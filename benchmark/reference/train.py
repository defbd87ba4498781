"""Plain float32 training steps of the reference: PiSSA's LoRA start, the
sparse top-K KD loss, the stage-1 cross entropy, clip by global norm and
AdamW on a warmup-linear schedule; and the readings a cell's ``correct``
compares.

Everything is worked out here again from the benchmark's inputs (the
drawn weights, the rows): nothing the program made is read, except its
outputs, which :func:`leaf_gap` and :func:`loss_gap` only judge.
Gradients are summed over blocks of rows under the whole batch's
denominators, so a full-size batch fits beside nothing else on the card.
The trainable tables keep the dtype the configuration states (bfloat16):
an update lands on the stored value, rounded, as a bfloat16 model's
trainable copy does; the arithmetic is float32.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .qwen3 import Qwen3Ref

IGNORE = -100


# --- PiSSA: the principal rank-r part of each weight becomes the adapter --

def principal_svd(W: np.ndarray, r: int, seed: int, oversample: int = 16,
                  iters: int = 4):
    """Top-r SVD by a randomized range finder with power iterations
    (Halko, Martinsson and Tropp 2011, algorithm 4.4), numpy float32, the
    test matrix from ``default_rng(seed)``."""
    din, dout = W.shape
    k = min(r + oversample, min(din, dout))
    rng = np.random.default_rng(seed)
    Y = W @ rng.normal(size=(dout, k)).astype(W.dtype)
    for _ in range(iters):
        Y = W @ (W.T @ Y)
        Y, _ = np.linalg.qr(Y)
    Q, _ = np.linalg.qr(Y)
    Ub, S, Vh = np.linalg.svd(Q.T @ W, full_matrices=False)
    return (Q @ Ub)[:, :r], S[:r], Vh[:r]


def pissa(W: np.ndarray, r: int, g: float, seed: int):
    """(A [din, r], B [r, dout], W - g A B): A = U sqrt(S / g), B =
    sqrt(S / g) V^T (PiSSA, Meng et al. 2024, with rsLoRA's scale g)."""
    if min(W.shape) <= 4 * r:
        U, S, Vh = np.linalg.svd(W, full_matrices=False)
        U, S, Vh = U[:, :r], S[:r], Vh[:r]
    else:
        U, S, Vh = principal_svd(W, r, seed)
    s = np.sqrt(S / g)
    A, B = U * s[None], s[:, None] * Vh
    return A, B, W - g * (A @ B)


def lora_start(ref: Qwen3Ref, targets, r: int, g: float, device) -> dict:
    """PiSSA on every target of every layer (seeded by the layer index):
    sets ``ref``'s residual weights and returns the trainable factors
    {(group, key): (A, B)} as float32 leaves."""
    L = ref.cfg["num_hidden_layers"]
    out = {}
    for group, key in targets:
        W = ref.w[f"{group}.{key}"]
        As, Bs = [], []
        for i in range(L):
            A, B, res = pissa(W[i].cpu().numpy(), r, g, seed=i)
            W[i].copy_(torch.from_numpy(res))
            As.append(A)
            Bs.append(B)
        out[(group, key)] = (
            torch.from_numpy(np.stack(As).astype(np.float32)).to(device)
            .requires_grad_(),
            torch.from_numpy(np.stack(Bs).astype(np.float32)).to(device)
            .requires_grad_())
    return out


# --- losses, summed over a block of rows under the batch's counts -------

def kd_sums(logits: torch.Tensor, labels: torch.Tensor, top_v: torch.Tensor,
            top_i: torch.Tensor, denom: float, temperature: float,
            alpha: float) -> torch.Tensor:
    """alpha CE + (1 - alpha) T^2 KL(teacher top-K || student) of a block,
    both summed over its valid next-token positions and divided by the
    batch's count ``denom``. The teacher's K log-probabilities are
    renormalised at temperature T; the student's log-probabilities at the
    teacher's ids are taken over the whole vocabulary at T."""
    s = logits[:, :-1].float()
    y = labels[:, 1:]
    valid = (y != IGNORE).float()
    v = top_v[:, :-1].float()
    idx = top_i[:, :-1].long()
    T = temperature
    log_p = torch.log_softmax(v / T, -1)
    log_q = s.gather(-1, idx) / T - torch.logsumexp(s / T, -1)[..., None]
    kl = (log_p.exp() * (log_p - log_q)).sum(-1)
    ce = torch.logsumexp(s, -1) - s.gather(-1, y.clamp_min(0)[..., None])[
        ..., 0]
    distill = (kl * valid).sum() / denom * (T * T)
    task = (ce * valid).sum() / denom
    return alpha * task + (1.0 - alpha) * distill


def ce_sums(logits: torch.Tensor, labels: torch.Tensor, denom: float
            ) -> torch.Tensor:
    """Next-token cross entropy of a block summed over labels != -100,
    divided by the batch's count."""
    s = logits[:, :-1].float()
    y = labels[:, 1:]
    valid = (y != IGNORE).float()
    ce = torch.logsumexp(s, -1) - s.gather(-1, y.clamp_min(0)[..., None])[
        ..., 0]
    return (ce * valid).sum() / denom


# --- the optimizer ------------------------------------------------------

def warmup_linear(lr: float, warmup: int, total: int) -> Callable:
    """Linear from 0 to ``lr`` over ``warmup`` updates, then linear to 0 at
    ``total``; evaluated at the count of earlier updates."""
    warmup = max(1, warmup)
    total = max(total, warmup + 1)

    def at(count: int) -> float:
        if count < warmup:
            return lr * count / warmup
        return lr * (1.0 - min(count - warmup, total - warmup)
                     / (total - warmup))
    return at


class AdamW:
    """Clip by global norm (no epsilon), then AdamW (Loshchilov and Hutter
    2019) with float32 moments; each parameter is updated in float32 and
    stored back in its own dtype (``store``)."""

    def __init__(self, schedule: Callable, b1=0.9, b2=0.999, eps=1e-8,
                 weight_decay=0.0, max_norm=1.0):
        self.schedule, self.b1, self.b2, self.eps = schedule, b1, b2, eps
        self.wd, self.max_norm = weight_decay, max_norm
        self.count = 0
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor],
             store: Dict[str, torch.dtype]) -> float:
        norm = float(torch.sqrt(sum(g.float().square().sum()
                                    for g in grads.values())))
        clip = 1.0 if norm < self.max_norm else self.max_norm / norm
        lr = self.schedule(self.count)
        self.count += 1
        bc1, bc2 = 1 - self.b1 ** self.count, 1 - self.b2 ** self.count
        for name, p in params.items():
            g = grads[name].float() * clip
            m = self.m.get(name, torch.zeros_like(g))
            v = self.v.get(name, torch.zeros_like(g))
            m = self.b1 * m + (1 - self.b1) * g
            v = self.b2 * v + (1 - self.b2) * g.square()
            self.m[name], self.v[name] = m, v
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            if self.wd:
                u = u + self.wd * p.float()
            new = p.float() - lr * u
            p.copy_(new.to(store[name]).float())
        return norm


# --- the readings --------------------------------------------------------

def loss_gap(prog: List[float], ref: List[float]) -> float:
    """The largest relative gap of a step's loss."""
    return max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog, ref))


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             ref_grad: Optional[Dict[str, float]] = None) -> tuple:
    """(gap, leaf) of the worst leaf: |prog norm - ref norm| over the
    larger of the reference's norm of that leaf and of the median leaf.
    Leaves whose reference gradient is under a thousandth of the median
    leaf's (``ref_grad``) are nought to rounding and left out."""
    keep = list(ref)
    if ref_grad is not None:
        med_g = float(np.median(list(ref_grad.values())))
        keep = [k for k in ref if ref_grad[k] >= 1e-3 * med_g]
    med = float(np.median([ref[k] for k in keep]))
    worst, leaf = 0.0, None
    for k in keep:
        gap = abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
        if gap > worst or leaf is None:
            worst, leaf = gap, k
    return worst, leaf
