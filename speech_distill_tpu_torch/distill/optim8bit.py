"""8-bit AdamW: blockwise-quantized optimizer moments (port of
``speech_distill_tpu/distill/optim8bit.py``; the reference's
bitsandbytes ``adamw_8bit``).

The first moment is stored as int8 codes and the second as uint8 codes,
each flat leaf zero-padded to a multiple of 256 and cut into blocks of
256 with one fp32 scale a block (max|x| / 127, max / 255): about a byte a
moment element instead of four. Each update dequantizes the moments,
updates them in fp32 and quantizes them again. The JAX version is
elementwise XLA, so this is plain PyTorch; the codes equal JAX's because
the arithmetic is the same: ``round(x / max(scale, 1e-20))`` as a
division (a reciprocal product gives other codes), half to even.

``adamw_8bit`` is optax's chain clip_by_global_norm -> scale_by_adam_8bit
-> add_decayed_weights -> scale_by_learning_rate, with each transform's
dtypes: the clip in the gradient's dtype, the Adam output cast to the
gradient's dtype before the decay and the (negated) learning rate.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from speech_distill_tpu_torch.core.tree import (tree_leaves, tree_map,
                                                tree_unflatten)
from speech_distill_tpu_torch.distill.train_step import (Optimizer,
                                                        bias_corrections,
                                                        weak)

BLOCK = 256


def _pad_len(n: int) -> int:
    return (n + BLOCK - 1) // BLOCK * BLOCK


def _blocks(x: torch.Tensor) -> torch.Tensor:
    """x flattened, zero-padded to a multiple of BLOCK, as [n/BLOCK, BLOCK]."""
    flat = x.reshape(-1)
    return F.pad(flat, (0, _pad_len(flat.numel()) - flat.numel())
                 ).reshape(-1, BLOCK)


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d as a true division: CUDA turns a division by a Python (or
    host) scalar into a product with its reciprocal, which rounds
    differently."""
    return x / torch.tensor(d, dtype=x.dtype, device=x.device)


def quantize_signed(x: torch.Tensor):
    """fp32 x -> (int8 codes [n/256, 256], fp32 scales [n/256, 1]),
    blockwise symmetric."""
    xp = _blocks(x)
    scale = _div(xp.abs().amax(dim=1, keepdim=True), 127.0)
    return torch.round(xp / scale.clamp_min(1e-20)).to(torch.int8), scale


def quantize_unsigned(x: torch.Tensor):
    """Nonnegative fp32 x -> (uint8 codes, fp32 scales), blockwise."""
    xp = _blocks(x)
    scale = _div(xp.amax(dim=1, keepdim=True), 255.0)
    return torch.round(xp / scale.clamp_min(1e-20)).to(torch.uint8), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    """Codes and scales back to an fp32 tensor of ``shape``."""
    x = q.float() * scale
    return x.reshape(-1)[:int(np.prod(shape))].reshape(shape)


class Adam8bitState(NamedTuple):
    count: int
    mu_q: Any
    mu_scale: Any
    nu_q: Any
    nu_scale: Any


def _zero_codes(p: torch.Tensor, dtype: torch.dtype):
    nb = _pad_len(p.numel()) // BLOCK
    return (torch.zeros((nb, BLOCK), dtype=dtype, device=p.device),
            torch.zeros((nb, 1), dtype=torch.float32, device=p.device))


def f32(x: float) -> float:
    """``x`` rounded to fp32 (a Python float holding the fp32 value)."""
    return float(np.float32(x))


def scale_by_adam_8bit(b1: float = 0.9, b2: float = 0.999,
                       eps: float = 1e-8) -> Optimizer:
    """Adam's normalised update with int8 / uint8 moments: ``update``
    returns (m / c1) / (sqrt(v / c2) + eps) in each gradient's dtype.
    At the first step the moments dequantize from all-zero codes."""

    def init(params) -> Adam8bitState:
        leaves = tree_leaves(params)
        mq, ms = zip(*(_zero_codes(p, torch.int8) for p in leaves))
        vq, vs = zip(*(_zero_codes(p, torch.uint8) for p in leaves))

        def unf(xs):
            return tree_unflatten(params, list(xs))
        return Adam8bitState(0, unf(mq), unf(ms), unf(vq), unf(vs))

    @torch.no_grad()
    def update(updates, state: Adam8bitState, params=None):
        count = state.count + 1
        c1, c2 = bias_corrections(b1, b2, count)
        outs, nmq, nms, nnq, nns = [], [], [], [], []
        for g, qm, sm, qv, sv in zip(
                tree_leaves(updates), tree_leaves(state.mu_q),
                tree_leaves(state.mu_scale), tree_leaves(state.nu_q),
                tree_leaves(state.nu_scale)):
            gf = g.float()
            m = b1 * dequantize(qm, sm, g.shape) + (1 - b1) * gf
            v = b2 * dequantize(qv, sv, g.shape) + (1 - b2) * gf.square()
            outs.append((_div(m, c1) / (torch.sqrt(_div(v, c2)) + eps)
                         ).to(g.dtype))
            q, s = quantize_signed(m)
            nmq.append(q)
            nms.append(s)
            q, s = quantize_unsigned(v)
            nnq.append(q)
            nns.append(s)

        def unf(xs):
            return tree_unflatten(updates, xs)
        return unf(outs), Adam8bitState(count, unf(nmq), unf(nms), unf(nnq),
                                        unf(nns))

    return Optimizer(init, update)


def optax_global_norm(tree) -> torch.Tensor:
    """``optax.global_norm``: each leaf's sum of squares in the leaf's
    dtype (bf16 squares summed in fp32 and rounded, as ``jnp.sum``
    upcasts them), the leaf sums added with JAX's promotion, then sqrt."""
    total = None
    for x in tree_leaves(tree):
        s = (x * x).float().sum().to(x.dtype)
        total = s if total is None else total + s
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float, g_norm=None):
    """``optax.clip_by_global_norm``: leaves scaled by max_norm / |g| in
    their own dtype when |g| >= max_norm, unchanged otherwise (a select
    on the device, no host read). ``g_norm``: the norm when the caller
    has it."""
    if g_norm is None:
        g_norm = optax_global_norm(grads)
    keep = g_norm < max_norm
    return tree_map(lambda t: torch.where(
        keep, t, (t / g_norm.to(t.dtype)) * weak(max_norm, t)), grads)


def adamw_8bit(learning_rate: Union[float, Callable[[int], float]],
               b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
               weight_decay: float = 0.0,
               max_grad_norm: float = 1.0) -> Optimizer:
    """The 8-bit counterpart of ``train_step.make_optimizer``: clip by
    global norm, 8-bit Adam, decoupled weight decay (``u + wd * p``, wd
    in p's dtype), then the learning rate (a float, or a schedule
    of the count of earlier updates) negated, cast to each update's dtype
    and multiplied in, as ``optax.scale_by_learning_rate`` does. The
    state is the :class:`Adam8bitState` of the Adam step; its count is
    the schedule's too."""
    adam = scale_by_adam_8bit(b1, b2, eps)
    lr_at = learning_rate if callable(learning_rate) else \
        (lambda count: learning_rate)

    @torch.no_grad()
    def update(grads, state: Adam8bitState, params=None, g_norm=None):
        lr = -f32(lr_at(state.count))
        clipped = (clip_by_global_norm(grads, max_grad_norm)
                   if g_norm is None else
                   clip_by_global_norm(grads, max_grad_norm, g_norm))
        ups, state2 = adam.update(clipped, state)
        if weight_decay:
            if params is None:
                raise ValueError("weight decay needs the params")
            ups = tree_map(lambda u, p: u + weak(weight_decay, p) * p, ups,
                           params)
        ups = tree_map(lambda u: weak(lr, u) * u, ups)
        return ups, state2

    return Optimizer(adam.init, update)


def state_bytes(state) -> int:
    """Bytes of an optimizer state's tensors (codes and scales, or
    moments), through its dicts, tuples and lists."""
    if isinstance(state, torch.Tensor):
        return state.numel() * state.element_size()
    items = state.values() if isinstance(state, dict) else (
        state if isinstance(state, (tuple, list)) else ())
    return sum(state_bytes(x) for x in items)
