"""LoRA for the Qwen3 port: rsLoRA scaling and PiSSA init (port of
``speech_distill_tpu/distill/lora.py``).

Adapters live in a tree of their own, shaped like the JAX one:
``{"layers": {group: {key: {"a": [L, din, r], "b": [L, r, dout]}}},
"embed": {"weight": [V, D]}, ["lm_head": {"weight": [V, D]}]}``, fp32
factors and full-rank copies of the saved modules. The training forward
applies them unmerged (``models/qwen3.forward_train``); gradients flow
only into the adapters and the copies.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from speech_distill_tpu_torch.core.config import LoraConfig, Qwen3Config
from speech_distill_tpu_torch.core.device import resolve_device
from speech_distill_tpu_torch.core.tree import tree_leaves, tree_map
from speech_distill_tpu_torch.models.convert import model_to_tree
from speech_distill_tpu_torch.models.qwen3 import Qwen3

Params = Dict[str, Any]

# module name -> (group, key) in the layer tree
_TARGETS = {
    "q_proj": ("attn", "q"),
    "k_proj": ("attn", "k"),
    "v_proj": ("attn", "v"),
    "o_proj": ("attn", "o"),
    "gate_proj": ("mlp", "gate"),
    "up_proj": ("mlp", "up"),
    "down_proj": ("mlp", "down"),
}


def lora_scaling(cfg: LoraConfig) -> float:
    """rsLoRA: alpha / sqrt(r); classic: alpha / r."""
    return cfg.alpha / np.sqrt(cfg.r) if cfg.use_rslora else cfg.alpha / cfg.r


def _principal_svd(W: np.ndarray, r: int, seed: int = 0,
                   oversample: int = 16, iters: int = 4):
    """Top-r SVD by a randomized range finder with power iterations (the
    JAX package's numpy routine, step for step, so both give the same
    factors)."""
    din, dout = W.shape
    k = min(r + oversample, min(din, dout))
    rng = np.random.default_rng(seed)
    Y = W @ rng.normal(size=(dout, k)).astype(W.dtype)
    for _ in range(iters):
        Y = W @ (W.T @ Y)
        Y, _ = np.linalg.qr(Y)
    Q, _ = np.linalg.qr(Y)
    B = Q.T @ W
    Ub, S, Vh = np.linalg.svd(B, full_matrices=False)
    return (Q @ Ub)[:, :r], S[:r], Vh[:r]


def _pissa(Wf: np.ndarray, r: int, g: float, seed: int):
    """(A [din, r], B [r, dout], residual W - g A B) of one fp32 weight:
    A = U_r diag(sqrt(S_r / g)), B = diag(sqrt(S_r / g)) V_r^T. ``seed``
    (the layer index, as in JAX) seeds the randomized range finder."""
    din, dout = Wf.shape
    if min(din, dout) <= 4 * r:
        U, S, Vh = np.linalg.svd(Wf, full_matrices=False)
        U, S, Vh = U[:, :r], S[:r], Vh[:r]
    else:
        U, S, Vh = _principal_svd(Wf, r, seed=seed)
    s = np.sqrt(S / g)
    A = U * s[None, :]
    B = s[:, None] * Vh
    return A, B, Wf - g * (A @ B)


def init_lora(base: Qwen3, model_cfg: Qwen3Config, cfg: LoraConfig,
              generator: Optional[torch.Generator] = None,
              device="cuda") -> Tuple[Params, Qwen3]:
    """(lora tree, base model), on ``device`` (CUDA by default; raises
    without it), where the base model must live.

    PiSSA: per target W, the rank-r principal SVD component becomes the
    adapter and is subtracted from the base, so training starts in the
    principal subspace. Deterministic (numpy, seeded by layer index):
    the same A, B and residual as the JAX ``init_lora``. The residual
    replaces the base model's weight in place (JAX returns a new tree).
    'gaussian' / 'default': A ~ N(0, 1/r) resp. N(0, 1/din) from
    ``generator``, B = 0. Saved modules get full-rank trainable copies.
    """
    dev = resolve_device(device)
    if base.device != dev:
        raise ValueError(f"base model is on {base.device}, not {dev}")
    g = lora_scaling(cfg)
    r = cfg.r
    L = model_cfg.num_hidden_layers
    layers: Params = {}
    for mod in cfg.target_modules:
        group, key = _TARGETS[mod]
        weights = [getattr(getattr(layer, group), key)
                   for layer in base.layers]
        din, dout = weights[0].shape
        if cfg.init_weights == "pissa":
            A = np.zeros((L, din, r), np.float32)
            B = np.zeros((L, r, dout), np.float32)
            for i, w in enumerate(weights):
                A[i], B[i], res = _pissa(w.detach().float().cpu().numpy(),
                                         r, g, seed=i)
                w.data.copy_(torch.from_numpy(res).to(w.device))
            a = torch.from_numpy(A).to(dev)
            b = torch.from_numpy(B).to(dev)
        else:
            std = 1.0 / r if cfg.init_weights == "gaussian" \
                else 1.0 / np.sqrt(din)
            a = torch.randn((L, din, r), generator=generator,
                            dtype=torch.float32).to(dev) * std
            b = torch.zeros((L, r, dout), dtype=torch.float32, device=dev)
        layers.setdefault(group, {})[key] = {"a": a, "b": b}
    lora: Params = {"layers": layers}
    if "embed_tokens" in cfg.modules_to_save:
        lora["embed"] = {"weight": base.embed.detach().clone()}
    if "lm_head" in cfg.modules_to_save and base.lm_head is not None:
        lora["lm_head"] = {"weight": base.lm_head.detach().clone()}
    # tied embeddings: the embed copy is also the head
    for leaf in tree_leaves(lora):
        leaf.requires_grad_(True)
    return lora, base


def merge_lora(base: Qwen3, lora: Params, cfg: LoraConfig) -> Params:
    """The effective weights as a JAX-shaped tree of stacked tensors:
    W + g * A @ B per target (delta in fp32, added in the weight's dtype,
    as JAX does), with the saved modules' copies in place of the base
    tables. Differentiable in the adapters only."""
    g = lora_scaling(cfg)
    eff = model_to_tree(base)
    for group, mods in lora.get("layers", {}).items():
        for key, ab in mods.items():
            W = eff["layers"][group][key]
            delta = torch.einsum("lir,lro->lio", ab["a"].float(),
                                 ab["b"].float()) * g
            eff["layers"][group][key] = W + delta.to(W.dtype)
    for name in ("embed", "lm_head"):
        if name in lora:
            eff[name] = {"weight": lora[name]["weight"]}
    return eff


def merge_and_export(base: Qwen3, lora: Params, cfg: LoraConfig) -> Params:
    """Adapters folded into a plain, detached tensor tree (what an export
    writes)."""
    with torch.no_grad():
        return tree_map(lambda t: t.detach().clone(),
                        merge_lora(base, lora, cfg))


def count_trainable(lora: Params) -> int:
    return sum(int(t.numel()) for t in tree_leaves(lora))
