"""Carry weights and trainable trees across from the JAX package.

The JAX leaves are stacked [L, ...] per layer with [din, dout] matrices;
the port's :class:`~speech_distill_tpu_torch.models.qwen3.Qwen3` keeps the
same matrices per layer. Trees arrive as numpy (``jax.tree.map(
np.asarray, params)``), so this module needs no JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from speech_distill_tpu_torch.core.config import Qwen3Config
from speech_distill_tpu_torch.core.device import resolve_device
from speech_distill_tpu_torch.core.tree import tree_map
from speech_distill_tpu_torch.models.qwen3 import Qwen3

_ATTN = ("q", "k", "v", "o", "q_norm", "k_norm")
_MLP = ("gate", "up", "down")


def _copy(dst: torch.nn.Parameter, src) -> None:
    # bf16 leaves arrive as ml_dtypes arrays; the fp32 view is exact
    arr = np.require(np.asarray(src, dtype=np.float32),
                     requirements=["C", "W"])
    if arr.shape != tuple(dst.shape):
        raise ValueError(f"shape {arr.shape} != {tuple(dst.shape)}")
    dst.data.copy_(torch.from_numpy(arr).to(dst.device).to(dst.dtype))


def params_from_jax(tree: dict, cfg: Qwen3Config, device="cuda") -> Qwen3:
    """A :class:`Qwen3` holding the weights of a JAX ``init_params``-shaped
    pytree of numpy arrays (cast to ``cfg.dtype``)."""
    model = Qwen3(cfg, device)
    _copy(model.embed, tree["embed"]["weight"])
    _copy(model.final_ln, tree["final_ln"]["scale"])
    if model.lm_head is not None:
        _copy(model.lm_head, tree["lm_head"]["weight"])
    lt = tree["layers"]
    for i, layer in enumerate(model.layers):
        _copy(layer.input_ln, lt["input_ln"]["scale"][i])
        _copy(layer.post_ln, lt["post_ln"]["scale"][i])
        for name in _ATTN:
            _copy(getattr(layer.attn, name), lt["attn"][name][i])
        for name in _MLP:
            _copy(getattr(layer.mlp, name), lt["mlp"][name][i])
    return model


def model_to_tree(model: Qwen3) -> dict:
    """The model's weights as a JAX ``init_params``-shaped tree of stacked
    [L, ...] tensors (detached copies)."""
    ls = model.layers

    def stack(get):
        return torch.stack([get(layer).detach() for layer in ls])
    tree = {"embed": {"weight": model.embed.detach().clone()},
            "final_ln": {"scale": model.final_ln.detach().clone()},
            "layers": {
                "attn": {n: stack(lambda l, n=n: getattr(l.attn, n))
                         for n in _ATTN},
                "input_ln": {"scale": stack(lambda l: l.input_ln)},
                "mlp": {n: stack(lambda l, n=n: getattr(l.mlp, n))
                        for n in _MLP},
                "post_ln": {"scale": stack(lambda l: l.post_ln)}}}
    if model.lm_head is not None:
        tree["lm_head"] = {"weight": model.lm_head.detach().clone()}
    return tree


def trainable_from_jax(tree: dict, cfg: Qwen3Config, device="cuda") -> dict:
    """A JAX LoRA/trainable tree of numpy leaves (adapters [L, din, r] and
    [L, r, dout], saved-module copies [V, D]) as port tensors that require
    grad: adapters in fp32, copies in ``cfg.dtype``."""
    dev = resolve_device(device)

    def leaf(a, dtype):
        arr = np.require(np.asarray(a, dtype=np.float32),
                         requirements=["C", "W"])
        return torch.from_numpy(arr).to(dev, dtype).requires_grad_(True)
    out = {"layers": tree_map(lambda a: leaf(a, torch.float32),
                              tree["layers"])}
    for name in ("embed", "lm_head"):
        if name in tree:
            out[name] = {"weight": leaf(tree[name]["weight"],
                                        cfg.torch_dtype)}
    return out


def tree_to_numpy(tree: dict) -> dict:
    """A tree of tensors as fp32 numpy, for comparison with JAX."""
    return tree_map(lambda t: t.detach().float().cpu().numpy(), tree)
