"""Carry weights and trainable trees across from the JAX package.

The JAX leaves are stacked [L, ...] per layer with [din, dout] matrices;
the port's :class:`~speech_distill_tpu_torch.models.qwen3.Qwen3` keeps the
same matrices per layer. Trees arrive as numpy (``jax.tree.map(
np.asarray, params)``), so this module needs no JAX, or as tensors (the
port's own :func:`model_to_tree`). Quantized leaves (``ops/quant``: a
stacked ``{"q4": [L, K/2, N], "scale": [L, 1, N]}`` and the like, an int8
``embed``) become :class:`~speech_distill_tpu_torch.models.qwen3.QuantWeight`
modules, sliced per layer with their codes kept exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from speech_distill_tpu_torch.core.config import Qwen3Config
from speech_distill_tpu_torch.core.device import resolve_device
from speech_distill_tpu_torch.core.tree import tree_map
from speech_distill_tpu_torch.models.qwen3 import QuantWeight, Qwen3
from speech_distill_tpu_torch.ops.quant import is_quantized_leaf

_ATTN = ("q", "k", "v", "o", "q_norm", "k_norm")
_MLP = ("gate", "up", "down")


def _copy(dst: torch.nn.Parameter, src) -> None:
    if isinstance(src, torch.Tensor):
        t = src.detach()
    else:
        # bf16 leaves arrive as ml_dtypes arrays; the fp32 view is exact
        t = torch.from_numpy(np.require(np.asarray(src, dtype=np.float32),
                                        requirements=["C", "W"]))
    if tuple(t.shape) != tuple(dst.shape):
        raise ValueError(f"shape {tuple(t.shape)} != {tuple(dst.shape)}")
    dst.data.copy_(t.to(dst.device).to(dst.dtype))


def _exact(a, device) -> torch.Tensor:
    """A leaf tensor of a quantized leaf on ``device``, dtype kept."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(device).contiguous().clone()
    return torch.from_numpy(np.array(a)).to(device)


def _set(module: torch.nn.Module, name: str, src, i=None) -> None:
    """Fill ``module.<name>`` from ``src`` (layer ``i`` of a stacked leaf):
    a dense leaf is copied into the parameter, a quantized leaf replaces it
    with a :class:`QuantWeight`."""
    if not is_quantized_leaf(src):
        _copy(getattr(module, name), src if i is None else src[i])
        return
    device = getattr(module, name).device
    delattr(module, name)
    setattr(module, name, QuantWeight(
        {k: _exact(v if i is None else v[i], device)
         for k, v in src.items()}))


def params_from_jax(tree: dict, cfg: Qwen3Config, device="cuda") -> Qwen3:
    """A :class:`Qwen3` holding the weights of a JAX ``init_params``-shaped
    tree of numpy arrays or tensors: dense leaves cast to ``cfg.dtype``,
    quantized leaves kept exactly."""
    model = Qwen3(cfg, device)
    _set(model, "embed", tree["embed"]["weight"])
    _copy(model.final_ln, tree["final_ln"]["scale"])
    if model.lm_head is not None:
        _set(model, "lm_head", tree["lm_head"]["weight"])
    lt = tree["layers"]
    for i, layer in enumerate(model.layers):
        _copy(layer.input_ln, lt["input_ln"]["scale"][i])
        _copy(layer.post_ln, lt["post_ln"]["scale"][i])
        for name in _ATTN:
            _set(layer.attn, name, lt["attn"][name], i)
        for name in _MLP:
            _set(layer.mlp, name, lt["mlp"][name], i)
    return model


def _leaf(w):
    """A detached copy: a tensor, or a quantized weight's leaf dict."""
    if isinstance(w, QuantWeight):
        return {k: t.detach().clone() for k, t in w.leaf.items()}
    return w.detach().clone()


def model_to_tree(model: Qwen3) -> dict:
    """The model's weights as a JAX ``init_params``-shaped tree of stacked
    [L, ...] tensors (detached copies; quantized weights as stacked leaf
    dicts)."""
    ls = model.layers

    def stack(get):
        first = get(ls[0])
        if isinstance(first, QuantWeight):
            return {k: torch.stack([get(layer).leaf[k].detach()
                                    for layer in ls]) for k in first.leaf}
        return torch.stack([get(layer).detach() for layer in ls])
    tree = {"embed": {"weight": _leaf(model.embed)},
            "final_ln": {"scale": model.final_ln.detach().clone()},
            "layers": {
                "attn": {n: stack(lambda l, n=n: getattr(l.attn, n))
                         for n in _ATTN},
                "input_ln": {"scale": stack(lambda l: l.input_ln)},
                "mlp": {n: stack(lambda l, n=n: getattr(l.mlp, n))
                        for n in _MLP},
                "post_ln": {"scale": stack(lambda l: l.post_ln)}}}
    if model.lm_head is not None:
        tree["lm_head"] = {"weight": _leaf(model.lm_head)}
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
