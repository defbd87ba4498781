"""Weight-only quantization (own copy of ``speech_distill_tpu/ops/quant.py``).

A quantized leaf is a dict of tensors: ``{"q8": int8[..., D], "scale":
f32[..., 1, D]}``, ``{"q4": uint8[..., K/2, D] packed nibbles, "scale":
f32[..., 1, D]}``, or the nf4 leaf ``{"nf4": uint8[..., K, D/2],
"absmax_q", "absmax_scale", "absmax_offset"}`` (``"absmax"`` without double
quantization). Scales are per output channel (the last axis); a leading
[L, ...] layer axis is kept, so a stacked leaf slices per layer.

The rounding is the JAX package's: ``torch.round`` is round-half-even as
``jnp.round`` is, ``torch.searchsorted`` (left) matches
``jnp.searchsorted``'s default, and the ``max(scale, 1e-12)`` guard stays,
so the codes come out integer-equal on the same fp32 weights.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

Leaf = Dict[str, torch.Tensor]


def _reduce_axes(ndim: int):
    """Reduce over the contraction dims: keep the last (output-channel)
    axis and, for stacked [L, ...] weights, the leading layer axis."""
    return tuple(range(ndim - 1)) if ndim == 2 else tuple(range(1, ndim - 1))


def _absmax(wf: torch.Tensor) -> torch.Tensor:
    return wf.abs().amax(dim=_reduce_axes(wf.dim()), keepdim=True)


def quantize_array_int8(w: torch.Tensor) -> Leaf:
    """Symmetric per-output-channel int8 (last dim = output channel)."""
    wf = w.float()
    scale = _absmax(wf) / 127.0
    q = torch.round(wf / torch.clamp(scale, min=1e-12)).to(torch.int8)
    return {"q8": q, "scale": scale}


def quantize_array_int4(w: torch.Tensor) -> Leaf:
    """Symmetric per-output-channel int4, two codes per uint8 along the
    contraction (second-to-last, even) axis, split-halves: packed row r
    holds contraction row r in the high nibble and row K/2 + r in the low
    nibble, so the unpacked weight is two contiguous half-matrices."""
    wf = w.float()
    scale = _absmax(wf) / 7.0
    q = torch.clamp(torch.round(wf / torch.clamp(scale, min=1e-12)), -7, 7)
    q = (q + 8).to(torch.uint8)                          # [1, 15]
    if q.shape[-2] % 2:
        raise ValueError(f"int4 packing needs an even contraction dim, got "
                         f"{tuple(q.shape)}")
    half = q.shape[-2] // 2
    packed = (q[..., :half, :] << 4) | q[..., half:, :]
    return {"q4": packed, "scale": scale}


# the 16 QLoRA normal-float constants (Dettmers et al. 2023; bitsandbytes)
NF4_CODE = (
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
    0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
    0.7229568362236023, 1.0)

_NF4_BLOCK = 64          # bitsandbytes' default 4-bit block size
_ABSMAX_BLOCK = 256      # ... and double-quant block size


def quantize_array_nf4(w: torch.Tensor, double_quant: bool = True) -> Leaf:
    """Blockwise nf4: 64-element blocks over the row-major-flattened matrix,
    per-block absmax, the nearest normal-float code. With ``double_quant``
    the fp32 absmax array is itself quantized to int8 in 256-element
    blocks around its mean. Leading axes are kept on every leaf."""
    wf = w.float()
    K, D = wf.shape[-2], wf.shape[-1]
    lead = tuple(wf.shape[:-2])
    if (K * D) % _NF4_BLOCK or D % 2:
        raise ValueError(f"nf4 needs K*D % {_NF4_BLOCK} == 0 and even D, "
                         f"got {(K, D)}")
    nb = K * D // _NF4_BLOCK
    blocks = wf.reshape(lead + (nb, _NF4_BLOCK))
    absmax = blocks.abs().amax(dim=-1)                         # [..., nb]
    normed = blocks / torch.clamp(absmax[..., None], min=1e-12)
    code = torch.tensor(NF4_CODE, dtype=torch.float32, device=w.device)
    mid = (code[1:] + code[:-1]) / 2.0
    q = torch.searchsorted(mid, normed.contiguous()).to(torch.uint8)
    q = q.reshape(lead + (K, D))
    out = {"nf4": (q[..., 0::2] << 4) | q[..., 1::2]}         # [..., K, D/2]
    if not double_quant:
        out["absmax"] = absmax
        return out
    n = absmax.shape[-1]
    nb2 = -(-n // _ABSMAX_BLOCK)
    offset = absmax.mean(dim=-1, keepdim=True)[..., None]      # [..., 1, 1]
    padded = torch.nn.functional.pad(absmax, (0, nb2 * _ABSMAX_BLOCK - n))
    r = padded.reshape(lead + (nb2, _ABSMAX_BLOCK)) - offset
    s2 = r.abs().amax(dim=-1, keepdim=True) / 127.0            # [..., nb2, 1]
    q2 = torch.round(r / torch.clamp(s2, min=1e-12)).to(torch.int8)
    out.update(absmax_q=q2, absmax_scale=s2, absmax_offset=offset)
    return out


def _dequantize_nf4(p: Leaf, dtype) -> torch.Tensor:
    packed = p["nf4"]
    K, D = packed.shape[-2], 2 * packed.shape[-1]
    lead = tuple(packed.shape[:-2])
    nb = K * D // _NF4_BLOCK
    if "absmax" in p:
        absmax = p["absmax"]                                   # [..., nb]
    else:
        # [..., nb2, 256]
        r = p["absmax_q"].float() * p["absmax_scale"] + p["absmax_offset"]
        absmax = r.reshape(lead + (-1,))[..., :nb]
    hi = (packed >> 4).long()
    lo = (packed & 0xF).long()
    q = torch.stack([hi, lo], dim=-1).reshape(lead + (K, D))
    code = torch.tensor(NF4_CODE, dtype=torch.float32, device=packed.device)
    vals = code[q].reshape(lead + (nb, _NF4_BLOCK)) * absmax[..., None]
    return vals.reshape(lead + (K, D)).to(dtype)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Packed uint8 [..., K/2, N] -> the int32 grid [..., K, N] in
    [-8, 7] (split-halves: high nibbles are rows [0, K/2))."""
    hi = (packed >> 4).to(torch.int32) - 8
    lo = (packed & 0xF).to(torch.int32) - 8
    return torch.cat([hi, lo], dim=-2)


def dequantize_array(p: Leaf, dtype=torch.bfloat16) -> torch.Tensor:
    if "q8" in p:
        return (p["q8"].float() * p["scale"]).to(dtype)
    if "q4" in p:
        return (unpack_int4(p["q4"]).float() * p["scale"]).to(dtype)
    if "nf4" in p:
        return _dequantize_nf4(p, dtype)
    raise ValueError("not a quantized leaf")


def is_quantized_leaf(x) -> bool:
    return isinstance(x, dict) and ("q8" in x or "q4" in x or "nf4" in x)


_QUANT_TARGETS = {("attn", "q"), ("attn", "k"), ("attn", "v"), ("attn", "o"),
                  ("mlp", "gate"), ("mlp", "up"), ("mlp", "down")}


def quantize_params(params: Dict[str, Any], bits: int = 8,
                    quantize_embed: bool = True,
                    method: str = "auto") -> Dict[str, Any]:
    """Quantize a Qwen3 tree's projection weights (and the embed / lm head)
    — the tree of ``models/convert.model_to_tree`` or of the JAX
    ``init_params``, as tensors.

    method: 'int8' | 'int4' (packed symmetric grid) | 'nf4' (normal-float
    codebook with double quantization) | 'auto' (int8 for bits=8, nf4 for
    bits=4). The embed and lm head are always int8 (row gathers and the
    unembed product want row-addressable codes)."""
    if method == "auto":
        method = "int8" if bits == 8 else "nf4"
    fn = {"int8": quantize_array_int8, "int4": quantize_array_int4,
          "nf4": quantize_array_nf4}[method]
    out = dict(params)
    layers = {g: dict(v) for g, v in params["layers"].items()}
    for group, key in _QUANT_TARGETS:
        if group in layers and key in layers[group]:
            layers[group][key] = fn(layers[group][key])
    out["layers"] = layers
    if quantize_embed:
        out["embed"] = {"weight": quantize_array_int8(
            params["embed"]["weight"])}
        if "lm_head" in params:
            out["lm_head"] = {"weight": quantize_array_int8(
                params["lm_head"]["weight"])}
    return out


def param_bytes(params) -> int:
    """Bytes of every tensor leaf of a (nested dict) tree."""
    if isinstance(params, torch.Tensor):
        return params.numel() * params.element_size()
    if isinstance(params, dict):
        return sum(param_bytes(v) for v in params.values())
    return 0
