"""Plain Qwen3 decoder in float32, the yardstick of every cell.

Written from the published description of the architecture (Qwen3
technical report and its ``config.json``): token embedding, per layer
RMSNorm, q/k/v projections, per-head q/k RMSNorm, NeoX rotary embedding
(half rotation) at theta ``rope_theta``, grouped-query causal attention
with softmax in float32, o projection, residual, RMSNorm, SwiGLU MLP,
residual; a final RMSNorm and the head (tied: the embedding matrix).
Matrices apply as ``x @ w`` with ``w`` [din, dout].

No kernel, cache or batching trick: each call runs the whole sequence.
Every product is float32 with TF32 off (:func:`exact_fp32`). The
``precision="fp8"`` mode is the control of the comparisons: every
operand of a linear layer is rounded to float8 e4m3 first (per-tensor
scale for weights, per-row for activations; the gradient passes straight
through the rounding), the next precision below the bfloat16 the
configurations state.

Imports torch alone: nothing of the program under test, nothing of JAX.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

E4M3_MAX = 448.0


def exact_fp32() -> None:
    """Full float32 products and convolutions for the rest of the process
    (the reference runs after the program's window has closed)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8_round(t: torch.Tensor, rowwise: bool) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under an amax scale and back, the
    gradient passing straight through."""
    a = (t.detach().abs().amax(dim=-1, keepdim=True) if rowwise
         else t.detach().abs().amax())
    scale = a.clamp_min(1e-30) / E4M3_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
    return t + (q - t.detach())


def linear(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "fp8":
        return fp8_round(x, True) @ fp8_round(w, False)
    return x @ w


def rms_norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with its scale (one at initialisation, never trained here)."""
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """NeoX rotary embedding of x [B, T, N, Dh] at positions [T]."""
    Dh = x.shape[-1]
    half = Dh // 2
    freq = 1.0 / (theta ** (torch.arange(half, device=x.device,
                                         dtype=torch.float32) / half))
    ang = positions.float()[:, None] * freq[None]
    ang = torch.cat([ang, ang], -1)
    cos, sin = ang.cos()[None, :, None], ang.sin()[None, :, None]
    rot = torch.cat([-x[..., half:], x[..., :half]], -1)
    return x * cos + rot * sin


class Qwen3Ref:
    """The decoder's float32 weights, from the benchmark's seeded draw
    (``{name: [L, ...] tensor}``, any dtype). ``lora``: per target
    ``(group, key)`` the factors (A [L, din, r], B [L, r, dout]) added as
    ``scale * x A B``; ``residual``: per target the [L, din, dout] weight
    that replaces the drawn one (PiSSA's). ``embed`` may be replaced at
    call time (a trainable copy)."""

    def __init__(self, cfg: dict, weights: Dict[str, torch.Tensor]):
        self.cfg = cfg
        self.w = {k: v.float() for k, v in weights.items()}
        self.lora: Dict[Tuple[str, str], Tuple[torch.Tensor,
                                               torch.Tensor]] = {}
        self.scale = 1.0

    def proj(self, x, group: str, key: str, i: int, precision: str):
        y = linear(x, self.w[f"{group}.{key}"][i], precision)
        ab = self.lora.get((group, key))
        if ab is not None:
            a, b = ab
            y = y + self.scale * linear(linear(x, a[i], precision), b[i],
                                        precision)
        return y

    def layer(self, x, i: int, positions, bias, precision: str):
        cfg = self.cfg
        B, T, _ = x.shape
        H, KV, Dh = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                     cfg["head_dim"])
        eps = cfg["rms_norm_eps"]
        y = rms_norm(x, eps)
        q = self.proj(y, "attn", "q", i, precision).view(B, T, H, Dh)
        k = self.proj(y, "attn", "k", i, precision).view(B, T, KV, Dh)
        v = self.proj(y, "attn", "v", i, precision).view(B, T, KV, Dh)
        q = rope(rms_norm(q, eps), positions, cfg["rope_theta"])
        k = rope(rms_norm(k, eps), positions, cfg["rope_theta"])
        k = k.repeat_interleave(H // KV, dim=2)
        v = v.repeat_interleave(H // KV, dim=2)
        s = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(Dh) + bias
        o = torch.einsum("bhts,bshd->bthd", torch.softmax(s, -1), v)
        x = x + self.proj(o.reshape(B, T, H * Dh), "attn", "o", i, precision)
        y = rms_norm(x, eps)
        g = F.silu(self.proj(y, "mlp", "gate", i, precision))
        u = self.proj(y, "mlp", "up", i, precision)
        return x + self.proj(g * u, "mlp", "down", i, precision)

    def hidden(self, ids: torch.Tensor, mask: Optional[torch.Tensor] = None,
               embed: Optional[torch.Tensor] = None,
               precision: str = "fp32", remat: bool = False
               ) -> torch.Tensor:
        """Final-normed hidden states [B, T, D] of ids [B, T]; ``mask``
        [B, T] marks real keys (right padding)."""
        table = self.w["embed"] if embed is None else embed
        B, T = ids.shape
        x = table.float()[ids]
        pos = torch.arange(T, device=ids.device)
        keep = pos[None, :] <= pos[:, None]
        keep = keep[None, None].expand(B, 1, T, T)
        if mask is not None:
            keep = keep & mask.bool()[:, None, None, :]
        bias = torch.zeros(keep.shape, device=ids.device).masked_fill(
            ~keep, float("-inf"))
        for i in range(self.cfg["num_hidden_layers"]):
            if remat:
                x = checkpoint(self.layer, x, i, pos, bias, precision,
                               use_reentrant=False)
            else:
                x = self.layer(x, i, pos, bias, precision)
        return rms_norm(x, self.cfg["rms_norm_eps"])

    def head(self, h: torch.Tensor, embed: Optional[torch.Tensor] = None,
             precision: str = "fp32") -> torch.Tensor:
        """float32 logits of hidden states h [..., D] (tied head)."""
        table = self.w["embed"] if embed is None else embed
        if "lm_head" in self.w and embed is None:
            table = self.w["lm_head"]
        return linear(h, table.float().t(), precision)
