"""Upsampling conformer encoder of the flow (port of
``speech_distill_tpu/models/flow_encoder.py``).

The reference ``UpsampleConformerEncoder``: Linear embed + Espnet rel-pos
encoding -> PreLookahead (3 frames) -> 6 rel-pos transformer layers
@512/8h -> nearest x2 upsample + causal conv -> fresh embed/pos -> 4 more
layers -> final LayerNorm.

Layout: channel-last [B, T, C] throughout, as in JAX; the convolutions
transpose to [B, C, T] at ``F.conv1d`` only. The modules carry the
reference torch names (``embed.out.0``, ``encoders.{i}.self_attn.
linear_q``, ``pre_lookahead_layer.conv1``, ...), so ``state_dict()`` is a
reference-format state dict; the functions take a module where JAX takes
its params pytree and keep JAX's names. Attention is plain matmul +
softmax with the additive -1e30 chunk/padding bias (not causal), so it
does not go through ``ops/attention.sdpa``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass
class FlowEncoderConfig:
    input_size: int = 512
    output_size: int = 512
    attention_heads: int = 8
    linear_units: int = 2048
    num_blocks: int = 6
    num_up_blocks: int = 4
    static_chunk_size: int = 25
    pre_lookahead_len: int = 3
    up_stride: int = 2


# ---------------------------------------------------------------------------
# modules (reference names)
# ---------------------------------------------------------------------------


class LinearEmbed(nn.Module):
    """``LinearNoSubsampling``: ``out`` = Linear -> LayerNorm (eps 1e-5)."""

    def __init__(self, din: int, d: int, device=None):
        super().__init__()
        self.out = nn.Sequential(nn.Linear(din, d, device=device),
                                 nn.LayerNorm(d, eps=1e-5, device=device))


class RelPositionMultiHeadedAttention(nn.Module):
    def __init__(self, d: int, heads: int, device=None):
        super().__init__()
        self.linear_q = nn.Linear(d, d, device=device)
        self.linear_k = nn.Linear(d, d, device=device)
        self.linear_v = nn.Linear(d, d, device=device)
        self.linear_out = nn.Linear(d, d, device=device)
        self.linear_pos = nn.Linear(d, d, bias=False, device=device)
        self.pos_bias_u = nn.Parameter(torch.zeros(heads, d // heads,
                                                   device=device))
        self.pos_bias_v = nn.Parameter(torch.zeros(heads, d // heads,
                                                   device=device))


class PositionwiseFeedForward(nn.Module):
    def __init__(self, d: int, units: int, device=None):
        super().__init__()
        self.w_1 = nn.Linear(d, units, device=device)
        self.w_2 = nn.Linear(units, d, device=device)


class ConformerEncoderLayer(nn.Module):
    """Pre-norm rel-pos MHA + pre-norm SiLU FF, eps 1e-12 norms."""

    def __init__(self, d: int, heads: int, units: int, device=None):
        super().__init__()
        self.self_attn = RelPositionMultiHeadedAttention(d, heads, device)
        self.feed_forward = PositionwiseFeedForward(d, units, device)
        self.norm_mha = nn.LayerNorm(d, eps=1e-12, device=device)
        self.norm_ff = nn.LayerNorm(d, eps=1e-12, device=device)


class PreLookaheadLayer(nn.Module):
    def __init__(self, d: int, la: int, device=None):
        super().__init__()
        self.conv1 = nn.Conv1d(d, d, la + 1, device=device)
        self.conv2 = nn.Conv1d(d, d, 3, device=device)


class Upsample1D(nn.Module):
    def __init__(self, d: int, stride: int, device=None):
        super().__init__()
        self.conv = nn.Conv1d(d, d, 2 * stride + 1, device=device)


class UpsampleConformerEncoder(nn.Module):
    def __init__(self, cfg: FlowEncoderConfig, device=None):
        super().__init__()
        self.cfg = cfg
        D, H, U = cfg.output_size, cfg.attention_heads, cfg.linear_units
        self.embed = LinearEmbed(cfg.input_size, D, device)
        self.pre_lookahead_layer = PreLookaheadLayer(
            D, cfg.pre_lookahead_len, device)
        self.encoders = nn.ModuleList(
            ConformerEncoderLayer(D, H, U, device)
            for _ in range(cfg.num_blocks))
        self.up_layer = Upsample1D(D, cfg.up_stride, device)
        self.up_embed = LinearEmbed(cfg.input_size, D, device)
        self.up_encoders = nn.ModuleList(
            ConformerEncoderLayer(D, H, U, device)
            for _ in range(cfg.num_up_blocks))
        self.after_norm = nn.LayerNorm(D, eps=1e-5, device=device)

    def forward(self, xs, xs_lens, context=None, streaming=False):
        return forward(self, xs, xs_lens, self.cfg, context, streaming)


# ---------------------------------------------------------------------------
# functions (JAX names)
# ---------------------------------------------------------------------------


def rel_pos_encoding(size: int, d_model: int) -> np.ndarray:
    """Espnet rel-pos table [2*size-1, d] (positive reversed ++
    negative[1:])."""
    position = np.arange(size, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d_model, 2, np.float32)
                 * -(np.log(10000.0) / d_model))
    pe_pos = np.zeros((size, d_model), np.float32)
    pe_neg = np.zeros((size, d_model), np.float32)
    pe_pos[:, 0::2] = np.sin(position * div)
    pe_pos[:, 1::2] = np.cos(position * div)
    pe_neg[:, 0::2] = np.sin(-position * div)
    pe_neg[:, 1::2] = np.cos(-position * div)
    return np.concatenate([pe_pos[::-1], pe_neg[1:]], axis=0)


def _rel_shift(x: torch.Tensor) -> torch.Tensor:
    """[B, H, T, 2T-1] -> [B, H, T, T] (Transformer-XL shift)."""
    B, H, T, P = x.shape
    zero = x.new_zeros((B, H, T, 1))
    xp = torch.cat([zero, x], dim=-1).reshape(B, H, P + 1, T)
    x = xp[:, :, 1:].reshape(B, H, T, P)
    return x[..., :P // 2 + 1]


def _rel_attention(attn: RelPositionMultiHeadedAttention, x: torch.Tensor,
                   pos_emb: torch.Tensor, mask_bias: Optional[torch.Tensor],
                   heads: int) -> torch.Tensor:
    """Rel-pos MHA. x [B, T, D], pos_emb [2T-1, D]."""
    B, T, D = x.shape
    Dh = D // heads
    q = attn.linear_q(x).reshape(B, T, heads, Dh)
    k = attn.linear_k(x).reshape(B, T, heads, Dh)
    v = attn.linear_v(x).reshape(B, T, heads, Dh)
    p = attn.linear_pos(pos_emb).reshape(-1, heads, Dh)       # [2T-1,H,Dh]

    q_u = (q + attn.pos_bias_u).transpose(1, 2)               # [B,H,T,Dh]
    q_v = (q + attn.pos_bias_v).transpose(1, 2)
    matrix_ac = q_u @ k.permute(0, 2, 3, 1)                   # [B,H,T,T]
    matrix_bd = q_v @ p.permute(1, 2, 0)                      # [B,H,T,2T-1]
    matrix_bd = _rel_shift(matrix_bd)
    scores = (matrix_ac + matrix_bd) / math.sqrt(Dh)
    if mask_bias is not None:
        scores = scores + mask_bias
    w = torch.softmax(scores, dim=-1)
    if mask_bias is not None:
        w = w.masked_fill(mask_bias < -1e20, 0.0)
    out = (w.to(v.dtype) @ v.transpose(1, 2)).transpose(1, 2)
    return attn.linear_out(out.reshape(B, T, D))


def _conformer_layer(layer: ConformerEncoderLayer, x, pos_emb, mask_bias,
                     heads: int) -> torch.Tensor:
    h = layer.norm_mha(x)
    x = x + _rel_attention(layer.self_attn, h, pos_emb, mask_bias, heads)
    h = layer.norm_ff(x)
    h = F.silu(layer.feed_forward.w_1(h))
    return x + layer.feed_forward.w_2(h)


def _causal_conv1d(x: torch.Tensor, conv: nn.Conv1d, left_pad: int,
                   right_pad: int = 0) -> torch.Tensor:
    """x [B, T, C]; conv weight [Cout, Cin, K]."""
    xt = F.pad(x.transpose(1, 2), (left_pad, right_pad))
    return F.conv1d(xt, conv.weight, conv.bias).transpose(1, 2)


def pre_lookahead(layer: PreLookaheadLayer, x: torch.Tensor, la: int,
                  context: Optional[torch.Tensor] = None) -> torch.Tensor:
    """PreLookaheadLayer: pad ``la`` future frames (or read the given
    context), conv k=la+1, leaky_relu, causal conv k=3, residual."""
    if context is not None:
        out = _causal_conv1d(torch.cat([x, context], dim=1), layer.conv1,
                             0, 0)
    else:
        out = _causal_conv1d(x, layer.conv1, 0, la)
    out = F.leaky_relu(out, negative_slope=0.01)
    out = _causal_conv1d(out, layer.conv2, 2, 0)
    return out + x


def upsample1d(layer: Upsample1D, x: torch.Tensor, stride: int
               ) -> torch.Tensor:
    """Nearest repeat + left pad 2*stride + conv k=2*stride+1.
    [B, T, C] -> [B, T*stride, C]."""
    x = torch.repeat_interleave(x, stride, dim=1)
    return _causal_conv1d(x, layer.conv, 2 * stride, 0)


def chunk_mask_bias(T: int, lengths: torch.Tensor, B: int,
                    chunk_size: int = 0) -> torch.Tensor:
    """[B, 1, T, T] additive bias (0 / -1e30) from padding and an optional
    chunk mask."""
    pos = torch.arange(T, device=lengths.device)
    keep = (pos[None, :] < lengths[:, None])[:, None, None, :]
    if chunk_size > 0:
        block = (pos // chunk_size + 1) * chunk_size
        chunk = pos[None, :] < block[:, None]                  # [T, T]
        keep = keep & chunk[None, None]
    zero = torch.zeros((), dtype=torch.float32, device=lengths.device)
    return torch.where(keep, zero, zero - 1e30)


def forward(enc: UpsampleConformerEncoder, xs: torch.Tensor,
            xs_lens: torch.Tensor, cfg: FlowEncoderConfig,
            context: Optional[torch.Tensor] = None,
            streaming: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """xs [B, T, input_size] -> (encoded [B, T*2, output_size],
    out_lens)."""
    B, T, _ = xs.shape
    D = cfg.output_size
    scale = math.sqrt(D)
    dev = xs.device

    x = enc.embed.out(xs) * scale
    pos = torch.from_numpy(rel_pos_encoding(T, D)).to(dev)
    c = enc.embed.out(context) * scale if context is not None else None
    bias = chunk_mask_bias(T, xs_lens, B,
                           cfg.static_chunk_size if streaming else 0)

    x = pre_lookahead(enc.pre_lookahead_layer, x, cfg.pre_lookahead_len, c)
    for layer in enc.encoders:
        x = _conformer_layer(layer, x, pos, bias, cfg.attention_heads)

    x = upsample1d(enc.up_layer, x, cfg.up_stride)
    up_lens = xs_lens * cfg.up_stride
    T2 = x.shape[1]
    x = enc.up_embed.out(x) * scale
    pos2 = torch.from_numpy(rel_pos_encoding(T2, D)).to(dev)
    bias2 = chunk_mask_bias(
        T2, up_lens, B,
        cfg.static_chunk_size * cfg.up_stride if streaming else 0)
    for layer in enc.up_encoders:
        x = _conformer_layer(layer, x, pos2, bias2, cfg.attention_heads)
    return enc.after_norm(x), up_lens


# ---------------------------------------------------------------------------
# random init (the JAX init's draws, in its order)
# ---------------------------------------------------------------------------


def numpy_init_tree(host: np.random.Generator, cfg: FlowEncoderConfig
                    ) -> dict:
    """The JAX ``init_params`` pytree, as numpy, drawn from ``host`` in the
    JAX init's order (the JAX init draws from ``default_rng(0)``)."""
    D, Fu = cfg.output_size, cfg.linear_units
    H = cfg.attention_heads

    def nrm(*shape):
        return host.normal(0, 0.02, shape).astype(np.float32)

    def ln(*lead):
        return {"scale": np.ones((*lead, D), np.float32),
                "bias": np.zeros((*lead, D), np.float32)}

    def zeros(*shape):
        return np.zeros(shape, np.float32)

    def layers(n):
        return {
            "norm_mha": ln(n), "norm_ff": ln(n),
            "attn": {
                "q": {"w": nrm(n, D, D), "b": zeros(n, D)},
                "k": {"w": nrm(n, D, D), "b": zeros(n, D)},
                "v": {"w": nrm(n, D, D), "b": zeros(n, D)},
                "out": {"w": nrm(n, D, D), "b": zeros(n, D)},
                "pos": {"w": nrm(n, D, D)},
                "pos_bias_u": nrm(n, H, D // H),
                "pos_bias_v": nrm(n, H, D // H),
            },
            "ff": {"w1": nrm(n, D, Fu), "b1": zeros(n, Fu),
                   "w2": nrm(n, Fu, D), "b2": zeros(n, D)},
        }

    la = cfg.pre_lookahead_len
    return {
        "embed": {"w": nrm(cfg.input_size, D), "b": zeros(D), "ln": ln()},
        "pre_lookahead": {
            "conv1": {"w": nrm(la + 1, D, D), "b": zeros(D)},
            "conv2": {"w": nrm(3, D, D), "b": zeros(D)},
        },
        "encoders": layers(cfg.num_blocks),
        "up_layer": {"conv": {"w": nrm(2 * cfg.up_stride + 1, D, D),
                              "b": zeros(D)}},
        "up_embed": {"w": nrm(cfg.input_size, D), "b": zeros(D),
                     "ln": ln()},
        "up_encoders": layers(cfg.num_up_blocks),
        "after_norm": ln(),
    }
