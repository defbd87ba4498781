"""Paged decode attention: single-token queries over a block-table KV pool.

Port of ``speech_distill_tpu/ops/paged_attention.py``: bf16 and fp32
pools, and int8 pools with one fp32 scale per (token, KV head)
(:func:`quantize_kv`).

Layouts (decode step, T == 1):
  q            [B, KV, G, Dh]        (H = KV * G query heads, GQA-grouped)
  k/v pool     [L, P, KV, ps, Dh]    (the FULL per-layer pool; ``layer``
                                      picks the layer inside the kernel,
                                      so the layer loop never copies one)
  block_tables [B, max_pages] int32  (entries beyond ceil(len/ps) are junk
                                      and never read)
  lengths      [B] int32             (valid keys incl. the current token;
                                      0 => row idle, output exact zeros)
  k/v scales   [L, P, KV, ps] fp32   (int8 pools only)

A pool without the layer axis, [P, KV, ps, Dh] (scales [P, KV, ps]), is
read as a pool of one layer, as the JAX ``layer=None``.

:func:`paged_attention` launches the hand-written CUDA kernels of
``csrc/paged_decode.cu`` (the counterpart of the TPU ``_decode_kernel``):
``paged_decode`` for bf16/fp32 pools, ``paged_decode_int8`` for int8
pools, each a flash-decoding kernel whose key-range splits
(:func:`k4_plan`) meet in one thread-block cluster; for CPU tensors it
runs :func:`paged_attention_plain`.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from speech_distill_tpu_torch.ops import _cuda

NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# K4's plan: at most MAX_SPLITS splits of a row's pages (one portable
# thread-block cluster), enough to put BLOCKS_PER_SM blocks a SM on the
# card; stages of about STAGE_BYTES of K and V rows, at most MAX_STAGES in
# a block's ring (the fastest stage size and depth of those measured on
# an H100, PERF.md section 6)
MAX_SPLITS, BLOCKS_PER_SM, STAGE_BYTES, MAX_STAGES = 8, 8, 32768, 2


class K4Plan(NamedTuple):
    """How one call of the kernel walks a row's pages: split r of the
    row's cluster owns pages [r * pages_per_split, (r + 1) *
    pages_per_split) below ceil(len / page_size), streamed in stages of
    ``stage_tokens`` rows of one page through a ring of ``stages``."""
    splits: int
    pages_per_split: int
    stage_tokens: int
    stages: int


def k4_plan(B: int, KV: int, max_pages: int, page_size: int, Dh: int,
            dtype: torch.dtype, sms: int) -> K4Plan:
    """The kernel's plan for B rows of KV heads over a block table of
    ``max_pages`` pages of ``page_size`` rows of Dh values of the pool's
    ``dtype``, on a card of ``sms`` SMs. From static shapes only: the
    launch never reads ``lengths`` on the host (no sync, capturable in a
    CUDA graph). As many splits as put BLOCKS_PER_SM blocks a SM on the
    card, at most MAX_SPLITS and at most one a page, then as few as give
    the same pages a split (so no split lies past the last page). A stage
    is the largest divisor of the page of at most STAGE_BYTES of K and V
    rows (int8: a multiple of 4 rows, so each scale run starts 16-byte
    aligned)."""
    want = max(1, min(MAX_SPLITS, max_pages,
                      -(-BLOCKS_PER_SM * sms // max(1, B * KV))))
    pps = -(-max_pages // want)
    itemsize = torch.empty((), dtype=dtype).element_size()
    step = 4 if dtype == torch.int8 else 1
    target = max(step, STAGE_BYTES // (2 * Dh * itemsize))
    st = max([t for t in range(step, page_size + 1, step)
              if page_size % t == 0 and t <= target] or [page_size])
    stages = max(1, min(MAX_STAGES, pps * (page_size // st)))
    return K4Plan(-(-max_pages // pps), pps, st, stages)


def quantize_kv(x: torch.Tensor, dim: int = -1):
    """Symmetric int8 with one scale per slice along ``dim`` (per token
    per KV head when x is [..., Dh]). Returns (q int8, scale fp32 with
    ``dim`` squeezed). Exact zeros stay exact (scale 1)."""
    xf = x.float()
    amax = xf.abs().amax(dim=dim, keepdim=True)
    scl = torch.where(amax > 0, amax / 127.0, 1.0)
    q = (xf / scl).round_().clamp_(-127, 127).to(torch.int8)
    return q, scl.squeeze(dim)


def _full_pool(k_pool, v_pool, k_scale, v_scale, layer):
    """A one-layer pool [P, KV, ps, Dh] as layer 0 of [1, P, KV, ps, Dh]."""
    if k_pool.dim() == 4:
        k_pool, v_pool = k_pool[None], v_pool[None]
        if k_scale is not None:
            k_scale, v_scale = k_scale[None], v_scale[None]
        layer = 0
    return k_pool, v_pool, k_scale, v_scale, layer


def paged_attention_plain(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, block_tables: torch.Tensor,
                          lengths: torch.Tensor, layer: int = 0,
                          k_scale: Optional[torch.Tensor] = None,
                          v_scale: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Gather-based plain version (counterpart of ``paged_attention_xla``):
    materializes the gathered KV [B, max_pages*ps, KV, Dh] (an int8 pool
    dequantized after the gather, in q.dtype) and runs a masked fp32
    softmax. Same arguments and result as the kernel."""
    k_pool, v_pool, k_scale, v_scale, layer = _full_pool(
        k_pool, v_pool, k_scale, v_scale, layer)
    B, KV, G, Dh = q.shape
    ps = k_pool.shape[3]
    mp = block_tables.shape[1]
    bt = block_tables.long()
    k = k_pool[layer][bt]                   # [B, mp, KV, ps, Dh]
    v = v_pool[layer][bt]
    if k_pool.dtype == torch.int8:
        if k_scale is None or v_scale is None:
            raise ValueError("int8 pools require k_scale/v_scale")
        dt = q.dtype
        k = k.to(dt) * k_scale[layer][bt][..., None].to(dt)
        v = v.to(dt) * v_scale[layer][bt][..., None].to(dt)
    k = k.transpose(2, 3).reshape(B, mp * ps, KV, Dh)
    v = v.transpose(2, 3).reshape(B, mp * ps, KV, Dh)
    s = torch.einsum("bkgd,bskd->bkgs", q.float(), k.float()) * Dh ** -0.5
    valid = (torch.arange(mp * ps, device=q.device)[None]
             < lengths.long()[:, None])                       # [B, S]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(v.dtype), v)
    # idle rows (length 0) are fully masked: zero them like the kernel
    out = torch.where((lengths > 0)[:, None, None, None], out, 0)
    return out.to(q.dtype)


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, block_tables: torch.Tensor,
                    lengths: torch.Tensor, layer: int = 0,
                    k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [B, KV, G, Dh] -> [B, KV, G, Dh] over the full pool's ``layer``
    (int8 pools with their per-token scales).

    CPU tensors take :func:`paged_attention_plain`. CUDA tensors launch
    ``csrc/paged_decode.cu`` or raise; there is no fallback."""
    if not q.is_cuda:
        return paged_attention_plain(q, k_pool, v_pool, block_tables,
                                     lengths, layer, k_scale, v_scale)
    k_pool, v_pool, k_scale, v_scale, layer = _full_pool(
        k_pool, v_pool, k_scale, v_scale, layer)
    quantized = k_pool.dtype == torch.int8
    B, KV, G, Dh = q.shape
    if k_pool.dim() != 5 or k_pool.shape != v_pool.shape:
        raise ValueError(f"pools must be [L, P, KV, ps, Dh], got "
                         f"{tuple(k_pool.shape)} / {tuple(v_pool.shape)}")
    L, P, KVp, ps, Dhp = k_pool.shape
    if (KVp, Dhp) != (KV, Dh):
        raise ValueError(f"q {tuple(q.shape)} does not match pool "
                         f"{tuple(k_pool.shape)}")
    pool_dt = torch.int8 if quantized else q.dtype
    if q.dtype not in _DTYPE_CODE or k_pool.dtype != pool_dt \
            or v_pool.dtype != pool_dt:
        raise ValueError(f"paged_decode takes bf16 or fp32 q and pools of "
                         f"the same dtype or int8, got {q.dtype}/"
                         f"{k_pool.dtype}/{v_pool.dtype}")
    if Dh % (16 if quantized else 8) or Dh > 256 or G > 16:
        raise ValueError(f"paged_decode supports Dh % 8 == 0 (int8: 16), "
                         f"Dh <= 256, G <= 16; got Dh={Dh}, G={G}")
    if quantized:
        if k_scale is None or v_scale is None:
            raise ValueError("int8 pools require k_scale/v_scale")
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if t.shape != k_pool.shape[:-1] or t.dtype != torch.float32:
                raise ValueError(f"{name} must be fp32 "
                                 f"{tuple(k_pool.shape[:-1])}, got "
                                 f"{t.dtype} {tuple(t.shape)}")
            if t.device != q.device or not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous on {q.device}")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("block_tables and lengths must be int32")
    if block_tables.dim() != 2 or block_tables.shape[0] != B \
            or lengths.shape != (B,):
        raise ValueError(f"block_tables [B, max_pages] / lengths [B] do "
                         f"not match B={B}")
    if not 0 <= int(layer) < L:
        raise ValueError(f"layer {layer} outside the pool's {L} layers")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_tables", block_tables), ("lengths", lengths)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {q.device}")
    # the bulk copies need 16-byte aligned sources: the bases of q, the
    # pools and the scales, and (int8) every page's run of ps scales
    if any(t.data_ptr() % 16 for t in (q, k_pool, v_pool)) or quantized and (
            ps % 4 or k_scale.data_ptr() % 16 or v_scale.data_ptr() % 16):
        raise ValueError(f"paged_decode needs 16-byte aligned q, pools and "
                         f"scales, and (int8) page_size % 4 == 0; got "
                         f"page_size={ps}")
    mp = block_tables.shape[1]
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    plan = k4_plan(B, KV, mp, ps, Dh, k_pool.dtype, sms)
    out = torch.empty_like(q)
    if quantized:
        fn = _cuda.function("paged_decode_int8")
        _cuda.launches["paged_decode_int8"] += 1
        _cuda.check(fn(_cuda.ptr(q), _cuda.ptr(k_pool), _cuda.ptr(v_pool),
                       _cuda.ptr(k_scale), _cuda.ptr(v_scale),
                       _cuda.ptr(block_tables), _cuda.ptr(lengths),
                       _cuda.ptr(out), B, KV, G, Dh, P, ps, mp, int(layer),
                       *plan, Dh ** -0.5, _DTYPE_CODE[q.dtype],
                       _cuda.stream_of(q)), "paged_decode_int8")
        return out
    fn = _cuda.function("paged_decode")
    _cuda.launches["paged_decode"] += 1
    _cuda.check(fn(_cuda.ptr(q), _cuda.ptr(k_pool), _cuda.ptr(v_pool),
                   _cuda.ptr(block_tables), _cuda.ptr(lengths),
                   _cuda.ptr(out), B, KV, G, Dh, P, ps, mp, int(layer),
                   *plan, Dh ** -0.5, _DTYPE_CODE[q.dtype],
                   _cuda.stream_of(q)), "paged_decode")
    return out
