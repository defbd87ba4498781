"""Fused lm-head statistics: the vocab-tiled head product with an online
logsumexp, never materialising the [N, V] logits (port of
``speech_distill_tpu/ops/pallas_lm_loss.py``, kernel K2).

  forward:  lse1[n], lseT[n] (logsumexp of h W^T at temperatures 1 and T)
            and label_logit[n], from h [N, D] and W [V, D]
  backward: dlogits = a1 * softmax_1 + (aT / T) * softmax_T + b * onehot,
            cast to W's dtype, then dh = dlogits W and dW = dlogits^T h,
            with the logits recomputed from the saved lse.

The forward's [N, V] logits never reach memory. The backward kernels
keep one vocab chunk of dlogits, bf16 [Vc, N] (transposed), in a device
scratch between the two GEMMs of each chunk (:func:`_bwd_plan` sizes
it), as the plain backward keeps one fp32 chunk. A label outside [0, V)
never hits: its label_logit is -1e30 and its onehot term is zero.
:func:`lm_head_stats` is the autograd op (the JAX custom VJP): CUDA
tensors launch the hand-written kernels of ``csrc/lm_head_stats.cu``
(stats, dh, dW) or raise; CPU tensors take the plain versions,
:func:`lm_head_stats_plain` and :func:`lm_head_stats_bwd_plain`, which
compute in fp32, chunked over the vocab so that they run at the real V.
:func:`gathered_logits` (logits at given columns) is plain tensor code,
not a kernel.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from speech_distill_tpu_torch.core.metrics import span
from speech_distill_tpu_torch.ops import _cuda

NEG_INF = -1e30
PLAIN_CHUNK = 8192          # vocab columns per step of the plain versions
KERNEL_DIMS = (64, 128, 256, 512, 1024)   # hidden sizes the kernels take
# the backward kernels: dlogits tiles of 128 rows x 256 vocab columns and
# a vocab chunk of at most BWD_CHUNK columns at a time
TILE_ROWS, TILE_V = 128, 256
BWD_CHUNK = 8192
# the stats kernel's vocab splits: at most this many, and the fewest whose
# busiest block sweeps within this share of the best split's tiles
STATS_MAX_SPLITS, STATS_BALANCE = 64, 0.01

Stats = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def online_update(m: torch.Tensor, s: torch.Tensor, x: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step of the online logsumexp: the running max m [N] and sum
    s [N] (of exp(. - m)) after the columns x [N, C]."""
    m_new = torch.maximum(m, x.amax(1))
    return m_new, s * torch.exp(m - m_new) + torch.exp(
        x - m_new[:, None]).sum(1)


def _chunk_update(m1, s1, m_t, s_t, lab, h, w_chunk, c0: int,
                  labels: Optional[torch.Tensor], temperature: float):
    """The running (m, s) at temperatures 1 and T and the label logit after
    the vocab columns [c0, c0 + C) of W; ``labels`` None skips the label."""
    z = h.float() @ w_chunk.float().t()                        # [N, C]
    m1, s1 = online_update(m1, s1, z)
    m_t, s_t = online_update(m_t, s_t, z / temperature)
    if labels is not None:
        cols = torch.arange(c0, c0 + z.shape[1], device=h.device)
        hit = cols[None, :] == labels[:, None]
        lab = torch.maximum(lab, torch.where(hit, z, NEG_INF).amax(1))
    return m1, s1, m_t, s_t, lab


def chunked_stats(h: torch.Tensor, w: torch.Tensor,
                  labels: Optional[torch.Tensor], temperature: float,
                  chunk: int = PLAIN_CHUNK,
                  checkpointed: bool = False) -> Stats:
    """(lse1, lseT, label_logit), each [N] fp32, from fp32 products over
    vocab chunks with the kernels' online update. ``labels`` None leaves
    the label logit at -1e30; ``checkpointed`` recomputes each chunk's
    [N, chunk] logits in the backward instead of keeping them."""
    N = h.shape[0]
    if labels is not None:
        labels = labels.long()
    kw = dict(dtype=torch.float32, device=h.device)
    carry = (torch.full((N,), NEG_INF, **kw), torch.zeros(N, **kw),
             torch.full((N,), NEG_INF, **kw), torch.zeros(N, **kw),
             torch.full((N,), NEG_INF, **kw))
    for c0 in range(0, w.shape[0], chunk):
        args = (*carry, h, w[c0:c0 + chunk], c0, labels, temperature)
        carry = (checkpoint(_chunk_update, *args, use_reentrant=False)
                 if checkpointed else _chunk_update(*args))
    m1, s1, m_t, s_t, lab = carry
    return (m1 + torch.log(s1.clamp_min(1e-30)),
            m_t + torch.log(s_t.clamp_min(1e-30)), lab)


def lm_head_stats_plain(h: torch.Tensor, w: torch.Tensor,
                        labels: torch.Tensor, temperature: float = 2.0,
                        chunk: int = PLAIN_CHUNK) -> Stats:
    """(lse1, lseT, label_logit), each [N] fp32, in fp32 over vocab chunks
    with the kernels' online update."""
    return chunked_stats(h, w, labels, temperature, chunk)


def lm_head_stats_bwd_plain(h: torch.Tensor, w: torch.Tensor,
                            labels: torch.Tensor, lse1: torch.Tensor,
                            lse_t: torch.Tensor, a1: torch.Tensor,
                            a_t: torch.Tensor, b: torch.Tensor,
                            temperature: float = 2.0,
                            chunk: int = PLAIN_CHUNK
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dh in h's dtype, dW in W's dtype) for the cotangents (a1, aT, b)
    of (lse1, lseT, label_logit): fp32 products of dlogits rounded to the
    operand dtypes, as the TPU kernels round them."""
    V = w.shape[0]
    hf = h.float()
    labels = labels.long()
    f32 = torch.float32
    a1, b = a1.to(f32)[:, None], b.to(f32)[:, None]
    c_t = (a_t.to(f32) / temperature)[:, None]
    dh = torch.zeros(hf.shape, dtype=f32, device=h.device)
    dw = torch.empty((V, h.shape[1]), dtype=f32, device=h.device)
    for c0 in range(0, V, chunk):
        wc = w[c0:c0 + chunk].float()
        z = hf @ wc.t()
        cols = torch.arange(c0, c0 + z.shape[1], device=h.device)
        onehot = (cols[None, :] == labels[:, None]).to(f32)
        dl = (a1 * torch.exp(z - lse1[:, None])
              + c_t * torch.exp(z / temperature - lse_t[:, None])
              + b * onehot)
        dh += dl.to(w.dtype).float() @ wc
        dw[c0:c0 + chunk] = dl.to(h.dtype).float().t() @ hf
    return dh.to(h.dtype), dw.to(w.dtype)


def _check(h, w, labels, *rows) -> None:
    """What the kernels take: contiguous bf16 h [N, D] and W [V, D] on one
    card, D in :data:`KERNEL_DIMS`, int32 labels and fp32 rows [N]."""
    N, D = h.shape
    if w.dim() != 2 or w.shape[1] != D:
        raise ValueError(f"lm_head kernels need W [V, {D}], got "
                         f"{tuple(w.shape)}")
    if h.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"lm_head kernels take bf16 h and W, got {h.dtype} "
                         f"/ {w.dtype}")
    if D not in KERNEL_DIMS:
        raise ValueError(f"lm_head kernels take D in {KERNEL_DIMS}, got {D}")
    for name, t, dtype in [("h", h, None), ("w", w, None),
                           ("labels", labels, torch.int32)] + [
            (f"row {i}", r, torch.float32) for i, r in enumerate(rows)]:
        if t.device != h.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {h.device}")
        if dtype is not None and (t.dtype != dtype or t.shape != (N,)):
            raise ValueError(f"{name} must be {dtype} [{N}], got {t.dtype} "
                             f"{tuple(t.shape)}")


class StatsPlan(NamedTuple):
    """The work of K2-stats: units of 128 rows x one vocab split, walked
    by a persistent grid of ``grid`` blocks (unit u = split * row_tiles +
    row tile; block b takes units b, b + grid, ...)."""
    splits: int                     # vocab splits, none empty
    per: int                        # vocab tiles a split (the last fewer)
    row_tiles: int
    vocab_tiles: int
    grid: int                       # blocks, min(units, SMs)
    makespan: int                   # most vocab tiles one block sweeps


@functools.lru_cache(maxsize=64)
def _stats_plan(N: int, V: int, sms: int) -> StatsPlan:
    """The vocab splits of the stats kernel that balance its persistent
    grid: for each split count up to :data:`STATS_MAX_SPLITS` with no
    empty split, the most 128 x 256 tiles any block sweeps; the fewest
    splits within :data:`STATS_BALANCE` of the best (each split adds a
    [5, N] fp32 partial and its unit's pipeline start)."""
    n_rt = -(-N // TILE_ROWS)
    n_vt = -(-V // TILE_V)
    plans = []
    for splits in range(1, min(STATS_MAX_SPLITS, n_vt) + 1):
        per = -(-n_vt // splits)
        if (splits - 1) * per >= n_vt:
            continue                                # an empty split
        grid = min(n_rt * splits, sms)
        load = [0] * grid
        for u in range(n_rt * splits):
            load[u % grid] += min(per, n_vt - (u // n_rt) * per)
        plans.append(StatsPlan(splits, per, n_rt, n_vt, grid, max(load)))
    best = min(p.makespan for p in plans)
    return next(p for p in plans
                if p.makespan <= best * (1 + STATS_BALANCE))


def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def lm_head_stats_kernel(h: torch.Tensor, w: torch.Tensor,
                         labels: torch.Tensor, temperature: float) -> Stats:
    """K2-stats on the card (CUDA tensors only): ``lm_head_stats`` over
    the vocab splits of :func:`_stats_plan`, then the small combine
    pass."""
    _check(h, w, labels)
    N, D = h.shape
    V = w.shape[0]
    splits = _stats_plan(N, V, _sm_count(h.device)).splits
    part = torch.empty((splits, 5, N), dtype=torch.float32, device=h.device)
    out = [torch.empty(N, dtype=torch.float32, device=h.device)
           for _ in range(3)]
    fn = _cuda.function("lm_head_stats")
    _cuda.launches["lm_head_stats"] += 1
    _cuda.check(fn(*(_cuda.ptr(t) for t in (h, w, labels, part, *out)),
                   N, V, D, splits, float(temperature), _cuda.stream_of(h)),
                "lm_head_stats")
    return tuple(out)


class BwdPlan(NamedTuple):
    """The vocab chunk of K2-dh and K2-dW and their scratch; the C entries
    walk the chunks [c0, c0 + chunk) over [0, V) themselves."""
    chunk: int                      # columns a chunk, a multiple of TILE_V
    ld: int                         # tokens a row of the dl^T chunk
    dh_bytes: int                   # dl^T [chunk, ld] bf16 + fp32 partial
    dw_bytes: int                   # dl^T [chunk, ld] bf16


def _bwd_plan(N: int, V: int, D: int) -> BwdPlan:
    """Chunks of :data:`BWD_CHUNK` vocab columns, or V rounded up to the
    tile where that is fewer; dh's fp32 partial [N, D] only when V takes
    more than one chunk."""
    rup = lambda x, m: -(-x // m) * m                          # noqa: E731
    ld = rup(N, TILE_ROWS)
    chunk = min(BWD_CHUNK, rup(V, TILE_V))
    part = N * D * 4 if V > chunk else 0
    return BwdPlan(chunk, ld, chunk * ld * 2 + part, chunk * ld * 2)


def _bwd_call(name: str, h, w, labels, lse1, lse_t, a1, a_t, b,
              temperature: float, out: torch.Tensor) -> torch.Tensor:
    _check(h, w, labels, lse1, lse_t, a1, a_t, b)
    N, D = h.shape
    V = w.shape[0]
    plan = _bwd_plan(N, V, D)
    dl = torch.empty((plan.chunk, plan.ld), dtype=torch.bfloat16,
                     device=h.device)
    part = (torch.empty((N, D), dtype=torch.float32, device=h.device)
            if name == "lm_head_dh" and V > plan.chunk else None)
    fn = _cuda.function(name)
    _cuda.launches[name] += 1
    _cuda.check(fn(*(_cuda.ptr(t) for t in (h, w, labels, lse1, lse_t, a1,
                                            a_t, b, out, dl)),
                   None if part is None else _cuda.ptr(part), N, V, D,
                   plan.chunk, plan.ld, float(temperature),
                   _cuda.stream_of(h)), name)
    return out


def lm_head_dh(h, w, labels, lse1, lse_t, a1, a_t, b,
               temperature: float) -> torch.Tensor:
    """K2-dh on the card (CUDA tensors only): dh [N, D] bf16, two kernels
    a vocab chunk (dlogits, then their product with W's chunk rows)."""
    return _bwd_call("lm_head_dh", h, w, labels, lse1, lse_t, a1, a_t, b,
                     temperature, torch.empty_like(h))


def lm_head_dw(h, w, labels, lse1, lse_t, a1, a_t, b,
               temperature: float) -> torch.Tensor:
    """K2-dW on the card (CUDA tensors only): dW [V, D] bf16, every row,
    two kernels a vocab chunk (dlogits, then their transpose times h)."""
    return _bwd_call("lm_head_dw", h, w, labels, lse1, lse_t, a1, a_t, b,
                     temperature, torch.empty_like(w))


class LMHeadStats(torch.autograd.Function):
    """(lse1, lseT, label_logit) with the kernels' backward; saves h, W,
    labels, lse1 and lseT, as the JAX custom VJP does."""

    @staticmethod
    def forward(ctx, h, w, labels, temperature):
        if h.is_cuda:
            labels = labels.to(torch.int32).contiguous()
            h, w = h.contiguous(), w.contiguous()
            out = lm_head_stats_kernel(h, w, labels, temperature)
        else:
            out = lm_head_stats_plain(h, w, labels, temperature)
        ctx.save_for_backward(h, w, labels, out[0], out[1])
        ctx.temperature = temperature
        return out

    @staticmethod
    def backward(ctx, d_lse1, d_lse_t, d_label):
        h, w, labels, lse1, lse_t = ctx.saved_tensors
        T = ctx.temperature
        with span("train.head"):
            rows = [g.float().contiguous()
                    for g in (d_lse1, d_lse_t, d_label)]
            if h.is_cuda:
                args = (h, w, labels, lse1, lse_t, *rows, T)
                return lm_head_dh(*args), lm_head_dw(*args), None, None
            dh, dw = lm_head_stats_bwd_plain(h, w, labels, lse1, lse_t,
                                             *rows, T)
            return dh, dw, None, None


def lm_head_stats(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                  temperature: float = 2.0) -> Stats:
    """(lse1 [N], lseT [N], label_logit [N]) fp32 from h [N, D] and
    W [V, D], differentiable in h and W: the K2 kernels on CUDA tensors
    (which raise on what they cannot take), the plain versions on CPU
    tensors."""
    return LMHeadStats.apply(h, w, labels, float(temperature))


def gathered_logits(h: torch.Tensor, w: torch.Tensor, idx: torch.Tensor,
                    chunk: int = 512) -> torch.Tensor:
    """Logits at the columns ``idx`` [N, K]: fp32 products of h [N, D] with
    the gathered W rows, checkpointed per chunk of N rows so the [chunk, K,
    D] gather is never kept for the backward (its gradient is a
    scatter-add into dW). Returns [N, K] fp32."""
    def one(hc, ic, w):
        return torch.einsum("nd,nkd->nk", hc.float(), w[ic].float())
    outs = [checkpoint(one, h[i:i + chunk], idx[i:i + chunk], w,
                       use_reentrant=False)
            for i in range(0, h.shape[0], chunk)]
    return torch.cat(outs, 0)
