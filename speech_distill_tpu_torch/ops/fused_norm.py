"""The decoder layer's elementwise passes: RMSNorm, q/k RMSNorm + NeoX
RoPE, and SwiGLU, as one-pass kernels with their own backward.

No Pallas kernel of the JAX package stands behind these: XLA fuses the
chains there. Run as eager PyTorch, every upcast, square, mean, rsqrt,
product, half-slice, cat, silu and downcast is a kernel that writes its
result to device memory. ``csrc/fused_norm.cu`` does each pass in one
read of its bf16 inputs and one write of its bf16 outputs, with the fp32
math in registers and the bf16 roundings where the plain versions round:

- :func:`rms_norm`: ``bf16((x rstd) w)``;
- :func:`qk_norm_rope`: ``rope(bf16(rms_norm(q)))`` and the same for k,
  in one launch over q's H and k's KV heads (RoPE alone where the model
  has no q/k norm, the Qwen2 backbones); cos/sin are the
  :func:`rope_angles`-shaped tables, [T, Dh] or [B, T, Dh];
- :func:`swiglu`: ``bf16(silu(gate)) * up``.

Each has a plain forward (the chains the model ran before, unchanged), a
plain analytic backward in fp32 with the kernel's rounding points
(``*_bwd_plain``), the kernel wrappers (CUDA tensors only) and an
``autograd.Function`` tying forward and backward, as
``ops/flash_attention.FlashAttention`` does. A backward saves only the
bf16 inputs and recomputes rstd and the normed values. A scale's gradient
is computed only where the scale needs one.

Routing follows the tensors: CUDA bf16 tensors of the widths the kernels
take (:func:`norm_kernel_takes`, :func:`rope_kernel_takes`,
:func:`swiglu_kernel_takes`, asking ``csrc/fused_norm.cu``, which owns the
launch geometry) launch the kernels, which run or raise; a view the
kernels cannot load (not contiguous, or off the 16-byte grid) is copied
first. CPU tensors and every other dtype (the fp32 serving models) take
the plain versions.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from speech_distill_tpu_torch.ops import _cuda

# how far the kernels lie from the plain versions on the same bf16 inputs,
# max |kernel - plain| / max |plain|: both round to bf16 at the same
# points; their fp32 sums (a row's sum of squares, a scale gradient's sum
# over up to 65,536 rows) run in another order and rsqrt differs in its
# last bits, which can move a value across one bf16 rounding step (2^-8 of
# it); 2x slack
PLAIN_REL_TOL = 2.0 ** -7
# csrc/fused_norm.cu fused_norm_grid's ops
_RMS, _QK, _SWIGLU_FWD, _SWIGLU_BWD = range(4)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def rms_norm_plain(x: torch.Tensor, scale: torch.Tensor, eps: float
                   ) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def _rope_tables(cos: torch.Tensor, sin: torch.Tensor):
    """cos/sin [B, T, Dh] or [T, Dh] as [B or 1, T, 1, Dh]."""
    if cos.dim() == 2:
        cos, sin = cos[None], sin[None]
    return cos[:, :, None, :], sin[:, :, None, :]


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: [B, T, N, Dh]; cos/sin: [B, T, Dh] or [T, Dh]; math in fp32."""
    cos, sin = _rope_tables(cos, sin)
    half = x.shape[-1] // 2
    xf = x.float()
    rotated = torch.cat([-xf[..., half:], xf[..., :half]], dim=-1)
    return (xf * cos + rotated * sin).to(x.dtype)


def qk_norm_rope_plain(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
                       sin: torch.Tensor,
                       q_scale: Optional[torch.Tensor] = None,
                       k_scale: Optional[torch.Tensor] = None,
                       eps: float = 1e-6
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rope(rms_norm(q)), rope(rms_norm(k))); without scales RoPE alone."""
    if q_scale is not None:
        q, k = rms_norm_plain(q, q_scale, eps), rms_norm_plain(k, k_scale, eps)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin)


def swiglu_plain(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """The gated MLP's product: SiLU in fp32, rounded, times up."""
    return F.silu(gate.float()).to(gate.dtype) * up


def rms_norm_bwd_plain(x: torch.Tensor, scale: torch.Tensor, eps: float,
                       dy: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx, dscale) of :func:`rms_norm_plain` in fp32, as the kernel
    computes them: rstd from x, dx = rstd (dy w) - x rstd^3 mean((dy w) x)
    rounded to x.dtype, dscale = sum of dy (x rstd) over the rows in
    scale.dtype."""
    xf, g, w = x.float(), dy.float(), scale.float()
    rstd = torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    dyw = g * w
    c = (dyw * xf).mean(-1, keepdim=True) * rstd ** 3
    dx = (dyw * rstd - xf * c).to(x.dtype)
    dscale = (g * (xf * rstd)).reshape(-1, x.shape[-1]).sum(0)
    return dx, dscale.to(scale.dtype)


def rope_bwd_plain(dy: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
                   ) -> torch.Tensor:
    """dx of :func:`apply_rope` in fp32, rounded to dy.dtype (the plain
    rope's input dtype): dy cos plus the partner's dy sin at i + Dh/2
    (i < Dh/2) or minus it at i - Dh/2."""
    cos, sin = _rope_tables(cos, sin)
    g = dy.float()
    gs = g * sin
    half = g.shape[-1] // 2
    return (g * cos + torch.cat([gs[..., half:], -gs[..., :half]],
                                dim=-1)).to(dy.dtype)


def qk_norm_rope_bwd_plain(q, k, cos, sin, q_scale, k_scale, eps, dqo, dko):
    """(dq, dk, dq_scale, dk_scale) of :func:`qk_norm_rope_plain`: the
    rotation's gradient rounded to bf16, then the norm's backward; the
    scales' gradients None without scales."""
    dq, dk = rope_bwd_plain(dqo, cos, sin), rope_bwd_plain(dko, cos, sin)
    if q_scale is None:
        return dq, dk, None, None
    dq, dqs = rms_norm_bwd_plain(q, q_scale, eps, dq)
    dk, dks = rms_norm_bwd_plain(k, k_scale, eps, dk)
    return dq, dk, dqs, dks


def swiglu_bwd_plain(gate: torch.Tensor, up: torch.Tensor, dh: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dgate, dup) of :func:`swiglu_plain`: dup = dh bf16(silu(gate)),
    dg = dh up, each rounded; dgate = dg s (1 + gate (1 - s)) with s the
    sigmoid of gate, rounded."""
    gf = gate.float()
    g = F.silu(gf).to(gate.dtype)
    dup = (dh.float() * g.float()).to(up.dtype)
    dg = (dh.float() * up.float()).to(gate.dtype)
    s = torch.sigmoid(gf)
    dgate = (dg.float() * s * (1 + gf * (1 - s))).to(gate.dtype)
    return dgate, dup


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _takes_width(op: int, width: int) -> bool:
    return _cuda.function("fused_norm_grid")(op, 1, width, 1) > 0


def _routes(t: torch.Tensor, op: int, width: int) -> bool:
    return (t.is_cuda and t.dtype == torch.bfloat16
            and _takes_width(op, width))


def norm_kernel_takes(x: torch.Tensor) -> bool:
    """CUDA bf16 rows of a width the RMSNorm kernels take (D % 8 == 0, up
    to the 1.7B's hidden 2,048)."""
    return _routes(x, _RMS, x.shape[-1])


def rope_kernel_takes(q: torch.Tensor) -> bool:
    """CUDA bf16 heads of 64 or 128."""
    return _routes(q, _QK, q.shape[-1])


def swiglu_kernel_takes(gate: torch.Tensor) -> bool:
    """CUDA bf16 rows of a width that is a multiple of 8."""
    return _routes(gate, _SWIGLU_FWD, gate.shape[-1])


def _ready(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the kernels load it, contiguous on the 16-byte grid: a
    copy where it is not (a view, or a slice at an odd offset)."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


# ---------------------------------------------------------------------------
# Kernel wrappers (CUDA tensors only)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _grid(op: int, units: int, width: int, t: torch.Tensor) -> int:
    """The blocks of a launch's persistent grid, from the kernels'
    source."""
    index = t.device.index
    sms = _sms(torch.cuda.current_device() if index is None else index)
    return _cuda.function("fused_norm_grid")(op, units, width, sms)


def _check(what: str, ok: bool, *tensors) -> None:
    """Raise unless ``ok`` and every tensor is CUDA bf16 on the 16-byte
    grid, and contiguous."""
    if not (ok and all(t.is_cuda and t.dtype == torch.bfloat16
                       and t.data_ptr() % 16 == 0 for t in tensors)):
        got = [(tuple(t.shape), t.dtype, str(t.device)) for t in tensors]
        raise ValueError(f"{what}: the kernel does not take {got}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{what} needs contiguous tensors")


def _rope_tables_ok(q: torch.Tensor, cos: torch.Tensor,
                    sin: torch.Tensor) -> bool:
    """fp32 cos/sin [T, Dh] or [B, T, Dh] on the card, contiguous on the
    16-byte grid."""
    B, T, _, Dh = q.shape
    return all(t.is_cuda and t.dtype == torch.float32 and t.is_contiguous()
               and t.data_ptr() % 16 == 0
               and t.shape in ((T, Dh), (B, T, Dh)) for t in (cos, sin))


def _norm_ok(x: torch.Tensor, scale: torch.Tensor) -> bool:
    return norm_kernel_takes(x) and scale.shape == (x.shape[-1],)


def rms_norm_fwd(x: torch.Tensor, scale: torch.Tensor, eps: float
                 ) -> torch.Tensor:
    """RMSNorm(x) scale from ``csrc/fused_norm.cu`` (bf16, CUDA)."""
    _check("rms_norm_fwd", _norm_ok(x, scale), x, scale)
    D = x.shape[-1]
    rows = x.numel() // D
    y = torch.empty_like(x)
    fn = _cuda.function("rms_norm_fwd")
    _cuda.launches["rms_norm_fwd"] += 1
    _cuda.check(fn(_cuda.ptr(x), _cuda.ptr(scale), _cuda.ptr(y), rows, D,
                   eps, _grid(_RMS, rows, D, x), _cuda.stream_of(x)),
                "rms_norm_fwd")
    return y


def rms_norm_bwd(x: torch.Tensor, scale: torch.Tensor, eps: float,
                 dy: torch.Tensor, need_dscale: bool
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(dx, dscale or None) from ``csrc/fused_norm.cu``; dscale is the sum
    of the kernel's per-block fp32 partials, in scale.dtype."""
    _check("rms_norm_bwd", _norm_ok(x, scale) and dy.shape == x.shape,
           x, scale, dy)
    D = x.shape[-1]
    rows = x.numel() // D
    blocks = _grid(_RMS, rows, D, x)
    dx = torch.empty_like(x)
    part = (torch.empty((blocks, D), dtype=torch.float32, device=x.device)
            if need_dscale else None)
    fn = _cuda.function("rms_norm_bwd")
    _cuda.launches["rms_norm_bwd"] += 1
    _cuda.check(fn(_cuda.ptr(x), _cuda.ptr(scale), _cuda.ptr(dy),
                   _cuda.ptr(dx), None if part is None else _cuda.ptr(part),
                   rows, D, eps, blocks, _cuda.stream_of(x)),
                "rms_norm_bwd")
    return dx, None if part is None else part.sum(0).to(scale.dtype)


def _rope_ok(q, k, cos, sin, q_scale, k_scale) -> bool:
    """q [B, T, H, Dh] and k [B, T, KV, Dh] with a head the kernel takes,
    the tables :func:`_rope_tables_ok`, both scales [Dh] or neither."""
    if q.dim() != 4 or k.dim() != 4 or not rope_kernel_takes(q):
        return False
    Dh = q.shape[3]
    if (q_scale is None) != (k_scale is None):
        return False
    scales = [w for w in (q_scale, k_scale) if w is not None]
    return (k.shape[:2] == q.shape[:2] and k.shape[3] == Dh
            and all(s.shape == (Dh,) for s in scales)
            and _rope_tables_ok(q, cos, sin))


def _rope_args(q, k, cos, q_scale, k_scale):
    B, T, H, Dh = q.shape
    tokens = B * T
    scales = ((None, None) if q_scale is None
              else (_cuda.ptr(q_scale), _cuda.ptr(k_scale)))
    return tokens, H, k.shape[2], Dh, cos.numel() // Dh, scales


def qk_norm_rope_fwd(q, k, cos, sin, q_scale=None, k_scale=None,
                     eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rope(rms_norm(q)), rope(rms_norm(k))) from ``csrc/fused_norm.cu``
    in one launch; without scales RoPE alone."""
    scales = [w for w in (q_scale, k_scale) if w is not None]
    _check("qk_norm_rope_fwd", _rope_ok(q, k, cos, sin, q_scale, k_scale),
           q, k, *scales)
    tokens, H, KV, Dh, cos_rows, (wq, wk) = _rope_args(q, k, cos, q_scale,
                                                       k_scale)
    qo, ko = torch.empty_like(q), torch.empty_like(k)
    fn = _cuda.function("qk_norm_rope_fwd")
    _cuda.launches["qk_norm_rope_fwd"] += 1
    _cuda.check(fn(_cuda.ptr(q), _cuda.ptr(k), _cuda.ptr(cos),
                   _cuda.ptr(sin), wq, wk, _cuda.ptr(qo), _cuda.ptr(ko),
                   tokens, H, KV, Dh, cos_rows, eps,
                   _grid(_QK, tokens, Dh, q), _cuda.stream_of(q)),
                "qk_norm_rope_fwd")
    return qo, ko


def qk_norm_rope_bwd(q, k, cos, sin, q_scale, k_scale, eps, dqo, dko,
                     need_dscale: bool):
    """(dq, dk, dq_scale, dk_scale) from ``csrc/fused_norm.cu``; the
    scales' gradients (sums of per-block fp32 partials) only with
    ``need_dscale``, else None."""
    scales = [w for w in (q_scale, k_scale) if w is not None]
    _check("qk_norm_rope_bwd",
           _rope_ok(q, k, cos, sin, q_scale, k_scale)
           and dqo.shape == q.shape and dko.shape == k.shape,
           q, k, dqo, dko, *scales)
    tokens, H, KV, Dh, cos_rows, (wq, wk) = _rope_args(q, k, cos, q_scale,
                                                       k_scale)
    blocks = _grid(_QK, tokens, Dh, q)
    need_dscale = need_dscale and q_scale is not None
    part = (torch.empty((blocks, 2, Dh), dtype=torch.float32,
                        device=q.device) if need_dscale else None)
    dq, dk = torch.empty_like(q), torch.empty_like(k)
    fn = _cuda.function("qk_norm_rope_bwd")
    _cuda.launches["qk_norm_rope_bwd"] += 1
    _cuda.check(fn(_cuda.ptr(q), _cuda.ptr(k), _cuda.ptr(dqo),
                   _cuda.ptr(dko), _cuda.ptr(cos), _cuda.ptr(sin), wq, wk,
                   _cuda.ptr(dq), _cuda.ptr(dk),
                   None if part is None else _cuda.ptr(part), tokens, H, KV,
                   Dh, cos_rows, eps, blocks, _cuda.stream_of(q)),
                "qk_norm_rope_bwd")
    if part is None:
        return dq, dk, None, None
    ds = part.sum(0)
    return dq, dk, ds[0].to(q_scale.dtype), ds[1].to(k_scale.dtype)


def swiglu_fwd(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """bf16(silu(gate)) * up from ``csrc/fused_norm.cu``."""
    _check("swiglu_fwd", swiglu_kernel_takes(gate) and up.shape == gate.shape,
           gate, up)
    h = torch.empty_like(gate)
    n = gate.numel()
    fn = _cuda.function("swiglu_fwd")
    _cuda.launches["swiglu_fwd"] += 1
    _cuda.check(fn(_cuda.ptr(gate), _cuda.ptr(up), _cuda.ptr(h), n,
                   _grid(_SWIGLU_FWD, n, gate.shape[-1], gate),
                   _cuda.stream_of(gate)), "swiglu_fwd")
    return h


def swiglu_bwd(gate: torch.Tensor, up: torch.Tensor, dh: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dgate, dup) from ``csrc/fused_norm.cu``, silu recomputed."""
    _check("swiglu_bwd", swiglu_kernel_takes(gate) and up.shape == gate.shape
           and dh.shape == gate.shape, gate, up, dh)
    dgate, dup = torch.empty_like(gate), torch.empty_like(up)
    n = gate.numel()
    fn = _cuda.function("swiglu_bwd")
    _cuda.launches["swiglu_bwd"] += 1
    _cuda.check(fn(_cuda.ptr(gate), _cuda.ptr(up), _cuda.ptr(dh),
                   _cuda.ptr(dgate), _cuda.ptr(dup), n,
                   _grid(_SWIGLU_BWD, n, gate.shape[-1], gate),
                   _cuda.stream_of(gate)), "swiglu_bwd")
    return dgate, dup


# ---------------------------------------------------------------------------
# Autograd and the routed functions
# ---------------------------------------------------------------------------


class RMSNorm(torch.autograd.Function):
    """The kernels' RMSNorm; saves x and the scale only."""

    @staticmethod
    def forward(ctx, x, scale, eps: float):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return rms_norm_fwd(x, scale, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, ds = rms_norm_bwd(x, scale, ctx.eps, _ready(dy),
                              ctx.needs_input_grad[1])
        return dx, ds, None


class QkNormRope(torch.autograd.Function):
    """The kernels' q/k RMSNorm + RoPE (RoPE alone without scales); saves
    the bf16 q and k, the tables and the scales."""

    @staticmethod
    def forward(ctx, q, k, cos, sin, q_scale, k_scale, eps: float):
        ctx.save_for_backward(q, k, cos, sin, q_scale, k_scale)
        ctx.eps = eps
        return qk_norm_rope_fwd(q, k, cos, sin, q_scale, k_scale, eps)

    @staticmethod
    def backward(ctx, dqo, dko):
        q, k, cos, sin, q_scale, k_scale = ctx.saved_tensors
        need = ctx.needs_input_grad[4] or ctx.needs_input_grad[5]
        dq, dk, dqs, dks = qk_norm_rope_bwd(
            q, k, cos, sin, q_scale, k_scale, ctx.eps, _ready(dqo),
            _ready(dko), need)
        return dq, dk, None, None, dqs, dks, None


class SwiGLU(torch.autograd.Function):
    """The kernels' SwiGLU; saves gate and up."""

    @staticmethod
    def forward(ctx, gate, up):
        ctx.save_for_backward(gate, up)
        return swiglu_fwd(gate, up)

    @staticmethod
    def backward(ctx, dh):
        gate, up = ctx.saved_tensors
        return swiglu_bwd(gate, up, _ready(dh))


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    """RMSNorm over the last axis in fp32, rounded to x.dtype: the kernel
    on CUDA bf16 rows of a width it takes (and it raises on a scale it
    cannot take), else :func:`rms_norm_plain`."""
    if norm_kernel_takes(x):
        return RMSNorm.apply(_ready(x), _ready(scale), eps)
    return rms_norm_plain(x, scale, eps)


def qk_norm_rope(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor, q_scale: Optional[torch.Tensor] = None,
                 k_scale: Optional[torch.Tensor] = None, eps: float = 1e-6
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rope(rms_norm(q)), rope(rms_norm(k))), or RoPE alone without
    scales: one kernel launch on CUDA bf16 heads it takes (which raises on
    k, tables or scales it cannot take), else
    :func:`qk_norm_rope_plain`."""
    if rope_kernel_takes(q):
        scales = [None if w is None else _ready(w)
                  for w in (q_scale, k_scale)]
        return QkNormRope.apply(_ready(q), _ready(k), _ready(cos),
                                _ready(sin), *scales, eps)
    return qk_norm_rope_plain(q, k, cos, sin, q_scale, k_scale, eps)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """bf16(silu(gate)) * up: the kernel on CUDA bf16 rows of a width it
    takes (which raises on an up it cannot take), else
    :func:`swiglu_plain`."""
    if swiglu_kernel_takes(gate):
        return SwiGLU.apply(_ready(gate), _ready(up))
    return swiglu_plain(gate, up)
