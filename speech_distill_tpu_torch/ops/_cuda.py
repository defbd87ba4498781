"""Build and load the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/<source>.cu`` exposes plain C entry points (:data:`SOURCES`
says which; ``csrc/*.cuh`` holds what several sources share) and is
compiled by
``nvcc -gencode arch=compute_90a,code=sm_90a -shared`` into
``build/lib<source>-<source hash>.so`` at first use, then loaded with
ctypes. Pointers and the stream cross the boundary as ``c_void_p``; each C
entry returns ``cudaGetLastError()`` and :func:`check` raises on a
non-zero code. Nothing here runs at import time: this module imports on
machines that have no nvcc and no GPU.

Launch counts live in :data:`launches`: every kernel wrapper adds one
where it launches its kernel, and nowhere else. The entries of
:data:`QUERIES` launch nothing (a source's answer about its own launch
geometry) and have no count.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
# C signature of each entry point
SIGNATURES = {
    # q, k_pool, v_pool, block_tables, lengths, out,
    # B, KV, G, Dh, P, ps, max_pages, layer, then the plan: splits, pages
    # per split, stage tokens, stages; scale, dtype, stream
    "paged_decode": [_P] * 6 + [_I] * 12 + [_F, _I, _P],
    # q, k_pool, v_pool, k_scale, v_scale, block_tables, lengths, out,
    # B, KV, G, Dh, P, ps, max_pages, layer, the plan, scale, q dtype,
    # stream
    "paged_decode_int8": [_P] * 8 + [_I] * 12 + [_F, _I, _P],
    # x, packed, scale, out, M, N, K2, ldx, splits, out dtype, stream
    "int4_matmul": [_P] * 4 + [_I] * 6 + [_P],
    # q, k, v, o, lse, B, T, H, KV, Dh, scale, stream
    "flash_fwd": [_P] * 5 + [_I] * 5 + [_F, _P],
    # q, k, v, dO, lse, delta, dq, B, T, H, KV, Dh, scale, stream
    "flash_dq": [_P] * 7 + [_I] * 5 + [_F, _P],
    # q, k, v, dO, lse, delta, dk, dv, B, T, H, KV, Dh, scale, stream
    "flash_dkv": [_P] * 8 + [_I] * 5 + [_F, _P],
    # h, w, labels, partials, lse1, lseT, label_logit, N, V, D, splits,
    # temperature, stream
    "lm_head_stats": [_P] * 7 + [_I] * 4 + [_F, _P],
    # h, w, labels, lse1, lseT, a1, aT, b, out, dl scratch, fp32 partial,
    # N, V, D, chunk, ld, temperature, stream
    "lm_head_dh": [_P] * 11 + [_I] * 5 + [_F, _P],
    "lm_head_dw": [_P] * 11 + [_I] * 5 + [_F, _P],
    # x, scale, y, rows, D, eps, blocks, stream
    "rms_norm_fwd": [_P] * 3 + [_I] * 2 + [_F, _I, _P],
    # x, scale, dy, dx, scale partials (or null), rows, D, eps, blocks,
    # stream
    "rms_norm_bwd": [_P] * 5 + [_I] * 2 + [_F, _I, _P],
    # q, k, cos, sin, q scale, k scale (both null: RoPE alone), q out,
    # k out, tokens, H, KV, Dh, cos rows, eps, blocks, stream
    "qk_norm_rope_fwd": [_P] * 8 + [_I] * 5 + [_F, _I, _P],
    # q, k, dq out, dk out, cos, sin, q scale, k scale, dq, dk, scale
    # partials (or null), tokens, H, KV, Dh, cos rows, eps, blocks, stream
    "qk_norm_rope_bwd": [_P] * 11 + [_I] * 5 + [_F, _I, _P],
    # gate, up, h, n, blocks, stream
    "swiglu_fwd": [_P] * 3 + [_I] * 2 + [_P],
    # gate, up, dh, dgate, dup, n, blocks, stream
    "swiglu_bwd": [_P] * 5 + [_I] * 2 + [_P],
    # op, units, width, SMs -> blocks of the persistent grid (0: the op
    # does not take the width)
    "fused_norm_grid": [_I, _L, _I, _I],
}
QUERIES = ("fused_norm_grid",)
# the csrc/<source>.cu that defines each entry point
SOURCES = {"paged_decode": "paged_decode",
           "paged_decode_int8": "paged_decode",
           "int4_matmul": "int4_matmul", "flash_fwd": "flash_fwd",
           "flash_dq": "flash_bwd", "flash_dkv": "flash_bwd",
           "lm_head_stats": "lm_head_stats", "lm_head_dh": "lm_head_stats",
           "lm_head_dw": "lm_head_stats",
           **{name: "fused_norm" for name in (
               "rms_norm_fwd", "rms_norm_bwd", "qk_norm_rope_fwd",
               "qk_norm_rope_bwd", "swiglu_fwd", "swiglu_bwd",
               "fused_norm_grid")}}

launches: Dict[str, int] = {name: 0 for name in SIGNATURES
                            if name not in QUERIES}
_fns: Dict[str, object] = {}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    for cand in ("/usr/local/cuda/bin/nvcc", shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the GPU (CUDA toolkit required)")


def _lib_path(source: str) -> Path:
    """The library of ``csrc/<source>.cu``, named by a hash of the source,
    the headers in ``csrc/`` (any of them may be included) and the flags,
    so that an edit to any of them builds anew."""
    src = b"".join(p.read_bytes() for p in
                   [CSRC / f"{source}.cu", *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD / f"lib{source}-{digest[:12]}.so"


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile the missing libraries that define the named entry points,
    one nvcc process per source, all started together. Returns
    {source: ptxas report} for what was built."""
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in sorted({SOURCES[n] for n in names}):
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), tmp, out)
    reports = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def function(name: str):
    """The C entry point ``name``, its source built first if needed."""
    fn = _fns.get(name)
    if fn is None:
        build([name])
        fn = getattr(ctypes.CDLL(str(_lib_path(SOURCES[name]))), name)
        fn.argtypes = SIGNATURES[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
