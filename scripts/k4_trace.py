#!/usr/bin/env python3
"""Where a K4 call spends its time, phase by phase, on one NVIDIA GPU.

    python3 scripts/k4_trace.py

Builds a copy of ``csrc/paged_decode.cu`` in which thread 0 of every block
reads the global timer at seven points, runs one call of K4 (bf16 pool)
and of K4-int8 at the shapes of ``scripts/k4_ab.py --sweep`` (the smoke's
check shape, a serve step, one 2,048-token row, sixteen one-token rows)
after a warm-up, and prints a JSON line a shape:

- ``blocks``, ``active_blocks``: the grid, and the blocks that hold pages;
- ``span_us``: first block start to last block end;
- ``start_us``: block start after the first one, median and max (a late
  median means the clusters did not all fit on the card at once);
- one [median, max] over the active blocks for each phase:
  ``row`` (the row's length), ``issue`` (block-table
  entries, first copies, barrier init), ``first_data`` (the first stage
  and the query rows arriving), ``loop`` (the token loop and the warps'
  merge), ``block_merge``, ``end`` (the output: the cluster merge and its
  two barriers, or the single split's store);
- ``life_us``: an active block's life, median and max.

The copy lives in ``speech_distill_tpu_torch/build/`` (ignored by git).
The timer reads add a few instructions a block; the kernel is otherwise
the one the package builds. Imports no JAX.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import k4_ab  # noqa: E402
from speech_distill_tpu_torch.ops import _cuda  # noqa: E402
from speech_distill_tpu_torch.ops.paged_attention import k4_plan  # noqa: E402

SLOTS = 8                     # timer reads a block
MAX_BLOCKS = 8192
TIMER = '''
__device__ unsigned long long k4_trace[%d][%d];
__device__ __forceinline__ void k4_mark(int k) {
  if (threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t));
    k4_trace[blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y *
                                       blockIdx.z)][k] = t;
  }
}
''' % (MAX_BLOCKS, SLOTS)
READ = '''
extern "C" int k4_trace_read(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, k4_trace, sizeof(k4_trace));
}
extern "C" int k4_trace_clear() {
  static unsigned long long z[%d][%d];
  return (int)cudaMemcpyToSymbol(k4_trace, z, sizeof(z));
}
''' % (MAX_BLOCKS, SLOTS)
# (text of the source, timer slot, read after the text rather than before)
MARKS = [("  extern __shared__ __align__(128) unsigned char smem[];\n", 0, True),
         ("  const int len = min(max(a.lengths[b], 0), a.max_pages * ps);\n",
          1, True),
         ("  __syncthreads();   // the barriers' init\n", 2, True),
         ("  float* wst = bacc + kR * Dh;", 4, False),
         ("  if (active == 1) {\n", 5, False),
         ("  cluster.sync();   // no block leaves while another reads its "
          "state\n", 6, True)]
PHASES = [("row", 0, 1), ("issue", 1, 2), ("first_data", 2, 3),
          ("loop", 3, 4), ("block_merge", 4, 5), ("end", 5, 6)]


def traced_source() -> str:
    src = (_cuda.CSRC / "paged_decode.cu").read_text()
    anchor = "namespace {\n\nnamespace cg"
    assert anchor in src
    src = src.replace(anchor, "namespace {\n" + TIMER + "\nnamespace cg", 1)
    for text, k, after in MARKS:
        assert text in src, text
        mark = f"  k4_mark({k});\n"
        src = src.replace(text, text + mark if after else mark + text, 1)
    loop = "    ring.wait(it);\n"
    store = ("      ob[i] = from_f<TQ>(bacc[i] / fmaxf(bl[i / Dh], "
             "1e-30f));\n    return;")
    assert loop in src and store in src
    src = src.replace(loop, loop + "    if (it == 0) k4_mark(3);\n", 1)
    src = src.replace(store, store.replace("    return;",
                                           "    k4_mark(6);\n    return;"), 1)
    return src + READ


def build() -> ctypes.CDLL:
    out = _cuda.BUILD / "k4_trace"
    out.mkdir(parents=True, exist_ok=True)
    cu, lib = out / "paged_decode_trace.cu", out / "libpaged_decode_trace.so"
    cu.write_text(traced_source())
    r = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I",
                        str(_cuda.CSRC), "-o", str(lib), str(cu)],
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"nvcc failed:\n{r.stdout[-4000:]}{r.stderr[-4000:]}")
    L = ctypes.CDLL(str(lib))
    for name in ("paged_decode", "paged_decode_int8"):
        getattr(L, name).argtypes = _cuda.SIGNATURES[name]
    return L


def trace(L, args, kw) -> dict:
    q, kp, vp, bt, lengths = args
    B, KV, G, Dh = q.shape
    _, P, _, ps, _ = kp.shape
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    plan = k4_plan(B, KV, bt.shape[1], ps, Dh, kp.dtype, sms)
    out = torch.empty_like(q)
    ptr = _cuda.ptr
    tail = (B, KV, G, Dh, P, ps, bt.shape[1], kw["layer"], *plan,
            Dh ** -0.5, 1, _cuda.stream_of(q))

    def call():
        if kp.dtype == torch.int8:
            code = L.paged_decode_int8(
                ptr(q), ptr(kp), ptr(vp), ptr(kw["k_scale"]),
                ptr(kw["v_scale"]), ptr(bt), ptr(lengths), ptr(out), *tail)
        else:
            code = L.paged_decode(ptr(q), ptr(kp), ptr(vp), ptr(bt),
                                  ptr(lengths), ptr(out), *tail)
        _cuda.check(code, "traced paged_decode")
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    L.k4_trace_clear()
    call()
    torch.cuda.synchronize()
    raw = np.zeros((MAX_BLOCKS, SLOTS), np.uint64)
    L.k4_trace_read(raw.ctypes.data_as(ctypes.c_void_p))
    n = KV * B * plan.splits           # G <= 8: one row group
    t = raw[:n].astype(np.int64)
    rel = np.where(t > 0, t - t[t[:, 0] > 0, 0].min(), -1) / 1e3
    active = rel[:, 3] >= 0
    res = {"plan": plan._asdict(), "blocks": int(n),
           "active_blocks": int(active.sum()),
           "span_us": float(rel.max()),
           "start_us": [float(np.median(rel[:, 0])), float(rel[:, 0].max())]}
    for name, a, b in PHASES:
        sel = active & (rel[:, a] >= 0) & (rel[:, b] >= 0)
        d = rel[sel, b] - rel[sel, a]
        res[name] = [float(np.median(d)), float(d.max())] if sel.any() \
            else None
    life = rel[active, 6] - rel[active, 0]
    res["life_us"] = [float(np.median(life)), float(life.max())]
    return res


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("k4_trace: CUDA is not available")
    dev = torch.device("cuda", 0)
    L = build()
    serve = [int(n) for n in np.random.default_rng(k4_ab.SEED + 2).integers(
        64, 161, 13)] + [0, 0, 0]
    for quantized in (False, True):
        tag = "int8" if quantized else "bf16"
        shapes = {"check": k4_ab.check_args(dev, quantized)[:2]}
        for name, lens in (("serve", serve), ("one_2048", [2048] + [0] * 15),
                           ("all_1", [1] * 16)):
            shapes[name] = k4_ab.lens_args(dev, quantized, lens)
        for name, (args, kw) in shapes.items():
            print(f"K4TRACE {name}_{tag} " + json.dumps(trace(L, args, kw)),
                  flush=True)


if __name__ == "__main__":
    main()
