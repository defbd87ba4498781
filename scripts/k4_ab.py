#!/usr/bin/env python3
"""K4 and K4-int8 (paged decode attention) on one NVIDIA GPU: checkouts
side by side, or the split plan's constants swept.

    python3 scripts/k4_ab.py DIR [DIR ...] [--out FILE]
    python3 scripts/k4_ab.py --sweep

Each DIR is the root of a checkout of this repository (its
``speech_distill_tpu_torch`` is imported from there, its kernels built
there); each runs in a process of its own, in the order given, so pass
``parent change change parent`` to see the drift between turns. A process:

1. K4 and K4-int8 at the smoke's check shape (16 rows, KV 8, G 2, Dh 128,
   page 128, lengths 0..2,048 adding up to 12,609, layer 1 of 2; the
   inputs of ``chip_smoke.k4_check``): device ms from CUDA-graph
   replays, ms of eager calls between CUDA events, the error against the
   plain version;
2. a decode-heavy serve of the full-width 0.6B (random weights, seed 0,
   ``PagedEngine(slots=16, max_len=2048, page_size=128)``, 13 prompts of
   64-128 tokens, 32 new tokens each) traced by ``torch.profiler``: the
   paged-decode kernel's device ms and launches a decode step by kernel
   name, with a bf16 pool and then with an int8 pool.

Prints one JSON line a DIR (and appends it to ``--out``).

``--sweep`` (the checkout in the working directory) graph-times both
kernels under each plan of ``SWEEP_PLANS`` (the module's MAX_SPLITS,
STAGE_BYTES and MAX_STAGES set in turn) at the check shape, a serve
step's shape (13 rows of 64..160 tokens, 3 idle), one 2,048-token row,
sixteen of them and sixteen one-token rows: one ``K4SWEEP`` line a plan.
Imports no JAX.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

SEED = 0


def graph_ms(fn, side, iters: int = 20, replays: int = 10) -> float:
    import torch
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def event_ms(fn, iters: int = 20) -> float:
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_args(dev, quantized: bool):
    """The smoke's K4 check inputs: (args, kwargs, plain's pools)."""
    import numpy as np
    import torch
    from speech_distill_tpu_torch.ops.paged_attention import quantize_kv
    rng = np.random.default_rng(SEED + (12 if quantized else 1))
    B, KV, G, Dh, ps, mp, L = 16, 8, 2, 128, 128, 16, 2
    P = B * mp

    def rnd(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)
                                ).to(dev, torch.bfloat16)
    q = rnd(B, KV, G, Dh)
    if quantized:
        kp, ks = quantize_kv(rnd(L, P + 1, KV, ps, Dh))
        vp, vs = quantize_kv(rnd(L, P + 1, KV, ps, Dh))
        kw = dict(layer=1, k_scale=ks, v_scale=vs)
        ref_args = (q.float(), kp, vp)
    else:
        kp, vp = rnd(L, P + 1, KV, ps, Dh), rnd(L, P + 1, KV, ps, Dh)
        kw = dict(layer=1)
        ref_args = (q.float(), kp.float(), vp.float())
    bt = torch.from_numpy(rng.permutation(P).reshape(B, mp).astype(
        np.int32)).to(dev)
    lengths = torch.tensor([0, 1, 127, 128, 129, 255, 256, 511, 640, 1000,
                            1023, 1024, 1500, 1920, 2047, 2048],
                           dtype=torch.int32, device=dev)
    return (q, kp, vp, bt, lengths), kw, ref_args


def check_shape(dev, side, quantized: bool) -> dict:
    import torch
    from speech_distill_tpu_torch.ops.paged_attention import (
        paged_attention, paged_attention_plain)
    args, kw, ref_args = check_args(dev, quantized)
    bt, lengths = args[3], args[4]
    got = paged_attention(*args, **kw)
    ref = paged_attention_plain(*ref_args, bt, lengths, **kw)
    torch.cuda.synchronize()
    return {"max_abs_err": (got.float() - ref).abs().max().item(),
            "graph_ms": graph_ms(lambda: paged_attention(*args, **kw), side),
            "host_ms": event_ms(lambda: paged_attention(*args, **kw))}


def serve_profile(model, cfg, dev, cache_dtype) -> dict:
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from speech_distill_tpu_torch.core.config import SamplingParams
    from speech_distill_tpu_torch.infer.paged import PagedEngine
    sp = SamplingParams(stop_token_ids=(cfg.eos_token_id,))
    eng = PagedEngine(model, cfg, sp, slots=16, max_len=2048, page_size=128,
                      seed=SEED, device=dev, cache_dtype=cache_dtype)
    rng = np.random.default_rng(SEED)
    lens = [int(n) for n in rng.integers(64, 129, 13)]

    def run():
        eng.serve([rng.integers(1, cfg.vocab_size - 2, n).tolist()
                   for n in lens], max_new=32)
        torch.cuda.synchronize()
    run()                                         # warm-up
    t0 = time.perf_counter()
    run()
    wall = time.perf_counter() - t0
    steps = eng.n_decode_steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    sel = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA
           and "paged_decode_kernel" in e.key]
    us = sum(e.self_device_time_total for e in sel)
    n = sum(e.count for e in sel)
    return {"decode_steps": steps, "wall_s_unprofiled": wall,
            "k4_ms_per_step": us / 1e3 / max(steps, 1),
            "k4_launches_per_step": n / max(steps, 1)}


def lens_args(dev, quantized: bool, lens):
    """K4's inputs for 16 rows of the given lengths at the serve's widths
    (KV 8, G 2, Dh 128, page 128, max_pages 16, layer 1 of 2)."""
    import numpy as np
    import torch
    from speech_distill_tpu_torch.ops.paged_attention import quantize_kv
    rng = np.random.default_rng(SEED + 2)
    B, KV, G, Dh, ps, mp, L = 16, 8, 2, 128, 128, 16, 2
    P = B * mp
    q = torch.randn(B, KV, G, Dh, device=dev).to(torch.bfloat16)
    pool = [torch.randn(L, P, KV, ps, Dh, device=dev).to(torch.bfloat16)
            for _ in range(2)]
    kw = dict(layer=1)
    if quantized:
        (kp, ks), (vp, vs) = (quantize_kv(t) for t in pool)
        pool = [kp, vp]
        kw.update(k_scale=ks, v_scale=vs)
    bt = torch.from_numpy(rng.permutation(P).reshape(B, mp).astype(
        np.int32)).to(dev)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    return (q, *pool, bt, lengths), kw


# (max splits, stage bytes, max stages) of the sweep; the first is the
# module's own
SWEEP_PLANS = [(8, 32768, 2), (8, 32768, 1), (8, 16384, 2), (8, 16384, 3),
               (4, 32768, 2)]


def sweep() -> None:
    """Graph-timed K4 / K4-int8 at the check shape, a serve step's shape
    (13 rows of 64..160 tokens, 3 idle), one 2,048-token row, 16 of them
    and 16 one-token rows, under other plans: the module's plan constants
    set in turn (the checkout in the working directory)."""
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch
    from speech_distill_tpu_torch.ops import paged_attention as pa
    dev = torch.device("cuda", 0)
    side = torch.cuda.Stream()
    serve_lens = [int(n) for n in np.random.default_rng(SEED + 2).integers(
        64, 161, 13)] + [0, 0, 0]
    shapes = {}
    for quantized in (False, True):
        tag = "int8" if quantized else "bf16"
        shapes[f"check_{tag}"] = check_args(dev, quantized)[:2]
        for name, lens in (("serve", serve_lens),
                           ("one_2048", [2048] + [0] * 15),
                           ("all_2048", [2048] * 16), ("all_1", [1] * 16)):
            shapes[f"{name}_{tag}"] = lens_args(dev, quantized, lens)
    base = (pa.MAX_SPLITS, pa.STAGE_BYTES, pa.MAX_STAGES)
    for plan in SWEEP_PLANS:
        pa.MAX_SPLITS, pa.STAGE_BYTES, pa.MAX_STAGES = plan
        row = {"max_splits": plan[0], "stage_bytes": plan[1],
               "max_stages": plan[2]}
        for name, (args, kw) in shapes.items():
            row[name] = graph_ms(lambda: pa.paged_attention(*args, **kw),
                                 side)
        print("K4SWEEP " + json.dumps(row), flush=True)
    pa.MAX_SPLITS, pa.STAGE_BYTES, pa.MAX_STAGES = base


def worker(root: str) -> dict:
    sys.path.insert(0, root)
    import torch
    from speech_distill_tpu_torch.core.config import qwen3_student_0p6b
    from speech_distill_tpu_torch.models import qwen3
    from speech_distill_tpu_torch.models.convert import (model_to_tree,
                                                         params_from_jax)
    from speech_distill_tpu_torch.ops import _cuda
    from speech_distill_tpu_torch.ops.quant import quantize_params
    if not torch.cuda.is_available():
        raise SystemExit("k4_ab: CUDA is not available")
    dev = torch.device("cuda", 0)
    _cuda.build(["paged_decode"])
    side = torch.cuda.Stream()
    res = {"root": root, "device": torch.cuda.get_device_name(0),
           "k4": check_shape(dev, side, False),
           "k4_int8": check_shape(dev, side, True)}
    cfg = qwen3_student_0p6b()
    model = qwen3.init_params(cfg, seed=SEED, device=dev)
    res["serve"] = serve_profile(model, cfg, dev, torch.bfloat16)
    qmodel = params_from_jax(quantize_params(
        model_to_tree(model), bits=4, method="int4", quantize_embed=True),
        cfg, dev)
    del model
    res["serve_quant"] = serve_profile(qmodel, cfg, dev, torch.int8)
    return res


def main() -> None:
    argv = sys.argv[1:]
    if argv[:1] == ["--worker"]:
        print("K4AB " + json.dumps(worker(argv[1])), flush=True)
        return
    if argv[:1] == ["--sweep"]:
        sweep()
        return
    out = None
    if "--out" in argv:
        i = argv.index("--out")
        out = argv[i + 1]
        del argv[i:i + 2]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    failed = False
    for root in argv:
        root = os.path.abspath(root)
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--worker", root], capture_output=True,
                              text=True, cwd=root)
        lines = [ln[5:] for ln in proc.stdout.splitlines()
                 if ln.startswith("K4AB ")]
        if proc.returncode != 0 or not lines:
            failed = True
            print(f"{root}: exit {proc.returncode}\n{proc.stderr[-4000:]}",
                  flush=True)
            continue
        print(lines[-1], flush=True)
        if out:
            with open(out, "a") as f:
                f.write(json.dumps({"card": card,
                                    **json.loads(lines[-1])}) + "\n")
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
