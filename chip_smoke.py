#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

1. Records the card (nvidia-smi name and power limit).
2. Builds the hand-written CUDA kernels from speech_distill_tpu_torch/csrc
   (one nvcc per source, all started together).
3. Serves 16 seeded requests through ``PagedEngine`` on the full-width
   Qwen3-0.6B student (random weights from a seed; the default sampler),
   and fails unless both serving kernels were launched during the serve.
4. Holds each serving kernel against its plain PyTorch version on the
   card at the serving path's shapes, and times kernel, plain version,
   bound and (for flash attention) the library SDPA call as a yardstick.
5. Teacher-forces decode steps of ``paged_forward`` through the kernel and
   through the plain version, and compares the logits.
6. Trains: PiSSA LoRA on the same full-width model, ``make_kd_step(mode=
   "precomputed")`` in ``train_loop`` over seeded synthetic batches (B 8,
   T 512, K 128), with checkpoints; fails unless the flash forward and
   backward kernels ran exactly as often as the step's layers say, the
   losses are finite, the base stayed frozen and the adapters moved. Then
   a short loop on one repeated batch, whose loss must fall.
7. Holds the backward kernels (K1-dq, K1-dkv) against the plain backward
   at the step's shape and times them beside SDPA's backward.
8. Loss and gradients of the KD step at reduced depth through the kernel
   route and the plain route in bf16, against the plain route in fp32.
9. Prints the kernels JSON line, then the result line.

Exits non-zero, printing no result, when CUDA is missing or any phase
fails. Only one card is needed. Imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from speech_distill_tpu_torch.core.config import (DistillConfig, LoraConfig,
                                                  SamplingParams,
                                                  qwen3_student_0p6b)
from speech_distill_tpu_torch.core.trainer import (LoopConfig, batches_from,
                                                   train_loop)
from speech_distill_tpu_torch.core.tree import tree_leaves, tree_map
from speech_distill_tpu_torch.data.collator import DistillCollator
from speech_distill_tpu_torch.distill import train_step
from speech_distill_tpu_torch.distill.lora import init_lora, lora_scaling
from speech_distill_tpu_torch.infer.paged import (PagedEngine, PagedKVCache,
                                                  paged_forward)
from speech_distill_tpu_torch.models import qwen3
from speech_distill_tpu_torch.ops import _cuda
from speech_distill_tpu_torch.ops.flash_attention import (
    flash_attention_bwd_plain, flash_attention_fwd, flash_attention_fwd_plain,
    flash_dkv, flash_dq)
from speech_distill_tpu_torch.ops.fused_lm_loss import head_sparse_kd_loss
from speech_distill_tpu_torch.ops.paged_attention import (
    paged_attention, paged_attention_plain)

SEED = 0
# H100 SXM published peaks (dense): HBM bandwidth and bf16 tensor cores
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
# bf16 results: one rounding of an attention output (|o| <= max|v| ~ 5,
# 2^-9 relative) plus the kernel's bf16 P; fp32 sums agree to ~1e-6
KERNEL_ATOL = 2e-2
LSE_ATOL = 1e-3
# decode logits through 28 layers, kernel vs plain attention, in fp32:
# only summation order differs (~1e-6 relative per reduction of <= 3072
# terms), on logits of O(1)
FP32_LOGITS_ATOL = 1e-3
# in bf16 the two routes round attention outputs at different points, and
# that noise passes through 28 residual layers: the kernel route must be
# no less accurate than the plain route against the fp32 route (2x slack
# for which of two like-sized noises happens to be larger)
BF16_ERR_RATIO = 2.0
# flash backward, max |kernel - plain(fp32)| / max |plain| on the same bf16
# inputs: the kernels round p and ds to bf16 (2^-9 relative) before
# products over up to T * G terms and write bf16 results (2^-9), and their
# forward's o and lse carry bf16 rounding too
BWD_REL_TOL = 2e-2
# the KD step of the smoke (bench.py's defaults): B 8, T 512, top-K 128
TRAIN_B, TRAIN_T, TRAIN_K, TRAIN_STEPS = 8, 512, 128, 10
SPEECH_BOS = 151_670          # a speech-start id; the pad id is the EOS
# learning rate of the loop on one repeated batch (first step's rate is 0)
REPEAT_LR, REPEAT_STEPS = 2e-4, 6


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events)."""
    for _ in range(warmup):
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


def bound(nbytes: float, flops: float):
    """(bound_ms, bound_by): the larger of bytes over HBM bandwidth and
    operations over the bf16 tensor-core peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def record_card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    log(out.splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    return out


def build_kernels() -> None:
    t0 = time.perf_counter()
    reports = _cuda.build(list(_cuda.SIGNATURES))
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")
    log(f"build s={time.perf_counter() - t0:.2f} "
        f"built={sorted(reports)}")


def serve(cfg, model):
    """Phase 3: the main path. Returns the launch counts of the serve."""
    sp = SamplingParams(stop_token_ids=(cfg.eos_token_id,))
    eng = PagedEngine(model, cfg, sp, slots=16, max_len=2048, page_size=128,
                      seed=SEED, device=model.device)
    rng = np.random.default_rng(SEED)
    # 13 short prompts and three fresh long ones whose page-aligned widths
    # (512, 768, 1024) take the flash kernel at prefill
    lens = [int(n) for n in rng.integers(64, 129, 13)] + [500, 700, 1000]
    prompts = [rng.integers(1, cfg.vocab_size - 2, n).tolist() for n in lens]
    caps = [int(c) for c in rng.integers(32, 129, len(prompts))]
    eng.serve([prompts[0][:70]], max_new=4)          # warm-up (cuBLAS etc.)
    torch.cuda.synchronize()

    _cuda.reset_launches()
    t0 = time.perf_counter()
    outs = eng.serve(prompts, max_new_per_request=caps)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(_cuda.launches)

    n_gen = sum(len(o) for o in outs)
    log("serve " + json.dumps({
        "requests": len(prompts), "prompt_tokens": sum(lens),
        "generated_tokens": n_gen, "seconds": dt, "tokens_per_s": n_gen / dt,
        "phase_seconds": eng.phase_seconds, "decode_steps":
        eng.n_decode_steps, "chunks": eng.n_chunks, "exit_syncs":
        eng.n_exit_syncs, "preemptions": eng.preemptions,
        "batched_prefills": eng.n_batched_prefills, "launches": counts}))
    for rid, (o, c) in enumerate(zip(outs, caps)):
        if not 0 < len(o) <= c:
            fail(f"request {rid}: {len(o)} tokens for cap {c}")
        if not all(0 <= t < cfg.vocab_size for t in o):
            fail(f"request {rid}: token outside the vocabulary")
        if len(o) < c and o[-1] != cfg.eos_token_id:
            fail(f"request {rid} stopped early without EOS")
    if min(counts["paged_decode"], counts["flash_fwd"]) <= 0:
        fail(f"a serving kernel was not launched during the serve: "
             f"{counts}")
    L = cfg.num_hidden_layers
    if counts["paged_decode"] != L * eng.n_decode_steps:
        fail(f"paged_decode launches {counts['paged_decode']} != layers x "
             f"decode steps {L * eng.n_decode_steps}")
    profile_decode(eng, lens[:13], cfg, rng)
    return counts


def profile_decode(eng, lens, cfg, rng) -> None:
    """Where a decode-heavy serve spends its time: the same serve (fresh
    random prompts of the given lengths, 32 tokens each) timed without the
    profiler, then traced with it for the time of each CUDA kernel. Device
    busy share = kernel time / unprofiled wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def run():
        eng.serve([rng.integers(1, cfg.vocab_size - 2, n).tolist()
                   for n in lens], max_new=32)
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    wall_us = (time.perf_counter() - t0) * 1e6
    steps = eng.n_decode_steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda e: -e.self_device_time_total)
    busy_us = sum(e.self_device_time_total for e in rows)
    log(f"profile decode serve: {len(lens)} requests x 32 tokens, "
        f"{steps} steps, wall_ms={wall_us / 1e3:.2f} (unprofiled) "
        f"device_kernel_ms={busy_us / 1e3:.2f} (profiled) busy_share="
        f"{busy_us / wall_us:.3f}")
    for e in rows[:8]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x "
            f"{e.key[:90]}")


def check_paged_decode(dev, launches: int) -> dict:
    """K4 at the serve's shapes: 16 rows, KV 8, G 2, Dh 128, page 128,
    lengths 0..2048 (idle row, page boundaries), layer 1 of 2."""
    rng = np.random.default_rng(SEED + 1)
    B, KV, G, Dh, ps, mp, L = 16, 8, 2, 128, 128, 16, 2
    P = B * mp

    def rnd(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)
                                ).to(dev, torch.bfloat16)
    q, kp, vp = rnd(B, KV, G, Dh), rnd(L, P + 1, KV, ps, Dh), \
        rnd(L, P + 1, KV, ps, Dh)
    bt = torch.from_numpy(rng.permutation(P).reshape(B, mp).astype(
        np.int32)).to(dev)
    lens = [0, 1, 127, 128, 129, 255, 256, 511, 640, 1000, 1023, 1024,
            1500, 1920, 2047, 2048]
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    args = (q, kp, vp, bt, lengths)
    got = paged_attention(*args, layer=1)
    torch.cuda.synchronize()
    ref = paged_attention_plain(q.float(), kp.float(), vp.float(), bt,
                                lengths, layer=1)
    err = (got.float() - ref).abs().max().item()
    if not bool(torch.all(got[0] == 0)):
        fail("paged_decode: idle row is not exact zeros")
    log(f"paged_decode max_abs_err={err:.3e} tol={KERNEL_ATOL} (bf16 "
        f"output rounding vs the plain version in fp32 on the same bf16 "
        f"inputs)")
    if not err <= KERNEL_ATOL:
        fail(f"paged_decode disagrees with its plain version: {err}")
    ms = time_ms(lambda: paged_attention(*args, layer=1))
    plain_ms = time_ms(lambda: paged_attention_plain(*args, layer=1))
    resident = sum(lens)
    pages_read = sum(-(-n // ps) for n in lens)
    nbytes = (resident * KV * Dh * 2 * 2          # K and V rows, bf16
              + 2 * q.numel() * 2                 # q in, out
              + pages_read * 4 + B * 4)           # block tables, lengths
    flops = 4 * G * Dh * KV * resident
    bound_ms, bound_by = bound(nbytes, flops)
    return {"name": "paged_decode", "route": "cuda",
            "source": "speech_distill_tpu_torch/csrc/paged_decode.cu",
            "replaces": "speech_distill_tpu/ops/paged_attention.py:55",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "kernel_ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def check_flash_fwd(dev, launches: int) -> dict:
    """K1-fwd at the long-prompt prefill's shape: B 1, T 1024, H 16,
    KV 8, Dh 128."""
    rng = np.random.default_rng(SEED + 2)
    B, T, H, KV, Dh = 1, 1024, 16, 8, 128

    def rnd(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)
                                ).to(dev, torch.bfloat16)
    q, k, v = rnd(B, T, H, Dh), rnd(B, T, KV, Dh), rnd(B, T, KV, Dh)
    o, lse = flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    ref_o, ref_lse = flash_attention_fwd_plain(q.float(), k.float(),
                                               v.float())
    err = (o.float() - ref_o).abs().max().item()
    err_lse = (lse - ref_lse).abs().max().item()
    log(f"flash_fwd max_abs_err o={err:.3e} tol={KERNEL_ATOL} (bf16 output "
        f"and bf16 P), lse={err_lse:.3e} tol={LSE_ATOL} (fp32)")
    if not (err <= KERNEL_ATOL and err_lse <= LSE_ATOL):
        fail(f"flash_fwd disagrees with its plain version: {err}, "
             f"{err_lse}")
    ms = time_ms(lambda: flash_attention_fwd(q, k, v))
    plain_ms = time_ms(lambda: flash_attention_fwd_plain(q, k, v))
    # yardstick only, never called by the port: PyTorch's fused SDPA over
    # the KV heads repeated to H (the repeat is done once, outside the
    # timing)
    G = H // KV
    qt = q.transpose(1, 2)
    kt = k.repeat_interleave(G, dim=2).transpose(1, 2)
    vt = v.repeat_interleave(G, dim=2).transpose(1, 2)
    library_ms = time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True))
    nbytes = (q.numel() * 2 * 2 + k.numel() * 2 * 2   # q, o, k, v bf16
              + B * H * T * 4)                         # lse fp32
    flops = 2 * B * H * T * T * Dh                     # causal QK^T + PV
    bound_ms, bound_by = bound(nbytes, flops)
    return {"name": "flash_fwd", "route": "cuda",
            "source": "speech_distill_tpu_torch/csrc/flash_fwd.cu",
            "replaces": "speech_distill_tpu/ops/flash_attention.py:28",
            "launches": launches, "max_abs_err": max(err, err_lse),
            "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def check_model_path(cfg, model, dev) -> None:
    """Phase 5: decode steps of paged_forward through the kernel and
    through the plain version, in bf16 (the serving dtype) and in fp32
    (same weights upcast, the kernel's fp32 instantiation), from the same
    random KV history, with one dead row."""
    rng = np.random.default_rng(SEED + 3)
    B, ps, mp, steps = 4, 128, 4, 4
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model32 = qwen3.Qwen3(cfg32, dev)
    for p32, p in zip(model32.parameters(), model.parameters()):
        p32.data.copy_(p.float())
    runs = {}                        # (dtype, impl) -> (model, pool)
    hist = None
    for name, m, c, dt in (("bf16", model, cfg, torch.bfloat16),
                           ("fp32", model32, cfg32, torch.float32)):
        for impl in ("kernel", "plain"):
            pool = PagedKVCache.create(c, B * mp, ps, dt, dev)
            if hist is None:
                hist = torch.from_numpy(rng.standard_normal(
                    tuple(pool.k.shape), np.float32)).to(dev, torch.bfloat16)
            pool.k.copy_(hist)
            pool.v.copy_(hist.flip(-1))
            runs[name, impl] = (m, pool)
    bt = torch.from_numpy(rng.permutation(B * mp).reshape(B, mp).astype(
        np.int32)).to(dev)
    lengths = torch.tensor([0, 100, 128, 300], dtype=torch.int64,
                           device=dev)
    live = torch.tensor([True, True, True, False], device=dev)
    err = dict.fromkeys(("fp32", "bf16_kernel", "bf16_plain"), 0.0)
    for _ in range(steps):
        tok = torch.from_numpy(rng.integers(1, cfg.vocab_size - 2, B)).to(dev)
        out = {key: paged_forward(m, tok, pool, bt, lengths, live, key[1])
               for key, (m, pool) in runs.items()}
        if not all(bool(torch.isfinite(o).all()) for o in out.values()):
            fail("paged_forward produced non-finite logits")
        ref = out["fp32", "plain"][live]

        def dist(key):
            return (out[key][live] - ref).abs().max().item()
        err["fp32"] = max(err["fp32"], dist(("fp32", "kernel")))
        err["bf16_kernel"] = max(err["bf16_kernel"], dist(("bf16", "kernel")))
        err["bf16_plain"] = max(err["bf16_plain"], dist(("bf16", "plain")))
        lengths = lengths + live
    log(f"model path: {steps} decode steps, max |logits - fp32 plain|: "
        f"fp32 kernel {err['fp32']:.3e} (tol {FP32_LOGITS_ATOL}), bf16 "
        f"kernel {err['bf16_kernel']:.3e}, bf16 plain {err['bf16_plain']:.3e}"
        f" (bf16 kernel must stay within {BF16_ERR_RATIO}x the bf16 plain "
        f"route's error)")
    if not err["fp32"] <= FP32_LOGITS_ATOL:
        fail(f"fp32 decode logits through the kernel disagree: {err}")
    if not err["bf16_kernel"] <= BF16_ERR_RATIO * err["bf16_plain"]:
        fail(f"bf16 decode through the kernel is less accurate: {err}")


def kd_features(cfg, n: int, rng) -> list:
    """Seeded synthetic precomputed-KD examples: 385-512 tokens (so a batch
    pads right to T = 512), a speech start in the first 32, and top-K
    columns of distinct indices with fp16 logprobs ~ N(-3, 1)."""
    V, K, pad = cfg.vocab_size, TRAIN_K, cfg.eos_token_id
    cols = rng.permutation(V)[:K]
    feats = []
    for _ in range(n):
        L = int(rng.integers(385, TRAIN_T + 1))
        ids = rng.integers(0, V, L)
        ids[np.isin(ids, (pad, SPEECH_BOS))] = 1
        ids[int(rng.integers(1, 32))] = SPEECH_BOS
        feats.append({
            "input_ids": ids.tolist(),
            "teacher_top_k_v": (rng.standard_normal((L, K)) - 3).astype(
                np.float16),
            "teacher_top_k_i": ((rng.integers(0, V, (L, 1)) + cols) % V
                                ).astype(np.int32)})
    return feats


def train(cfg, model, dev):
    """Phase 6: the KD training step through ``train_loop``. Returns the
    launch counts of the loop and the trained LoRA tree."""
    t0 = time.perf_counter()
    lora, base = init_lora(model, cfg, LoraConfig(), device=dev)
    torch.cuda.synchronize()
    log(f"init_lora pissa r=32 alpha=64 rslora s="
        f"{time.perf_counter() - t0:.2f}")
    frozen = [p.detach().clone() for p in base.parameters()]
    before = [t.detach().clone() for t in tree_leaves(lora)]
    rng = np.random.default_rng(SEED + 4)
    feats = kd_features(cfg, TRAIN_B * TRAIN_STEPS, rng)
    collate = DistillCollator(pad_token_id=cfg.eos_token_id,
                              speech_bos_id=SPEECH_BOS,
                              pad_to_multiple_of=128)
    dcfg = DistillConfig()
    opt = train_step.make_optimizer(dcfg.learning_rate, 2, TRAIN_STEPS)
    step = train_step.make_kd_step(cfg, dcfg, opt, mode="precomputed",
                                   device=dev)
    times, metrics, shapes = [], [], []

    def timed_step(state, *args):
        shapes.append(tuple(args[-1]["input_ids"].shape))
        t = time.perf_counter()
        state, m = step(state, *args)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        metrics.append({k: float(v) for k, v in m.items()})
        return state, m

    def batch_iter(epoch):
        return batches_from(feats, collate, TRAIN_B, 1, shuffle_seed=SEED,
                            epoch=epoch)
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as out:
        loop = LoopConfig(num_epochs=1, max_steps=TRAIN_STEPS,
                          logging_steps=TRAIN_STEPS, save_steps=5,
                          save_total_limit=2, output_dir=out)
        _cuda.reset_launches()
        state = train_loop(timed_step, train_step.init_state(lora, opt),
                           (base, None), batch_iter, loop, device=dev)
        torch.cuda.synchronize()
        counts = dict(_cuda.launches)
        kept = sorted(os.listdir(os.path.join(out, "ckpt")))
    peak = torch.cuda.max_memory_allocated() / 2**30
    n = len(times)
    L = cfg.num_hidden_layers
    tokens = TRAIN_B * TRAIN_T
    step_s = float(np.median(times[2:]))
    tok_s = tokens / step_s
    mfu = tok_s * 3 * qwen3.flops_per_token(cfg, TRAIN_T) / BF16_FLOP_PER_S
    real = sum(len(f["input_ids"]) for f in feats[:n * TRAIN_B])
    log("train " + json.dumps({
        "steps": n, "batch_shape": shapes[0], "tokens_per_step": tokens,
        "real_tokens_per_step": real / n, "step_ms_median": step_s * 1e3,
        "step_ms": [t * 1e3 for t in times], "tokens_per_s": tok_s,
        "mfu": mfu, "mfu_peak": "H100 SXM bf16 dense 989 TFLOP/s",
        "loss": [m["loss"] for m in metrics],
        "grad_norm": [m["grad_norm"] for m in metrics],
        "peak_mem_gib": peak, "checkpoints_kept": kept,
        "launches": counts}))
    if n != TRAIN_STEPS or state.step != TRAIN_STEPS:
        fail(f"train_loop ran {n} steps, state at {state.step}")
    if any(s != (1, TRAIN_B, TRAIN_T) for s in shapes):
        fail(f"batches are not [1, {TRAIN_B}, {TRAIN_T}]: {set(shapes)}")
    if not all(np.isfinite([m["loss"], m["grad_norm"]]).all()
               for m in metrics):
        fail("a loss or grad_norm is not finite")
    want = {"flash_fwd": 2 * L * n, "flash_dq": L * n, "flash_dkv": L * n}
    got = {k: counts[k] for k in want}
    if got != want:
        fail(f"flash launches {got} != {want} (2 x layers forward under "
             f"remat, layers backward, per step)")
    if len(kept) != 2:
        fail(f"save_total_limit 2 kept {kept}")
    if not all(torch.equal(a, b) for a, b in zip(frozen,
                                                 base.parameters())):
        fail("the frozen base weights changed")
    moved = [not torch.equal(a, b) for a, b in
             zip(before, tree_leaves(state.trainable))]
    if not all(moved):
        fail(f"{moved.count(False)} trainable leaves did not change")
    batch = {k: v[None] for k, v in collate(feats[:TRAIN_B]).items()}
    check_loss_falls(cfg, dcfg, base, state.trainable, batch, dev)
    profile_train(step, state, base, batch)
    return counts, state.trainable


def profile_train(step, state, base, batch) -> None:
    """Where a training step spends its time: one step timed without the
    profiler, one traced with it for the time of each CUDA kernel. Device
    busy share = kernel time / unprofiled wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def run():
        nonlocal state
        state, _ = step(state, base, None, batch)
        torch.cuda.synchronize()
    run()
    t0 = time.perf_counter()
    run()
    wall_us = (time.perf_counter() - t0) * 1e6
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda e: -e.self_device_time_total)
    busy_us = sum(e.self_device_time_total for e in rows)
    flash_us = sum(e.self_device_time_total for e in rows
                   if "flash_" in e.key)
    log(f"profile train step: wall_ms={wall_us / 1e3:.2f} (unprofiled) "
        f"device_kernel_ms={busy_us / 1e3:.2f} (profiled) busy_share="
        f"{busy_us / wall_us:.3f} flash_kernels_ms={flash_us / 1e3:.2f} "
        f"flash_share_of_kernel_time={flash_us / max(busy_us, 1.0):.3f}")
    for e in rows[:14]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x "
            f"{e.key[:90]}")


def check_loss_falls(cfg, dcfg, base, trainable, batch, dev):
    """A short loop on one repeated batch: its loss must fall."""
    opt = train_step.make_optimizer(REPEAT_LR, 1, 50)
    step = train_step.make_kd_step(cfg, dcfg, opt, mode="precomputed",
                                   donate=False, device=dev)
    state = train_step.init_state(trainable, opt)
    losses = []
    for _ in range(REPEAT_STEPS):
        state, m = step(state, base, None, batch)
        losses.append(float(m["loss"]))
    log(f"repeated batch: lr={REPEAT_LR} (warmup 1: the first step's rate "
        f"is 0) losses={losses}")
    if not losses[-1] < losses[0]:
        fail(f"the loss on one repeated batch did not fall: {losses}")


def check_flash_bwd(dev, counts: dict) -> list:
    """K1-dq and K1-dkv at the training step's shape (B 8, T 512, H 16,
    KV 8, Dh 128) against the plain backward in fp32 on the same bf16
    inputs; K1-fwd timed at the same shape."""
    rng = np.random.default_rng(SEED + 5)
    B, T, H, KV, Dh = TRAIN_B, TRAIN_T, 16, 8, 128
    G = H // KV

    def rnd(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)
                                ).to(dev, torch.bfloat16)
    q, k, v, do = rnd(B, T, H, Dh), rnd(B, T, KV, Dh), rnd(B, T, KV, Dh), \
        rnd(B, T, H, Dh)
    o, lse = flash_attention_fwd(q, k, v)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    dq = flash_dq(q, k, v, do, lse, delta)
    dk, dv = flash_dkv(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    ref_o, ref_lse = flash_attention_fwd_plain(qf, kf, vf)
    ref = flash_attention_bwd_plain(qf, kf, vf, ref_o, ref_lse, dof)
    abs_err = {name: (g.float() - r).abs().max().item()
               for name, g, r in zip(("dq", "dk", "dv"), (dq, dk, dv), ref)}
    err = {name: abs_err[name] / r.abs().max().item()
           for name, r in zip(("dq", "dk", "dv"), ref)}
    log(f"flash_bwd max |kernel - plain| / max |plain|: " + ", ".join(
        f"{n}={e:.3e}" for n, e in err.items()) + f" tol={BWD_REL_TOL} "
        f"(bf16 p and ds in the products, bf16 outputs, against fp32); "
        f"max |kernel - plain|: " + ", ".join(
            f"{n}={e:.3e}" for n, e in abs_err.items()))
    if not max(err.values()) <= BWD_REL_TOL:
        fail(f"flash backward disagrees with its plain version: {err}")
    dq_ms = time_ms(lambda: flash_dq(q, k, v, do, lse, delta))
    dkv_ms = time_ms(lambda: flash_dkv(q, k, v, do, lse, delta))
    plain_ms = time_ms(lambda: flash_attention_bwd_plain(q, k, v, o, lse,
                                                         do), iters=5)
    # yardstick only, never called by the port: the backward of PyTorch's
    # fused SDPA over KV heads repeated to H, one number for the pair
    qt = q.transpose(1, 2).detach().requires_grad_()
    kt = k.repeat_interleave(G, dim=2).transpose(1, 2).detach() \
        .requires_grad_()
    vt = v.repeat_interleave(G, dim=2).transpose(1, 2).detach() \
        .requires_grad_()
    out = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2)
    library_ms = time_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True))
    fwd_ms = time_ms(lambda: flash_attention_fwd(q, k, v))
    fwd_plain_ms = time_ms(lambda: flash_attention_fwd_plain(q, k, v),
                           iters=5)
    fwd_library_ms = time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True))
    causal_mm = B * H * T * T * Dh          # flops of one causal product
    qb, kvb, rowb = q.numel() * 2, k.numel() * 2, B * H * T * 4
    fwd_bound = bound(2 * qb + 2 * kvb + rowb, 2 * causal_mm)
    log(f"flash_fwd at the train shape B {B} T {T}: ms={fwd_ms:.4f} "
        f"plain_ms={fwd_plain_ms:.4f} library_ms={fwd_library_ms:.4f} "
        f"bound_ms={fwd_bound[0]:.5f} ({fwd_bound[1]})")
    rows = []
    for name, ms, line, nbytes, flops in (
            ("flash_dq", dq_ms, 73, 3 * qb + 2 * kvb + 2 * rowb,
             3 * causal_mm),
            ("flash_dkv", dkv_ms, 104, 2 * qb + 4 * kvb + 2 * rowb,
             4 * causal_mm)):
        bound_ms, bound_by = bound(nbytes, flops)
        outs = ("dq",) if name == "flash_dq" else ("dk", "dv")
        rows.append({
            "name": name, "route": "cuda",
            "source": "speech_distill_tpu_torch/csrc/flash_bwd.cu",
            "replaces": f"speech_distill_tpu/ops/flash_attention.py:{line}",
            "launches": counts[name],
            "max_abs_err": max(abs_err[o] for o in outs),
            "max_rel_err": max(err[o] for o in outs), "ms": ms,
            "kernel_ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms})
    train_fwd = {"ms": fwd_ms, "plain_ms": fwd_plain_ms,
                 "library_ms": fwd_library_ms, "bound_ms": fwd_bound[0],
                 "shape": [B, T, H, KV, Dh]}
    return rows, train_fwd


def check_grad_path(cfg, model, lora, dev) -> None:
    """Phase 8: one KD loss-and-grad of the full width at 4 layers, B 2,
    T 512, from the same weights, LoRA and batch: (a) the kernel route in
    bf16, (b) the plain route in bf16, (c) the plain route in fp32."""
    depth = 4
    rng = np.random.default_rng(SEED + 6)
    feats = kd_features(cfg, 2, rng)
    batch = DistillCollator(pad_token_id=cfg.eos_token_id,
                            speech_bos_id=SPEECH_BOS)(feats)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    if batch["input_ids"].shape[1] != TRAIN_T:
        fail(f"grad path batch is not T = {TRAIN_T}")
    dcfg = DistillConfig()
    g = lora_scaling(dcfg.lora)

    def run(dtype, impl):
        c = dataclasses.replace(cfg, num_hidden_layers=depth,
                                dtype=dtype, attn_impl=impl)
        m = qwen3.Qwen3(c, dev)
        with torch.no_grad():
            for name, p in m.named_parameters():
                p.copy_(model.get_parameter(name))
        tr = {"layers": tree_map(lambda t: t[:depth].detach().clone()
                                 .requires_grad_(), lora["layers"]),
              "embed": {"weight": lora["embed"]["weight"].detach()
                        .to(c.torch_dtype).requires_grad_()}}
        emb = tr["embed"]["weight"]
        _cuda.reset_launches()
        hidden = qwen3.forward_train(
            m, batch["input_ids"], attention_mask=batch["attention_mask"],
            embed=emb, adapters=tr["layers"], adapter_scale=g, device=dev)
        out = head_sparse_kd_loss(hidden, emb, batch["labels"],
                                  batch["teacher_top_k_v"],
                                  batch["teacher_top_k_i"], None,
                                  dcfg.temperature, dcfg.alpha)
        leaves = tree_leaves(tr["layers"])
        grads = torch.autograd.grad(out.total, leaves + [emb])
        torch.cuda.synchronize()
        return (float(out.total.detach()), [x.float() for x in grads[:-1]],
                grads[-1].float(), dict(_cuda.launches))
    ref_loss, ref_lora, ref_emb, _ = run("float32", "xla")
    res = {"bf16_kernel": run("bfloat16", "auto"),
           "bf16_plain": run("bfloat16", "xla")}
    if res["bf16_kernel"][3]["flash_dq"] != depth \
            or res["bf16_plain"][3]["flash_dq"] != 0:
        fail(f"grad path routes: {[r[3] for r in res.values()]}")
    err = {}
    for key, (loss, lg, eg, _) in res.items():
        if not (np.isfinite(loss) and all(bool(torch.isfinite(x).all())
                                          for x in lg + [eg])):
            fail(f"{key}: non-finite loss or grads")
        err[key] = {"loss": abs(loss - ref_loss),
                    "lora_grad": max(((a - b).abs().max() / b.abs().max())
                                     .item() for a, b in zip(lg, ref_lora)),
                    "embed_grad": ((eg - ref_emb).abs().max()
                                   / ref_emb.abs().max()).item()}
    log("grad path: " + json.dumps({"layers": depth, "B": 2, "T": TRAIN_T,
                                    "fp32_plain_loss": ref_loss,
                                    "errors_vs_fp32_plain": err}) +
        f" (max |grad - fp32| / max |fp32 grad| over the LoRA leaves and "
        f"the embed; the kernel route must stay within {BF16_ERR_RATIO}x "
        f"the plain route's error)")
    for what in ("lora_grad", "embed_grad"):
        if not err["bf16_kernel"][what] <= \
                BF16_ERR_RATIO * err["bf16_plain"][what]:
            fail(f"bf16 {what} through the kernels is less accurate: {err}")


def main() -> None:
    if not torch.cuda.is_available():
        fail("CUDA is not available: this smoke runs on the GPU only")
    # fp32 products in full fp32 on the card (the plain versions are the
    # references); cuDNN's TF32 default is turned off as well
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_all = time.perf_counter()
    record_card()
    build_kernels()

    cfg = qwen3_student_0p6b()
    t0 = time.perf_counter()
    model = qwen3.init_params(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    log(f"model qwen3_student_0p6b hidden={cfg.hidden_size} layers="
        f"{cfg.num_hidden_layers} heads={cfg.num_attention_heads}/"
        f"{cfg.num_key_value_heads} vocab={cfg.vocab_size} bf16 random "
        f"init seed={SEED} s={time.perf_counter() - t0:.2f}")
    counts = serve(cfg, model)

    kernels = [check_paged_decode(dev, counts["paged_decode"]),
               check_flash_fwd(dev, counts["flash_fwd"])]
    check_model_path(cfg, model, dev)
    t0 = time.perf_counter()
    train_counts, lora = train(cfg, model, dev)
    bwd_rows, train_fwd = check_flash_bwd(dev, train_counts)
    kernels[1]["train_shape"] = dict(train_fwd,
                                     launches=train_counts["flash_fwd"])
    kernels += bwd_rows
    check_grad_path(cfg, model, lora, dev)
    log(f"train phases s={time.perf_counter() - t0:.2f}")
    log(f"total s={time.perf_counter() - t_all:.2f}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
