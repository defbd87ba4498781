"""K2, the fused lm-head cross entropy of stage 1 (``ops/pallas_lm_loss``
-> ``csrc/lm_head_stats.cu``: ``lm_head_stats_kernel``,
``lm_head_combine_kernel``, ``lm_head_dl_kernel``,
``lm_head_gemm_kernel``): the traced microbatches' least time over the
kernels' device time.

A microbatch of N = B (T - 1) shifted rows against the [V, D] head
requires its logits once, dh and dW: 6 N V D operations. Bytes: h, the
head and the labels read once; dh and dW written once (bf16). The least
time is max(operations / 989e12, bytes / 3.35e12); the logits recomputed
in the backward are not counted."""
from benchmark.harness.peaks import bound_s

MOVES = "train_tokens_per_s"
UNIT = "%"
KERNELS = ("lm_head_stats_kernel", "lm_head_combine_kernel",
           "lm_head_dl_kernel", "lm_head_gemm_kernel")


def microbatch_bound(N: int, V: int, D: int) -> float:
    ops = 6.0 * N * V * D
    nbytes = 2 * N * D + 2 * V * D + 8 * N + 2 * N * D + 2 * V * D
    return bound_s(ops, nbytes)


def read(run):
    tr = run.trace
    if tr is None:
        return None
    time = tr.time_of(*KERNELS)
    n_mb = run.counters.get("trace_steps", 0) * run.shapes["A"]
    if time <= 0 or not n_mb:
        return None
    cfg, s = run.config, run.shapes
    N = s["B"] * (s["T"] - 1)
    b = microbatch_bound(N, cfg["vocab_size"], cfg["hidden_size"])
    return 100.0 * n_mb * b / time
