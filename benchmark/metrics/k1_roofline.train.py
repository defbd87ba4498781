"""K1, causal flash attention (``ops/flash_attention`` -> ``csrc/
flash_fwd.cu`` ``flash_fwd_kernel``, ``csrc/flash_bwd.cu``
``flash_dq_kernel`` and ``flash_dkv_kernel``): the sum of each call's
least time over the sum of the kernels' device time in the trace.

A call's least time is max(operations / 989e12, bytes / 3.35e12) at the
step's shapes (B rows of T, H query heads, KV key heads of Dh). One
causal product of T x T is B H Dh T (T + 1) operations: the forward makes
two (scores, values), dq three (scores again: its inputs hold no
probabilities; dP; dQ), dkv four (scores, dP, dV, dK). Bytes: each input
read once and each output written once, bf16 tensors and fp32 row
statistics (log-sum-exp, the backward's delta)."""
from benchmark.harness.peaks import bound_s

MOVES = "train_tokens_per_s"
UNIT = "%"
KERNELS = {"flash_fwd_kernel": "fwd", "flash_dq_kernel": "dq",
           "flash_dkv_kernel": "dkv"}


def call_bound(kind: str, B: int, T: int, H: int, KV: int, Dh: int) -> float:
    prod = B * H * Dh * T * (T + 1)
    q, kv, rows = B * T * H * Dh, B * T * KV * Dh, B * H * T
    if kind == "fwd":
        ops, nbytes = 2 * prod, 2 * (2 * q + 2 * kv) + 4 * rows
    elif kind == "dq":
        ops, nbytes = 3 * prod, 2 * (3 * q + 2 * kv) + 8 * rows
    else:
        ops, nbytes = 4 * prod, 2 * (2 * q + 4 * kv) + 8 * rows
    return bound_s(ops, nbytes)


def read(run):
    tr = run.trace
    if tr is None:
        return None
    cfg, s = run.config, run.shapes
    args = (s["B"], s["T"], cfg["num_attention_heads"],
            cfg["num_key_value_heads"], cfg["head_dim"])
    bound = time = 0.0
    for name, kind in KERNELS.items():
        n = tr.count_of(name)
        if n:
            bound += n * call_bound(kind, *args)
            time += tr.time_of(name)
    if time <= 0:
        return None
    return 100.0 * bound / time
