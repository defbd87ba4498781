"""What the two training drivers share: naming the trainable leaves, the
first steps and their readings, the measured window, and the comparison
with the reference.

A training cell builds one step with its model and optimizer state,
drives it from the seed through its first steps on the window's
own feed, then hands the same state to the window. The readings of the
first steps are the program's outputs that ``correct`` judges: each
step's loss, the first step's reported gradient norm (before the clip),
each leaf's first gradient as the optimizer received it (from AdamW's
first moment after step one, the clip undone with that norm), and each
leaf's change over those steps.
"""
from __future__ import annotations

import gc
import time
from typing import Callable, Dict, Iterator

B1 = 0.9        # AdamW's first-moment decay (the program's and the reference's)


def named_leaves(tree, prefix: str = "") -> Dict[str, "object"]:
    """{name: tensor} of a nested dict of tensors, a stacked [L, ...]
    leaf under ``layers`` split into its L layers (each projection of each
    layer is a leaf of its own)."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(named_leaves(v, name))
        elif name.startswith("layers."):
            for i in range(v.shape[0]):
                out[f"{name}[{i}]"] = v[i]
        else:
            out[name] = v
    return out


def norms(leaves: Dict[str, "object"]) -> Dict[str, float]:
    return {k: float(t.detach().float().norm()) for k, t in leaves.items()}


class Feed:
    """The window's feed: host batches from ``make(step)`` for step = 0,
    1, ..., placed on the device by the program's prefetch thread."""

    def __init__(self, make: Callable[[int], dict], device):
        from speech_distill_tpu_torch.core.prefetch import prefetch, put
        self._stop = False

        def host() -> Iterator[dict]:
            step = 0
            while not self._stop:
                yield make(step)
                step += 1
        self._it = prefetch(host(), put=lambda b: put(b, device), depth=2)

    def __next__(self):
        return next(self._it)

    def close(self) -> None:
        """Stop the producer and drain what it placed."""
        self._stop = True
        try:
            while True:
                next(self._it)
        except StopIteration:
            pass


def first_steps(run_step: Callable, state, feed: Feed, max_norm: float,
                n_steps: int, split: Callable = None) -> tuple:
    """Drive the step through the first ``n_steps`` batches of the feed;
    returns (state, the program's readings). ``split`` divides the named
    leaves further (stage 1: the embedding's old and new rows)."""
    import torch
    split = split or (lambda d: d)

    def leaves(tree):
        return split(named_leaves(tree))
    start = {k: t.detach().clone() for k, t in
             leaves(state.trainable).items()}
    losses, grads, g_norm = [], {}, None
    for i in range(n_steps):
        state, m = run_step(state, next(feed))
        losses.append(float(m["loss"]))
        if i == 0:
            g_norm = float(m["grad_norm"])
            clip = 1.0 if g_norm < max_norm else max_norm / g_norm
            grads = {k: float(t.float().norm()) / (1 - B1) / clip
                     for k, t in leaves(state.opt_state["mu"]).items()}
    change = {k: float((t.detach().float() - start[k].float()).norm())
              for k, t in leaves(state.trainable).items()}
    del start
    torch.cuda.empty_cache() if torch.cuda.is_available() else None
    return state, {"loss": losses, "grad_norm": g_norm, "grad": grads,
                   "change": change}


def window(bench, run_step: Callable, state, feed: Feed, tokens_per_step:
           int, trace_steps: int = 2) -> tuple:
    """Steps until ``bench.seconds`` have passed on the host clock, then a
    synchronise closes the window. With ``bench.trace`` the profiler then
    records ``trace_steps`` more steps on the device and one more on the
    host too (:class:`~benchmark.harness.trace.Traced`), outside the
    window, so the window's numbers are the same with and without it.
    Returns (state, counters)."""
    import torch
    from speech_distill_tpu_torch.ops import _cuda

    from benchmark.harness.trace import Traced
    on_card = bench.device != "cpu"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    sync()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    launches0 = dict(_cuda.launches)
    t0 = bench.window_opens()
    n = 0

    def one():
        nonlocal state
        with bench.spans("data_wait"):
            batch = next(feed)
        with bench.spans("step"):
            state, _ = run_step(state, batch)
    while n == 0 or time.perf_counter() - t0 < bench.seconds:
        one()
        n += 1
    sync()
    window_s = time.perf_counter() - t0
    counters = {
        "steps": n, "window_s": window_s, "tokens": n * tokens_per_step,
        "data_wait_s": bench.spans.seconds.get("data_wait", 0.0),
        "launches": {k: _cuda.launches[k] - launches0.get(k, 0)
                     for k in _cuda.launches},
        "memory_peak_bytes": (torch.cuda.max_memory_allocated()
                              if on_card else 0),
        "trace": None, "trace_steps": 0,
    }
    if bench.trace:
        traced = Traced()
        traced.next()
        for _ in range(trace_steps):
            one()
        traced.next()
        one()
        traced.next()
        counters.update(trace=traced.reduced, trace_steps=trace_steps)
    return state, counters


def free_program() -> None:
    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def compare(prog: dict, ref: dict, limits: Dict[str, float]) -> dict:
    """The numbers ``correct`` compares, each beside its limit:
    ``grad_norm_gap``, the first step's gradient norm before the clip
    against the reference's, relative; ``frozen_change``, the largest
    change of a leaf that the reference leaves exactly as it was (stage
    1's old rows: a masked gradient, and weight decay alone rounds away in
    bfloat16), absolute, 0 where there is none."""
    from benchmark.reference.train import leaf_gap, loss_gap
    g, g_leaf = leaf_gap(prog["grad"], ref["grad"], ref["grad"])
    c, c_leaf = leaf_gap(prog["change"], ref["change"], ref["grad"])
    frozen = [k for k, v in ref["change"].items() if v == 0.0]
    values = {"loss_gap": loss_gap(prog["loss"], ref["loss"]),
              "grad_norm_gap": abs(prog["grad_norm"] - ref["grad_norm"])
              / ref["grad_norm"],
              "grad_gap": g, "change_gap": c,
              "frozen_change": max((prog["change"][k] for k in frozen),
                                   default=0.0)}
    out = {}
    for name, v in values.items():
        lim = limits.get(name)
        out[name] = {"value": v, "limit": lim,
                     "ok": lim is not None and v <= lim}
    out["grad_gap"]["leaf"] = g_leaf
    out["change_gap"]["leaf"] = c_leaf
    return out


def unchanged(run: Callable, state, batch) -> tuple:
    """A step that returns its state unchanged: a fault the tests plant."""
    import copy
    keep = copy.deepcopy(state)
    _, metrics = run(state, batch)
    return keep, metrics


def stepper(step: Callable, base, teacher_slot: bool) -> Callable:
    """``run_step(state, batch)`` over the program's step signature."""
    if teacher_slot:
        return lambda state, batch: step(state, base, None, batch)
    return lambda state, batch: step(state, base, batch)


