"""Training loop: the HF-Trainer-shaped outer loop (port of
``speech_distill_tpu/core/trainer.py``): epoch iteration, gradient
accumulation as a microbatch axis, periodic logging, checkpoints with
retention, evaluation, load-best and resume.

Resume skips the batches the checkpointed steps already consumed (as HF
Trainer does), so a resumed run takes the same batches as an
uninterrupted one; the JAX loop starts the stream over instead.

``SDT_PROFILE=<dir>`` traces steps 11-13 with ``torch.profiler`` into
``<dir>`` (``core/metrics.ProfilerWindow``), with ``spans.json`` beside the
trace: the steps' phase spans (``train.forward``, ``train.head``,
``train.backward``, ``train.recompute``, ``train.optimizer``, ``data.wait``,
...) as ``{name: {"n", "device_s", "host_s"}}``, self seconds summed over
the three steps (``core/metrics.span_table``).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, Iterable, Iterator, List, Optional

import numpy as np

from speech_distill_tpu_torch.core.checkpoint import CheckpointManager
from speech_distill_tpu_torch.core.device import resolve_device
from speech_distill_tpu_torch.core.metrics import (MetricsLogger,
                                                   ProfilerWindow)
from speech_distill_tpu_torch.core.prefetch import prefetch, put


@dataclasses.dataclass
class LoopConfig:
    num_epochs: int = 3
    max_steps: Optional[int] = None
    logging_steps: int = 10
    save_steps: Optional[int] = None      # None -> save per epoch
    save_total_limit: int = 3
    output_dir: str = "./output"
    report_to: str = "none"
    eval_steps: Optional[int] = None      # None + eval_fn -> eval per epoch
    load_best_at_end: bool = True         # reference train.py:343


def shuffled_stream(dataset: Iterable,
                    shuffle_seed: Optional[int] = None,
                    epoch: int = 0,
                    shuffle_buffer: Optional[int] = None,
                    host_count: int = 1,
                    host_index: int = 0) -> Iterator:
    """Stream dataset items with O(shuffle_buffer) host memory (the
    reference relies on torch DataLoader workers + sampler,
    train.py:348-353; here a windowed shuffle buffer gives the streaming
    equivalent).

      * ``host_count``/``host_index``: deterministic every-Nth-item shard
        split (the multi-host data loading hook), applied BEFORE shuffling
        so hosts draw disjoint items regardless of buffer size.

      * ``shuffle_buffer=None`` (or >= dataset size): the buffer swallows
        the whole stream and emits ``rng.permutation`` of it — *identical*
        order to the old materialized implementation for the same
        (seed, epoch).
      * bounded ``shuffle_buffer=W``: classic windowed shuffle — fill W
        items, then for each incoming item emit a uniformly drawn buffer
        slot and replace it; drain the tail in a final permutation. Every
        item is emitted exactly once; order is deterministic per
        (seed, epoch, W).
    """
    it = iter(dataset)
    if host_count > 1:
        it = (x for i, x in enumerate(it) if i % host_count == host_index)
    if shuffle_seed is None:
        yield from it
        return
    rng = np.random.default_rng(shuffle_seed + epoch)
    if shuffle_buffer is None:
        items = list(it)
        for i in rng.permutation(len(items)):
            yield items[i]
        return
    buf: List = []
    for x in it:
        if len(buf) < shuffle_buffer:
            buf.append(x)
            continue
        j = int(rng.integers(len(buf)))
        out, buf[j] = buf[j], x
        yield out
    for i in rng.permutation(len(buf)):
        yield buf[i]


def batches_from(dataset: Iterable[Dict[str, np.ndarray]],
                 collate: Callable, batch_size: int, accum: int,
                 drop_last: bool = True,
                 shuffle_seed: Optional[int] = None,
                 epoch: int = 0,
                 shuffle_buffer: Optional[int] = None,
                 host_count: int = 1,
                 host_index: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Group examples into [A, B, ...] microbatched host batches.

    Streaming: host memory is O(shuffle_buffer + batch_size*accum), not
    O(epoch) — see :func:`shuffled_stream` for the shuffle / shard
    semantics (``shuffle_buffer=None`` reproduces the old materialized
    order).
    """
    chunk = batch_size * accum
    group: List = []
    for x in shuffled_stream(dataset, shuffle_seed, epoch, shuffle_buffer,
                             host_count, host_index):
        group.append(x)
        if len(group) < chunk:
            continue
        big = collate(group)
        group = []
        yield {k: v.reshape((accum, batch_size) + v.shape[1:])
               for k, v in big.items()}
    if group and not drop_last:
        # repeat-pad (tiling) the final group to a full static shape
        group = (group * (-(-chunk // len(group))))[:chunk]
        big = collate(group)
        yield {k: v.reshape((accum, batch_size) + v.shape[1:])
               for k, v in big.items()}


def train_loop(step_fn: Callable, state, frozen_args: tuple,
               batch_iter_fn: Callable[[int], Iterator[Dict[str, np.ndarray]]],
               cfg: LoopConfig,
               put_batch: Optional[Callable] = None,
               eval_fn: Optional[Callable] = None,
               ckpt: Optional[CheckpointManager] = None,
               tokens_per_batch: Optional[int] = None,
               device="cuda", mesh=None, state_specs=None):
    """Run the loop. ``step_fn(state, *frozen_args, batch) -> (state,
    metrics)``.

    ``batch_iter_fn(epoch)`` yields host batches; ``put_batch`` places them
    (by default a copy to ``device``, CUDA unless the caller names another;
    raises without it), in a background thread. ``eval_fn(state)`` returns
    metrics with a "loss". Returns the final state.

    ``mesh``: one rank of a multi-process run. Every rank passes the same
    global batches (the default ``put_batch`` keeps its dp rows,
    ``multihost.make_global_batch``); only the primary writes metrics and
    traces (JAX: ``MetricsLogger(write=)``), and checkpoints are gathered
    to rank 0 in the one-device format by ``state_specs(state)``
    (``sharding.state_pspecs``), so a resumed run may take another
    layout. Save, restore and eval run on every rank (collectives).
    """
    dev = resolve_device(device if mesh is None else mesh.device)
    primary = mesh is None or mesh.is_primary
    if put_batch is None:
        if mesh is not None:
            from speech_distill_tpu_torch.parallel.multihost import (
                make_global_batch)

            def put_batch(batch):
                return make_global_batch(mesh, batch)
        else:
            def put_batch(batch):
                return put(batch, dev)
    profiler = ProfilerWindow(
        os.environ.get("SDT_PROFILE", f"{cfg.output_dir}/trace"),
        enabled=bool(os.environ.get("SDT_PROFILE")) and primary)
    if ckpt is None:
        ckpt = CheckpointManager(f"{cfg.output_dir}/ckpt",
                                 cfg.save_total_limit, mesh=mesh,
                                 specs_fn=state_specs)

    start_step = 0
    latest = ckpt.latest_step()
    if latest is not None:
        restored = ckpt.restore(state, latest)
        if restored is not None:
            state = restored
            start_step = latest
            if primary:
                print(f"resumed from step {latest}")
    logger = MetricsLogger(cfg.output_dir, cfg.report_to if primary
                           else "none", write=primary, step=start_step)

    global_step = start_step
    to_skip = start_step            # batches the restored steps consumed
    done = False
    best = {"loss": float("inf"), "step": None}

    # the last saved step, kept here: a rank that read the directory would
    # see the primary's new file or not depending on timing, and skip or
    # enter the save's collectives unlike the others
    saved = {"step": latest}

    def save():
        if saved["step"] != global_step:
            ckpt.save(global_step, state)
            saved["step"] = global_step

    def run_eval():
        eval_metrics = eval_fn(state)
        logger.log(global_step,
                   {f"eval_{k}": v for k, v in eval_metrics.items()})
        loss = float(eval_metrics.get("loss", float("inf")))
        if loss < best["loss"]:
            best["loss"] = loss
            best["step"] = global_step
            save()

    for epoch in range(cfg.num_epochs):
        if done:
            break
        for batch in prefetch(batch_iter_fn(epoch), put=put_batch, depth=2):
            if to_skip:
                to_skip -= 1
                continue
            state, metrics = step_fn(state, *frozen_args, batch)
            global_step += 1
            profiler.on_step(global_step)
            if global_step % cfg.logging_steps == 0:
                logger.log(global_step, metrics, tokens_per_batch)
            if cfg.save_steps and global_step % cfg.save_steps == 0:
                save()
            if cfg.eval_steps and eval_fn and \
                    global_step % cfg.eval_steps == 0:
                run_eval()
            if cfg.max_steps and global_step >= cfg.max_steps:
                done = True
                break
        if eval_fn and not cfg.eval_steps and not to_skip:
            run_eval()                        # per-epoch eval (reference)
        if not cfg.save_steps:
            save()                            # per-epoch save (reference)
    save()
    ckpt.wait()
    if (cfg.load_best_at_end and eval_fn and best["step"] is not None
            and best["step"] != global_step):
        restored = ckpt.restore(state, best["step"])
        if restored is not None:
            state = restored
            if primary:
                print(f"loaded best model from step {best['step']} "
                      f"(eval loss {best['loss']:.4f})")
    profiler.close()
    logger.close()
    return state
