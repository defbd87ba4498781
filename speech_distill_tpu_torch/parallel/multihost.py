"""Multi-process start-up and the host side of a parallel run (port of
``speech_distill_tpu/parallel/multihost.py``).

JAX runs one process a host driving its local chips; the port runs one
process a device (as ``torchrun`` starts them), joined by
``torch.distributed``: NCCL between cards, gloo on the CPU.

  * :func:`initialize` starts the process group from the flags, the
    ``SDT_*`` variables or ``torchrun``'s (a no-op for one process).
  * :func:`make_global_batch`: every rank collates the same global batch
    and keeps its dp rows (the tp ranks of one dp index need the same
    rows; a one-process run sees the same batches).
  * :func:`fetch_replicated` makes sharded leaves whole for export.
"""
from __future__ import annotations

import datetime
import os
from typing import Any, Dict, Optional

import torch

from speech_distill_tpu_torch.parallel.mesh import Mesh

# a rank that dies fails the others at their next collective after this
# long, instead of hanging them
TIMEOUT_S = 600


def _env_int(*names) -> Optional[int]:
    for n in names:
        if os.environ.get(n):
            return int(os.environ[n])
    return None


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               backend: Optional[str] = None, device=None,
               timeout_s: float = TIMEOUT_S) -> bool:
    """Join this process to the group. Returns True if a multi-process
    run started (False: one process, nothing done).

    Arguments fall back to SDT_COORDINATOR / SDT_NUM_PROCESSES /
    SDT_PROCESS_ID, as in JAX, then to ``torchrun``'s MASTER_ADDR:
    MASTER_PORT / WORLD_SIZE / RANK. ``coordinator_address`` is
    ``host:port`` (a ``tcp://`` address) or a ``file://`` store path.
    ``backend``: "nccl" when the rank's ``device`` is a card (the default,
    ``mesh.rank_device``), else "gloo". The group's ``timeout_s`` bounds
    every collective."""
    coordinator_address = coordinator_address or os.environ.get(
        "SDT_COORDINATOR")
    if num_processes is None:
        num_processes = _env_int("SDT_NUM_PROCESSES", "WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("SDT_PROCESS_ID", "RANK")
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', 29500)}")
    if coordinator_address is None and num_processes is None:
        return False
    if num_processes is not None and num_processes <= 1:
        return False
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("a multi-process run needs the coordinator "
                         "address, the process count and this process's "
                         "id")
    import torch.distributed as dist
    from speech_distill_tpu_torch.parallel.mesh import rank_device
    if dist.is_initialized():
        return True
    dev = rank_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return True


def process_count() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    return process_index() == 0


def check_single_host() -> None:
    """Raise ``ValueError`` when the ranks span more than one host: the
    disaggregated teacher is single-host, as in JAX (which refuses it for
    more than one process: a JAX process is a host, a rank here is a
    device). Each rank's ``socket.gethostname()`` is all-gathered over
    the process group (every rank calls this)."""
    import socket
    import torch.distributed as dist
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return
    names = [None] * dist.get_world_size()
    dist.all_gather_object(names, socket.gethostname())
    if len(set(names)) > 1:
        raise ValueError(
            f"--teacher_devices (disaggregated teacher) is single-host; "
            f"these ranks span {len(set(names))} hosts")


def shutdown() -> None:
    """Leave the process group (if one was started)."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def local_batch_size(global_batch: int, mesh: Optional[Mesh] = None
                     ) -> int:
    """Rows of the global batch this rank holds: global / dp (every
    process when no mesh is given, as in JAX)."""
    n = mesh.dp if mesh is not None else process_count()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{'dp' if mesh is not None else 'process count'}"
                         f" {n}")
    return global_batch // n


def make_global_batch(mesh: Mesh, batch: Dict[str, Any],
                      microbatched: bool = True) -> Dict[str, Any]:
    """This rank's dp rows of the global host ``batch`` on its device
    (``sharding.shard_batch``: axis 1 under the microbatch axis, else
    axis 0). Every rank passes the same global batch."""
    from speech_distill_tpu_torch.parallel.sharding import shard_batch
    return shard_batch(mesh, batch, microbatched=microbatched)


def fetch_replicated(tree, specs=None, mesh: Optional[Mesh] = None):
    """The tree with its sharded leaves made whole on every rank, detached
    (``sharding.gather_tree`` under ``specs`` on ``mesh``: a collective,
    every rank calls it), for export; a one-process tree as it is."""
    from speech_distill_tpu_torch.core.tree import tree_map
    if mesh is not None and specs is not None:
        from speech_distill_tpu_torch.parallel.sharding import gather_tree
        return gather_tree(tree, specs, mesh)
    return tree_map(lambda x: x.detach(), tree)


def barrier(mesh: Optional[Mesh] = None) -> None:
    """Every rank of ``mesh`` (default: of the process group) waits here
    for the others (e.g. before reading a checkpoint another rank just
    wrote). A disaggregated run passes the student's mesh: the teacher
    ranks, serving, never join it."""
    import torch.distributed as dist
    if not dist.is_initialized():
        return
    if mesh is not None:
        group = mesh.group(None)
        if group is not None:
            dist.barrier(group=group)
    elif dist.get_world_size() > 1:
        dist.barrier()


def _launched(fn, rank: int, world: int, store: str, device, backend,
              timeout_s: float, threads, out, args) -> None:
    """One launched rank: join the group, run ``fn``, report, leave."""
    import traceback
    try:
        if device is None:
            os.environ["LOCAL_RANK"] = str(rank)    # one card a rank
        if threads:
            torch.set_num_threads(threads)
        initialize(f"file://{store}", world, rank, backend=backend,
                   device=device, timeout_s=timeout_s)
        out.put((rank, True, fn(rank, world, *args)))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
        raise
    finally:
        shutdown()


def launch(fn, world: int, *args, store_dir: str, device=None,
           backend: Optional[str] = None, timeout_s: float = 600,
           threads: Optional[int] = None) -> list:
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes of
    one host joined through a ``file://`` store in ``store_dir`` (a fresh
    directory); returns each rank's result (picklable) in rank order.
    ``device``: every rank's (``"cpu"`` only when asked; two ranks on one
    card pass it), default rank r's card ``cuda:r``; raises without CUDA.
    ``backend``: as :func:`initialize` picks it; two ranks on one card
    need "gloo" (NCCL refuses a device twice). A rank's
    exception, death or a run past ``timeout_s`` raises ``RuntimeError``
    here, and every rank still running is killed: a hung collective
    fails the launch instead of hanging it."""
    import multiprocessing as mp
    import queue
    import time
    from speech_distill_tpu_torch.parallel.mesh import rank_device
    rank_device("cuda:0" if device is None else device)
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    store = os.path.join(store_dir, "store")
    procs = [ctx.Process(target=_launched, args=(
        fn, r, world, store, device, backend, timeout_s, threads, out,
        args), daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    results = {}
    try:
        while len(results) < world:
            try:
                rank, ok, val = out.get(timeout=1.0)
            except queue.Empty:
                dead = [(i, p.exitcode) for i, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and i not in results]
                if dead:
                    raise RuntimeError(f"launched ranks died: {dead}")
                if time.monotonic() > deadline:
                    raise RuntimeError(f"launched ranks ran past "
                                       f"{timeout_s} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{val}")
            results[rank] = val
    finally:
        for p in procs:
            p.join(timeout=30 if len(results) == world else 1)
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(world)]
