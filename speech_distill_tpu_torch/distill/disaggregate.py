"""The disaggregated teacher: the teacher serves top-K artifacts from ranks
of its own, pipelined ahead of the student's KD step (port of
``speech_distill_tpu/distill/disaggregate.py``).

JAX runs two disjoint meshes over one process's devices and gets its
overlap from async dispatch. The port runs one process a device, so the
two sides are different programs (MPMD, as ``parallel/pipeline`` is):

  * ``split_devices(n)``: the trailing ``n`` ranks are the teacher's, the
    rest the student's; every rank builds both meshes
    (``parallel/mesh.make_mesh(ranks=)``).
  * The student ranks' :class:`TeacherService` ``submit``s a request (the
    [A B, T] ids and mask, from the student's primary to every teacher
    rank) and ``get``s the artifacts (fp16 logprobs and int32 indices
    [A B, T, K], from the teacher's primary to every student rank).
  * The teacher ranks run :meth:`TeacherService.serve`: receive a request,
    extract each teacher dp slice's rows on its (dp x tp) mesh (the
    online-KD extraction: forward, then the top-K over the student vocab),
    all-gather them over the teacher's dp, send them back; a stop message
    from the student's ``close`` ends the loop. (Counting batches would
    not do: the student stops at ``max_steps`` mid-epoch and runs eval
    batches too.)
  * The student consumes the stream through the *precomputed* KD step, the
    same loss as online KD when the extraction is exact.

Each request carries a key, (stream, index): :func:`pipeline_batches`
opens a stream per call and numbers its batches, and ``get`` waits for
its own key. A stream abandoned with extractions in flight (the train
loop stopping at ``max_steps`` while its prefetcher reads ahead) thus
never hands its artifacts to the next stream (eval's); JAX's shared FIFO
does (ROADMAP §3). The keys are the same on every student rank: streams
open in the main thread, in program order.

Transport: the artifacts are small (~3.1 MB at B 8, T 512, K 128 against
2.6 GB of dense fp32 logits), so they go through the host on gloo groups
of their own (``req``: the student primary and the teacher ranks;
``rep``: the teacher primary and the student ranks), whatever the
training backend; every send has its receive posted on the peer (a
receiver thread a student rank, the serve loop a teacher rank).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, Iterable, Iterator, Optional, Sequence

import numpy as np
import torch

# message kinds of the header's first field
_REQUEST, _STOP = 1, 2        # student primary -> teacher ranks
_REPLY, _END = 3, 4           # teacher primary -> student ranks
_HDR = 6                      # kind, stream, index, N, T, K


def split_devices(n_teacher: int, ranks: Optional[Sequence[int]] = None):
    """(student ranks, teacher ranks): the trailing ``n_teacher`` of
    ``ranks`` (default: every rank of the process group) for the
    teacher."""
    if ranks is None:
        import torch.distributed as dist
        n = dist.get_world_size() if dist.is_initialized() else 1
        ranks = range(n)
    ranks = list(ranks)
    if not 0 < n_teacher < len(ranks):
        raise ValueError(
            f"teacher_devices={n_teacher} must be in (0, {len(ranks)})")
    return ranks[:-n_teacher], ranks[-n_teacher:]


def _header(*fields) -> torch.Tensor:
    h = torch.zeros(_HDR, dtype=torch.int64)
    h[:len(fields)] = torch.tensor(fields, dtype=torch.int64)
    return h


class TeacherService:
    """Both sides of the teacher's stream; every rank of the world builds
    it (:func:`make_teacher_service`: its groups are collective).

    Student ranks: ``submit(ids, mask)`` queues one [N, T] extraction and
    returns at once (the primary posts the sends); ``get()`` blocks for
    the oldest in-flight one's host (v, i) arrays, ``get(key)`` for a
    given one; ``len`` is the number in flight; ``close()`` stops the
    teacher ranks (every student rank calls it once, after its last
    ``get``). ``wait_s`` lists the seconds each ``get`` waited.

    Teacher ranks (``is_teacher``): ``serve()`` runs the loop until the
    stop, returning the seconds each extraction took."""

    def __init__(self, student_ranks: Sequence[int],
                 teacher_ranks: Sequence[int], extract: Optional[Callable]
                 = None, teacher=None, mesh=None, depth: int = 2):
        import torch.distributed as dist
        self.students, self.teachers = list(student_ranks), list(
            teacher_ranks)
        self.depth = max(1, depth)
        self.rank = dist.get_rank()
        self.is_teacher = self.rank in self.teachers
        # the groups: every rank creates both, in this order
        self._req = dist.new_group([self.students[0]] + self.teachers,
                                   backend="gloo")
        self._rep = dist.new_group([self.teachers[0]] + self.students,
                                   backend="gloo")
        self.extract, self.teacher, self.mesh = extract, teacher, mesh
        self._inflight: deque = deque()
        self._sends: list = []
        self._streams = 0
        self._next = 0
        self._stash: Dict[tuple, tuple] = {}
        self._dropped: set = set()
        # the stash, the keys in flight and the dropped streams, shared by
        # the receiver thread and the getters (a prefetch thread, eval)
        self._cv = threading.Condition()
        self._lock = threading.Lock()       # the primary's sends
        self._closed = False
        self.wait_s: list = []
        self._receiver = None
        if not self.is_teacher:
            self._receiver = threading.Thread(target=self._receive,
                                              daemon=True)
            self._receiver.start()

    # -- the student side ------------------------------------------------

    def open_stream(self) -> int:
        """A new stream id (call it in program order on every student
        rank: :func:`pipeline_batches` does)."""
        self._streams += 1
        return self._streams

    def submit(self, ids: np.ndarray, mask: np.ndarray,
               key: Optional[tuple] = None) -> tuple:
        """Queue the extraction of one [N, T] batch; returns its key."""
        import torch.distributed as dist
        with self._cv:
            if key is None:
                key = (0, self._next)
                self._next += 1
            self._inflight.append(key)
        if self.rank != self.students[0]:
            return key
        ids = torch.as_tensor(np.asarray(ids), dtype=torch.int64)
        mask = torch.as_tensor(np.asarray(mask), dtype=torch.int64)
        N, T = ids.shape
        msgs = (_header(_REQUEST, key[0], key[1], N, T), ids.contiguous(),
                mask.contiguous())
        with self._lock:
            self._sends = [w for w in self._sends if not w[0].is_completed()]
            for dst in self.teachers:
                for m in msgs:
                    self._sends.append((dist.isend(m, dst, group=self._req),
                                        m))
        return key

    def get(self, key: Optional[tuple] = None):
        """Block on an in-flight extraction (the oldest without ``key``);
        host (fp16 v, int32 i) arrays [N, T, K]."""
        t0 = time.perf_counter()
        with self._cv:
            if key is None:
                key = self._inflight[0]
            self._inflight.remove(key)
            while key not in self._stash:
                if self._receiver is None or not self._receiver.is_alive():
                    raise RuntimeError("the teacher stream ended before "
                                       f"extraction {key} arrived")
                self._cv.wait(timeout=1.0)
            v, i = self._stash.pop(key)
        self.wait_s.append(time.perf_counter() - t0)
        return v, i

    def drop(self, stream: int) -> None:
        """Forget a closed stream's artifacts (arrived or to come)."""
        with self._cv:
            self._dropped.add(stream)
            for k in [k for k in self._stash if k[0] == stream]:
                del self._stash[k]
            self._inflight = deque(k for k in self._inflight
                                   if k[0] != stream)

    def __len__(self) -> int:
        with self._cv:
            return len(self._inflight)

    def _receive(self) -> None:
        """A student rank's receiver: every reply of the teacher's primary
        into the stash, until the end message."""
        import torch.distributed as dist
        src = self.teachers[0]
        while True:
            h = torch.empty(_HDR, dtype=torch.int64)
            dist.recv(h, src, group=self._rep)
            kind, stream, index, N, T, K = h.tolist()
            if kind == _END:
                return
            v = torch.empty((N, T, K), dtype=torch.float16)
            i = torch.empty((N, T, K), dtype=torch.int32)
            dist.recv(v, src, group=self._rep)
            dist.recv(i, src, group=self._rep)
            with self._cv:
                if stream not in self._dropped:
                    self._stash[(stream, index)] = (v.numpy(), i.numpy())
                    self._cv.notify_all()

    def close(self) -> None:
        """Stop the teacher ranks; returns once every reply sent to this
        rank has arrived (the abandoned ones dropped)."""
        import torch.distributed as dist
        if self.is_teacher or self._closed:
            return
        self._closed = True
        if self.rank == self.students[0]:
            with self._lock:
                for w, _ in self._sends:
                    w.wait()
                self._sends = []
                for dst in self.teachers:
                    dist.send(_header(_STOP), dst, group=self._req)
        self._receiver.join()
        with self._cv:
            self._stash.clear()
            self._inflight.clear()

    # -- the teacher side ------------------------------------------------

    def serve(self) -> list:
        """The teacher ranks' loop: each request's rows of this rank's dp
        slice extracted (the tp collectives inside the teacher's forward),
        all-gathered over the teacher's dp, sent by the teacher's primary
        to every student rank. Returns the seconds of each extraction."""
        import torch.distributed as dist
        from speech_distill_tpu_torch.parallel import comm
        src, mesh = self.students[0], self.mesh
        primary = self.rank == self.teachers[0]
        dp, di = mesh.dp, mesh.index("dp")
        pending: list = []
        took = []
        while True:
            h = torch.empty(_HDR, dtype=torch.int64)
            dist.recv(h, src, group=self._req)
            kind, stream, index, N, T, _ = h.tolist()
            if kind == _STOP:
                for w, _m in pending:
                    w.wait()
                if primary:
                    for dst in self.students:
                        dist.send(_header(_END), dst, group=self._rep)
                return took
            ids = torch.empty((N, T), dtype=torch.int64)
            mask = torch.empty((N, T), dtype=torch.int64)
            dist.recv(ids, src, group=self._req)
            dist.recv(mask, src, group=self._req)
            if N % dp:
                raise ValueError(f"{N} rows do not split over the "
                                 f"teacher's dp={dp}")
            rows = slice(di * (N // dp), (di + 1) * (N // dp))
            t0 = time.perf_counter()
            with torch.no_grad():
                v, i = self.extract(self.teacher,
                                    ids[rows].to(mesh.device),
                                    mask[rows].to(mesh.device))
                group = mesh.group("dp")
                v, i = comm.all_gather(v, group), comm.all_gather(i, group)
            v = v.to("cpu", torch.float16).contiguous()
            i = i.to("cpu", torch.int32).contiguous()
            took.append(time.perf_counter() - t0)
            if primary:
                for w, _m in pending:
                    w.wait()
                msgs = (_header(_REPLY, stream, index, N, T, v.shape[-1]),
                        v, i)
                pending = [(dist.isend(m, dst, group=self._rep), m)
                           for dst in self.students for m in msgs]


def make_teacher_service(teacher, teacher_cfg, mesh, *, top_k: int,
                         student_vocab_size: int, method: str = "exact",
                         recall: float = 0.95,
                         extract_fn: Optional[Callable] = None,
                         shard: bool = True, depth: int = 2,
                         ranks: Optional[tuple] = None) -> TeacherService:
    """The service of the standard Qwen3 teacher extraction (the online-KD
    extraction, reference train.py:74-94: ``qwen3.forward``, then
    ``losses.extract_top_k`` over the student vocab with ``method``).
    Every rank calls it: ``teacher`` and its ``mesh`` (the teacher's, from
    ``make_mesh(ranks=teacher ranks)``) on the teacher ranks, None on the
    student ranks. ``ranks``: (student ranks, teacher ranks), as
    :func:`split_devices` returns them. Pass ``extract_fn(teacher, ids,
    mask) -> (v, i)`` to serve another teacher (the CosyVoice2 teacher:
    ``models/cosyvoice2.make_teacher_extract``), and ``shard=False`` when
    the teacher already holds its slices of ``mesh``
    (``sharding.shard_params``; ``teacher_cfg``: the config it shards
    under, default the teacher's own)."""
    from speech_distill_tpu_torch.distill import losses
    from speech_distill_tpu_torch.models import qwen3

    if ranks is None:
        raise ValueError("ranks=(student ranks, teacher ranks) is needed: "
                         "every rank calls make_teacher_service")
    if extract_fn is None:
        def extract_fn(t, ids, mask):
            logits = qwen3.forward(t, ids, attention_mask=mask)
            return losses.extract_top_k(
                logits, top_k, student_vocab_size=student_vocab_size,
                method=method, recall=recall)
    if teacher is not None and shard and mesh is not None \
            and mesh.world > 1:
        from speech_distill_tpu_torch.parallel.sharding import shard_params
        teacher = shard_params(mesh, teacher, teacher_cfg or teacher.cfg)
    return TeacherService(ranks[0], ranks[1], extract_fn, teacher, mesh,
                          depth=depth)


def pipeline_batches(batches: Iterable[Dict[str, np.ndarray]],
                     service: TeacherService
                     ) -> Iterator[Dict[str, np.ndarray]]:
    """Adapt a host-batch iterator for the precomputed KD step: stream
    teacher_top_k_v / _i through the service, keeping up to
    ``service.depth`` extractions in flight ahead of the consumer.

    Batches carry microbatched [A, B, T] arrays (``core/trainer.
    batches_from``); extraction flattens them to [A B, T] and the
    artifacts reshape back to [A, B, T, K]. Teacher and student sequences
    must be position-aligned (as online KD needs; ``data/template.
    align_prefixes`` sees to it). The stream opens here, when called (in
    program order on every student rank); each yielded batch carries its
    own extraction, whatever other streams run meanwhile."""
    stream = service.open_stream()
    return _stream(batches, service, stream)


def _stream(batches, service: TeacherService, stream: int):
    pending: deque = deque()

    def attach(hb, key):
        v, i = service.get(key)
        A, B, T = hb["input_ids"].shape
        if v.shape[:1] != (A * B,) or v.shape[1] != T:
            raise ValueError(
                f"teacher artifacts {v.shape} misaligned with student batch "
                f"{(A, B, T)}; online KD requires position-aligned "
                f"teacher/student sequences")
        out = dict(hb)
        out["teacher_top_k_v"] = v.reshape(A, B, T, -1)
        out["teacher_top_k_i"] = i.reshape(A, B, T, -1)
        return out

    try:
        for n, hb in enumerate(batches):
            ids = np.asarray(hb.get("teacher_input_ids", hb["input_ids"]))
            mask = np.asarray(hb.get("teacher_attention_mask",
                                     hb["attention_mask"]))
            A, B, T = ids.shape
            key = service.submit(ids.reshape(A * B, T),
                                 mask.reshape(A * B, T), key=(stream, n))
            pending.append((hb, key))
            if len(pending) > service.depth:
                yield attach(*pending.popleft())
        while pending:
            yield attach(*pending.popleft())
    finally:
        service.drop(stream)
