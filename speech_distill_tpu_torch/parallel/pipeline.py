"""Pipeline parallelism: microbatch pipelining of the layer stack over the
mesh's ``pp`` axis (port of ``speech_distill_tpu/parallel/pipeline.py``).

Each pp rank (stage) holds L / pp layers (``sharding.shard_params`` with
``param_pspecs(cfg, pp=True)``); under interleaving its V chunks of
L / (pp V) layers (:func:`_interleave_layer_perm`). JAX runs the
schedules as one lockstep SPMD tick scan inside a ``shard_map``, shifting
activations with ``ppermute`` every tick; the port runs the same tables
as MPMD: at tick t a stage does the forward and the backward the tables
name and sends activations (to the next stage) and cotangents (to the
previous one) that a neighbour consumes at t + 1 (``comm.exchange``, every
message of a tick posted together). No point-to-point op sits inside an
autograd function whose order the engine picks: each microbatch's
backward is driven explicitly (``torch.autograd.grad`` on the recomputed
chunk with the received cotangent), so the receives pair with the sends.

  * :func:`pipelined_layers`: GPipe. Forward only under ``no_grad`` (the
    teacher, eval); with gradients an autograd function whose forward
    stashes each microbatch's stage input and whose backward runs the
    microbatches' backwards in reverse order, recomputing each stage
    forward (full remat). The values are JAX's autodiffed GPipe's. A
    stage laid out for interleaving runs its chunks in turn, the last
    stage's chunk v feeding stage 0's chunk v + 1.
  * :func:`pipelined_grads_1f1b` / :func:`pipelined_grads_interleaved`:
    the hand-scheduled (interleaved) 1F1B of JAX, from the tables of
    :func:`_interleaved_schedule`: a stage's peak of stashed chunk inputs
    is its slot count in the tables (K at most).

The last stage's output (the loss, the head's gradients) reaches every pp
rank, as JAX's replicated outputs do, and so does stage 0's gradient of
the pipeline input: every leaf replicated over pp gets the same gradient
on every stage.
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from speech_distill_tpu_torch.parallel import comm

TAG_FWD, TAG_BWD = 1, 2


def mesh_pp(mesh) -> int:
    return int(mesh.shape.get("pp", 1)) if mesh is not None else 1


def _stage(mesh) -> tuple:
    """(pp group, pp size, this rank's stage)."""
    return mesh.group("pp"), mesh.size("pp"), mesh.index("pp")


def _last_rank(group, S: int) -> int:
    import torch.distributed as dist
    return dist.get_global_rank(group, S - 1)


def _first_rank(group) -> int:
    import torch.distributed as dist
    return dist.get_global_rank(group, 0)


def _forward_only(run_chunk, x, mesh, n_micro, n_virtual, leaves,
                  stash=None):
    """The GPipe forward: microbatch by microbatch, each stage applies its
    chunk v = 0 .. V - 1 (all its layers for V 1) to what the previous
    stage sends (the last stage's chunk v feeds stage 0's chunk v + 1)
    and sends the result on; the last stage's outputs are broadcast over
    pp. ``stash`` (a list) collects each chunk input."""
    group, S, s = _stage(mesh)
    M, V = n_micro, n_virtual
    xm = x.reshape((M, x.shape[0] // M) + x.shape[1:])
    outs = []
    for m in range(M):
        for v in range(V):
            if s == 0 and v == 0:
                h = xm[m]
            else:
                (h,) = comm.exchange([], [(xm.shape[1:], x.dtype,
                                           (s - 1) % S, TAG_FWD)],
                                     group, x.device)
            if stash is not None:
                stash.append(h)
            h = run_chunk(v, h, m, leaves)
            if s == S - 1 and v == V - 1:
                outs.append(h)
            else:
                comm.exchange([(h, (s + 1) % S, TAG_FWD)], [], group)
    out = torch.cat(outs) if s == S - 1 else torch.empty_like(x)
    return comm.broadcast(out, group, _last_rank(group, S))


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run_chunk, mesh, n_micro, n_virtual, x, *leaves):
        stash: list = []
        out = _forward_only(run_chunk, x, mesh, n_micro, n_virtual, leaves,
                            stash)
        ctx.run_chunk, ctx.mesh = run_chunk, mesh
        ctx.M, ctx.V = n_micro, n_virtual
        ctx.stash, ctx.x_shape = stash, x.shape
        ctx.save_for_backward(*leaves)
        return out

    @staticmethod
    def backward(ctx, g):
        leaves = ctx.saved_tensors
        group, S, s = _stage(ctx.mesh)
        M, V = ctx.M, ctx.V
        gm = g.reshape((M, g.shape[0] // M) + g.shape[1:])
        acc = [torch.zeros_like(l, dtype=torch.float32) for l in leaves]
        g_x = torch.zeros(ctx.x_shape, dtype=g.dtype, device=g.device)
        gxm = g_x.view_as(gm)
        for m in reversed(range(M)):
            for v in reversed(range(V)):
                if s == S - 1 and v == V - 1:
                    g_in = gm[m]
                else:
                    (g_in,) = comm.exchange([], [(gm.shape[1:], g.dtype,
                                                  (s + 1) % S, TAG_BWD)],
                                            group, g.device)
                h_in = ctx.stash.pop().detach().requires_grad_(True)
                lv = [l.detach().requires_grad_(True) for l in leaves]
                with torch.enable_grad():
                    h_out = ctx.run_chunk(v, h_in, m, lv)
                grads = torch.autograd.grad(h_out, [h_in] + lv, g_in,
                                            allow_unused=True)
                for a, gl in zip(acc, grads[1:]):
                    if gl is not None:
                        a += gl.float()
                if s == 0 and v == 0:
                    gxm[m] = grads[0]
                else:
                    comm.exchange([(grads[0].to(g.dtype), (s - 1) % S,
                                    TAG_BWD)], [], group)
        g_x = comm.broadcast(g_x, group, _first_rank(group))
        return (None, None, None, None, g_x,
                *(a.to(l.dtype) for a, l in zip(acc, leaves)))


def pipelined_layers(run_chunk: Callable, x: torch.Tensor, mesh,
                     n_micro: int, leaves: Sequence[torch.Tensor] = (),
                     n_virtual: int = 1) -> torch.Tensor:
    """The layer stack applied to ``x`` [B, ...] pipelined over pp (GPipe):
    ``run_chunk(v, h, m, leaves)`` applies this stage's chunk ``v`` (its
    layers, or for an interleaved stage its v-th chunk of ``n_virtual``)
    to microbatch ``m`` (rows m B/M to (m + 1) B/M, whose rope / mask
    slices it picks), reading the stage's trainable ``leaves`` (LoRA
    factors or full-finetuning layer leaves); every pp rank gets the
    output. With gradients enabled and ``x`` or a leaf requiring grad,
    differentiable (see the module docstring); B must divide by
    ``n_micro``."""
    B = x.shape[0]
    if n_micro < 1 or B % n_micro:
        raise ValueError(f"batch {B} not divisible by n_micro={n_micro}")
    leaves = tuple(leaves)
    if torch.is_grad_enabled() and (x.requires_grad or any(
            l.requires_grad for l in leaves)):
        return _GPipe.apply(run_chunk, mesh, n_micro, n_virtual, x,
                            *leaves)
    with torch.no_grad():
        return _forward_only(run_chunk, x, mesh, n_micro, n_virtual,
                             leaves)


# ---------------------------------------------------------------------------
# 1F1B and interleaved 1F1B
# ---------------------------------------------------------------------------


def _interleaved_schedule(S: int, V: int, M: int):
    """Static schedule tables for the (optionally interleaved) 1F1B
    pipeline of S stages with V virtual stages ("model chunks") each,
    JAX's tables exactly (``speech_distill_tpu/parallel/pipeline.py``).

    Logical stage q = v S + s (chunk v on stage s) holds L / (S V)
    consecutive layers; microbatches go in groups of S:

      fwd  of (m, v) on stage s at tick  F = s + sig(m, v)
      bwd  of (m, v) on stage s at tick  B = (Q-1) + (S-1-s) + sigb(m, v)
      sig(m, v)  = (m % S) + v S       + (m // S) S V
      sigb(m, v) = (m % S) + (V-1-v) S + (m // S) S V

    Every producer -> consumer dependency lands one tick apart (asserted):
    the forward ring s -> s + 1 (the wrap S - 1 -> 0 is the chunk hop
    v -> v + 1), the backward ring s -> s - 1. The first backward of a
    microbatch (v = V - 1 on the last stage) lands on the tick of its
    last forward, seeded by the head. A stash slot holds a chunk input
    from F to B; slots are assigned by linear scan (first fit over sorted
    starts, optimal for interval colouring), K being the peak.

    Returns (tables, tB0, tC0, T, K): ``tables`` a dict of numpy arrays
    indexed [tick, stage] (head entries [tick]), phase bounds [0, tB0) /
    [tB0, tC0) / [tC0, T).
    """
    Q = S * V

    def sig(m, v):
        return (m % S) + v * S + (m // S) * S * V

    def sigb(m, v):
        return (m % S) + (V - 1 - v) * S + (m // S) * S * V

    off = Q - 1
    T = off + (S - 1) + sigb(M - 1, 0) + 1      # last bwd: (M-1, v=0, s=0)
    zi = lambda: np.zeros((T, S), np.int32)     # noqa: E731
    zb = lambda: np.zeros((T, S), bool)         # noqa: E731
    tb = {"fm": zi(), "fv": zi(), "fvalid": zb(), "fslot": zi(),
          "bm": zi(), "bv": zi(), "bvalid": zb(), "bslot": zi(),
          "bseed": zb(), "hm": np.zeros(T, np.int32),
          "hvalid": np.zeros(T, bool)}
    K = 0
    for s in range(S):
        events = []
        for m in range(M):
            for v in range(V):
                F = s + sig(m, v)
                B = off + (S - 1 - s) + sigb(m, v)
                assert F <= B < T and not tb["fvalid"][F, s] \
                    and not tb["bvalid"][B, s]
                tb["fm"][F, s], tb["fv"][F, s] = m, v
                tb["fvalid"][F, s] = True
                tb["bm"][B, s], tb["bv"][B, s] = m, v
                tb["bvalid"][B, s] = True
                if s == S - 1 and v == V - 1:
                    assert F == B and not tb["hvalid"][F]
                    tb["hm"][F], tb["hvalid"][F] = m, True
                    tb["bseed"][B, s] = True
                events.append((F, B))
        # linear-scan stash allocation; a slot frees the tick after its
        # last read (the in-tick write precedes the read)
        events.sort()
        free_at: list = []
        for F, B in events:
            for k, fa in enumerate(free_at):
                if fa <= F:
                    break
            else:
                k = len(free_at)
                free_at.append(0)
            free_at[k] = B + 1
            tb["fslot"][F, s] = k
            tb["bslot"][B, s] = k
        K = max(K, len(free_at))

    # ring tightness: every valid message is consumed by the neighbour
    # exactly one tick later (or provably ignored at the wrap)
    for t in range(T):
        for s in range(S):
            if tb["fvalid"][t, s] and t + 1 < T:
                m, v = tb["fm"][t, s], tb["fv"][t, s]
                nxt = (s + 1) % S
                if s < S - 1:
                    assert tb["fvalid"][t + 1, nxt] and \
                        (tb["fm"][t + 1, nxt], tb["fv"][t + 1, nxt]) == (m, v)
                elif v < V - 1:
                    assert tb["fvalid"][t + 1, 0] and \
                        (tb["fm"][t + 1, 0], tb["fv"][t + 1, 0]) == (m, v + 1)
                else:
                    assert not tb["fvalid"][t + 1, 0] \
                        or tb["fv"][t + 1, 0] == 0
            if tb["bvalid"][t, s] and t + 1 < T:
                m, v = tb["bm"][t, s], tb["bv"][t, s]
                prv = (s - 1) % S
                if s > 0:
                    assert tb["bvalid"][t + 1, prv] and \
                        (tb["bm"][t + 1, prv], tb["bv"][t + 1, prv]) == (m, v)
                elif v > 0:
                    assert tb["bvalid"][t + 1, S - 1] and \
                        (tb["bm"][t + 1, S - 1],
                         tb["bv"][t + 1, S - 1]) == (m, v - 1)
                else:
                    assert not tb["bvalid"][t + 1, S - 1] \
                        or tb["bseed"][t + 1, S - 1]

    tB0 = off                                       # first head/backward
    tC0 = int(np.max(np.nonzero(tb["fvalid"].any(axis=1))[0])) + 1
    assert not tb["bvalid"][:tB0].any() and not tb["hvalid"][:tB0].any()
    assert not tb["fvalid"][tC0:].any() and not tb["hvalid"][tC0:].any()
    return tb, tB0, tC0, T, K


def _interleave_layer_perm(L: int, S: int, V: int) -> np.ndarray:
    """Permutation laying the [L] layer axis out so that stage s's
    contiguous L / S slice is its V interleaved chunks in v order (chunk
    q = v S + s holds global layers [q Lc, (q + 1) Lc))."""
    Lc = L // (S * V)
    return np.concatenate([
        np.arange((v * S + s) * Lc, (v * S + s + 1) * Lc)
        for s in range(S) for v in range(V)])


def stage_slots(S: int, V: int, M: int) -> List[int]:
    """Each stage's number of stash slots in the tables (its peak of
    stashed chunk inputs; the tables' K is the largest)."""
    tb = _interleaved_schedule(S, V, M)[0]
    return [int(tb["fslot"][tb["fvalid"][:, s], s].max()) + 1
            for s in range(S)]


class PipelineGrads(NamedTuple):
    loss: torch.Tensor              # fp32 sum of the microbatch totals
    metrics: dict                   # fp32 sums of the head's metrics
    g_chunks: list                  # [V][leaf] fp32 gradient of each chunk
    g_x: Optional[torch.Tensor]     # fp32 [B, ...] gradient of the input
    g_head: list                    # fp32 gradients of the head leaves
    peak_stash: int                 # this stage's peak of stashed inputs


def pipelined_grads_interleaved(run_chunk: Callable, chunk_leaves: list,
                                x: torch.Tensor, head_fn: Callable,
                                head_leaves: Sequence[torch.Tensor], mesh,
                                n_micro: int, n_virtual: int, *,
                                grad_x: bool = True,
                                metric_names: Sequence[str] = ()
                                ) -> PipelineGrads:
    """Interleaved 1F1B: loss and gradients of the pipelined stack, each
    stage hosting ``n_virtual`` chunks of layers.

    ``run_chunk(v, h, m, leaves)`` applies this stage's chunk ``v`` to
    microbatch ``m``'s activations ``h`` reading ``leaves`` (the chunk's
    trainable tensors, ``chunk_leaves[v]``; may be empty: a frozen
    stack). ``head_fn(h, m, leaves) -> (total, metrics)`` is microbatch
    ``m``'s loss at the top of the stack (sum form over global
    denominators, ``losses.sparse_distill_sums``) from the last chunk's
    output and the ``head_leaves`` (final norm, lm head); ``metrics`` maps
    ``metric_names`` to scalars, summed over the microbatches like the
    loss.

    The forward slot runs without gradients and stashes the chunk input;
    the backward slot recomputes the chunk from it (full remat, as JAX)
    and differentiates it with the cotangent from the next stage (or the
    head's, the seed). Returns :class:`PipelineGrads`; ``g_x`` (stage 0's)
    and the loss, metrics and head gradients (the last stage's) are
    broadcast over pp."""
    group, S, s = _stage(mesh)
    V, M = n_virtual, n_micro
    B = x.shape[0]
    if B % M or M < 1:
        raise ValueError(f"batch {B} not divisible by n_micro={M}")
    tb, _, _, n_ticks, _ = _interleaved_schedule(S, V, M)
    xm = x.reshape((M, B // M) + x.shape[1:])
    mshape, dt, dev = xm.shape[1:], x.dtype, x.device

    def needs_f(t, st):
        return (t < n_ticks and tb["fvalid"][t, st]
                and not (st == 0 and tb["fv"][t, st] == 0))

    def needs_b(t, st):
        return t < n_ticks and tb["bvalid"][t, st] and not tb["bseed"][t, st]

    g_chunks = [[torch.zeros_like(l, dtype=torch.float32) for l in lv]
                for lv in chunk_leaves]
    g_head = [torch.zeros_like(l, dtype=torch.float32) for l in head_leaves]
    g_x = torch.zeros(xm.shape, dtype=torch.float32, device=dev) \
        if grad_x else None
    loss = torch.zeros((), dtype=torch.float32, device=dev)
    metrics: dict = {}
    stash: dict = {}
    peak = 0
    fwd_in = bwd_in = None
    for t in range(n_ticks):
        h_out = gh = g_seed = None
        if tb["fvalid"][t, s]:
            m, v = int(tb["fm"][t, s]), int(tb["fv"][t, s])
            h_in = xm[m] if (s == 0 and v == 0) else fwd_in
            stash[int(tb["fslot"][t, s])] = h_in
            peak = max(peak, len(stash))
            with torch.no_grad():
                h_out = run_chunk(v, h_in, m, chunk_leaves[v])
        if s == S - 1 and tb["hvalid"][t]:
            m = int(tb["hm"][t])
            h_req = h_out.detach().requires_grad_(True)
            hl = [l.detach().requires_grad_(True) for l in head_leaves]
            with torch.enable_grad():
                total, mets = head_fn(h_req, m, hl)
            grads = torch.autograd.grad(total, [h_req] + hl)
            g_seed = grads[0]
            for a, g in zip(g_head, grads[1:]):
                a += g.float()
            loss = loss + total.detach().float()
            for k, val in mets.items():
                metrics[k] = metrics.get(k, 0.0) + val.detach().float()
        if tb["bvalid"][t, s]:
            m, v = int(tb["bm"][t, s]), int(tb["bv"][t, s])
            g_in = g_seed if tb["bseed"][t, s] else bwd_in
            h_req = stash.pop(int(tb["bslot"][t, s])).detach() \
                .requires_grad_(True)
            lv = [l.detach().requires_grad_(True) for l in chunk_leaves[v]]
            with torch.enable_grad():
                out = run_chunk(v, h_req, m, lv)
            grads = torch.autograd.grad(out, [h_req] + lv, g_in.to(out.dtype),
                                        allow_unused=True)
            gh = grads[0]
            for a, g in zip(g_chunks[v], grads[1:]):
                if g is not None:
                    a += g.float()
            if grad_x and s == 0 and v == 0:
                g_x[m] = gh.float()
        # the messages a neighbour reads at t + 1
        sends, recvs = [], []
        if needs_f(t + 1, (s + 1) % S):
            sends.append((h_out, (s + 1) % S, TAG_FWD))
        if needs_b(t + 1, (s - 1) % S):
            sends.append((gh.to(dt), (s - 1) % S, TAG_BWD))
        want_f, want_b = needs_f(t + 1, s), needs_b(t + 1, s)
        if want_f:
            recvs.append((mshape, dt, (s - 1) % S, TAG_FWD))
        if want_b:
            recvs.append((mshape, dt, (s + 1) % S, TAG_BWD))
        got = comm.exchange(sends, recvs, group, dev)
        fwd_in = got.pop(0) if want_f else None
        bwd_in = got.pop(0) if want_b else None
    assert not stash, "stash not drained"

    last, first = _last_rank(group, S), _first_rank(group)
    packed = torch.stack([loss] + [metrics.get(k, torch.zeros_like(loss))
                                   for k in metric_names])
    packed = comm.broadcast(packed, group, last)
    loss = packed[0]
    metrics = {k: packed[j + 1] for j, k in enumerate(metric_names)}
    g_head = [comm.broadcast(g, group, last) for g in g_head]
    if grad_x:
        g_x = comm.broadcast(g_x, group, first).reshape(x.shape)
    return PipelineGrads(loss, metrics, g_chunks, g_x, g_head, peak)


def pipelined_grads_1f1b(run_chunk: Callable, chunk_leaves: list,
                         x: torch.Tensor, head_fn: Callable,
                         head_leaves: Sequence[torch.Tensor], mesh,
                         n_micro: int, *,
                         grad_x: bool = True,
                         metric_names: Sequence[str] = ()) -> PipelineGrads:
    """1F1B: :func:`pipelined_grads_interleaved` with one chunk a stage
    (the tables reduce to fwd t = m + s, bwd t = m + 2 (S - 1) - s): the
    stash holds at most min(M, 2 S - 1) microbatch inputs, where GPipe
    holds M."""
    return pipelined_grads_interleaved(run_chunk, chunk_leaves, x, head_fn,
                                       head_leaves, mesh, n_micro, 1,
                                       grad_x=grad_x,
                                       metric_names=metric_names)
