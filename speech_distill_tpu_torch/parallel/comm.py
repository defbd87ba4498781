"""The collectives of the SPMD ranks, and the autograd functions around
them.

JAX inserts these from shardings (GSPMD); the port calls them where GSPMD
would: the tensor-parallel pair of Megatron-LM (``copy_to_tp``: identity
forward, all-reduce backward, before a column-parallel product;
``reduce_from_tp``: all-reduce forward, identity backward, after a
row-parallel one), the vocab gathers of the lm head, and the loss
denominators summed over dp (and sp: :func:`dp_denominators`), and the
point-to-point shifts of sequence and pipeline parallelism: the ring
shifts of ring attention with their autograd pair
(:func:`ring_rotations`: the backward shifts the other way, JAX's
transposed ``ppermute``) and the stage-to-stage messages of the pipeline
schedules (:func:`exchange`).

Only all_reduce, all_gather, broadcast and isend / irecv (posted
together through ``batch_isend_irecv``: blocking pairs deadlock on a
ring) are used, which NCCL and gloo both provide, so the CPU tests
(gloo) run the code the card runs. gloo takes CUDA tensors for few
collectives, so on a gloo group a CUDA tensor goes through a host copy
(two ranks on one card, where NCCL refuses a second rank of the same
device).

A ``group`` of None is a one-rank axis: every function is then the
identity.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.distributed as dist


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _wire(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` as it goes on the wire: contiguous, on the host for a gloo
    group, bool as uint8 (gloo has no bool)."""
    t = t.contiguous()
    if _staged(t, group):
        t = t.cpu()
    return t.to(torch.uint8) if t.dtype == torch.bool else t


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place; returns it."""
    if group is None:
        return t
    w = _wire(t, group)
    if w is t:
        dist.all_reduce(t, group=group)
        return t
    dist.all_reduce(w, group=group)
    t.copy_(w.to(t.dtype))
    return t


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group``, a new tensor."""
    if group is None:
        return t
    return all_reduce_(t.detach().clone(), group)


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Each rank's ``t`` concatenated along ``dim`` in rank order."""
    if group is None:
        return t
    w = _wire(t.detach(), group)
    outs = [torch.empty_like(w) for _ in range(dist.get_world_size(group))]
    dist.all_gather(outs, w, group=group)
    return torch.cat(outs, dim).to(device=t.device, dtype=t.dtype)


def broadcast(t: torch.Tensor, group, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``t`` (a global rank) on every rank, a new tensor."""
    if group is None:
        return t
    w = _wire(t.detach().clone(), group)
    dist.broadcast(w, src=src, group=group)
    return w.to(device=t.device, dtype=t.dtype)


def _index(group) -> int:
    return dist.get_rank(group)


def exchange(sends, recvs, group, device=None) -> list:
    """Point-to-point messages within ``group``, all posted together and
    waited for: ``sends`` is a list of (tensor, peer, tag), ``recvs`` of
    (shape, dtype, peer, tag); a peer is an index in the group. Returns
    the received tensors, on ``device`` (default: the first sent
    tensor's). Every rank must post the pairs its peers post."""
    if not sends and not recvs:
        return []
    if device is None:
        device = sends[0][0].device if sends else torch.device("cpu")
    staged = device.type == "cuda" and dist.get_backend(group) == "gloo"
    host = torch.device("cpu") if staged else device
    ops, bufs, keep = [], [], []
    for t, peer, tag in sends:
        w = t.detach().contiguous()
        w = w.cpu() if staged else w
        keep.append(w)
        ops.append(dist.P2POp(dist.isend, w, dist.get_global_rank(
            group, peer), group, tag))
    for shape, dtype, peer, tag in recvs:
        b = torch.empty(shape, dtype=dtype, device=host)
        bufs.append(b)
        ops.append(dist.P2POp(dist.irecv, b, dist.get_global_rank(
            group, peer), group, tag))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [b.to(device) for b in bufs]


def shift(xs, group, step: int = 1) -> list:
    """Each rank i's tensors ``xs`` to rank i + ``step`` of ``group``
    (mod its size); returns what rank i - ``step`` sent, in one message
    (the tensors are flattened into one buffer of their common dtype)."""
    n = dist.get_world_size(group)
    i = _index(group)
    flat = torch.cat([x.detach().reshape(-1) for x in xs])
    (got,) = exchange([(flat, (i + step) % n, 0)],
                      [(flat.shape, flat.dtype, (i - step) % n, 0)],
                      group, flat.device)
    out, at = [], 0
    for x in xs:
        out.append(got[at:at + x.numel()].view_as(x))
        at += x.numel()
    return out


class _RingRotations(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, n, *xs):
        ctx.group, ctx.n, ctx.k = group, n, len(xs)
        outs, cur = list(xs), list(xs)
        for _ in range(1, n):
            cur = shift(cur, group, 1)
            outs += cur
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        k, n = ctx.k, ctx.n
        gs = [torch.zeros_like(g) if g is None else g for g in gs]
        acc = gs[(n - 1) * k:]
        for s in range(n - 1, 0, -1):
            acc = shift(acc, ctx.group, -1)
            acc = [a + g for a, g in zip(acc, gs[(s - 1) * k:s * k])]
        return (None, None, *acc)


def ring_rotations(xs, group) -> list:
    """The n rotations of ``xs`` (tensors of one dtype) around the ring
    ``group`` of n ranks: entry s holds, on rank i, rank (i - s)'s
    tensors (entry 0 its own), after s shifts i -> i + 1. Differentiable:
    the backward shifts the cotangents the other way n - 1 times (the
    transposed ``ppermute`` of JAX's ring), on every rank whichever
    rotations its loss reads, so the ranks' shifts always pair."""
    if group is None:
        return [tuple(xs)]
    import torch.distributed as dist
    n = dist.get_world_size(group)
    flat = _RingRotations.apply(group, n, *xs)
    k = len(xs)
    return [tuple(flat[s * k:(s + 1) * k]) for s in range(n)]


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromTP(torch.autograd.Function):
    """All-gather along ``dim``; the backward keeps this rank's chunk of
    the cotangent (every rank computed the same downstream values)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        i = _index(ctx.group)
        return g.narrow(ctx.dim, i * ctx.n, ctx.n).contiguous(), None, None


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward, all-reduce backward: the replicated input of a
    column-parallel product, whose gradient each rank holds in part."""
    return x if group is None else _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce forward, identity backward: the partial sums of a
    row-parallel product (or a vocab-parallel lookup) made whole."""
    return x if group is None else _ReduceFromTP.apply(x, group)


def gather_from_tp(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """All-gather along ``dim`` with a slicing backward: local vocab
    logits or head rows made whole on every rank."""
    if group is None:
        return x
    return _GatherFromTP.apply(x, group, dim % x.dim())


# ---------------------------------------------------------------------------
# Loss denominators over dp (and sp)
# ---------------------------------------------------------------------------

_DP_GROUPS: tuple = ()


@contextlib.contextmanager
def dp_denominators(*groups):
    """Inside the block, :func:`global_count` sums a loss's counts over
    each of ``groups`` (the dp group, and the sp group when each rank
    holds a piece of the sequence): each rank's masked sums then divide
    by the global count, and the sum of the ranks' losses (and gradients)
    is the loss of the global batch, whatever the number of valid tokens
    each rank holds (JAX normalises over the global batch). None entries
    (one-rank axes) are skipped."""
    global _DP_GROUPS
    prev = _DP_GROUPS
    _DP_GROUPS = tuple(g for g in groups if g is not None)
    try:
        yield
    finally:
        _DP_GROUPS = prev


def global_count(n: torch.Tensor) -> torch.Tensor:
    """``n`` summed over the active groups (no gradient: a count)."""
    n = n.detach()
    for g in _DP_GROUPS:
        n = all_reduce(n, g)
    return n


def all_reduce_over(t: torch.Tensor, *groups) -> torch.Tensor:
    """``t`` summed over each of ``groups`` in turn (None: skipped), a
    new tensor: the sum over their product."""
    for g in groups:
        t = all_reduce(t, g)
    return t
