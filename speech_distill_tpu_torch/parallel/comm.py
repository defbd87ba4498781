"""The collectives of the SPMD ranks, and the autograd functions around
them.

JAX inserts these from shardings (GSPMD); the port calls them where GSPMD
would: the tensor-parallel pair of Megatron-LM (``copy_to_tp``: identity
forward, all-reduce backward, before a column-parallel product;
``reduce_from_tp``: all-reduce forward, identity backward, after a
row-parallel one), the vocab gathers of the lm head, and the loss
denominators summed over dp (:func:`dp_denominators`).

Only all_reduce, all_gather and broadcast are used, which NCCL and gloo
both provide, so the CPU tests (gloo) run the code the card runs. gloo
takes CUDA tensors for few collectives, so on a gloo group a CUDA tensor
goes through a host copy (two ranks on one card, where NCCL refuses a
second rank of the same device).

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
# Loss denominators over dp
# ---------------------------------------------------------------------------

_DP_GROUP: Optional[object] = None


@contextlib.contextmanager
def dp_denominators(group):
    """Inside the block, :func:`global_count` sums a loss's counts over
    the dp ``group``: each rank's masked sums then divide by the global
    count, and the sum of the ranks' losses (and gradients) is the loss of
    the global batch, whatever the number of valid tokens each rank
    holds (JAX normalises over the global batch)."""
    global _DP_GROUP
    prev, _DP_GROUP = _DP_GROUP, group
    try:
        yield
    finally:
        _DP_GROUP = prev


def global_count(n: torch.Tensor) -> torch.Tensor:
    """``n`` summed over the active dp group (no gradient: a count)."""
    if _DP_GROUP is None:
        return n
    return all_reduce(n.detach(), _DP_GROUP)
