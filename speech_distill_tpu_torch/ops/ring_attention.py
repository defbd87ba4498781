"""Ring attention: exact causal attention with the sequence split over the
mesh's ``sp`` axis (port of ``speech_distill_tpu/ops/ring_attention.py``).

JAX runs the ring inside a ``shard_map`` over global arrays; here each sp
rank holds its own [B, T/sp, ...] shard of q / k / v (the qwen3 forward
gives it only its positions) and the K/V shards travel around the ring
(``comm.ring_rotations``: rank i sends to i + 1, the backward sends the
cotangents from i + 1 to i). Each step attends this rank's queries to the
visiting K/V block and merges the partial softmaxes with the streaming
(flash) recurrence. Logits and the (m, l, acc) carries are fp32; masks
are -1e30, never -inf, as in JAX.

Causality comes from global positions: rank r's contiguous shard holds
positions [r Tc, (r + 1) Tc); a zig-zag shard the chunk pair (r, 2 sp - 1
- r) of C = T / (2 sp) positions each (:func:`zigzag_order`). Blocks that
causality leaves empty never run: a merge with one is an exact no-op in
JAX, so the results are the same. The block attend is plain PyTorch
matmuls (two einsums in plain XLA in JAX, no Pallas kernel) under
activation checkpointing (``jax.checkpoint`` there): the backward
recomputes each block's logits from the K/V it saw, O(T / sp) residuals.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from speech_distill_tpu_torch.parallel import comm

_BIG_NEG = -1e30


def _attend_block_plain(qf, kc, vc, q_pos, k_pos):
    """One (q-chunk x kv-chunk) block: per-row (m, l, o) partials.

    qf [B, Tq, KV, G, Dh]; kc / vc [B, Tk, KV, Dh]; q_pos [Tq, 1] and
    k_pos [1, Tk] global positions. Products of the operands in fp32 (bf16
    products are exact there, as with JAX's fp32-accumulating einsum)."""
    scale = qf.shape[-1] ** -0.5
    logits = torch.einsum("btkgd,bskd->bkgts", qf.float(),
                          kc.float()) * scale
    keep = k_pos <= q_pos
    logits = logits.masked_fill(~keep, _BIG_NEG)
    m = logits.amax(dim=-1, keepdim=True)                  # [B,KV,G,Tq,1]
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgts,bskd->btkgd", p.to(vc.dtype).float(),
                     vc.float())                           # [B,Tq,KV,G,Dh]
    return m, l, o


def _attend_block(qf, kc, vc, q_pos, k_pos):
    if torch.is_grad_enabled() and (qf.requires_grad or kc.requires_grad
                                    or vc.requires_grad):
        return checkpoint(_attend_block_plain, qf, kc, vc, q_pos, k_pos,
                          use_reentrant=False)
    return _attend_block_plain(qf, kc, vc, q_pos, k_pos)


def _to_tq(x):
    """[B, KV, G, T, 1] -> [B, T, KV, G, 1], to scale the accumulator."""
    return x.permute(0, 3, 1, 2, 4)


def _merge(carry, block):
    """The streaming merge of a block's (m, l, o) into the carry."""
    m, l, acc = carry
    m_b, l_b, o_b = block
    new_m = torch.maximum(m, m_b)
    c_old = torch.exp(m - new_m)
    c_new = torch.exp(m_b - new_m)
    return (new_m, l * c_old + l_b * c_new,
            acc * _to_tq(c_old) + o_b * _to_tq(c_new))


def _finish(carry, q):
    _, l, acc = carry
    B, T, H, Dh = q.shape
    return (acc / _to_tq(l)).reshape(B, T, H, Dh).to(q.dtype)


def _sp_size(mesh) -> int:
    return int(mesh.shape.get("sp", 1)) if mesh is not None else 1


def _sp(mesh) -> tuple:
    """(group, size, this rank's index) of the mesh's sp axis."""
    if _sp_size(mesh) == 1:
        return None, 1, 0
    return mesh.group("sp"), mesh.size("sp"), mesh.index("sp")


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh) -> torch.Tensor:
    """Causal GQA attention over the contiguous ring: q [B, Tc, H, Dh],
    k / v [B, Tc, KV, Dh] are this rank's shard (global positions
    [r Tc, (r + 1) Tc) for sp index r); returns its [B, Tc, H, Dh] in
    q.dtype. Heads may be a tp rank's. A mesh without sp (or None) is a
    ring of one: plain causal attention."""
    group, n, i = _sp(mesh)
    B, Tc, H, Dh = q.shape
    KV = k.shape[2]
    qf = q.reshape(B, Tc, KV, H // KV, Dh)
    loc = torch.arange(Tc, device=q.device)
    q_pos = (i * Tc + loc)[:, None]
    rot = comm.ring_rotations((k, v), group)
    carry = _attend_block(qf, *rot[0], q_pos, q_pos.T)     # own block
    for s in range(1, n):
        kc, vc = rot[s]
        src = (i - s) % n                                  # kv owner
        if src < i:          # later blocks are wholly masked: never run
            carry = _merge(carry, _attend_block(
                qf, kc, vc, q_pos, (src * Tc + loc)[None, :]))
    return _finish(carry, q)


def ring_available(mesh, seq_len: int) -> bool:
    """True when the mesh has an sp axis of more than one rank and the
    (global) sequence length divides over it: the condition under which
    the forward routes attention through the ring instead of building a
    [B, 1, T, T] bias."""
    n = _sp_size(mesh)
    return n > 1 and seq_len % n == 0


def zigzag_order(T: int, sp: int) -> np.ndarray:
    """Permutation (length T) mapping zig-zag slot -> global position:
    the sequence splits into 2 sp chunks of C = T / (2 sp), and rank r's
    slots hold the chunk pair (r, 2 sp - 1 - r), balancing causal work
    over the ranks."""
    C = T // (2 * sp)
    idx = np.arange(T, dtype=np.int32).reshape(2 * sp, C)
    return np.concatenate(
        [np.concatenate([idx[r], idx[2 * sp - 1 - r]]) for r in range(sp)])


def zigzag_inverse(T: int, sp: int) -> np.ndarray:
    """Inverse permutation: global position -> zig-zag slot."""
    inv = np.empty(T, np.int32)
    inv[zigzag_order(T, sp)] = np.arange(T, dtype=np.int32)
    return inv


def zigzag_ring_attention(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, mesh) -> torch.Tensor:
    """Causal GQA attention over the zig-zag ring: this rank's [B, 2C,
    ...] shard holds global chunks (r, 2 sp - 1 - r). Step 0 attends the
    two in-chunk diagonals and the late-by-early cross block; each later
    step two full (C x C) blocks: late queries by the visiting early
    keys, and the early-by-early block when the keys come from an earlier
    rank (src < r) or else the late-by-late one. Same contract as
    :func:`ring_attention` otherwise."""
    group, n, i = _sp(mesh)
    B, T2, H, Dh = q.shape
    C = T2 // 2
    KV = k.shape[2]
    qf = q.reshape(B, T2, KV, H // KV, Dh)
    qa, qb = qf[:, :C], qf[:, C:]
    loc = torch.arange(C, device=q.device)
    pos_a = (i * C + loc)[:, None]                     # early chunk
    pos_b = ((2 * n - 1 - i) * C + loc)[:, None]       # late chunk
    rot = comm.ring_rotations((k, v), group)
    kc, vc = rot[0]
    ka, va, kb, vb = kc[:, :C], vc[:, :C], kc[:, C:], vc[:, C:]
    A = _attend_block(qa, ka, va, pos_a, pos_a.T)
    Bh = _merge(_attend_block(qb, kb, vb, pos_b, pos_b.T),
                _attend_block(qb, ka, va, pos_b, pos_a.T))
    for s in range(1, n):
        kc, vc = rot[s]
        src = (i - s) % n
        ka, va, kb, vb = kc[:, :C], vc[:, :C], kc[:, C:], vc[:, C:]
        kpa = (src * C + loc)[None, :]
        kpb = ((2 * n - 1 - src) * C + loc)[None, :]
        Bh = _merge(Bh, _attend_block(qb, ka, va, pos_b, kpa))
        if src < i:
            A = _merge(A, _attend_block(qa, ka, va, pos_a, kpa))
        else:
            Bh = _merge(Bh, _attend_block(qb, kb, vb, pos_b, kpb))
    return torch.cat([_finish(A, q[:, :C]), _finish(Bh, q[:, C:])], dim=1)


def zigzag_available(mesh, seq_len: int) -> bool:
    """True when the mesh has an sp axis of more than one rank and the
    (global) sequence splits into 2 sp chunks."""
    n = _sp_size(mesh)
    return n > 1 and seq_len % (2 * n) == 0


def local_positions(T: int, mesh, zigzag: bool,
                    device: Optional[torch.device] = None) -> torch.Tensor:
    """The global positions (ascending) of this sp rank's shard of a
    length-T sequence: [r Tc, (r + 1) Tc) contiguous, or its zig-zag
    chunk pair."""
    _, n, i = _sp(mesh)
    Tc = T // n
    if zigzag:
        pos = zigzag_order(T, n)[i * Tc:(i + 1) * Tc]
        return torch.as_tensor(pos, dtype=torch.long, device=device)
    return torch.arange(i * Tc, (i + 1) * Tc, device=device)
