"""PyTorch port, the fused lm-head statistics (K2) and the fused losses
built on them, held against the JAX package on the same numpy inputs: the
plain K2 against ``pallas_lm_loss.lm_head_stats`` in interpret mode
(forward and VJP), ``gathered_logits``, ``fused_sparse_kd_loss`` (both
backends) and ``fused_cross_entropy`` with their gradients. fp32, CPU,
N 40, D 32, V 300 (not a multiple of the tiles)."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from speech_distill_tpu.distill import losses as jlosses
from speech_distill_tpu.ops import fused_lm_loss as jfused
from speech_distill_tpu.ops import pallas_lm_loss as jpallas
from speech_distill_tpu_torch.ops import fused_lm_loss as tfused
from speech_distill_tpu_torch.ops import pallas_lm_loss as tpallas

N, D, V, TEMP = 40, 32, 300, 2.0
# JAX interpret-mode tiles: 16 rows, 128 vocab columns (V is ragged)
BN, BV = 16, 128


def _inputs(seed=0):
    """h, W, and labels with one past V (never hits) and one clamped -100
    (0), as numpy."""
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(N, D)).astype(np.float32)
    w = rng.normal(size=(V, D)).astype(np.float32)
    labels = rng.integers(0, V, N).astype(np.int32)
    labels[:3] = [V + 5, 0, V - 1]
    return h, w, labels


def _jax_stats(h, w, labels):
    return jpallas.lm_head_stats(jnp.asarray(h), jnp.asarray(w),
                                 jnp.asarray(labels), TEMP, BN, BV, True)


@pytest.mark.parametrize("chunk", [64, 128, 8192])
def test_plain_stats_match_interpret(chunk):
    h, w, labels = _inputs()
    ref = _jax_stats(h, w, labels)
    got = tpallas.lm_head_stats_plain(torch.from_numpy(h),
                                      torch.from_numpy(w),
                                      torch.from_numpy(labels), TEMP,
                                      chunk=chunk)
    for name, a, b in zip(("lse1", "lseT", "label"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=0, err_msg=name)
    assert got[2][0].item() == float(np.float32(-1e30))


def test_stats_vjp_matches_interpret():
    """Random nonzero cotangents on all three outputs (a1, aT and b)."""
    h, w, labels = _inputs(seed=1)
    cot = [np.random.default_rng(2).normal(size=N).astype(np.float32) * s
           for s in (1.0, 0.5, 2.0)]

    def jloss(hh, ww):
        out = jpallas.lm_head_stats(hh, ww, jnp.asarray(labels), TEMP, BN,
                                    BV, True)
        return sum(jnp.sum(o * jnp.asarray(c)) for o, c in zip(out, cot))
    jdh, jdw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(h),
                                               jnp.asarray(w))
    ht = torch.from_numpy(h).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    out = tpallas.lm_head_stats(ht, wt, torch.from_numpy(labels), TEMP)
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(out, cot)).backward()
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(jdh), atol=5e-5,
                               rtol=1e-3)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jdw), atol=5e-5,
                               rtol=1e-3)


def test_plain_bwd_is_the_vjp():
    """``lm_head_stats_bwd_plain`` (what the chip compares the kernels with)
    is the op's backward: the same dh and dW as autograd of the plain
    forward's logsumexp algebra."""
    h, w, labels = _inputs(seed=3)
    a1, at, b = (torch.from_numpy(np.random.default_rng(s).normal(
        size=N).astype(np.float32)) for s in (4, 5, 6))
    ht = torch.from_numpy(h).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    z = ht @ wt.t()
    lab = torch.from_numpy(labels).long()
    hit = lab < V
    label_logit = torch.where(hit, z.gather(1, lab.clamp_max(V - 1)[:, None]
                                            )[:, 0], 0.0)
    (torch.logsumexp(z, 1) * a1 + torch.logsumexp(z / TEMP, 1) * at
     + label_logit * b).sum().backward()
    stats = tpallas.lm_head_stats_plain(ht.detach(), wt.detach(), lab, TEMP)
    dh, dw = tpallas.lm_head_stats_bwd_plain(ht.detach(), wt.detach(), lab,
                                             stats[0], stats[1], a1, at, b,
                                             TEMP, chunk=100)
    torch.testing.assert_close(dh, ht.grad, atol=2e-5, rtol=1e-4)
    torch.testing.assert_close(dw, wt.grad, atol=2e-5, rtol=1e-4)


def test_gathered_logits_match_jax():
    h, w, _ = _inputs(seed=7)
    idx = np.random.default_rng(8).integers(0, V, (N, 5)).astype(np.int32)
    ref = jpallas.gathered_logits(jnp.asarray(h), jnp.asarray(w),
                                  jnp.asarray(idx), chunk=16)
    got = tpallas.gathered_logits(torch.from_numpy(h), torch.from_numpy(w),
                                  torch.from_numpy(idx).long(), chunk=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def _loss_inputs(seed, B=2, T=10, Dm=16, Vm=300, K=6):
    """The batch of tests/test_fused_loss.py: -100 labels in one row."""
    rng = np.random.default_rng(seed)
    hidden = rng.normal(size=(B, T, Dm)).astype(np.float32)
    lm_w = rng.normal(size=(Vm, Dm)).astype(np.float32)
    labels = rng.integers(0, Vm, (B, T))
    labels[0, :3] = -100
    logp = (rng.normal(size=(B, T, K)) - 2).astype(np.float32)
    idx = rng.integers(0, Vm, (B, T, K)).astype(np.int32)
    smask = (rng.random((B, T)) > 0.3).astype(np.float32)
    return hidden, lm_w, labels, logp, idx, smask


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "smask"])
def test_fused_sparse_kd_loss_matches_jax(backend, masked):
    """All four outputs against the JAX function (the Pallas backend in
    interpret mode), and the gradients of total in hidden and W against
    the JAX chunked route."""
    hidden, lm_w, labels, logp, idx, smask = _loss_inputs(seed=1)
    sm = smask if masked else None
    jargs = (jnp.asarray(labels), jnp.asarray(logp), jnp.asarray(idx),
             None if sm is None else jnp.asarray(sm))
    ref = jfused.fused_sparse_kd_loss(
        jnp.asarray(hidden), jnp.asarray(lm_w), *jargs, chunk_size=48,
        backend=backend, interpret=True)

    def jtotal(hh, ww):
        return jfused.fused_sparse_kd_loss(hh, ww, *jargs,
                                           chunk_size=48).total
    jdh, jdw = jax.grad(jtotal, argnums=(0, 1))(jnp.asarray(hidden),
                                                jnp.asarray(lm_w))
    ht = torch.from_numpy(hidden).requires_grad_()
    wt = torch.from_numpy(lm_w).requires_grad_()
    out = tfused.fused_sparse_kd_loss(
        ht, wt, torch.from_numpy(labels), torch.from_numpy(logp),
        torch.from_numpy(idx), None if sm is None else torch.from_numpy(sm),
        chunk_size=48, backend=backend)
    for name, a, b in zip(out._fields, out, ref):
        np.testing.assert_allclose(a.item(), float(b), rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    out.total.backward()
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(jdh), atol=1e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jdw), atol=1e-5,
                               rtol=1e-4)


@pytest.mark.parametrize("chunk", [32, 100])
def test_fused_cross_entropy_matches_jax(chunk):
    hidden, lm_w, labels, *_ = _loss_inputs(seed=3)
    jl = jnp.asarray(labels)

    def jce(hh, ww):
        return jfused.fused_cross_entropy(hh, ww, jl, chunk_size=chunk)
    ref, (jdh, jdw) = jax.value_and_grad(jce, argnums=(0, 1))(
        jnp.asarray(hidden), jnp.asarray(lm_w))
    # the materialised reference of the JAX test, for the value
    logits = (jnp.asarray(hidden) @ jnp.asarray(lm_w).T)[:, :-1, :]
    shift = jl[:, 1:]
    mat = jlosses._masked_mean(jlosses._ce_per_pos(logits, shift),
                               (shift != -100).astype(jnp.float32))
    ht = torch.from_numpy(hidden).requires_grad_()
    wt = torch.from_numpy(lm_w).requires_grad_()
    got = tfused.fused_cross_entropy(ht, wt, torch.from_numpy(labels),
                                     chunk_size=chunk)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)
    np.testing.assert_allclose(float(got), float(mat), rtol=1e-5)
    got.backward()
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(jdh), atol=1e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jdw), atol=1e-5,
                               rtol=1e-4)


def test_fused_cross_entropy_pallas_matches_jax():
    """``backend="pallas"`` against the JAX stage-1 step's K2 loss (the
    interpret-mode kernel at temperature 2: masked mean of lse1 minus the
    label logit over the clamped shifted labels), value and gradients."""
    hidden, lm_w, labels, *_ = _loss_inputs(seed=5)
    shift = jnp.asarray(labels)[:, 1:].reshape(-1)
    valid = (shift != -100).astype(jnp.float32)

    def jce(hh, ww):
        h = hh[:, :-1, :].reshape(-1, hh.shape[-1])
        lse1, _, gold = jpallas.lm_head_stats(h, ww, jnp.maximum(shift, 0),
                                              2.0, BN, BV, True)
        return jlosses._masked_mean(lse1 - gold, valid)
    ref, (jdh, jdw) = jax.value_and_grad(jce, argnums=(0, 1))(
        jnp.asarray(hidden), jnp.asarray(lm_w))
    ht = torch.from_numpy(hidden).requires_grad_()
    wt = torch.from_numpy(lm_w).requires_grad_()
    got = tfused.fused_cross_entropy(ht, wt, torch.from_numpy(labels),
                                     backend="pallas")
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)
    got.backward()
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(jdh), atol=1e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jdw), atol=1e-5,
                               rtol=1e-4)


def test_checkpointed_chunks_change_nothing():
    """``chunked_stats`` with each chunk checkpointed (the xla route) gives
    the plain version's values and gradients; without labels it skips the
    label logit."""
    h, w, labels = _inputs(seed=9)
    cot = [torch.from_numpy(np.random.default_rng(s).normal(size=N)
                            .astype(np.float32)) for s in (10, 11)]
    grads = []
    for ckpt, lab in ((False, torch.from_numpy(labels)), (True, None)):
        ht = torch.from_numpy(h).requires_grad_()
        wt = torch.from_numpy(w).requires_grad_()
        lse1, lse_t, gold = tpallas.chunked_stats(ht, wt, lab, TEMP, chunk=64,
                                                  checkpointed=ckpt)
        (lse1 * cot[0] + lse_t * cot[1]).sum().backward()
        grads.append((lse1.detach(), lse_t.detach(), ht.grad, wt.grad))
    assert bool((gold == float(np.float32(-1e30))).all())    # no labels
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


BWD_SCRATCH_BUDGET = int(0.6 * 2**30)     # the scratch a call may take


@pytest.mark.parametrize("n,v,d,want_chunk", [
    (16380, 159488, 1024, 8192),     # a stage-1 microbatch
    (4088, 159488, 1024, 8192),      # a fused-KD microbatch
    (300, 1000, 128, 1024),          # one chunk, rounded up to the tile
    (70, 300, 64, 512)])
def test_bwd_plan_covers_the_vocab_within_its_budget(n, v, d, want_chunk):
    """The K2 backward walks [0, V) in chunks of ``chunk`` columns, a
    multiple of the 256-column tile, so that the last chunk rounded up to
    the tile (its columns past V are zero) still fits the dl^T scratch;
    each call's scratch stays under 0.6 GiB."""
    plan = tpallas._bwd_plan(n, v, d)
    assert plan.chunk == want_chunk
    assert plan.chunk % tpallas.TILE_V == 0
    n_chunks = -(-v // plan.chunk)
    last = v - (n_chunks - 1) * plan.chunk
    assert 0 < last <= plan.chunk
    assert -(-last // tpallas.TILE_V) * tpallas.TILE_V <= plan.chunk
    assert plan.ld % tpallas.TILE_ROWS == 0 and n <= plan.ld < n + 128
    part = n * d * 4 if n_chunks > 1 else 0
    assert plan.dh_bytes == plan.chunk * plan.ld * 2 + part
    assert plan.dw_bytes == plan.chunk * plan.ld * 2
    assert max(plan.dh_bytes, plan.dw_bytes) <= BWD_SCRATCH_BUDGET


def test_bwd_plan_follows_a_lowered_chunk(monkeypatch):
    """A lowered BWD_CHUNK gives that chunk and, past one chunk, dh's fp32
    partial [N, D]; a vocab within one chunk takes no partial."""
    monkeypatch.setattr(tpallas, "BWD_CHUNK", 256)
    plan = tpallas._bwd_plan(300, 1000, 128)
    assert (plan.chunk, plan.ld) == (256, 384)
    assert plan.dh_bytes - plan.dw_bytes == 300 * 128 * 4
    plan = tpallas._bwd_plan(300, 256, 128)
    assert plan.chunk == 256 and plan.dh_bytes == plan.dw_bytes


def test_unknown_backend_raises():
    hidden, lm_w, labels, logp, idx, _ = _loss_inputs(seed=4)
    with pytest.raises(ValueError, match="backend"):
        tfused.fused_sparse_kd_loss(
            torch.from_numpy(hidden), torch.from_numpy(lm_w),
            torch.from_numpy(labels), torch.from_numpy(logp),
            torch.from_numpy(idx), backend="ring")
    with pytest.raises(ValueError, match="backend"):
        tfused.fused_cross_entropy(
            torch.from_numpy(hidden), torch.from_numpy(lm_w),
            torch.from_numpy(labels), backend="ring")


@pytest.mark.parametrize("sms", [132, 7])
@pytest.mark.parametrize("n,v", [
    (16380, 159488),     # a stage-1 microbatch
    (4088, 159488),      # a fused-KD microbatch
    (300, 1000),         # N and V ragged against the 128 x 256 tiles
    (129, 4099),
    (70, 300),
    (1, 257)])
def test_stats_plan_covers_every_tile_once(n, v, sms):
    """K2-stats' persistent grid, walked as the kernel walks it (block b
    takes units b, b + grid, ...; unit u = split * row_tiles + row tile,
    the split's vocab tiles in order): every (row tile, vocab tile) pair
    once (so the [splits, 5, N] partials are each written once), no empty
    split, the busiest block as planned and within 1% of a perfect spread
    (or, on a grid smaller than the card, one split's tiles)."""
    plan = tpallas._stats_plan(n, v, sms)
    n_rt, n_vt = -(-n // tpallas.TILE_ROWS), -(-v // tpallas.TILE_V)
    assert (plan.row_tiles, plan.vocab_tiles) == (n_rt, n_vt)
    assert 1 <= plan.splits <= min(tpallas.STATS_MAX_SPLITS, n_vt)
    assert plan.per == -(-n_vt // plan.splits)
    assert (plan.splits - 1) * plan.per < n_vt          # no empty split
    units = n_rt * plan.splits
    assert plan.grid == min(units, sms)
    seen = {}
    load = [0] * plan.grid
    for u in range(units):
        rt, split = u % n_rt, u // n_rt
        tiles = range(split * plan.per, min(n_vt, (split + 1) * plan.per))
        assert len(tiles) > 0
        for vt in tiles:
            seen[rt, vt] = seen.get((rt, vt), 0) + 1
        load[u % plan.grid] += len(tiles)
    assert seen == {(rt, vt): 1 for rt in range(n_rt) for vt in range(n_vt)}
    assert max(load) == plan.makespan
    # within 1% (and a tile) of a perfect spread of the tiles over the SMs
    assert plan.makespan <= 1.01 * n_rt * n_vt / sms + 1 or \
        plan.grid < sms and plan.makespan == plan.per


@pytest.mark.parametrize("v,bv", [(600, 256), (257, 128)])
def test_plain_stats_match_interpret_ragged_vocab(v, bv):
    """V ragged against the kernel's 256-column tiles (600 = 2 x 256 + 88;
    257 = 256 + 1, one column in the last tile) with labels at V - 1 and
    past V, against the JAX kernel in interpret mode."""
    rng = np.random.default_rng(v)
    h = rng.normal(size=(N, D)).astype(np.float32)
    w = rng.normal(size=(v, D)).astype(np.float32)
    labels = rng.integers(0, v, N).astype(np.int32)
    labels[:3] = [v - 1, v, v + 300]
    ref = jpallas.lm_head_stats(jnp.asarray(h), jnp.asarray(w),
                                jnp.asarray(labels), TEMP, BN, bv, True)
    got = tpallas.lm_head_stats_plain(torch.from_numpy(h),
                                      torch.from_numpy(w),
                                      torch.from_numpy(labels), TEMP,
                                      chunk=256)
    for name, a, b in zip(("lse1", "lseT", "label"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=0, err_msg=name)
    assert abs(got[2][0].item() - float(h[0] @ w[v - 1])) < 1e-4
    assert got[2][1].item() == got[2][2].item() == float(np.float32(-1e30))
