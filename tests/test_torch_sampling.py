"""PyTorch port, sampler: the deterministic processors held against the
JAX package within 1e-6, and the drawn tokens' frequencies held against
the processed distribution (the RNG streams differ, so draws are compared
as distributions)."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from speech_distill_tpu.ops import sampling as js
from speech_distill_tpu_torch.ops import sampling as ts

V = 40


def _logits(B=3, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(0, 2.0, (B, V)).astype(np.float32)


def test_repetition_penalty_and_eos_suppression_match_jax():
    raw = _logits()
    presence = np.random.default_rng(1).random((3, V)) < 0.3
    ngen = np.asarray([0, 5, 9])
    got = ts.apply_repetition_penalty(torch.from_numpy(raw),
                                      torch.from_numpy(presence), 1.25)
    ref = js.apply_repetition_penalty(jnp.asarray(raw),
                                      jnp.asarray(presence), 1.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    got = ts.suppress_eos_before_min(got, (V - 1, 3), torch.from_numpy(ngen),
                                     8)
    ref = js.suppress_eos_before_min(ref, (V - 1, 3), jnp.asarray(ngen), 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    # rows below min_tokens have every EOS suppressed, the last row none
    assert (got[:2, [V - 1, 3]] <= -1e29).all()
    assert (got[2, [V - 1, 3]] > -1e29).all()


def test_eos_past_the_vocabulary_is_skipped_as_in_jax():
    """A stop id past a small vocabulary (the configs' default EOS on a
    test model): JAX drops the out-of-range update; the port skips it."""
    raw = _logits()
    ngen = np.asarray([0, 5, 9])
    got = ts.suppress_eos_before_min(torch.from_numpy(raw), (151675, 3),
                                     torch.from_numpy(ngen), 8)
    ref = js.suppress_eos_before_min(jnp.asarray(raw), (151675, 3),
                                     jnp.asarray(ngen), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("top_k,temperature,top_p",
                         [(10, 0.6, 0.9), (25, 1.0, 0.5), (5, 1.3, 1.0)])
def test_topk_topp_kept_set_matches_jax(top_k, temperature, top_p):
    """The k-space candidates that survive top-p are exactly the tokens
    JAX's full-vocab ``process_logits`` keeps, with the same values."""
    raw = _logits(seed=top_k)
    vals, idx = ts.top_k_top_p(torch.from_numpy(raw), top_k, temperature,
                               top_p)
    ref = np.asarray(js.process_logits(
        jnp.asarray(raw), jnp.zeros((3, V), bool), jnp.zeros((3, 1)),
        temperature=temperature, top_k=top_k, top_p=top_p,
        repetition_penalty=1.0, min_tokens=0, eos_ids=(V - 1,)))
    for b in range(3):
        kept = vals[b] > -1e29
        got_set = set(idx[b][kept].tolist())
        assert got_set == set(np.nonzero(ref[b] > -1e29)[0].tolist())
        for i, v in zip(idx[b][kept].tolist(), vals[b][kept].tolist()):
            assert abs(v - ref[b, i]) <= 1e-6


def _freq_check(draws, probs, n):
    """Empirical frequencies within 5 binomial standard deviations of the
    target (per token; a false alarm is < 1e-5 over the whole vocab)."""
    freq = np.bincount(draws, minlength=V) / n
    sigma = np.sqrt(probs * (1 - probs) / n) + 1e-12
    assert np.all(np.abs(freq - probs) <= 5 * sigma + 1e-9), \
        (freq, probs)


def test_sampled_frequencies_follow_processed_distribution():
    n = 4000
    raw = np.repeat(_logits(B=1, seed=7), n, axis=0)
    presence = np.zeros((n, V), bool)
    presence[:, :5] = True
    kw = dict(temperature=0.7, top_k=12, top_p=0.85, repetition_penalty=1.3,
              min_tokens=0, eos_ids=(V - 1,))
    g = torch.Generator().manual_seed(0)
    toks = ts.sample_token_topk(
        g, torch.from_numpy(raw), torch.from_numpy(presence),
        torch.zeros(n, dtype=torch.long), torch.zeros((n, 4), dtype=torch.long),
        torch.zeros((n, 4), dtype=torch.bool), use_ras=False, win_size=4,
        tau_r=0.2, **kw)
    proc = js.process_logits(jnp.asarray(raw[:1]), jnp.asarray(presence[:1]),
                             jnp.zeros((1, 1)), **kw)
    probs = np.asarray(jax.nn.softmax(proc, axis=-1))[0]
    _freq_check(toks.numpy(), probs, n)


def test_ras_fallback_draws_from_raw_distribution():
    """Every kept candidate sits in the recent window often enough to
    trigger RAS, so every token is redrawn from softmax(raw)."""
    n = 4000
    raw = np.repeat(_logits(B=1, seed=9), n, axis=0)
    top = np.argsort(-raw[0])[:3]
    recent = np.tile(np.repeat(top, 2), (n, 1))        # each top id twice
    g = torch.Generator().manual_seed(1)
    toks = ts.sample_token_topk(
        g, torch.from_numpy(raw), torch.zeros((n, V), dtype=torch.bool),
        torch.zeros(n, dtype=torch.long), torch.from_numpy(recent),
        torch.ones(recent.shape, dtype=torch.bool), temperature=1.0,
        top_k=3, top_p=1.0, repetition_penalty=1.0, min_tokens=0,
        eos_ids=(V - 1,), use_ras=True, win_size=6, tau_r=0.3)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(raw[0])))
    _freq_check(toks.numpy(), probs, n)
