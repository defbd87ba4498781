"""PyTorch port, sampler with per-row parameters, logprobs and the
full-vocab path, held against the JAX package on the same numpy inputs:
the processors and the k-space kept set (1e-6), the closed-form logprob
evaluated at the token JAX drew (1e-5), ``process_logits`` and the
``ras_sample`` logprob, and seeded draw frequencies against
exp(logprob)."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from speech_distill_tpu.ops import sampling as js
from speech_distill_tpu_torch.ops import sampling as ts

V, B, WIN, EOS = 40, 4, 6, (39, 3)
# per-row parameters, one value a row (temperature, top_p, penalty,
# min_tokens), and scalars
ROWS = dict(temperature=np.asarray([0.6, 1.0, 1.3, 0.9], np.float32),
            top_p=np.asarray([0.9, 1.0, 0.5, 0.75], np.float32),
            repetition_penalty=np.asarray([1.25, 1.0, 1.5, 2.0], np.float32),
            min_tokens=np.asarray([0, 5, 9, 3], np.int32))
SCALARS = dict(temperature=0.7, top_p=0.85, repetition_penalty=1.3,
               min_tokens=4)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    raw = rng.normal(0, 2.0, (B, V)).astype(np.float32)
    presence = rng.random((B, V)) < 0.3
    ngen = np.asarray([0, 5, 9, 2], np.int32)
    recent = rng.integers(0, 8, (B, WIN)).astype(np.int32)
    valid = rng.random((B, WIN)) < 0.85
    return raw, presence, ngen, recent, valid


def _params(per_row):
    """(torch kwargs, jax kwargs) of the sampling parameters."""
    if not per_row:
        return dict(SCALARS), dict(SCALARS)
    return ({k: torch.from_numpy(v) for k, v in ROWS.items()},
            {k: jnp.asarray(v) for k, v in ROWS.items()})


@pytest.mark.parametrize("per_row", [False, True], ids=["scalar", "rows"])
def test_processors_match_jax(per_row):
    raw, presence, ngen, *_ = _inputs()
    tp, jp = _params(per_row)
    got = ts.suppress_eos_before_min(torch.from_numpy(raw), EOS,
                                     torch.from_numpy(ngen),
                                     tp["min_tokens"])
    ref = js.suppress_eos_before_min(jnp.asarray(raw), EOS,
                                     jnp.asarray(ngen), jp["min_tokens"])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    got = ts.apply_repetition_penalty(got, torch.from_numpy(presence),
                                      tp["repetition_penalty"])
    ref = js.apply_repetition_penalty(ref, jnp.asarray(presence),
                                      jp["repetition_penalty"])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    if per_row:       # each row has its own gate: only row 3 (2 < 3)
        assert (got[3, list(EOS)] <= -1e29).all()
        assert (got[:3, list(EOS)] > -1e29).all()


@pytest.mark.parametrize("per_row", [False, True], ids=["scalar", "rows"])
@pytest.mark.parametrize("top_k", [5, 12])
def test_topk_kept_set_and_values_match_jax(per_row, top_k):
    """The k-space candidates that survive top-p are exactly the tokens
    JAX's full-vocab ``process_logits`` keeps, with the same values."""
    raw, presence, ngen, *_ = _inputs(seed=top_k)
    tp, jp = _params(per_row)
    x = ts.apply_repetition_penalty(
        ts.suppress_eos_before_min(torch.from_numpy(raw), EOS,
                                   torch.from_numpy(ngen), tp["min_tokens"]),
        torch.from_numpy(presence), tp["repetition_penalty"])
    vals, idx = ts.top_k_top_p(x, top_k, tp["temperature"], tp["top_p"])
    ref = np.asarray(js.process_logits(
        jnp.asarray(raw), jnp.asarray(presence), jnp.asarray(ngen),
        top_k=top_k, eos_ids=EOS, **jp))
    for b in range(B):
        kept = vals[b] > -1e29
        assert set(idx[b][kept].tolist()) == \
            set(np.nonzero(ref[b] > -1e29)[0].tolist())
        np.testing.assert_allclose(vals[b][kept].numpy(),
                                   ref[b, idx[b][kept].numpy()], atol=1e-6)


@pytest.mark.parametrize("per_row", [False, True], ids=["scalar", "rows"])
@pytest.mark.parametrize("use_ras", [False, True], ids=["plain", "ras"])
def test_topk_logprob_at_jax_token_matches_jax(per_row, use_ras):
    """JAX draws the token and reports its logprob; the port's closed form
    (``topk_logprob``) evaluated at that token agrees within 1e-5."""
    raw, presence, ngen, recent, valid = _inputs(seed=3)
    tp, jp = _params(per_row)
    ras = dict(use_ras=use_ras, win_size=WIN, tau_r=0.3)
    for key in range(4):
        tok, _, ref = js.sample_token_topk(
            jax.random.PRNGKey(key), jnp.asarray(raw), jnp.asarray(presence),
            jnp.asarray(ngen), jnp.asarray(recent), jnp.asarray(valid),
            top_k=10, eos_ids=EOS, return_logprob=True, **jp, **ras)
        x = ts.apply_repetition_penalty(
            ts.suppress_eos_before_min(torch.from_numpy(raw), EOS,
                                       torch.from_numpy(ngen),
                                       tp["min_tokens"]),
            torch.from_numpy(presence), tp["repetition_penalty"])
        vals, idx = ts.top_k_top_p(x, 10, tp["temperature"], tp["top_p"])
        got = ts.topk_logprob(vals, idx, torch.from_numpy(raw),
                              torch.from_numpy(np.array(tok)).long(),
                              torch.from_numpy(recent),
                              torch.from_numpy(valid), **ras)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("per_row", [False, True], ids=["scalar", "rows"])
@pytest.mark.parametrize("top_k", [0, 7])
def test_process_logits_matches_jax(per_row, top_k):
    raw, presence, ngen, *_ = _inputs(seed=5)
    tp, jp = _params(per_row)
    got = ts.process_logits(torch.from_numpy(raw),
                            torch.from_numpy(presence),
                            torch.from_numpy(ngen), top_k=top_k,
                            eos_ids=EOS, **tp)
    ref = js.process_logits(jnp.asarray(raw), jnp.asarray(presence),
                            jnp.asarray(ngen), top_k=top_k, eos_ids=EOS,
                            **jp)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("use_ras", [False, True], ids=["plain", "ras"])
def test_ras_logprob_at_jax_token_matches_jax(use_ras):
    """Full vocab: JAX's ``ras_sample`` draws and reports the logprob; the
    port's ``ras_logprob`` at that token agrees within 1e-5."""
    raw, presence, ngen, recent, valid = _inputs(seed=7)
    processed = np.array(js.process_logits(
        jnp.asarray(raw), jnp.asarray(presence), jnp.asarray(ngen),
        top_k=0, eos_ids=EOS, **SCALARS))
    ras = dict(use_ras=use_ras, win_size=WIN, tau_r=0.3)
    for key in range(4):
        res = js.ras_sample(jax.random.PRNGKey(key), jnp.asarray(raw),
                            jnp.asarray(processed), jnp.asarray(recent),
                            jnp.asarray(valid), return_logprob=True, **ras)
        got = ts.ras_logprob(torch.from_numpy(raw),
                             torch.from_numpy(processed),
                             torch.from_numpy(np.array(res.token)).long(),
                             torch.from_numpy(recent).long(),
                             torch.from_numpy(valid), **ras)
        np.testing.assert_allclose(got.numpy(), np.asarray(res.logprob),
                                   atol=1e-5)


def _check_frequencies(tokens: np.ndarray, logp: np.ndarray) -> None:
    """Empirical frequencies within 5 binomial standard deviations of
    exp(logprob) for every token (a false alarm is < 1e-5 over V)."""
    p = np.exp(logp)
    assert abs(p.sum() - 1.0) < 1e-4
    n = len(tokens)
    freq = np.bincount(tokens, minlength=V) / n
    sigma = np.sqrt(p * (1 - p) / n) + 1e-12
    assert np.all(np.abs(freq - p) <= 5 * sigma + 1e-9), (freq, p)


def _every_token_logprob(fn):
    """The distribution a logprob function of one row gives: its value at
    each vocab id."""
    return np.asarray([fn(torch.tensor([v]))[0] for v in range(V)])


@pytest.mark.parametrize("row", [0, 2])
@pytest.mark.parametrize("use_ras", [False, True], ids=["plain", "ras"])
def test_topk_draws_follow_exp_logprob(row, use_ras):
    """Rows with their own parameters, replicated: the drawn tokens'
    frequencies follow exp(logprob) of the closed form (RAS mixture
    included), and the logprob returned with each draw is the closed
    form's value at that token."""
    n = 4000
    raw, presence, ngen, recent, valid = (np.repeat(a[row:row + 1], n, 0)
                                          for a in _inputs(seed=11))
    recent[:, :3] = np.argsort(-raw[0])[:3]     # top candidates repeat
    valid[:] = True
    params = {k: torch.from_numpy(np.repeat(v[row:row + 1], n))
              for k, v in ROWS.items()}
    t = [torch.from_numpy(a) for a in (raw, presence, ngen, recent, valid)]
    ras = dict(use_ras=use_ras, win_size=WIN, tau_r=0.3)
    g = torch.Generator().manual_seed(row)
    tok, lp = ts.sample_token_topk(g, *t, top_k=12, eos_ids=EOS,
                                   return_logprob=True, **params, **ras)
    x = ts.apply_repetition_penalty(
        ts.suppress_eos_before_min(t[0], EOS, t[2], params["min_tokens"]),
        t[1], params["repetition_penalty"])
    vals, idx = ts.top_k_top_p(x, 12, params["temperature"],
                               params["top_p"])
    dist = _every_token_logprob(
        lambda tk: ts.topk_logprob(vals[:1], idx[:1], t[0][:1], tk,
                                   t[3][:1], t[4][:1], **ras))
    _check_frequencies(tok.numpy(), dist)
    np.testing.assert_allclose(lp.numpy(), dist[tok.numpy()], atol=1e-6)


def test_full_vocab_ras_draws_follow_exp_logprob():
    n = 4000
    raw, presence, ngen, recent, valid = (np.repeat(a[:1], n, 0)
                                          for a in _inputs(seed=13))
    recent[:, :2] = np.argsort(-raw[0])[:2]
    valid[:] = True
    t = [torch.from_numpy(a) for a in (raw, presence, ngen, recent, valid)]
    processed = ts.process_logits(t[0], t[1], t[2], top_k=10, eos_ids=EOS,
                                  **SCALARS)
    ras = dict(use_ras=True, win_size=WIN, tau_r=0.3)
    g = torch.Generator().manual_seed(5)
    tok, used_raw, lp = ts.ras_sample(g, t[0], processed, t[3], t[4],
                                      return_logprob=True, **ras)
    assert used_raw.any() and not used_raw.all()
    dist = _every_token_logprob(
        lambda tk: ts.ras_logprob(t[0][:1], processed[:1], tk, t[3][:1],
                                  t[4][:1], **ras))
    _check_frequencies(tok.numpy(), dist)
    np.testing.assert_allclose(lp.numpy(), dist[tok.numpy()], atol=1e-6)


@pytest.mark.parametrize("p", [0.0, 1e-8])
def test_top_p_at_a_tiny_p_keeps_the_argmax(p):
    """Standing divergence F3 (ROADMAP.md section 3), pinned on both
    sides: on a row whose fp32 cumulative probability at its last sorted
    token rounds to <= 1 - p, the JAX filter's threshold index runs one
    past the row, reads NaN and keeps the whole vocabulary (which rows do
    so depends on each row's rounding); the port clamps the index and
    keeps the argmax on every row, as HF's TopPLogitsWarper keeps at
    least one token."""
    vocab = 159_488
    logits = (np.random.default_rng(0).normal(size=(4, vocab)) * 3).astype(
        np.float32)
    srt = jnp.sort(jnp.asarray(logits), axis=-1)
    cum_last = np.asarray(jnp.cumsum(jax.nn.softmax(srt, axis=-1),
                                     axis=-1)[:, -1])
    overflow = cum_last <= 1.0 - p
    assert overflow.any()                 # the divergence shows here
    kept_j = (np.asarray(js.top_p_filter(jnp.asarray(logits), p))
              > js.NEG_INF).sum(-1)
    got = ts.top_p_filter(torch.from_numpy(logits), p)
    kept_t = (got > ts.NEG_INF).sum(-1).numpy()
    np.testing.assert_array_equal(kept_j, np.where(overflow, vocab, 1))
    np.testing.assert_array_equal(kept_t, [1] * 4)
    np.testing.assert_array_equal(torch.argmax(got, -1).numpy(),
                                  logits.argmax(-1))
