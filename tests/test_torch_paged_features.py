"""PyTorch port, ``PagedEngine``'s serving features held against the JAX
engine on the same weights (qwen3_tiny, fp32, CPU, greedy unless a test
says otherwise): chunked prefill, the early chunk exit, per-request
sampling, full-vocab sampling, logprobs, the admission policies, TTFT
deadlines with shedding, open-loop arrivals and ``on_chunk``. Tests that
depend on time replace the port module's ``time`` with a fake clock."""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from speech_distill_tpu.core.config import SamplingParams as JaxSP
from speech_distill_tpu.core.config import qwen3_tiny as jax_tiny
from speech_distill_tpu.infer import paged as jpaged
from speech_distill_tpu.infer import speculative
from speech_distill_tpu.models import qwen3 as jq
from speech_distill_tpu_torch.core.config import SamplingParams, qwen3_tiny
from speech_distill_tpu_torch.infer import paged as tpaged
from speech_distill_tpu_torch.models.convert import params_from_jax

V = 48
GREEDY = dict(stop_token_ids=(V - 1,), top_k=1, temperature=1.0,
              use_ras=False, repetition_penalty=1.0)


def _setup(seed=3, max_tokens=6, **sampling):
    jcfg = jax_tiny(V, dtype="float32", remat=False)
    params = jq.init_params(jax.random.PRNGKey(seed), jcfg)
    cfg = qwen3_tiny(V, dtype="float32")
    model = params_from_jax(jax.tree.map(np.asarray, params), cfg, "cpu")
    kw = {**GREEDY, "max_tokens": max_tokens, "min_tokens": max_tokens,
          **sampling}
    return jcfg, params, JaxSP(**kw), cfg, model, SamplingParams(**kw)


def _engines(setup, cache_dtype=None, **kw):
    jcfg, params, jsp, cfg, model, sp = setup
    jeng = jpaged.PagedEngine(
        params, jcfg, jsp, attn_impl="xla",
        cache_dtype=jnp.int8 if cache_dtype == torch.int8 else jnp.float32,
        **kw)
    teng = tpaged.PagedEngine(model, cfg, sp, device="cpu",
                              cache_dtype=cache_dtype, **kw)
    return jeng, teng


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, V - 2, n).tolist() for n in lens]


class FakeClock:
    """Stands in for the port module's ``time``: ``perf_counter`` moves
    1 ms a call, ``sleep`` moves it by the time asked for."""

    def __init__(self):
        self.t = 100.0
        self.slept = 0.0

    def perf_counter(self):
        self.t += 1e-3
        return self.t

    def sleep(self, dt):
        self.slept += dt
        self.t += dt


@pytest.fixture
def clock(monkeypatch):
    fake = FakeClock()
    monkeypatch.setattr(tpaged, "time", fake)
    return fake


def _first_seen():
    seen = []

    def on_tokens(rid, new, done):
        if new and rid not in seen:
            seen.append(rid)
    return seen, on_tokens


# --------------------------------------------------------------------------
# chunked prefill
# --------------------------------------------------------------------------

CHUNKED = {
    # whole-prompt vs 8-token pieces, live slots decode between pieces
    "alone": (13, (7, (29, 4, 33, 7, 18)),
              dict(slots=2, max_len=64, page_size=8, chunk_steps=3)),
    # a repeated long prompt rides pages its first copy's pieces registered
    "prefix_sharing": (15, None,
                       dict(slots=2, max_len=64, page_size=8,
                            chunk_steps=3)),
    # one slot, 5 pages: the queued 25er's pieces are reclaimed when the
    # resident stream must grow and no victim slot exists
    "reclaimed": (17, (9, (9, 25)),
                  dict(slots=1, max_len=40, page_size=8, num_pages=5,
                       chunk_steps=4)),
}


@pytest.mark.parametrize("case", sorted(CHUNKED))
def test_chunked_prefill_matches_jax(case):
    seed, spec, kw = CHUNKED[case]
    setup = _setup(seed=seed, max_tokens=8)
    if spec is None:
        rng = np.random.default_rng(8)
        long = rng.integers(1, V - 2, 27).tolist()
        prompts = [long, rng.integers(1, V - 2, 5).tolist(), list(long),
                   long + rng.integers(1, V - 2, 3).tolist()]
    else:
        prompts = _prompts(*spec)
    jeng, teng = _engines(setup, prefill_chunk=8, **kw)
    got = teng.serve(prompts, max_new=8)
    assert got == jeng.serve(prompts, max_new=8)
    assert teng.n_prefill_chunks == jeng.n_prefill_chunks > 0
    assert teng.prefix_hits == jeng.prefix_hits
    assert teng.preemptions == jeng.preemptions
    # every piece and admission is one model forward
    assert teng.n_prefill_forwards == teng.n_prefill_chunks + teng.n_prefills
    if case == "prefix_sharing":
        assert teng.prefix_hits >= 2
    # chunking changes scheduling only: the whole-prompt engine agrees
    whole = tpaged.PagedEngine(setup[4], setup[3], setup[5], device="cpu",
                               **kw)
    assert whole.serve(prompts, max_new=8) == got


def test_int8_chunked_prefill_under_preemption_matches_jax():
    """An int8 pool with 8-token pieces and a pool small enough to
    preempt, token for token against the JAX int8 engine at the same
    prefill_chunk."""
    setup = _setup(seed=3, max_tokens=10)
    prompts = _prompts(3, (19, 19, 19, 19))
    jeng, teng = _engines(setup, torch.int8, slots=3, max_len=48,
                          page_size=8, num_pages=7, chunk_steps=3,
                          prefill_chunk=8)
    got = teng.serve(prompts, max_new=10)
    assert got == jeng.serve(prompts, max_new=10)
    assert all(len(o) == 10 for o in got)
    # JAX prefills a long prompt whole when it becomes the head during
    # admission; the port always prefills it in pieces
    assert teng.n_prefill_chunks > jeng.n_prefill_chunks > 0
    assert teng.preemptions > 0 and jeng.preemptions > 0


def test_a_long_prompt_behind_the_head_prefills_in_pieces():
    """Two long prompts queued at once: the second becomes the head while
    the first is admitted. The JAX engine then prefills it whole in the
    same pass; the port waits a pass and prefills it in pieces, so every
    prompt's prefill stays within prefill_chunk. Tokens agree."""
    setup = _setup(seed=13, max_tokens=6)
    prompts = _prompts(5, (20, 30))
    jeng, teng = _engines(setup, slots=2, max_len=64, page_size=8,
                          chunk_steps=3, prefill_chunk=8)
    assert teng.serve(prompts, max_new=6) == jeng.serve(prompts, max_new=6)
    # 20 tokens: pieces of 8 and 8 (4 left to admit); 30: 8, 8, 8 (6)
    assert teng.n_prefill_chunks == 2 + 3
    assert jeng.n_prefill_chunks == 2


# --------------------------------------------------------------------------
# early chunk exit
# --------------------------------------------------------------------------

def test_chunk_exit_free_matches_jax():
    """Early exits fire (device steps < chunks x chunk_steps) and add
    chunks; chunk and step counts equal the JAX engine's, tokens equal the
    run-to-boundary engine's, and every step costs one exit test."""
    setup = _setup(max_tokens=8)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(1, V - 2, int(rng.integers(3, 11))).tolist()
               for _ in range(9)]
    caps = [2, 8, 3, 7, 2, 6, 4, 8, 3]
    kw = dict(slots=3, max_len=64, page_size=8, chunk_steps=8)
    jeng, teng = _engines(setup, chunk_exit_free=1, **kw)
    got = teng.serve(prompts, max_new_per_request=caps)
    assert got == jeng.serve(prompts, max_new_per_request=caps)
    assert (teng.n_chunks, teng.n_decode_steps) == \
        (jeng.n_chunks, jeng.n_decode_steps)
    assert teng.n_decode_steps < teng.n_chunks * teng.chunk_steps
    assert teng.n_exit_syncs == teng.n_decode_steps + teng.n_chunks
    base = tpaged.PagedEngine(setup[4], setup[3], setup[5], device="cpu",
                              **kw)
    assert base.serve(prompts, max_new_per_request=caps) == got
    assert teng.n_chunks > base.n_chunks


# --------------------------------------------------------------------------
# per-request and full-vocab sampling
# --------------------------------------------------------------------------

def test_per_request_penalty_and_min_tokens_match_jax():
    """Greedy rows with their own repetition penalty and min_tokens,
    served together through a pool that preempts, against the JAX engine;
    the penalty changes what a row generates."""
    setup = _setup(max_tokens=8)
    prompts = _prompts(3, (9, 9, 9, 9))
    reqs = [{"repetition_penalty": 1.0}, {"repetition_penalty": 8.0}, None,
            {"repetition_penalty": 8.0, "min_tokens": 2}]
    jeng, teng = _engines(setup, slots=3, max_len=48, page_size=8,
                          num_pages=7, chunk_steps=3,
                          per_request_sampling=True)
    got = teng.serve(prompts, max_new=8, sampling_per_request=reqs)
    assert got == jeng.serve(prompts, max_new=8, sampling_per_request=reqs)
    assert teng.preemptions == jeng.preemptions > 0
    assert got[0] != got[1]
    assert teng._state.samp.shape == (3, 4)


def test_full_vocab_sampling_with_one_kept_token_is_greedy():
    """top_k=0 routes to process_logits + ras_sample; a top_p that keeps
    one token makes it greedy: the JAX engine's tokens, the top_k=1
    engine's tokens, and logprob 0 for every token."""
    full = dict(top_k=0, top_p=1e-4, temperature=0.7)
    setup = _setup(seed=5, **full)
    prompts = _prompts(4, (6, 9, 4))
    kw = dict(slots=2, max_len=48, page_size=8, chunk_steps=3)
    jeng, teng = _engines(setup, return_logprobs=True, **kw)
    got = teng.serve(prompts, max_new=6)
    assert got == jeng.serve(prompts, max_new=6)
    greedy = tpaged.PagedEngine(setup[4], setup[3],
                                dataclasses.replace(setup[5], top_k=1),
                                device="cpu", **kw)
    assert greedy.serve(prompts, max_new=6) == got
    for lps in teng.request_logprobs:
        np.testing.assert_allclose(lps, 0.0, atol=1e-6)


# --------------------------------------------------------------------------
# logprobs
# --------------------------------------------------------------------------

def test_greedy_logprobs_are_zero_and_hold_across_preemption():
    setup = _setup(seed=5, max_tokens=8)
    prompts = _prompts(2, (9, 9, 9, 9))
    kw = dict(max_len=48, page_size=8, chunk_steps=4, return_logprobs=True)
    jeng, teng = _engines(setup, slots=3, num_pages=7, **kw)
    got = teng.serve(prompts, max_new=8)
    assert got == jeng.serve(prompts, max_new=8)
    assert teng.preemptions > 0
    free = tpaged.PagedEngine(setup[4], setup[3], setup[5], device="cpu",
                              slots=4, **kw)
    assert free.serve(prompts, max_new=8) == got
    for g, a, b, c in zip(got, teng.request_logprobs,
                          free.request_logprobs, jeng.request_logprobs):
        assert len(a) == len(g) and a == b
        assert a == c == [0.0] * len(g)
    off = tpaged.PagedEngine(setup[4], setup[3], setup[5], device="cpu",
                             slots=2, max_len=48, page_size=8)
    off.serve(prompts[:1], max_new=4)
    assert off.request_logprobs == [None] and off._state.logps is None


def test_served_logprobs_match_the_closed_form_on_jax_logits():
    """Sampled RAS serving: every logprob the port reports equals the
    closed-form emission distribution (``speculative.target_probs``)
    at the emitted token, on JAX's teacher-forced logits of the
    request."""
    win = 6
    samp = dict(top_k=8, top_p=0.9, temperature=0.8, repetition_penalty=1.2,
                use_ras=True, win_size=win, tau_r=0.2)
    jcfg, params, jsp, cfg, model, sp = _setup(seed=6, max_tokens=8,
                                               **{**samp, "min_tokens": 2})
    prompts = _prompts(4, (7, 7, 7))
    eng = tpaged.PagedEngine(model, cfg, sp, slots=2, max_len=64,
                             page_size=8, chunk_steps=3, device="cpu",
                             return_logprobs=True, seed=1)
    outs = eng.serve(prompts, max_new=8)
    checked = 0
    for p, gen, lps in zip(prompts, outs, eng.request_logprobs):
        assert len(lps) == len(gen) > 0
        logits = jq.forward(params, jnp.asarray([p + gen], jnp.int32), jcfg)
        for i, (t, lp) in enumerate(zip(gen, lps)):
            raw = logits[:, len(p) + i - 1].astype(jnp.float32)
            seq = p + gen[:i]
            pos = len(seq) - win + np.arange(win)
            recent = jnp.asarray([[seq[max(j, 0)] for j in pos]], jnp.int32)
            presence = jnp.zeros((1, V), bool).at[
                0, jnp.asarray(gen[:i], jnp.int32)].set(bool(i))
            target = np.asarray(speculative.target_probs(
                raw, presence, jnp.asarray([i]), recent,
                jnp.asarray([(pos >= 0).astype(np.int32)]), jsp,
                tuple(jsp.stop_token_ids), win))[0]
            assert abs(lp - np.log(max(target[t], 1e-38))) < 5e-3, (i, t)
            checked += 1
    assert checked >= 10


def test_on_logprobs_streams_aligned_with_on_tokens():
    """Through preemption: one on_logprobs call per on_tokens call, of the
    same length and done flag, concatenating to request_logprobs (which
    equal JAX's)."""
    setup = _setup(seed=5, max_tokens=8)
    prompts = _prompts(2, (9, 9, 9, 9))
    jeng, teng = _engines(setup, slots=3, max_len=48, page_size=8,
                          num_pages=7, chunk_steps=3, return_logprobs=True)
    tok_ev, lp_ev = [], []
    outs = teng.serve(
        prompts, max_new=8,
        on_tokens=lambda rid, t, d: tok_ev.append((rid, list(t), d)),
        on_logprobs=lambda rid, lp, d: lp_ev.append((rid, list(lp), d)))
    assert outs == jeng.serve(prompts, max_new=8)
    assert teng.preemptions > 0
    for rid in range(len(prompts)):
        toks = [(len(t), d) for r, t, d in tok_ev if r == rid]
        lps = [(lp, d) for r, lp, d in lp_ev if r == rid]
        assert toks == [(len(lp), d) for lp, d in lps]
        assert sum(d for _, d in toks) == 1 and toks[-1][1]
        flat = [x for lp, _ in lps for x in lp]
        assert flat == teng.request_logprobs[rid] == \
            jeng.request_logprobs[rid]
        assert len(flat) == len(outs[rid])


# --------------------------------------------------------------------------
# admission policies
# --------------------------------------------------------------------------

POLICIES = {
    # (policy, max_tokens, prompt lengths, serve kwargs, expected order)
    "shortest_job": (12, (6, 6, 6, 6),
                     {"max_new_per_request": [12, 2, 12, 2]}, None),
    "shortest_prompt": (6, (10, 3, 7, 4), {"max_new": 6}, [1, 3, 2, 0]),
    "deadline": (6, (6, 6, 6, 6),
                 {"max_new": 6,
                  "deadline_per_request": [1000.0, 10.0, 100.0, 50.0]},
                 [1, 3, 2, 0]),
}


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_admission_order_matches_jax(policy):
    """One slot: the policy decides who is seated first; each request's
    tokens are the JAX engine's under the same policy."""
    max_tokens, lens, serve_kw, order = POLICIES[policy]
    setup = _setup(max_tokens=max_tokens)
    prompts = _prompts(2, lens)
    jeng, teng = _engines(setup, slots=1, max_len=64, page_size=8,
                          chunk_steps=2, admission_policy=policy)
    seen, on_tokens = _first_seen()
    jseen, jon_tokens = _first_seen()
    got = teng.serve(prompts, on_tokens=on_tokens, **serve_kw)
    assert got == jeng.serve(prompts, on_tokens=jon_tokens, **serve_kw)
    assert seen == jseen
    if order is None:                     # the two 2-token turns first
        assert set(seen[:2]) == {1, 3}
    else:
        assert seen == order
    assert teng.shed_requests == 0


@pytest.mark.parametrize("policy", ["fifo", "shortest_job",
                                    "shortest_prompt", "deadline"])
def test_admission_queue_matches_jax(policy):
    """A seeded sequence of appends, appendlefts (with requests whose
    budget moved), pops and sheds: the port's queue holds the JAX queue's
    order after every operation."""
    rng = np.random.default_rng(len(policy))
    jq_, tq = jpaged._AdmissionQueue(policy), tpaged._AdmissionQueue(policy)
    popped = []
    for i in range(200):
        op = rng.integers(0, 4)
        if op == 0 or not len(tq):
            r = {"rid": i, "ids": [0] * int(rng.integers(1, 9)),
                 "cap": int(rng.integers(1, 9)), "gen": [],
                 "dl": (float(rng.integers(0, 20))
                        if rng.random() < 0.8 else None)}
            jq_.append(r)
            tq.append(dict(r))
        elif op == 1:
            a, b = jq_.popleft(), tq.popleft()
            assert a["rid"] == b["rid"]
            popped.append((a, b))
        elif op == 2 and popped:
            a, b = popped.pop(int(rng.integers(0, len(popped))))
            if rng.random() < 0.5:
                a["gen"] = b["gen"] = [1] * int(rng.integers(1, 4))
            jq_.appendleft(a)
            tq.appendleft(b)
        elif op == 3:
            t = float(rng.integers(0, 20))
            assert [r["rid"] for r in jq_.shed_expired(t)] == \
                [r["rid"] for r in tq.shed_expired(t)]
        assert [r["rid"] for r in jq_] == [r["rid"] for r in tq]
        assert len(jq_) == len(tq)


# --------------------------------------------------------------------------
# deadlines, shedding, arrivals, on_chunk
# --------------------------------------------------------------------------

def test_deadline_shedding_matches_jax(clock):
    """Two requests with an expired deadline are shed before any prefill:
    empty outputs, shed metrics, their stream closed once; the others run
    as in the JAX engine, and every page returns to the pool."""
    setup = _setup(seed=6)
    prompts = _prompts(3, (6, 6, 6, 6))
    jeng, teng = _engines(setup, slots=2, max_len=64, page_size=8,
                          chunk_steps=2, prefix_sharing=False,
                          return_logprobs=True)
    dls = [None, 1000.0, 0.0, 0.0]
    done = []
    got = teng.serve(prompts, max_new=6, deadline_per_request=dls,
                     on_tokens=lambda rid, new, d: done.append(rid)
                     if d else None)
    assert got == jeng.serve(prompts, max_new=6, deadline_per_request=dls)
    assert got[2] == got[3] == [] and len(got[0]) == len(got[1]) == 6
    assert teng.shed_requests == jeng.shed_requests == 2
    assert teng.request_logprobs[2] == teng.request_logprobs[3] == []
    for rid in (2, 3):
        m = teng.request_metrics[rid]
        assert m["shed"] is True and m["n_gen"] == 0 and m["wait_s"] >= 0
    assert not any(teng.request_metrics[r].get("shed") for r in (0, 1))
    assert sorted(done) == [0, 1, 2, 3]
    assert teng._pool.free_pages == teng.num_pages


def test_shed_mid_prefill_returns_its_pages(clock):
    """A queued request shed halfway through its chunked prefill gives its
    pieces back to the pool; the resident stream keeps JAX's tokens."""
    setup = _setup(seed=8, max_tokens=40)
    short, long_prompt = _prompts(4, (6, 30))
    jeng, teng = _engines(setup, slots=1, max_len=64, page_size=8,
                          num_pages=16, chunk_steps=2, prefill_chunk=8,
                          prefix_sharing=False)
    ref = jeng.serve([short], max_new=40)[0]
    # each scheduler pass costs 50 ms of (fake) downstream time: the
    # request's 0.22 s deadline expires after a few pieces
    got = teng.serve([short, long_prompt], max_new_per_request=[40, 4],
                     deadline_per_request=[None, 0.22],
                     on_chunk=lambda: clock.sleep(0.05))
    assert got == [ref, []]
    assert teng.shed_requests == 1 and teng.request_metrics[1]["shed"]
    assert teng.n_prefill_chunks >= 1
    assert teng._pool.free_pages == teng.num_pages


def test_open_loop_arrivals_seat_early_requests_first(clock):
    """Requests 2 and 3 arrive at once, 0 and 1 after 0.8 s: 2 and 3 are
    seated first, tokens equal JAX's, and TTFT runs from arrival."""
    setup = _setup(seed=9)
    prompts = _prompts(6, (6, 6, 6, 6))
    jeng, teng = _engines(setup, slots=2, max_len=64, page_size=8,
                          chunk_steps=2)
    seen, on_tokens = _first_seen()
    got = teng.serve(prompts, max_new=6,
                     arrival_per_request=[0.8, 0.8, 0.0, 0.0],
                     on_tokens=on_tokens, on_chunk=lambda: clock.sleep(0.05))
    assert got == jeng.serve(prompts, max_new=6)
    assert set(seen[:2]) == {2, 3}
    for rid in (0, 1):
        assert teng.request_metrics[rid]["ttft_s"] < 0.6


def test_idle_scheduler_sleeps_to_the_next_arrival(clock):
    setup = _setup(seed=9)
    prompt = _prompts(6, (6,))
    jeng, teng = _engines(setup, slots=2, max_len=64, page_size=8,
                          chunk_steps=2)
    got = teng.serve(prompt, max_new=6, arrival_per_request=[0.5])
    assert got == jeng.serve(prompt, max_new=6)
    assert 0.49 <= clock.slept <= 0.5
    # 6 tokens in 2-step chunks; no empty chunks before the arrival
    assert teng.n_chunks <= 4


def test_on_chunk_once_a_pass_and_generate_logprobs():
    setup = _setup(seed=4)
    prompts = _prompts(1, (6, 6, 6, 6))
    jeng, teng = _engines(setup, slots=2, max_len=64, page_size=8,
                          chunk_steps=2, return_logprobs=True)
    calls = []
    got = teng.serve(prompts, max_new_per_request=[2, 5, 3, 6],
                     on_chunk=lambda: calls.append(teng.n_chunks))
    assert got == jeng.serve(prompts, max_new_per_request=[2, 5, 3, 6])
    assert calls == list(range(1, teng.n_chunks + 1))
    assert teng.phase_seconds["downstream"] >= 0.0
    out = teng.generate(prompts[1], max_new=5)
    ref = jeng.generate(prompts[1], max_new=5)
    assert out["token_ids"] == ref["token_ids"] == got[1]
    assert out["logprobs"] == ref["logprobs"] == [0.0] * 5
