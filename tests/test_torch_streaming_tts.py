"""PyTorch port, streaming synthesis (``infer/streaming_tts.py``):
``StreamingTokenToWav`` pushed at a fixed cadence against the JAX
synthesizer on the same weights and the same random draws (a draw source
that reproduces JAX's key splits: ``split(rng, 3)`` for the noise buffer
and the vocoder key, then ``split(kh)`` once a vocode job), in the
recompute and the incremental form; the chunk rules; and the port's own
invariants (prefix stability, incremental == recompute).

Tolerances: every wav chunk 2e-4 / rtol 1e-4 against JAX and against the
port's recompute (the JAX tests' bound for the same streams: fp32 through
the flow's solve and HiFT's exp head)."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from speech_distill_tpu.infer import streaming_tts as jst
from speech_distill_tpu.models import flow as jflow
from speech_distill_tpu_torch.infer import streaming_tts as tst
from speech_distill_tpu_torch.models import flow as tflow
from tests.test_streaming_tts import _tiny_flow, _tiny_hift
from tests.test_torch_flow import port_flow
from tests.test_torch_hift import jax_nsf_draws, port_hift

WAV_ATOL, WAV_RTOL = 2e-4, 1e-4


class JaxDraws:
    """JAX's random draws of one utterance as a draw source."""

    def __init__(self, key):
        _, self.kn, self.kh = jax.random.split(key, 3)

    def flow_noise(self, shape):
        return torch.from_numpy(np.array(
            jax.random.normal(self.kn, shape, jnp.float32)))

    def source(self, T, H):
        self.kh, sub = jax.random.split(self.kh)
        return jax_nsf_draws(sub, 1, T, H)


def tiny_models(enc_chunk=4):
    """(JAX flow params, JAX flow cfg, JAX HiFT params, JAX HiFT cfg) and
    the port's (flow, flow cfg, hift, hift cfg) on the same weights."""
    fp, fc = _tiny_flow(enc_chunk=enc_chunk)
    hp, hc = _tiny_hift()
    return (fp, fc, hp, hc), (*port_flow(fp, fc), *port_hift(hp, hc))


@pytest.fixture(scope="module")
def models():
    return tiny_models()


def _utterance(seed, n_gen, n_prompt=3, pml=6):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 50, n_prompt).tolist(),
            rng.normal(size=(pml, 8)).astype(np.float32), pml,
            rng.normal(size=(6,)).astype(np.float32),
            rng.integers(0, 50, n_gen).tolist())


def _push_all(synth, gen):
    """Token-by-token arrival, then the final flush; returns the chunks
    and how many arrived before the flush."""
    chunks = []
    for i in range(1, len(gen) + 1):
        chunks += synth.push(gen[:i])
    n_mid = len(chunks)
    return chunks + synth.push(gen, final=True), n_mid


def _assert_chunks_close(got, ref):
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=WAV_ATOL, rtol=WAV_RTOL)


@pytest.mark.parametrize("incremental", [False, True])
def test_push_cadence_matches_jax(models, incremental):
    """Every chunk of a token-by-token stream equals JAX's, with fp32
    incremental caches on both sides."""
    (fp, fc, hp, hc), (tf, tfc, th, thc) = models
    pt, pmel, pml, spk, gen = _utterance(4, 18)
    key = jax.random.PRNGKey(5)
    kw = dict(token_bucket=8, mel_cache_frames=2, max_tokens=64,
              incremental=incremental, inc_max_frames=128)
    ref, _ = _push_all(jst.StreamingTokenToWav(
        fp, fc, hp, hc, pt, pmel, pml, spk, key,
        inc_kv_dtype=jnp.float32, **kw), gen)
    got, n_mid = _push_all(tst.StreamingTokenToWav(
        tf, tfc, th, thc, pt, pmel, pml, spk, JaxDraws(key),
        inc_kv_dtype=torch.float32, device="cpu", **kw), gen)
    assert n_mid >= 2                    # streamed before the flush
    _assert_chunks_close(got, ref)
    wav = np.concatenate(got)
    assert wav.shape[0] == (2 * (len(pt) + len(gen)) - pml) * thc.upsample_scale


def test_unaligned_prompt_small_first_chunk_matches_jax(models):
    """A prompt that is not chunk-aligned makes the first emitted region
    smaller than the hold window; the pending mel waits for the next
    window (as in JAX), and the chunks equal JAX's."""
    (fp, fc, hp, hc), (tf, tfc, th, thc) = models
    pt, pmel, pml, spk, gen = _utterance(11, 15)
    key = jax.random.PRNGKey(5)
    kw = dict(token_bucket=8, mel_cache_frames=4, max_tokens=64)
    ref, _ = _push_all(jst.StreamingTokenToWav(
        fp, fc, hp, hc, pt, pmel, pml, spk, key, **kw), gen)
    got, n_mid = _push_all(tst.StreamingTokenToWav(
        tf, tfc, th, thc, pt, pmel, pml, spk, JaxDraws(key), device="cpu",
        **kw), gen)
    assert n_mid >= 1
    _assert_chunks_close(got, ref)
    assert np.isfinite(np.concatenate(got)).all()


def test_enc_len_prefix_is_stable(models):
    """The streaming invariant in the port: with chunk-causal masks,
    causal convs, inline lookahead (``enc_len``) and fixed noise, the mel
    of every completed chunk equals the final full call's."""
    _, (tf, tfc, _, _) = models
    rng = np.random.default_rng(0)
    n_total, chunk, la = 19, 4, tfc.pre_lookahead_len
    toks = rng.integers(0, tfc.vocab_size, n_total)
    pmel = torch.from_numpy(rng.normal(size=(1, 6, 8)).astype(np.float32))
    emb = torch.from_numpy(rng.normal(size=(1, 6)).astype(np.float32))
    noise = torch.randn((1, 128, 8), generator=torch.Generator().manual_seed(7))

    def call(n_have, n_enc, W):
        arr = np.zeros((1, W), np.int64)
        arr[0, :n_have] = toks[:n_have]
        mels, _ = tflow.forward_flow(
            tf, torch.from_numpy(arr), torch.tensor([n_have]), pmel,
            torch.tensor([6]), emb, tfc, streaming=True,
            noise=noise[:, :2 * W], enc_len=torch.tensor([n_enc]))
        return mels.numpy()

    full = call(n_total, n_total, 24)
    for m in range(1, (n_total - la) // chunk + 1):
        n_enc = m * chunk
        part = call(n_enc + la, n_enc, -(-(n_enc + la) // 8) * 8)
        np.testing.assert_allclose(part[:, :2 * n_enc], full[:, :2 * n_enc],
                                   atol=WAV_ATOL, rtol=WAV_RTOL)


def test_chunk_boundary_validation(models):
    import dataclasses as dc
    _, (tf, tfc, th, thc) = models
    z = np.zeros((2, 8), np.float32)
    spk = np.zeros(6, np.float32)

    def make(cfg, **kw):
        return tst.StreamingTokenToWav(tf, cfg, th, thc, [1], z, 2, spk, 0,
                                       device="cpu", **kw)
    with pytest.raises(ValueError, match="multiple"):
        make(tfc, chunk_tokens=3)
    with pytest.raises(ValueError, match="mel_cache_frames"):
        make(tfc, mel_cache_frames=0)
    with pytest.raises(ValueError, match="mel_pad_to"):
        make(tfc, mel_pad_to=1)
    # estimator chunk 6, ratio 2: boundaries must complete the mel blocks
    fc6 = dc.replace(tfc, static_chunk_size=6,
                     encoder=dc.replace(tfc.encoder, static_chunk_size=2))
    with pytest.raises(ValueError, match="multiple"):
        make(fc6, chunk_tokens=2)
    assert make(fc6).chunk == 6


def test_fade_in_out_matches_jax():
    win = np.hamming(8).astype(np.float32)
    new = np.random.default_rng(1).normal(size=(1, 10)).astype(np.float32)
    old = np.full((1, 4), 3.0, np.float32)
    got = tst.fade_in_out(new, old, win)
    np.testing.assert_array_equal(got, jst.fade_in_out(new, old, win))
    np.testing.assert_array_equal(got[0, 4:], new[0, 4:])
    assert not np.shares_memory(got, new)


def test_out_of_range_flow_id_raises(models):
    """Ids at or past the flow vocabulary raise on the host (standing
    divergence: JAX's embedding reads NaN rows there and returns NaN
    mel, which this test also pins)."""
    (fp, fc, _, _), (tf, tfc, th, thc) = models
    pt, pmel, pml, spk, gen = _utterance(2, 8)
    synth = tst.StreamingTokenToWav(tf, tfc, th, thc, pt, pmel, pml, spk, 0,
                                    token_bucket=8, device="cpu")
    bad = gen[:5] + [tfc.vocab_size] + gen[5:]
    with pytest.raises(ValueError, match="vocab_size"):
        synth.push(bad)
    with pytest.raises(ValueError, match="vocab_size"):
        tst.StreamingTokenToWav(tf, tfc, th, thc, [tfc.vocab_size], pmel,
                                pml, spk, 0, device="cpu")
    assert synth.push(gen) is not None     # the stream is still usable
    tok = jnp.asarray([[1, fc.vocab_size, 2, 3]])
    mel, _ = jflow.forward_flow(fp, tok, jnp.asarray([4]),
                                jnp.asarray(pmel[None]), jnp.asarray([pml]),
                                jnp.asarray(spk[None]), fc,
                                noise=jnp.zeros((1, 8, 8)))
    assert np.isnan(np.asarray(mel)).any()


def test_incremental_matches_recompute(models):
    """The per-Euler-step cached flow emits the port's recompute chunks
    (fp32 caches; several F buckets, a partial final chunk)."""
    _, (tf, tfc, th, thc) = models
    pt, pmel, pml, spk, gen = _utterance(6, 27)

    def mk(inc):
        return tst.StreamingTokenToWav(
            tf, tfc, th, thc, pt, pmel, pml, spk, 5, token_bucket=8,
            mel_cache_frames=2, max_tokens=64, incremental=inc,
            inc_max_frames=128, inc_kv_dtype=torch.float32, device="cpu")
    ref, _ = _push_all(mk(False), gen)
    got, _ = _push_all(mk(True), gen)
    assert len(ref) >= 3
    _assert_chunks_close(got, ref)


def test_incremental_capacity_error(models):
    _, (tf, tfc, th, thc) = models
    rng = np.random.default_rng(7)
    synth = tst.StreamingTokenToWav(
        tf, tfc, th, thc, [1, 2, 3],
        rng.normal(size=(6, 8)).astype(np.float32), 6,
        rng.normal(size=(6,)).astype(np.float32), 0, token_bucket=8,
        mel_cache_frames=2, max_tokens=64, incremental=True,
        inc_max_frames=16, device="cpu")
    with pytest.raises(ValueError, match="inc_max_frames"):
        synth.push(rng.integers(0, tfc.vocab_size, 24).tolist())


def test_full_waveform_and_closed_stream(models):
    """Every prompt-plus-generated token becomes ratio x upsample samples
    of finite audio; the same seed repeats the stream exactly; a push
    after the flush raises."""
    _, (tf, tfc, th, thc) = models
    pt, pmel, pml, spk, gen = _utterance(4, 18)

    def run(seed):
        synth = tst.StreamingTokenToWav(
            tf, tfc, th, thc, pt, pmel, pml, spk,
            torch.Generator().manual_seed(seed), token_bucket=8,
            mel_cache_frames=2, max_tokens=64, device="cpu")
        return synth, _push_all(synth, gen)[0]
    synth, chunks = run(3)
    wav = np.concatenate(chunks)
    assert wav.shape[0] == (2 * (len(pt) + len(gen)) - pml) * thc.upsample_scale
    assert np.isfinite(wav).all()
    np.testing.assert_array_equal(np.concatenate(run(3)[1]), wav)
    with pytest.raises(RuntimeError):
        synth.push(gen)
