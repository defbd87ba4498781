"""PyTorch port, the S3 speech tokenizer (``tokenizer/s3.py``) against the
JAX package on the same weights (``models/convert.s3_params_from_jax``):
codes integer-equal to ``s3.quantize`` at ``s3_tiny`` and at a wider
config (n_state 128, 4 heads) for T = 0..3 (mod 4), a ragged batch
equal to its clips alone, the FSQ rounding edges, the port's
``state_dict()`` read back by JAX's converter, a checkpoint loaded from
``$S3_TOKENIZER_CKPT`` turning 24 kHz audio into JAX's codes through
``S3Tokenizer`` and ``default_speech_tokens_fn``, and the TF32 flags held
off inside ``quantize`` while other threads' calls open and close, then
left as the caller set them. CPU, fp32."""
import dataclasses
import threading

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from speech_distill_tpu.tokenizer import s3 as js3
from speech_distill_tpu_torch.models.convert import s3_params_from_jax
from speech_distill_tpu_torch.tokenizer import s3 as ts3

CONFIGS = {"tiny": js3.s3_tiny(),
           "wide": js3.S3Config(n_mels=16, n_state=128, n_head=4, n_layer=2,
                                max_ctx=64)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_cfg(jcfg) -> ts3.S3Config:
    return ts3.S3Config(**dataclasses.asdict(jcfg))


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    """(JAX params, JAX config, port S3Encoder) on the same weights, with
    nonzero biases and LayerNorm affines so every term counts."""
    jcfg = CONFIGS[request.param]
    params = js3.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(1)
    params = jax.tree.map(
        lambda a: jnp.asarray(np.asarray(a) + rng.normal(
            0, 0.02, a.shape).astype(np.float32)), params)
    model = s3_params_from_jax(jax.tree.map(np.asarray, params),
                               port_cfg(jcfg), "cpu")
    return params, jcfg, model


def jquantize(params, mels, lens, jcfg):
    """JAX's ``quantize``, jitted (one compile a shape, ~7x faster than
    its eager call on the CPU)."""
    key = repr(jcfg)
    if key not in _JITTED:
        _JITTED[key] = jax.jit(lambda p, m, l: js3.quantize(p, m, l, jcfg))
    return _JITTED[key](params, jnp.asarray(mels), jnp.asarray(lens))


_JITTED = {}


def _both(pair, mels, lens):
    params, jcfg, model = pair
    jc, jl = jquantize(params, mels, lens, jcfg)
    tc, tl = ts3.quantize(model, torch.from_numpy(mels),
                          torch.from_numpy(lens))
    return (np.asarray(jc), np.asarray(jl)), (tc.numpy(), tl.numpy())


@pytest.mark.parametrize("T", [48, 49, 50, 51])
def test_codes_equal_jax_every_residue_mod4(pair, T):
    """T' = ceil(ceil(T/2)/2) frames and every code equal; the rows'
    lengths T and T - 1 .. T - 3 cover the length rule's residues too."""
    mels = np.random.default_rng(T).normal(
        size=(4, pair[1].n_mels, T)).astype(np.float32)
    lens = np.array([T, T - 1, T - 2, T - 3], np.int32)
    (jc, jl), (tc, tl) = _both(pair, mels, lens)
    assert tc.shape == jc.shape == (4, -(-(-(-T // 2)) // 2))
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(tc, jc)


def test_ragged_batch_matches_clips_alone(pair):
    """A right-padded batch of lengths 37..64: each row's codes equal JAX's
    batch and the port's clip quantized alone at its own length (JAX's
    alone at one length: each length compiles anew there)."""
    params, jcfg, model = pair
    rng = np.random.default_rng(7)
    lens = np.array([64, 37, 50, 61], np.int32)
    mels = np.zeros((4, jcfg.n_mels, 64), np.float32)
    for i, n in enumerate(lens):
        mels[i, :, :n] = rng.normal(size=(jcfg.n_mels, n))
    (jc, jl), (tc, tl) = _both(pair, mels, lens)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tl, jl)
    for i, n in enumerate(lens):
        alone, al = ts3.quantize(model, torch.from_numpy(mels[i:i + 1]),
                                 torch.tensor([n]))
        assert int(al[0]) == tl[i]
        np.testing.assert_array_equal(alone.numpy()[0], tc[i])
    ja, _ = jquantize(params, mels[1:2, :, :37], np.array([37]), jcfg)
    np.testing.assert_array_equal(np.asarray(ja)[0], tc[1, :tl[1]])


def test_fsq_rounding_edges(pair):
    """Hidden states whose projections land within +-1e-3 of the +-0.5
    rounding thresholds: the same code on both sides (round half to
    even, the tanh * 0.999 clamp)."""
    params, jcfg, model = pair
    w = np.asarray(params["fsq"]["w"]).T.astype(np.float64)   # [8, D]
    b = np.asarray(params["fsq"]["b"]).astype(np.float64)
    rng = np.random.default_rng(3)
    n = 256
    targets = np.arctanh(np.clip(
        (rng.choice([-0.5, 0.5], size=(n, jcfg.fsq_dim))
         + rng.normal(scale=1e-3, size=(n, jcfg.fsq_dim))) / 0.999,
        -0.999999, 0.999999))
    h = np.linalg.lstsq(w, (targets - b).T, rcond=None)[0].T
    h = h.astype(np.float32)[None]
    jc = np.asarray(js3.fsq_encode(params, jnp.asarray(h), jcfg))
    tc = ts3.fsq_encode(model, torch.from_numpy(h)).numpy()
    np.testing.assert_array_equal(tc, jc)


def test_state_dict_round_trips_through_jax(pair):
    """The port's ``state_dict()`` is the checkpoint: JAX's
    ``convert_torch_state`` reads it back to the same codes, and
    ``config_from_state`` recovers the architecture (the quantizer's
    ``_codebook`` prefix too)."""
    params, jcfg, model = pair
    state = model.state_dict()
    back = js3.convert_torch_state(state, jcfg)
    mels = np.random.default_rng(2).normal(
        size=(1, jcfg.n_mels, 40)).astype(np.float32)
    lens = np.array([40], np.int32)
    a, _ = jquantize(back, mels, lens, jcfg)
    b, _ = jquantize(params, mels, lens, jcfg)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    renamed = {k.replace("quantizer.", "quantizer._codebook."): v
               for k, v in state.items()}
    cfg = ts3.config_from_state(renamed)
    assert (cfg.n_mels, cfg.n_state, cfg.n_layer, cfg.fsq_dim) == (
        jcfg.n_mels, jcfg.n_state, jcfg.n_layer, jcfg.fsq_dim)
    reloaded = ts3.from_state_dict(renamed, port_cfg(jcfg), "cpu")
    for k, v in reloaded.state_dict().items():
        assert torch.equal(v, state[k]), k


def test_tokenizer_from_checkpoint_env(tmp_path, monkeypatch):
    """24 kHz audio -> codes: the port's ``S3Tokenizer`` (one clip and a
    batch) and ``default_speech_tokens_fn`` (array dict and wav path)
    over ``$S3_TOKENIZER_CKPT`` equal JAX's tokenizer on the same file (a
    tiny-width checkpoint with the whisper front end's 128 mels)."""
    from scipy.io.wavfile import write as wav_write
    jcfg = dataclasses.replace(js3.s3_tiny(), n_mels=128)
    params = js3.init_params(jax.random.PRNGKey(5), jcfg)
    model = s3_params_from_jax(jax.tree.map(np.asarray, params),
                               port_cfg(jcfg), "cpu")
    path = tmp_path / "speech_tokenizer_v2.pt"
    torch.save(model.state_dict(), path)
    monkeypatch.setenv("S3_TOKENIZER_CKPT", str(path))
    rng = np.random.default_rng(4)
    clips = [(0.3 * rng.normal(size=n)).astype(np.float32)
             for n in (24000, 17000)]
    jtok = js3.load_s3_tokenizer()
    ttok = ts3.load_s3_tokenizer(device="cpu")
    ref = [jtok(c, 24000) for c in clips]
    assert [ttok(c, 24000) for c in clips] == ref
    assert ttok.batch(clips, [24000, 24000]) == jtok.batch(clips,
                                                           [24000, 24000])
    fn = ts3.default_speech_tokens_fn("cpu")
    assert fn({"array": clips[0], "sampling_rate": 24000}) == ref[0]
    wav = tmp_path / "a.wav"
    wav_write(str(wav), 24000, (clips[1] * 32767).astype(np.int16))
    jfn = js3.default_speech_tokens_fn()
    assert fn(str(wav)) == jfn(str(wav))


def test_precision_and_tf32_flags(pair, tf32_on):
    """quantize holds fp32 whatever the global TF32 flags and leaves them
    as set; an unknown precision raises."""
    _, jcfg, model = pair
    mels = torch.zeros(1, jcfg.n_mels, 8)
    ts3.quantize(model, mels, torch.tensor([8]))
    assert all(f.allow_tf32 for f in tf32_on)
    codes, _ = ts3.quantize(model, mels, torch.tensor([8]), "bfloat16")
    assert codes.dtype == torch.int64
    with pytest.raises(ValueError, match="precision"):
        ts3.quantize(model, mels, torch.tensor([8]), "float16")


@pytest.fixture
def tf32_on():
    flags = torch.backends.cuda.matmul, torch.backends.cudnn
    before = [f.allow_tf32 for f in flags]
    for f in flags:
        f.allow_tf32 = True
    yield flags
    for f, v in zip(flags, before):
        f.allow_tf32 = v


def test_full_fp32_holds_across_threads(tf32_on):
    """Thread A opens, B opens, A closes: B still reads TF32 off; once B
    closes the caller's flags are back. A nested block in one thread
    likewise."""
    from speech_distill_tpu_torch.core.device import full_fp32
    seen = []
    a_open, b_open, a_closed = (threading.Event() for _ in range(3))

    def read():
        seen.append([f.allow_tf32 for f in tf32_on])

    def a():
        with full_fp32():
            a_open.set()
            b_open.wait(5)
        a_closed.set()

    def b():
        a_open.wait(5)
        with full_fp32():
            b_open.set()
            a_closed.wait(5)
            read()
            with full_fp32():
                read()
            read()
    threads = [threading.Thread(target=t) for t in (a, b)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    assert seen == [[False, False]] * 3
    assert all(f.allow_tf32 for f in tf32_on)


def test_quantize_from_threads_holds_fp32(pair, tf32_on):
    """Four threads quantize at once, as the stage-1 CLI's workers do:
    every conv of every call runs with TF32 off, each thread's codes equal
    the lone call's, and the flags come back as the caller set them."""
    _, jcfg, model = pair
    rng = np.random.default_rng(7)
    mels = torch.from_numpy(rng.normal(size=(1, jcfg.n_mels, 24))
                            .astype(np.float32))
    lens = torch.tensor([24])
    ref = ts3.quantize(model, mels, lens)[0]
    seen = []
    hook = model.encoder.conv1.register_forward_pre_hook(
        lambda *_: seen.append([f.allow_tf32 for f in tf32_on]))
    out, start = [None] * 4, threading.Barrier(4)

    def work(i):
        start.wait(5)
        for _ in range(3):
            out[i] = ts3.quantize(model, mels, lens)[0]
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        hook.remove()
    assert seen == [[False, False]] * 12
    assert all(torch.equal(o, ref) for o in out)
    assert all(f.allow_tf32 for f in tf32_on)
