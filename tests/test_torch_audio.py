"""PyTorch port, the audio front end (``audio/*``, ``native/audio.py``)
against the JAX package on inputs made from a numpy seed: the resampler
(numpy and native paths, 44.1k -> 16k and 24k -> 16k, atol 1e-6), the
whisper log-mel and the 24 kHz mel at lengths on every framing edge, the
volume normalisation and the Kaldi fbank (both paths), the native fbank
frames against numpy, and the inference dataset's ``build_item``. CPU.

Tolerances. Logs (the mels, the fbank) hold atol 1e-5 with rtol 4e-6:
a log of magnitude 5-12 in fp32 carries ~1e-6 of relative rounding from
the sums under it (about 30 ulps), which atol 1e-5 alone does not cover
(measured 1.5e-5 at -5 and 3e-5 at -11). The mels hold that on every
entry whose mel energy is at least 1e-5 of its clip's peak, and atol
5e-5 on the rest: both sides run an fp32 FFT, whose error is absolute
(~1e-7 of the frame's peak), so a mel bin 50-80 dB below the peak
carries a relative error of 1e-4 and more on each side (each side
measured up to 1.7e-5 from a float64 reference in log-mel units
there)."""
import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from scipy.io.wavfile import write as wav_write

from speech_distill_tpu.audio import fbank as jfbank
from speech_distill_tpu.audio import mel as jmel
from speech_distill_tpu.audio import resample as jres
from speech_distill_tpu_torch.audio import fbank as tfbank
from speech_distill_tpu_torch.audio import mel as tmel
from speech_distill_tpu_torch.audio import resample as tres
from speech_distill_tpu_torch.native import audio as native

LOG_ATOL, LOG_RTOL = 1e-5, 4e-6
MEL_FLOOR_ATOL, LEVEL = 5e-5, 1e-5
# JAX's mels, jitted (one compile a shape, several times faster than the
# eager op-by-op call on the CPU)
J_LOG_MEL = jax.jit(jmel.log_mel_spectrogram)
J_MEL = jax.jit(jmel.mel_spectrogram)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lib():
    if native.get_lib() is None:
        pytest.skip(f"no native audio library: "
                    f"{native.unavailable_reason()}")
    return native.get_lib()


def path(use_native, request, monkeypatch):
    """Select the native path (the library must build) or the numpy twin
    (the library reported missing, as with ``SDT_NATIVE=0``)."""
    if use_native:
        request.getfixturevalue("lib")
    else:
        monkeypatch.setattr(native, "get_lib", lambda: None)


def voice(rng, n: int, sr: int) -> np.ndarray:
    """A voiced-speech-like clip: a vibrato harmonic series under a
    syllable envelope, with a little noise."""
    t = np.arange(n) / sr
    f0 = rng.uniform(90, 220) * (1 + 0.1 * np.sin(2 * np.pi * 3 * t))
    phase = 2 * np.pi * np.cumsum(f0) / sr
    x = sum(np.sin(k * phase) / k for k in range(1, 30))
    env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(2, 5) * t) ** 2
    return (0.2 * x * env / np.abs(x).max()
            + 0.003 * rng.normal(size=n)).astype(np.float32)


@pytest.mark.parametrize("sr,new", [(44100, 16000), (24000, 16000)])
@pytest.mark.parametrize("use_native", [True, False])
def test_resample_matches_jax(sr, new, use_native, request, monkeypatch):
    path(use_native, request, monkeypatch)
    a = voice(np.random.default_rng(sr), sr + 37, sr)
    got = tres.resample(a, sr, new)
    ref = jres.resample(a, sr, new)
    assert got.shape == ref.shape == (-(-new * len(a) // sr),)
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def test_resample_batch_matches_rows():
    a = np.random.default_rng(1).normal(size=(2, 4410)).astype(np.float32)
    got = tres.resample(a, 44100, 16000)
    for i in range(2):
        np.testing.assert_allclose(
            got[i], jres.resample(a[i], 44100, 16000), atol=1e-6, rtol=0)


def _mel_close(got, ref, energy):
    """The log tolerance where the mel energy is >= LEVEL of the clip's
    peak, MEL_FLOOR_ATOL everywhere (the module docstring)."""
    assert got.shape == ref.shape
    if not ref.size:
        return
    hi = energy >= LEVEL * energy.max()
    np.testing.assert_allclose(got[hi], ref[hi], atol=LOG_ATOL,
                               rtol=LOG_RTOL)
    np.testing.assert_allclose(got, ref, atol=MEL_FLOOR_ATOL, rtol=0)


# 16 kHz clips: 1 to 4 frames (399-401: the reflect pad longer than the
# clip's own frame), a hop boundary +-1, and longer clips at T % 160 in
# {0, 3, 159}
WHISPER_LENS = [160, 399, 400, 401, 1599, 1600, 1601, 16000 + 3, 32159]


@pytest.mark.parametrize("n", WHISPER_LENS)
def test_log_mel_matches_jax(n):
    a = voice(np.random.default_rng(n), n, 16000)
    got = tmel.log_mel_spectrogram(torch.from_numpy(a)).numpy()
    ref = np.asarray(J_LOG_MEL(jnp.asarray(a)))
    _mel_close(got, ref, 10.0 ** (4 * ref - 4))


def test_log_mel_floor_is_per_clip():
    """A batch of a loud and a quiet clip: each row equals the clip
    alone (the max - 8 floor never spans the batch)."""
    rng = np.random.default_rng(5)
    a = np.stack([voice(rng, 3200, 16000), 1e-3 * voice(rng, 3200, 16000)])
    got = tmel.log_mel_spectrogram(torch.from_numpy(a)).numpy()
    for i in range(2):
        alone = tmel.log_mel_spectrogram(torch.from_numpy(a[i])).numpy()
        np.testing.assert_array_equal(got[i], alone)
        ref = np.asarray(J_LOG_MEL(jnp.asarray(a[i])))
        _mel_close(got[i], ref, 10.0 ** (4 * ref - 4))


# 24 kHz clips: shorter than one window after the pad (no frame), one
# frame, a hop boundary +-1, and several seconds
FLOW_LENS = [400, 480, 481, 959, 960, 961, 24000 * 3 + 1]


@pytest.mark.parametrize("n", FLOW_LENS)
def test_flow_mel_matches_jax(n):
    a = voice(np.random.default_rng(n + 1), n, 24000)[None]
    got = tmel.mel_spectrogram(torch.from_numpy(a)).numpy()
    ref = np.asarray(J_MEL(jnp.asarray(a)))
    _mel_close(got, ref, np.exp(ref))


@pytest.mark.parametrize("scale", [1.0, 0.05, 1e-4])
@pytest.mark.parametrize("use_native", [True, False])
def test_volume_normalize_matches_jax(scale, use_native, request,
                                      monkeypatch):
    path(use_native, request, monkeypatch)
    a = scale * voice(np.random.default_rng(3), 16000, 16000)
    got = tmel.audio_volume_normalize(a)
    np.testing.assert_allclose(got, jmel.audio_volume_normalize(a),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("n", [399, 400, 16000, 16000 * 2 + 77])
@pytest.mark.parametrize("use_native", [True, False])
def test_fbank_matches_jax(n, use_native, request, monkeypatch):
    path(use_native, request, monkeypatch)
    a = voice(np.random.default_rng(n), n, 16000)
    got = tfbank.fbank(a)
    ref = jfbank.fbank(a)
    assert got.shape == ref.shape == (max(0, 1 + (n - 400) // 160), 80)
    np.testing.assert_allclose(got, ref, atol=LOG_ATOL, rtol=LOG_RTOL)


def test_native_fbank_frames_match_numpy(lib, monkeypatch):
    a = voice(np.random.default_rng(11), 8000, 16000)
    args = (400, 160, 0.0, 0.97, True)
    got = tfbank.fbank_frames(a, *args)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    np.testing.assert_allclose(got, tfbank.fbank_frames(a, *args),
                               atol=1e-5, rtol=0)


def write_wav(path, seconds, sr, seed):
    """An int16 prompt wav of a seeded voice-like clip."""
    a = voice(np.random.default_rng(seed), int(sr * seconds), sr)
    wav_write(str(path), sr, (a * 32767).astype(np.int16))


def test_build_item_matches_jax(tmp_path, monkeypatch):
    """Two seeded prompt wavs (44.1 kHz and 24 kHz) through both
    datasets with the same speaker-embedding stand-in: the same token
    ids, and the mels, the fbank-derived embeddings and the lengths
    within the tolerances above (JAX's dataset runs its mels jitted)."""
    from speech_distill_tpu.infer import dataloader as jdl
    from speech_distill_tpu_torch.infer.dataloader import PodcastDataset
    from tests.test_data import make_tokenizer

    monkeypatch.setattr(jdl, "log_mel_spectrogram", J_LOG_MEL)
    monkeypatch.setattr(jdl, "mel_spectrogram", J_MEL)

    write_wav(tmp_path / "a.wav", 0.9, 44100, 1)
    write_wav(tmp_path / "b.wav", 0.7, 24000, 2)
    row = {"key": "u1", "prompt_text": ["hello there", "hi"],
           "prompt_wav": [str(tmp_path / "a.wav"), str(tmp_path / "b.wav")],
           "text": ["how are you", "fine thanks"], "spk": [0, 1]}
    (tmp_path / "d.jsonl").write_text(json.dumps(row) + "\n")

    def spk(feat):                      # a stand-in for CAM++
        return feat.mean(axis=0)[:8]

    tok = make_tokenizer()
    ref = jdl.PodcastDataset(tok, str(tmp_path / "d.jsonl"),
                             spk_emb_fn=spk)[0]
    got = PodcastDataset(tok, str(tmp_path / "d.jsonl"), spk_emb_fn=spk,
                         device="cpu")[0]
    for k in ("prompt_text_tokens", "text_tokens", "spks_list", "mel_len"):
        assert got[k] == ref[k], k
    np.testing.assert_allclose(got["spk_emb"], ref["spk_emb"], atol=1e-5,
                               rtol=0)
    for g, r in zip(got["log_mel"], ref["log_mel"]):
        _mel_close(g, r, 10.0 ** (4 * r - 4))
    for g, r in zip(got["mel"], ref["mel"]):
        _mel_close(g, r, np.exp(r))
