"""Kaldi-compatible fbank features on the host (own copy of
``speech_distill_tpu/audio/fbank.py``).

Replaces ``torchaudio.compliance.kaldi.fbank`` in the CAM++ speaker
embedding's front end (reference soulxpodcast/utils/dataloader.py:135-140:
num_mel_bins 80, dither 0, sample_frequency 16000, defaults otherwise):
25 ms povey window / 10 ms shift, snip_edges, DC removal, preemphasis
0.97, HTK mel banks (low 20 Hz, high the Nyquist, the Nyquist bin
excluded), log power-spectrum mel energies floored at the fp32 epsilon.
The framing takes the native C++ path (``native/audio.py``) for an
undithered clip when it builds, else numpy.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

from speech_distill_tpu_torch.native import audio as native

EPSILON = 1.1920928955078125e-07  # torchaudio kaldi epsilon (fp32 eps)


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


@lru_cache(maxsize=4)
def _kaldi_mel_banks(num_bins: int, n_fft: int, sr: int,
                     low_freq: float = 20.0,
                     high_freq: float = 0.0) -> np.ndarray:
    if high_freq <= 0:
        high_freq = sr / 2 + high_freq

    def mel(f):
        return 1127.0 * np.log(1.0 + f / 700.0)

    mel_low = mel(low_freq)
    mel_delta = (mel(high_freq) - mel_low) / (num_bins + 1)
    fft_mels = mel(np.arange(n_fft // 2 + 1) * sr / n_fft)
    banks = np.zeros((num_bins, n_fft // 2 + 1), np.float32)
    for b in range(num_bins):
        left = mel_low + b * mel_delta
        center = mel_low + (b + 1) * mel_delta
        right = mel_low + (b + 2) * mel_delta
        up = (fft_mels - left) / (center - left)
        down = (right - fft_mels) / (right - center)
        banks[b] = np.maximum(0.0, np.minimum(up, down))
    banks[:, -1] = 0.0          # kaldi excludes the Nyquist bin
    return banks


@lru_cache(maxsize=4)
def _povey_window(n: int) -> np.ndarray:
    return (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / (n - 1))) ** 0.85


def fbank_frames(audio: np.ndarray, win: int, hop: int, dither: float,
                 preemphasis: float, remove_dc_offset: bool) -> np.ndarray:
    """[n_frames, win] windowed frames: dither, DC removal, preemphasis,
    the povey window (the native path when there is no dither and the
    library is available)."""
    window = _povey_window(win).astype(np.float32)
    if not dither:
        out = native.fbank_frames(audio, window, hop, preemphasis,
                                  remove_dc_offset)
        if out is not None:
            return out
    n_frames = 1 + (len(audio) - win) // hop if len(audio) >= win else 0
    idx = np.arange(n_frames)[:, None] * hop + np.arange(win)[None, :]
    frames = audio[idx].astype(np.float32)
    if dither:
        frames = frames + dither * np.random.default_rng(0).normal(
            size=frames.shape).astype(np.float32)
    if remove_dc_offset:
        frames = frames - frames.mean(axis=1, keepdims=True)
    if preemphasis:
        pre = np.concatenate([frames[:, :1], frames[:, :-1]], axis=1)
        frames = frames - preemphasis * pre
    return frames * _povey_window(win)


def fbank(audio: np.ndarray, num_mel_bins: int = 80, sr: int = 16000,
          frame_length_ms: float = 25.0, frame_shift_ms: float = 10.0,
          dither: float = 0.0, preemphasis: float = 0.97,
          remove_dc_offset: bool = True) -> np.ndarray:
    """[T] float audio -> [n_frames, num_mel_bins] log-mel (kaldi fbank)."""
    audio = np.asarray(audio, np.float32)
    win = int(sr * frame_length_ms / 1000)
    hop = int(sr * frame_shift_ms / 1000)
    n_fft = _next_pow2(win)
    if len(audio) < win:
        return np.zeros((0, num_mel_bins), np.float32)
    frames = fbank_frames(audio, win, hop, dither, preemphasis,
                          remove_dc_offset)
    power = np.abs(np.fft.rfft(frames, n=n_fft, axis=1)) ** 2
    mel = power @ _kaldi_mel_banks(num_mel_bins, n_fft, sr).T
    return np.log(np.maximum(mel, EPSILON)).astype(np.float32)
