"""Mel-spectrogram front ends in torch (port of
``speech_distill_tpu/audio/mel.py``; no librosa or torchaudio).

Two parameterisations:

* 16 kHz / 128-mel whisper-style log-mel, the S3 tokenizer's input
  (reference ``s3tokenizer.log_mel_spectrogram``, utils.py:88): n_fft
  400, hop 160, periodic hann, centre reflect pad, the last frame
  dropped, log10 clamped at 1e-10, a per-clip floor at max - 8, then
  (x + 4) / 4.
* 24 kHz / 80-mel HiFiGAN-style log-mel, the flow's prompt features
  (soulxpodcast/utils/audio.py:44-77): n_fft 1920, hop 480, fmax 8000,
  ``center=False`` after a manual (n_fft - hop) / 2 reflect pad,
  ln(clamp(x, 1e-5)).

The filterbank is librosa's Slaney bank (``librosa.filters.mel(htk=False,
norm='slaney')``) in numpy; the STFT is framing + ``torch.fft.rfft`` on
the input's device, the mel product in full fp32.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from speech_distill_tpu_torch.core.device import full_fp32
from speech_distill_tpu_torch.native import audio as native


def _hz_to_mel_slaney(f: np.ndarray) -> np.ndarray:
    """Slaney mel: linear below 1 kHz, log above."""
    f = np.asarray(f, np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz)
                    / logstep, f / f_sp)


def _mel_to_hz_slaney(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)),
                    m * f_sp)


@lru_cache(maxsize=8)
def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                   fmax: Optional[float] = None) -> np.ndarray:
    """[n_mels, n_fft//2+1] Slaney-normalised triangular filters
    (== librosa.filters.mel defaults)."""
    fmax = fmax if fmax is not None else sr / 2
    fft_freqs = np.linspace(0, sr / 2, n_fft // 2 + 1)
    mel_pts = np.linspace(_hz_to_mel_slaney(np.array(fmin)),
                          _hz_to_mel_slaney(np.array(fmax)), n_mels + 2)
    hz_pts = _mel_to_hz_slaney(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    # Slaney normalisation: constant energy per channel
    weights *= (2.0 / (hz_pts[2:n_mels + 2] - hz_pts[:n_mels]))[:, None]
    return weights.astype(np.float32)


@lru_cache(maxsize=8)
def _hann(n: int) -> np.ndarray:
    """The periodic hann window (``np.hanning(n + 1)[:-1]``)."""
    return np.hanning(n + 1)[:-1].astype(np.float32)


def _reflect_pad(x: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """numpy's "reflect" pad of the last axis, pads longer than the clip
    included (the reflection repeats with period 2 (T - 1))."""
    T = x.shape[-1]
    idx = torch.arange(-left, T + right, device=x.device)
    if T > 1:
        idx = torch.remainder(idx, 2 * (T - 1))
        idx = torch.where(idx > T - 1, 2 * (T - 1) - idx, idx)
    else:
        idx = torch.zeros_like(idx)
    return x[..., idx]


def stft_mag(x: torch.Tensor, n_fft: int, hop: int, win_length: int,
             window: torch.Tensor, center: bool = True) -> torch.Tensor:
    """Magnitude STFT |X| [..., n_freq, n_frames] (torch.stft's framing)."""
    if center:
        x = _reflect_pad(x, n_fft // 2, n_fft // 2)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        window = F.pad(window, (lpad, n_fft - win_length - lpad))
    if x.shape[-1] < n_fft:                  # no whole frame
        return x.new_zeros(*x.shape[:-1], n_fft // 2 + 1, 0)
    frames = x.unfold(-1, n_fft, hop) * window
    spec = torch.fft.rfft(frames, n=n_fft, dim=-1)
    return spec.abs().transpose(-1, -2)


def _apply_fb(fb: np.ndarray, spec: torch.Tensor) -> torch.Tensor:
    with full_fp32():
        return torch.einsum("mf,...ft->...mt",
                            torch.from_numpy(fb).to(spec.device), spec)


S3_SR = 16000
S3_N_FFT = 400
S3_HOP = 160
S3_N_MELS = 128


def log_mel_spectrogram(audio: torch.Tensor,
                        n_mels: int = S3_N_MELS) -> torch.Tensor:
    """Whisper-style log-mel: [T] or [B, T] -> [..., n_mels, n_frames] on
    the input's device. The dynamic-range floor is taken over each clip's
    own mel and frames."""
    audio = audio.float()
    window = torch.from_numpy(_hann(S3_N_FFT)).to(audio.device)
    mag = stft_mag(audio, S3_N_FFT, S3_HOP, S3_N_FFT, window, center=True)
    power = (mag ** 2)[..., :-1]          # whisper drops the final frame
    mel = _apply_fb(mel_filterbank(S3_SR, S3_N_FFT, n_mels), power)
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    floor = log_spec.amax(dim=(-2, -1), keepdim=True) - 8.0
    return (torch.maximum(log_spec, floor) + 4.0) / 4.0


def mel_spectrogram(y: torch.Tensor, n_fft: int = 1920, num_mels: int = 80,
                    sampling_rate: int = 24000, hop_size: int = 480,
                    win_size: int = 1920, fmin: float = 0,
                    fmax: float = 8000) -> torch.Tensor:
    """[B, T] -> [B, num_mels, n_frames] (reference audio.py:44-77:
    ``center=False`` after a manual reflect pad, sqrt(|X|^2 + 1e-9),
    ln(clamp(mel, 1e-5)))."""
    pad = (n_fft - hop_size) // 2
    y = _reflect_pad(y.float(), pad, pad)
    window = torch.from_numpy(_hann(win_size)).to(y.device)
    mag = stft_mag(y, n_fft, hop_size, win_size, window, center=False)
    spec = torch.sqrt(mag ** 2 + 1e-9)
    mel = _apply_fb(mel_filterbank(sampling_rate, n_fft, num_mels, fmin,
                                   fmax), spec)
    return torch.log(torch.clamp(mel, min=1e-5))


def audio_volume_normalize(audio: np.ndarray,
                           coeff: float = 0.1) -> np.ndarray:
    """Percentile volume normalisation (audio.py:80-123) on the host: the
    native path for 1-D input when the library is available, else
    numpy."""
    audio = np.asarray(audio, np.float32)
    if audio.ndim == 1:
        out = native.volume_normalize(audio, coeff)
        if out is not None:
            return out
    temp = np.sort(np.abs(audio))
    if temp.size == 0:
        return audio
    if temp[-1] < 0.1:
        scaling = max(float(temp[-1]), 1e-3)
        audio = audio / scaling * 0.1
    # the reference filters the magnitudes from before the rescale
    temp = temp[temp > 0.01]
    L = temp.shape[0]
    if L <= 10:
        return audio
    volume = np.mean(temp[int(0.9 * L):int(0.99 * L)])
    audio = audio * np.clip(coeff / volume, 0.1, 10)
    max_value = np.max(np.abs(audio))
    if max_value > 1:
        audio = audio / max_value
    return audio
