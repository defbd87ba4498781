"""Audio resampling: a windowed-sinc polyphase filter on the host (own
copy of ``speech_distill_tpu/audio/resample.py``).

Replaces ``torchaudio.transforms.Resample`` (reference utils.py:42-45).
The kernel construction matches torchaudio's
``_get_sinc_resample_kernel`` (sinc_interp_hann, lowpass_filter_width 6,
rolloff 0.99), so resampled waveforms, and the speech tokens after them,
agree with the reference pipeline to float precision. 1-D input takes the
native C++ path (``native/audio.py``) when it builds, else numpy; both
use the same taps.
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import Tuple

import numpy as np

from speech_distill_tpu_torch.native import audio as native


@lru_cache(maxsize=16)
def _kernel(orig_freq: int, new_freq: int, lowpass_filter_width: int = 6,
            rolloff: float = 0.99) -> Tuple[np.ndarray, int]:
    """Polyphase kernels [new', K] and the half width, for gcd-reduced
    frequencies; torchaudio's hann-windowed sinc."""
    gcd = math.gcd(orig_freq, new_freq)
    orig = orig_freq // gcd
    new = new_freq // gcd
    base_freq = min(orig, new) * rolloff
    width = math.ceil(lowpass_filter_width * orig / base_freq)
    idx = np.arange(-width, width + orig, dtype=np.float64)[None] / orig
    t = np.arange(0, -new, -1, dtype=np.float64)[:, None] / new + idx
    t = t * base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * np.pi / lowpass_filter_width / 2) ** 2
    scale = base_freq / orig
    kernels = np.where(t == 0, np.float64(1.0),
                       np.sin(t * np.pi) / (t * np.pi + 1e-20))
    kernels = kernels * window * scale
    return kernels.astype(np.float32), width


def resample(audio: np.ndarray, orig_freq: int,
             new_freq: int) -> np.ndarray:
    """Resample [..., T] float audio to ``ceil(new * T / orig)`` samples
    (the native path for 1-D input when the library is available)."""
    audio = np.asarray(audio, np.float32)
    if orig_freq == new_freq:
        return audio
    gcd = math.gcd(orig_freq, new_freq)
    orig = orig_freq // gcd
    kernels, width = _kernel(orig_freq, new_freq)
    length = audio.shape[-1]
    target_len = int(math.ceil(new_freq * length / orig_freq))
    if audio.ndim == 1:
        out = native.resample(audio, kernels, width, orig, target_len)
        if out is not None:
            return out

    shape = audio.shape
    x = np.pad(audio.reshape(-1, length), [(0, 0), (width, width + orig)])
    # a strided conv with stride orig over the kernels [new, K]
    K = kernels.shape[1]
    n_out_frames = (x.shape[-1] - K) // orig + 1
    idx = np.arange(n_out_frames)[:, None] * orig + np.arange(K)[None, :]
    frames = x[:, idx]                                # [B, F, K]
    out = np.einsum("bfk,nk->bnf", frames, kernels)   # [B, new, F]
    out = out.transpose(0, 2, 1).reshape(x.shape[0], -1)[:, :target_len]
    return out.reshape(shape[:-1] + (target_len,))
