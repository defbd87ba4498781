"""ctypes bindings for the native audio kernels (``audio_kernels.cc``).

C++ twins of the numpy code in ``speech_distill_tpu_torch/audio/``: the
polyphase resampler, the percentile volume normalisation and the Kaldi
fbank framing. ``g++`` builds the source at first use into
``speech_distill_tpu_torch/build/`` as ``libsdt_audio-<hash>.so``
(``native/_build.py``); ``SDT_NATIVE=0`` turns it off, and the callers
then take their numpy paths. Nothing builds at import time.
"""
from __future__ import annotations

import ctypes
import os
from pathlib import Path
from typing import Optional

import numpy as np

from speech_distill_tpu_torch.native import _build
from speech_distill_tpu_torch.native._build import BUILD

SRC = Path(__file__).resolve().with_name("audio_kernels.cc")

_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None          # why the library is unavailable

_f32p = ctypes.POINTER(ctypes.c_float)


def lib_path(build_dir=BUILD) -> Path:
    return _build.lib_path(SRC, "libsdt_audio", build_dir)


def load(build_dir=BUILD) -> ctypes.CDLL:
    """Build (if needed) and load the kernels, with their C signatures."""
    lib = ctypes.CDLL(str(_build.build(SRC, "libsdt_audio", build_dir)))
    i64, i32, f32 = ctypes.c_int64, ctypes.c_int32, ctypes.c_float
    for name, args in (
            ("resample_f32", [_f32p, i64, _f32p, i64, i64, i64, i64, _f32p,
                              i64, i32]),
            ("volume_normalize_f32", [_f32p, i64, f32]),
            ("fbank_frames_f32", [_f32p, i64, _f32p, i64, i64, f32, i32,
                                  _f32p, i64])):
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = args
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded kernels, or None when ``SDT_NATIVE=0`` or the build
    failed (:func:`unavailable_reason` says why). Tried once a process."""
    global _lib, _error
    if _lib is None and _error is None:
        if os.environ.get("SDT_NATIVE", "1") == "0":
            _error = "SDT_NATIVE=0"
        else:
            try:
                _lib = load()
            except (OSError, RuntimeError) as e:
                _error = str(e)
    return _lib


def unavailable_reason() -> Optional[str]:
    get_lib()
    return _error


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_f32p)


def _f32(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.float32)


def resample(audio: np.ndarray, kernels: np.ndarray, width: int, orig: int,
             out_len: int) -> Optional[np.ndarray]:
    """1-D ``audio`` through the polyphase ``kernels`` [new, K] (stride
    ``orig``, ``width`` zeros of padding on the left) into ``out_len``
    samples; None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    x, kern = _f32(audio), _f32(kernels)
    if x.ndim != 1 or kern.ndim != 2:
        raise ValueError(f"audio {x.shape} must be 1-D, kernels "
                         f"{kern.shape} 2-D")
    out = np.zeros((out_len,), np.float32)
    lib.resample_f32(_ptr(x), len(x), _ptr(kern), kern.shape[0],
                     kern.shape[1], orig, width, _ptr(out), out_len,
                     os.cpu_count() or 1)
    return out


def volume_normalize(audio: np.ndarray,
                     coeff: float = 0.1) -> Optional[np.ndarray]:
    """Percentile volume normalisation of 1-D ``audio`` (a copy); None
    without the library."""
    lib = get_lib()
    if lib is None:
        return None
    x = _f32(audio).copy()
    if x.ndim != 1:
        raise ValueError(f"audio {x.shape} must be 1-D")
    lib.volume_normalize_f32(_ptr(x), len(x), coeff)
    return x


def fbank_frames(audio: np.ndarray, window: np.ndarray, hop: int,
                 preemph: float = 0.97,
                 remove_dc: bool = True) -> Optional[np.ndarray]:
    """Kaldi frames [n_frames, len(window)] of 1-D ``audio``: DC removal,
    preemphasis and the window; None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    x, w = _f32(audio), _f32(window)
    if x.ndim != 1 or w.ndim != 1:
        raise ValueError(f"audio {x.shape} and window {w.shape} must be "
                         f"1-D")
    win = len(w)
    n_frames = 1 + (len(x) - win) // hop if len(x) >= win else 0
    out = np.zeros((n_frames, win), np.float32)
    if n_frames > 0:
        lib.fbank_frames_f32(_ptr(x), len(x), _ptr(w), win, hop, preemph,
                             int(remove_dc), _ptr(out), n_frames)
    return out
