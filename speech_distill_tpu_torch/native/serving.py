"""ctypes bindings for the native serving runtime (``serving_runtime.cc``).

C++ twins of the Python ``PagePool`` / ``PrefixRegistry`` in
``infer/paged.py`` (the vLLM block-manager role). ``g++`` builds the
source at first use into ``speech_distill_tpu_torch/build/`` as
``libsdt_serving-<hash>.so`` (``native/_build.py``). ``SDT_NATIVE=0``
turns the native runtime off. Nothing builds at import time.
"""
from __future__ import annotations

import ctypes
import os
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from speech_distill_tpu_torch.native import _build
from speech_distill_tpu_torch.native._build import BUILD

SRC = Path(__file__).resolve().with_name("serving_runtime.cc")

_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None          # why the library is unavailable

_i32p = ctypes.POINTER(ctypes.c_int32)


def lib_path(build_dir=BUILD) -> Path:
    return _build.lib_path(SRC, "libsdt_serving", build_dir)


def build(build_dir=BUILD) -> Path:
    """Compile the runtime into ``build_dir`` unless it is there; returns
    its path. Raises with the compiler's output when the build fails."""
    return _build.build(SRC, "libsdt_serving", build_dir)


def load(build_dir=BUILD) -> ctypes.CDLL:
    """Build (if needed) and load the runtime, with its C signatures."""
    lib = ctypes.CDLL(str(build(build_dir)))
    i64, i32 = ctypes.c_int64, ctypes.c_int32
    for name, res, args in (
            ("sdt_pool_new", i64, [i32]),
            ("sdt_pool_delete", None, [i64]),
            ("sdt_pool_free_pages", i32, [i64]),
            ("sdt_pool_alloc", i32, [i64, i32, _i32p]),
            ("sdt_pool_share", None, [i64, _i32p, i32]),
            ("sdt_pool_release", None, [i64, _i32p, i32]),
            ("sdt_pool_refcount", i32, [i64, i32]),
            ("sdt_reg_new", i64, []),
            ("sdt_reg_delete", None, [i64]),
            ("sdt_reg_size", i64, [i64]),
            ("sdt_reg_match", i32, [i64, _i32p, i64, i32, i32, _i32p]),
            ("sdt_reg_register", i32, [i64, i64, _i32p, i64, _i32p, i32]),
            ("sdt_reg_evict_one", i32, [i64, i64])):
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded runtime, or None when ``SDT_NATIVE=0`` or the build
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


def available() -> bool:
    return get_lib() is not None


def unavailable_reason() -> Optional[str]:
    get_lib()
    return _error


def _as_i32(seq: Sequence[int]) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(seq, dtype=np.int32))


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_i32p)


def _require_lib() -> ctypes.CDLL:
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"native serving runtime unavailable: {_error}")
    return lib


class NativePagePool:
    """C++ twin of ``infer/paged.PagePool`` (same API)."""

    def __init__(self, num_pages: int):
        self._lib = _require_lib()
        self._h = self._lib.sdt_pool_new(num_pages)

    def __del__(self):
        if getattr(self, "_h", None) is not None:
            self._lib.sdt_pool_delete(self._h)

    @property
    def free_pages(self) -> int:
        return int(self._lib.sdt_pool_free_pages(self._h))

    def alloc(self, n: int) -> Optional[List[int]]:
        out = np.empty(max(n, 1), np.int32)
        ok = self._lib.sdt_pool_alloc(self._h, n, _ptr(out))
        return out[:n].tolist() if ok else None

    def share(self, pages: Sequence[int]) -> None:
        a = _as_i32(pages)
        self._lib.sdt_pool_share(self._h, _ptr(a), len(a))

    def free(self, pages: Sequence[int]) -> None:
        a = _as_i32(pages)
        self._lib.sdt_pool_release(self._h, _ptr(a), len(a))

    def refcount(self, p: int) -> int:
        return int(self._lib.sdt_pool_refcount(self._h, p))


class NativePrefixRegistry:
    """C++ twin of ``infer/paged.PrefixRegistry``: an exact-token prefix
    trie. Same semantics (exact chunk tokens, per-hit LRU refresh; an
    evicted entry leaves its deeper entries unreachable, as the Python
    map's walk stops at the first missing key), but match and register
    walk O(n) tokens where the map hashes O(n^2/ps)."""

    def __init__(self):
        self._lib = _require_lib()
        self._h = self._lib.sdt_reg_new()

    def __del__(self):
        if getattr(self, "_h", None) is not None:
            self._lib.sdt_reg_delete(self._h)

    def __len__(self) -> int:
        return int(self._lib.sdt_reg_size(self._h))

    def match(self, ids: Sequence[int], ps: int,
              max_pages: int) -> List[int]:
        a = _as_i32(ids)
        out = np.empty(max(max_pages, 1), np.int32)
        n = self._lib.sdt_reg_match(self._h, _ptr(a), len(a), ps,
                                    max_pages, _ptr(out))
        return out[:n].tolist()

    def register(self, ids: Sequence[int], stream_pages: Sequence[int],
                 ps: int, pool: NativePagePool) -> None:
        a = _as_i32(ids)
        sp = _as_i32(stream_pages)
        self._lib.sdt_reg_register(self._h, pool._h, _ptr(a), len(a),
                                   _ptr(sp), ps)

    def evict_one(self, pool: NativePagePool) -> bool:
        return bool(self._lib.sdt_reg_evict_one(self._h, pool._h))

    def alloc(self, pool: NativePagePool, n: int) -> Optional[List[int]]:
        """pool.alloc with LRU cache eviction under pressure."""
        while True:
            got = pool.alloc(n)
            if got is not None or not self.evict_one(pool):
                return got
