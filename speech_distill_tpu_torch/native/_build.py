"""g++ builds of the port's host-side C++ sources.

Each library is built at first use into ``speech_distill_tpu_torch/build/``
as ``<stem>-<hash>.so``, named by the source and the flags, so an edit
builds anew. Each process compiles to a file of its own and renames it
into place, so processes that build at once never read a half-written
library.
"""
from __future__ import annotations

import hashlib
import os
import subprocess
import threading
from pathlib import Path

BUILD = Path(__file__).resolve().parents[1] / "build"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]


def lib_path(src: Path, stem: str, build_dir=BUILD) -> Path:
    digest = hashlib.sha1(src.read_bytes()
                          + " ".join(CXX_FLAGS).encode()).hexdigest()
    return Path(build_dir) / f"{stem}-{digest[:12]}.so"


def build(src: Path, stem: str, build_dir=BUILD) -> Path:
    """Compile ``src`` into ``build_dir`` unless it is there; returns the
    library's path. Raises with the compiler's output when the build
    fails."""
    out = lib_path(src, stem, build_dir)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}."
                        f"{threading.get_ident()}.tmp")
    try:
        res = subprocess.run(["g++", *CXX_FLAGS, str(src), "-o", str(tmp)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed for {src.name}:\n{res.stderr}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out
