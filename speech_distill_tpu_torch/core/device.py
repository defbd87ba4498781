"""Device resolution for the port's entry points.

Entry points default to ``device="cuda"`` and raise when CUDA is missing:
the port never carries on silently on the CPU. Tests pass
``device="cpu"`` explicitly.
"""
from __future__ import annotations

import contextlib
import threading

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; the port runs on the GPU unless "
                "the caller passes device='cpu' explicitly")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


_fp32_lock = threading.Lock()
_fp32_depth = 0         # blocks open across all threads
_fp32_saved = None      # the flags as they were when the first one opened


@contextlib.contextmanager
def full_fp32():
    """fp32 products and convolutions in full fp32 inside the block,
    whatever the caller's global TF32 flags. TF32 keeps 10 mantissa bits,
    enough to flip an FSQ code whose projection lies near a rounding edge.

    The flags are process-wide, so the hold is counted across threads:
    the first block to open saves them and turns TF32 off, the last to
    close restores them. A block that closes while another thread's is
    still open leaves TF32 off for it."""
    global _fp32_depth, _fp32_saved
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    with _fp32_lock:
        if _fp32_depth == 0:
            _fp32_saved = matmul.allow_tf32, cudnn.allow_tf32
            matmul.allow_tf32 = cudnn.allow_tf32 = False
        _fp32_depth += 1
    try:
        yield
    finally:
        with _fp32_lock:
            _fp32_depth -= 1
            if _fp32_depth == 0:
                matmul.allow_tf32, cudnn.allow_tf32 = _fp32_saved
