"""Host-side batch prefetching: overlap collation and the host-to-device
copy with device compute (own copy of ``speech_distill_tpu/core/
prefetch.py``).

A background thread produces collated host batches and applies ``put``
(by default nothing; :func:`put` copies a numpy batch to a device) while
the current step runs. The bounded queue bounds host memory. The wait for
a batch is the ``data.wait`` span (``core/metrics.span``).
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from speech_distill_tpu_torch.core.metrics import span

_SENTINEL = object()


def put(batch: Dict[str, np.ndarray], device: torch.device
        ) -> Dict[str, torch.Tensor]:
    """A numpy batch as tensors on ``device`` (a host-to-device copy)."""
    return {k: torch.as_tensor(v).to(device, non_blocking=True)
            for k, v in batch.items()}


class Prefetcher:
    """Wrap a host batch iterator; optionally apply ``put`` in the
    background thread so transfers start early."""

    def __init__(self, it: Iterator, put: Optional[Callable] = None,
                 depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._put = put
        self._err: Optional[BaseException] = None

        def worker():
            try:
                for item in it:
                    self._q.put(self._put(item) if self._put else item)
            except BaseException as e:  # surfaced on next __next__
                self._err = e
            finally:
                self._q.put(_SENTINEL)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        with span("data.wait"):
            item = self._q.get()
        if item is _SENTINEL:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


def prefetch(it: Iterator, put: Optional[Callable] = None,
             depth: int = 2) -> Iterator:
    return Prefetcher(it, put, depth)
