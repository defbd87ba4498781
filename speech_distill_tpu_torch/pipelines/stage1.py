"""Stage-1 warm-up: align text with the new speech tokens (port of the
library parts of ``speech_distill_tpu/pipelines/stage1.py``).

Only the new speech-token rows of the embedding train
(``distill/train_step.make_stage1_step``); examples are packed into
fixed-length rows (TRL ``packing=True``) for static shapes. The CLI
``train_stage1`` needs a tokenizer, a pretrained checkpoint and an HF
dataset on disk, and is not ported yet; the pieces it runs are plain
functions here, with the CLI's semantics:

* :func:`pack_sequences`, the packing;
* :func:`stage1_batches`, the CLI's batch iterator ([A, B, T] batches of
  packed rows in a seeded order per epoch, labels equal to the ids);
* :func:`make_eval_fn`, the CLI's eval aggregator (exact per-token mean
  over every eval row, scored once);
* :func:`fused_route`, the CLI's choice of the fused CE.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterator, List, Tuple

import numpy as np
import torch

from speech_distill_tpu_torch.distill.losses import IGNORE_INDEX
from speech_distill_tpu_torch.ops.pallas_lm_loss import KERNEL_DIMS

FUSED_MIN_SEQ = 2048        # the CLI's threshold for the fused CE


def pack_sequences(id_lists: List[List[int]], seq_len: int,
                   eos_id: int) -> np.ndarray:
    """Concatenate the examples, each followed by ``eos_id``, and cut the
    stream into int32 rows [n, seq_len]; the tail shorter than a row is
    dropped (an empty [0, seq_len] array when nothing fills a row)."""
    flat: List[int] = []
    for ids in id_lists:
        flat.extend(ids)
        flat.append(eos_id)
    n = len(flat) // seq_len
    if n == 0:
        return np.zeros((0, seq_len), np.int32)
    return np.asarray(flat[:n * seq_len], np.int32).reshape(n, seq_len)


def stage1_batches(packed: np.ndarray, batch_size: int, accum: int,
                   seed: int, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
    """[A, B, T] host batches of the packed rows in the order
    ``default_rng(seed + epoch).permutation``, full groups only, with an
    all-ones attention mask and int64 labels equal to the ids."""
    order = np.random.default_rng(seed + epoch).permutation(len(packed))
    chunk = batch_size * accum
    for i in range(0, len(packed) - chunk + 1, chunk):
        ids = packed[order[i:i + chunk]].reshape(accum, batch_size, -1)
        yield {"input_ids": ids, "attention_mask": np.ones_like(ids),
               "labels": ids.astype(np.int64)}


def make_eval_fn(eval_step: Callable, eval_packed: np.ndarray,
                 eval_batch_size: int, base) -> Callable:
    """``eval_fn(state) -> {"loss": mean CE per valid token}`` over every
    row of ``eval_packed`` in groups of ``eval_batch_size``. The last short
    group is padded to the full size with copies of its last row whose
    labels are all -100, so they add no valid token; ``eval_step``
    (``make_stage1_eval_step``) returns per-group sums, so the result is
    the exact per-token mean however the valid tokens fall."""
    eb = max(eval_batch_size, 1)

    def eval_fn(state) -> Dict[str, float]:
        loss_sum, n_tokens = 0.0, 0.0
        for i in range(0, len(eval_packed), eb):
            rows = eval_packed[i:i + eb]
            n_real = len(rows)
            if n_real < eb:
                pad = np.repeat(rows[-1:], eb - n_real, axis=0)
                rows = np.concatenate([rows, pad], axis=0)
            labels = rows[None].astype(np.int64)
            labels[0, n_real:] = IGNORE_INDEX
            m = eval_step(state.trainable, base,
                          {"input_ids": rows[None],
                           "attention_mask": np.ones_like(rows)[None],
                           "labels": labels})
            loss_sum += float(m["loss_sum"])
            n_tokens += float(m["n_tokens"])
        return {"loss": loss_sum / max(n_tokens, 1.0)}

    return eval_fn


def fused_route(max_seq_length: int, device, dtype: torch.dtype,
                hidden_size: int) -> Tuple[bool, str]:
    """(fused_loss, fused_backend) as the CLI picks them: the fused CE from
    ``max_seq_length`` 2048 on (materialised logits would take ~10 GB at
    B 4, T 4096), through the K2 kernels ("pallas") on the card where they
    take the model's ``dtype`` and ``hidden_size`` (bf16, D in
    ``KERNEL_DIMS``), as JAX picks its Pallas kernels on its accelerator,
    else the chunked plain route ("xla"), as ``ops/attention.use_flash``
    picks K1's."""
    on_card = torch.device(device).type == "cuda"
    takes = dtype == torch.bfloat16 and hidden_size in KERNEL_DIMS
    return (max_seq_length >= FUSED_MIN_SEQ,
            "pallas" if on_card and takes else "xla")
