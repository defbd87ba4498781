"""Batch collation: padding, labels, speech-token masking. Host-side numpy.

Own copy of ``speech_distill_tpu/data/collator.py`` (the port imports
nothing of the JAX package). Behaviour matches the reference
``ProcessedDataCollator`` (data.py:201-387) with two changes:

  * ``pad_to_multiple_of`` defaults to 128 — bucketed shapes, so every
    batch of a bucket has the same [B, T];
  * the speech mask is computed vectorized (cumulative-or over
    ``ids == speech_bos_id``) instead of a per-row python loop.

Label semantics preserved exactly: labels = input_ids; positions equal to
pad_token_id -> -100 (note: this also masks genuine speech_eos occurrences,
since the reference's default pad token IS <|semantic_token_end|> — faithful
on purpose); then all positions before the first speech_bos -> -100
(data.py:247-276).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

IGNORE_INDEX = -100


def round_up(n: int, multiple: Optional[int]) -> int:
    if not multiple:
        return n
    return (n + multiple - 1) // multiple * multiple


def pad_sequences(ids_list: Sequence[Sequence[int]],
                  mask_list: Optional[Sequence[Sequence[int]]],
                  pad_token_id: int,
                  pad_to_multiple_of: Optional[int] = None,
                  max_length: Optional[int] = None):
    """Right-pad ragged id lists to one [B, T] array (data.py:280-328)."""
    lengths = [len(x) for x in ids_list]
    T = max_length if max_length is not None else round_up(
        max(lengths), pad_to_multiple_of)
    B = len(ids_list)
    ids = np.full((B, T), pad_token_id, dtype=np.int32)
    mask = np.zeros((B, T), dtype=np.int32)
    for b, seq in enumerate(ids_list):
        n = min(len(seq), T)
        ids[b, :n] = np.asarray(seq[:n], dtype=np.int32)
        if mask_list is not None:
            mask[b, :n] = np.asarray(mask_list[b][:n], dtype=np.int32)
        else:
            mask[b, :n] = 1
    return ids, mask


def pad_top_k(arr_list: Sequence[np.ndarray], max_length: int,
              padding_value) -> np.ndarray:
    """Pad/truncate per-example [t, K] arrays to [B, max_length, K]
    (data.py:330-348)."""
    K = np.asarray(arr_list[0]).shape[-1]
    B = len(arr_list)
    dtype = np.asarray(arr_list[0]).dtype
    out = np.full((B, max_length, K), padding_value, dtype=dtype)
    for b, a in enumerate(arr_list):
        a = np.asarray(a)
        n = min(a.shape[0], max_length)
        out[b, :n] = a[:n]
    return out


def speech_token_mask(input_ids: np.ndarray, speech_bos_id: int) -> np.ndarray:
    """[B, T] float mask: 1 from the first speech_bos onwards
    (data.py:350-387), vectorized via cumulative-or."""
    hit = input_ids == speech_bos_id
    return np.maximum.accumulate(hit, axis=1).astype(np.float32)


class DistillCollator:
    """Collate processed features into fixed-shape numpy batches.

    Accepts features with either ``student_input_ids``/``teacher_input_ids``
    (dual-processed) or plain ``input_ids`` (data.py:219-243), plus optional
    pre-extracted ``teacher_top_k_v``/``teacher_top_k_i`` columns.
    """

    def __init__(self, pad_token_id: int, speech_bos_id: Optional[int],
                 pad_to_multiple_of: Optional[int] = 128,
                 emit_speech_mask: bool = False):
        self.pad_token_id = pad_token_id
        self.speech_bos_id = speech_bos_id
        self.pad_to_multiple_of = pad_to_multiple_of
        # the reference computes the mask only to fold it into labels and
        # does NOT ship it to the loss (train.py:47 pops a key the collator
        # never sets); emit_speech_mask=True adds it for exactness checks.
        self.emit_speech_mask = emit_speech_mask

    def __call__(self, features: List[Dict[str, Any]]) -> Dict[str, np.ndarray]:
        if "student_input_ids" in features[0]:
            s_ids = [f["student_input_ids"] for f in features]
            s_mask = [f.get("student_attention_mask", [1] * len(i))
                      for f, i in zip(features, s_ids)]
            t_ids = [f.get("teacher_input_ids") for f in features]
            t_mask = [f.get("teacher_attention_mask") for f in features]
        else:
            s_ids = [f["input_ids"] for f in features]
            s_mask = [f.get("attention_mask", [1] * len(i))
                      for f, i in zip(features, s_ids)]
            t_ids = [None]
            t_mask = [None]

        input_ids, attention_mask = pad_sequences(
            s_ids, s_mask, self.pad_token_id, self.pad_to_multiple_of)
        T = input_ids.shape[1]

        labels = input_ids.astype(np.int64).copy()
        labels[labels == self.pad_token_id] = IGNORE_INDEX

        batch: Dict[str, np.ndarray] = {
            "input_ids": input_ids,
            "attention_mask": attention_mask,
            "labels": labels,
        }

        if t_ids[0] is not None:
            # teacher pads to its own batch max (reference data.py:280-328),
            # floored at the student bucket T so the common aligned-prefix
            # case keeps equal static shapes; teacher rows longer than the
            # student bucket are preserved, never silently truncated — any
            # position misalignment then fails loudly at loss time, exactly
            # like the reference.
            t_T = max(T, round_up(max(len(t) for t in t_ids),
                                  self.pad_to_multiple_of))
            tt, tm = pad_sequences(t_ids, t_mask, self.pad_token_id,
                                   self.pad_to_multiple_of, max_length=t_T)
            batch["teacher_input_ids"] = tt
            batch["teacher_attention_mask"] = tm

        if "teacher_top_k_v" in features[0]:
            top_v = [f["teacher_top_k_v"] for f in features]
            top_i = [f["teacher_top_k_i"] for f in features]
            batch["teacher_top_k_v"] = pad_top_k(top_v, T, 0.0)
            batch["teacher_top_k_i"] = pad_top_k(top_i, T, 0)

        if self.speech_bos_id is not None:
            mask = speech_token_mask(input_ids, self.speech_bos_id)
            batch["labels"][mask == 0] = IGNORE_INDEX
            if self.emit_speech_mask:
                batch["speech_token_mask"] = mask

        return batch
