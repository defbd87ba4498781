"""Student vocab expansion: teacher tokenizer + resized embeddings (port
of ``speech_distill_tpu/distill/vocab.py``).

Semantics of the reference ``expand_student_vocab`` (prepare_student.py:
7-86): the student adopts the *teacher's* tokenizer for exact id
alignment; the new embedding matrices start as noise N(0, 1/sqrt(d)) plus
the mean embedding, and rows of tokens present in both vocabs are copied
over. Host numpy with the JAX package's draws, a one-shot offline
transform; the new tables are rounded to the model dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch


def expand_embeddings(old_input: np.ndarray, old_output: np.ndarray,
                      old_vocab: Dict[str, int], new_vocab: Dict[str, int],
                      seed: int = 0) -> Tuple[np.ndarray, np.ndarray, int]:
    """Return (new_input [V', D], new_output [V', D], matched_count)."""
    new_size = len(new_vocab)
    dim = old_input.shape[1]
    old_size = old_input.shape[0]
    rng = np.random.default_rng(seed)

    std = 1.0 / np.sqrt(dim)
    new_input = rng.normal(0.0, std, (new_size, dim)).astype(np.float32)
    new_input += old_input.mean(axis=0, keepdims=True)
    new_output = rng.normal(0.0, std, (new_size, dim)).astype(np.float32)
    new_output += old_output.mean(axis=0, keepdims=True)

    matched = 0
    for token, new_idx in new_vocab.items():
        old_idx = old_vocab.get(token)
        if old_idx is not None and old_idx < old_size and new_idx < new_size:
            new_input[new_idx] = old_input[old_idx]
            new_output[new_idx] = old_output[old_idx]
            matched += 1
    return new_input, new_output, matched


def _host32(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def expand_student_params(params: Dict[str, Any], cfg,
                          old_vocab: Dict[str, int],
                          new_vocab: Dict[str, int], seed: int = 0):
    """:func:`expand_embeddings` applied to a JAX-shaped weight tree of
    tensors (``convert.model_to_tree``). Returns (new tree, new config,
    matched); the new tables are ``cfg.dtype`` tensors on the device of
    the old ones. Tied embeddings use one matrix for input and output
    (like HF's resize of a tied model)."""
    old = params["embed"]["weight"]
    old_in = _host32(old)
    old_out = (_host32(params["lm_head"]["weight"]) if "lm_head" in params
               else old_in)
    new_in, new_out, matched = expand_embeddings(
        old_in, old_out, old_vocab, new_vocab, seed)

    def table(a):
        return torch.from_numpy(a).to(old.device).to(cfg.torch_dtype)

    new_params = dict(params)
    new_params["embed"] = {"weight": table(new_in)}
    if "lm_head" in params:
        new_params["lm_head"] = {"weight": table(new_out)}
    new_cfg = dataclasses.replace(cfg, vocab_size=len(new_vocab))
    return new_params, new_cfg, matched
