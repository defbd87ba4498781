"""Shared CLI plumbing for the pipelines (own copy of
``speech_distill_tpu/pipelines/common.py``).

The template and token flags are defined once, with the reference's names
and defaults, so commands carry over 1:1; the tokenizer and dataset
loaders are the host side of every CLI.
"""
from __future__ import annotations

import argparse
import os
from typing import Optional


def add_template_args(p: argparse.ArgumentParser, teacher_prefix=True,
                      student_prefix=True):
    if teacher_prefix:
        p.add_argument("--teacher_prefix", type=str,
                       default="<|task_podcast|><|SPEAKER_0|>",
                       help="Prefix for teacher input (string or JSON dict)")
    if student_prefix:
        p.add_argument("--student_prefix", type=str, default="",
                       help="Prefix for student input (string or JSON dict)")
    p.add_argument("--text_bos", type=str, default="<|text_start|>")
    p.add_argument("--text_eos", type=str, default="<|text_end|>")
    p.add_argument("--text_prefix", type=str,
                   default='{"en": "", "zh": "", "yue": "<|Yue|>"}')
    p.add_argument("--speech_bos", type=str,
                   default="<|semantic_token_start|>")
    p.add_argument("--speech_eos", type=str, default="<|semantic_token_end|>")
    p.add_argument("--pad_token", type=str, default="<|semantic_token_end|>")


def add_device_arg(p: argparse.ArgumentParser):
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; the CLIs raise without CUDA unless "
                        "this is 'cpu'")


def load_tokenizer(path: str, pad_token: Optional[str] = None):
    from transformers import AutoTokenizer
    tok = AutoTokenizer.from_pretrained(path, trust_remote_code=True)
    if pad_token:
        if pad_token not in tok.get_vocab():
            raise ValueError(
                f"Specified pad_token '{pad_token}' not found in tokenizer "
                "vocabulary. Please ensure the token exists or use a "
                "different one.")
        tok.pad_token = pad_token
    elif tok.pad_token is None:
        tok.pad_token = tok.eos_token
    return tok


def load_hf_dataset(path: str, split: Optional[str] = None):
    from datasets import load_dataset, load_from_disk
    if os.path.exists(path):
        ds = load_from_disk(path)
    else:
        ds = load_dataset(path, split=split) if split else load_dataset(path)
    if hasattr(ds, "keys") and not hasattr(ds, "column_names"):
        ds = ds.get("train", ds)
    return ds
