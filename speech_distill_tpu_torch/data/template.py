"""Prompt-template grammar and prefix alignment (own copy of
``speech_distill_tpu/data/template.py``).

Token-exact reproduction of the reference's template assembly
(utils.py:183-195,227-245) and prefix alignment (data.py:20-60). These are
host-side string/token functions shared by every pipeline; the grammar is
part of the public artifact contract:

    prefix + text_bos + text_prefix + text.strip() + text_eos
           + speech_bos + "<|id|>"*N + speech_eos
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Union

from speech_distill_tpu_torch.core.config import parse_prefix  # re-export  # noqa: F401

Prefix = Union[str, Dict[str, str], Callable[[str, str], str]]


def resolve_prefix(prefix: Prefix, text: str = "", lang: str = "") -> str:
    """str -> itself; dict -> by lang with 'default' fallback; callable ->
    called with (text, lang). Matches reference data.py:95-111."""
    if callable(prefix):
        return prefix(text, lang)
    if isinstance(prefix, dict):
        return prefix.get(lang, prefix.get("default", ""))
    return prefix


def speech_codes_to_text(codes: Sequence[int]) -> str:
    """Semantic token ids -> literal ``<|1234|>`` text (utils.py:183-185)."""
    return "".join(f"<|{int(c)}|>" for c in codes)


def assemble_prompt(text: str, codes: Sequence[int], *, prefix: str = "",
                    text_bos: str = "<|text_start|>",
                    text_eos: str = "<|text_end|>",
                    text_prefix: str = "",
                    speech_bos: str = "<|semantic_token_start|>",
                    speech_eos: str = "<|semantic_token_end|>") -> str:
    """The full template string (utils.py:186-195)."""
    return (prefix + text_bos + text_prefix + text.strip() + text_eos
            + speech_bos + speech_codes_to_text(codes) + speech_eos)


def align_prefixes(teacher_prefix: Union[str, Dict[str, str]],
                   student_prefix: Union[str, Dict[str, str]],
                   tokenizer):
    """Left-pad the shorter prefix with pad_token strings so teacher and
    student prefixes tokenize to the same length — required so sequences
    index-align position-by-position for per-position KL (data.py:20-60).
    """
    pad_token = tokenizer.pad_token if getattr(tokenizer, "pad_token", None) \
        else tokenizer.eos_token

    def _align_single(t_p: str, s_p: str):
        t_ids = tokenizer.encode(t_p, add_special_tokens=False)
        s_ids = tokenizer.encode(s_p, add_special_tokens=False)
        if len(t_ids) == len(s_ids):
            return t_p, s_p
        max_len = max(len(t_ids), len(s_ids))
        if len(t_ids) < max_len:
            t_p = (pad_token * (max_len - len(t_ids))) + t_p
        if len(s_ids) < max_len:
            s_p = (pad_token * (max_len - len(s_ids))) + s_p
        return t_p, s_p

    if isinstance(teacher_prefix, dict) or isinstance(student_prefix, dict):
        if isinstance(teacher_prefix, str):
            teacher_prefix = {"default": teacher_prefix}
        if isinstance(student_prefix, str):
            student_prefix = {"default": student_prefix}
        new_t: Dict[str, str] = {}
        new_s: Dict[str, str] = {}
        for k in set(teacher_prefix) | set(student_prefix):
            t_val = teacher_prefix.get(k, teacher_prefix.get("default", ""))
            s_val = student_prefix.get(k, student_prefix.get("default", ""))
            new_t[k], new_s[k] = _align_single(t_val, s_val)
        return new_t, new_s
    return _align_single(teacher_prefix, student_prefix)


def build_example_text(text: str, codes: Sequence[int], lang: str, *,
                       prefix: Prefix, text_prefix: Prefix,
                       text_bos: str, text_eos: str,
                       speech_bos: str, speech_eos: str) -> str:
    """Resolve per-language prefixes and assemble the prompt for one example."""
    return assemble_prompt(
        text, codes,
        prefix=resolve_prefix(prefix, text, lang),
        text_prefix=resolve_prefix(text_prefix, text, lang),
        text_bos=text_bos, text_eos=text_eos,
        speech_bos=speech_bos, speech_eos=speech_eos)
