"""Text normalisation and dialogue validators (own copy of
``speech_distill_tpu/utils/text.py``; reference
soulxpodcast/utils/text.py)."""
from __future__ import annotations

import re
from typing import List


def remove_space_between_chinese(text: str) -> str:
    text = re.sub(r'([一-鿿])\s+([一-鿿])', r'\1\2', text)
    text = re.sub(r'([a-zA-Z])\s+([一-鿿])', r'\1\2', text)
    text = re.sub(r'([一-鿿])\s+([a-zA-Z])', r'\1\2', text)
    return text


def normalize_text(current_text: str) -> str:
    """CJK-aware space removal + final-punctuation insertion
    (text.py:17-43)."""
    current_text = remove_space_between_chinese(current_text)
    if re.search(r'[一-鿿]$', current_text):
        if current_text[-1] not in ",.?!。，？！":
            current_text += "。"
    elif re.search(r'[a-zA-Z]$', current_text):
        if current_text[-1] not in ".!?":
            current_text += "."
    return current_text


def check_monologue_text(text: str, prefix: str = None) -> bool:
    text = text.strip()
    if prefix is not None and not text.startswith(prefix):
        return False
    if prefix is not None:
        text = text.removeprefix(prefix)
    return len(text.strip()) > 0


def check_dialect_prompt_text(text: str, prefix: str = None) -> bool:
    text = text.strip()
    if prefix is not None and not text.startswith(prefix):
        return False
    return len(text.strip()) > 0


def check_dialogue_text(text_list: List[str]) -> bool:
    if len(text_list) == 0:
        return False
    return all(
        any(check_monologue_text(t, p) for p in ("[S1]", "[S2]", "[S3]", "[S4]"))
        for t in text_list)
