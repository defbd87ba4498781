"""Podcast script parsing (own copy of
``speech_distill_tpu/utils/parser.py``; reference
soulxpodcast/utils/parser.py)."""
from __future__ import annotations

import datetime
import os
from typing import Dict

DIALECT_PREFIXES = ("<|Henan|>", "<|Sichuan|>", "<|Yue|>")


def generate_time_index() -> str:
    return datetime.datetime.now().strftime("%Y%m%d-%H%M%S")


def check_prefix(text: str) -> bool:
    return any(text.startswith(p) for p in DIALECT_PREFIXES)


def podcast_format_parser(data: Dict, output_dir: str = "outputs") -> Dict:
    """Multi-speaker podcast JSON -> flattened datalist entry
    (parser.py:20-78)."""
    speakers = data.get("speakers", {})
    text_entries = data.get("text", [])
    spk2id = {name: idx for idx, name in enumerate(speakers.keys())}

    prompt_text, prompt_wav, dialect_prompt_text = [], [], []
    for name in speakers:
        prompt_text.append(speakers[name].get("prompt_text", ""))
        prompt_wav.append(speakers[name].get("prompt_audio", ""))
        dialect_prompt_text.append(speakers[name].get("dialect_prompt", ""))

    text_list, spk_list = [], []
    for turn in text_entries:
        if len(turn) == 2:
            spk_name, utt_text = turn
            text_list.append(f"[{spk_name}]{utt_text}")
            spk_list.append(spk2id.get(spk_name, -1))

    key = generate_time_index()
    use_dialect_prompt = False
    for dialect_text in dialect_prompt_text:
        if len(dialect_text) > 0:
            if not check_prefix(dialect_text):
                raise AssertionError(
                    f"Unknown dialect prefix: {dialect_text} \n Prefix "
                    f"should be one of: {', '.join(DIALECT_PREFIXES)}")
            use_dialect_prompt = True

    return {
        "key": key,
        "prompt_text": prompt_text,
        "prompt_wav": prompt_wav,
        "text": text_list,
        "spk": spk_list,
        "wav": os.path.join(output_dir, f"{key}.wav"),
        "use_dialect_prompt": use_dialect_prompt,
        "dialect_prompt_text": dialect_prompt_text,
    }
