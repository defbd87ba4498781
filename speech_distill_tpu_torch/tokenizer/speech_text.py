"""Text tokenizer with literal speech-token markers, for the CosyVoice2
teacher's unified ids (port of ``speech_distill_tpu/tokenizer/
speech_text.py``; the reference's ``CosyVoiceTokenizerWrapper``).

Plain text goes through a base tokenizer; special markers and ``<|N|>``
semantic-token literals map to their own id ranges:

    <|sos|> / <|text_start|>                      -> text_vocab_size
    <|sft_text_only|> / <|semantic_token_start|>  -> text_vocab_size + 1
    <|N|>                                         -> text_vocab_size + 2 + N
    <|semantic_token_end|>                        -> text_vocab_size + 2 + 6561

Host-side regex; no tensor is touched.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Union

DEFAULT_NUM_SPEECH_TOKENS = 6561


class SpeechTextTokenizer:
    """Wraps any base tokenizer with speech-marker handling; other
    attributes pass through to the base."""

    def __init__(self, base_tokenizer, text_vocab_size: int = 152704,
                 num_speech_tokens: int = DEFAULT_NUM_SPEECH_TOKENS,
                 special_map: Optional[Dict[str, int]] = None):
        self.base = base_tokenizer
        self.text_vocab_size = text_vocab_size
        self.sos_token_id = text_vocab_size
        self.task_token_id = text_vocab_size + 1
        self.speech_token_offset = text_vocab_size + 2
        self.speech_eos_id = self.speech_token_offset + num_speech_tokens
        self.special_map = special_map if special_map is not None else {
            "<|sos|>": self.sos_token_id,
            "<|text_start|>": self.sos_token_id,
            "<|sft_text_only|>": self.task_token_id,
            "<|semantic_token_start|>": self.task_token_id,
            "<|semantic_token_end|>": self.speech_eos_id,
        }
        keys = "|".join(re.escape(k) for k in self.special_map)
        self.pattern = re.compile(rf"({keys}|<\|(\d+)\|>)")

    def encode(self, text: str, add_special_tokens: bool = False,
               **kw) -> List[int]:
        """Ids of ``text``: the base tokenizer's for the text between
        markers (never with its special tokens), the mapped id for each
        marker. A non-string goes to the base tokenizer as it is."""
        if not isinstance(text, str):
            return self.base.encode(text,
                                    add_special_tokens=add_special_tokens,
                                    **kw)
        tokens: List[int] = []
        last = 0
        for m in self.pattern.finditer(text):
            seg = text[last:m.start()]
            if seg:
                tokens.extend(self.base.encode(seg, add_special_tokens=False))
            lit = m.group(1)
            if lit in self.special_map:
                tokens.append(self.special_map[lit])
            elif m.group(2) is not None:
                tokens.append(self.speech_token_offset + int(m.group(2)))
            last = m.end()
        seg = text[last:]
        if seg:
            tokens.extend(self.base.encode(seg, add_special_tokens=False))
        return tokens

    def __call__(self, text: Union[str, Sequence[str]],
                 padding: bool = False, truncation: bool = False,
                 max_length: Optional[int] = None,
                 return_attention_mask: bool = True, **kw):
        """A string or a batch of them as {"input_ids", "attention_mask"}
        lists; ``padding`` right-pads a batch to its longest row with the
        pad id (0 without one)."""
        is_batch = isinstance(text, (list, tuple))
        texts = list(text) if is_batch else [text]
        all_ids = [self.encode(t) for t in texts]
        if truncation and max_length:
            all_ids = [ids[:max_length] for ids in all_ids]
        if padding:
            T = max(len(ids) for ids in all_ids)
            pad_id = self.pad_token_id or 0
            masks = [[1] * len(ids) + [0] * (T - len(ids)) for ids in all_ids]
            all_ids = [ids + [pad_id] * (T - len(ids)) for ids in all_ids]
        else:
            masks = [[1] * len(ids) for ids in all_ids]
        res = {"input_ids": all_ids if is_batch else all_ids[0]}
        if return_attention_mask:
            res["attention_mask"] = masks if is_batch else masks[0]
        return res

    def decode(self, ids: Sequence[int], **kw) -> str:
        """The text of ``ids``: runs of text ids through the base
        tokenizer, markers and ``<|N|>`` literals spelled out (for an id
        with two markers, the later one in ``special_map``)."""
        inv = {v: k for k, v in self.special_map.items()}
        out: List[str] = []
        run: List[int] = []

        def flush():
            if run:
                out.append(self.base.decode(run))
                run.clear()

        for i in ids:
            i = int(i)
            if i in inv:
                flush()
                out.append(inv[i])
            elif i >= self.speech_token_offset:
                flush()
                out.append(f"<|{i - self.speech_token_offset}|>")
            elif i >= self.text_vocab_size:
                flush()
                out.append(inv.get(i, ""))
            else:
                run.append(i)
        flush()
        return "".join(out)

    @property
    def pad_token(self):
        return getattr(self.base, "pad_token", None)

    @property
    def pad_token_id(self):
        tok = self.pad_token
        if tok is None:
            return None
        ids = self.encode(tok)
        return ids[0] if ids else None

    @property
    def eos_token(self):
        return getattr(self.base, "eos_token", None)

    def __getattr__(self, name):
        return getattr(self.base, name)

    def __len__(self):
        return self.speech_eos_id + 1
