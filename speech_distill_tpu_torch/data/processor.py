"""Dataset processors: audio -> semantic tokens -> template -> input ids
(own copy of ``speech_distill_tpu/data/processor.py``).

Equivalent of reference ``SpeechDistillDatasetProcessor`` (data.py:63-198) and
``DistillationDataProcessor`` (data.py:390-462). The audio->codes function is
injected (``speech_tokens_fn``) so the same processor drives an S3
tokenizer (``tokenizer/s3.default_speech_tokens_fn``), a
recorded-codes lookup in tests, or datasets that already carry a ``codes``
column.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

from speech_distill_tpu_torch.data.template import Prefix, build_example_text

# (audio_input) -> list[int] semantic codes for ONE clip
SpeechTokensFn = Callable[[Any], Sequence[int]]


class SpeechDistillProcessor:
    """Turns one raw example {audio?, codes?, text, lang} into input ids."""

    def __init__(self, tokenizer, speech_tokens_fn: Optional[SpeechTokensFn] = None,
                 prefix: Prefix = "", text_bos: str = "<|text_start|>",
                 text_eos: str = "<|text_end|>", text_prefix: Prefix = "",
                 speech_bos: str = "<|semantic_token_start|>",
                 speech_eos: str = "<|semantic_token_end|>",
                 max_length: Optional[int] = None):
        self.tokenizer = tokenizer
        self.speech_tokens_fn = speech_tokens_fn
        self.prefix = prefix
        self.text_bos = text_bos
        self.text_eos = text_eos
        self.text_prefix = text_prefix
        self.speech_bos = speech_bos
        self.speech_eos = speech_eos
        self.max_length = max_length

    def _codes(self, example: Dict[str, Any]) -> Sequence[int]:
        if "codes" in example and example["codes"] is not None:
            return example["codes"]
        audio = example.get("audio", example.get("wav_path"))
        if audio is None:
            raise ValueError("'audio' key not found in example")
        if self.speech_tokens_fn is None:
            raise ValueError("no speech_tokens_fn configured and no 'codes' column")
        return self.speech_tokens_fn(audio)

    def build_text(self, example: Dict[str, Any]) -> str:
        return build_example_text(
            example.get("text", ""), self._codes(example),
            example.get("lang", ""),
            prefix=self.prefix, text_prefix=self.text_prefix,
            text_bos=self.text_bos, text_eos=self.text_eos,
            speech_bos=self.speech_bos, speech_eos=self.speech_eos)

    def process_example(self, example: Dict[str, Any]) -> Dict[str, List[int]]:
        enc = self.tokenizer(
            self.build_text(example),
            truncation=self.max_length is not None,
            max_length=self.max_length,
            return_attention_mask=True)
        ids = enc["input_ids"]
        mask = enc.get("attention_mask", [1] * len(ids))
        return {"input_ids": list(ids), "attention_mask": list(mask)}

    def process_batch(self, examples: Dict[str, List[Any]]) -> Dict[str, List[List[int]]]:
        n = len(examples.get("text", examples.get("audio", examples.get("codes", []))))
        out_ids, out_mask = [], []
        for i in range(n):
            ex = {k: v[i] for k, v in examples.items()}
            one = self.process_example(ex)
            out_ids.append(one["input_ids"])
            out_mask.append(one["attention_mask"])
        return {"input_ids": out_ids, "attention_mask": out_mask}


class DualProcessor:
    """Produces aligned student+teacher ids from one raw example
    (reference DistillationDataProcessor, data.py:390-462)."""

    def __init__(self, student: SpeechDistillProcessor,
                 teacher: SpeechDistillProcessor):
        self.student = student
        self.teacher = teacher

    def __call__(self, examples: Dict[str, Any]) -> Dict[str, Any]:
        probe = examples.get("text", examples.get("audio", examples.get("codes")))
        if isinstance(probe, list):
            s = self.student.process_batch(examples)
            t = self.teacher.process_batch(examples)
            return {
                "student_input_ids": s["input_ids"],
                "student_attention_mask": s["attention_mask"],
                "teacher_input_ids": t["input_ids"],
                "teacher_attention_mask": t["attention_mask"],
            }
        s1 = self.student.process_example(examples)
        t1 = self.teacher.process_example(examples)
        return {
            "student_input_ids": s1["input_ids"],
            "student_attention_mask": s1["attention_mask"],
            "teacher_input_ids": t1["input_ids"],
            "teacher_attention_mask": t1["attention_mask"],
        }
