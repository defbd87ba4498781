"""The S3 speech tokenizer's entry for the dataset processors (the
``default_speech_tokens_fn`` of ``speech_distill_tpu/tokenizer/s3.py``).

The tokenizer itself (audio -> 25 Hz semantic codes) is not ported yet
(ROADMAP §1 item 9): the processors call this function only for rows with
audio and no ``codes`` column, and it raises there, so such a dataset
fails loudly instead of training without its speech.
"""
from __future__ import annotations

NOT_PORTED = ("audio rows need the S3 speech tokenizer, which is not ported "
              "(ROADMAP §1 item 9); give the dataset a 'codes' column")


def default_speech_tokens_fn():
    """speech_tokens_fn for the processors: raises ``NotImplementedError``
    on its first call."""
    def fn(audio_input):
        raise NotImplementedError(NOT_PORTED)
    return fn
