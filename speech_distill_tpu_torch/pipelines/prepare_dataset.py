"""Offline dataset preprocessing CLI (port of
``speech_distill_tpu/pipelines/prepare_dataset.py``; reference
prepare_dataset.py:19-216).

Runs the dual student/teacher processor over a raw dataset and saves the
four id columns the train CLI detects. Rows with audio and no ``codes``
column go through the S3 tokenizer of ``$S3_TOKENIZER_CKPT`` on
``--device``.
"""
from __future__ import annotations

import argparse


def make_dual_processor(tokenizer, teacher_prefix, student_prefix, config,
                        speech_tokens_fn=None, device="cuda"):
    from speech_distill_tpu_torch.core.config import parse_prefix
    from speech_distill_tpu_torch.data.processor import (
        DualProcessor, SpeechDistillProcessor)

    if speech_tokens_fn is None:
        from speech_distill_tpu_torch.tokenizer.s3 import (
            default_speech_tokens_fn)
        speech_tokens_fn = default_speech_tokens_fn(device)
    text_prefix = parse_prefix(config.text_prefix)
    common = dict(
        speech_tokens_fn=speech_tokens_fn,
        text_bos=config.text_bos, text_eos=config.text_eos,
        text_prefix=text_prefix, speech_bos=config.speech_bos,
        speech_eos=config.speech_eos,
        max_length=getattr(config, "max_length", None))
    return DualProcessor(
        SpeechDistillProcessor(tokenizer, prefix=student_prefix, **common),
        SpeechDistillProcessor(tokenizer, prefix=teacher_prefix, **common))


def prepare_dataset(config):
    from speech_distill_tpu_torch.core.config import parse_prefix
    from speech_distill_tpu_torch.core.device import resolve_device
    from speech_distill_tpu_torch.data.template import align_prefixes
    from speech_distill_tpu_torch.pipelines.common import (
        load_hf_dataset, load_tokenizer)

    dev = resolve_device(config.device)
    tokenizer = load_tokenizer(config.student_model, config.pad_token)
    teacher_prefix = parse_prefix(config.teacher_prefix)
    student_prefix = parse_prefix(config.student_prefix)
    teacher_prefix, student_prefix = align_prefixes(
        teacher_prefix, student_prefix, tokenizer)

    dataset = load_hf_dataset(config.dataset_path)
    dual = make_dual_processor(tokenizer, teacher_prefix, student_prefix,
                               config, device=dev)
    processed = dataset.map(
        dual, batched=config.batch_size > 1, batch_size=config.batch_size,
        num_proc=config.num_proc if config.num_proc > 1 else None,
        desc="Processing dataset")
    processed.save_to_disk(config.output_path)
    print(f"Dataset preprocessing complete: {len(processed)} examples -> "
          f"{config.output_path}")
    print(f"Columns: {processed.column_names}")


def build_parser():
    from speech_distill_tpu_torch.pipelines.common import (add_device_arg,
                                                           add_template_args)
    p = argparse.ArgumentParser(
        description="Preprocess dataset with the dual distillation processor")
    p.add_argument("--dataset_path", type=str, required=True)
    p.add_argument("--output_path", type=str, required=True)
    p.add_argument("--student_model", type=str,
                   default="./pretrained_models/Qwen3-0.6B")
    add_template_args(p)
    p.add_argument("--max_length", type=int, default=512)
    add_device_arg(p)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--num_proc", type=int, default=1)
    return p


def main(argv=None):
    prepare_dataset(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
