"""Vocab-expansion CLI (port of
``speech_distill_tpu/pipelines/prepare_student.py``; reference
prepare_student.py:7-114).

Swaps the student tokenizer for the teacher's and resizes the embeddings
with noisy-mean init and matched-token copy, then writes an HF directory.
"""
from __future__ import annotations

import argparse


def expand_student_vocab(teacher_model_id: str, student_model_id: str,
                         output_dir: str, seed: int = 0, device="cuda"):
    from transformers import AutoTokenizer
    from speech_distill_tpu_torch.core.checkpoint import export_hf
    from speech_distill_tpu_torch.core.device import resolve_device
    from speech_distill_tpu_torch.distill.vocab import expand_student_params
    from speech_distill_tpu_torch.models.convert import model_to_tree
    from speech_distill_tpu_torch.models.hf_loader import load_pretrained

    dev = resolve_device(device)
    teacher_tok = AutoTokenizer.from_pretrained(
        teacher_model_id, trust_remote_code=True)
    student_tok = AutoTokenizer.from_pretrained(
        student_model_id, trust_remote_code=True)
    teacher_tok.save_pretrained(output_dir)

    cfg, model = load_pretrained(student_model_id, device=dev)
    params = model_to_tree(model)
    del model
    new_params, new_cfg, matched = expand_student_params(
        params, cfg, student_tok.get_vocab(), teacher_tok.get_vocab(),
        seed=seed)
    print(f"Resized embeddings {cfg.vocab_size} -> {new_cfg.vocab_size}; "
          f"matched {matched} tokens from the original student.")
    export_hf(new_params, new_cfg, output_dir)
    print(f"Resized student model saved to {output_dir}")


def main(argv=None):
    from speech_distill_tpu_torch.pipelines.common import add_device_arg
    p = argparse.ArgumentParser(
        description="Expand student model vocabulary to match teacher model")
    p.add_argument("--teacher-model", type=str,
                   default="Soul-AILab/SoulX-Podcast-1.7B-dialect")
    p.add_argument("--student-model", type=str, default="Qwen/Qwen3-0.6B")
    p.add_argument("--output-dir", type=str,
                   default="./pretrained_models/Qwen3-0.6B")
    p.add_argument("--seed", type=int, default=0)
    add_device_arg(p)
    args = p.parse_args(argv)
    expand_student_vocab(args.teacher_model, args.student_model,
                         args.output_dir, args.seed, args.device)


if __name__ == "__main__":
    main()
