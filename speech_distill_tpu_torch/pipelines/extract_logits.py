"""Teacher top-K logprob extraction, a batched inference pass (port of the
``speech_distill_tpu/pipelines/extract_logits.py``).

Order-preserving, no-grad teacher forward, top-K of the log-softmax,
each example truncated to its true length, fp16 values and int32
indices: the on-disk format the precomputed KD mode reads. Sequences are
right-padded to ``pad_to_multiple_of``, so every batch of a bucket has
one shape. ``main`` is the CLI (``datasets`` and ``transformers``).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from speech_distill_tpu_torch.core.device import resolve_device
from speech_distill_tpu_torch.data.collator import pad_sequences
from speech_distill_tpu_torch.distill.losses import extract_top_k
from speech_distill_tpu_torch.ops.fused_lm_loss import fused_extract_top_k


def make_extract_fn(teacher_forward: Callable, top_k: int,
                    vocab_limit: Optional[int] = None,
                    method: str = "exact",
                    hidden_forward: Optional[Callable] = None,
                    head_weight_fn: Optional[Callable] = None):
    """``fn(teacher, ids, mask) -> (fp16 values, int32 indices)`` [B, T, K],
    without gradients: ``extract_top_k`` of ``teacher_forward``'s logits,
    or, given ``hidden_forward(teacher, ids, mask)`` and
    ``head_weight_fn(teacher)``, ``fused_extract_top_k`` of the hidden
    states (the [B, T, V] fp32 logits never held; the same set as
    method "exact")."""
    if hidden_forward is not None and head_weight_fn is not None:
        @torch.no_grad()
        def fused_fn(teacher, ids, mask):
            return fused_extract_top_k(hidden_forward(teacher, ids, mask),
                                       head_weight_fn(teacher), top_k,
                                       vocab_limit)
        return fused_fn

    @torch.no_grad()
    def fn(teacher, ids, mask):
        return extract_top_k(teacher_forward(teacher, ids, mask), top_k,
                             vocab_limit, method=method)
    return fn


def extract_teacher_logprobs(
        teacher, teacher_forward: Callable, sequences: Sequence[Dict],
        top_k: int = 100, batch_size: int = 4, pad_token_id: int = 0,
        pad_to_multiple_of: int = 128, vocab_limit: Optional[int] = None,
        progress: bool = True, mesh=None, method: str = "exact",
        hidden_forward: Optional[Callable] = None,
        head_weight_fn: Optional[Callable] = None, device="cuda",
) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Order-preserving extraction over feature dicts, each with
    ``teacher_input_ids`` (or ``input_ids``) and optionally a matching
    attention mask, on ``device`` (CUDA by default; raises without it).
    A final short batch is repeat-padded with its last row to
    ``batch_size``. Returns per-example (fp16 values [t, K], int32 indices
    [t, K]) truncated to the true length t.

    ``mesh`` (``parallel/mesh.Mesh``): data-parallel extraction, one rank
    of it (the teacher sharded by ``sharding.shard_params``, ``device``
    then the mesh's). Each rank runs its dp rows of every batch
    (``batch_size`` divisible by dp) and the rows are all-gathered, so
    every rank returns the whole, ordered result. A teacher whose forward
    splits the sequence over sp (a ring ``attn_impl``) gives each rank its
    positions, gathered over sp (``sharding.gather_sequence``); a
    pipelined one gives every pp rank the whole output."""
    dev = resolve_device(device if mesh is None else mesh.device)
    dp = None
    if mesh is not None:
        from speech_distill_tpu_torch.models.qwen3 import sequence_layout
        from speech_distill_tpu_torch.parallel import comm
        from speech_distill_tpu_torch.parallel.sharding import (
            gather_sequence, shard_batch)
        if batch_size % mesh.dp:
            raise ValueError(f"batch_size={batch_size} not divisible by "
                             f"dp={mesh.dp}")
        dp = mesh.group("dp")
    fn = make_extract_fn(teacher_forward, top_k, vocab_limit, method,
                         hidden_forward, head_weight_fn)
    starts = range(0, len(sequences), batch_size)
    if progress:
        try:
            from tqdm import tqdm
            starts = tqdm(list(starts), desc=f"extract top-{top_k}")
        except ImportError:
            pass
    all_v: List[np.ndarray] = []
    all_i: List[np.ndarray] = []
    for start in starts:
        feats = sequences[start:start + batch_size]
        ids_l = [f.get("teacher_input_ids", f.get("input_ids"))
                 for f in feats]
        mask_l = [f.get("teacher_attention_mask",
                        f.get("attention_mask", [1] * len(i)))
                  for f, i in zip(feats, ids_l)]
        ids, mask = pad_sequences(ids_l, mask_l, pad_token_id,
                                  pad_to_multiple_of)
        if len(feats) < batch_size:      # the last short batch: repeat-pad
            reps = batch_size - len(feats)
            ids = np.concatenate([ids, np.repeat(ids[-1:], reps, 0)])
            mask = np.concatenate([mask, np.repeat(mask[-1:], reps, 0)])
        if mesh is None:
            v, i = fn(teacher, torch.from_numpy(ids).to(dev),
                      torch.from_numpy(mask).to(dev))
        else:
            b = shard_batch(mesh, {"ids": ids, "mask": mask},
                            microbatched=False)
            v, i = fn(teacher, b["ids"], b["mask"])
            layout = sequence_layout(teacher, ids.shape[1])
            if layout is not None:              # this sp rank's positions
                v = gather_sequence(v, mesh, layout[1])
                i = gather_sequence(i, mesh, layout[1])
            v, i = comm.all_gather(v, dp), comm.all_gather(i, dp)
        v, i = v.cpu().numpy(), i.cpu().numpy()
        for b, n in enumerate(mask.sum(axis=1)[:len(feats)]):
            all_v.append(v[b, :int(n)].astype(np.float16))
            all_i.append(i[b, :int(n)].astype(np.int32))
    return all_v, all_i


def main(argv=None):
    import argparse
    from speech_distill_tpu_torch.core.config import parse_prefix
    from speech_distill_tpu_torch.data.processor import (
        SpeechDistillProcessor)
    from speech_distill_tpu_torch.models import qwen3
    from speech_distill_tpu_torch.models.hf_loader import load_pretrained
    from speech_distill_tpu_torch.pipelines.common import (
        add_device_arg, add_template_args, load_hf_dataset, load_tokenizer)
    from speech_distill_tpu_torch.tokenizer.s3 import (
        default_speech_tokens_fn)

    p = argparse.ArgumentParser(
        description="Extract teacher logprobs for distillation")
    p.add_argument("--teacher_model_path", type=str, required=True)
    p.add_argument("--dataset_path", type=str, required=True)
    p.add_argument("--dataset_split", type=str, default="train")
    p.add_argument("--output_path", type=str, required=True)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--top_k", type=int, default=100)
    p.add_argument("--max_length", type=int, default=None)
    p.add_argument("--pad_to_multiple_of", type=int, default=128)
    add_template_args(p, student_prefix=False)
    add_device_arg(p)
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    _, model = load_pretrained(args.teacher_model_path, device=dev)
    tokenizer = load_tokenizer(args.teacher_model_path, args.pad_token)
    dataset = load_hf_dataset(args.dataset_path, args.dataset_split)

    if "input_ids" not in dataset.column_names and \
            "teacher_input_ids" not in dataset.column_names:
        processor = SpeechDistillProcessor(
            tokenizer, speech_tokens_fn=default_speech_tokens_fn(dev),
            prefix=parse_prefix(args.teacher_prefix),
            text_bos=args.text_bos, text_eos=args.text_eos,
            text_prefix=parse_prefix(args.text_prefix),
            speech_bos=args.speech_bos, speech_eos=args.speech_eos,
            max_length=args.max_length)
        dataset = dataset.map(lambda ex: processor.process_example(ex),
                              desc="tokenize")

    def fwd(teacher, ids, mask):
        return qwen3.forward(teacher, ids, attention_mask=mask)

    feats = [dataset[i] for i in range(len(dataset))]
    all_v, all_i = extract_teacher_logprobs(
        model, fwd, feats, top_k=args.top_k, batch_size=args.batch_size,
        pad_token_id=tokenizer.pad_token_id,
        pad_to_multiple_of=args.pad_to_multiple_of, device=dev)

    if len(all_v) != len(dataset):
        raise RuntimeError(
            f"Alignment mismatch! Extracted {len(all_v)} but dataset has "
            f"{len(dataset)}")
    dataset = dataset.add_column("teacher_top_k_v",
                                 [v.tolist() for v in all_v])
    dataset = dataset.add_column("teacher_top_k_i",
                                 [i.tolist() for i in all_i])
    dataset.save_to_disk(args.output_path)
    print(f"Saved enriched dataset to {args.output_path}")


if __name__ == "__main__":
    main()
