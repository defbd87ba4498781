"""Stage-1 warm-up CLI: align text with the new speech tokens (port of
``speech_distill_tpu/pipelines/stage1.py``; reference stage1.py:96-531).

Only the new speech-token rows of the embedding train
(``distill/train_step.make_stage1_step``); examples are formatted by the
template processor and packed into fixed-length rows (TRL
``packing=True``) for static shapes; ``--use_8bit_optimizer`` keeps
AdamW's moments as int8 / uint8 codes (``distill/optim8bit``).
:func:`train_stage1` is the CLI; the pieces it runs are plain functions
here:

* :func:`pack_sequences`, the packing;
* :func:`stage1_batches`, the batch iterator ([A, B, T] batches of
  packed rows in a seeded order per epoch, labels equal to the ids);
* :func:`make_eval_fn`, the eval aggregator (exact per-token mean over
  every eval row, scored once);
* :func:`fused_route`, the choice of the fused CE.

``--sp`` (JAX ``stage1.py:45-47, 99-101``): ring attention over a mesh of
tp 1, sp ``--sp`` and dp the processes that remain (one process a device,
started by ``torchrun`` or ``parallel/multihost``'s variables): every
rank streams the global batches of ``--batch_size`` x dp rows, keeps its
dp rows, and runs the head (K2 on the card) on its positions.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Callable, Dict, Iterator, List, Tuple

import numpy as np
import torch

from speech_distill_tpu_torch.distill.losses import IGNORE_INDEX
from speech_distill_tpu_torch.ops.pallas_lm_loss import KERNEL_DIMS

FUSED_MIN_SEQ = 2048        # the CLI's threshold for the fused CE


def pack_sequences(id_lists: List[List[int]], seq_len: int,
                   eos_id: int) -> np.ndarray:
    """Concatenate the examples, each followed by ``eos_id``, and cut the
    stream into int32 rows [n, seq_len]; the tail shorter than a row is
    dropped (an empty [0, seq_len] array when nothing fills a row)."""
    flat: List[int] = []
    for ids in id_lists:
        flat.extend(ids)
        flat.append(eos_id)
    n = len(flat) // seq_len
    if n == 0:
        return np.zeros((0, seq_len), np.int32)
    return np.asarray(flat[:n * seq_len], np.int32).reshape(n, seq_len)


def stage1_batches(packed: np.ndarray, batch_size: int, accum: int,
                   seed: int, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
    """[A, B, T] host batches of the packed rows in the order
    ``default_rng(seed + epoch).permutation``, full groups only, with an
    all-ones attention mask and int64 labels equal to the ids."""
    order = np.random.default_rng(seed + epoch).permutation(len(packed))
    chunk = batch_size * accum
    for i in range(0, len(packed) - chunk + 1, chunk):
        ids = packed[order[i:i + chunk]].reshape(accum, batch_size, -1)
        yield {"input_ids": ids, "attention_mask": np.ones_like(ids),
               "labels": ids.astype(np.int64)}


def make_eval_fn(eval_step: Callable, eval_packed: np.ndarray,
                 eval_batch_size: int, base, put=None) -> Callable:
    """``eval_fn(state) -> {"loss": mean CE per valid token}`` over every
    row of ``eval_packed`` in groups of ``eval_batch_size``. The last short
    group is padded to the full size with copies of its last row whose
    labels are all -100, so they add no valid token; ``eval_step``
    (``make_stage1_eval_step``) returns per-group sums, so the result is
    the exact per-token mean however the valid tokens fall. ``put``
    places a host batch (a rank's dp rows under a mesh)."""
    eb = max(eval_batch_size, 1)
    put = put or (lambda b: b)

    def eval_fn(state) -> Dict[str, float]:
        loss_sum, n_tokens = 0.0, 0.0
        for i in range(0, len(eval_packed), eb):
            rows = eval_packed[i:i + eb]
            n_real = len(rows)
            if n_real < eb:
                pad = np.repeat(rows[-1:], eb - n_real, axis=0)
                rows = np.concatenate([rows, pad], axis=0)
            labels = rows[None].astype(np.int64)
            labels[0, n_real:] = IGNORE_INDEX
            m = eval_step(state.trainable, base,
                          put({"input_ids": rows[None],
                               "attention_mask": np.ones_like(rows)[None],
                               "labels": labels}))
            loss_sum += float(m["loss_sum"])
            n_tokens += float(m["n_tokens"])
        return {"loss": loss_sum / max(n_tokens, 1.0)}

    return eval_fn


def fused_route(max_seq_length: int, device, dtype: torch.dtype,
                hidden_size: int) -> Tuple[bool, str]:
    """(fused_loss, fused_backend) as the CLI picks them: the fused CE from
    ``max_seq_length`` 2048 on (materialised logits would take ~10 GB at
    B 4, T 4096), through the K2 kernels ("pallas") on the card where they
    take the model's ``dtype`` and ``hidden_size`` (bf16, D in
    ``KERNEL_DIMS``), as JAX picks its Pallas kernels on its accelerator,
    else the chunked plain route ("xla"), as ``ops/attention.use_flash``
    picks K1's."""
    on_card = torch.device(device).type == "cuda"
    takes = dtype == torch.bfloat16 and hidden_size in KERNEL_DIMS
    return (max_seq_length >= FUSED_MIN_SEQ,
            "pallas" if on_card and takes else "xla")


def _process_one(processor, tokenizer, example):
    """One example's ids: the template processor's, or, when it fails
    (an audio row without an S3 checkpoint among them), the tokenized
    text (the JAX CLI's fallback)."""
    try:
        return processor.process_example(example)["input_ids"]
    except Exception:
        text = example.get("text", "").strip()
        return tokenizer.encode(text) if text else None


def _eval_split(id_lists: List[List[int]], eval_size: float):
    """(train, eval) id lists: a ``default_rng(42)`` permutation split
    before packing; ``eval_size`` below 1 is a fraction (at least one
    example), else a count."""
    if eval_size <= 0:
        return id_lists, []
    order = np.random.default_rng(42).permutation(len(id_lists))
    n_eval = max(1, int(round(len(id_lists) * eval_size))) \
        if eval_size < 1 else int(eval_size)
    return ([id_lists[j] for j in order[n_eval:]],
            [id_lists[j] for j in order[:n_eval]])


def train_stage1(config):
    from speech_distill_tpu_torch.core.checkpoint import export_hf
    from speech_distill_tpu_torch.core.config import parse_prefix
    from speech_distill_tpu_torch.core.device import resolve_device
    from speech_distill_tpu_torch.core.trainer import LoopConfig, train_loop
    from speech_distill_tpu_torch.data.processor import (
        SpeechDistillProcessor)
    from speech_distill_tpu_torch.distill import train_step
    from speech_distill_tpu_torch.models.convert import model_to_tree
    from speech_distill_tpu_torch.models.hf_loader import load_pretrained
    from speech_distill_tpu_torch.pipelines.common import (
        load_hf_dataset, load_tokenizer)
    from speech_distill_tpu_torch.tokenizer.s3 import (
        default_speech_tokens_fn)

    from speech_distill_tpu_torch.core.config import MeshConfig
    from speech_distill_tpu_torch.parallel import multihost, sharding
    from speech_distill_tpu_torch.parallel import mesh as meshlib
    sp = getattr(config, "sp", 1)
    rank_dev = None if config.device == "cuda" else config.device
    mesh = None
    if multihost.initialize(device=rank_dev) or sp > 1:
        mesh = meshlib.make_mesh(MeshConfig(tp=1, sp=sp), device=rank_dev)
        meshlib.set_active_mesh(mesh)
    dev = resolve_device(config.device) if mesh is None else mesh.device
    tokenizer = load_tokenizer(config.model_path)
    cfg, model = load_pretrained(config.model_path, device=dev)
    if sp > 1:
        cfg = dataclasses.replace(cfg, attn_impl="ring")
    old_vocab_size = cfg.vocab_size - config.num_new_tokens

    dataset = load_hf_dataset(config.dataset_path)
    processor = SpeechDistillProcessor(
        tokenizer, speech_tokens_fn=default_speech_tokens_fn(dev),
        prefix=parse_prefix(config.prefix),
        text_bos=config.text_bos, text_eos=config.text_eos,
        text_prefix=parse_prefix(config.text_prefix),
        speech_bos=config.speech_bos, speech_eos=config.speech_eos)

    def process_one(example):
        return _process_one(processor, tokenizer, example)

    if config.num_workers > 1:
        # host-side example processing in threads (reference
        # dataloader_num_workers, stage1.py:320)
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(config.num_workers) as pool:
            processed = list(pool.map(
                process_one, (dataset[i] for i in range(len(dataset)))))
    else:
        processed = [process_one(dataset[i]) for i in range(len(dataset))]
    id_lists, eval_id_lists = _eval_split(
        [ids for ids in processed if ids], config.eval_size)
    if eval_id_lists:
        print(f"Splitting dataset: {len(id_lists)} train, "
              f"{len(eval_id_lists)} eval")

    eos_id = tokenizer.eos_token_id or 0
    packed = pack_sequences(id_lists, config.max_seq_length, eos_id)
    if len(packed) == 0:
        raise ValueError("Train dataset is empty after processing!")
    print(f"Packed {len(id_lists)} examples into {len(packed)} sequences of "
          f"{config.max_seq_length}")
    eval_packed = pack_sequences(eval_id_lists, config.max_seq_length,
                                 eos_id)

    trainable = {"embed": {"weight": model.embed.detach().clone()
                           .requires_grad_(True)}}
    if model.lm_head is not None:
        trainable["lm_head"] = {"weight": model.lm_head.detach().clone()
                                .requires_grad_(True)}
    dp = mesh.dp if mesh is not None else 1
    base = model if mesh is None else sharding.shard_params(mesh, model, cfg)
    B, A = config.batch_size * dp, config.gradient_accumulation_steps
    steps = max(1, len(packed) // (B * A)) * config.num_epochs
    opt = train_step.make_optimizer(config.learning_rate,
                                    config.warmup_steps, steps,
                                    weight_decay=config.weight_decay,
                                    eight_bit=config.use_8bit_optimizer)
    state = train_step.init_state(trainable, opt)
    fused, backend = fused_route(config.max_seq_length, dev,
                                 cfg.torch_dtype, cfg.hidden_size)
    step_fn = train_step.make_stage1_step(cfg, opt, old_vocab_size,
                                          fused_loss=fused,
                                          fused_backend=backend, device=dev,
                                          mesh=mesh)
    put = None
    if mesh is not None:
        def put(batch):
            return multihost.make_global_batch(mesh, batch)
    eval_fn = None
    if len(eval_packed) > 0:
        # the eval batch rounded up to a multiple of dp (JAX)
        eb = (max(config.eval_batch_size, 1) + dp - 1) // dp * dp
        eval_fn = make_eval_fn(
            train_step.make_stage1_eval_step(cfg, device=dev, mesh=mesh),
            eval_packed, eb, base, put)

    loop_cfg = LoopConfig(
        num_epochs=config.num_epochs, logging_steps=config.logging_steps,
        save_steps=config.save_steps, output_dir=config.output_dir,
        eval_steps=config.eval_steps if eval_fn else None,
        load_best_at_end=eval_fn is not None,  # stage1.py:311
        report_to="wandb" if config.use_wandb else "none")
    state = train_loop(
        step_fn, state, (base,),
        lambda epoch: stage1_batches(packed, B, A, config.seed, epoch),
        loop_cfg, put_batch=put, eval_fn=eval_fn,
        tokens_per_batch=B * A * config.max_seq_length, device=dev,
        mesh=mesh, state_specs=(lambda st: sharding.state_pspecs(
            st, {k: {"weight": ()} for k in st.trainable}, mesh))
        if mesh is not None else None)

    # the final model: the base with the trained tables
    final = model_to_tree(model)
    for name in trainable:
        final[name] = {"weight": state.trainable[name]["weight"].detach()}
    if mesh is None or mesh.is_primary:
        out = os.path.join(config.output_dir, "final_model")
        export_hf(final, cfg, out)
        tokenizer.save_pretrained(out)
        print("Stage-1 training completed!")
    multihost.barrier()


def build_parser():
    from speech_distill_tpu_torch.pipelines.common import (add_device_arg,
                                                           add_template_args)
    p = argparse.ArgumentParser(
        description="Stage 1: Text-to-Speech Token Alignment Training")
    p.add_argument("--model_path", type=str, required=True)
    p.add_argument("--dataset_path", type=str, required=True)
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--num_epochs", type=int, default=3)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--eval_batch_size", type=int, default=8)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--warmup_steps", type=int, default=1000)
    p.add_argument("--weight_decay", type=float, default=0.01)
    p.add_argument("--gradient_accumulation_steps", type=int, default=4)
    p.add_argument("--logging_steps", type=int, default=50)
    p.add_argument("--save_steps", type=int, default=500)
    p.add_argument("--eval_steps", type=int, default=500)
    p.add_argument("--eval_size", type=float, default=0)
    p.add_argument("--max_seq_length", type=int, default=4096)
    p.add_argument("--sp", type=int, default=1,
                   help="sequence-parallel size (ring attention)")
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--num_new_tokens", type=int, default=8220)
    p.add_argument("--prefix", type=str, default="")
    add_template_args(p, teacher_prefix=False, student_prefix=False)
    p.add_argument("--gradient_checkpointing", action="store_true")
    p.set_defaults(gradient_checkpointing=True)
    p.add_argument("--use_8bit_optimizer", action="store_true")
    p.add_argument("--use_wandb", action="store_true")
    p.add_argument("--seed", type=int, default=42)
    add_device_arg(p)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)
    train_stage1(args)


if __name__ == "__main__":
    main()
