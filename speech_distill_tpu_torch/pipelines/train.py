"""Stage-2 KD training CLI (port of ``speech_distill_tpu/pipelines/train.py``;
reference train.py:119-596).

Flags match the JAX CLI 1:1, plus ``--device``; the engine underneath is
the port's KD step (``distill/train_step.make_kd_step``) in
``train_loop``. The mode follows the dataset's columns: stored top-K
("precomputed"), else the teacher runs in the step ("online_sparse", or
"online_dense" for ``--top_k`` <= 0 or a quantized teacher). The teacher
is a Qwen3 HF directory, or with ``--teacher_family cosyvoice2`` a
reference CosyVoice2 torch checkpoint (``models/cosyvoice2``: a Qwen2
backbone over the unified vocabulary).

Data and tensor parallelism run one process a device (``torchrun
--nproc_per_node N -m speech_distill_tpu_torch train --tp T ...``, or
``--coordinator_address`` / ``--num_processes`` / ``--process_id`` on each
process): dp = processes / (tp sp pp), the global batch is the
per-device batch times dp, every rank streams the global batches and
keeps its dp rows, and ``--zero1`` shards the AdamW moments over dp. The
student and a Qwen3 teacher shard over tp (a quantized or CosyVoice2
teacher is replicated whole). ``--sp`` splits each sequence over a ring
(``--sp_zigzag``: the zig-zag ring), student and teacher alike;
``--pp`` pipelines the student's stack (and a teacher's whose layer
count pp divides) in ``--pp_microbatches`` (default 2 pp) microbatches,
GPipe or ``--pp_schedule 1f1b`` (``--pp_interleave`` virtual stages).
As in JAX, sp and pp do not combine.

``--teacher_devices N`` (online sparse KD) disaggregates the teacher onto
the trailing N ranks (``distill/disaggregate``): they load only the
teacher, on a dp x ``--teacher_tp`` mesh of their own without ring or
pipeline, and serve its top-K to the student ranks, whose step (and eval
step) becomes the precomputed one; the teacher ranks return when the
student closes the stream. As in JAX it refuses dense KD and ranks on
more than one host, and ``--teacher_tp`` without it changes nothing.

Where the JAX CLI fails, this one raises ``ValueError`` before the teacher
loads: a quantized CosyVoice2 teacher, and dense KD against a CosyVoice2
teacher whose unified vocabulary is narrower than the student's.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os


def build_parser() -> argparse.ArgumentParser:
    from speech_distill_tpu_torch.pipelines.common import (add_device_arg,
                                                           add_template_args)

    p = argparse.ArgumentParser(
        description="Distill a teacher LLM into a student LLM.")
    p.add_argument("--teacher_model", type=str,
                   default="Soul-AILab/SoulX-Podcast-1.7B-dialect")
    p.add_argument("--student_model", type=str,
                   default="./pretrained_models/Qwen3-0.6B")
    p.add_argument("--dataset_path", type=str, required=True)
    p.add_argument("--output_dir", type=str, default="./distilled_model")
    p.add_argument("--max_length", type=int, default=512)
    add_template_args(p)
    p.add_argument("--use_lora", action="store_true")
    p.add_argument("--lora_r", type=int, default=32)
    p.add_argument("--lora_alpha", type=int, default=64)
    p.add_argument("--use_rslora", action="store_true")
    p.set_defaults(use_rslora=True)
    p.add_argument("--init_lora_weights", type=str, default="pissa")
    p.add_argument("--temperature", type=float, default=2.0)
    p.add_argument("--alpha", type=float, default=0.5)
    p.add_argument("--learning_rate", type=float, default=5e-5)
    p.add_argument("--num_train_epochs", type=int, default=3)
    p.add_argument("--warmup_steps", type=int, default=1000)
    p.add_argument("--bf16", action="store_true")
    p.set_defaults(bf16=True)
    p.add_argument("--gradient_checkpointing", action="store_true")
    p.set_defaults(gradient_checkpointing=True)
    p.add_argument("--test_size", type=int, default=10)
    p.add_argument("--report_to", type=str, default="none")
    p.add_argument("--top_k", type=int, default=128)
    p.add_argument("--teacher_family", type=str, default="qwen3",
                   choices=["qwen3", "cosyvoice2"],
                   help="cosyvoice2: split-embedding Qwen2 teacher over the "
                        "unified vocab (a reference torch checkpoint)")
    p.add_argument("--load_teacher_in_4bit", action="store_true")
    p.add_argument("--load_teacher_in_8bit", action="store_true")
    p.add_argument("--per_device_train_batch_size", type=int, default=4)
    p.add_argument("--gradient_accumulation_steps", type=int, default=4)
    p.add_argument("--pad_to_multiple_of", type=int, default=128)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--sp", type=int, default=1)
    p.add_argument("--sp_zigzag", action="store_true")
    p.add_argument("--pp", type=int, default=1)
    p.add_argument("--pp_microbatches", type=int, default=0)
    p.add_argument("--pp_schedule", choices=["gpipe", "1f1b"],
                   default="gpipe")
    p.add_argument("--pp_interleave", type=int, default=1)
    p.add_argument("--zero1", action="store_true")
    p.add_argument("--teacher_devices", type=int, default=0)
    p.add_argument("--teacher_tp", type=int, default=1)
    p.add_argument("--coordinator_address", type=str, default=None)
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--shuffle_buffer_size", type=int, default=0,
                   help="0: whole-epoch shuffle (exact permutation, "
                        "O(epoch) host RAM); >0: windowed shuffle buffer "
                        "(streaming, O(buffer) RAM)")
    add_device_arg(p)
    return p


def check_ported(config, mode: str = None) -> None:
    """Raise ``ValueError`` where the JAX CLI refuses (sp with pp, an
    interleave without 1F1B, ``--teacher_devices`` with dense KD: a
    quantized teacher or ``--top_k`` <= 0, under the dataset's ``mode``
    when given) or fails (a quantized CosyVoice2 teacher, on its int8
    embedding)."""
    if mode == "online_dense" and config.teacher_devices > 0:
        raise ValueError(
            "--teacher_devices streams sparse top-K artifacts; dense KD "
            "(quantized teacher or top_k<=0) must share the mesh")
    if config.sp > 1 and config.pp > 1:
        raise ValueError("--sp (ring attention) and --pp (pipeline) "
                         "cannot combine; pick one")
    if config.pp_interleave > 1 and config.pp_schedule != "1f1b":
        raise ValueError("--pp_interleave > 1 requires --pp_schedule 1f1b")
    if config.pp_schedule == "1f1b" and config.pp <= 1:
        # JAX's step raises it once the model has loaded
        raise ValueError("--pp_schedule 1f1b needs a mesh with pp > 1")
    if config.teacher_family == "cosyvoice2" and (
            config.load_teacher_in_4bit or config.load_teacher_in_8bit):
        raise ValueError("--load_teacher_in_4bit / _8bit with "
                         "--teacher_family cosyvoice2: a quantized "
                         "CosyVoice2 teacher is not supported")


def check_teacher_rows(config, ranks) -> None:
    """A disaggregated teacher extracts a batch's rows split over its dp
    (JAX shards the ids ``P("dp")``): the global batch must divide by it,
    else ``ValueError`` on every rank before any weight loads."""
    from speech_distill_tpu_torch.core.config import MeshConfig
    from speech_distill_tpu_torch.parallel.mesh import mesh_shape
    t_dp = mesh_shape(MeshConfig(tp=config.teacher_tp), len(ranks[1]))["dp"]
    s_dp = mesh_shape(MeshConfig(tp=config.tp, sp=config.sp, pp=config.pp),
                      len(ranks[0]))["dp"]
    rows = config.per_device_train_batch_size * s_dp
    if rows % t_dp:
        raise ValueError(f"a global batch of {rows} rows does not split "
                         f"over the teacher's dp={t_dp}")


def preview(tokenizer, sample) -> None:
    """The sample preview (reference train.py:383-418)."""
    s_ids = sample.get("student_input_ids", sample.get("input_ids"))
    t_ids = sample.get("teacher_input_ids")
    print("=" * 50 + "\nSAMPLE DATA PREVIEW\n" + "=" * 50)
    for what, ids in (("STUDENT", s_ids), ("TEACHER", t_ids)):
        if ids is not None:
            print(f"--- {what} INPUT ---\nText: "
                  f"{tokenizer.decode(ids[:100])} ... "
                  f"{tokenizer.decode(ids[-10:])}")
            print(f"IDs: {list(ids[:20])} ... {list(ids[-10:])}")
    print("=" * 50)


def load_teacher(path: str, quant: str, dev):
    """The teacher model, quantized as the JAX CLI quantizes it
    (``quantize_params`` at its defaults: int8 layers and table for
    "int8"; nf4 layers with an int8 embed / head for "int4")."""
    from speech_distill_tpu_torch.models.convert import (model_to_tree,
                                                         params_from_jax)
    from speech_distill_tpu_torch.models.hf_loader import load_pretrained
    from speech_distill_tpu_torch.ops.quant import quantize_params

    t_cfg, teacher = load_pretrained(path, device=dev)
    if quant == "none":
        return teacher
    tree = quantize_params(model_to_tree(teacher),
                           bits=8 if quant == "int8" else 4)
    del teacher
    return params_from_jax(tree, t_cfg, dev)


def parallel_cfg(cfg, config, teacher: bool = False):
    """A model config on the CLI's mesh: the ring (``--sp``) or the
    pipeline (``--pp``: ``--pp_microbatches``, default 2 pp; the
    student's ``--pp_interleave``). A teacher pipelines GPipe when pp
    divides its layer count, else it runs whole on every stage (the JAX
    CLI)."""
    if config.sp > 1:
        cfg = dataclasses.replace(
            cfg, attn_impl="ring_zigzag" if config.sp_zigzag else "ring")
    if config.pp > 1 and not (teacher and
                              cfg.num_hidden_layers % config.pp):
        cfg = dataclasses.replace(
            cfg, pp_microbatches=config.pp_microbatches or 2 * config.pp)
        if not teacher:
            cfg = dataclasses.replace(
                cfg, pp_interleave=max(config.pp_interleave, 1))
    return cfg


def load_teacher_model(config, quant: str, s_cfg, dcfg, dev, mesh=None):
    """The teacher of an online mode on ``dev``: a Qwen3 HF directory
    (quantized by ``--load_teacher_in_*``), or the CosyVoice2 checkpoint
    of ``--teacher_family cosyvoice2`` with its forward and (sparse) its
    extraction, on the CLI's ``mesh`` when one is given (sharded, with the
    ring or pipeline of :func:`parallel_cfg`; a CosyVoice2 teacher whole
    under tp). Returns (teacher, teacher_forward, teacher_extract)."""
    from speech_distill_tpu_torch.distill import train_step
    from speech_distill_tpu_torch.parallel import sharding
    parallel = mesh is not None and mesh.world > 1
    if config.teacher_family != "cosyvoice2":
        teacher = load_teacher(config.teacher_model, quant, dev)
        if parallel:
            teacher = sharding.shard_params(
                mesh, teacher, parallel_cfg(teacher.cfg, config,
                                            teacher=True))
        return teacher, None, None
    from speech_distill_tpu_torch.models import cosyvoice2 as cv2
    if dcfg.use_dense:
        train_step.check_width(cv2.CosyVoice2Config().unified_vocab_size,
                               s_cfg.vocab_size)
    teacher = cv2.load(config.teacher_model, dev)
    if parallel and mesh.tp == 1:
        # the ring / pipeline of the backbone (replicated whole under tp)
        bcfg = parallel_cfg(teacher.cfg.backbone, config, teacher=True)
        teacher.backbone = sharding.shard_params(mesh, teacher.backbone,
                                                 bcfg)
        teacher.cfg = dataclasses.replace(teacher.cfg, backbone=bcfg)
    extract = None
    if not dcfg.use_dense:
        extract = cv2.make_teacher_extract(
            teacher.cfg, dcfg.top_k, s_cfg.vocab_size,
            extract=dcfg.online_extract, recall=dcfg.online_topk_recall)
    return teacher, cv2.make_teacher_forward(teacher.cfg), extract


def teacher_service(config, dcfg, ranks, t_mesh, student_model: str):
    """Every rank's part of the disaggregated teacher
    (``disaggregate.make_teacher_service``): the teacher ranks load the
    teacher on their mesh (sharded over its tp; a CosyVoice2 teacher
    whole, as under ``--tp``), the student ranks nothing."""
    from speech_distill_tpu_torch.distill import disaggregate
    from speech_distill_tpu_torch.models.hf_loader import config_from_hf
    with open(os.path.join(student_model, "config.json")) as f:
        s_cfg = config_from_hf(json.load(f))
    teacher = extract = None
    if t_mesh is not None:
        teacher, _, extract = load_teacher_model(config, "none", s_cfg,
                                                 dcfg, t_mesh.device)
    svc = disaggregate.make_teacher_service(
        teacher, None, t_mesh, top_k=dcfg.top_k,
        student_vocab_size=s_cfg.vocab_size,
        method=dcfg.online_topk_method, recall=dcfg.online_topk_recall,
        extract_fn=extract, shard=config.teacher_family == "qwen3",
        ranks=ranks)
    if svc.is_teacher:
        print(f"Disaggregated teacher: ranks {ranks[1]} (mesh "
              f"{t_mesh.shape}), student ranks {ranks[0]}")
    return svc


def train(config) -> None:
    from speech_distill_tpu_torch.core.config import (DistillConfig,
                                                      LoraConfig, MeshConfig)
    from speech_distill_tpu_torch.distill import disaggregate
    from speech_distill_tpu_torch.parallel import multihost
    from speech_distill_tpu_torch.parallel import mesh as meshlib
    from speech_distill_tpu_torch.pipelines.common import load_hf_dataset

    check_ported(config)
    # one process a device: the rank's card (cuda:LOCAL_RANK) unless
    # --device names another
    rank_dev = None if config.device == "cuda" else config.device
    multihost.initialize(config.coordinator_address, config.num_processes,
                         config.process_id, device=rank_dev)
    meshlib.rank_device(rank_dev)        # raises without CUDA
    dataset = load_hf_dataset(config.dataset_path)
    is_preprocessed = ("student_input_ids" in dataset.column_names
                       and "teacher_input_ids" in dataset.column_names)
    has_topk = "teacher_top_k_v" in dataset.column_names

    quant = ("int4" if config.load_teacher_in_4bit
             else "int8" if config.load_teacher_in_8bit else "none")
    dcfg = DistillConfig(
        temperature=config.temperature, alpha=config.alpha,
        top_k=config.top_k, teacher_quant=quant,
        learning_rate=config.learning_rate,
        num_train_epochs=config.num_train_epochs,
        warmup_steps=config.warmup_steps,
        per_device_batch_size=config.per_device_train_batch_size,
        gradient_accumulation_steps=config.gradient_accumulation_steps,
        pad_to_multiple_of=config.pad_to_multiple_of,
        shuffle_buffer_size=config.shuffle_buffer_size,
        lora=LoraConfig(use_lora=config.use_lora, r=config.lora_r,
                        alpha=config.lora_alpha,
                        use_rslora=config.use_rslora,
                        init_weights=config.init_lora_weights))
    mode = "precomputed" if has_topk else (
        "online_dense" if dcfg.use_dense else "online_sparse")
    check_ported(config, mode)
    # a disaggregated teacher (online KD only, as in JAX): the trailing
    # ranks, every rank building both meshes
    ranks = t_mesh = service = None
    if config.teacher_devices > 0 and mode != "precomputed":
        multihost.check_single_host()
        ranks = disaggregate.split_devices(config.teacher_devices)
        check_teacher_rows(config, ranks)
        t_mesh = meshlib.make_mesh(MeshConfig(tp=config.teacher_tp),
                                   device=rank_dev, ranks=ranks[1])
    mesh = meshlib.make_mesh(MeshConfig(tp=config.tp, sp=config.sp,
                                        pp=config.pp), device=rank_dev,
                             ranks=ranks[0] if ranks else None)
    if ranks is not None:
        service = teacher_service(config, dcfg, ranks, t_mesh,
                                  config.student_model)
        if service.is_teacher:
            service.serve()
            return
    try:
        _train_student(config, dcfg, mode, quant, dataset, is_preprocessed,
                       mesh, service)
    finally:
        if service is not None:
            service.close()     # the teacher ranks return, after a raise too


def _train_student(config, dcfg, mode, quant, dataset, is_preprocessed,
                   mesh, service) -> None:
    """The student ranks' part of :func:`train` (every rank without a
    disaggregated teacher): load, train, evaluate and export."""
    import torch
    from speech_distill_tpu_torch.core.checkpoint import export_hf
    from speech_distill_tpu_torch.core.config import parse_prefix
    from speech_distill_tpu_torch.core.trainer import (LoopConfig,
                                                       batches_from,
                                                       train_loop)
    from speech_distill_tpu_torch.data.collator import DistillCollator
    from speech_distill_tpu_torch.data.template import align_prefixes
    from speech_distill_tpu_torch.distill import disaggregate, train_step
    from speech_distill_tpu_torch.distill.lora import (init_lora,
                                                       merge_and_export)
    from speech_distill_tpu_torch.models.hf_loader import load_pretrained
    from speech_distill_tpu_torch.parallel import multihost, sharding
    from speech_distill_tpu_torch.parallel import mesh as meshlib
    from speech_distill_tpu_torch.pipelines.common import load_tokenizer
    from speech_distill_tpu_torch.pipelines.prepare_dataset import (
        make_dual_processor)

    meshlib.set_active_mesh(mesh)
    parallel = mesh.world > 1
    dev = mesh.device
    tokenizer = load_tokenizer(config.student_model, config.pad_token)
    teacher_prefix, student_prefix = align_prefixes(
        parse_prefix(config.teacher_prefix),
        parse_prefix(config.student_prefix), tokenizer)

    if config.test_size > 0 and len(dataset) > config.test_size:
        split = dataset.train_test_split(test_size=config.test_size, seed=42)
        dataset, eval_dataset = split["train"], split["test"]
    else:
        eval_dataset = None

    if not is_preprocessed:
        dual = make_dual_processor(
            tokenizer, teacher_prefix, student_prefix, config, device=dev)
        dataset = dataset.map(dual, batched=True, desc="process")
    preview(tokenizer, dataset[0])

    s_cfg, student = load_pretrained(config.student_model, device=dev)
    s_cfg = parallel_cfg(s_cfg, config)
    teacher = teacher_forward = teacher_extract = None
    if mode != "precomputed" and service is None:
        teacher, teacher_forward, teacher_extract = load_teacher_model(
            config, quant, s_cfg, dcfg, dev, mesh)
    # a disaggregated teacher streams the top-K in: the precomputed steps
    step_mode = "precomputed" if service is not None else mode

    if config.use_lora:
        gen = torch.Generator().manual_seed(dcfg.seed)
        trainable, base = init_lora(student, s_cfg, dcfg.lora, gen,
                                    device=dev)
    else:
        base = student
    base_full = base if config.use_lora else None   # whole, for the export
    if parallel:
        base = sharding.shard_params(mesh, base, s_cfg)
        if config.use_lora:
            trainable = sharding.shard_lora(mesh, trainable, s_cfg)
    if not config.use_lora:
        # full finetuning: the model's weights are the trainable tree
        trainable = train_step.full_trainable(base)
    specs = sharding.trainable_pspecs(trainable, s_cfg, config.use_lora,
                                      mesh)

    global_batch = dcfg.per_device_batch_size * mesh.dp
    A = dcfg.gradient_accumulation_steps
    steps_per_epoch = len(dataset) // (global_batch * A)
    total_steps = config.max_steps or steps_per_epoch * dcfg.num_train_epochs
    opt = train_step.make_optimizer(dcfg.learning_rate, dcfg.warmup_steps,
                                    total_steps)
    state = train_step.init_state(trainable, opt)
    step_mesh = mesh if parallel else None
    if parallel:
        state = state._replace(opt_state=sharding.shard_opt_state(
            mesh, state.opt_state, specs, zero1=config.zero1))
    step_fn = train_step.make_kd_step(
        s_cfg, dcfg, opt, mode=step_mode, teacher_forward=teacher_forward,
        teacher_extract=teacher_extract, use_lora=config.use_lora,
        pp_schedule=config.pp_schedule, device=dev, mesh=step_mesh,
        zero1=config.zero1 and parallel)

    collator = DistillCollator(
        pad_token_id=tokenizer.pad_token_id,
        speech_bos_id=tokenizer.encode(
            config.speech_bos, add_special_tokens=False)[0],
        pad_to_multiple_of=dcfg.pad_to_multiple_of)

    def teacher_stream(it):
        return it if service is None else \
            disaggregate.pipeline_batches(it, service)

    def batch_iter(epoch):
        return teacher_stream(batches_from(
            (dataset[i] for i in range(len(dataset))), collator,
            global_batch, A, shuffle_seed=dcfg.seed, epoch=epoch,
            shuffle_buffer=dcfg.shuffle_buffer_size or None))

    loop_cfg = LoopConfig(
        num_epochs=dcfg.num_train_epochs, max_steps=config.max_steps,
        logging_steps=dcfg.logging_steps, output_dir=config.output_dir,
        report_to=config.report_to, save_total_limit=dcfg.save_total_limit)

    eval_fn = None
    if eval_dataset is not None and len(eval_dataset) > 0:
        if not is_preprocessed:
            eval_dataset = eval_dataset.map(dual, batched=True, desc="eval")
        eval_step = train_step.make_kd_eval_step(
            s_cfg, dcfg, mode=step_mode, teacher_forward=teacher_forward,
            use_lora=config.use_lora, device=dev, mesh=step_mesh)

        def eval_fn(state):
            totals, n = None, 0
            for hb in teacher_stream(batches_from(
                    (eval_dataset[i] for i in range(len(eval_dataset))),
                    collator, global_batch, 1, drop_last=False)):
                if parallel:
                    hb = multihost.make_global_batch(mesh, hb)
                m = {k: float(v) for k, v in eval_step(
                    state.trainable, base, teacher, hb).items()}
                totals = m if totals is None else \
                    {k: totals[k] + m[k] for k in m}
                n += 1
            return {k: v / max(n, 1) for k, v in totals.items()} \
                if totals else {}

    state = train_loop(
        step_fn, state, (base, teacher), batch_iter, loop_cfg,
        eval_fn=eval_fn,
        # as the JAX CLI counts it: the padding multiple, not the length
        tokens_per_batch=global_batch * A * dcfg.pad_to_multiple_of,
        device=dev, mesh=step_mesh,
        state_specs=lambda st: sharding.state_pspecs(
            st, specs, mesh, zero1=config.zero1))
    # the merged model for HF consumers (the ranks' slices made whole;
    # the primary writes)
    trainable = multihost.fetch_replicated(state.trainable, specs, step_mesh)
    if mesh.is_primary:
        out = os.path.join(config.output_dir, "final_model")
        final = (merge_and_export(base_full, trainable, dcfg.lora)
                 if config.use_lora else trainable)
        export_hf(final, s_cfg, out)
        tokenizer.save_pretrained(out)
        print("Training complete.")
    multihost.barrier(mesh)


def main(argv=None):
    train(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
