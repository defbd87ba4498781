"""Distilled-model quality evaluation CLI (port of
``speech_distill_tpu/pipelines/evaluate.py``).

Measures the distilled student on held-out data: teacher-student top-1 /
top-K agreement, KL(teacher||student) at T = 1 and student / teacher CE,
each over speech-token positions and over all attended positions
(``distill/evaluate.py``), and an optional end-to-end audio smoke: the
student generates speech tokens under the production RAS sampler
(``infer/engine.DecodeEngine``) and drives the flow and HiFT; the wav must
have the exact expected length, be finite and carry energy. Writes one
JSON report per checkpoint.

    python -m speech_distill_tpu_torch evaluate \\
        --student_model distilled_model/final_model \\
        --dataset_path processed_dataset [--smoke]

A dataset with ``teacher_top_k_v/i`` columns (the extract-logits output)
needs no teacher: the metrics run against the stored top-K. ``--test_size``
replays the train CLI's held-out split (same seed). ``--dp`` / ``--tp``:
one process a device (``torchrun --nproc_per_node N``); each dp rank
scores its rows of every batch, the sums are added over dp, the student
and a Qwen3 teacher shard over tp, and the primary writes the report.
A CosyVoice2 teacher (``--teacher_family
cosyvoice2``, a reference torch checkpoint) runs where its unified
vocabulary is at least as wide as the student's, as in JAX; a narrower
one raises ``ValueError`` before it loads.
"""
from __future__ import annotations

import argparse
import json
import os


def build_parser() -> argparse.ArgumentParser:
    from speech_distill_tpu_torch.pipelines.common import (add_device_arg,
                                                           add_template_args)

    p = argparse.ArgumentParser(
        description="Evaluate a distilled student against its teacher.")
    p.add_argument("--student_model", type=str, required=True,
                   help="distilled checkpoint dir (train CLI final_model)")
    p.add_argument("--teacher_model", type=str, default=None,
                   help="teacher checkpoint; omit when the dataset carries "
                        "stored teacher_top_k_v/i artifacts")
    p.add_argument("--teacher_family", type=str, default="qwen3",
                   choices=["qwen3", "cosyvoice2"],
                   help="cosyvoice2: a reference CosyVoice2 torch "
                        "checkpoint over the unified vocab")
    p.add_argument("--dataset_path", type=str, required=True)
    p.add_argument("--max_length", type=int, default=512)
    add_template_args(p)
    p.add_argument("--test_size", type=int, default=10,
                   help="held-out rows, split with the train CLI's seed so "
                        "this is the data the checkpoint never saw "
                        "(0: evaluate the whole dataset)")
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--max_batches", type=int, default=0, help="0 = all")
    p.add_argument("--agree_k", type=int, default=10,
                   help="K for top-K agreement")
    p.add_argument("--pad_to_multiple_of", type=int, default=128)
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel size")
    p.add_argument("--dp", type=int, default=0,
                   help="data-parallel size (0: the processes / tp)")
    p.add_argument("--output", type=str, default=None,
                   help="JSON artifact path (default: "
                        "<student_model>/eval_quality.json)")
    # ---- e2e audio smoke -------------------------------------------------
    p.add_argument("--smoke", action="store_true",
                   help="generate speech tokens from the student (RAS "
                        "sampler) and synthesize a wav through flow+HiFT; "
                        "checks duration/finiteness/energy")
    p.add_argument("--smoke_max_tokens", type=int, default=60)
    p.add_argument("--flow_model", type=str, default=None,
                   help="flow.pt torch checkpoint (omit: randomly "
                        "initialized flow — plumbing/duration check only)")
    p.add_argument("--hift_model", type=str, default=None)
    p.add_argument("--smoke_tiny", action="store_true",
                   help="scaled-down random flow/HiFT (test rigs)")
    p.add_argument("--smoke_wav", type=str, default=None,
                   help="also write the smoke wav here")
    add_device_arg(p)
    return p


def smoke_flow_hift(config, flow_vocab: int, dev):
    """(flow_cfg, flow, hift_cfg, hift, flow_src, hift_src): the full-size
    (or ``--smoke_tiny``) flow and HiFT, from reference checkpoints when
    given, else random with the JAX package's weights."""
    import torch
    from speech_distill_tpu_torch.models import flow as flow_lib
    from speech_distill_tpu_torch.models import flow_encoder
    from speech_distill_tpu_torch.models import hift as hift_lib
    from speech_distill_tpu_torch.models.convert import load_reference_state

    if config.smoke_tiny:
        enc = flow_encoder.FlowEncoderConfig(
            input_size=16, output_size=16, attention_heads=2,
            linear_units=32, num_blocks=1, num_up_blocks=1)
        flow_cfg = flow_lib.FlowConfig(
            input_size=16, output_size=8, spk_embed_dim=6,
            vocab_size=max(flow_vocab, 2), n_timesteps=2,
            est_in_channels=32, est_channels=16, est_n_blocks=1,
            est_num_mid_blocks=1, est_num_heads=2, est_head_dim=8,
            encoder=enc)
        hift_cfg = hift_lib.HiFTConfig(
            in_channels=8, base_channels=16, nb_harmonics=2,
            resblock_kernel_sizes=(3,), resblock_dilations=((1,),),
            source_resblock_kernel_sizes=(3, 3, 3),
            source_resblock_dilations=((1,), (1,), (1,)),
            f0_cond_channels=8)
    else:
        flow_cfg = flow_lib.FlowConfig()
        hift_cfg = hift_lib.HiFTConfig()

    def read(path):
        return torch.load(path, map_location="cpu", weights_only=True)

    if config.flow_model:
        flow = load_reference_state(flow_lib.Flow(flow_cfg, dev),
                                    read(config.flow_model))
        flow_src = "checkpoint"
    else:
        flow = flow_lib.init_params(flow_cfg, 0, dev)
        flow_src = "random"
    if config.hift_model:
        hift = load_reference_state(
            hift_lib.HiFTGenerator(hift_cfg, dev),
            hift_lib.fold_weight_norm(read(config.hift_model)))
        hift_src = "checkpoint"
    else:
        hift = hift_lib.init_params(hift_cfg, 0, dev)
        hift_src = "random"
    return flow_cfg, flow, hift_cfg, hift, flow_src, hift_src


def run_smoke(config, s_cfg, student, prompt_ids, dev) -> dict:
    """End-to-end audio smoke: student decode -> flow -> HiFT -> checks
    (reference anchor: the forward_tts chain, soulxpodcast.py:145-250).
    The sampler is the production one (RAS, the reference defaults with
    the model's stop token)."""
    import numpy as np
    import torch
    from speech_distill_tpu_torch.core.config import SamplingParams
    from speech_distill_tpu_torch.infer.engine import DecodeEngine
    from speech_distill_tpu_torch.models import flow as flow_lib
    from speech_distill_tpu_torch.models import hift as hift_lib

    eos = s_cfg.eos_token_id
    sp = SamplingParams(max_tokens=config.smoke_max_tokens,
                        stop_token_ids=(eos,),
                        top_k=min(100, s_cfg.vocab_size))
    max_len = 1 << (len(prompt_ids)
                    + config.smoke_max_tokens + 1).bit_length()
    eng = DecodeEngine(student, s_cfg, sp, max_len=max(max_len, 512),
                       prefill_bucket=16, cache_dtype=torch.float32,
                       device=dev)
    gen = eng.generate([int(t) for t in prompt_ids])["token_ids"]
    offset = s_cfg.speech_token_offset
    flow_tokens = [t - offset for t in gen if t >= offset and t != eos]
    result = {"generated_tokens": len(gen),
              "speech_tokens": len(flow_tokens)}
    if not flow_tokens:
        result["status"] = "no_speech_tokens"
        return result

    flow_cfg, flow, hift_cfg, hift, fsrc, hsrc = smoke_flow_hift(
        config, max(flow_tokens) + 1, dev)
    flow_tokens = [min(t, flow_cfg.vocab_size - 1) for t in flow_tokens]
    n = len(flow_tokens)
    mels, _ = flow_lib.forward_flow(
        flow, torch.tensor([flow_tokens], device=dev),
        torch.tensor([n], device=dev),
        torch.zeros((1, 0, flow_cfg.output_size), device=dev),
        torch.zeros((1,), dtype=torch.int64, device=dev),
        torch.ones((1, flow_cfg.spk_embed_dim), device=dev), flow_cfg,
        generator=torch.Generator(device=dev).manual_seed(0))
    wav, _ = hift_lib.forward(
        hift, mels, hift_cfg,
        generator=torch.Generator(device=dev).manual_seed(3))
    wav = wav[0].float().cpu().numpy()
    expected = n * flow_cfg.token_mel_ratio * hift_cfg.upsample_scale
    rms = float(np.sqrt(np.mean(np.square(wav)))) if wav.size else 0.0
    finite = bool(np.isfinite(wav).all())
    result.update({
        "flow_weights": fsrc, "hift_weights": hsrc,
        "wav_samples": int(wav.shape[0]),
        "expected_samples": int(expected),
        "duration_s": wav.shape[0] / hift_cfg.sampling_rate,
        "rms": rms,
        "finite": finite,
        "duration_exact": int(wav.shape[0]) == int(expected),
        "status": "ok" if (finite and rms > 1e-6
                           and wav.shape[0] == expected) else "failed",
    })
    if config.smoke_wav:
        from scipy.io.wavfile import write as wav_write
        wav_write(config.smoke_wav, hift_cfg.sampling_rate,
                  (np.clip(wav, -1, 1) * 32767).astype(np.int16))
    return result


def evaluate(config) -> dict:
    import numpy as np
    import torch
    from speech_distill_tpu_torch.core.config import parse_prefix
    from speech_distill_tpu_torch.data.collator import DistillCollator
    from speech_distill_tpu_torch.data.template import align_prefixes
    from speech_distill_tpu_torch.distill import evaluate as ev
    from speech_distill_tpu_torch.models.hf_loader import load_pretrained
    from speech_distill_tpu_torch.pipelines.common import (load_hf_dataset,
                                                           load_tokenizer)

    from speech_distill_tpu_torch.core.config import MeshConfig
    from speech_distill_tpu_torch.parallel import comm, multihost, sharding
    from speech_distill_tpu_torch.parallel import mesh as meshlib

    # one process a device (torchrun, or the SDT_* variables): dp x tp
    # ranks, dp = processes / tp unless --dp says it
    rank_dev = None if config.device == "cuda" else config.device
    multihost.initialize(device=rank_dev)
    mesh = meshlib.make_mesh(MeshConfig(dp=config.dp or -1, tp=config.tp),
                             device=rank_dev)
    meshlib.set_active_mesh(mesh)
    parallel = mesh.world > 1
    dev = mesh.device
    if config.batch_size % mesh.dp:
        raise ValueError(f"--batch_size {config.batch_size} must divide "
                         f"by dp={mesh.dp}")
    tokenizer = load_tokenizer(config.student_model, config.pad_token)
    dataset = load_hf_dataset(config.dataset_path)
    is_preprocessed = "student_input_ids" in dataset.column_names \
        or "input_ids" in dataset.column_names
    has_topk = "teacher_top_k_v" in dataset.column_names

    # replay the train CLI's split (same seed): truly held-out rows
    if config.test_size > 0 and len(dataset) > config.test_size:
        dataset = dataset.train_test_split(
            test_size=config.test_size, seed=42)["test"]

    if not is_preprocessed:
        from speech_distill_tpu_torch.pipelines.prepare_dataset import (
            make_dual_processor)
        teacher_prefix, student_prefix = align_prefixes(
            parse_prefix(config.teacher_prefix),
            parse_prefix(config.student_prefix), tokenizer)
        dual = make_dual_processor(tokenizer, teacher_prefix,
                                   student_prefix, config, device=dev)
        dataset = dataset.map(dual, batched=True, desc="process")

    s_cfg, student = load_pretrained(config.student_model, device=dev)
    student_full = student
    if parallel:
        student = sharding.shard_params(mesh, student, s_cfg)
    mode = "precomputed" if has_topk else "online"
    teacher = None
    if mode == "online":
        if not config.teacher_model:
            raise ValueError("--teacher_model required (dataset has no "
                             "stored teacher_top_k_v/i artifacts)")
        teacher_forward = None
        if config.teacher_family == "cosyvoice2":
            from speech_distill_tpu_torch.models import cosyvoice2 as cv2
            from speech_distill_tpu_torch.distill.train_step import (
                check_width)
            check_width(cv2.CosyVoice2Config().unified_vocab_size,
                        s_cfg.vocab_size)
            teacher = cv2.load(config.teacher_model, dev)
            t_cfg = teacher.cfg.backbone
            teacher_forward = cv2.make_teacher_forward(teacher.cfg)
        else:
            t_cfg, teacher = load_pretrained(config.teacher_model,
                                             device=dev)
            if parallel:
                teacher = sharding.shard_params(mesh, teacher, t_cfg)
        step = ev.make_agreement_step(s_cfg, t_cfg, k=config.agree_k,
                                      teacher_forward=teacher_forward,
                                      device=dev)
    else:
        step = ev.make_sparse_agreement_step(s_cfg, k=config.agree_k,
                                             device=dev)

    collator = DistillCollator(
        pad_token_id=tokenizer.pad_token_id,
        speech_bos_id=tokenizer.encode(
            config.speech_bos, add_special_tokens=False)[0],
        pad_to_multiple_of=config.pad_to_multiple_of,
        emit_speech_mask=True)

    sums, n_batches, n_rows = None, 0, 0
    bs = config.batch_size
    for i0 in range(0, len(dataset) - bs + 1, bs):
        batch = collator([dataset[i] for i in range(i0, i0 + bs)])
        if parallel:
            batch = sharding.shard_batch(mesh, batch, microbatched=False)
        s = (step(student, teacher, batch) if mode == "online"
             else step(student, batch))
        # each dp rank's rows' sums, added
        s = {k: float(comm.all_reduce(torch.as_tensor(v, device=dev),
                                      mesh.group("dp")))
             for k, v in s.items()}
        sums = s if sums is None else {k: sums[k] + s[k] for k in s}
        n_batches += 1
        n_rows += bs
        if config.max_batches and n_batches >= config.max_batches:
            break
    if sums is None:
        raise ValueError(f"dataset has fewer than {bs} rows")

    report = {
        "student_model": config.student_model,
        "teacher_model": config.teacher_model,
        "dataset": config.dataset_path,
        "mode": mode,
        "rows": n_rows,
        "metrics": ev.finalize_metrics(sums, config.agree_k),
    }

    if config.smoke:
        # prompt = the first held-out row's student ids up to (and with)
        # the speech span's start: the production generation prompt
        row = dataset[0]
        ids = row.get("student_input_ids", row.get("input_ids"))
        m = np.asarray(collator([row])["speech_token_mask"][0])
        nz = np.nonzero(m)[0]
        cut = int(nz[0]) + 1 if nz.size else len(ids)
        report["smoke"] = run_smoke(config, s_cfg, student_full, ids[:cut],
                                    dev)

    if not mesh.is_primary:
        return report
    out_path = config.output or os.path.join(
        config.student_model, "eval_quality.json")
    with open(out_path, "w") as f:
        json.dump(report, f, indent=2)
    m = report["metrics"]
    k = config.agree_k
    for sl in ("all", "speech"):
        d = m[sl]
        if d["positions"]:
            ce = d["student_ce"] if d["student_ce"] is not None \
                else float("nan")
            print(f"[{sl}] n={d['positions']} "
                  f"top1={d['top1_agreement']:.4f} "
                  f"top{k}={d[f'top{k}_agreement']:.4f} "
                  f"kl={d['kl_t1']:.4f} ce_s={ce:.4f}")
    if "smoke" in report:
        print(f"[smoke] {report['smoke'].get('status')} "
              f"({report['smoke'].get('speech_tokens', 0)} speech tokens, "
              f"{report['smoke'].get('duration_s', 0):.2f}s)")
    print(f"Wrote {out_path}")
    return report


def main(argv=None):
    return evaluate(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
