#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

1. Records the card (nvidia-smi name and power limit).
2. Builds the hand-written CUDA kernels from speech_distill_tpu_torch/csrc
   (one nvcc per source, all started together).
3. Serves 16 seeded requests through ``PagedEngine`` on the full-width
   Qwen3-0.6B student (random weights from a seed; the default sampler),
   and fails unless both serving kernels were launched during the serve;
   a profile of a decode-heavy serve fails unless K4 ran 28 times a
   decode step by kernel name.
3b. The feature serve: 24 seeded requests arriving open-loop over ~2 s
   (16 short, 4 of 1,200-1,900 tokens prefilled in 512-token pieces, 4
   with an expired TTFT deadline) through an engine with every serving
   feature on (EDF admission with shedding, chunked prefill, the early
   chunk exit, per-request sampling overrides on half the requests,
   streamed logprobs, ``on_chunk``, the native runtime) and a pool small
   enough to preempt; fails unless exactly the 4 are shed, the streams
   equal the outputs and logprobs, the logprobs are finite and <= 0, the
   pieces, preemption and K4 counts hold and K1-fwd ran. Then one long
   prompt's last logits after chunked and whole-prompt prefill (bf16 and
   fp32) against the fp32 whole prompt, and the registry's host time,
   native against Python, over the phase's prompts.
3c. The TTS serve: ``MultiSessionTTS`` over ``PagedEngine`` (8 slots,
   chunk_steps 16, logprobs) on the same student with the full-size flow
   and HiFT (random weights, fp32, TF32 off): 8 sessions (six 128-token
   LLM prompts, two of 700 and 1,000 tokens; 75-token flow prompts, 150
   prompt mel frames padded to 160), 100 tokens each (bench: 150), the
   confidence gate
   at -3.0; generated ids are folded into the flow's speech range by a
   thin adapter. Fails unless every wav is finite and (2 n_tok - 150) x
   480 samples long, the streamed chunks make the wav, every session gave
   >= 2 chunks, the streamed tokens equal the outputs, K4 ran exactly 28
   a decode step and K1-fwd 28 a fresh long admission, and the gate
   deferred. Logs x-realtime, TTFA, LLM tokens/s, tick ms by row count,
   the decode stall a tick and device memory. Then session 0 replayed
   alone against its batched row, and a 100-token stream through the
   incremental flow (fp32 caches) against the recompute (mel error and
   each chunk's ms), and a profile of an 8-row flow and HiFT tick.
3d. The contiguous-cache engines on the JAX benchmark's decode modes,
   bf16 caches: ``DecodeEngine`` B 1 (128-token prompt, 64 tokens, the
   default sampler) with a profile of its step; greedy speculative
   decoding (gamma 7, a repetitive motif prompt: the plain decode and
   the ngram draft over 64 tokens, layer_skip over 7 layers for 32);
   ``generate_batch`` of 16 prompts with a 700-token shared prefix (64
   tokens; with the prefix cache and without); ``ContinuousEngine`` (16
   slots, 16 + 2 long requests); ``stream_tts`` over ``DecodeEngine``
   (51 tokens) with the full-size flow and HiFT, recompute and
   incremental. (Cut in depth from 256 / 256 / 64 / 128 / 32 + 2 / 151
   to keep the smoke inside its limit; the fp32 greedy gates run 64
   tokens, from 128.) Fails
   unless K1-fwd ran 28 times a flash-width prefill (the prefix, the
   two long admissions) and K3 and K4 never, the wavs are finite and
   of the expected length and the streamed tokens equal ``generate``;
   then, on the model upcast to fp32, the drafts' greedy streams must
   equal the plain decode's and the first continuous requests their
   streams decoded alone.
4. Holds each serving kernel against its plain PyTorch version on the
   card at the serving path's shapes, and times kernel, plain version,
   bound and (for flash attention) the library SDPA call as a yardstick;
   K4, K4-int8 (with their split plan and GB/s), K1 (fwd, dq, dkv) and
   SDPA (forward, backward) by CUDA-graph replays, here and at the KD and
   stage-1 shapes. Fails if ptxas reports a spill in ``paged_decode``.
5. Teacher-forces decode steps of ``paged_forward`` through the kernel and
   through the plain version, and compares the logits.
5b. Quantized serving: the same model quantized to int4 projections and
   an int8 tied embedding/head, served from an int8 page pool with the
   same traffic in 512-token prefill pieces with logprobs; fails unless
   K3 (``int4_matmul``) and K4-int8 (``paged_decode_int8``) ran exactly
   7 x 28 a model forward (prefill pieces included) and 28 a decode
   step, the pieces ran and the logprobs are finite and <= 0, and a profile of the quantized decode with K3's and
   K4-int8's kernel time a step by kernel name (K4-int8: 28 launches).
   Then K3 against its plain version at M 16 and 1,024 on the q, o, gate
   and down codes (device times beside cuBLAS), K4-int8 at K4's check
   shape, and decode logits of the kernel and plain routes against an
   fp32 reference on the same codes.
5c. The decoder layer's elementwise kernels (``ops/fused_norm``:
   RMSNorm, q/k RMSNorm + RoPE, SwiGLU, forward and backward) alone at
   the stage-1 (16 x 4,096 tokens) and KD (32 x 512) shapes, the serve's
   decode step (16 slots x T 1) and a 1,024-wide prefill: each held to
   its plain version, timed by CUDA-graph replays beside its byte bound
   and the eager chain the model ran before (forward, and its autograd
   backward), then the host microseconds of a routed call at one token,
   kernel against eager. Every phase that counts
   launches pins these kernels' counts too (``fused_launches``): 2 L + 1
   RMSNorm, L q/k norm + RoPE and L SwiGLU launches a forward of L
   layers, the matching backward launches a training step; none where a
   path runs fp32.
6. Trains: PiSSA LoRA on the same full-width model, ``make_kd_step(mode=
   "precomputed")`` in ``train_loop`` over seeded synthetic batches (B 8,
   T 512, K 128), with checkpoints; fails unless the flash forward and
   backward kernels ran exactly as often as the step's layers say, the
   losses are finite, the base stayed frozen and the adapters moved. Then
   a short loop on one repeated batch, whose loss must fall.
7. Holds K1-fwd and the backward kernels (K1-dq, K1-dkv) against their
   plain versions at the step's shape and times them beside SDPA.
8. Loss and gradients of the KD step at reduced depth through the kernel
   route and the plain route in bf16, against the plain route in fp32.
9. Two KD steps with ``fused_loss=True, fused_backend="pallas"`` (the K2
   kernels) on one batch, held to the default fused-head route.
9a. The remat policies: 2 KD steps (B 8, T 512, K 128) from phase 6's
   LoRA under "full", "dots", "half" and "everything" and without remat;
   fails unless K1-fwd ran 56 / 56 / 42 / 28 / 28 a step and K1-dq /
   dkv 28, nothing else, and the losses, grad norms and adapters equal
   "full"'s (bit for bit, else within 1e-6); logs each policy's peak
   memory and step ms. (``split_apply=True`` builds the same eager step
   as the monolithic one, so no run holds one against the other.)
10. Stage 1 at the reference CLI's defaults on a fresh full-width model:
   ``make_stage1_step`` (fused CE through K2) in ``train_loop`` for 4
   steps of B 4, T 4096, A 4 over packed seeded speech-token data, one
   eval with ``make_stage1_eval_step`` and load-best; fails unless the
   launch counts are exact, the losses finite, the old embedding rows
   equal their start less AdamW's decay, the base bit-equal and a new row
   moved. Then a profile of one stage-1 step.
11. Holds K2 (stats, dh, dW) against the plain versions at V 159,488,
   D 1024, at N 4096 and at the stage-1 microbatch's N 16,380, and times
   them at N 16,380 beside cuBLAS: h W^T for stats, that product followed
   by the product with W (dh) or, transposed, with h (dW).
12. The stage-1 gradient of the embedding at 4 layers, B 1, T 4096 through
   the kernel route and the plain route in bf16, against fp32.
13. K1 (fwd, dq, dkv) at the stage-1 microbatch's shape: against the plain
   versions at B 1, T 4096, timed at B 4 beside SDPA.
14. Prints the kernels JSON line (K1-fwd once for each of the serve, KD,
   stage-1 and CosyVoice2 teacher shapes; each entry with its launches
   in every CLI of phase 15, ``cli_launches``, in phase 17's runs,
   ``cosyvoice2_launches``, in each run of phase 16,
   ``synthesize_launches``, and in each rank's runs of phase 18,
   ``parallel_launches``), then the result line, after phase 18.
15. The distillation CLIs end to end, each through its ``main`` in this
   process at the full width (random weights): a student HF directory at
   Qwen3-0.6B's vocab of 151,936 and a teacher tokenizer of 159,488 ids
   (the speech tokens at the config's offset), a raw dataset of 100 rows
   with codes; prepare-student (matched rows equal, vocab 159,488),
   stage1 (B 4, T 4096, A 1, 2 steps and an eval; exact K2 and K1 counts,
   only the embedding changed, new rows moved), prepare-dataset,
   extract-logits with the stage-1 model as teacher (K 128, B 8, padded
   to 512; K1-fwd 28 a batch, every row's length, values finite and
   <= 0), train precomputed with PiSSA (4 steps; exact K1 counts, finite
   losses, final_model == merge_and_export of the trained state in bf16),
   evaluate with the full-size audio smoke (exact K1 count, finite
   metrics, the wav's exact sample count), train online sparse (2 steps;
   K1 in teacher and student), and ``python -m speech_distill_tpu_torch``
   (help lists seven commands, an unknown one exits 1). Logs each CLI's
   seconds, the HF export and load GB/s and the CLI rates beside phases
   6, 9b and 10's.
16. Synthesis: ``synthesize.main`` three times in this process at full width
   (random weights from SEED): a model directory with the 1.7B as bf16
   safetensors, phase 15's 159,488-id tokenizer, the full-size flow and
   HiFT, the reference v2 S3 tokenizer (~0.5 GB fp32) and the published
   CAM++; two seeded int16 prompt wavs (8 s at 44.1 kHz, 9 s at 24 kHz:
   200 and 225 codes, so the first turn's prefill is a 512-token flash
   width) and a two-turn two-speaker script, each turn capped at
   SYN_TURN_TOKENS through the run's EngineConfig. The CLI's default
   (the contiguous engine, offline), the same engine with
   ``--streaming``, then ``--llm_engine paged`` offline, with the
   process's default TF32 flags (cuDNN on). Fails unless each wav is
   finite, 24 kHz and of the length the turns' tokens imply, K1-fwd ran
   28 x the fresh flash-width prefills and K4 28 a decode step (paged),
   nothing else launched, the prompt codes equal the CPU's on the same
   mels (a flip only within 1e-4 of a rounding edge, logged) and the
   x-vectors are within 1e-4 relative of the CPU's. Logs the S3 and
   CAM++ ms, each turn's decode ms a step and tokens/s, flow + HiFT ms a
   turn (offline), first audio a turn (streaming), x-realtime and peak
   memory beside the card. The kernels line gets ``synthesize_launches``.

17. CosyVoice2 and the 8-bit optimizer, after phase 15 in its working
   directory and before phase 16: the full-width CosyVoice2 teacher
   (Qwen2-0.5B backbone, unified vocab 159,271; random from a seed, bf16)
   written as a reference-named torch checkpoint; ``train.main
   --teacher_family cosyvoice2`` on phase 15's stage-1 student and rows
   (teacher ids folded below 159,271), online sparse, K 128, B 8, T 512,
   2 steps (exact K1 counts: 24 K1-fwd a teacher forward); the two
   extract routes against each other; the teacher at 2 layers through
   K1-fwd (Dh 64, G 7) and the plain route against fp32; K1-fwd alone at
   (8, 512, 14, 2, 64) beside SDPA; stage 1 with
   ``make_optimizer(eight_bit=True)`` (B 4, T 4096, A 1, 2 steps; exact
   K2 and K1 counts, the base bit-equal, the old rows their start less
   the decay, int8 / uint8 moments) beside one standard step (state
   bytes, peak memory, step and update ms); one KD step with the fused
   and with the default optimizer, their updates on the same gradients
   compared.
18. dp x tp, pp and sp over ``torch.distributed``, after phase 16: two
   ranks spawned
   on the one card (``parallel/multihost.launch``, gloo: NCCL refuses a
   device twice, so a one-rank NCCL group's all_reduce shows its start).
   Each rank draws the full-width student on the card from the seed
   (``init_params_on_device``, as the one-process reference does) and
   keeps its slices (``sharding.shard_params``): a tp-2 ``PagedEngine``
   serve of
   4 greedy requests (two fresh 512- and 768-wide prefills), in bf16 and
   in fp32, a bf16 512-token prefill, then 2 LoRA KD steps (precomputed,
   B 8, T 512, K 128) at dp 1 x tp 2 and at dp 2 x tp 1 with ZeRO-1.
   Fails unless each rank's K4 ran 28 a decode step and K1-fwd 28 a
   fresh flash-width prefill, K1-fwd 2 x 28 and K1-dq / K1-dkv 28 a KD
   step (nothing else), the fp32 greedy tokens equal the one-process
   run's (the bf16 common prefixes are logged), the bf16 prefill logits
   and the step losses and grad norms agree with it, and a rank's
   failure or hang (a timeout) fails the launch. Then (the same two
   ranks) 2 LoRA KD steps at pp 2 (4 microbatches of 2 rows), GPipe and
   then interleaved 1F1B (2 chunks of 7 layers a stage), 2 zig-zag KD
   steps at sp 2 on a T 1,024 batch (512 positions a rank), and one
   stage-1 step at sp 2 (B 1, T 4,096, A 1), each beside the one-process
   run on the same batch: fails unless each rank's launches are exact
   (pp: K1-fwd 2 x 14 x 4 and K1-dq / K1-dkv 14 x 4 a step; sp: no K1;
   stage 1: K2 stats / dh / dW once; nothing else) and the losses and
   grad norms agree. Then K4 at KV 4 and K1-fwd / dq / dkv at H 8, KV 4
   and at a pp microbatch's B 2 against their plain versions, timed.
   Last on the two ranks, the disaggregated teacher
   (``distill/disaggregate``): rank 1 draws the 1.7B teacher and serves
   its exact top-K, rank 0 runs 3 precomputed KD steps (B 8, T 512, K
   128) on the streamed batches; fails unless the student's launches are
   a KD step's (K1-fwd 56, dq / dkv 28 a step), the teacher's K1-fwd 28
   an extraction, nothing else, and the losses and grad norms agree with
   the one-process online-sparse steps (1e-3, 1e-2); logs each side's ms
   and the student's waits. Then the multi-process dry run
   (``parallel/multihost_dryrun``) on 2 x 2 ranks on the card over gloo:
   fails unless every rank reports ``MULTIHOST_OK``.

Exits non-zero, printing no result, when CUDA is missing or any phase
fails. Only one card is needed. Imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from speech_distill_tpu_torch.core.config import (DistillConfig, LoraConfig,
                                                  SamplingParams,
                                                  qwen3_student_0p6b,
                                                  qwen3_teacher_1p7b)
from speech_distill_tpu_torch.core.trainer import (LoopConfig, batches_from,
                                                   train_loop)
from speech_distill_tpu_torch.core.tree import tree_leaves, tree_map
from speech_distill_tpu_torch.data.collator import (DistillCollator,
                                                    pad_sequences)
from speech_distill_tpu_torch.distill import evaluate, losses, train_step
from speech_distill_tpu_torch.distill.lora import init_lora, lora_scaling
from speech_distill_tpu_torch.infer.continuous import ContinuousEngine
from speech_distill_tpu_torch.infer.engine import DecodeEngine
from speech_distill_tpu_torch.infer.paged import (PagedEngine, PagedKVCache,
                                                  PagePool, PrefixRegistry,
                                                  paged_forward)
from speech_distill_tpu_torch.infer.streaming_tts import (StreamingTokenToWav,
                                                          stream_tts)
from speech_distill_tpu_torch.infer.tts_serve import (MultiSessionTTS,
                                                      TTSSession)
from speech_distill_tpu_torch.distill import optim8bit
from speech_distill_tpu_torch.models import cosyvoice2 as cv2
from speech_distill_tpu_torch.models import flow as flow_lib
from speech_distill_tpu_torch.models import hift as hift_lib
from speech_distill_tpu_torch.models import qwen3
from speech_distill_tpu_torch.models.convert import (model_to_tree,
                                                     params_from_jax)
from speech_distill_tpu_torch.native.serving import (NativePagePool,
                                                     NativePrefixRegistry)
from speech_distill_tpu_torch.ops import _cuda
from speech_distill_tpu_torch.ops import fused_norm
from speech_distill_tpu_torch.ops.attention import FLASH_BLOCK, FLASH_MIN_SEQ
from speech_distill_tpu_torch.ops.flash_attention import (
    flash_attention_bwd_plain, flash_attention_fwd, flash_attention_fwd_plain,
    flash_dkv, flash_dq)
from speech_distill_tpu_torch.ops.fused_lm_loss import (fused_cross_entropy,
                                                        fused_extract_top_k,
                                                        head_dense_kd_loss,
                                                        head_sparse_kd_loss)
from speech_distill_tpu_torch.ops.paged_attention import (
    k4_plan, paged_attention, paged_attention_plain, quantize_kv)
from speech_distill_tpu_torch.ops.pallas_lm_loss import (
    _bwd_plan, _sm_count, _stats_plan, lm_head_dh, lm_head_dw,
    lm_head_stats_bwd_plain, lm_head_stats_kernel, lm_head_stats_plain)
from speech_distill_tpu_torch.ops.quant import (dequantize_array,
                                                param_bytes, quantize_params)
from speech_distill_tpu_torch.ops.quant_matmul import (int4_matmul,
                                                       int4_matmul_plain,
                                                       int4_route)
from speech_distill_tpu_torch.core import trainer as trainer_lib
from speech_distill_tpu_torch.core.checkpoint import export_hf, hf_config
from speech_distill_tpu_torch.distill.lora import merge_and_export
from speech_distill_tpu_torch.models.hf_loader import (load_pretrained,
                                                       to_state_dict)
from speech_distill_tpu_torch.pipelines import evaluate as evaluate_cli
from speech_distill_tpu_torch.pipelines import extract_logits as extract_cli
from speech_distill_tpu_torch.pipelines import prepare_dataset as prepare_cli
from speech_distill_tpu_torch.pipelines import prepare_student as student_cli
from speech_distill_tpu_torch.pipelines import stage1 as stage1_data
from speech_distill_tpu_torch.pipelines import train as train_cli
from speech_distill_tpu_torch.pipelines.extract_logits import (
    extract_teacher_logprobs)

SEED = 0
# H100 SXM published peaks (dense): HBM bandwidth and bf16 tensor cores
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
# bf16 results: one rounding of an attention output (|o| <= max|v| ~ 5,
# 2^-9 relative) plus the kernel's bf16 P; fp32 sums agree to ~1e-6
KERNEL_ATOL = 2e-2
LSE_ATOL = 1e-3
# decode logits through 28 layers, kernel vs plain attention, in fp32:
# only summation order differs (~1e-6 relative per reduction of <= 3072
# terms), on logits of O(1)
FP32_LOGITS_ATOL = 1e-3
# in bf16 the two routes round attention outputs at different points, and
# that noise passes through 28 residual layers: the kernel route must be
# no less accurate than the plain route against the fp32 route (2x slack
# for which of two like-sized noises happens to be larger)
BF16_ERR_RATIO = 2.0
# flash backward, max |kernel - plain(fp32)| / max |plain| on the same bf16
# inputs: the kernels round p and ds to bf16 (2^-9 relative) before
# products over up to T * G terms and write bf16 results (2^-9), and their
# forward's o and lse carry bf16 rounding too
BWD_REL_TOL = 2e-2
# the one-pass elementwise kernels against their plain versions on the
# same bf16 inputs (ops/fused_norm's own bound; its comment gives the
# source)
FUSED_REL_TOL = fused_norm.PLAIN_REL_TOL
FUSED_NAMES = ("rms_norm_fwd", "rms_norm_bwd", "qk_norm_rope_fwd",
               "qk_norm_rope_bwd", "swiglu_fwd", "swiglu_bwd")
# the KD step of the smoke (bench.py's defaults): B 8, T 512, top-K 128
TRAIN_B, TRAIN_T, TRAIN_K, TRAIN_STEPS = 8, 512, 128, 10
SPEECH_BOS = 151_670          # a speech-start id; the pad id is the EOS
# learning rate of the loop on one repeated batch (first step's rate is 0)
REPEAT_LR, REPEAT_STEPS = 2e-4, 6
# the fused KD route against the head route on the same weights and batch:
# both take fp32 logits of the same bf16 operands, summed in another order
# (~1e-6 relative); the teacher top-K logits are the same gather
FUSED_KD_LOSS_RTOL = 1e-4
# ... and both round d_logits to bf16 (2^-9 relative), the head route from
# a bf16 logits residual, K2 from recomputed fp32 logits
FUSED_KD_GRAD_NORM_RTOL = 2e-2
# stage 1 at the reference CLI's defaults (pipelines/stage1.py: batch 4,
# max_seq_length 4096, gradient_accumulation_steps 4, weight_decay 0.01,
# num_new_tokens 8220); lr with warmup 1, so the rate is nonzero from
# step 2 (the first step's rate is 0)
S1_B, S1_T, S1_A, S1_STEPS = 4, 4096, 4, 4
S1_NEW_TOKENS, S1_LR, S1_WARMUP, S1_WD = 8220, 1e-4, 1, 0.01
S1_EVAL_ROWS = 2                  # eval rows, scored one at a time
# K2 against its plain version, max |kernel - plain(fp32)| / max |plain|:
# the statistics are fp32 sums of bf16 products in another order; dh and
# dW round dlogits to bf16 (2^-9 relative) as the TPU kernels do, and are
# written in bf16
K2_CHECK_N = S1_T                 # one packed sequence; also checked at
#                                   the stage-1 microbatch's N
LSE_REL_TOL, HEAD_GRAD_REL_TOL = 1e-3, 2e-2
# K3 against int4_matmul_plain, max |kernel - plain| / max |plain|: the
# same bf16 x and integer grid, fp32 sums in another order (split over
# blocks at decode) for an fp32 output; a bf16 output adds one rounding
# of each element (at most 2^-8 of it) on either side of a sum that may
# differ in its last fp32 bits
INT4_REL_TOL, INT4_BF16_REL_TOL = 1e-3, 2.0 ** -7
# the seven projections of a layer, each one K3 launch a model forward
QUANT_PROJ = 7
# earlier phases' library rates, printed beside phase 15's CLI rates
RATES: dict = {}


def add_launches(*counts: dict, times: int = 1) -> dict:
    """The sum of launch-count dicts, each count ``times`` over; nonzero
    counts only."""
    out: dict = {}
    for c in counts:
        for k, v in c.items():
            out[k] = out.get(k, 0) + v * times
    return {k: v for k, v in out.items() if v}


def fused_launches(fwd: int, finals: int, bwd: int = 0,
                   bwd_norms: int = 0) -> dict:
    """The launches of ``ops/fused_norm``'s kernels (nonzero only) for
    ``fwd`` bf16 decoder-layer forwards (two RMSNorms, the q/k norm +
    RoPE and the SwiGLU each) and ``finals`` final norms, and for the
    backward of ``bwd`` layers with ``bwd_norms`` RMSNorm backwards in
    all."""
    return add_launches({
        "rms_norm_fwd": 2 * fwd + finals, "qk_norm_rope_fwd": fwd,
        "swiglu_fwd": fwd, "rms_norm_bwd": bwd_norms,
        "qk_norm_rope_bwd": bwd, "swiglu_bwd": bwd})


def forward_launches(L: int, forwards: int) -> dict:
    """``ops/fused_norm``'s launches of ``forwards`` whole forwards of an L
    layer bf16 model (a prefill, a decode step, a teacher's batch)."""
    return fused_launches(L * forwards, forwards)


def train_launches(L: int, fwd: int = None) -> dict:
    """``ops/fused_norm``'s launches of one training step of an L layer
    bf16 student: ``fwd`` layer forwards (default 2 L: each layer again in
    the full-remat recompute) and the final norm, then the backward of
    every layer and of the final norm: 2 L + 1 RMSNorm backwards, since
    every step here trains the embedding (stage 1's rows, LoRA's copy of
    the table), so layer 0's input norm has a gradient to pass down."""
    return fused_launches(2 * L if fwd is None else fwd, 1, L, 2 * L + 1)


def check_serve_launches(what: str, counts: dict, L: int, eng) -> None:
    """A paged serve's ``ops/fused_norm`` launches: one whole forward a
    prefill forward and a decode step (the engine's own counters), no
    backward."""
    want = forward_launches(L, eng.n_prefill_forwards + eng.n_decode_steps)
    got = {k: counts.get(k, 0) for k in FUSED_NAMES if counts.get(k, 0)}
    if got != want:
        fail(f"{what}: fused_norm launches {got} != {want} "
             f"({eng.n_prefill_forwards} prefill forwards, "
             f"{eng.n_decode_steps} decode steps)")


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, side, iters: int = 20, replays: int = 10) -> float:
    """Mean device time of ``fn`` with no host in the way: ``iters`` calls
    captured in one CUDA graph, replayed ``replays`` times between CUDA
    events. For kernels shorter than their launch's host work, where
    :func:`time_ms` measures the host. The warm-up and the capture run on
    the stream ``side``, one for all calls: cuBLAS keeps a workspace for
    every stream it has run on, so a new stream a call would hold memory
    into the later phases; and an autograd backward runs on the stream of
    its forward, so a forward run on ``side`` has its backward captured."""
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def scratch_bytes(fn) -> int:
    """Device memory that one call of ``fn`` takes and gives back: its
    peak less what stays allocated after it (its outputs held), from the
    caching allocator's counts."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    del out
    return torch.cuda.max_memory_allocated() - held


def bound(nbytes: float, flops: float):
    """(bound_ms, bound_by): the larger of bytes over HBM bandwidth and
    operations over the bf16 tensor-core peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def is_flash_width(w: int) -> bool:
    """Whether a fresh prefill this wide takes K1-fwd (ops/attention)."""
    return w >= FLASH_MIN_SEQ and w % FLASH_BLOCK == 0


def record_card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    log(out.splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    return out


def build_kernels() -> None:
    t0 = time.perf_counter()
    reports = _cuda.build(list(_cuda.SIGNATURES))
    for name, rep in reports.items():
        for line in rep.splitlines():
            if any(w in line for w in ("registers", "spill",
                                       "Function properties",
                                       "Performance Loss")):
                log(f"ptxas {name}: {line.strip()}")
    # every K4 instantiation keeps its state in registers
    spills = [line.strip() for line in
              reports.get("paged_decode", "").splitlines()
              if re.search(r"\b[1-9]\d* bytes spill", line)]
    if spills:
        fail(f"ptxas paged_decode spills: {spills}")
    log(f"build s={time.perf_counter() - t0:.2f} "
        f"built={sorted(reports)}")


def serve_traffic(cfg, eng, what: str, **extra):
    """The smoke's serving traffic through ``eng``, timed with the launch
    counts set to 0 just before and read just after: 16 seeded requests,
    13 short prompts and three fresh long ones whose page-aligned widths
    (512, 768, 1024) take the flash kernel at prefill, after a warm-up.
    Prints the ``what`` line, checks the caps contract and returns
    (counts, lens, rng)."""
    rng = np.random.default_rng(SEED)
    lens = [int(n) for n in rng.integers(64, 129, 13)] + [500, 700, 1000]
    prompts = [rng.integers(1, cfg.vocab_size - 2, n).tolist() for n in lens]
    caps = [int(c) for c in rng.integers(32, 129, len(prompts))]
    eng.serve([prompts[0][:70]], max_new=4)          # warm-up (cuBLAS etc.)
    torch.cuda.synchronize()

    _cuda.reset_launches()
    t0 = time.perf_counter()
    outs = eng.serve(prompts, max_new_per_request=caps)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(_cuda.launches)

    n_gen = sum(len(o) for o in outs)
    log(what + " " + json.dumps({
        "requests": len(prompts), "prompt_tokens": sum(lens),
        "generated_tokens": n_gen, "seconds": dt, "tokens_per_s": n_gen / dt,
        "phase_seconds": eng.phase_seconds, "decode_steps":
        eng.n_decode_steps, "chunks": eng.n_chunks, "exit_syncs":
        eng.n_exit_syncs, "preemptions": eng.preemptions,
        "batched_prefills": eng.n_batched_prefills,
        "prefill_forwards": eng.n_prefill_forwards,
        "prefill_pieces": eng.n_prefill_chunks, **extra,
        "launches": counts}))
    for rid, (o, c) in enumerate(zip(outs, caps)):
        if not 0 < len(o) <= c:
            fail(f"{what} request {rid}: {len(o)} tokens for cap {c}")
        if not all(0 <= t < cfg.vocab_size for t in o):
            fail(f"{what} request {rid}: token outside the vocabulary")
        if len(o) < c and o[-1] != cfg.eos_token_id:
            fail(f"{what} request {rid} stopped early without EOS")
    return counts, lens, rng


def serve(cfg, model):
    """Phase 3: the main path. Returns the launch counts of the serve."""
    sp = SamplingParams(stop_token_ids=(cfg.eos_token_id,))
    eng = PagedEngine(model, cfg, sp, slots=16, max_len=2048, page_size=128,
                      seed=SEED, device=model.device)
    counts, lens, rng = serve_traffic(cfg, eng, "serve")
    if min(counts["paged_decode"], counts["flash_fwd"]) <= 0:
        fail(f"a serving kernel was not launched during the serve: "
             f"{counts}")
    L = cfg.num_hidden_layers
    if counts["paged_decode"] != L * eng.n_decode_steps:
        fail(f"paged_decode launches {counts['paged_decode']} != layers x "
             f"decode steps {L * eng.n_decode_steps}")
    check_serve_launches("serve", counts, L, eng)
    per_step = profile_decode(eng, lens[:13], cfg, rng,
                              groups={"k4": "paged_decode_kernel"})
    check_k4_per_step(per_step["k4"], L, "serve")
    return counts


# phase 3b, the feature serve: 24 requests arriving open-loop over ~2 s,
# 4 of them with an already expired TTFT deadline (shed before prefill)
FEATURE_SHORT, FEATURE_LONG, FEATURE_SHED = 16, 4, 4
FEATURE_SPREAD_S, FEATURE_DEADLINE_S = 2.0, 60.0
# a pool small enough that the serve preempts: 48 pages (a CPU rehearsal
# of the schedule at several step times preempted at 40-48, not at 56-64)
FEATURE_PAGES, FEATURE_CHUNK, FEATURE_EXIT_FREE = 48, 512, 4
# token budgets, drawn in [lo, hi): the short requests' are long enough
# that sixteen of them resident at once outgrow the pool
FEATURE_SHORT_CAPS, FEATURE_LONG_CAPS = (256, 385), (32, 129)


def feature_traffic(cfg, rng):
    """The feature serve's requests: (prompts, caps, arrivals, deadlines,
    overrides, shed rids). Seeded order; long prompts of 1,200-1,900
    tokens prefill in 512-token pieces; half the requests override
    temperature, top_p, repetition penalty and min_tokens."""
    n = FEATURE_SHORT + FEATURE_LONG + FEATURE_SHED
    short = FEATURE_SHORT + FEATURE_SHED
    lens = ([int(x) for x in rng.integers(64, 129, short)]
            + [int(x) for x in rng.integers(1200, 1901, FEATURE_LONG)])
    caps = ([int(x) for x in rng.integers(*FEATURE_SHORT_CAPS, short)]
            + [int(x) for x in rng.integers(*FEATURE_LONG_CAPS,
                                            FEATURE_LONG)])
    order = rng.permutation(n)
    lens, caps = [lens[i] for i in order], [caps[i] for i in order]
    shed = sorted(int(np.nonzero(order == i)[0][0])
                  for i in range(FEATURE_SHORT, short))
    prompts = [rng.integers(1, cfg.vocab_size - 2, k).tolist() for k in lens]
    gaps = np.cumsum(rng.exponential(1.0, n))
    arrivals = ((gaps - gaps[0]) / (gaps[-1] - gaps[0])
                * FEATURE_SPREAD_S).tolist()
    deadlines = [0.0 if rid in shed else FEATURE_DEADLINE_S
                 for rid in range(n)]
    with_overrides = set(rng.permutation(n)[:n // 2].tolist())
    overrides = [{"temperature": float(rng.uniform(0.3, 1.0)),
                  "top_p": float(rng.uniform(0.7, 1.0)),
                  "repetition_penalty": float(rng.uniform(1.0, 1.3)),
                  "min_tokens": int(rng.integers(0, 17))}
                 if rid in with_overrides else None for rid in range(n)]
    return prompts, caps, arrivals, deadlines, overrides, shed


def pieces_needed(n: int, chunk: int, ps: int) -> int:
    """Chunked-prefill pieces of a fresh n-token prompt (no prefix hit):
    the engine's 2a loop."""
    done = pieces = 0
    while n - done * ps > chunk:
        done += min(chunk // ps, (n - 1) // ps - done)
        pieces += 1
    return pieces


def registry_host_ms(prompts, ps: int) -> dict:
    """Host ms of the prefix registry over the phase's prompts, for the
    native runtime and the Python twins: match then register each prompt
    (cold), then match each again (every full page a hit)."""
    out, matches = {}, {}
    n_pages = sum(len(p) // ps + 1 for p in prompts)
    for name, make in (("native", lambda: (NativePagePool(n_pages),
                                           NativePrefixRegistry())),
                       ("python", lambda: (PagePool(n_pages),
                                           PrefixRegistry()))):
        pool, reg = make()
        t0 = time.perf_counter()
        for ids in prompts:
            reg.match(ids, ps, (len(ids) - 1) // ps)
            reg.register(ids, pool.alloc(len(ids) // ps), ps, pool)
        matches[name] = [reg.match(ids, ps, len(ids) // ps)
                         for ids in prompts]
        out[name] = (time.perf_counter() - t0) * 1e3
    if matches["native"] != matches["python"]:
        fail("native and Python prefix registries disagree")
    return out


def prefill_logits(model, cfg, ids, chunk, dev) -> torch.Tensor:
    """Last-position logits of ``ids`` after the engine's admission
    (chunked in ``chunk``-token pieces, or whole when None): the row that
    ``_admit`` leaves in ``last_logits``."""
    eng = PagedEngine(model, cfg, SamplingParams(stop_token_ids=(
        cfg.eos_token_id,)), slots=1, max_len=2048, page_size=128,
        num_pages=16, prefix_sharing=False, prefill_chunk=chunk,
        device=dev, native_runtime=False)
    rows = []
    admit = eng._admit

    def spy(state, b, *args, **kw):
        admit(state, b, *args, **kw)
        rows.append(state.last_logits[b].clone())
    eng._admit = spy
    eng.serve([ids], max_new=1)
    if chunk and eng.n_prefill_chunks != pieces_needed(len(ids), chunk, 128):
        fail(f"teacher-forced prefill ran {eng.n_prefill_chunks} pieces")
    return rows[0]


def check_chunked_prefill(cfg, model, ids, dev) -> None:
    """One long prompt's last-position logits after the chunked prefill
    and after the whole-prompt prefill, in bf16 (flash for the first
    piece and the whole prompt, ``sdpa_plain`` over gathered pages for
    the later pieces) and in fp32 (same weights upcast), against the fp32
    whole-prompt route."""
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model32 = qwen3.Qwen3(cfg32, dev)
    for p32, p in zip(model32.parameters(), model.parameters()):
        p32.data.copy_(p.float())
    ref = prefill_logits(model32, cfg32, ids, None, dev)
    err = {"fp32_chunked": prefill_logits(model32, cfg32, ids,
                                          FEATURE_CHUNK, dev),
           "bf16_chunked": prefill_logits(model, cfg, ids, FEATURE_CHUNK,
                                          dev),
           "bf16_whole": prefill_logits(model, cfg, ids, None, dev)}
    del model32
    if not all(bool(torch.isfinite(v).all()) for v in err.values()):
        fail("chunked prefill produced non-finite logits")
    err = {k: (v - ref).abs().max().item() for k, v in err.items()}
    log(f"chunked prefill ({len(ids)} tokens, {FEATURE_CHUNK}-token "
        f"pieces): max |logits - fp32 whole|: fp32 chunked "
        f"{err['fp32_chunked']:.3e} (tol {FP32_LOGITS_ATOL}), bf16 chunked "
        f"{err['bf16_chunked']:.3e}, bf16 whole {err['bf16_whole']:.3e} "
        f"(chunked must stay within {BF16_ERR_RATIO}x the whole route's "
        f"error)")
    if not err["fp32_chunked"] <= FP32_LOGITS_ATOL:
        fail(f"fp32 chunked prefill disagrees with the whole prompt: {err}")
    if not err["bf16_chunked"] <= BF16_ERR_RATIO * err["bf16_whole"]:
        fail(f"bf16 chunked prefill is less accurate: {err}")


def serve_features(cfg, model, dev) -> dict:
    """Phase 3b: the engine's serving features on the full-width model:
    open-loop arrivals, EDF admission with shedding, chunked prefill, the
    early chunk exit, per-request sampling, streamed logprobs, on_chunk
    and the native runtime, through a pool that preempts. Returns the
    launch counts of the serve."""
    rng = np.random.default_rng(SEED + 21)
    prompts, caps, arrivals, deadlines, overrides, shed = \
        feature_traffic(cfg, rng)
    sp = SamplingParams(stop_token_ids=(cfg.eos_token_id,))
    eng = PagedEngine(model, cfg, sp, slots=16, max_len=2048, page_size=128,
                      num_pages=FEATURE_PAGES, seed=SEED, device=dev,
                      prefill_chunk=FEATURE_CHUNK,
                      chunk_exit_free=FEATURE_EXIT_FREE,
                      admission_policy="deadline",
                      per_request_sampling=True, return_logprobs=True,
                      native_runtime=True)
    n = len(prompts)
    toks, lps = [[] for _ in range(n)], [[] for _ in range(n)]
    closed = [0] * n
    chunk_calls = []

    def on_tokens(rid, new, done):
        toks[rid] += new
        closed[rid] += done

    def on_logprobs(rid, new, done):
        lps[rid] += new

    torch.cuda.synchronize()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    outs = eng.serve(prompts, max_new_per_request=caps, on_tokens=on_tokens,
                     on_logprobs=on_logprobs,
                     on_chunk=lambda: chunk_calls.append(1),
                     sampling_per_request=overrides,
                     deadline_per_request=deadlines,
                     arrival_per_request=arrivals)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(_cuda.launches)
    served = [rid for rid in range(n) if rid not in shed]
    n_gen = sum(len(o) for o in outs)
    met = [m for m in eng.request_metrics if not m.get("shed")]
    ttft = np.asarray([m["ttft_s"] for m in met])
    e2e = np.asarray([m["e2e_s"] for m in met])
    lens = [len(p) for p in prompts]
    long_rids = [rid for rid in range(n) if lens[rid] >= 1200]
    need = sum(pieces_needed(lens[rid], FEATURE_CHUNK, eng.ps)
               for rid in long_rids)
    host = registry_host_ms(prompts, eng.ps)
    log("serve_features " + json.dumps({
        "requests": n, "shed": eng.shed_requests, "prompt_tokens": sum(lens),
        "generated_tokens": n_gen, "seconds": dt, "tokens_per_s": n_gen / dt,
        "ttft_s": {"p50": float(np.percentile(ttft, 50)),
                   "p90": float(np.percentile(ttft, 90)),
                   "max": float(ttft.max())},
        "e2e_s": {"p50": float(np.percentile(e2e, 50)),
                  "p90": float(np.percentile(e2e, 90)),
                  "max": float(e2e.max())},
        "chunks": eng.n_chunks, "decode_steps": eng.n_decode_steps,
        "exit_syncs": eng.n_exit_syncs,
        "prefill_pieces": eng.n_prefill_chunks, "pieces_needed": need,
        "prefill_forwards": eng.n_prefill_forwards,
        "preemptions": eng.preemptions, "runtime": eng.runtime,
        "phase_seconds": eng.phase_seconds,
        "registry_host_ms": host, "pool_pages": eng.num_pages,
        "launches": counts}))
    if sorted(rid for rid in range(n) if outs[rid] == []) != shed \
            or eng.shed_requests != len(shed):
        fail(f"feature serve shed {eng.shed_requests} requests, not "
             f"exactly {shed}")
    if any(eng.request_metrics[rid].get("shed") is not True for rid in shed):
        fail("a shed request has no shed record")
    if closed != [1] * n:
        fail(f"streams not closed exactly once: {closed}")
    for rid in served:
        o = outs[rid]
        if not 0 < len(o) <= caps[rid]:
            fail(f"feature serve request {rid}: {len(o)} tokens for cap "
                 f"{caps[rid]}")
        if not all(0 <= t < cfg.vocab_size for t in o):
            fail(f"feature serve request {rid}: token outside the vocab")
        if (len(o) < caps[rid] and o[-1] != cfg.eos_token_id
                and len(prompts[rid]) + len(o) < eng.max_len):
            fail(f"feature serve request {rid} stopped early without EOS")
    if toks != outs or lps != eng.request_logprobs:
        fail("streamed tokens or logprobs differ from the outputs")
    flat = np.asarray([x for lp in lps for x in lp])
    if len(flat) != n_gen or not (np.isfinite(flat).all()
                                  and (flat <= 0).all()):
        fail("logprobs not finite and <= 0, one a token")
    if len(chunk_calls) != eng.n_chunks:
        fail(f"on_chunk ran {len(chunk_calls)} times over "
             f"{eng.n_chunks} scheduler passes")
    if eng.n_prefill_chunks < need:
        fail(f"{eng.n_prefill_chunks} prefill pieces < the {need} the long "
             f"prompts need")
    if eng.preemptions < 1:
        fail("the feature serve did not preempt")
    if counts["flash_fwd"] < 1:
        fail(f"flash_fwd not launched in the feature serve: {counts}")
    L = cfg.num_hidden_layers
    if counts["paged_decode"] != L * eng.n_decode_steps:
        fail(f"feature serve paged_decode launches {counts['paged_decode']}"
             f" != layers x decode steps {L * eng.n_decode_steps}")
    check_serve_launches("feature serve", counts, L, eng)
    if eng.runtime != "native":
        fail(f"feature serve ran the {eng.runtime} runtime")
    del eng
    check_chunked_prefill(cfg, model, prompts[long_rids[0]], dev)
    return counts


# phase 3c, the TTS serve: the traffic of the JAX package's own benchmark
# of the serving product (bench.py bench_tts_serve) at its N = 8, over the
# phase-3 student, with the reference's full-size flow and HiFT (random
# weights from the smoke's seed, fp32, TF32 off)
TTS_SESSIONS, TTS_PROMPT, TTS_LONG = 8, 128, (700, 1000)
TTS_FLOW_PROMPT, TTS_PROMPT_MEL, TTS_MEL_PAD = 75, 150, 160
TTS_GEN, TTS_CHUNK_STEPS, TTS_GATE = 100, 16, -3.0   # bench: 150
# one 100-token stream in 4 chunks of 25, incremental against recompute
# (cut from 400 in 16 chunks, then 150 in 6, to keep the smoke inside its
# limit)
TTS_INC_TOKENS, TTS_INC_CHUNK, TTS_INC_FRAMES = 100, 25, 1024
# a session replayed alone against its batched row, max |wav difference|:
# the two differ only in how cuBLAS and cuDNN block the fp32 products of
# an 8-row and a 1-row call (~1e-6 relative each), carried through 15
# Euler steps of 70 blocks and HiFT's exp(magnitude) head into a wav
# clipped at 0.99 (the JAX test allows 2e-4 on its tiny config)
TTS_REPLAY_WAV_ATOL = 1e-3
# the incremental flow (fp32 K/V caches) against the recompute, max |mel
# difference|: the same fp32 arithmetic on other shapes (F new rows
# against cached keys instead of the whole prefix)
TTS_INC_MEL_ATOL = 1e-3


class FoldSpeechIds:
    """The engine, with every generated id outside the flow's speech range
    folded into it (offset + id % vocab) in the token callbacks and the
    outputs: a random-weight student samples its whole vocabulary, and a
    flow id past the flow vocabulary raises. Counts the ids it folded,
    keeps the raw streams, and times each ``on_chunk`` tick (decode waits
    for it: the synthesis runs on the engine's stream)."""

    def __init__(self, eng, offset: int, vocab: int):
        self.eng, self.offset, self.vocab = eng, offset, vocab
        self.folded = 0
        self.raw, self.outputs, self.tick_s = [], [], []

    def fold(self, ids):
        return [t if 0 <= t - self.offset < self.vocab
                else self.offset + t % self.vocab for t in ids]

    def serve(self, prompts, max_new=None, on_tokens=None, on_chunk=None,
              on_logprobs=None):
        self.raw = [[] for _ in prompts]
        self.tick_s = []

        def tokens(rid, new, done):
            self.raw[rid] += new
            folded = self.fold(new)
            self.folded += sum(a != b for a, b in zip(new, folded))
            on_tokens(rid, folded, done)

        def chunk():
            t0 = time.perf_counter()
            on_chunk()
            self.tick_s.append(time.perf_counter() - t0)
        self.outputs = self.eng.serve(prompts, max_new=max_new,
                                      on_tokens=tokens, on_chunk=chunk,
                                      on_logprobs=on_logprobs)
        return [self.fold(o) for o in self.outputs]

    def generate_stream(self, prompt_ids, chunk=25, **kw):
        """The engine's token stream, folded; keeps the raw chunks."""
        self.raw_chunks = []
        for new in self.eng.generate_stream(prompt_ids, chunk=chunk, **kw):
            self.raw_chunks.append(new)
            folded = self.fold(new)
            self.folded += sum(a != b for a, b in zip(new, folded))
            yield folded


def tts_sessions(cfg, fcfg, rng) -> list:
    """Six 128-token LLM prompts and two long ones (page-aligned widths 768
    and 1,024 take K1-fwd), each with a 75-token flow prompt, 150 prompt
    mel frames and a 192-dim speaker embedding; int seeds for the draws."""
    lens = [TTS_PROMPT] * (TTS_SESSIONS - len(TTS_LONG)) + list(TTS_LONG)
    return [TTSSession(
        llm_ids=rng.integers(1, cfg.vocab_size - 2, n).tolist(),
        flow_prompt_tokens=rng.integers(0, fcfg.vocab_size,
                                        TTS_FLOW_PROMPT).tolist(),
        prompt_mel=(rng.normal(size=(TTS_PROMPT_MEL, fcfg.output_size))
                    * 0.1).astype(np.float32),
        prompt_mel_len=TTS_PROMPT_MEL,
        spk_emb=rng.normal(size=(fcfg.spk_embed_dim,)).astype(np.float32),
        rng=SEED + 100 + i) for i, n in enumerate(lens)]


def ms_by_rows(tick_ms: dict) -> dict:
    return {what: {rows: {"calls": len(v), "mean": float(np.mean(v)),
                          "max": float(np.max(v))}
                   for rows, v in sorted(d.items())}
            for what, d in tick_ms.items()}


def stream_timed(synth, gen, cadence) -> tuple:
    """Push ``gen`` through ``synth`` at ``cadence`` [(n_tokens, final)]:
    (mel [1, F, 80] the flow emitted, wav chunks, ms of each push; every
    push ends with its results read back to the host)."""
    mels, wavs, ms = [], [], []
    for n, final in cadence:
        t0 = time.perf_counter()
        job = synth.flow_job(gen[:n], final)
        if job is not None:
            mels.append(synth.run_flow(job))
        job = synth.vocode_job(final)
        if job is not None:
            wavs.append(synth.run_vocode(job))
        ms.append((time.perf_counter() - t0) * 1e3)
    return np.concatenate(mels, axis=1), wavs, ms


def check_tts_replay(coord, sessions, res, flow, fcfg, hift, hcfg, offset,
                     dev) -> float:
    """Session 0 replayed alone through StreamingTokenToWav at its recorded
    cadence, against its batched row; returns the max |wav difference|."""
    s = sessions[0]
    gen = [t - offset for t in res[0]["tokens"]]
    synth = StreamingTokenToWav(
        flow, fcfg, hift, hcfg, s.flow_prompt_tokens, s.prompt_mel,
        s.prompt_mel_len, s.spk_emb, s.rng, mel_pad_to=TTS_MEL_PAD,
        device=dev)
    wav = np.concatenate([w for n, final in coord.cadence[0]
                          for w in synth.push(gen[:n], final)])
    if wav.shape != res[0]["wav"].shape:
        fail(f"replayed session: wav {wav.shape} != batched row "
             f"{res[0]['wav'].shape}")
    return float(np.abs(wav - res[0]["wav"]).max())


def check_tts_incremental(s, flow, fcfg, hift, hcfg, dev) -> dict:
    """One TTS_INC_TOKENS-token stream (chunks of TTS_INC_CHUNK tokens,
    then the flush)
    through the recompute and the incremental flow with fp32 K/V caches:
    the mel and wav of the two, and each chunk's ms."""
    gen = np.random.default_rng(SEED + 32).integers(
        0, fcfg.vocab_size, TTS_INC_TOKENS).tolist()
    cadence = [(n, False) for n in range(TTS_INC_CHUNK, TTS_INC_TOKENS + 1,
                                         TTS_INC_CHUNK)]
    cadence.append((TTS_INC_TOKENS, True))
    out = {}
    for inc in (False, True):
        synth = StreamingTokenToWav(
            flow, fcfg, hift, hcfg, s.flow_prompt_tokens, s.prompt_mel,
            s.prompt_mel_len, s.spk_emb, SEED + 200, incremental=inc,
            inc_max_frames=TTS_INC_FRAMES, inc_kv_dtype=torch.float32,
            device=dev)
        out["incremental" if inc else "recompute"] = stream_timed(
            synth, gen, cadence)
        del synth
    (mel_r, wav_r, ms_r), (mel_i, wav_i, ms_i) = (out["recompute"],
                                                  out["incremental"])
    if mel_r.shape != mel_i.shape or len(wav_r) != len(wav_i):
        fail(f"incremental stream: mel {mel_i.shape} / {len(wav_i)} chunks "
             f"vs recompute {mel_r.shape} / {len(wav_r)}")
    if not (np.isfinite(mel_i).all() and np.isfinite(mel_r).all()):
        fail("incremental or recompute mel is not finite")
    return {"tokens": TTS_INC_TOKENS, "mel_frames": mel_r.shape[1],
            "max_mel_err": float(np.abs(mel_i - mel_r).max()),
            "max_wav_err": float(max(np.abs(a - b).max()
                                     for a, b in zip(wav_i, wav_r))),
            "chunk_ms": {"recompute": ms_r, "incremental": ms_i}}


def profile_tts_ticks(flow, fcfg, hift, hcfg, dev) -> None:
    """Device busy share of the serve's largest ticks under
    :func:`profile_step`: one 8-row flow call at the final width (W 256
    tokens, 160 prompt frames) and one 8-row HiFT call over a steady
    window (a 25-token chunk's 50 frames and the 8 held)."""
    g = torch.Generator(device=dev).manual_seed(SEED)
    B, W = TTS_SESSIONS, 256
    tok = torch.randint(0, fcfg.vocab_size, (B, W), device=dev, generator=g)
    n = torch.full((B,), TTS_FLOW_PROMPT + TTS_GEN - 1, device=dev)
    pm = torch.randn((B, TTS_MEL_PAD, fcfg.output_size), device=dev,
                     generator=g)
    plen = torch.full((B,), TTS_PROMPT_MEL, device=dev)
    spk = torch.randn((B, fcfg.spk_embed_dim), device=dev, generator=g)
    noise = torch.randn((B, 2 * W, fcfg.output_size), device=dev,
                        generator=g)
    mel = torch.randn((B, 58, hcfg.in_channels), device=dev, generator=g)

    def flow_call():
        flow_lib.forward_flow(flow, tok, n, pm, plen, spk, fcfg,
                              streaming=True, noise=noise, enc_len=n)
        torch.cuda.synchronize()

    def hift_call():
        hift_lib.forward(hift, mel, hcfg, generator=g)
        torch.cuda.synchronize()
    profile_step("tts flow tick (8 rows, W 256)", flow_call, {}, top=6)
    profile_step("tts vocode tick (8 rows, 58 frames)", hift_call, {},
                 top=6)


def tts_serve(cfg, model, dev, fcfg=None, hcfg=None) -> dict:
    """Phase 3c: MultiSessionTTS over PagedEngine, the serving product:
    8 sessions through the full-width student, batched flow and HiFT
    ticks at every decode-chunk boundary, the confidence gate on the
    streamed logprobs. Then a session replayed alone, and the incremental
    flow against the recompute at full width. Returns the serve's launch
    counts."""
    t_phase = time.perf_counter()
    fcfg = fcfg or flow_lib.FlowConfig()
    hcfg = hcfg or hift_lib.HiFTConfig()
    flow = flow_lib.init_params(fcfg, seed=SEED, device=dev)
    hift = hift_lib.init_params(hcfg, seed=SEED, device=dev)
    sessions = tts_sessions(cfg, fcfg, np.random.default_rng(SEED + 31))
    offset = cfg.speech_token_offset
    sp = SamplingParams(stop_token_ids=(cfg.eos_token_id,),
                        min_tokens=TTS_GEN, max_tokens=TTS_GEN)
    eng = PagedEngine(model, cfg, sp, slots=TTS_SESSIONS, max_len=2048,
                      page_size=128, chunk_steps=TTS_CHUNK_STEPS, seed=SEED,
                      device=dev, return_logprobs=True)
    folder = FoldSpeechIds(eng, offset, fcfg.vocab_size)
    coord = MultiSessionTTS(folder, flow, fcfg, hift, hcfg, offset,
                            mel_pad_to=TTS_MEL_PAD,
                            confidence_gate=TTS_GATE, device=dev)
    # warm-up: cuBLAS / cuDNN handles and plans of the flow and HiFT
    s = sessions[0]
    warm = StreamingTokenToWav(flow, fcfg, hift, hcfg, s.flow_prompt_tokens,
                               s.prompt_mel, s.prompt_mel_len, s.spk_emb, 0,
                               mel_pad_to=TTS_MEL_PAD, device=dev)
    warm.push(list(range(50)), final=True)
    del warm
    streamed = [[] for _ in sessions]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    res = coord.serve(sessions,
                      on_wav=lambda sid, w: streamed[sid].append(w))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(_cuda.launches)
    peak = torch.cuda.max_memory_allocated()

    L = cfg.num_hidden_layers
    widths = [-(-len(x.llm_ids) // eng.ps) * eng.ps for x in sessions]
    flash_widths = [w for w in widths if is_flash_width(w)]
    audio_s = sum(r["wav"].shape[0] for r in res) / hcfg.sampling_rate
    ttfa = np.asarray([r["ttfa_s"] for r in res], np.float64)
    n_gen = sum(len(o) for o in folder.outputs)
    stall = np.asarray(folder.tick_s)
    log("tts_serve " + json.dumps({
        "sessions": len(sessions), "generated_tokens": n_gen,
        "audio_s": audio_s, "wall_s": wall, "x_realtime": audio_s / wall,
        "ttfa_s": {"p50": float(np.percentile(ttfa, 50)),
                   "max": float(ttfa.max())},
        "llm_tokens_per_s": n_gen / wall,
        "chunks": [r["n_chunks"] for r in res],
        "gate_deferrals": sum(r["gate_deferrals"] for r in res),
        "folded_ids": folder.folded,
        "tick_ms": ms_by_rows(coord.tick_ms),
        "decode_stall_ms_a_tick": {"ticks": len(stall),
                                   "mean": float(stall.mean() * 1e3),
                                   "max": float(stall.max() * 1e3),
                                   "total": float(stall.sum() * 1e3)},
        "decode_steps": eng.n_decode_steps, "chunks_llm": eng.n_chunks,
        "phase_seconds": eng.phase_seconds,
        "device_memory_gib": {
            "allocated": torch.cuda.memory_allocated() / 2**30,
            "peak": peak / 2**30},
        "tf32": False, "launches": counts}))

    for sid, r in enumerate(res):
        n_tok = TTS_FLOW_PROMPT + len(r["tokens"]) - 1
        want = (2 * n_tok - TTS_PROMPT_MEL) * hcfg.upsample_scale
        if not np.isfinite(r["wav"]).all() or r["wav"].shape != (want,):
            fail(f"tts session {sid}: wav {r['wav'].shape} (finite "
                 f"{bool(np.isfinite(r['wav']).all())}), want ({want},)")
        if not np.array_equal(np.concatenate(streamed[sid]), r["wav"]):
            fail(f"tts session {sid}: streamed chunks != returned wav")
        if r["n_chunks"] < 2:
            fail(f"tts session {sid} gave {r['n_chunks']} chunks")
        if len(r["tokens"]) != TTS_GEN:
            fail(f"tts session {sid}: {len(r['tokens'])} tokens")
    if folder.raw != folder.outputs or [r["tokens"] for r in res] != [
            folder.fold(o) for o in folder.outputs]:
        fail("tts serve: streamed tokens differ from the engine outputs")
    if eng.preemptions or eng.prefix_hits or len(set(flash_widths)) != len(
            flash_widths):
        fail("tts serve: the K1-fwd count is not exact (preemption, a "
             "prefix hit or a batched long prefill)")
    if counts["paged_decode"] != L * eng.n_decode_steps:
        fail(f"tts serve paged_decode launches {counts['paged_decode']} != "
             f"layers x decode steps {L * eng.n_decode_steps}")
    check_serve_launches("tts serve", counts, L, eng)
    if counts["flash_fwd"] != L * len(flash_widths) or not flash_widths:
        fail(f"tts serve flash_fwd launches {counts['flash_fwd']} != "
             f"layers x fresh long admissions {L * len(flash_widths)}")
    if sum(r["gate_deferrals"] for r in res) <= 0:
        fail("tts serve: the confidence gate never deferred")
    del eng, folder

    replay_err = check_tts_replay(coord, sessions, res, flow, fcfg, hift,
                                  hcfg, offset, dev)
    inc = check_tts_incremental(sessions[0], flow, fcfg, hift, hcfg, dev)
    profile_tts_ticks(flow, fcfg, hift, hcfg, dev)
    log("tts_check " + json.dumps({
        "replay_max_wav_err": replay_err,
        "replay_tol": TTS_REPLAY_WAV_ATOL, "incremental": inc,
        "incremental_mel_tol": TTS_INC_MEL_ATOL}))
    if not replay_err <= TTS_REPLAY_WAV_ATOL:
        fail(f"replayed session differs from its batched row by "
             f"{replay_err:.3e} > {TTS_REPLAY_WAV_ATOL}")
    if not inc["max_mel_err"] <= TTS_INC_MEL_ATOL:
        fail(f"incremental mel differs from the recompute by "
             f"{inc['max_mel_err']:.3e} > {TTS_INC_MEL_ATOL}")
    del coord, flow, hift
    torch.cuda.empty_cache()
    log(f"tts serve phase s={time.perf_counter() - t_phase:.2f} (fp32 "
        f"flow and HiFT, TF32 off), device memory still allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    return counts


# phase 3d, the contiguous-cache engines on the JAX benchmark's decode
# modes (bench.py: decode, decode_spec_greedy, decode_serving16, serve
# --serve_phase continuous, tts_streaming)
# Cut to keep the phase near its budget (a B = 1 step is host-bound at
# ~37-55 ms): decode and the plain and ngram spec streams run 64 tokens
# (bench: 256), layer_skip 16, decode_serving16 64, the continuous
# workload has factor 1 (16 requests + the 2 long ones) and caps of at
# most 224 tokens (bench: 448), tts_streaming
# 51 tokens (bench: 151)
DEC_PROMPT, DEC_TOKENS, DEC_MAX_LEN = 128, 64, 4096
SPEC_GAMMA, SPEC_LAYERS, SPEC_MOTIF, SPEC_MAX_LEN = 7, 7, 8, 1024
SPEC_SKIP_TOKENS = 16           # cut from 32
B16_STREAMS, B16_PREFIX, B16_MAX_LEN, B16_TOKENS = 16, 700, 2048, 64
CONT_SLOTS, CONT_FACTOR, CONT_CHUNK, CONT_MAX_LEN = 16, 1, 32, 2048
CONT_LONG = (700, 1000)
CONT_CAP = 224                  # the requests' longest cap (bench: 448)
TTS_STREAM_PROMPT, TTS_STREAM_GEN, TTS_STREAM_MAX_LEN = 128, 51, 1024
# The greedy gates (speculative and continuous against the plain
# single-stream decode) run on the model upcast to fp32 with TF32 off: a
# greedy argmax over 159,488 random-weight logits flips on bf16 rounding
# differences between GEMM shapes (an 8-token verify or a 16-row step
# against a 1-token step; on the H100 the bf16 drafts left the plain
# stream at token 231 of 256, a continuous request at token 2), which is
# no fault of either engine. The bf16 drafts' agreement is logged. The
# gates' depths: 64 tokens for the plain and ngram streams, 32 for
# layer_skip, 32 for the first 3 continuous requests.
GATE_TOKENS, GATE_SKIP_TOKENS, CONT_CHECK_N, CONT_CHECK_NEW = 64, 32, 3, 32


def greedy_sp(cfg, n: int) -> SamplingParams:
    """bench.py's greedy decode: argmax, penalty and RAS off, n tokens."""
    return SamplingParams(temperature=1.0, top_k=1, top_p=1.0,
                          use_ras=False, repetition_penalty=1.0,
                          min_tokens=n, max_tokens=n,
                          stop_token_ids=(cfg.eos_token_id,))


def common_prefix(a, b) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


def decode_single(cfg, model, dev) -> dict:
    """bench.py ``decode``: B 1, a 128-token random prompt, 64 tokens
    (min = max), the default sampler with topk_method "approx"; a
    warm-up, then one timed generate."""
    sp = SamplingParams(max_tokens=DEC_TOKENS, min_tokens=DEC_TOKENS,
                        stop_token_ids=(cfg.eos_token_id,),
                        topk_method="approx")
    prompt = np.random.default_rng(SEED + 40).integers(
        0, cfg.vocab_size, DEC_PROMPT).tolist()
    # how much of a B = 1 step the card is busy (8 steps a run; its
    # first run is the warm-up)
    short = DecodeEngine(model, cfg, dataclasses.replace(
        sp, max_tokens=8, min_tokens=8), max_len=DEC_MAX_LEN, seed=SEED,
        device=dev)

    def run():
        short.generate(prompt)
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    profile_step("decode engine B 1 (prefill 128 + 8 steps)", run, {},
                 top=6)
    log(f"decode engine profile s={time.perf_counter() - t0:.2f}")
    eng = DecodeEngine(model, cfg, sp, max_len=DEC_MAX_LEN, seed=SEED,
                       device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = len(eng.generate(prompt)["token_ids"])
    dt = time.perf_counter() - t0
    if n != DEC_TOKENS:
        fail(f"decode: {n} tokens for min = max {DEC_TOKENS}")
    return {"tokens": n, "seconds": dt, "tokens_per_s": n / dt,
            "step_ms": dt / n * 1e3, "audio_rtf": n / 25.0 / dt}


def spec_engines(cfg, model, dev, n: int, skip_n: int, **kw):
    """(name, engine) of the plain greedy decode (n tokens) and of the
    ngram (n) and layer_skip (skip_n, 7 layers) drafts at gamma 7."""
    drafts = {"plain": (n, {}), "ngram": (n, {}),
              "layer_skip": (skip_n, {"spec_draft": "layer_skip",
                                      "spec_layers": SPEC_LAYERS})}
    for name, (tokens, extra) in drafts.items():
        gamma = 0 if name == "plain" else SPEC_GAMMA
        yield name, DecodeEngine(model, cfg, greedy_sp(cfg, tokens),
                                 max_len=SPEC_MAX_LEN, seed=SEED,
                                 spec_gamma=gamma, device=dev, **kw,
                                 **extra)


def decode_spec(cfg, model, dev) -> dict:
    """bench.py ``decode_spec_greedy``: gamma 7, greedy, a repetitive
    8-token speech motif prompt, max_len 1024; the plain decode and the
    ngram draft over 64 tokens, the layer_skip draft (7 layers) over 16,
    timed, with the drafts' verify iterations."""
    rng = np.random.default_rng(SEED + 41)
    motif = rng.integers(cfg.speech_token_offset, cfg.vocab_size,
                         SPEC_MOTIF).tolist()
    prompt = (motif * 16)[:DEC_PROMPT]
    res, streams = {}, {}
    for name, eng in spec_engines(cfg, model, dev, DEC_TOKENS,
                                  SPEC_SKIP_TOKENS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = eng.generate(prompt)["token_ids"]
        dt = time.perf_counter() - t0
        streams[name] = toks
        res[name] = {"tokens": len(toks), "seconds": dt,
                     "tokens_per_s": len(toks) / dt}
        if name != "plain":
            res[name].update(
                verify_iterations=eng.n_spec_iterations,
                tokens_per_iteration=len(toks) / max(eng.n_spec_iterations,
                                                     1),
                bf16_equal_prefix=common_prefix(toks, streams["plain"]),
                speedup=len(toks) / dt / res["plain"]["tokens_per_s"])
    res["prompt"] = prompt
    return res


def decode_serving16(cfg, model, dev) -> tuple:
    """bench.py ``decode_serving16`` in bf16: generate_batch of 16 prompts,
    a 700-token shared prefix + 64-128 distinct tokens each, max_len
    2048, 64 tokens (bench: 256). The first call (8 tokens) prefills the
    prefix alone (width 768: K1-fwd) into the prefix cache; then one
    timed call without the prefix cache (``cold_seconds``) and one with
    it. Returns (flash-width prefills, the line's fields)."""
    rng = np.random.default_rng(SEED + 42)
    shared = rng.integers(0, cfg.vocab_size, B16_PREFIX).tolist()
    prompts = [shared + rng.integers(0, cfg.vocab_size, int(
        rng.integers(64, 128))).tolist() for _ in range(B16_STREAMS)]
    sp = SamplingParams(max_tokens=B16_TOKENS, min_tokens=B16_TOKENS,
                        stop_token_ids=(cfg.eos_token_id,),
                        topk_method="approx")
    eng = DecodeEngine(model, cfg, sp, max_len=B16_MAX_LEN, seed=SEED,
                       device=dev)
    eng.generate_batch(prompts, max_new=8)      # warm-up, fills the cache
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cold = eng.generate_batch(prompts, use_prefix_cache=False)
    cold_s = time.perf_counter() - t0
    del cold
    t0 = time.perf_counter()
    outs = eng.generate_batch(prompts)
    dt = time.perf_counter() - t0
    n = sum(len(o) for o in outs)
    if [len(o) for o in outs] != [B16_TOKENS] * B16_STREAMS:
        fail(f"decode_serving16: {[len(o) for o in outs]} tokens")
    width = eng._bucketed(B16_PREFIX)
    del eng, outs
    torch.cuda.empty_cache()
    return int(is_flash_width(width)), {
        "streams": B16_STREAMS, "prefix_len": B16_PREFIX,
        "prefix_width": width, "tokens": n, "seconds": dt,
        "tokens_per_s": n / dt, "step_ms": dt / B16_TOKENS * 1e3,
        "audio_rtf": n / B16_STREAMS / 25.0 / dt, "cold_seconds": cold_s,
        "prefix_cache_speedup": cold_s / dt}


def continuous_workload(cfg):
    """bench.py's ``_serve_workload`` at 16 slots (factor 1, bench's 3:
    16 requests of 64-128 tokens, caps clip(exp(160), 32, CONT_CAP; bench
    448)), then two
    long prompts of 700 and 1,000 tokens (flash widths 768 and
    1,024)."""
    rng = np.random.default_rng(SEED + 43)
    N = CONT_FACTOR * CONT_SLOTS
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(
        64, 128))).tolist() for _ in range(N)]
    caps = np.clip(rng.exponential(160, N).astype(int), 32,
                   CONT_CAP).tolist()
    for n in CONT_LONG:
        prompts.append(rng.integers(0, cfg.vocab_size, n).tolist())
        caps.append(int(np.clip(rng.exponential(160), 32, CONT_CAP)))
    return prompts, caps


def serve_continuous(cfg, model, dev) -> tuple:
    """bench.py ``serve --serve_phase continuous``: ContinuousEngine(slots
    16, max_len 2048, chunk_steps 32), bench's sampler (max 512, min 1,
    topk_method "approx"); a warm-up over the first 16 prompts (8
    tokens), then the workload. Returns (flash-width prefills, fields)."""
    prompts, caps = continuous_workload(cfg)
    sp = SamplingParams(max_tokens=512, min_tokens=1,
                        stop_token_ids=(cfg.eos_token_id,),
                        topk_method="approx")
    eng = ContinuousEngine(model, cfg, sp, slots=CONT_SLOTS,
                           max_len=CONT_MAX_LEN, chunk_steps=CONT_CHUNK,
                           seed=SEED, device=dev)
    eng.serve(prompts[:CONT_SLOTS], max_new=8)
    eng.n_decode_steps = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = eng.serve(prompts, max_new_per_request=caps)
    dt = time.perf_counter() - t0
    n = sum(len(o) for o in outs)
    for rid, (o, c) in enumerate(zip(outs, caps)):
        if not 0 < len(o) <= c or (len(o) < c
                                   and o[-1] != cfg.eos_token_id):
            fail(f"continuous request {rid}: {len(o)} tokens for cap {c}")
    widths = [eng._bucketed(len(p)) for p in prompts[:CONT_SLOTS]
              + prompts]
    steps = eng.n_decode_steps
    del eng, outs
    torch.cuda.empty_cache()
    return sum(map(is_flash_width, widths)), {
        "requests": len(prompts), "slots": CONT_SLOTS,
        "prompt_tokens": sum(map(len, prompts)), "generated_tokens": n,
        "seconds": dt, "tokens_per_s": n / dt, "decode_steps": steps,
        "slot_steps": CONT_SLOTS * steps, "slot_use": n / max(
            CONT_SLOTS * steps, 1)}


def tts_streaming(cfg, model, dev, fcfg=None, hcfg=None) -> dict:
    """bench.py ``tts_streaming``: stream_tts over DecodeEngine(max_len
    1024), a 128-token LLM prompt, 51 tokens (bench: 151; min = max, the
    default sampler), a 75-token flow prompt, 150 prompt mel frames, a
    192-dim speaker vector; the full-size flow and HiFT in fp32 (TF32
    off), in the recompute and the incremental form (fp32 caches). The
    random student's ids are folded into the speech range. Fails unless
    each wav is finite and (2 (75 + 75) - 150) x 480 samples long and
    the streamed tokens equal generate() under the same seed."""
    fcfg = fcfg or flow_lib.FlowConfig()
    hcfg = hcfg or hift_lib.HiFTConfig()
    flow = flow_lib.init_params(fcfg, seed=SEED, device=dev)
    hift = hift_lib.init_params(hcfg, seed=SEED, device=dev)
    rng = np.random.default_rng(SEED + 44)
    ftoks = rng.integers(0, fcfg.vocab_size, TTS_FLOW_PROMPT).tolist()
    pmel = (rng.normal(size=(TTS_PROMPT_MEL, fcfg.output_size))
            * 0.1).astype(np.float32)
    spk = rng.normal(size=(fcfg.spk_embed_dim,)).astype(np.float32)
    llm_prompt = rng.integers(0, cfg.vocab_size, TTS_STREAM_PROMPT).tolist()
    sp = SamplingParams(max_tokens=TTS_STREAM_GEN, min_tokens=TTS_STREAM_GEN,
                        stop_token_ids=(cfg.eos_token_id,),
                        topk_method="approx")
    offset = cfg.speech_token_offset

    def engine():
        return DecodeEngine(model, cfg, sp, max_len=TTS_STREAM_MAX_LEN,
                            seed=SEED, device=dev)
    want = (2 * (TTS_FLOW_PROMPT + TTS_STREAM_GEN - 1)
            - TTS_PROMPT_MEL) * hcfg.upsample_scale
    # warm-up: one flow and one HiFT call at one stream (cuDNN plans)
    StreamingTokenToWav(flow, fcfg, hift, hcfg, ftoks, pmel, TTS_PROMPT_MEL,
                        spk, 0, device=dev).push(list(range(50)), final=True)
    res, wavs, raw = {}, {}, []
    for form, kw in (("recompute", {}), ("incremental", dict(
            incremental=True, inc_kv_dtype=torch.float32,
            inc_max_frames=2 * (TTS_FLOW_PROMPT + TTS_STREAM_GEN) + 512))):
        folder = FoldSpeechIds(engine(), offset, fcfg.vocab_size)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        marks, chunks = [], []
        for wav in stream_tts(folder, flow, fcfg, hift, hcfg, llm_prompt,
                              offset, ftoks, pmel, TTS_PROMPT_MEL, spk,
                              SEED + 300, device=dev, **kw):
            chunks.append(wav)
            marks.append(time.perf_counter() - t0)
        wall = marks[-1]
        wav = np.concatenate(chunks)
        raw.append([t for c in folder.raw_chunks for t in c])
        if not np.isfinite(wav).all() or wav.shape != (want,):
            fail(f"tts_streaming {form}: wav {wav.shape} (finite "
                 f"{bool(np.isfinite(wav).all())}), want ({want},)")
        gaps = np.diff(marks) * 1e3
        k = min(10, max(1, len(gaps) // 3))
        wavs[form] = wav
        res[form] = {"ttfa_s": marks[0], "wall_s": wall,
                     "x_realtime": wav.shape[0] / hcfg.sampling_rate / wall,
                     "chunks": len(chunks),
                     "gap_ms_first": float(np.median(gaps[:k])),
                     "gap_ms_last": float(np.median(gaps[-k:]))}
    ref = engine().generate(llm_prompt)["token_ids"]
    if not raw[0] == raw[1] == ref or len(ref) != TTS_STREAM_GEN:
        fail(f"tts_streaming: streamed tokens differ from generate() under "
             f"the same seed (equal prefix "
             f"{common_prefix(raw[0], ref)} / {common_prefix(raw[1], ref)}"
             f" of {len(ref)})")
    res["audio_s"] = want / hcfg.sampling_rate
    res["incremental_max_wav_err"] = float(
        np.abs(wavs["incremental"] - wavs["recompute"]).max())
    del flow, hift
    torch.cuda.empty_cache()
    return res


def check_greedy_gates(cfg, model, dev, spec_prompt) -> dict:
    """On the model upcast to fp32: the ngram and layer_skip drafts
    against the plain decode on the spec prompt, and the first 3
    continuous requests (16 slots) against each decoded alone, greedy
    (depths: see the constants); fails unless the token lists are
    equal."""
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model32 = qwen3.Qwen3(cfg32, dev)
    for p32, p in zip(model32.parameters(), model.parameters()):
        p32.data.copy_(p.float())
    streams = {name: eng.generate(spec_prompt)["token_ids"]
               for name, eng in spec_engines(
                   cfg32, model32, dev, GATE_TOKENS, GATE_SKIP_TOKENS,
                   cache_dtype=torch.float32)}
    out = {f"spec_{name}_fp32_equal": streams[name] == streams["plain"][
        :len(streams[name])] for name in ("ngram", "layer_skip")}
    prompts = continuous_workload(cfg)[0][:CONT_CHECK_N]
    sp = greedy_sp(cfg, CONT_CHECK_NEW)
    got = ContinuousEngine(model32, cfg32, sp, slots=CONT_SLOTS,
                           max_len=CONT_MAX_LEN, chunk_steps=CONT_CHUNK,
                           seed=SEED, cache_dtype=torch.float32,
                           device=dev).serve(prompts)
    alone = [DecodeEngine(model32, cfg32, sp, max_len=CONT_MAX_LEN,
                          seed=SEED, cache_dtype=torch.float32,
                          device=dev).generate(p)["token_ids"]
             for p in prompts]
    out["continuous_fp32_equal_prefix"] = [common_prefix(a, b)
                                           for a, b in zip(got, alone)]
    out["continuous_fp32_equal"] = got == alone
    del model32
    torch.cuda.empty_cache()
    log("decode_engines_check " + json.dumps(out))
    if not all(v for k, v in out.items() if k.endswith("_equal")):
        fail(f"a greedy gate failed: {out}")
    return out


def decode_engines(cfg, model, dev, fcfg=None, hcfg=None) -> dict:
    """Phase 3d: the contiguous-cache engines at full width, bf16 caches.
    The launch counts are set to 0 before the first engine runs and read
    after the last; fails unless K1-fwd ran 28 times a flash-width
    prefill (the serving16 prefix, the continuous long prompts), K3 and
    K4 never, and the layers' elementwise kernels a whole layer at a
    time with a final norm a forward. Then the greedy gates. Returns the
    launch counts."""
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    res = {}
    t0 = time.perf_counter()
    res["decode"] = decode_single(cfg, model, dev)
    res["decode"]["phase_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    spec = decode_spec(cfg, model, dev)
    spec_prompt = spec.pop("prompt")
    res["spec_greedy"] = spec
    res["spec_greedy"]["phase_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    flash_b16, res["serving16"] = decode_serving16(cfg, model, dev)
    res["serving16"]["phase_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    flash_cont, res["continuous"] = serve_continuous(cfg, model, dev)
    res["continuous"]["phase_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res["tts_streaming"] = tts_streaming(cfg, model, dev, fcfg, hcfg)
    res["tts_streaming"]["phase_s"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    counts = dict(_cuda.launches)
    res["device_memory_gib"] = {
        "peak": torch.cuda.max_memory_allocated() / 2**30,
        "allocated": torch.cuda.memory_allocated() / 2**30}
    res["launches"] = counts
    log("decode_engines " + json.dumps(res))
    L = cfg.num_hidden_layers
    want = L * (flash_b16 + flash_cont)
    if counts.get("flash_fwd", 0) != want or not want:
        fail(f"decode engines flash_fwd launches "
             f"{counts.get('flash_fwd', 0)} != layers x flash-width "
             f"prefills {want}")
    for k in ("paged_decode", "paged_decode_int8", "int4_matmul"):
        if counts.get(k, 0):
            fail(f"decode engines launched {k} {counts[k]} times")
    # the layers' elementwise kernels: a layer's three together, one final
    # norm a forward (the layer-skip drafts' forwards run fewer than L
    # layers), nothing of a backward
    f = {k: counts.get(k, 0) for k in FUSED_NAMES}
    forwards = f["rms_norm_fwd"] - 2 * f["qk_norm_rope_fwd"]
    if (f["qk_norm_rope_fwd"] != f["swiglu_fwd"] or forwards < 1
            or not forwards <= f["qk_norm_rope_fwd"] <= L * forwards
            or f["rms_norm_bwd"] or f["qk_norm_rope_bwd"]
            or f["swiglu_bwd"]):
        fail(f"decode engines fused_norm launches {f}")
    check_greedy_gates(cfg, model, dev, spec_prompt)
    log(f"decode engines phase s={time.perf_counter() - t_phase:.2f}, "
        f"device memory still allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    return counts


def check_k4_per_step(k4, L: int, what: str) -> None:
    """K4 by kernel name in a decode profile: once a layer a decode step."""
    if k4["launches_per_step"] != L:
        fail(f"{what}: paged_decode_kernel launched "
             f"{k4['launches_per_step']} times a decode step by kernel "
             f"name, not {L}")


def profile_decode(eng, lens, cfg, rng, what: str = "decode serve",
                   groups=None) -> dict:
    """Where a decode-heavy serve spends its time: the same serve (fresh
    random prompts of the given lengths, 32 tokens each) timed without the
    profiler, then traced with it for the time of each CUDA kernel. Device
    busy share = kernel time / unprofiled wall time. ``groups`` maps a
    label to a substring of kernel names whose time and launches are
    summed, in all and a decode step (the profiled serve's steps);
    returns {label: {"ms_per_step", "launches_per_step"}}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def run():
        eng.serve([rng.integers(1, cfg.vocab_size - 2, n).tolist()
                   for n in lens], max_new=32)
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    wall_us = (time.perf_counter() - t0) * 1e6
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    steps = eng.n_decode_steps
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda e: -e.self_device_time_total)
    busy_us = sum(e.self_device_time_total for e in rows)
    log(f"profile {what}: {len(lens)} requests x 32 tokens, "
        f"{steps} steps, wall_ms={wall_us / 1e3:.2f} (unprofiled) "
        f"device_kernel_ms={busy_us / 1e3:.2f} (profiled) busy_share="
        f"{busy_us / wall_us:.3f}")
    per_step = {}
    for label, key in (groups or {}).items():
        sel = [e for e in rows if key in e.key]
        us = sum(e.self_device_time_total for e in sel)
        n = sum(e.count for e in sel)
        per_step[label] = {"ms_per_step": us / 1e3 / max(steps, 1),
                           "launches_per_step": n / max(steps, 1)}
        log(f"  {label} ({key}): kernel_ms={us / 1e3:.3f} launches={n} "
            f"per decode step: ms={us / 1e3 / max(steps, 1):.4f} "
            f"launches={n / max(steps, 1):.1f}")
    for e in rows[:8]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x "
            f"{e.key[:90]}")
    host = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)
    log(f"  host: {sum(e.self_cpu_time_total for e in host) / 1e3:.2f} ms "
        f"of CPU self time (profiled), the largest:")
    for e in host[:8]:
        log(f"  {e.self_cpu_time_total / 1e3:9.3f} ms {e.count:6d}x "
            f"{e.key[:90]}")
    return per_step


K4_CHECK_LENS = [0, 1, 127, 128, 129, 255, 256, 511, 640, 1000, 1023, 1024,
                 1500, 1920, 2047, 2048]


def k4_check(dev, side, launches: int, quantized: bool, KV: int = 8
             ) -> dict:
    """K4 (bf16 pool) or K4-int8 (int8 pool and scales from
    ``quantize_kv`` of seeded bf16 K/V) at the serve's shapes: 16 rows,
    KV 8 (a tp-2 rank's 4 with ``KV``), G 2, Dh 128, page 128, lengths
    0..2048 (idle row, page boundaries), layer 1 of 2, against the plain
    version in fp32 on the same bf16 inputs or int8 codes. Timed by
    CUDA-graph replays on ``side`` (``ms``) beside eager calls between
    CUDA events (``host_ms``, what a call costs with its host work)."""
    name = "paged_decode_int8" if quantized else "paged_decode"
    rng = np.random.default_rng(SEED + (12 if quantized else 1))
    B, G, Dh, ps, mp, L = 16, 2, 128, 128, 16, 2
    P = B * mp

    def rnd(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)
                                ).to(dev, torch.bfloat16)
    q = rnd(B, KV, G, Dh)
    if quantized:
        kp, ks = quantize_kv(rnd(L, P + 1, KV, ps, Dh))
        vp, vs = quantize_kv(rnd(L, P + 1, KV, ps, Dh))
        kw = dict(layer=1, k_scale=ks, v_scale=vs)
        ref_pools = (kp, vp)
    else:
        kp, vp = rnd(L, P + 1, KV, ps, Dh), rnd(L, P + 1, KV, ps, Dh)
        kw = dict(layer=1)
        ref_pools = (kp.float(), vp.float())
    bt = torch.from_numpy(rng.permutation(P).reshape(B, mp).astype(
        np.int32)).to(dev)
    lengths = torch.tensor(K4_CHECK_LENS, dtype=torch.int32, device=dev)
    args = (q, kp, vp, bt, lengths)
    got = paged_attention(*args, **kw)
    torch.cuda.synchronize()
    ref = paged_attention_plain(q.float(), *ref_pools, bt, lengths, **kw)
    err = (got.float() - ref).abs().max().item()
    if not bool(torch.all(got[0] == 0)):
        fail(f"{name}: idle row is not exact zeros")
    log(f"{name} max_abs_err={err:.3e} tol={KERNEL_ATOL} (bf16 output "
        f"rounding vs the plain version in fp32 on the same "
        f"{'int8 codes and scales' if quantized else 'bf16 inputs'})")
    if not err <= KERNEL_ATOL:
        fail(f"{name} disagrees with its plain version: {err}")
    ms = graph_ms(lambda: paged_attention(*args, **kw), side)
    host_ms = time_ms(lambda: paged_attention(*args, **kw))
    plain_ms = graph_ms(lambda: paged_attention_plain(*args, **kw), side)
    resident = sum(K4_CHECK_LENS)
    pages_read = sum(-(-n // ps) for n in K4_CHECK_LENS)
    row_bytes = Dh * (1 if quantized else 2)
    nbytes = (resident * KV * row_bytes * 2       # K and V rows
              + (resident * KV * 4 * 2 if quantized else 0)   # scales
              + 2 * q.numel() * 2                 # q in, out
              + pages_read * 4 + B * 4)           # block tables, lengths
    flops = 4 * G * Dh * KV * resident
    bound_ms, bound_by = bound(nbytes, flops)
    plan = k4_plan(B, KV, mp, ps, Dh, kp.dtype, _sm_count(dev))
    log(f"{name} at KV {KV} plan: splits={plan.splits} pages_per_split="
        f"{plan.pages_per_split} stage_tokens={plan.stage_tokens} "
        f"stages={plan.stages}; ms={ms:.5f} (graph) host_ms={host_ms:.4f} "
        f"(events, eager calls) plain_ms={plain_ms:.4f} bound_ms="
        f"{bound_ms:.5f} ({bound_by}, {nbytes / 1e6:.2f} MB) GB/s="
        f"{nbytes / ms / 1e6:.1f}")
    return {"name": name, "route": "cuda",
            "source": "speech_distill_tpu_torch/csrc/paged_decode.cu",
            "replaces": "speech_distill_tpu/ops/paged_attention.py:55",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "kernel_ms": ms, "host_ms": host_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "plan": plan._asdict(), "gb_per_s": nbytes / ms / 1e6,
            "shape": {"B": B, "KV": KV, "G": G, "Dh": Dh, "page": ps},
            **({"path": "tp2 serve"} if KV != 8 else {})}


def flash_inputs(rng, dev, B: int, T: int, n: int = 3, H: int = 16,
                 KV: int = 8, Dh: int = 128) -> list:
    """q [B, T, H, Dh], k and v [B, T, KV, Dh] (and, for n 4, a dO like
    q): bf16 of N(0, 1), the model's head layout."""
    return [torch.from_numpy(rng.standard_normal((B, T, h, Dh), np.float32)
                             ).to(dev, torch.bfloat16)
            for h in (H, KV, KV, H)[:n]]


def sdpa_inputs(q, k, v, grad: bool = False) -> tuple:
    """q, k, v for PyTorch's fused SDPA, the yardstick only (never called
    by the port): [B, heads, T, Dh], the KV heads repeated to H once here,
    outside every timing."""
    G = q.shape[2] // k.shape[2]
    out = (q.transpose(1, 2), k.repeat_interleave(G, dim=2).transpose(1, 2),
           v.repeat_interleave(G, dim=2).transpose(1, 2))
    return tuple(t.detach().requires_grad_() for t in out) if grad else out


def flash_fwd_entry(what: str, q, k, v, launches: int, err: float, side,
                    plain_iters: int = 20) -> dict:
    """The kernels-line entry of K1-fwd at one path's shape: the kernel and
    the SDPA yardstick timed by CUDA-graph replays (:func:`graph_ms`: a
    call here is shorter than its host work), the plain version by
    events."""
    B, T, H, Dh = q.shape
    ms = graph_ms(lambda: flash_attention_fwd(q, k, v), side)
    plain_ms = time_ms(lambda: flash_attention_fwd_plain(q, k, v),
                       iters=plain_iters, warmup=1)
    qt, kt, vt = sdpa_inputs(q, k, v)
    library_ms = graph_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), side)
    del qt, kt, vt
    nbytes = (q.numel() * 2 * 2 + k.numel() * 2 * 2   # q, o, k, v bf16
              + B * H * T * 4)                         # lse fp32
    flops = 2 * B * H * T * T * Dh                     # causal QK^T + PV
    bound_ms, bound_by = bound(nbytes, flops)
    log(f"flash_fwd at the {what} shape B {B} T {T} H {H} KV {k.shape[2]} "
        f"Dh {Dh}: ms={ms:.4f} ({flops / ms / 1e9:.1f} TFLOP/s) "
        f"library_ms={library_ms:.4f} (SDPA causal; kernel / SDPA "
        f"{ms / library_ms:.2f}) plain_ms={plain_ms:.4f} bound_ms="
        f"{bound_ms:.5f} ({bound_by}) launches={launches} (graph replays)")
    return {"name": "flash_fwd", "route": "cuda",
            "source": "speech_distill_tpu_torch/csrc/flash_fwd.cu",
            "replaces": "speech_distill_tpu/ops/flash_attention.py:28",
            "path": what, "shape": [B, T, H, k.shape[2], Dh],
            "launches": launches, "max_abs_err": err, "ms": ms,
            "kernel_ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "timing": "graph"}


def check_flash_fwd(q, k, v, what: str) -> float:
    """K1-fwd against its plain version in fp32 on the same bf16 inputs;
    returns max(|o - plain|, |lse - plain|)."""
    o, lse = flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    ref_o, ref_lse = flash_attention_fwd_plain(q.float(), k.float(),
                                               v.float())
    err = (o.float() - ref_o).abs().max().item()
    err_lse = (lse - ref_lse).abs().max().item()
    log(f"flash_fwd at the {what} check shape {list(q.shape)}: "
        f"max_abs_err o={err:.3e} tol={KERNEL_ATOL} (bf16 output and bf16 "
        f"P), lse={err_lse:.3e} tol={LSE_ATOL} (fp32)")
    if not (err <= KERNEL_ATOL and err_lse <= LSE_ATOL):
        fail(f"flash_fwd disagrees with its plain version at the {what} "
             f"shape: {err}, {err_lse}")
    return max(err, err_lse)


def check_flash_serve(dev, launches: int, side) -> dict:
    """K1-fwd at the long-prompt prefill's shape: B 1, T 1024, H 16,
    KV 8, Dh 128."""
    rng = np.random.default_rng(SEED + 2)
    q, k, v = flash_inputs(rng, dev, 1, 1024)
    err = check_flash_fwd(q, k, v, "serve")
    return flash_fwd_entry("serve", q, k, v, launches, err, side)


def check_model_path(cfg, model, dev) -> None:
    """Phase 5: decode steps of paged_forward through the kernel and
    through the plain version, in bf16 (the serving dtype) and in fp32
    (same weights upcast, the kernel's fp32 instantiation), from the same
    random KV history, with one dead row."""
    rng = np.random.default_rng(SEED + 3)
    B, ps, mp, steps = 4, 128, 4, 4
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model32 = qwen3.Qwen3(cfg32, dev)
    for p32, p in zip(model32.parameters(), model.parameters()):
        p32.data.copy_(p.float())
    runs = {}                        # (dtype, impl) -> (model, pool)
    hist = None
    for name, m, c, dt in (("bf16", model, cfg, torch.bfloat16),
                           ("fp32", model32, cfg32, torch.float32)):
        for impl in ("kernel", "plain"):
            pool = PagedKVCache.create(c, B * mp, ps, dt, dev)
            if hist is None:
                hist = torch.from_numpy(rng.standard_normal(
                    tuple(pool.k.shape), np.float32)).to(dev, torch.bfloat16)
            pool.k.copy_(hist)
            pool.v.copy_(hist.flip(-1))
            runs[name, impl] = (m, pool)
    bt = torch.from_numpy(rng.permutation(B * mp).reshape(B, mp).astype(
        np.int32)).to(dev)
    lengths = torch.tensor([0, 100, 128, 300], dtype=torch.int64,
                           device=dev)
    live = torch.tensor([True, True, True, False], device=dev)
    err = dict.fromkeys(("fp32", "bf16_kernel", "bf16_plain"), 0.0)
    for _ in range(steps):
        tok = torch.from_numpy(rng.integers(1, cfg.vocab_size - 2, B)).to(dev)
        out = {key: paged_forward(m, tok, pool, bt, lengths, live, key[1])
               for key, (m, pool) in runs.items()}
        if not all(bool(torch.isfinite(o).all()) for o in out.values()):
            fail("paged_forward produced non-finite logits")
        ref = out["fp32", "plain"][live]

        def dist(key):
            return (out[key][live] - ref).abs().max().item()
        err["fp32"] = max(err["fp32"], dist(("fp32", "kernel")))
        err["bf16_kernel"] = max(err["bf16_kernel"], dist(("bf16", "kernel")))
        err["bf16_plain"] = max(err["bf16_plain"], dist(("bf16", "plain")))
        lengths = lengths + live
    log(f"model path: {steps} decode steps, max |logits - fp32 plain|: "
        f"fp32 kernel {err['fp32']:.3e} (tol {FP32_LOGITS_ATOL}), bf16 "
        f"kernel {err['bf16_kernel']:.3e}, bf16 plain {err['bf16_plain']:.3e}"
        f" (bf16 kernel must stay within {BF16_ERR_RATIO}x the bf16 plain "
        f"route's error)")
    if not err["fp32"] <= FP32_LOGITS_ATOL:
        fail(f"fp32 decode logits through the kernel disagree: {err}")
    if not err["bf16_kernel"] <= BF16_ERR_RATIO * err["bf16_plain"]:
        fail(f"bf16 decode through the kernel is less accurate: {err}")


def serve_quant(cfg, model, dev):
    """Quantized serving: the same seeded model quantized as
    ``quantize_params(bits=4, method="int4", quantize_embed=True)`` (int4
    projections through K3, an int8 tied embed/head), served from an int8
    page pool (decode through K4-int8) with the bf16 serve's traffic, in
    512-token prefill pieces and with logprobs. Returns the quantized
    model and the launch counts of the serve."""
    t0 = time.perf_counter()
    tree = model_to_tree(model)
    dense_bytes = param_bytes(tree)
    qtree = quantize_params(tree, bits=4, method="int4", quantize_embed=True)
    del tree
    qmodel = params_from_jax(qtree, cfg, dev)
    quant_bytes = param_bytes(qtree)
    del qtree
    torch.cuda.synchronize()
    log(f"quantize int4 layers + int8 embed s={time.perf_counter() - t0:.2f}")
    sp = SamplingParams(stop_token_ids=(cfg.eos_token_id,))
    eng = PagedEngine(qmodel, cfg, sp, slots=16, max_len=2048,
                      page_size=128, seed=SEED, device=dev,
                      cache_dtype=torch.int8, prefill_chunk=FEATURE_CHUNK,
                      return_logprobs=True)
    L, P = cfg.num_hidden_layers, eng.num_pages + 1
    kv_elems = L * P * cfg.num_key_value_heads * eng.ps * cfg.head_dim
    pool_bytes = 2 * kv_elems + 2 * (kv_elems // cfg.head_dim) * 4
    counts, lens, rng = serve_traffic(
        cfg, eng, "serve_quant", pool_bytes=pool_bytes,
        bf16_pool_bytes=2 * kv_elems * 2, weight_bytes=quant_bytes,
        bf16_weight_bytes=dense_bytes)
    want = {"paged_decode_int8": L * eng.n_decode_steps,
            "int4_matmul": QUANT_PROJ * L * (eng.n_decode_steps
                                             + eng.n_prefill_forwards),
            "paged_decode": 0}
    if {k: counts[k] for k in want} != want:
        fail(f"quantized serve launches {counts} != {want} (K4-int8 once a "
             f"layer a decode step; K3 for the 7 projections of every "
             f"layer of every model forward)")
    check_serve_launches("quantized serve", counts, L, eng)
    need = sum(pieces_needed(n, FEATURE_CHUNK, eng.ps) for n in lens)
    if eng.n_prefill_chunks < need:
        fail(f"quantized serve ran {eng.n_prefill_chunks} prefill pieces, "
             f"its long prompts need {need}")
    lps = eng.request_logprobs
    if [len(lp) for lp in lps] != [m["n_gen"] for m in eng.request_metrics] \
            or not all(np.isfinite(x) and x <= 0 for lp in lps for x in lp):
        fail("quantized serve logprobs not finite and <= 0, one a token")
    per_step = profile_decode(eng, lens[:13], cfg, rng,
                              "quantized decode serve",
                              {"k3_decode": "int4_decode_kernel",
                               "k3_prefill": "int4_prefill_kernel",
                               "k4_int8": "paged_decode_kernel"})
    check_k4_per_step(per_step["k4_int8"], L, "quantized serve")
    return qmodel, counts


def check_int4_matmul(dev, qmodel, launches: int) -> dict:
    """K3 on the quantized model's layer-0 gate (1024 -> 3072), down
    (3072 -> 1024), q (1024 -> 2048) and o (2048 -> 1024) codes at M 16
    (a decode step, the decode kernel) and M 1024 (a batched prefill,
    the wgmma kernel): the kernel on bf16 x (the serving route) and on
    the same values in fp32 (fp32 output, so only summation order differs) against
    ``int4_matmul_plain``. Timed on the device (:func:`graph_ms`) beside
    its bound, the plain version, cuBLAS on the weight dequantized to bf16
    once beforehand (what the bf16 model pays) and
    dequantize-then-matmul."""
    rng = np.random.default_rng(SEED + 11)
    side = torch.cuda.Stream()
    mlp, attn = qmodel.layers[0].mlp, qmodel.layers[0].attn
    rows, err, err_bf16 = [], 0.0, 0.0
    for name, leaf in (("gate", mlp.gate.leaf), ("down", mlp.down.leaf),
                       ("q", attn.q.leaf), ("o", attn.o.leaf)):
        packed, scale = leaf["q4"], leaf["scale"]
        K2, N = packed.shape
        K = 2 * K2
        w_bf16 = dequantize_array(leaf, torch.bfloat16)
        for M in (16, 1024):
            x = torch.from_numpy(rng.standard_normal((M, K), np.float32)).to(
                dev, torch.bfloat16)
            got = int4_matmul(x.float(), packed, scale)
            got_bf16 = int4_matmul(x, packed, scale)
            torch.cuda.synchronize()
            ref = int4_matmul_plain(x.float(), packed, scale)
            scale_ref = ref.abs().max().item()
            abs_err = (got - ref).abs().max().item()
            e = abs_err / scale_ref
            e16 = (got_bf16.float() - ref).abs().max().item() / scale_ref
            err, err_bf16 = max(err, e), max(err_bf16, e16)
            # device times (graph replays); the host's time to issue one
            # K3 call (a stream of calls between events) beside them
            ms = graph_ms(lambda: int4_matmul(x, packed, scale), side)
            stream_ms = time_ms(lambda: int4_matmul(x, packed, scale),
                                iters=50)
            plain_ms = graph_ms(lambda: int4_matmul_plain(x, packed, scale),
                                side)
            # yardsticks only, never called by the port
            library_ms = graph_ms(lambda: x @ w_bf16, side)
            deq_ms = graph_ms(lambda: x @ dequantize_array(
                leaf, torch.bfloat16), side)
            nbytes = K2 * N + 4 * N + 2 * M * K + 2 * M * N
            bound_ms, bound_by = bound(nbytes, 2 * M * K * N)
            rows.append({"proj": name, "M": M, "K": K, "N": N,
                         "abs_err_fp32_out": abs_err,
                         "rel_err_fp32_out": e, "rel_err_bf16_out": e16,
                         "ms": ms, "stream_ms": stream_ms,
                         "plain_ms": plain_ms, "library_ms": library_ms,
                         "dequant_matmul_ms": deq_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by})
            log(f"int4_matmul {name} M {M} K {K} N {N}: rel_err fp32 out "
                f"{e:.3e} (tol {INT4_REL_TOL}), bf16 out {e16:.3e} (tol "
                f"{INT4_BF16_REL_TOL:.3e}); device ms={ms:.4f} (a call "
                f"issued from the host: {stream_ms:.4f}) plain_ms="
                f"{plain_ms:.4f} cublas_bf16_ms={library_ms:.4f} "
                f"dequant_matmul_ms={deq_ms:.4f} bound_ms={bound_ms:.5f} "
                f"({bound_by})")
    if not (err <= INT4_REL_TOL and err_bf16 <= INT4_BF16_REL_TOL):
        fail(f"int4_matmul disagrees with its plain version: {err}, "
             f"{err_bf16}")
    main = rows[0]                       # gate at M 16, a decode step
    return {"name": "int4_matmul", "route": "cuda",
            "source": "speech_distill_tpu_torch/csrc/int4_matmul.cu",
            "replaces": "speech_distill_tpu/ops/quant_matmul.py:30",
            "launches": launches,
            "max_abs_err": max(r["abs_err_fp32_out"] for r in rows),
            "max_rel_err": err, "ms": main["ms"], "kernel_ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "shapes": rows}


def check_quant_model_path(cfg, qmodel, dev) -> None:
    """Decode steps of ``paged_forward`` on the quantized model over an
    int8 pool, from the same quantized random KV history, with one dead
    row: the kernel route (K3 + K4-int8) and the plain route
    (``int4_matmul_plain`` + plain int8 attention), both in bf16, against
    the plain route with fp32 activations on the same codes."""
    rng = np.random.default_rng(SEED + 13)
    B, ps, mp, steps = 4, 128, 4, 4
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    qmodel32 = params_from_jax(model_to_tree(qmodel), cfg32, dev)
    runs = {}
    hist = None
    for key, m in ((("bf16", "kernel"), qmodel), (("bf16", "plain"), qmodel),
                   (("fp32", "plain"), qmodel32)):
        pool = PagedKVCache.create(cfg, B * mp, ps, torch.int8, dev)
        if hist is None:
            hist = torch.from_numpy(rng.standard_normal(
                tuple(pool.k.shape), np.float32)).to(dev, torch.bfloat16)
        pool.k, pool.ks = quantize_kv(hist)
        pool.v, pool.vs = quantize_kv(hist.flip(-1))
        runs[key] = (m, pool)
    del hist
    routes = {("bf16", "kernel"): "auto", ("bf16", "plain"): "plain",
              ("fp32", "plain"): "plain"}
    bt = torch.from_numpy(rng.permutation(B * mp).reshape(B, mp).astype(
        np.int32)).to(dev)
    lengths = torch.tensor([0, 100, 128, 300], dtype=torch.int64,
                           device=dev)
    live = torch.tensor([True, True, True, False], device=dev)
    err = {"bf16_kernel": 0.0, "bf16_plain": 0.0}
    for _ in range(steps):
        tok = torch.from_numpy(rng.integers(1, cfg.vocab_size - 2, B)).to(dev)
        out = {}
        for key, (m, pool) in runs.items():
            _cuda.reset_launches()
            with int4_route(routes[key]):
                out[key] = paged_forward(m, tok, pool, bt, lengths, live,
                                         key[1])
            n = dict(_cuda.launches)
            k = key == ("bf16", "kernel")
            L = cfg.num_hidden_layers
            if (n["int4_matmul"], n["paged_decode_int8"]) != \
                    ((QUANT_PROJ * L, L) if k else (0, 0)):
                fail(f"quantized model path {key}: launches {n}")
        if not all(bool(torch.isfinite(o).all()) for o in out.values()):
            fail("quantized paged_forward produced non-finite logits")
        ref = out["fp32", "plain"][live]
        for name, key in (("bf16_kernel", ("bf16", "kernel")),
                          ("bf16_plain", ("bf16", "plain"))):
            err[name] = max(err[name],
                            (out[key][live] - ref).abs().max().item())
        lengths = lengths + live
    log(f"quantized model path: {steps} decode steps over an int8 pool, "
        f"max |logits - fp32 plain|: bf16 kernel {err['bf16_kernel']:.3e}, "
        f"bf16 plain {err['bf16_plain']:.3e} (the kernel route must stay "
        f"within {BF16_ERR_RATIO}x the plain route's error)")
    if not err["bf16_kernel"] <= BF16_ERR_RATIO * err["bf16_plain"]:
        fail(f"quantized decode through the kernels is less accurate: {err}")


def kd_features(cfg, n: int, rng, T: int = None) -> list:
    """Seeded synthetic precomputed-KD examples: 385-512 tokens (so a batch
    pads right to T = 512; 3 T / 4 + 1 to ``T`` tokens for another T), a
    speech start in the first 32, and top-K columns of distinct indices
    with fp16 logprobs ~ N(-3, 1)."""
    V, K, pad = cfg.vocab_size, TRAIN_K, cfg.eos_token_id
    T = T or TRAIN_T
    cols = rng.permutation(V)[:K]
    feats = []
    for _ in range(n):
        L = int(rng.integers(3 * T // 4 + 1, T + 1))
        ids = rng.integers(0, V, L)
        ids[np.isin(ids, (pad, SPEECH_BOS))] = 1
        ids[int(rng.integers(1, 32))] = SPEECH_BOS
        feats.append({
            "input_ids": ids.tolist(),
            "teacher_top_k_v": (rng.standard_normal((L, K)) - 3).astype(
                np.float16),
            "teacher_top_k_i": ((rng.integers(0, V, (L, 1)) + cols) % V
                                ).astype(np.int32)})
    return feats


def train(cfg, model, dev):
    """Phase 6: the KD training step through ``train_loop``. Returns the
    launch counts of the loop, the trained LoRA tree and the base."""
    t0 = time.perf_counter()
    lora, base = init_lora(model, cfg, LoraConfig(), device=dev)
    torch.cuda.synchronize()
    log(f"init_lora pissa r=32 alpha=64 rslora s="
        f"{time.perf_counter() - t0:.2f}")
    frozen = [p.detach().clone() for p in base.parameters()]
    before = [t.detach().clone() for t in tree_leaves(lora)]
    rng = np.random.default_rng(SEED + 4)
    feats = kd_features(cfg, TRAIN_B * TRAIN_STEPS, rng)
    collate = DistillCollator(pad_token_id=cfg.eos_token_id,
                              speech_bos_id=SPEECH_BOS,
                              pad_to_multiple_of=128)
    dcfg = DistillConfig()
    opt = train_step.make_optimizer(dcfg.learning_rate, 2, TRAIN_STEPS)
    step = train_step.make_kd_step(cfg, dcfg, opt, mode="precomputed",
                                   device=dev)
    times, metrics, shapes = [], [], []

    def timed_step(state, *args):
        shapes.append(tuple(args[-1]["input_ids"].shape))
        t = time.perf_counter()
        state, m = step(state, *args)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        metrics.append({k: float(v) for k, v in m.items()})
        return state, m

    def batch_iter(epoch):
        return batches_from(feats, collate, TRAIN_B, 1, shuffle_seed=SEED,
                            epoch=epoch)
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as out:
        loop = LoopConfig(num_epochs=1, max_steps=TRAIN_STEPS,
                          logging_steps=TRAIN_STEPS, save_steps=5,
                          save_total_limit=2, output_dir=out)
        _cuda.reset_launches()
        state = train_loop(timed_step, train_step.init_state(lora, opt),
                           (base, None), batch_iter, loop, device=dev)
        torch.cuda.synchronize()
        counts = dict(_cuda.launches)
        kept = sorted(os.listdir(os.path.join(out, "ckpt")))
    peak = torch.cuda.max_memory_allocated() / 2**30
    n = len(times)
    L = cfg.num_hidden_layers
    tokens = TRAIN_B * TRAIN_T
    step_s = float(np.median(times[2:]))
    tok_s = tokens / step_s
    RATES["train_tokens_per_s"] = tok_s
    real = sum(len(f["input_ids"]) for f in feats[:n * TRAIN_B])
    log("train " + json.dumps({
        "steps": n, "batch_shape": shapes[0], "tokens_per_step": tokens,
        "real_tokens_per_step": real / n, "step_ms_median": step_s * 1e3,
        "step_ms": [t * 1e3 for t in times], "tokens_per_s": tok_s,
        "loss": [m["loss"] for m in metrics],
        "grad_norm": [m["grad_norm"] for m in metrics],
        "peak_mem_gib": peak, "checkpoints_kept": kept,
        "launches": counts}))
    if n != TRAIN_STEPS or state.step != TRAIN_STEPS:
        fail(f"train_loop ran {n} steps, state at {state.step}")
    if any(s != (1, TRAIN_B, TRAIN_T) for s in shapes):
        fail(f"batches are not [1, {TRAIN_B}, {TRAIN_T}]: {set(shapes)}")
    if not all(np.isfinite([m["loss"], m["grad_norm"]]).all()
               for m in metrics):
        fail("a loss or grad_norm is not finite")
    want = add_launches({"flash_fwd": 2 * L, "flash_dq": L, "flash_dkv": L},
                        train_launches(L), times=n)
    got = {k: counts[k] for k in want}
    if got != want:
        fail(f"flash and fused_norm launches {got} != {want} (2 x layers "
             f"forward under remat, layers backward, per step)")
    if len(kept) != 2:
        fail(f"save_total_limit 2 kept {kept}")
    if not all(torch.equal(a, b) for a, b in zip(frozen,
                                                 base.parameters())):
        fail("the frozen base weights changed")
    moved = [not torch.equal(a, b) for a, b in
             zip(before, tree_leaves(state.trainable))]
    if not all(moved):
        fail(f"{moved.count(False)} trainable leaves did not change")
    batch = {k: v[None] for k, v in collate(feats[:TRAIN_B]).items()}
    check_loss_falls(cfg, dcfg, base, state.trainable, batch, dev)
    profile_train(step, state, base, batch)
    return counts, state.trainable, base


def profile_step(what: str, run, groups: dict, warm: bool = True,
                 top: int = 14) -> None:
    """Where a training step spends its time: ``run()`` (one step, ending
    in a synchronise) timed without the profiler, then traced with it for
    the time of each CUDA kernel. Device busy share = kernel time /
    unprofiled wall time; ``groups`` maps a label to a substring of the
    kernel names whose time is summed."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if warm:
        run()
    t0 = time.perf_counter()
    run()
    wall_us = (time.perf_counter() - t0) * 1e6
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda e: -e.self_device_time_total)
    busy_us = sum(e.self_device_time_total for e in rows)
    parts = ""
    for label, key in groups.items():
        us = sum(e.self_device_time_total for e in rows if key in e.key)
        parts += (f" {label}_kernels_ms={us / 1e3:.2f} {label}_share_of_"
                  f"kernel_time={us / max(busy_us, 1.0):.3f}")
    log(f"profile {what}: wall_ms={wall_us / 1e3:.2f} (unprofiled) "
        f"device_kernel_ms={busy_us / 1e3:.2f} (profiled) busy_share="
        f"{busy_us / wall_us:.3f}{parts}")
    for e in rows[:top]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x "
            f"{e.key[:90]}")


def profile_train(step, state, base, batch) -> None:
    """Phase 6's step under :func:`profile_step`."""
    def run():
        nonlocal state
        state, _ = step(state, base, None, batch)
        torch.cuda.synchronize()
    profile_step("train step", run, {"flash": "flash_"})


def check_loss_falls(cfg, dcfg, base, trainable, batch, dev):
    """A short loop on one repeated batch: its loss must fall."""
    opt = train_step.make_optimizer(REPEAT_LR, 1, 50)
    step = train_step.make_kd_step(cfg, dcfg, opt, mode="precomputed",
                                   donate=False, device=dev)
    state = train_step.init_state(trainable, opt)
    losses = []
    for _ in range(REPEAT_STEPS):
        state, m = step(state, base, None, batch)
        losses.append(float(m["loss"]))
    log(f"repeated batch: lr={REPEAT_LR} (warmup 1: the first step's rate "
        f"is 0) losses={losses}")
    if not losses[-1] < losses[0]:
        fail(f"the loss on one repeated batch did not fall: {losses}")


def check_flash_bwd(dev, counts: dict, side, H: int = 16, KV: int = 8,
                    what: str = "KD", B: int = None) -> list:
    """K1-dq and K1-dkv at the training step's shape (B 8, T 512, H 16,
    KV 8, Dh 128; a tp-2 rank's H 8, KV 4 with ``H`` / ``KV``; a pp
    microbatch's B 2 with ``B``) against the plain backward in fp32 on
    the same bf16 inputs, K1-fwd against its plain version; K1-fwd
    graph-timed at the same shape. Returns the kernels-line entries."""
    rng = np.random.default_rng(SEED + 5)
    B, T = B or TRAIN_B, TRAIN_T
    q, k, v, do = flash_inputs(rng, dev, B, T, n=4, H=H, KV=KV)
    fwd_err = check_flash_fwd(q, k, v, what)
    abs_err, err = flash_bwd_errors(q, k, v, do, what)
    o, lse = flash_attention_fwd(q, k, v)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    dq_ms = graph_ms(lambda: flash_dq(q, k, v, do, lse, delta), side)
    dkv_ms = graph_ms(lambda: flash_dkv(q, k, v, do, lse, delta), side)
    plain_ms = time_ms(lambda: flash_attention_bwd_plain(q, k, v, o, lse,
                                                         do), iters=5)
    library_ms = sdpa_bwd_ms(q, k, v, do, side)
    rows = flash_bwd_entries(what, q, k, counts, abs_err, err,
                             (dq_ms, dkv_ms, plain_ms, library_ms))
    return rows + [flash_fwd_entry(what, q, k, v, counts["flash_fwd"],
                                   fwd_err, side, plain_iters=5)]


def sdpa_bwd_ms(q, k, v, do, side, iters: int = 20) -> float:
    """Graph replays (:func:`graph_ms`) of the backward of PyTorch's fused
    SDPA over the KV heads repeated to H, one number for the pair dq and
    dk/dv (the yardstick only, never called by the port). The forward
    runs on ``side``, so that its backward runs and is captured there."""
    qt, kt, vt = sdpa_inputs(q, k, v, grad=True)
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True)
    torch.cuda.current_stream().wait_stream(side)
    dot = do.transpose(1, 2)
    return graph_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True), side, iters=iters)


def flash_bwd_entries(what: str, q, k, counts: dict, abs_err: dict,
                      err: dict, times: tuple) -> list:
    """The kernels-line entries of K1-dq and K1-dkv at one path's shape;
    ``times`` = (dq ms, dkv ms, plain backward ms, SDPA backward ms)."""
    B, T, H, Dh = q.shape
    dq_ms, dkv_ms, plain_ms, library_ms = times
    causal_mm = B * H * T * T * Dh          # flops of one causal product
    qb, kvb, rowb = q.numel() * 2, k.numel() * 2, B * H * T * 4
    rows = []
    for name, ms, line, nbytes, flops in (
            ("flash_dq", dq_ms, 73, 3 * qb + 2 * kvb + 2 * rowb,
             3 * causal_mm),
            ("flash_dkv", dkv_ms, 104, 2 * qb + 4 * kvb + 2 * rowb,
             4 * causal_mm)):
        bound_ms, bound_by = bound(nbytes, flops)
        outs = ("dq",) if name == "flash_dq" else ("dk", "dv")
        rows.append({
            "name": name, "route": "cuda",
            "source": "speech_distill_tpu_torch/csrc/flash_bwd.cu",
            "replaces": f"speech_distill_tpu/ops/flash_attention.py:{line}",
            "path": what, "shape": [B, T, H, k.shape[2], Dh],
            "launches": counts[name],
            "max_abs_err": max(abs_err[o] for o in outs),
            "max_rel_err": max(err[o] for o in outs), "ms": ms,
            "kernel_ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "timing": "graph"})
    log(f"flash_bwd at the {what} shape B {B} T {T}: dq ms={dq_ms:.4f} "
        f"({3 * causal_mm / dq_ms / 1e9:.1f} TFLOP/s) dkv ms={dkv_ms:.4f} "
        f"({4 * causal_mm / dkv_ms / 1e9:.1f} TFLOP/s) (bounds "
        f"{rows[0]['bound_ms']:.5f}, {rows[1]['bound_ms']:.5f}) "
        f"library_ms={library_ms:.4f} (SDPA backward, the pair; pair / "
        f"SDPA {(dq_ms + dkv_ms) / library_ms:.2f}) plain_ms="
        f"{plain_ms:.4f} launches {counts['flash_dq']}, "
        f"{counts['flash_dkv']} (graph replays)")
    return rows


def flash_bwd_errors(q, k, v, do, what: str) -> tuple:
    """K1-dq and K1-dkv (on the forward kernel's o and lse) against the
    plain backward in fp32 on the same bf16 inputs: (max |kernel - plain|,
    that over max |plain|) for dq, dk and dv."""
    o, lse = flash_attention_fwd(q, k, v)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    got = (flash_dq(q, k, v, do, lse, delta),
           *flash_dkv(q, k, v, do, lse, delta))
    torch.cuda.synchronize()
    del o, lse, delta
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    ref_o, ref_lse = flash_attention_fwd_plain(qf, kf, vf)
    ref = flash_attention_bwd_plain(qf, kf, vf, ref_o, ref_lse, dof)
    abs_err = {name: (g.float() - r).abs().max().item()
               for name, g, r in zip(("dq", "dk", "dv"), got, ref)}
    err = {name: abs_err[name] / r.abs().max().item()
           for name, r in zip(("dq", "dk", "dv"), ref)}
    log(f"flash_bwd at the {what} check shape {list(q.shape)}: max |kernel "
        f"- plain| / max |plain|: " + ", ".join(
            f"{n}={e:.3e}" for n, e in err.items()) + f" tol={BWD_REL_TOL} "
        f"(bf16 p and ds in the products, bf16 outputs, against fp32); "
        f"max |kernel - plain|: " + ", ".join(
            f"{n}={e:.3e}" for n, e in abs_err.items()))
    if not max(err.values()) <= BWD_REL_TOL:
        fail(f"flash backward disagrees with its plain version at the "
             f"{what} shape: {err}")
    return abs_err, err


def check_flash_stage1(dev, counts: dict, side) -> list:
    """K1 at the stage-1 microbatch's shape (H 16, KV 8, Dh 128, T 4096):
    the forward and the backward pair against their plain versions at B 1
    (the fp32 scores of one row, 1 GiB, beside the model), then timed at
    B 4 beside SDPA, forward and backward. Returns the kernels-line
    entries."""
    rng = np.random.default_rng(SEED + 12)
    q, k, v, do = flash_inputs(rng, dev, 1, S1_T, n=4)
    fwd_err = check_flash_fwd(q, k, v, "stage-1")
    abs_err, err = flash_bwd_errors(q, k, v, do, "stage-1")
    del q, k, v, do
    torch.cuda.empty_cache()
    q, k, v, do = flash_inputs(rng, dev, S1_B, S1_T, n=4)
    rows = [flash_fwd_entry("stage-1", q, k, v, counts["flash_fwd"],
                            fwd_err, side, plain_iters=2)]
    o, lse = flash_attention_fwd(q, k, v)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    dq_ms = graph_ms(lambda: flash_dq(q, k, v, do, lse, delta), side,
                     iters=10)
    dkv_ms = graph_ms(lambda: flash_dkv(q, k, v, do, lse, delta), side,
                      iters=10)
    plain_ms = time_ms(lambda: flash_attention_bwd_plain(q, k, v, o, lse,
                                                         do), iters=1)
    library_ms = sdpa_bwd_ms(q, k, v, do, side, iters=10)
    rows += flash_bwd_entries("stage-1", q, k, counts, abs_err, err,
                              (dq_ms, dkv_ms, plain_ms, library_ms))
    return rows


def grad_path_errors(cfg, model, lora, batch, head_loss, depth: int,
                     dev) -> tuple:
    """One KD loss-and-grad of the full width at ``depth`` layers from the
    same weights (``model``'s first layers), LoRA (``lora``'s layers cut to
    the depth, and its embed) and ``batch`` (tensors on the card): (a) the
    kernel route in bf16, (b) the plain route in bf16, (c) the plain route
    in fp32; ``head_loss(hidden, embed)`` gives the loss. Returns the fp32
    plain loss and, for (a) and (b), the errors against (c): |loss|, and
    max |grad - fp32| / max |fp32 grad| over the LoRA leaves and the
    embed."""
    g = lora_scaling(DistillConfig().lora)

    def run(dtype, impl):
        c = dataclasses.replace(cfg, num_hidden_layers=depth,
                                dtype=dtype, attn_impl=impl)
        m = qwen3.Qwen3(c, dev)
        with torch.no_grad():
            for name, p in m.named_parameters():
                p.copy_(model.get_parameter(name))
        tr = {"layers": tree_map(lambda t: t[:depth].detach().clone()
                                 .requires_grad_(), lora["layers"]),
              "embed": {"weight": lora["embed"]["weight"].detach()
                        .to(c.torch_dtype).requires_grad_()}}
        emb = tr["embed"]["weight"]
        _cuda.reset_launches()
        hidden = qwen3.forward_train(
            m, batch["input_ids"], attention_mask=batch["attention_mask"],
            embed=emb, adapters=tr["layers"], adapter_scale=g, device=dev)
        out = head_loss(hidden, emb)
        leaves = tree_leaves(tr["layers"])
        grads = torch.autograd.grad(out.total, leaves + [emb])
        torch.cuda.synchronize()
        return (float(out.total.detach()), [x.float() for x in grads[:-1]],
                grads[-1].float(), dict(_cuda.launches))
    ref_loss, ref_lora, ref_emb, _ = run("float32", "xla")
    res = {"bf16_kernel": run("bfloat16", "auto"),
           "bf16_plain": run("bfloat16", "xla")}
    if res["bf16_kernel"][3]["flash_dq"] != depth \
            or res["bf16_plain"][3]["flash_dq"] != 0:
        fail(f"grad path routes: {[r[3] for r in res.values()]}")
    err = {}
    for key, (loss, lg, eg, _) in res.items():
        if not (np.isfinite(loss) and all(bool(torch.isfinite(x).all())
                                          for x in lg + [eg])):
            fail(f"{key}: non-finite loss or grads")
        err[key] = {"loss": abs(loss - ref_loss),
                    "lora_grad": max(((a - b).abs().max() / b.abs().max())
                                     .item() for a, b in zip(lg, ref_lora)),
                    "embed_grad": ((eg - ref_emb).abs().max()
                                   / ref_emb.abs().max()).item()}
    return ref_loss, err


def check_grad_errors(what: str, depth: int, ref_loss: float,
                      err: dict) -> None:
    """Log the grad path's errors; fail unless the kernel route is within
    ``BF16_ERR_RATIO`` of the plain route's error, for both grads."""
    log(f"{what}: " + json.dumps({"layers": depth, "B": 2, "T": TRAIN_T,
                                  "fp32_plain_loss": ref_loss,
                                  "errors_vs_fp32_plain": err}) +
        f" (max |grad - fp32| / max |fp32 grad| over the LoRA leaves and "
        f"the embed; the kernel route must stay within {BF16_ERR_RATIO}x "
        f"the plain route's error)")
    for key in ("lora_grad", "embed_grad"):
        if not err["bf16_kernel"][key] <= \
                BF16_ERR_RATIO * err["bf16_plain"][key]:
            fail(f"{what}: bf16 {key} through the kernels is less "
                 f"accurate: {err}")


def check_grad_path(cfg, model, lora, dev) -> None:
    """Phase 8: one KD loss-and-grad of the full width at 4 layers, B 2,
    T 512, from the same weights, LoRA and batch: (a) the kernel route in
    bf16, (b) the plain route in bf16, (c) the plain route in fp32."""
    depth = 4
    rng = np.random.default_rng(SEED + 6)
    feats = kd_features(cfg, 2, rng)
    batch = DistillCollator(pad_token_id=cfg.eos_token_id,
                            speech_bos_id=SPEECH_BOS)(feats)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    if batch["input_ids"].shape[1] != TRAIN_T:
        fail(f"grad path batch is not T = {TRAIN_T}")
    dcfg = DistillConfig()

    def head_loss(hidden, emb):
        return head_sparse_kd_loss(hidden, emb, batch["labels"],
                                   batch["teacher_top_k_v"],
                                   batch["teacher_top_k_i"], None,
                                   dcfg.temperature, dcfg.alpha)
    check_grad_errors("grad path", depth, *grad_path_errors(
        cfg, model, lora, batch, head_loss, depth, dev))


def check_fused_kd(cfg, base, lora, dev) -> dict:
    """Phase 9: two KD steps on one batch (B 8, T 512, K 128) through
    ``fused_loss=True, fused_backend="pallas"`` (K2) and through the
    default fused-head route, from the same LoRA. The first step's rate is
    0, so both steps of both routes see the same weights. Returns the
    launch counts of the fused route."""
    rng = np.random.default_rng(SEED + 8)
    collate = DistillCollator(pad_token_id=cfg.eos_token_id,
                              speech_bos_id=SPEECH_BOS,
                              pad_to_multiple_of=128)
    batch = {k: v[None] for k, v in
             collate(kd_features(cfg, TRAIN_B, rng)).items()}
    dcfg = DistillConfig()
    out = {}
    for route in ("head", "fused"):
        opt = train_step.make_optimizer(dcfg.learning_rate, 2, TRAIN_STEPS)
        step = train_step.make_kd_step(
            cfg, dcfg, opt, mode="precomputed", fused_loss=route == "fused",
            fused_backend="pallas", device=dev)
        tr = tree_map(lambda t: t.detach().clone().requires_grad_(), lora)
        state = train_step.init_state(tr, opt)
        metrics = []
        _cuda.reset_launches()
        for _ in range(2):
            state, m = step(state, base, None, batch)
            metrics.append({k: float(v) for k, v in m.items()})
        torch.cuda.synchronize()
        out[route] = (metrics, dict(_cuda.launches))
        del state, tr
    (head, _), (fused, counts) = out["head"], out["fused"]
    err = {k: max(abs(f[k] - h[k]) / abs(h[k]) for f, h in zip(fused, head))
           for k in ("loss", "grad_norm")}
    log("fused kd: " + json.dumps({
        "B": TRAIN_B, "T": TRAIN_T, "K": TRAIN_K,
        "loss_head": [m["loss"] for m in head],
        "loss_fused": [m["loss"] for m in fused],
        "grad_norm_head": [m["grad_norm"] for m in head],
        "grad_norm_fused": [m["grad_norm"] for m in fused],
        "rel_err": err, "launches": counts}) +
        f" (tol loss {FUSED_KD_LOSS_RTOL}, grad_norm "
        f"{FUSED_KD_GRAD_NORM_RTOL})")
    want = {"lm_head_stats": 2, "lm_head_dh": 2, "lm_head_dw": 2}
    if {k: counts[k] for k in want} != want or \
            out["head"][1]["lm_head_stats"] != 0:
        fail(f"fused kd launches {counts} (want {want} a route of 2 steps)")
    if not (err["loss"] <= FUSED_KD_LOSS_RTOL
            and err["grad_norm"] <= FUSED_KD_GRAD_NORM_RTOL):
        fail(f"the fused KD route disagrees with the head route: {err}")
    return counts


# phase 6/7, the remat policies at full width: 2 KD steps (B 8, T 512,
# K 128) from the phase-6 LoRA under each policy, and without remat; the
# forward is the same under every policy and a recompute repeats it, so
# the losses, grad norms and adapters equal "full"'s bit for bit where the
# kernels are deterministic, else within REMAT_RTOL
REMAT_RUNS = ("full", "dots", "half", "everything", "no_remat")
REMAT_STEPS = 2
REMAT_RTOL = 1e-6


def remat_batch(cfg) -> dict:
    collate = DistillCollator(pad_token_id=cfg.eos_token_id,
                              speech_bos_id=SPEECH_BOS,
                              pad_to_multiple_of=128)
    feats = kd_features(cfg, TRAIN_B, np.random.default_rng(SEED + 9))
    return {k: v[None] for k, v in collate(feats).items()}


def remat_steps(cfg, base, lora, batch, dev) -> dict:
    """REMAT_STEPS precomputed KD steps from a copy of ``lora`` (the
    launch counts set to 0 just before, read just after), with each
    step's ms and the device memory peak over the start."""
    opt = train_step.make_optimizer(2e-4, 1, 10)
    step = train_step.make_kd_step(cfg, DistillConfig(), opt,
                                   mode="precomputed", donate=False,
                                   device=dev)
    state = train_step.init_state(
        tree_map(lambda t: t.detach().clone().requires_grad_(), lora), opt)
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    times, metrics = [], []
    for _ in range(REMAT_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, base, None, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        metrics.append(m)
    return {"loss": [float(m["loss"]) for m in metrics],
            "grad_norm": [float(m["grad_norm"]) for m in metrics],
            "metrics": metrics, "step_ms": times,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "peak_over_start_gib": (torch.cuda.max_memory_allocated()
                                    - start) / 2**30,
            "launches": dict(_cuda.launches),
            "trainable": [t.detach() for t in tree_leaves(state.trainable)]}


def rel_gap(a: list, b: list) -> float:
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


def remat_policies(cfg, base, lora, dev) -> dict:
    """The remat policies (``models/qwen3.layer_runners``) at full width:
    fails unless K1-fwd ran 2 x 28 a step under "full" and "dots" (JAX's
    Pallas call is not a dot: the kernel runs again in the recompute), 28
    + 14 under "half", 28 under "everything" and without remat, K1-dq and
    K1-dkv 28 each, the layers' elementwise kernels once a layer forward
    (recompute included) and backward, nothing else, and the losses, grad
    norms and adapters equal "full"'s. Logs each policy's peak memory and
    step ms. Returns the launch counts by policy."""
    batch = remat_batch(cfg)
    L = cfg.num_hidden_layers
    fwd = {"full": 2 * L, "dots": 2 * L, "half": L + L // 2,
           "everything": L, "no_remat": L}
    own, runs = base.cfg, {}
    try:
        for run in REMAT_RUNS:
            pcfg = dataclasses.replace(
                cfg, remat=run != "no_remat",
                remat_policy="full" if run == "no_remat" else run)
            base.cfg = pcfg
            runs[run] = remat_steps(pcfg, base, lora, batch, dev)
    finally:
        base.cfg = own
    full = runs["full"]
    record = {}
    for run, r in runs.items():
        bitwise = all(torch.equal(a, b) for a, b in
                      zip(r["trainable"], full["trainable"])) and all(
            torch.equal(x[k], y[k]) for x, y in
            zip(r["metrics"], full["metrics"]) for k in x)
        leaf = max(float(((a.float() - b.float()).abs() /
                          b.float().abs().clamp_min(1e-30)).max())
                   for a, b in zip(r["trainable"], full["trainable"]))
        record[run] = {k: r[k] for k in ("loss", "grad_norm", "step_ms",
                                         "peak_gib", "peak_over_start_gib")}
        record[run].update(
            bitwise_equal_full=bitwise,
            loss_rel=rel_gap(r["loss"], full["loss"]),
            grad_norm_rel=rel_gap(r["grad_norm"], full["grad_norm"]),
            launches={k: r["launches"][k] for k in
                      ("flash_fwd", "flash_dq", "flash_dkv")})
        want = add_launches(
            {"flash_fwd": fwd[run], "flash_dq": L, "flash_dkv": L},
            train_launches(L, fwd[run]), times=REMAT_STEPS)
        got = {k: v for k, v in r["launches"].items() if v}
        if got != want:
            fail(f"remat {run}: launches {got} != {want}")
        if not bitwise and not (record[run]["loss_rel"] <= REMAT_RTOL
                                and record[run]["grad_norm_rel"]
                                <= REMAT_RTOL and leaf <= REMAT_RTOL):
            fail(f"remat {run}: apart from 'full' (loss "
                 f"{record[run]['loss_rel']:.3e}, grad norm "
                 f"{record[run]['grad_norm_rel']:.3e}, leaf {leaf:.3e})")
    log("remat policies " + json.dumps({
        "B": TRAIN_B, "T": TRAIN_T, "K": TRAIN_K, "steps": REMAT_STEPS,
        "device": torch.cuda.get_device_name(0), "runs": record}))
    return {run: r["launches"] for run, r in runs.items()}


# phase 9b, the teacher in the loop: the JAX benchmark's online modes
# (bench.py --mode online_sparse / online_dense, --teacher_quant, eval,
# extract: B 8, T 512, top-K 128, gaussian LoRA r 32, make_optimizer(5e-5,
# 10, 1000), 2 warm-up steps) on a fresh full-width student and the
# full-width 1.7B teacher, both drawn on the card; timed steps cut (from
# 8, 4 and 4) to keep the smoke inside its limit
TEACHER_SEED = 2
ONLINE_WARMUP, ONLINE_STEPS, QUANT_STEPS, FULL_FT_STEPS = 2, 4, 2, 2
# full finetuning at the bench's 5e-5 (10 warm-up steps) moves a bf16
# weight of size 0.02 by less than half its ulp (~1.2e-4): nothing would
# visibly change, so the phase trains at 1e-3 from the second step
FULL_FT_LR = 1e-3
# one online_sparse step and one precomputed step from the same state and
# batch, the precomputed top-K extracted from the same teacher at the same
# shape: the same numbers up to summation order
ONLINE_PRE_RTOL = 1e-3
AGREE_K, AGREE_STEPS = 10, 5
SELF_KL_TOL = 1e-3
# the extraction routes against each other: the same index set wherever
# the K-th and (K+1)-th teacher logits differ by more than EXTRACT_GAP
# (the routes sum their head products in other orders), sorted values
# within EXTRACT_ULPS fp16 ulps
EXTRACT_GAP, EXTRACT_ULPS, EXTRACT_ITERS = 1e-3, 2, 3
EXTRACT_SEQS, EXTRACT_BATCH = 10, 4
# a sequence extracted in a padded batch against it extracted alone: a
# lone row padded to 128 may be off the flash widths (384, 896) where its
# batch is on them, and the two bf16 routes round attention apart, so the
# logits differ by a measured eps (0.18-0.22 on such rows of the random
# 1.7B teacher on an H100, 0 where both take one route). Sets must
# agree where the K / K+1 gap exceeds 2 eps, values within 2 eps +
# EXTRACT_ULPS fp16 ulps, and eps stay below ALONE_EPS_MAX: a wrong row
# or truncation differs by the logits' own spread (std ~0.9, max ~6)
ALONE_EPS_MAX = 1.0


def bench_kd_batch(cfg, rng) -> dict:
    """bench.py's KD batch: [1, B, T] ids and labels drawn in that order
    from ``rng``, a mask of ones."""
    shape = (1, TRAIN_B, TRAIN_T)
    return {"input_ids": rng.integers(0, cfg.vocab_size, shape).astype(
                np.int32),
            "attention_mask": np.ones(shape, np.int32),
            "labels": rng.integers(0, cfg.vocab_size, shape).astype(
                np.int64)}


def teacher_forward(teacher, ids, mask):
    return qwen3.forward(teacher, ids, attention_mask=mask)


def module_bytes(model) -> int:
    """Bytes of a model's parameters and buffers (quantized codes and
    scales)."""
    return sum(t.numel() * t.element_size()
               for t in list(model.parameters()) + list(model.buffers()))


def online_loop(what: str, step, state, base, teacher, batch, steps: int,
                cfg, tcfg, profile: bool = False) -> tuple:
    """``ONLINE_WARMUP`` steps, then ``steps`` timed ones with the launch
    counts reset just before them; fails unless K1-fwd ran teacher + 2 x
    student layers a step (the student's recompute), K1-dq and K1-dkv the
    student's layers, K3 never, the layers' elementwise kernels the
    teacher's forward and the student's step, and the losses are finite.
    Returns the state, the logged record and the counts."""
    for _ in range(ONLINE_WARMUP):
        state, _ = step(state, base, teacher, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    times, metrics = [], []
    for _ in range(steps):
        t = time.perf_counter()
        state, m = step(state, base, teacher, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        metrics.append({k: float(v) for k, v in m.items()})
    counts = dict(_cuda.launches)
    L, Lt = cfg.num_hidden_layers, tcfg.num_hidden_layers
    step_s = float(np.median(times))
    tok_s = TRAIN_B * TRAIN_T / step_s
    rec = {"mode": what, "steps": steps, "step_ms_median": step_s * 1e3,
           "step_ms": [t * 1e3 for t in times], "tokens_per_s": tok_s,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
           "loss": [m["loss"] for m in metrics],
           "grad_norm": [m["grad_norm"] for m in metrics],
           "launches": {k: counts[k] for k in ("flash_fwd", "flash_dq",
                                               "flash_dkv", "int4_matmul")
                        + FUSED_NAMES}}
    log("online kd " + json.dumps(rec))
    want = {"int4_matmul": 0, **dict.fromkeys(FUSED_NAMES, 0),
            **add_launches({"flash_fwd": Lt + 2 * L, "flash_dq": L,
                            "flash_dkv": L}, forward_launches(Lt, 1),
                           train_launches(L), times=steps)}
    if rec["launches"] != want:
        fail(f"{what} launches {rec['launches']} != {want} (teacher + 2 x "
             f"student layers forward, student layers backward, no K3)")
    if not all(np.isfinite([m["loss"], m["grad_norm"]]).all()
               for m in metrics):
        fail(f"{what}: a loss or grad_norm is not finite")
    if profile:
        def run():
            nonlocal state
            state, _ = step(state, base, teacher, batch)
            torch.cuda.synchronize()
        profile_step(f"online kd {what} step", run, {"flash": "flash_"},
                     warm=False)
    return state, rec, counts


def check_online_equals_precomputed(cfg, dcfg, opt, base, lora0, teacher,
                                    batch, dev) -> dict:
    """One online_sparse step and one precomputed step from the same state
    on the same batch, the precomputed top-K from
    ``extract_teacher_logprobs`` on the teacher: loss and grad_norm within
    ``ONLINE_PRE_RTOL``. Returns the precomputed batch."""
    feats = [{"input_ids": row.tolist()} for row in batch["input_ids"][0]]
    v, i = extract_teacher_logprobs(
        teacher, teacher_forward, feats, top_k=dcfg.top_k,
        batch_size=TRAIN_B, pad_to_multiple_of=128,
        vocab_limit=cfg.vocab_size, progress=False, device=dev)
    pre = dict(batch, teacher_top_k_v=np.stack(v)[None],
               teacher_top_k_i=np.stack(i)[None])
    out = {}
    for mode, bt in (("online_sparse", batch), ("precomputed", pre)):
        step = train_step.make_kd_step(cfg, dcfg, opt, mode=mode,
                                       donate=False, device=dev)
        state = train_step.init_state(
            tree_map(lambda t: t.detach().clone().requires_grad_(), lora0),
            opt)
        _, m = step(state, base, teacher, bt)
        out[mode] = {k: float(x) for k, x in m.items()}
        del state
    err = {k: abs(out["online_sparse"][k] - out["precomputed"][k])
           / abs(out["precomputed"][k]) for k in ("loss", "grad_norm")}
    log("online vs precomputed: " + json.dumps({**out, "rel_err": err}) +
        f" (tol {ONLINE_PRE_RTOL})")
    if not max(err.values()) <= ONLINE_PRE_RTOL:
        fail(f"online_sparse disagrees with precomputed: {err}")
    return pre


def check_dense_grad_path(cfg, base, lora0, teacher, batch, dev) -> None:
    """Phase 8's check for online_dense: the dense KD loss and grads at 4
    layers, B 2, T 512, through the kernel route and the plain route in
    bf16 against the plain route in fp32, the teacher's logits (its
    kernel route, truncated to the student vocab) held fixed. The
    adapters' B factors are drawn N(0, 0.02) (gaussian init starts them
    at 0, where the A grads vanish)."""
    depth = 4
    b = {k: torch.as_tensor(v[0, :2], device=dev) for k, v in batch.items()}
    t_logits = teacher_forward(teacher, b["input_ids"], b["attention_mask"]
                               )[..., :cfg.vocab_size]
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    lora = {"embed": lora0["embed"],
            "layers": tree_map(lambda t: t, lora0["layers"])}
    for mods in lora["layers"].values():
        for key, ab in mods.items():
            mods[key] = {"a": ab["a"], "b": torch.randn(
                ab["b"].shape, generator=gen, device=dev) * 0.02}
    dcfg = DistillConfig()

    def head_loss(hidden, emb):
        return head_dense_kd_loss(hidden, emb, t_logits, b["labels"], None,
                                  dcfg.temperature, dcfg.alpha)
    check_grad_errors("online dense grad path", depth, *grad_path_errors(
        cfg, base, lora, b, head_loss, depth, dev))


def sorted_sets(v, i):
    return (torch.sort(v.float(), dim=-1, descending=True).values,
            torch.sort(i.long(), dim=-1).values)


def compare_topk(what: str, got, ref, gap_ok, tol) -> dict:
    """Index sets equal wherever ``gap_ok``, sorted values within ``tol``
    (a tensor broadcast against them). Returns the errors."""
    gv, gi = sorted_sets(*got)
    rv, ri = sorted_sets(*ref)
    set_diff = int(((gi != ri).any(-1) & gap_ok).sum())
    excess = float(((gv - rv).abs() - tol).max())
    if set_diff or excess > 0:
        fail(f"{what}: {set_diff} positions with another top-K set, values "
             f"over their tolerance by {excess}")
    return {"max_value_diff": float((gv - rv).abs().max()),
            "set_differs_at_excluded": int((gi != ri).any(-1).sum())}


def fp16_ulp(v: torch.Tensor) -> torch.Tensor:
    """The fp16 spacing at each value."""
    a = v.float().abs().clamp_min(2.0 ** -14)
    return torch.exp2(torch.floor(torch.log2(a)) - 10)


def check_extraction(cfg, tcfg, teacher, batch, dev) -> dict:
    """Teacher top-K extraction at B 8, T 512, K 128 through the
    materialized, chunked and fused routes (bench.py ``--mode extract``),
    timed, and held to each other; then ``extract_teacher_logprobs`` over
    ragged sequences against each sequence extracted alone."""
    V, K = cfg.vocab_size, TRAIN_K
    ids = torch.as_tensor(batch["input_ids"][0], device=dev)
    mask = torch.ones_like(ids)

    def chunked():
        logits = teacher_forward(teacher, ids, mask)[..., :V].float()
        lse = torch.logsumexp(logits, dim=-1, keepdim=True)
        v, i = losses.chunked_top_k(logits, K)
        return (v - lse).to(torch.float16), i.to(torch.int32)
    routes = {
        "materialized": lambda: losses.extract_top_k(
            teacher_forward(teacher, ids, mask), K, V, method="exact"),
        "chunked": chunked,
        "fused": lambda: fused_extract_top_k(
            qwen3.forward(teacher, ids, attention_mask=mask,
                          return_hidden=True),
            qwen3.lm_head_weight(teacher), K, V)}
    out, res = {}, {}
    for name, fn in routes.items():
        res[name] = fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(EXTRACT_ITERS):
            fn()
        torch.cuda.synchronize()
        out[name] = {"tokens_per_s": EXTRACT_ITERS * ids.numel()
                     / (time.perf_counter() - t0)}
    top = torch.topk(teacher_forward(teacher, ids, mask)[..., :V].float(),
                     K + 1, dim=-1).values
    gap_ok = (top[..., K - 1] - top[..., K]) > EXTRACT_GAP
    del top
    ref = res["materialized"]
    tol = EXTRACT_ULPS * fp16_ulp(sorted_sets(*ref)[0])
    for name in ("chunked", "fused"):
        out[name].update(compare_topk(f"extraction {name}", res[name], ref,
                                      gap_ok, tol))
    out["excluded_share"] = 1.0 - float(gap_ok.float().mean())
    RATES["extract_tokens_per_s"] = out["materialized"]["tokens_per_s"]
    out["alone"] = check_extraction_alone(cfg, teacher, dev)
    log("extraction " + json.dumps(out) + f" (B {TRAIN_B} T {TRAIN_T} K "
        f"{K}; sets held where the K-th and (K+1)-th logits differ by > "
        f"{EXTRACT_GAP}, values within {EXTRACT_ULPS} fp16 ulps)")
    return out


def check_extraction_alone(cfg, teacher, dev) -> dict:
    """``extract_teacher_logprobs`` over ``EXTRACT_SEQS`` sequences of
    300-1,000 tokens, batch 4, padded to 128 (the last batch
    repeat-padded): every example its own length, and its values and
    indices those of the example extracted alone, within the measured
    difference eps of the two forwards' logits."""
    V, K = cfg.vocab_size, TRAIN_K
    rng = np.random.default_rng(SEED + 13)
    feats = [{"input_ids": rng.integers(0, V, int(n)).tolist()}
             for n in rng.integers(300, 1001, EXTRACT_SEQS)]
    kw = dict(top_k=K, pad_to_multiple_of=128, vocab_limit=V,
              progress=False, device=dev)
    t0 = time.perf_counter()
    v_b, i_b = extract_teacher_logprobs(teacher, teacher_forward, feats,
                                        batch_size=EXTRACT_BATCH, **kw)
    batched_s = time.perf_counter() - t0
    lengths = [len(f["input_ids"]) for f in feats]
    if [len(v) for v in v_b] != lengths or [len(i) for i in i_b] != lengths:
        fail(f"extracted lengths {[len(v) for v in v_b]} != {lengths}")
    eps_all, diffs, routes = [], [], []
    for j, f in enumerate(feats):
        n = lengths[j]
        v_a, i_a = extract_teacher_logprobs(teacher, teacher_forward, [f],
                                            batch_size=1, **kw)
        group = feats[j - j % EXTRACT_BATCH:][:EXTRACT_BATCH]
        ids_b, mask_b = pad_sequences([g["input_ids"] for g in group], None,
                                      0, 128)
        row = j % EXTRACT_BATCH
        lb = teacher_forward(teacher, torch.as_tensor(ids_b[row:row + 1],
                                                      device=dev),
                             torch.as_tensor(mask_b[row:row + 1],
                                             device=dev))[0, :n, :V]
        ids_a, mask_a = pad_sequences([f["input_ids"]], None, 0, 128)
        la = teacher_forward(teacher, torch.as_tensor(ids_a, device=dev),
                             torch.as_tensor(mask_a, device=dev))[0, :n, :V]
        eps = float((lb.float() - la.float()).abs().max())
        routes.append((is_flash_width(ids_b.shape[1]),
                       is_flash_width(ids_a.shape[1])))
        top = torch.topk(la.float(), K + 1, dim=-1).values
        gap_ok = (top[:, K - 1] - top[:, K]) > 2 * eps
        del lb, la, top
        got = (torch.as_tensor(v_b[j], device=dev),
               torch.as_tensor(i_b[j], device=dev))
        ref = (torch.as_tensor(v_a[0], device=dev),
               torch.as_tensor(i_a[0], device=dev))
        tol = 2 * eps + EXTRACT_ULPS * fp16_ulp(sorted_sets(*ref)[0])
        diffs.append(compare_topk(f"extraction of sequence {j} in a batch",
                                  got, ref, gap_ok, tol))
        eps_all.append(eps)
    if not max(eps_all) <= ALONE_EPS_MAX:
        fail(f"batched and lone teacher logits differ by {max(eps_all)}")
    return {"sequences": EXTRACT_SEQS, "lengths": lengths,
            "batched_seconds": batched_s, "logits_eps": eps_all,
            "flash_batched_alone": routes,
            "max_value_diff": max(d["max_value_diff"] for d in diffs),
            "set_differs_at_excluded": sum(d["set_differs_at_excluded"]
                                           for d in diffs)}


def check_eval_and_agreement(cfg, tcfg, dcfg, trainable, base, teacher,
                             batch, pre, dev) -> dict:
    """``make_kd_eval_step`` in the three modes on one batch (the online
    sparse loss must equal the precomputed one on the extracted top-K);
    ``make_agreement_step`` (k 10, the speech mask on the second half, as
    bench.py ``--mode eval``) timed over ``AGREE_STEPS``; the teacher
    scored against itself; ``make_sparse_agreement_step`` against the
    extracted top-K."""
    out = {}
    for mode in train_step.MODES:
        ev = train_step.make_kd_eval_step(cfg, dcfg, mode=mode, device=dev)
        m = ev(trainable, base, teacher,
               pre if mode == "precomputed" else batch)
        out[mode] = {k: float(v) for k, v in m.items()}
        if not np.isfinite(list(out[mode].values())).all():
            fail(f"kd eval {mode}: non-finite {out[mode]}")
    err = abs(out["online_sparse"]["loss"] - out["precomputed"]["loss"]) \
        / abs(out["precomputed"]["loss"])
    log("kd eval " + json.dumps(out) + f" online_sparse vs precomputed "
        f"rel_err={err:.3e} (tol {ONLINE_PRE_RTOL})")
    if not err <= ONLINE_PRE_RTOL:
        fail(f"kd eval: online_sparse {out['online_sparse']['loss']} != "
             f"precomputed {out['precomputed']['loss']}")
    B, T = TRAIN_B, TRAIN_T
    smask = np.zeros((B, T), np.float32)
    smask[:, T // 2:] = 1.0
    ab = {"input_ids": batch["input_ids"][0],
          "attention_mask": batch["attention_mask"][0],
          "labels": batch["labels"][0], "speech_token_mask": smask}
    step = evaluate.make_agreement_step(cfg, tcfg, k=AGREE_K, device=dev)
    sums = step(base, teacher, ab)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(AGREE_STEPS):
        sums = step(base, teacher, ab)
    torch.cuda.synchronize()
    pos_s = AGREE_STEPS * B * T / (time.perf_counter() - t0)
    agree = {"positions_per_s": pos_s,
             "metrics": evaluate.finalize_metrics(sums, AGREE_K)}
    self_m = evaluate.finalize_metrics(evaluate.make_agreement_step(
        tcfg, k=AGREE_K, device=dev)(teacher, teacher, ab), AGREE_K)
    sparse = dict(ab, teacher_top_k_v=pre["teacher_top_k_v"][0],
                  teacher_top_k_i=pre["teacher_top_k_i"][0])
    agree["sparse_metrics"] = evaluate.finalize_metrics(
        evaluate.make_sparse_agreement_step(cfg, k=AGREE_K, device=dev)(
            base, sparse), AGREE_K)
    agree["teacher_vs_itself"] = self_m
    log("agreement " + json.dumps(agree) + f" (teacher vs itself: top-1 "
        f"1.0 and kl_t1 < {SELF_KL_TOL} on both slices)")
    for sl in ("all", "speech"):
        if not (self_m[sl]["top1_agreement"] == 1.0
                and abs(self_m[sl]["kl_t1"]) < SELF_KL_TOL):
            fail(f"the teacher disagrees with itself: {self_m}")
        for m in (agree["metrics"], agree["sparse_metrics"]):
            if not np.isfinite([m[sl]["kl_t1"], m[sl]["student_ce"]]).all():
                fail(f"agreement metrics not finite: {m}")
    return agree


def online_kd(cfg, dev) -> dict:
    """Phase 9b: the teacher in the loop at full width. Returns the K1
    launch counts of the phase's step loops."""
    t_phase = time.perf_counter()
    tcfg = qwen3_teacher_1p7b()
    # the earlier phases' cached blocks go back to the device before the
    # timed loops, so no loop pays for releasing them
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    base = qwen3.init_params_on_device(SEED, cfg, dev)
    teacher = qwen3.init_params_on_device(TEACHER_SEED, tcfg, dev)
    torch.cuda.synchronize()
    log(f"online kd: student qwen3_student_0p6b (seed {SEED}) and teacher "
        f"qwen3_teacher_1p7b hidden={tcfg.hidden_size} layers="
        f"{tcfg.num_hidden_layers} (seed {TEACHER_SEED}, "
        f"{module_bytes(teacher) / 1e9:.3f} GB bf16) drawn on the card "
        f"s={time.perf_counter() - t0:.2f}")
    lcfg = LoraConfig(init_weights="gaussian")
    lora0, base = init_lora(base, cfg, lcfg,
                            generator=torch.Generator().manual_seed(1),
                            device=dev)
    teacher_ref = [p.detach().clone() for p in teacher.parameters()]
    frozen = [p.detach().clone() for p in base.parameters()]
    batch = bench_kd_batch(cfg, np.random.default_rng(SEED))
    dcfg = DistillConfig(top_k=TRAIN_K, lora=lcfg)
    opt = train_step.make_optimizer(5e-5, 10, 1000)
    totals = dict.fromkeys(("flash_fwd", "flash_dq", "flash_dkv")
                           + FUSED_NAMES, 0)
    records = {}

    def fresh_state(optimizer):
        return train_step.init_state(
            tree_map(lambda t: t.detach().clone().requires_grad_(), lora0),
            optimizer)

    def run(what, step, state, tch, steps, profile=False):
        state, rec, counts = online_loop(what, step, state, base, tch,
                                         batch, steps, cfg, tcfg, profile)
        records[what] = rec
        for k in totals:
            totals[k] += counts[k]
        return state

    # 1. online_sparse
    step = train_step.make_kd_step(cfg, dcfg, opt, mode="online_sparse",
                                   device=dev)
    state = run("online_sparse", step, fresh_state(opt), teacher,
                ONLINE_STEPS, profile=True)
    moved = [not torch.equal(a, b) for a, b in zip(
        tree_leaves(lora0["layers"]), tree_leaves(state.trainable["layers"]))]
    if not all(moved):
        fail(f"online_sparse: {moved.count(False)} adapter leaves did not "
             f"change")
    trained = state.trainable
    del state
    pre = check_online_equals_precomputed(cfg, dcfg, opt, base, lora0,
                                          teacher, batch, dev)
    # 2. online_dense
    step = train_step.make_kd_step(cfg, dcfg, opt, mode="online_dense",
                                   device=dev)
    state = run("online_dense", step, fresh_state(opt), teacher,
                ONLINE_STEPS, profile=True)
    del state
    check_dense_grad_path(cfg, base, lora0, teacher, batch, dev)
    # 3. the quantized teacher: dense KD, K3 never runs
    for quant in ("int8", "nf4"):
        qteacher = train_step.quantize_teacher(teacher, quant)
        qcfg = dataclasses.replace(dcfg, teacher_quant=quant)
        mode = "online_dense" if qcfg.use_dense else "online_sparse"
        if mode != "online_dense":
            fail(f"teacher_quant={quant} did not force dense KD")
        step = train_step.make_kd_step(cfg, qcfg, opt, mode=mode,
                                       device=dev)
        state = run(f"online_dense {quant} teacher", step, fresh_state(opt),
                    qteacher, QUANT_STEPS)
        records[f"online_dense {quant} teacher"]["teacher_weight_bytes"] = \
            module_bytes(qteacher)
        log(f"{quant} teacher weight bytes {module_bytes(qteacher)} (bf16 "
            f"{module_bytes(teacher)})")
        del state, qteacher
    # 4. eval and agreement; 5. extraction
    check_eval_and_agreement(cfg, tcfg, dcfg, trained, base, teacher,
                             batch, pre, dev)
    del trained
    check_extraction(cfg, tcfg, teacher, batch, dev)
    if not all(torch.equal(a, b) for a, b in zip(frozen,
                                                 base.parameters())):
        fail("the frozen student base changed in the LoRA modes")
    del frozen
    # 6. full finetuning: every weight of the student trains
    ft_opt = train_step.make_optimizer(FULL_FT_LR, 1, 1000)
    step = train_step.make_kd_step(cfg, dcfg, ft_opt, mode="online_sparse",
                                   use_lora=False, device=dev)
    trainable = train_step.full_trainable(base)
    # the matrices, updated in place (the norm scales, ones in bf16, move
    # by less than half their ulp of 2^-7 at this rate)
    layers = trainable["layers"]
    matrices = ([trainable["embed"]["weight"]]
                + [layers["attn"][n] for n in ("q", "k", "v", "o")]
                + list(layers["mlp"].values()))
    before = [t.detach().clone() for t in matrices]
    state = run("full_finetune", step, train_step.init_state(trainable,
                                                             ft_opt),
                teacher, FULL_FT_STEPS)
    mus = tree_leaves(state.opt_state["mu"])
    bad = [k for k, m in enumerate(mus)
           if not (bool(torch.isfinite(m).all()) and bool((m != 0).any()))]
    if bad:
        fail(f"full finetuning: leaves {bad} got a non-finite or zero "
             f"gradient (first moments)")
    still = [k for k, (a, b) in enumerate(zip(before, matrices))
             if torch.equal(a, b)]
    if still:
        fail(f"full finetuning: matrix leaves {still} did not move")
    del state, trainable, layers, matrices, before
    if not all(torch.equal(a, b) for a, b in zip(teacher_ref,
                                                 teacher.parameters())):
        fail("the teacher's weights changed")
    if any(p.grad is not None or p.requires_grad
           for p in teacher.parameters()):
        fail("the teacher has gradients")
    log(f"online kd phase s={time.perf_counter() - t_phase:.2f} "
        f"launches {totals}")
    return totals


def stage1_rows(cfg, old_vocab: int, n_rows: int, rng) -> np.ndarray:
    """Seeded synthetic stage-1 data packed into n_rows rows of S1_T: each
    example is a short text prefix of old-vocab ids (3-32) and then
    new-vocab speech tokens (200-1200), as tests/test_stage1_parity.py
    builds them, each followed by the EOS id."""
    need = n_rows * S1_T
    examples, total = [], 0
    while total < need + S1_T:
        text = rng.integers(0, old_vocab, int(rng.integers(3, 33)))
        speech = rng.integers(old_vocab, cfg.vocab_size,
                              int(rng.integers(200, 1201)))
        examples.append(np.concatenate([text, speech]).tolist())
        total += len(examples[-1]) + 1
    rows = stage1_data.pack_sequences(examples, S1_T, cfg.eos_token_id)
    return rows[:n_rows]


def stage1(cfg, dev):
    """Phase 10: the stage-1 warm-up, this slice's main path, through the
    entry points the stage-1 CLI calls. Returns the launch counts of the
    loop, the model and the packed rows."""
    t0 = time.perf_counter()
    model = qwen3.init_params(cfg, seed=SEED, device=dev)
    old_vocab = cfg.vocab_size - S1_NEW_TOKENS
    rng = np.random.default_rng(SEED + 9)
    n_train = S1_STEPS * S1_B * S1_A
    rows = stage1_rows(cfg, old_vocab, n_train + S1_EVAL_ROWS, rng)
    train_rows, eval_rows = rows[:n_train], rows[n_train:]
    fused, backend = stage1_data.fused_route(S1_T, dev, cfg.torch_dtype,
                                                 cfg.hidden_size)
    trainable = {"embed": {"weight": model.embed.detach().clone()
                           .requires_grad_()}}
    start = trainable["embed"]["weight"].detach().clone()
    frozen = [p.detach().clone() for p in model.parameters()]
    opt = train_step.make_optimizer(S1_LR, S1_WARMUP, S1_STEPS,
                                    weight_decay=S1_WD)
    step = train_step.make_stage1_step(cfg, opt, old_vocab,
                                       fused_loss=fused,
                                       fused_backend=backend, device=dev)
    eval_fn = stage1_data.make_eval_fn(
        train_step.make_stage1_eval_step(cfg, device=dev), eval_rows, 1,
        model)
    torch.cuda.synchronize()
    log(f"stage1 setup: old_vocab={old_vocab} fused={fused} "
        f"backend={backend} rows={len(train_rows)}+{len(eval_rows)} "
        f"s={time.perf_counter() - t0:.2f}")
    times, metrics, per_step = [], [], []

    def timed_step(state, *args):
        before = dict(_cuda.launches)
        t = time.perf_counter()
        state, m = step(state, *args)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        metrics.append({k: float(v) for k, v in m.items()})
        per_step.append({k: _cuda.launches[k] - before[k] for k in before})
        return state, m

    evals = []

    def counted_eval(state):
        t = time.perf_counter()
        m = eval_fn(state)
        torch.cuda.synchronize()
        evals.append({"loss": m["loss"], "s": time.perf_counter() - t})
        return m

    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as out:
        loop = LoopConfig(num_epochs=1, max_steps=S1_STEPS, logging_steps=1,
                          save_steps=None, save_total_limit=2,
                          output_dir=out, eval_steps=None,
                          load_best_at_end=True)
        _cuda.reset_launches()
        state = train_loop(
            timed_step, train_step.init_state(trainable, opt), (model,),
            lambda epoch: stage1_data.stage1_batches(train_rows, S1_B, S1_A,
                                                     SEED, epoch),
            loop, eval_fn=counted_eval,
            tokens_per_batch=S1_B * S1_A * S1_T, device=dev)
        torch.cuda.synchronize()
        counts = dict(_cuda.launches)
        kept = sorted(os.listdir(os.path.join(out, "ckpt")))
    peak = torch.cuda.max_memory_allocated() / 2**30
    RATES["stage1_peak_gib"] = peak
    n = len(times)
    tokens = S1_B * S1_A * S1_T
    step_s = float(np.median(times[1:]))
    tok_s = tokens / step_s
    RATES["stage1_step_ms"], RATES["stage1_tokens_per_s"] = step_s * 1e3, tok_s
    log("stage1 " + json.dumps({
        "steps": n, "B": S1_B, "T": S1_T, "A": S1_A,
        "tokens_per_step": tokens, "step_ms": [t * 1e3 for t in times],
        "step_ms_median_after_first": step_s * 1e3, "tokens_per_s": tok_s,
        "peak_mem_gib": peak, "loss": [m["loss"] for m in metrics],
        "grad_norm": [m["grad_norm"] for m in metrics], "eval": evals,
        "checkpoints_kept": kept, "launches_per_step": per_step,
        "launches": counts}))
    L = cfg.num_hidden_layers
    if n != S1_STEPS or state.step != S1_STEPS:
        fail(f"stage-1 train_loop ran {n} steps, state at {state.step}")
    if not all(np.isfinite([m["loss"], m["grad_norm"]]).all()
               for m in metrics) or len(evals) != 1 \
            or not np.isfinite(evals[0]["loss"]):
        fail("a stage-1 loss, grad_norm or eval loss is not finite")
    want = add_launches({"lm_head_stats": 1, "lm_head_dh": 1,
                         "lm_head_dw": 1, "flash_fwd": 2 * L, "flash_dq": L,
                         "flash_dkv": L}, train_launches(L), times=S1_A)
    for i, got in enumerate(per_step):
        if {k: got[k] for k in want} != want:
            fail(f"stage-1 step {i + 1} launches {got} != {want} (K2 once a "
                 f"microbatch; flash 2 x layers forward under remat, layers "
                 f"backward)")
    # the eval forward: one flash forward a layer for each eval row
    total = add_launches(add_launches(want, times=S1_STEPS),
                         {"flash_fwd": L * S1_EVAL_ROWS},
                         forward_launches(L, S1_EVAL_ROWS))
    if {k: counts[k] for k in total} != total:
        fail(f"stage-1 loop launches {counts} != {total}")
    final = state.trainable["embed"]["weight"].detach()
    if not all(torch.equal(a, b) for a, b in zip(frozen,
                                                 model.parameters())):
        fail("the frozen base weights changed")
    if torch.equal(final[old_vocab:], start[old_vocab:]):
        fail("no new embedding row moved")
    # the old rows get a zero gradient: AdamW only decays them, so the same
    # optimizer on zero gradients from the same start gives them exactly
    old = {"w": start[:old_vocab].clone()}
    ost = opt.init(old)
    for _ in range(S1_STEPS):
        ups, ost = opt.update({"w": torch.zeros_like(old["w"])}, ost, old)
        old = train_step.apply_updates(old, ups)
    if not torch.equal(final[:old_vocab], old["w"]):
        fail("the old embedding rows are not their start less AdamW's decay")
    log(f"stage1 checks: old rows == start less AdamW decay (bit-equal), "
        f"base bit-equal, {int((final[old_vocab:] != start[old_vocab:]).any(1).sum())} "
        f"of {S1_NEW_TOKENS} new rows moved")
    batch = next(stage1_data.stage1_batches(train_rows, S1_B, S1_A, SEED, 0))

    def run():
        nonlocal state
        state, _ = step(state, model, batch)
        torch.cuda.synchronize()
    profile_step("stage1 step", run, {"flash": "flash_",
                                      "flash_fwd": "flash_fwd",
                                      "lm_head": "lm_head_",
                                      "lm_head_stats": "lm_head_stats_",
                                      "lm_head_combine": "lm_head_combine_",
                                      "lm_head_dl": "lm_head_dl_",
                                      "lm_head_gemm": "lm_head_gemm_"},
                 warm=False)
    return counts, model, rows


def check_lm_head(dev, model, counts: dict, side) -> list:
    """K2 at the stage-1 head: W is the full-width table [159,488, 1024]
    bf16 scaled to N(0, 0.1) (logits of std ~3), h ~ N(0, 1), T 2.0,
    labels over the vocab with a hit in the last column, random a1, aT, b.
    Checked against the plain versions in fp32 at N 4096 (the fused-KD
    microbatch's vocab-split grid) and at the stage-1 microbatch's
    N 16,380, where it is also timed; dh and dW beside the two cuBLAS
    products that each one's work holds, graph-timed on ``side``."""
    rng = np.random.default_rng(SEED + 10)
    V, D = model.embed.shape
    w = (model.embed.detach().float() * 5.0).to(torch.bfloat16)
    T = 2.0

    def inputs(n):
        h = torch.from_numpy(rng.standard_normal((n, D), np.float32)).to(
            dev, torch.bfloat16)
        lab = rng.integers(0, V, n)
        lab[0] = V - 1
        labels = torch.from_numpy(lab).to(dev, torch.int32)
        cot = [torch.from_numpy(rng.standard_normal(n, np.float32)).to(dev)
               for _ in range(3)]
        return h, labels, cot
    def compare(h, labels, cot):
        """max |kernel - plain(fp32)| and that over max |plain| for each
        output, on the same bf16 inputs."""
        stats = lm_head_stats_kernel(h, w, labels, T)
        args = (h, w, labels, stats[0], stats[1], *cot, T)
        got = dict(zip(("lse1", "lseT", "label_logit", "dh", "dW"),
                       (*stats, lm_head_dh(*args), lm_head_dw(*args))))
        torch.cuda.synchronize()
        hf, wf = h.float(), w.float()
        ref = lm_head_stats_plain(hf, wf, labels, T)
        refs = dict(zip(got, (*ref, *lm_head_stats_bwd_plain(
            hf, wf, labels, ref[0], ref[1], *cot, T))))
        abs_err = {k: (got[k].float() - refs[k]).abs().max().item()
                   for k in got}
        err = {k: abs_err[k] / refs[k].abs().max().item() for k in got}
        plan = _stats_plan(h.shape[0], V, _sm_count(dev))
        log(f"lm_head K2 at N {h.shape[0]} ({plan.splits} vocab splits, "
            f"{plan.grid} blocks, busiest {plan.makespan} tiles), V {V}, "
            f"D {D}: max |kernel - plain(fp32)| / max "
            "|plain|: " + ", ".join(f"{k}={e:.3e}" for k, e in err.items())
            + f" (tol {LSE_REL_TOL} for the statistics, {HEAD_GRAD_REL_TOL} "
            "for dh and dW: bf16 dlogits and outputs); max abs: "
            + ", ".join(f"{k}={e:.3e}" for k, e in abs_err.items()))
        if not (max(err[k] for k in ("lse1", "lseT", "label_logit"))
                <= LSE_REL_TOL and max(err["dh"], err["dW"])
                <= HEAD_GRAD_REL_TOL):
            fail(f"K2 disagrees with its plain version at N {h.shape[0]}: "
                 f"{err}")
        return abs_err, err

    # the fused-KD microbatch's grid, then the stage-1 microbatch's
    checks = [compare(*inputs(K2_CHECK_N))]
    N = S1_B * (S1_T - 1)         # rows of one stage-1 microbatch
    h, labels, cot = inputs(N)
    checks.append(compare(h, labels, cot))
    abs_err = {k: max(c[0][k] for c in checks) for k in checks[0][0]}
    err = {k: max(c[1][k] for c in checks) for k in checks[0][1]}
    stats = lm_head_stats_kernel(h, w, labels, T)
    args = (h, w, labels, stats[0], stats[1], *cot, T)
    ms = {"lm_head_stats": time_ms(lambda: lm_head_stats_kernel(
              h, w, labels, T), iters=10, warmup=2),
          "lm_head_dh": time_ms(lambda: lm_head_dh(*args), iters=5,
                                warmup=1),
          "lm_head_dw": time_ms(lambda: lm_head_dw(*args), iters=5,
                                warmup=1)}
    plain_fwd = time_ms(lambda: lm_head_stats_plain(h, w, labels, T),
                        iters=2, warmup=1)
    plain_bwd = time_ms(lambda: lm_head_stats_bwd_plain(
        h, w, labels, stats[0], stats[1], *cot, T), iters=2, warmup=1)
    # yardstick only, never called by the port: cuBLAS's bf16 product of
    # the same [N, D] x [D, V] alone (no statistic computes in it)
    library_ms = time_ms(lambda: torch.matmul(h, w.t()), iters=10, warmup=2)
    # the same for dh and dW: the logits h W^T (bf16 [N, V]) and then
    # their product with W (dh) or, transposed, with h (dW)
    library = {"lm_head_stats": library_ms,
               "lm_head_dh": graph_ms(lambda: (h @ w.t()) @ w, side,
                                      iters=3, replays=2),
               "lm_head_dw": graph_ms(lambda: (h @ w.t()).t() @ h, side,
                                      iters=3, replays=2)}
    nvd = N * V * D
    opnd = (N + V) * D * 2 + N * 4            # h, W, labels
    # device scratch of one call, measured: the stats' vocab-split
    # partials; dh's dl chunk and fp32 partial, dW's dl chunk
    scratch = {"lm_head_stats": scratch_bytes(
                   lambda: lm_head_stats_kernel(h, w, labels, T)),
               "lm_head_dh": scratch_bytes(lambda: lm_head_dh(*args)),
               "lm_head_dw": scratch_bytes(lambda: lm_head_dw(*args))}
    plan = _bwd_plan(N, V, D)
    rows = []
    for name, line, nbytes, flops, plain_ms, outs in (
            ("lm_head_stats", 34, opnd + 3 * N * 4, 2 * nvd, plain_fwd,
             ("lse1", "lseT", "label_logit")),
            ("lm_head_dh", 79, opnd + 5 * N * 4 + N * D * 2, 4 * nvd,
             plain_bwd, ("dh",)),
            ("lm_head_dw", 112, opnd + 5 * N * 4 + V * D * 2, 4 * nvd,
             plain_bwd, ("dW",))):
        bound_ms, bound_by = bound(nbytes, flops)
        rows.append({
            "name": name, "route": "cuda",
            "source": "speech_distill_tpu_torch/csrc/lm_head_stats.cu",
            "replaces": f"speech_distill_tpu/ops/pallas_lm_loss.py:{line}",
            "launches": counts[name],
            "max_abs_err": max(abs_err[o] for o in outs),
            "max_rel_err": max(err[o] for o in outs), "ms": ms[name],
            "kernel_ms": ms[name], "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library[name], "checked_n": [K2_CHECK_N, N],
            "timed_shape": [N, V, D], "scratch_bytes": scratch[name]})
    log("lm_head K2 at N " + str(N) + ": " + ", ".join(
        f"{r['name']} ms={r['ms']:.3f} bound_ms={r['bound_ms']:.3f}"
        for r in rows) + f"; plain stats ms={plain_fwd:.3f}, plain bwd "
        f"(dh and dW) ms={plain_bwd:.3f}; library: cuBLAS h @ W^T "
        f"ms={library_ms:.3f} (events), (h @ W^T) @ W ms="
        f"{library['lm_head_dh']:.3f}, (h @ W^T)^T @ h ms="
        f"{library['lm_head_dw']:.3f} (graph replays); scratch measured: "
        f"stats {scratch['lm_head_stats']} B, dh {scratch['lm_head_dh']} B, "
        f"dW {scratch['lm_head_dw']} B (planned: dh {plan.dh_bytes} B, dW "
        f"{plan.dw_bytes} B, vocab chunks of {plan.chunk})")
    return rows


def check_stage1_grad_path(cfg, model, rows, dev) -> None:
    """Phase 12: the stage-1 loss and masked embedding gradient of one
    packed row (B 1, T 4096) at 4 layers of the full width, from the same
    weights: (a) the kernel route in bf16 (flash + K2), (b) the plain
    route in bf16 (plain attention + chunked CE), (c) the plain route in
    fp32."""
    depth = 4
    old_vocab = cfg.vocab_size - S1_NEW_TOKENS
    ids = torch.as_tensor(rows[:1], device=dev).long()
    labels = ids.clone()
    ones = torch.ones_like(ids)

    def run(dtype, impl, backend):
        c = dataclasses.replace(cfg, num_hidden_layers=depth, dtype=dtype,
                                attn_impl=impl)
        m = qwen3.Qwen3(c, dev)
        with torch.no_grad():
            for name, p in m.named_parameters():
                p.copy_(model.get_parameter(name))
        emb = model.embed.detach().to(c.torch_dtype).clone() \
            .requires_grad_()
        _cuda.reset_launches()
        hidden = qwen3.forward_train(m, ids, attention_mask=ones, embed=emb,
                                     device=dev)
        loss = fused_cross_entropy(hidden, emb, labels, backend=backend)
        (g,) = torch.autograd.grad(loss, [emb])
        g = train_step.mask_new_token_grads({"embed": {"weight": g}},
                                            old_vocab)["embed"]["weight"]
        torch.cuda.synchronize()
        return float(loss.detach()), g.float(), dict(_cuda.launches)
    ref_loss, ref_g, _ = run("float32", "xla", "xla")
    res = {"bf16_kernel": run("bfloat16", "auto", "pallas"),
           "bf16_plain": run("bfloat16", "xla", "xla")}
    want = {"flash_fwd": 2 * depth, "flash_dq": depth, "flash_dkv": depth,
            "lm_head_stats": 1, "lm_head_dh": 1, "lm_head_dw": 1}
    if {k: res["bf16_kernel"][2][k] for k in want} != want or any(
            res["bf16_plain"][2][k] for k in want):
        fail(f"stage-1 grad path routes: {[r[2] for r in res.values()]}")
    scale = ref_g.abs().max().item()
    err = {}
    for key, (loss, g, _) in res.items():
        if not (np.isfinite(loss) and bool(torch.isfinite(g).all())):
            fail(f"{key}: non-finite stage-1 loss or gradient")
        err[key] = {"loss": abs(loss - ref_loss),
                    "embed_grad": (g - ref_g).abs().max().item() / scale}
    log("stage1 grad path: " + json.dumps({
        "layers": depth, "B": 1, "T": S1_T, "fp32_plain_loss": ref_loss,
        "errors_vs_fp32_plain": err}) + " (max |grad - fp32| / max |fp32 "
        "grad| over the masked embedding gradient; the kernel route must "
        f"stay within {BF16_ERR_RATIO}x the plain route's error)")
    if not err["bf16_kernel"]["embed_grad"] <= \
            BF16_ERR_RATIO * err["bf16_plain"]["embed_grad"]:
        fail(f"bf16 stage-1 embedding gradient through the kernels is less "
             f"accurate: {err}")


# ---------------------------------------------------------------------------
# Phase 15: the distillation CLIs end to end
# ---------------------------------------------------------------------------

CLI_STUDENT_VOCAB = 151_936      # Qwen3-0.6B's own vocabulary
CLI_SPECIALS = ("<|text_start|>", "<|text_end|>", "<|semantic_token_start|>",
                "<|semantic_token_end|>", "<|task_podcast|>", "<|SPEAKER_0|>",
                "<|Yue|>")
CLI_SPEECH = 6561                # speech tokens <|0|> .. <|6560|>
# raw examples (text of 20-60 characters, 300-440 codes: <= 512 tokens
# each), stage 1's eval examples, the train CLI's and evaluate's held-out
# rows
CLI_ROWS, CLI_S1_EVAL, CLI_TRAIN_TEST, CLI_EVAL_TEST = 100, 12, 8, 10
CLI_B, CLI_T, CLI_K = 8, 512, 128          # train / extract batch, pad, K
CLI_TEXT_PREFIX = '{"en": "", "zh": "", "yue": "<|Yue|>"}'   # the default


def cli_tokenizer(out_dir: str, n_base: int, speech: bool):
    """A fast WordLevel tokenizer over characters (a-z, space, "?") padded
    with filler words to ``n_base`` ids, as tests/test_pipelines.py builds
    the tiny one; with ``speech``, then the template's special tokens and
    <|0|> .. <|6560|>, so the speech tokens start at the config's
    ``speech_token_offset``. Saved under ``out_dir``."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast
    vocab = {chr(c): i for i, c in enumerate(range(ord("a"), ord("z") + 1))}
    vocab.update({" ": 26, "?": 27})
    vocab.update({f"<f{i}>": i for i in range(28, n_base)})
    tok = Tokenizer(models.WordLevel(vocab=vocab, unk_token="?"))
    tok.pre_tokenizer = pre_tokenizers.Split("", "isolated")
    fast = PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="?")
    if speech:
        fast.add_tokens(list(CLI_SPECIALS))
        fast.add_tokens([f"<|{i}|>" for i in range(CLI_SPEECH)])
        fast.pad_token = fast.eos_token = "<|semantic_token_end|>"
    fast.save_pretrained(out_dir)
    return fast


def cli_rows(rng) -> dict:
    """The raw dataset: seeded text, language and a ``codes`` column (the
    S3 tokenizer is not ported, so no audio)."""
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz "))
    return {
        "text": ["".join(rng.choice(letters, int(rng.integers(20, 61))))
                 for _ in range(CLI_ROWS)],
        "codes": [rng.integers(0, CLI_SPEECH,
                               int(rng.integers(300, 441))).tolist()
                  for _ in range(CLI_ROWS)],
        "lang": ["en", "zh", "yue", "en"] * (CLI_ROWS // 4)}


class LoopSpy:
    """While a CLI runs, ``core.trainer.train_loop`` records each step's
    seconds, metrics and launches, and the loop's frozen arguments and
    final state (the CLIs import it when called)."""

    def __enter__(self):
        self.real = trainer_lib.train_loop
        self.steps, self.frozen, self.state = [], None, None

        def loop(step_fn, state, frozen, *args, **kw):
            def step(st, *a):
                before = dict(_cuda.launches)
                t = time.perf_counter()
                st, m = step_fn(st, *a)
                torch.cuda.synchronize()
                rec = {k: float(v) for k, v in m.items()}
                rec["s"] = time.perf_counter() - t
                rec["launches"] = {k: _cuda.launches[k] - before[k]
                                   for k in before}
                self.steps.append(rec)
                return st, m
            self.frozen = frozen
            self.state = self.real(step, state, frozen, *args, **kw)
            return self.state
        trainer_lib.train_loop = loop
        return self

    def __exit__(self, *exc):
        trainer_lib.train_loop = self.real


def run_cli(name: str, fn, argv: list, record: dict):
    """One CLI ``main(argv)`` in this process, launches counted from 0."""
    torch.cuda.synchronize()
    _cuda.reset_launches()
    t = time.perf_counter()
    out = fn(argv)
    torch.cuda.synchronize()
    s = time.perf_counter() - t
    counts = {k: v for k, v in _cuda.launches.items() if v}
    record[name] = {"s": s, "launches": counts}
    log(f"cli {name}: s={s:.2f} launches={counts}")
    return out


def check_cli_launches(name: str, record: dict, want: dict) -> None:
    got = record[name]["launches"]
    want = {k: v for k, v in want.items() if v}
    if got != want:
        fail(f"cli {name} launches {got} != {want}")


def check_cli_steps(name: str, spy: LoopSpy, n: int, per_step: dict) -> None:
    if len(spy.steps) != n:
        fail(f"cli {name} ran {len(spy.steps)} steps, not {n}")
    for i, st in enumerate(spy.steps):
        if not np.isfinite([v for k, v in st.items()
                            if k not in ("s", "launches")]).all():
            fail(f"cli {name} step {i + 1}: a metric is not finite {st}")
        got = {k: v for k, v in st["launches"].items() if v}
        if got != per_step:
            fail(f"cli {name} step {i + 1} launches {got} != {per_step}")


def stage1_rows_expected(tok, rows: dict, seq: int) -> tuple:
    """(train rows, eval rows) the stage-1 CLI packs from ``rows``: its
    processor (the CLI's template defaults), eval split and packing."""
    from speech_distill_tpu_torch.core.config import parse_prefix
    from speech_distill_tpu_torch.data.processor import (
        SpeechDistillProcessor)
    proc = SpeechDistillProcessor(tok,
                                  text_prefix=parse_prefix(CLI_TEXT_PREFIX))
    ids = [proc.process_example({k: v[i] for k, v in rows.items()})
           ["input_ids"] for i in range(CLI_ROWS)]
    train_ids, eval_ids = stage1_data._eval_split(ids, CLI_S1_EVAL)
    return (len(stage1_data.pack_sequences(train_ids, seq, tok.eos_token_id)),
            len(stage1_data.pack_sequences(eval_ids, seq, tok.eos_token_id)))


def tensor_file(path: str):
    from safetensors import safe_open
    return safe_open(os.path.join(path, "model.safetensors"), framework="pt")


def cli(dev) -> tuple:
    """Phase 15: the distillation chain of README's "Pipelines" through
    each CLI's ``main`` at the 0.6B's full width (random weights):
    prepare-student, stage1, prepare-dataset, extract-logits, train
    (precomputed, PiSSA), evaluate with the full-size audio smoke, train
    (online sparse), and ``python -m speech_distill_tpu_torch``. Returns
    each CLI's launch counts and the working directory (a
    ``TemporaryDirectory`` holding ``s1/final_model`` and ``proc``)."""
    import shutil

    import datasets
    from scipy.io.wavfile import read as wav_read

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    record: dict = {}
    big = qwen3_student_0p6b()
    V, L = big.vocab_size, big.num_hidden_layers
    old_vocab = V - S1_NEW_TOKENS
    # the working directory outlives the phase: phase 17 reads its
    # stage-1 student and processed rows, then main() removes it
    work = tempfile.TemporaryDirectory()
    root = work.name
    def d(*names):
        return os.path.join(root, *names)

    # 1. the inputs: the student at Qwen3-0.6B's vocab, the teacher's
    # tokenizer at 159,488 ids, the raw dataset
    t0 = time.perf_counter()
    cli_tokenizer(d("student"), CLI_STUDENT_VOCAB, False)
    tok = cli_tokenizer(d("teacher"), big.speech_token_offset
                        - len(CLI_SPECIALS), True)
    if len(tok) != V or tok.convert_tokens_to_ids("<|0|>") != \
            big.speech_token_offset:
        fail(f"teacher tokenizer: {len(tok)} ids, <|0|> at "
             f"{tok.convert_tokens_to_ids('<|0|>')}")
    rows = cli_rows(np.random.default_rng(SEED + 15))
    datasets.Dataset.from_dict(rows).save_to_disk(d("raw"))
    tok_s = time.perf_counter() - t0
    scfg = qwen3_student_0p6b(CLI_STUDENT_VOCAB)
    model = qwen3.init_params_on_device(SEED, scfg, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    export_hf(model_to_tree(model), scfg, d("student"))
    export_s = time.perf_counter() - t0
    nbytes = os.path.getsize(d("student", "model.safetensors"))
    t0 = time.perf_counter()
    _, back = load_pretrained(d("student"), device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    if not all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                 back.parameters())):
        fail("the HF export of the student does not load back exactly")
    del model, back
    hf_io = {"bytes": nbytes, "export_s": export_s,
             "export_GB_per_s": nbytes / export_s / 1e9,
             "load_s": load_s, "load_GB_per_s": nbytes / load_s / 1e9}
    log(f"cli inputs: tokenizers and dataset s={tok_s:.2f}; student "
        f"HF dir (vocab {CLI_STUDENT_VOCAB}, fp32 safetensors) "
        + json.dumps(hf_io))

    # 2. prepare-student: expand to the teacher's 159,488 ids
    run_cli("prepare-student", student_cli.main,
            ["--teacher-model", d("teacher"), "--student-model",
             d("student"), "--output-dir", d("expanded")], record)
    with tensor_file(d("expanded")) as f, tensor_file(d("student")) as g:
        new = f.get_tensor("model.embed_tokens.weight")
        old = g.get_tensor("model.embed_tokens.weight")
    with open(d("expanded", "config.json")) as f:
        vocab = json.load(f)["vocab_size"]
    if vocab != V or tuple(new.shape) != (V, big.hidden_size):
        fail(f"prepare-student: vocab {vocab}, embed {tuple(new.shape)}")
    # every student token is a teacher token at the same id
    if not torch.equal(new[:CLI_STUDENT_VOCAB], old):
        fail("prepare-student: matched rows differ from the student's")
    if not torch.equal(new[CLI_STUDENT_VOCAB:].to(torch.bfloat16)
                       .float(), new[CLI_STUDENT_VOCAB:]):
        fail("prepare-student: new rows are not bf16 values")
    del new, old
    shutil.rmtree(d("student"))
    check_cli_launches("prepare-student", record, {})

    # 3. stage1 on the expanded student: K2 and K1 at T 4096
    n_train, n_eval = stage1_rows_expected(tok, rows, S1_T)
    steps = n_train // S1_B
    if steps != 2 or n_eval < 1:
        fail(f"stage-1 data packs {n_train} + {n_eval} rows, not 2 "
             f"steps and an eval")
    with LoopSpy() as spy:
        run_cli("stage1", stage1_data.main,
                ["--model_path", d("expanded"), "--dataset_path",
                 d("raw"), "--output_dir", d("s1"), "--num_epochs", "1",
                 "--batch_size", str(S1_B),
                 "--gradient_accumulation_steps", "1",
                 "--max_seq_length", str(S1_T), "--num_new_tokens",
                 str(S1_NEW_TOKENS), "--eval_size", str(CLI_S1_EVAL),
                 "--eval_steps", "2", "--eval_batch_size", "1",
                 "--warmup_steps", "1", "--logging_steps", "1",
                 "--num_workers", "1"], record)
    per_step = add_launches(
        {"lm_head_stats": 1, "lm_head_dh": 1, "lm_head_dw": 1,
         "flash_fwd": 2 * L, "flash_dq": L, "flash_dkv": L},
        train_launches(L))
    check_cli_steps("stage1", spy, steps, per_step)
    # eval rows one at a time
    want = add_launches(add_launches(per_step, times=steps),
                        {"flash_fwd": L * n_eval},
                        forward_launches(L, n_eval))
    check_cli_launches("stage1", record, want)
    s1_ms = [st["s"] * 1e3 for st in spy.steps]
    moved = 0
    with tensor_file(d("s1", "final_model")) as f, \
            tensor_file(d("expanded")) as g:
        for k in g.keys():
            a, b = f.get_tensor(k), g.get_tensor(k)
            if k == "model.embed_tokens.weight":
                moved = int((a[old_vocab:] != b[old_vocab:]).any(1)
                            .sum())
            elif not torch.equal(a, b):
                fail(f"stage1 changed {k}")
    if not moved:
        fail("stage1: no new embedding row moved")
    shutil.rmtree(d("expanded"))
    shutil.rmtree(d("s1", "ckpt"))
    log(f"cli stage1 checks: {steps} steps of B {S1_B} T {S1_T} "
        f"({n_train} packed rows), {n_eval} eval rows; step_ms "
        f"{s1_ms}; every non-embedding tensor bit-equal to the input, "
        f"{moved} of {S1_NEW_TOKENS} new rows moved")

    # 4. prepare-dataset, then extract-logits with the stage-1 model as
    # the teacher (it stands in for the 1.7B)
    run_cli("prepare-dataset", prepare_cli.main,
            ["--dataset_path", d("raw"), "--output_path", d("proc"),
             "--student_model", d("s1", "final_model")], record)
    check_cli_launches("prepare-dataset", record, {})
    real_extract = extract_cli.extract_teacher_logprobs
    timed = {}

    def extract_timed(*a, **kw):
        t = time.perf_counter()
        out = real_extract(*a, **kw)
        torch.cuda.synchronize()
        timed["s"] = time.perf_counter() - t
        return out
    extract_cli.extract_teacher_logprobs = extract_timed
    try:
        run_cli("extract-logits", extract_cli.main,
                ["--teacher_model_path", d("s1", "final_model"),
                 "--dataset_path", d("proc"), "--output_path", d("enr"),
                 "--top_k", str(CLI_K), "--batch_size", str(CLI_B),
                 "--pad_to_multiple_of", str(CLI_T)], record)
    finally:
        extract_cli.extract_teacher_logprobs = real_extract
    batches = -(-CLI_ROWS // CLI_B)
    check_cli_launches("extract-logits", record, add_launches(
        {"flash_fwd": L * batches}, forward_launches(L, batches)))
    ds = datasets.load_from_disk(d("enr"))
    real_tokens = 0
    for row in ds:
        v = np.asarray(row["teacher_top_k_v"], np.float32)
        i = np.asarray(row["teacher_top_k_i"])
        n = len(row["teacher_input_ids"])
        real_tokens += n
        if v.shape != (n, CLI_K) or i.shape != (n, CLI_K) or n > CLI_T:
            fail(f"extract-logits: a row of {n} tokens has columns "
                 f"{v.shape} / {i.shape}")
        if not (np.isfinite(v).all() and (v <= 0).all()
                and ((i >= 0) & (i < V)).all()):
            fail("extract-logits: values not finite and <= 0, or "
                 "indices out of the vocabulary")
    extract = {"rows": len(ds), "batches": batches,
               "real_tokens": real_tokens,
               "extract_s": timed["s"],
               "padded_tokens_per_s": batches * CLI_B * CLI_T
               / timed["s"],
               "real_tokens_per_s": real_tokens / timed["s"]}
    log("cli extract-logits checks: " + json.dumps(extract))

    # 5. train, precomputed, PiSSA LoRA, student = the stage-1 model
    with LoopSpy() as spy:
        run_cli("train", train_cli.main,
                ["--dataset_path", d("enr"), "--student_model",
                 d("s1", "final_model"), "--output_dir", d("kd"),
                 "--use_lora", "--per_device_train_batch_size",
                 str(CLI_B), "--gradient_accumulation_steps", "1",
                 "--pad_to_multiple_of", str(CLI_T), "--max_steps", "4",
                 "--test_size", str(CLI_TRAIN_TEST)], record)
    per_step = add_launches({"flash_fwd": 2 * L, "flash_dq": L,
                             "flash_dkv": L}, train_launches(L))
    check_cli_steps("train", spy, 4, per_step)
    # the held-out batch
    want = add_launches(add_launches(per_step, times=4), {"flash_fwd": L},
                        forward_launches(L, 1))
    check_cli_launches("train", record, want)
    kd_ms = [st["s"] * 1e3 for st in spy.steps]
    merged = merge_and_export(spy.frozen[0], spy.state.trainable,
                              LoraConfig())
    _, back = load_pretrained(d("kd", "final_model"), device=dev)
    pairs = zip(tree_leaves(model_to_tree(back)), tree_leaves(merged))
    if not all(torch.equal(a, b.to(torch.bfloat16)) for a, b in pairs):
        fail("train: final_model != merge_and_export of the trained "
             "state in bf16")
    del merged, back, spy
    shutil.rmtree(d("kd", "ckpt"))
    log(f"cli train checks: 4 steps of B {CLI_B} T {CLI_T}, step_ms "
        f"{kd_ms}, final_model == merge_and_export(trained state) in "
        f"bf16")

    # 6. evaluate the distilled student on the extracted dataset, with
    # the full-size audio smoke (random flow and HiFT)
    rep = run_cli("evaluate", evaluate_cli.main,
                  ["--student_model", d("kd", "final_model"),
                   "--dataset_path", d("enr"), "--pad_to_multiple_of",
                   str(CLI_T), "--smoke", "--smoke_max_tokens", "60",
                   "--smoke_wav", d("smoke.wav"), "--output",
                   d("quality.json")], record)
    n_batches = CLI_EVAL_TEST // 4
    # the batches, then the audio smoke's decode (a prefill and a forward
    # of each sampled token)
    decode = 1 + rep["smoke"]["generated_tokens"]
    check_cli_launches("evaluate", record, add_launches(
        {"flash_fwd": L * n_batches},
        forward_launches(L, n_batches + decode)))
    values = [v for sl in ("all", "speech")
              for k, v in rep["metrics"][sl].items() if v is not None]
    if rep["rows"] != 4 * n_batches or not np.isfinite(values).all():
        fail(f"evaluate: rows {rep['rows']}, metrics {rep['metrics']}")
    sm = rep["smoke"]
    if sm["status"] == "ok":
        rate, wav = wav_read(d("smoke.wav"))
        if len(wav) != sm["expected_samples"] or \
                sm["wav_samples"] != sm["expected_samples"]:
            fail(f"evaluate smoke: {len(wav)} samples, expected "
                 f"{sm['expected_samples']}")
    elif sm["status"] != "no_speech_tokens":
        fail(f"evaluate smoke: {sm}")
    log("cli evaluate checks: " + json.dumps(
        {"metrics": rep["metrics"], "smoke": sm}))
    shutil.rmtree(d("kd"))

    # 7. train, online sparse: the stage-1 model teaches itself
    with LoopSpy() as spy:
        run_cli("train-online", train_cli.main,
                ["--dataset_path", d("proc"), "--student_model",
                 d("s1", "final_model"), "--teacher_model",
                 d("s1", "final_model"), "--output_dir", d("online"),
                 "--use_lora", "--init_lora_weights", "gaussian",
                 "--per_device_train_batch_size", str(CLI_B),
                 "--gradient_accumulation_steps", "1",
                 "--pad_to_multiple_of", str(CLI_T), "--max_steps", "2",
                 "--test_size", str(CLI_TRAIN_TEST)], record)
    # a step: the teacher's forward, then the student's
    per_step = add_launches({"flash_fwd": 3 * L, "flash_dq": L,
                             "flash_dkv": L}, forward_launches(L, 1),
                            train_launches(L))
    check_cli_steps("train-online", spy, 2, per_step)
    # eval: teacher, student
    want = add_launches(add_launches(per_step, times=2),
                        {"flash_fwd": 2 * L}, forward_launches(L, 2))
    check_cli_launches("train-online", record, want)
    del spy
    shutil.rmtree(d("online"))

    # 8. the entry point
    def entry(*args):
        return subprocess.run([sys.executable, "-m",
                               "speech_distill_tpu_torch", *args],
                              capture_output=True, text=True, timeout=120,
                              cwd=os.path.dirname(os.path.abspath(__file__)))
    res = entry("--help")
    listed = [c for c in ("prepare-student", "stage1", "prepare-dataset",
                          "extract-logits", "train", "synthesize", "evaluate")
              if f"  {c} " in res.stdout]
    if res.returncode != 0 or len(listed) != 7:
        fail(f"python -m speech_distill_tpu_torch --help: rc "
             f"{res.returncode}, commands {listed}")
    if entry("no-such-command").returncode != 1:
        fail("an unknown command does not exit 1")
    rates = {
        "hf_io": hf_io,
        "stage1_cli_step_ms": s1_ms,
        "stage1_cli_tokens_per_s": S1_B * S1_T / float(np.median(s1_ms))
        * 1e3,
        "phase10_stage1_step_ms": RATES.get("stage1_step_ms"),
        "phase10_stage1_tokens_per_s": RATES.get("stage1_tokens_per_s"),
        "train_cli_tokens_per_s": CLI_B * CLI_T
        / float(np.median(kd_ms[1:])) * 1e3,
        "phase6_train_tokens_per_s": RATES.get("train_tokens_per_s"),
        "extract_cli_padded_tokens_per_s": extract["padded_tokens_per_s"],
        "phase9b_extract_tokens_per_s": RATES.get("extract_tokens_per_s"),
        "seconds": {k: v["s"] for k, v in record.items()}}
    log("cli " + json.dumps(rates) + " (stage-1 CLI: A 1, 16,384 tokens a "
        "step; phase 10: A 4; phase 9b extracts with the 1.7B teacher)")
    log(f"cli phase s={time.perf_counter() - t_phase:.2f}")
    return {k: v["launches"] for k, v in record.items()}, work


# Phase 16: synthesis. Two prompt wavs whose 16 kHz lengths give 200 and
# 225 S3 codes (8 s at 44.1 kHz, 9 s at 24 kHz): with the prompt texts
# and the first turn's text the first prefill holds <= 512 tokens, a
# flash width; two turns, one a speaker, each capped at SYN_TURN_TOKENS
# tokens (the random 1.7B almost never samples its stop id, and the CLI
# has no cap flag: the smoke sets the run's EngineConfig sampling)
SYN_WAVS = (("S1", 44100, 8.0, "hello there"), ("S2", 24000, 9.0, "hi there"))
SYN_TURNS = (("S1", "welcome to the show"), ("S2", "glad to be here"))
SYN_TURN_TOKENS = 24            # 2 turns of 24 (cut from 4 of 30)
# an S3 code may differ between the card and the CPU only where the fp32
# FSQ value of the differing digit lies this close to a +-0.5 edge
SYN_FSQ_EDGE = 1e-4
SYN_XVEC_REL = 1e-4      # max |card - CPU| / max |CPU| of an x-vector


def synth_model_dir(d: str, dev) -> dict:
    """The synthesis model directory at full width, random weights from
    SEED: the 1.7B (bf16 safetensors, config.json and
    soulxpodcast_config.json), phase 15's 159,488-id tokenizer, flow.pt
    and hift.pt at full size, speech_tokenizer_v2.pt at the reference v2
    size and campplus.pt. Returns each file's bytes and the seconds."""
    from speech_distill_tpu_torch.models import campplus
    from speech_distill_tpu_torch.tokenizer import s3
    t0 = time.perf_counter()
    cfg = qwen3_teacher_1p7b()
    tok = cli_tokenizer(d, cfg.speech_token_offset - len(CLI_SPECIALS), True)
    if len(tok) != cfg.vocab_size:
        fail(f"synthesis tokenizer: {len(tok)} ids")
    llm = qwen3.init_params_on_device(SEED, cfg, dev)
    # a released checkpoint's bf16 tensors (export_hf writes fp32)
    from safetensors.torch import save_file
    save_file({k: torch.from_numpy(v).bfloat16() for k, v in
               to_state_dict(model_to_tree(llm), cfg).items()},
              os.path.join(d, "model.safetensors"))
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(hf_config(cfg), f, indent=2)
    del llm
    with open(os.path.join(d, "soulxpodcast_config.json"), "w") as f:
        json.dump(cfg.to_dict(), f)
    torch.save(flow_lib.init_params(flow_lib.FlowConfig(), SEED, dev)
               .state_dict(), os.path.join(d, "flow.pt"))
    torch.save(hift_lib.init_params(hift_lib.HiFTConfig(), SEED, dev)
               .state_dict(), os.path.join(d, "hift.pt"))
    torch.save(s3.init_params_on_device(SEED, s3.S3Config(), dev)
               .state_dict(), os.path.join(d, "speech_tokenizer_v2.pt"))
    torch.manual_seed(SEED)                 # CAM++'s default init draws
    torch.save(campplus.CAMPPlus(device=dev).state_dict(),
               os.path.join(d, "campplus.pt"))
    torch.cuda.synchronize()
    sizes = {f: os.path.getsize(os.path.join(d, f)) for f in (
        "model.safetensors", "flow.pt", "hift.pt", "speech_tokenizer_v2.pt",
        "campplus.pt")}
    return {"bytes": sizes, "s": time.perf_counter() - t0}


def synth_script(d: str) -> str:
    """Two seeded int16 prompt wavs and the two-turn script."""
    from scipy.io.wavfile import write as wav_write
    rng = np.random.default_rng(SEED + 16)
    speakers = {}
    for name, sr, secs, text in SYN_WAVS:
        t = np.arange(int(sr * secs)) / sr
        f0 = rng.uniform(90, 220) * (1 + 0.1 * np.sin(2 * np.pi * 3 * t))
        phase = 2 * np.pi * np.cumsum(f0) / sr
        voiced = sum(np.sin(k * phase) / k for k in range(1, 30))
        env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(2, 5) * t) ** 2
        a = 0.2 * voiced * env / np.abs(voiced).max() \
            + 0.003 * rng.normal(size=t.shape)
        path = os.path.join(d, f"{name}.wav")
        wav_write(path, sr, (a * 32767).astype(np.int16))
        speakers[name] = {"prompt_text": text, "prompt_audio": path}
    path = os.path.join(d, "script.json")
    with open(path, "w") as f:
        json.dump({"speakers": speakers,
                   "text": [list(t) for t in SYN_TURNS]}, f)
    return path


class SynthSpy:
    """While ``synthesize.main`` runs: wraps ``initiate_model`` to time
    and record the S3 quantize and CAM++ calls (inputs, outputs, ms) and
    the engine's turns (tokens, seconds, fresh prefill widths, decode
    steps, model forwards), the orchestrator's flow + HiFT ms a turn
    (offline) or its first audio a turn (streaming), and the returned
    wavs. The run's EngineConfig gets the turn cap."""

    def __init__(self, sp: SamplingParams):
        from speech_distill_tpu_torch.infer import infer_utils
        self.mod, self.sp = infer_utils, sp
        self.quant, self.xvec, self.turns, self.synth = [], [], [], []
        self.wavs, self.first_audio, self.fresh = [], [], []

    def __enter__(self):
        mod, spy = self.mod, self
        self.real_init, self.real_ec = mod.initiate_model, mod.EngineConfig
        mod.EngineConfig = lambda **kw: self.real_ec(sampling=self.sp, **kw)

        def init(*a, **kw):
            model, dataset = spy.real_init(*a, **kw)
            spy.wrap(model, dataset)
            return model, dataset
        mod.initiate_model = init
        return self

    def __exit__(self, *exc):
        self.mod.initiate_model = self.real_init
        self.mod.EngineConfig = self.real_ec

    @staticmethod
    def timed(fn, *a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    def wrap(self, model, dataset):
        spy, eng = self, model.llm
        self.model = model
        quant, emb = model.s3_quantize, dataset.spk_emb_fn

        def s3_quantize(mels, lens):
            (codes, clens), ms = spy.timed(quant, mels, lens)
            spy.quant.append({"mels": np.asarray(mels), "lens": np.asarray(
                lens), "codes": codes.cpu().numpy(), "code_lens":
                clens.cpu().numpy(), "ms": ms})
            return codes, clens

        def spk_emb_fn(feat):
            out, ms = spy.timed(emb, feat)
            spy.xvec.append({"feat": feat, "emb": out, "ms": ms})
            return out
        model.s3_quantize, dataset.spk_emb_fn = s3_quantize, spk_emb_fn

        def record(prefill_len, tokens, s, steps, forwards):
            spy.turns.append({"prefill_tokens": prefill_len,
                              "tokens": len(tokens), "s": s,
                              "decode_steps": steps, "forwards": forwards})

        if eng.stateful:
            real_prefill, real_stream = eng.prefill, eng.generate_stream
            real_gen = eng.generate

            def prefill(state, new_ids):
                if int(state.length[0]) == 0:
                    spy.fresh.append(eng._bucketed(len(new_ids)))
                return real_prefill(state, new_ids)
            eng.prefill = prefill

            def generate(ids, state=None):
                out, ms = spy.timed(real_gen, ids, state=state)
                # the prefill, then a forward of each sampled token
                record(len(ids), out["token_ids"], ms / 1e3,
                       len(out["token_ids"]), 1 + len(out["token_ids"]))
                return out
            eng.generate = generate

            def generate_stream(ids, **kw):
                # decode seconds only: the synthesis the consumer runs
                # between chunks is left out
                it, toks, busy = real_stream(ids, **kw), [], 0.0
                while True:
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    new = next(it, None)
                    torch.cuda.synchronize()
                    busy += time.perf_counter() - t
                    if new is None:
                        break
                    toks.extend(new)
                    yield new
                record(len(ids), toks, busy, len(toks), 1 + len(toks))
            eng.generate_stream = generate_stream
        else:
            real_gen = eng.generate

            def generate(ids, max_new=None):
                out, ms = spy.timed(real_gen, ids, max_new)
                record(len(ids), out["token_ids"], ms / 1e3,
                       eng.n_decode_steps,
                       eng.n_prefill_forwards + eng.n_decode_steps)
                if not eng.prefix_hits:
                    spy.fresh.append(-(-len(ids) // eng.ps) * eng.ps)
                return out
            eng.generate = generate

        real_t2w = model._token_to_wav

        def token_to_wav(*a, **kw):
            wav, ms = spy.timed(real_t2w, *a, **kw)
            spy.synth.append(ms)
            spy.wavs.append(wav)
            return wav
        model._token_to_wav = token_to_wav

        real_stream_lf = model.forward_longform_streaming

        def forward_longform_streaming(**kw):
            t, cur = time.perf_counter(), -1
            for turn, chunk in real_stream_lf(**kw):
                if turn != cur:
                    spy.first_audio.append(
                        (time.perf_counter() - t) * 1e3)
                    spy.wavs.append([])
                    cur = turn
                spy.wavs[-1].append(chunk)
                yield turn, chunk
                t = time.perf_counter()
        model.forward_longform_streaming = forward_longform_streaming


def fsq_values(model, mels, lens) -> np.ndarray:
    """The fp32 FSQ values tanh(project_down(h)) * 0.999 before rounding
    [B, T', fsq_dim] on the model's device."""
    from speech_distill_tpu_torch.core.device import full_fp32
    from speech_distill_tpu_torch.tokenizer import s3
    mels = torch.as_tensor(mels).to(model.device)
    lens = torch.as_tensor(lens).to(model.device).long()
    T_out = s3.conv_out_len(s3.conv_out_len(mels.shape[-1]))
    mask = torch.arange(T_out, device=model.device)[None] < \
        s3.conv_out_len(s3.conv_out_len(lens))[:, None]
    with full_fp32(), torch.no_grad():
        h = model.quantizer.project_down(s3.encode(model, mels, mask))
    return (torch.tanh(h) * np.float32(0.999)).cpu().numpy()


class CpuReference:
    """The port's S3 codes, fp32 FSQ values and CAM++ x-vectors on the
    CPU from the model directory's checkpoints, each computed once for
    a given input: the runs of phase 16 quantize the same prompts."""

    def __init__(self, d: str):
        from speech_distill_tpu_torch.models import campplus
        from speech_distill_tpu_torch.tokenizer import s3
        self.s3 = s3.load_s3_tokenizer(
            os.path.join(d, "speech_tokenizer_v2.pt"), device="cpu").model
        self.camp = campplus.from_state_dict(
            torch.load(os.path.join(d, "campplus.pt"), map_location="cpu",
                       weights_only=True), device="cpu")
        self.memo = {}

    def _once(self, key, fn):
        if key not in self.memo:
            self.memo[key] = fn()
        return self.memo[key]

    def codes(self, mels, lens):
        """(codes, code lengths, FSQ values) as numpy."""
        from speech_distill_tpu_torch.tokenizer import s3

        def run():
            ref, ref_lens = s3.quantize(self.s3, mels, lens)
            return (ref.numpy(), ref_lens.numpy(),
                    fsq_values(self.s3, mels, lens))
        return self._once(("s3", mels.tobytes(), lens.tobytes()), run)

    def xvector(self, feat):
        from speech_distill_tpu_torch.models import campplus
        feat = np.asarray(feat, np.float32)
        return self._once(("campplus", feat.shape, feat.tobytes()),
                          lambda: campplus.embed_one(
                              self.camp, torch.from_numpy(feat)).numpy())


def check_prompt_codes(spy: SynthSpy, cpu: CpuReference) -> dict:
    """The card's prompt codes against the port's on the CPU for the same
    log-mels: a code may differ only where each differing digit's fp32
    FSQ value lies within SYN_FSQ_EDGE of +-0.5 (each flip logged with
    its distance); the card's x-vectors within SYN_XVEC_REL of the CPU's
    on the same fbank."""
    flips, n_codes = [], 0
    for q in spy.quant:
        ref, ref_lens, vals = cpu.codes(q["mels"], q["lens"])
        if not np.array_equal(ref_lens, q["code_lens"]):
            fail(f"synthesis: code lengths {q['code_lens']} on the card, "
                 f"{ref_lens.tolist()} on the CPU")
        n_codes += int(q["code_lens"].sum())
        for b, t in zip(*np.nonzero(ref != q["codes"])):
            dc = np.base_repr(int(ref[b, t]), 3).zfill(8)[::-1]
            dg = np.base_repr(int(q["codes"][b, t]), 3).zfill(8)[::-1]
            for i in (i for i in range(8) if dc[i] != dg[i]):
                dist = abs(abs(float(vals[b, t, i])) - 0.5)
                flips.append({"row": int(b), "frame": int(t), "digit": i,
                              "fsq_value": float(vals[b, t, i]),
                              "edge_distance": dist})
                if dist > SYN_FSQ_EDGE:
                    fail(f"synthesis: S3 code flip at row {b} frame {t} "
                         f"digit {i}, {dist:.2e} from the rounding edge")
    xerr = 0.0
    for x in spy.xvec:
        ref = cpu.xvector(x["feat"])
        xerr = max(xerr, float(np.abs(x["emb"] - ref).max()
                               / np.abs(ref).max()))
    if not spy.xvec or xerr > SYN_XVEC_REL:
        fail(f"synthesis: x-vector card vs CPU {xerr:.2e} relative")
    return {"codes": n_codes, "flips": flips, "xvector_max_rel_err": xerr}


def synthesis(dev) -> dict:
    """Phase 16: ``synthesize.main`` three times at full width (the 1.7B,
    the v2 S3 tokenizer, CAM++, the full-size flow and HiFT; random
    weights) on a two-turn two-speaker script, each run through its main
    in this process with the launch counts set to 0 just before it and
    read just after: the CLI's default (the contiguous engine, offline),
    the same engine with ``--streaming``, then ``--llm_engine paged``
    offline (the long-form streaming path needs the stateful engine, as
    in JAX). Returns each run's launch counts."""
    from scipy.io.wavfile import read as wav_read
    from speech_distill_tpu_torch.pipelines import synthesize
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cfg = qwen3_teacher_1p7b()
    L = cfg.num_hidden_layers
    sp = SamplingParams(max_tokens=SYN_TURN_TOKENS,
                        stop_token_ids=(cfg.eos_token_id,))
    # the CLI's process defaults: TF32 off for matmuls, on for cuDNN; the
    # S3 tokenizer and CAM++ must hold fp32 themselves
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    record, out = {}, {}
    try:
        with tempfile.TemporaryDirectory() as d:
            made = synth_model_dir(d, dev)
            script = synth_script(d)
            log("synthesis model dir " + json.dumps(made))
            cpu = None          # the CPU references, loaded after a run
            for run, extra in (("offline", []),
                               ("streaming", ["--streaming"]),
                               ("paged", ["--llm_engine", "paged"])):
                gc.collect()    # the last run's models, so each peak is its own
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                with SynthSpy(sp) as spy:
                    torch.cuda.synchronize()
                    _cuda.reset_launches()
                    t = time.perf_counter()
                    path = synthesize.main(
                        ["--model_path", d, "--script", script,
                         "--output_dir", os.path.join(d, run),
                         "--seed", str(SEED)] + extra)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t
                    counts = {k: v for k, v in _cuda.launches.items() if v}
                record[run] = counts
                cpu = cpu or CpuReference(d)
                out[run] = check_synthesis_run(run, path, spy, counts, wall,
                                               L, cpu)
                del spy     # its wrappers hold the run's model in a cycle
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    log(f"synthesis phase s={time.perf_counter() - t_phase:.2f}")
    return record


def check_synthesis_run(run: str, path: str, spy: SynthSpy, counts: dict,
                        wall: float, L: int, cpu: CpuReference) -> dict:
    """Phase 16's checks and numbers for one run (see ``synthesis``)."""
    from scipy.io.wavfile import read as wav_read
    rate, wav = wav_read(path)
    turns = spy.turns
    want = sum(2 * (t["tokens"] - 1) * 480 for t in turns)
    wavs = [w if isinstance(w, np.ndarray) else np.concatenate(w)
            for w in spy.wavs]
    if len(turns) != len(SYN_TURNS) or len(wavs) != len(SYN_TURNS):
        fail(f"synthesis {run}: {len(turns)} turns, {len(wavs)} wavs")
    for i, (t, w) in enumerate(zip(turns, wavs)):
        if not np.isfinite(w).all() or w.shape != (2 * (t["tokens"] - 1)
                                                   * 480,):
            fail(f"synthesis {run} turn {i}: wav {w.shape} for "
                 f"{t['tokens']} tokens (finite {bool(np.isfinite(w).all())})")
    if rate != 24000 or wav.dtype != np.int16 or len(wav) != want:
        fail(f"synthesis {run}: {path} is {rate} Hz {wav.dtype} "
             f"{len(wav)} samples, want 24000 int16 {want}")
    if not spy.fresh or not is_flash_width(spy.fresh[0]):
        fail(f"synthesis {run}: the first prefill's width {spy.fresh} is "
             f"not a flash width")
    want_k = {"flash_fwd": L * sum(is_flash_width(w) for w in spy.fresh)}
    if run == "paged":
        want_k["paged_decode"] = L * sum(t["decode_steps"] for t in turns)
    want_k = add_launches(want_k, forward_launches(
        L, sum(t["forwards"] for t in turns)))
    if counts != want_k:
        fail(f"synthesis {run} launches {counts} != {want_k}")
    codes = check_prompt_codes(spy, cpu)
    audio_s = len(wav) / 24000
    rep = {
        "run": run, "card": record_card(), "wall_s": wall, "audio_s": audio_s,
        "x_realtime": audio_s / wall,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        "s3_quantize_ms": [q["ms"] for q in spy.quant],
        "campplus_ms": [x["ms"] for x in spy.xvec],
        "turns": [{"prefill_tokens": t["prefill_tokens"],
                   "tokens": t["tokens"], "s": t["s"],
                   "decode_ms_per_step": t["s"] * 1e3 / max(t["tokens"], 1),
                   "tokens_per_s": t["tokens"] / t["s"]} for t in turns],
        "fresh_prefill_widths": spy.fresh,
        "flow_hift_ms": spy.synth, "first_audio_ms": spy.first_audio,
        "prompt_codes": codes, "launches": counts,
        "turn_cap": SYN_TURN_TOKENS}
    log(f"synthesis {run} " + json.dumps(rep))
    return rep


# ---------------------------------------------------------------------------
# Phase 17: the CosyVoice2 teacher and the 8-bit optimizer
# ---------------------------------------------------------------------------

CV_SEED = SEED + 17
CV_STEPS = 2                    # the train CLI's steps (B 8, T 512, K 128)
CV_DEPTH, CV_CHECK_B = 2, 2     # 17c: the teacher at reduced depth
# the phase-15 rows' teacher ids: speech tokens at the Qwen3 configs'
# offset (152,927 + code) fold onto CosyVoice2's speech range (152,706 +
# code); every other id lies below 152,927 already
CV_FOLD = (qwen3_student_0p6b().speech_token_offset
           - cv2.CosyVoice2Config().speech_offset)
CV_S1_STEPS = 2                 # 17e: stage 1, B 4, T 4096, A 1
OPT_ITERS = 5                   # timed optimizer updates on the tree
# 17f: the fused clip + AdamW against the default on the same gradients:
# fp32 leaves within FUSED_REL of the largest update; a bf16 leaf's
# fused update is cast to bf16 (JAX's contract), so it may sit one bf16
# ulp from the default's rounded fp32 update on at most FUSED_FLIPS of
# its elements
FUSED_REL, FUSED_FLIPS = 1e-6, 1e-3


def cv_unified_ids(cfg, rng, B: int, T: int) -> np.ndarray:
    """[B, T] unified ids: text below the backbone's vocab, sos, speech
    codes at the speech offset, eos."""
    n_text = T // 4
    return np.concatenate([
        rng.integers(0, cfg.backbone.vocab_size, (B, n_text)),
        np.full((B, 1), cfg.sos_id),
        rng.integers(cfg.speech_offset, cfg.speech_offset
                     + cfg.speech_token_size, (B, T - n_text - 2)),
        np.full((B, 1), cfg.eos_unified)], axis=1).astype(np.int64)


class TeacherSpy:
    """While a CLI runs, the teacher routes that ``cosyvoice2.
    make_teacher_forward`` and ``make_teacher_extract`` return count the
    K1-fwd launches made inside each of their calls, and the calls."""

    def __enter__(self):
        self.real = (cv2.make_teacher_forward, cv2.make_teacher_extract)
        self.calls, self.flash_fwd = 0, 0

        def counted(make):
            def factory(*a, **kw):
                fn = make(*a, **kw)

                def route(*args):
                    before = _cuda.launches["flash_fwd"]
                    out = fn(*args)
                    self.calls += 1
                    self.flash_fwd += _cuda.launches["flash_fwd"] - before
                    return out
                return route
            return factory
        cv2.make_teacher_forward, cv2.make_teacher_extract = map(counted,
                                                                 self.real)
        return self

    def __exit__(self, *exc):
        cv2.make_teacher_forward, cv2.make_teacher_extract = self.real


def cv_train_cli(root: str, teacher, record: dict) -> dict:
    """17a: ``train.main --teacher_family cosyvoice2`` on phase 15's
    stage-1 student and processed rows (teacher ids folded below
    159,271), the teacher a reference-named torch checkpoint of
    ``teacher``; online sparse, K 128, B 8, T 512, gaussian LoRA, 2 steps
    and the held-out batch. Exact K1 counts: 24 K1-fwd a teacher forward,
    the student's 2 x 28 K1-fwd (remat) and 28 K1-dq / K1-dkv a step; the
    teacher's share counted inside its own calls (``TeacherSpy``)."""
    import datasets
    import shutil

    def d(*names):
        return os.path.join(root, *names)
    cfg = teacher.cfg
    t0 = time.perf_counter()
    torch.save(cv2.torch_state(teacher), d("cosyvoice2.pt"))
    save_s = time.perf_counter() - t0
    off = qwen3_student_0p6b().speech_token_offset
    rows = datasets.load_from_disk(d("proc")).map(
        lambda r: {"teacher_input_ids": [t - CV_FOLD if t >= off else t
                                         for t in r["teacher_input_ids"]]})
    rows.save_to_disk(d("proc_cv"))
    top = max(max(r) for r in rows["teacher_input_ids"])
    if top >= cfg.unified_vocab_size:
        fail(f"cosyvoice2 rows: teacher id {top} past the unified table")
    with LoopSpy() as spy, TeacherSpy() as tspy:
        run_cli("train-cosyvoice2", train_cli.main,
                ["--dataset_path", d("proc_cv"), "--student_model",
                 d("s1", "final_model"), "--teacher_model",
                 d("cosyvoice2.pt"), "--teacher_family", "cosyvoice2",
                 "--output_dir", d("cv"), "--use_lora",
                 "--init_lora_weights", "gaussian",
                 "--per_device_train_batch_size", str(CLI_B),
                 "--gradient_accumulation_steps", "1",
                 "--pad_to_multiple_of", str(CLI_T), "--top_k", str(CLI_K),
                 "--max_steps", str(CV_STEPS), "--test_size",
                 str(CLI_TRAIN_TEST)], record)
    L = qwen3_student_0p6b().num_hidden_layers
    Lt = cfg.backbone.num_hidden_layers
    # the teacher's layers: RoPE alone in the q/k kernel (no q/k norm)
    per_step = add_launches({"flash_fwd": Lt + 2 * L, "flash_dq": L,
                             "flash_dkv": L}, forward_launches(Lt, 1),
                            train_launches(L))
    check_cli_steps("train-cosyvoice2", spy, CV_STEPS, per_step)
    # eval: teacher, student
    want = add_launches(add_launches(per_step, times=CV_STEPS),
                        {"flash_fwd": Lt + L}, forward_launches(Lt, 1),
                        forward_launches(L, 1))
    check_cli_launches("train-cosyvoice2", record, want)
    # the teacher's share, counted inside its calls: 24 a forward, one
    # forward a step and one for the held-out batch
    teacher_fwd = {"calls": tspy.calls, "flash_fwd": tspy.flash_fwd}
    if teacher_fwd != {"calls": CV_STEPS + 1,
                       "flash_fwd": Lt * (CV_STEPS + 1)}:
        fail(f"cosyvoice2 train cli: teacher calls and K1-fwd launches "
             f"{teacher_fwd}, not {CV_STEPS + 1} calls of {Lt}")
    student_fwd = record["train-cosyvoice2"]["launches"]["flash_fwd"] \
        - tspy.flash_fwd
    out = {"checkpoint_s": save_s, "top_teacher_id": top,
           "teacher_calls": tspy.calls,
           "teacher_flash_fwd": tspy.flash_fwd,
           "student_flash_fwd": student_fwd,
           "step_ms": [st["s"] * 1e3 for st in spy.steps],
           "loss": [st["loss"] for st in spy.steps],
           "s": record["train-cosyvoice2"]["s"]}
    del spy
    shutil.rmtree(d("cv"))
    log("cosyvoice2 train cli " + json.dumps(out))
    return out


def cv_extract_routes(teacher, dev) -> dict:
    """17b: ``make_teacher_extract`` "materialized" against "fused" at
    B 8, T 512, K 128 for the full student vocabulary: the same set where
    the unified logits' K-th and (K+1)-th differ by > EXTRACT_GAP, sorted
    values within EXTRACT_ULPS fp16 ulps; each route timed once."""
    cfg, V, K = teacher.cfg, qwen3_student_0p6b().vocab_size, CLI_K
    ids = torch.as_tensor(cv_unified_ids(cfg, np.random.default_rng(
        CV_SEED), CLI_B, CLI_T), device=dev)
    mask = torch.ones_like(ids)
    res, out = {}, {}
    for route in cv2.EXTRACTS:
        fn = cv2.make_teacher_extract(cfg, K, V, extract=route)
        fn(teacher, ids, mask)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res[route] = fn(teacher, ids, mask)
        torch.cuda.synchronize()
        out[f"{route}_ms"] = (time.perf_counter() - t0) * 1e3
    top = torch.topk(cv2.forward(teacher, ids, mask)[..., :V], K + 1,
                     dim=-1).values
    gap_ok = (top[..., K - 1] - top[..., K]) > EXTRACT_GAP
    del top
    ref = res["materialized"]
    tol = EXTRACT_ULPS * fp16_ulp(sorted_sets(*ref)[0])
    out.update(compare_topk("cosyvoice2 extraction fused", res["fused"],
                            ref, gap_ok, tol))
    out["excluded_share"] = 1.0 - float(gap_ok.float().mean())
    out["speech_share"] = float((ref[1] >= cfg.speech_offset).float().mean())
    log("cosyvoice2 extraction " + json.dumps(out) + f" (B {CLI_B} T "
        f"{CLI_T} K {K}; sets held where the K-th and (K+1)-th logits "
        f"differ by > {EXTRACT_GAP}, values within {EXTRACT_ULPS} fp16 "
        f"ulps)")
    return out


def cv_model_path(teacher, dev) -> dict:
    """17c: the teacher cut to CV_DEPTH layers, its unified logits at
    B 2, T 512 through the kernel route (K1-fwd at Dh 64, G 7) and the
    plain route in bf16, both against the plain route in fp32; the
    kernel route's error within BF16_ERR_RATIO x the plain route's, over
    the head columns (the -10000 filler is exact everywhere)."""
    cfg = teacher.cfg
    bb = dataclasses.replace(cfg.backbone, num_hidden_layers=CV_DEPTH)
    state = {k: v for k, v in teacher.state_dict().items()
             if not k.startswith("backbone.layers.")
             or int(k.split(".")[2]) < CV_DEPTH}
    models = {}
    for name, dtype, impl in (("kernel", "bfloat16", "auto"),
                              ("plain", "bfloat16", "xla"),
                              ("fp32", "float32", "xla")):
        c = dataclasses.replace(cfg, backbone=dataclasses.replace(
            bb, dtype=dtype, attn_impl=impl))
        m = cv2.CosyVoice2(c, dev, head_dtype=teacher.llm_embedding.dtype
                           if dtype == "bfloat16" else torch.float32)
        m.load_state_dict(state)
        models[name] = m
    ids = torch.as_tensor(cv_unified_ids(cfg, np.random.default_rng(
        CV_SEED + 1), CV_CHECK_B, CLI_T), device=dev)
    torch.cuda.synchronize()
    before = _cuda.launches["flash_fwd"]
    logits = {name: cv2.forward(m, ids) for name, m in models.items()}
    torch.cuda.synchronize()
    ran = _cuda.launches["flash_fwd"] - before
    ref = logits["fp32"]
    cols = ref[0, 0] != cv2.NEG_FILL
    scale = ref[..., cols].abs().max()
    err = {name: float((logits[name][..., cols] - ref[..., cols]).abs().max()
                       / scale) for name in ("kernel", "plain")}
    finite = all(bool(torch.isfinite(t).all()) for t in logits.values())
    filler = all(torch.equal(t[..., ~cols], ref[..., ~cols])
                 for t in logits.values())
    out = {"depth": CV_DEPTH, "B": CV_CHECK_B, "T": CLI_T,
           "kernel_rel_err": err["kernel"], "plain_rel_err": err["plain"],
           "flash_fwd_launches": ran, "finite": finite,
           "filler_exact": filler}
    log("cosyvoice2 model path " + json.dumps(out) + f" (max |bf16 - fp32|"
        f" / max |fp32| over the head columns; kernel within "
        f"{BF16_ERR_RATIO}x plain)")
    if ran != CV_DEPTH or not finite or not filler or not \
            err["kernel"] <= BF16_ERR_RATIO * err["plain"]:
        fail(f"cosyvoice2 model path: {out}")
    del models, logits
    return out


def cv_flash(dev, launches: int, side) -> dict:
    """17d: K1-fwd at the teacher's shape, B 8, T 512, H 14, KV 2, Dh 64
    (G 7, the unpaired one-head path), against its plain version and
    timed beside SDPA by graph replays."""
    rng = np.random.default_rng(CV_SEED + 2)
    q, k, v = flash_inputs(rng, dev, CLI_B, CLI_T, H=14, KV=2, Dh=64)
    err = check_flash_fwd(q, k, v, "CosyVoice2 teacher")
    return flash_fwd_entry("CosyVoice2 teacher", q, k, v, launches, err,
                           side)


def cv_stage1_8bit(cfg, dev, record: dict) -> tuple:
    """17e: ``make_stage1_step`` with ``make_optimizer(eight_bit=True)``
    on a fresh full-width model, CV_S1_STEPS steps of B 4, T 4096, A 1
    (K2 and K1 counts exact); the base bit-equal, the old rows their start
    less the 8-bit AdamW's decay, a new row moved, int8 / uint8 moments.
    Then one step of phase 10's standard AdamW from the same start, the
    two optimizer states' bytes and each update's ms on the embedding
    tree [159,488, 1,024]. Returns the model (for 17f)."""
    L = cfg.num_hidden_layers
    model = qwen3.init_params_on_device(SEED, cfg, dev)
    old_vocab = cfg.vocab_size - S1_NEW_TOKENS
    rows = stage1_rows(cfg, old_vocab, CV_S1_STEPS * S1_B,
                       np.random.default_rng(CV_SEED + 3))
    batches = list(stage1_data.stage1_batches(rows, S1_B, 1, SEED, 0))
    fused, backend = stage1_data.fused_route(S1_T, dev, cfg.torch_dtype,
                                             cfg.hidden_size)
    start = model.embed.detach().clone()
    frozen = [p.detach().clone() for p in model.parameters()]
    out = {}
    for name, eight_bit in (("8bit", True), ("standard", False)):
        opt = train_step.make_optimizer(S1_LR, S1_WARMUP, CV_S1_STEPS,
                                        weight_decay=S1_WD,
                                        eight_bit=eight_bit)
        step = train_step.make_stage1_step(cfg, opt, old_vocab,
                                           fused_loss=fused,
                                           fused_backend=backend,
                                           device=dev)
        state = train_step.init_state(
            {"embed": {"weight": start.clone().requires_grad_()}}, opt)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _cuda.reset_launches()
        times, losses, per_step = [], [], []
        for batch in batches[:CV_S1_STEPS if eight_bit else 1]:
            before = dict(_cuda.launches)
            t0 = time.perf_counter()
            state, m = step(state, model, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(m["loss"]))
            per_step.append({k: _cuda.launches[k] - before[k]
                             for k in before if _cuda.launches[k] - before[k]})
        out[name] = {"step_ms": times, "loss": losses,
                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                     "state_bytes": optim8bit.state_bytes(state.opt_state)}
        if eight_bit:
            record["stage1-8bit"] = {"launches": {
                k: v for k, v in _cuda.launches.items() if v}}
            st8, final = state.opt_state, state.trainable["embed"]["weight"]
            want = add_launches(
                {"lm_head_stats": 1, "lm_head_dh": 1, "lm_head_dw": 1,
                 "flash_fwd": 2 * L, "flash_dq": L, "flash_dkv": L},
                train_launches(L))
            if any(p != want for p in per_step):
                fail(f"stage-1 8-bit launches a step {per_step} != {want}")
            if not np.isfinite(losses).all():
                fail(f"stage-1 8-bit losses {losses}")
        # each optimizer's update alone on the embedding tree
        params = {"embed": {"weight": start}}
        g = {"embed": {"weight": torch.randn_like(start) * 1e-3}}
        ost = opt.init(params)
        out[name]["update_ms"] = time_ms(lambda: opt.update(g, ost, params),
                                         iters=OPT_ITERS, warmup=1)
        del state, step, g, ost
    if not all(torch.equal(a, b) for a, b in zip(frozen,
                                                 model.parameters())):
        fail("stage-1 8-bit: the frozen base weights changed")
    moved = int((final[old_vocab:] != start[old_vocab:]).any(1).sum())
    if not moved:
        fail("stage-1 8-bit: no new embedding row moved")
    opt = train_step.make_optimizer(S1_LR, S1_WARMUP, CV_S1_STEPS,
                                    weight_decay=S1_WD, eight_bit=True)
    old = {"w": start[:old_vocab].clone()}
    ost = opt.init(old)
    for _ in range(CV_S1_STEPS):
        ups, ost = opt.update({"w": torch.zeros_like(old["w"])}, ost, old)
        old = train_step.apply_updates(old, ups)
    if not torch.equal(final[:old_vocab], old["w"]):
        fail("stage-1 8-bit: the old rows are not their start less the "
             "8-bit AdamW's decay")
    codes = [t.dtype for t in (st8.mu_q["embed"]["weight"],
                               st8.nu_q["embed"]["weight"])]
    if codes != [torch.int8, torch.uint8]:
        fail(f"stage-1 8-bit moments are {codes}")
    out.update({"moved_new_rows": moved, "moment_dtypes": [str(c) for c in
                                                          codes],
                "phase10_step_ms": RATES.get("stage1_step_ms"),
                "phase10_peak_gib": RATES.get("stage1_peak_gib"),
                "card": record_card()})
    log("cosyvoice2 stage1 8bit " + json.dumps(out) + f" (B {S1_B} T "
        f"{S1_T} A 1; phase 10: A {S1_A}, the standard AdamW; update_ms: "
        f"one optimizer update on the embedding tree "
        f"[{cfg.vocab_size}, {cfg.hidden_size}], events)")
    del frozen, start, final, st8, old, ost
    return model, out


class OptSpy:
    """An optimizer that records the gradients and updates it sees."""

    def __init__(self, opt):
        self.opt, self.calls = opt, []

    def init(self, params):
        return self.opt.init(params)

    def update(self, grads, state, params=None):
        ups, state = self.opt.update(grads, state, params)
        self.calls.append((grads, ups))
        return ups, state


def update_gap(u_ref: torch.Tensor, u: torch.Tensor) -> dict:
    """How far an update ``u`` lies from ``u_ref`` (fp32): for an fp32
    leaf the largest difference over the largest update; for a bf16 leaf
    the share of elements off the reference rounded to bf16, and whether
    each lies within one bf16 ulp of it."""
    if u.dtype == torch.float32:
        return {"rel": float((u - u_ref).abs().max()
                             / u_ref.abs().max().clamp_min(1e-30))}
    r = u_ref.to(u.dtype)
    off = r != u
    ulp = (r.float().abs().clamp_min(2.0 ** -126)
           * 2.0 ** -7)                          # bf16 spacing, upper bound
    within = bool(((u.float() - r.float()).abs() <= ulp)[off].all()) \
        if bool(off.any()) else True
    return {"flipped_share": float(off.float().mean()),
            "within_one_ulp": within}


def cv_fused_optimizer(cfg, model, teacher, dev) -> dict:
    """17f: one KD step (online sparse against the CosyVoice2 teacher,
    gaussian LoRA, B 8, T 512) with ``make_optimizer(fused=True)`` and
    one with the default optimizer, from the same state (moments zero,
    count 1, so the learning rate is 1e-3) and batch; the updates of
    both optimizers on the default step's gradients compared."""
    lcfg = LoraConfig(init_weights="gaussian")
    lora0, base = init_lora(model, cfg, lcfg,
                            generator=torch.Generator().manual_seed(1),
                            device=dev)
    rng = np.random.default_rng(CV_SEED + 4)
    batch = bench_kd_batch(cfg, rng)
    batch["teacher_input_ids"] = cv_unified_ids(teacher.cfg, rng, TRAIN_B,
                                                TRAIN_T)[None]
    batch["teacher_attention_mask"] = batch["attention_mask"]
    dcfg = DistillConfig(top_k=TRAIN_K, lora=lcfg)
    route = dict(teacher_forward=cv2.make_teacher_forward(teacher.cfg),
                 teacher_extract=cv2.make_teacher_extract(
                     teacher.cfg, TRAIN_K, cfg.vocab_size))
    spies, metrics = {}, {}
    for name, kw in (("default", {}), ("fused", {"fused": True})):
        spy = OptSpy(train_step.make_optimizer(1e-3, 1, 10, **kw))
        step = train_step.make_kd_step(cfg, dcfg, spy, mode="online_sparse",
                                       donate=False, device=dev, **route)
        state = train_step.init_state(lora0, spy)
        state = state._replace(opt_state=dict(state.opt_state, count=1))
        _, m = step(state, base, teacher, batch)
        metrics[name] = {k: float(v) for k, v in m.items()}
        spies[name] = spy
    (g_d, u_d), (g_f, _) = spies["default"].calls[0], \
        spies["fused"].calls[0]
    same_grads = all(torch.equal(a, b) for a, b in zip(tree_leaves(g_d),
                                                        tree_leaves(g_f)))
    fused = train_step.make_optimizer(1e-3, 1, 10, fused=True)
    st = dict(fused.init(lora0), count=1)
    u_same, _ = fused.update(g_d, st, lora0)
    gaps = [update_gap(a, b) for a, b in zip(tree_leaves(u_d),
                                              tree_leaves(u_same))]
    out = {"grads_bit_equal": same_grads, "metrics": metrics,
           "max_rel_fp32": max(g["rel"] for g in gaps if "rel" in g),
           "bf16_flipped_share": max([g["flipped_share"] for g in gaps
                                      if "flipped_share" in g] or [0.0]),
           "bf16_within_one_ulp": all(g.get("within_one_ulp", True)
                                      for g in gaps),
           "update_dtypes": sorted({str(u.dtype) for u in
                                    tree_leaves(u_same)})}
    log("cosyvoice2 fused optimizer " + json.dumps(out) + f" (fp32 leaves "
        f"within {FUSED_REL} of the largest update; bf16 leaves: at most "
        f"{FUSED_FLIPS} of the elements one ulp off)")
    if not (out["max_rel_fp32"] <= FUSED_REL
            and out["bf16_flipped_share"] <= FUSED_FLIPS
            and out["bf16_within_one_ulp"]):
        fail(f"the fused optimizer's update is not the default's: {out}")
    del spies, lora0, base
    return out


def cosyvoice2(dev, root: str, side) -> tuple:
    """Phase 17: the CosyVoice2 teacher drawn at full width on the card
    (bf16, from CV_SEED), then 17a-17f. Returns each run's launch counts
    (the train CLI, stage 1 with the 8-bit AdamW) and the K1-fwd entry at
    the teacher's shape."""
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = qwen3_student_0p6b()
    tcfg = cv2.CosyVoice2Config()
    t0 = time.perf_counter()
    teacher = cv2.init_params_on_device(CV_SEED, tcfg, dev)
    torch.cuda.synchronize()
    log(f"cosyvoice2 teacher: Qwen2 backbone hidden "
        f"{tcfg.backbone.hidden_size} layers {tcfg.backbone.num_hidden_layers}"
        f" heads {tcfg.backbone.num_attention_heads}/"
        f"{tcfg.backbone.num_key_value_heads} Dh {tcfg.backbone.head_dim}, "
        f"unified vocab {tcfg.unified_vocab_size}, "
        f"{sum(p.numel() for p in teacher.parameters()) / 1e6:.1f} M "
        f"parameters, {module_bytes(teacher) / 1e9:.3f} GB bf16, drawn on "
        f"the card (seed {CV_SEED}) s={time.perf_counter() - t0:.2f}")
    record: dict = {}
    res = {"train_cli": cv_train_cli(root, teacher, record)}
    res["extract"] = cv_extract_routes(teacher, dev)
    res["model_path"] = cv_model_path(teacher, dev)
    entry = cv_flash(dev, res["train_cli"]["teacher_flash_fwd"], side)
    model, res["stage1_8bit"] = cv_stage1_8bit(cfg, dev, record)
    res["fused_optimizer"] = cv_fused_optimizer(cfg, model, teacher, dev)
    del model, teacher
    gc.collect()
    torch.cuda.empty_cache()
    log(f"cosyvoice2 phase s={time.perf_counter() - t_phase:.2f}")
    return {k: v["launches"] for k, v in record.items()}, entry


# phase 18, dp x tp, pp and sp over torch.distributed: two ranks on the
# one card
PAR_WORLD = 2
# the serve: two short prompts (one batched 128-wide prefill) and two
# fresh long ones (512 and 768 wide: K1-fwd at the ranks' heads)
PAR_LENS, PAR_NEW, PAR_SLOTS = (96, 120, 500, 700), 32, 4
PAR_FLASH_PREFILLS = 2
PAR_STEPS = 2                   # KD steps a layout (B 8, T 512, K 128)
PAR_LORA_SEED = 7               # gaussian LoRA, drawn on the host
# the bf16 tp-2 prefill logits against the fp32 one-process run's: the
# partial sums of the row-parallel products round to bf16 before the
# all-reduce, where one process rounds the whole sum once (2^-9 relative
# a layer), so the tp-2 error may be larger than the one-process bf16
# error, within BF16_ERR_RATIO of it. The step losses and grad norms:
# means over 4,088 positions, against the one-process bf16 step
PAR_LOSS_RTOL, PAR_GRAD_NORM_RTOL = 1e-2, 5e-2
PAR_TIMEOUT_S = 600
# pp 2: the KD steps' batch in 4 microbatches of 2 rows, GPipe
# and interleaved 1F1B (2 chunks of 7 layers a stage); sp 2: zig-zag KD
# steps on rows of 769-1,024 tokens (T 1,024: 512 a rank) and one stage-1
# step of B 1, T 4,096, A 1 (2,048 positions a rank)
PAR_PP_MICRO, PAR_PP_INTERLEAVE = 4, 2
PAR_SP_T = 1024
PAR_S1_ROWS = 1
# the disaggregated teacher: 3 online KD steps (B 8, T 512, K 128, exact
# top-K) with the student on rank 0 and the 1.7B teacher serving from rank
# 1, against the one-process online-sparse steps; the same numbers but
# for summation order (as ONLINE_PRE_RTOL), the grad norms as the other
# runs of the phase
PAR_DISAGG_STEPS = 3
PAR_DISAGG_LOSS_RTOL, PAR_DISAGG_GRAD_NORM_RTOL = 1e-3, 1e-2


# the runs of each rank, and the one-process reference of each step run
PAR_RUNS = ("serve", "serve_fp32", "kd_tp2", "kd_dp2_zero1", "kd_pp2_gpipe",
            "kd_pp2_1f1b_v2", "kd_sp2_zigzag", "stage1_sp2")
PAR_STEP_REFS = {"kd_tp2": "kd", "kd_dp2_zero1": "kd", "kd_pp2_gpipe": "kd",
                 "kd_pp2_1f1b_v2": "kd", "kd_sp2_zigzag": "kd_sp",
                 "stage1_sp2": "stage1"}


def par_prompts(cfg) -> list:
    rng = np.random.default_rng(SEED + 18)
    return [rng.integers(1, cfg.vocab_size - 2, n).tolist()
            for n in PAR_LENS]


def par_sampler(cfg) -> SamplingParams:
    """Greedy to a fixed length: the streams are comparable."""
    return SamplingParams(stop_token_ids=(cfg.eos_token_id,),
                          max_tokens=PAR_NEW, min_tokens=PAR_NEW, top_k=1,
                          temperature=1.0, use_ras=False,
                          repetition_penalty=1.0)


def par_serve(cfg, model, dev, mesh=None) -> dict:
    """The phase's serve on ``model`` (one process, or this rank's tp
    slices): a warm-up, then the prompts with the launch counts set to 0
    just before and read just after."""
    eng = PagedEngine(model, cfg, par_sampler(cfg), slots=PAR_SLOTS,
                      max_len=1024, page_size=128, seed=SEED, device=dev,
                      mesh=mesh)
    prompts = par_prompts(cfg)
    eng.serve([prompts[0][:64]], max_new=4)
    torch.cuda.synchronize()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    out = eng.serve(prompts, max_new=PAR_NEW)
    torch.cuda.synchronize()
    return {"tokens": out, "seconds": time.perf_counter() - t0,
            "decode_steps": eng.n_decode_steps,
            "prefill_forwards": eng.n_prefill_forwards,
            "launches": dict(_cuda.launches)}


def par_prefill_logits(model, cfg, dev) -> np.ndarray:
    """The last position's logits of the longest prompt's first 512 tokens
    (K1-fwd: a cache-less flash-width forward), fp32."""
    ids = torch.tensor([par_prompts(cfg)[-1][:512]], device=dev)
    return qwen3.forward(model, ids)[0, -1].float().cpu().numpy()


def par_kd_batch(cfg) -> dict:
    feats = kd_features(cfg, TRAIN_B, np.random.default_rng(SEED + 19))
    collate = DistillCollator(pad_token_id=cfg.eos_token_id,
                              speech_bos_id=SPEECH_BOS,
                              pad_to_multiple_of=128)
    return {k: v[None] for k, v in collate(feats).items()}


def par_lora(model, cfg, dev):
    return init_lora(model, cfg, LoraConfig(init_weights="gaussian"),
                     torch.Generator().manual_seed(PAR_LORA_SEED),
                     device=dev)


def par_copy(tree):
    from speech_distill_tpu_torch.core.tree import tree_map
    return tree_map(lambda x: x.detach().clone().requires_grad_(True), tree)


def par_kd(cfg, base, lora, batch, dev, mesh=None, zero1=False,
           pp_schedule="gpipe") -> dict:
    """PAR_STEPS precomputed LoRA KD steps on one batch (the trainable
    tree this rank's slices, the batch its dp rows under ``mesh``), the
    launch counts set to 0 just before and read just after."""
    from speech_distill_tpu_torch.parallel import sharding
    opt = train_step.make_optimizer(2e-4, 1, 10)
    state = train_step.init_state(lora, opt)
    if mesh is not None:
        state = state._replace(opt_state=sharding.shard_opt_state(
            mesh, state.opt_state, sharding.trainable_pspecs(
                lora, cfg, True, mesh), zero1=zero1))
        batch = sharding.shard_batch(mesh, batch)
    step = train_step.make_kd_step(cfg, DistillConfig(), opt,
                                   mode="precomputed", device=dev,
                                   mesh=mesh, zero1=zero1,
                                   pp_schedule=pp_schedule)
    torch.cuda.synchronize()
    _cuda.reset_launches()
    times, losses_, norms = [], [], []
    for _ in range(PAR_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, base, None, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses_.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return {"loss": losses_, "grad_norm": norms, "step_ms":
            [t * 1e3 for t in times], "launches": dict(_cuda.launches)}


def par_sp_batch(cfg) -> dict:
    """The zig-zag steps' batch: TRAIN_B rows of 769-1,024 tokens."""
    feats = kd_features(cfg, TRAIN_B, np.random.default_rng(SEED + 20),
                        T=PAR_SP_T)
    collate = DistillCollator(pad_token_id=cfg.eos_token_id,
                              speech_bos_id=SPEECH_BOS,
                              pad_to_multiple_of=128)
    return {k: v[None] for k, v in collate(feats).items()}


def par_stage1(cfg, model, dev, mesh=None) -> dict:
    """One stage-1 step (B 1, T 4,096, A 1, the fused CE through K2) on
    the embedding of ``model``: one process, or this rank's positions on
    ``mesh``'s sp ring (``cfg`` "ring"); launch counts set to 0 just
    before and read just after."""
    from speech_distill_tpu_torch.parallel import sharding
    old_vocab = cfg.vocab_size - S1_NEW_TOKENS
    rows = stage1_rows(cfg, old_vocab, PAR_S1_ROWS,
                       np.random.default_rng(SEED + 21))
    batch = {"input_ids": rows[None], "attention_mask":
             np.ones_like(rows)[None], "labels": rows[None].astype(np.int64)}
    tr = {"embed": {"weight": model.embed.detach().clone()
                    .requires_grad_(True)}}
    opt = train_step.make_optimizer(S1_LR, S1_WARMUP, 10,
                                    weight_decay=S1_WD)
    state = train_step.init_state(tr, opt)
    base = model
    if mesh is not None:
        base = sharding.shard_params(mesh, model, cfg)
        batch = sharding.shard_batch(mesh, batch)
    step = train_step.make_stage1_step(cfg, opt, old_vocab, fused_loss=True,
                                       fused_backend="pallas", device=dev,
                                       mesh=mesh)
    torch.cuda.synchronize()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    state, m = step(state, base, batch)
    torch.cuda.synchronize()
    return {"loss": [float(m["loss"])], "grad_norm": [float(m["grad_norm"])],
            "step_ms": [(time.perf_counter() - t0) * 1e3],
            "launches": dict(_cuda.launches)}


def par_disagg_batches(cfg) -> list:
    """The online steps' batches: bench.py's KD batch, 3 seeds."""
    return [bench_kd_batch(cfg, np.random.default_rng(SEED + 22 + i))
            for i in range(PAR_DISAGG_STEPS)]


def par_online(cfg, model, lora, dev) -> dict:
    """The one-process reference of the disaggregated run: the online
    sparse steps with the teacher in the step, on the same batches."""
    teacher = qwen3.init_params_on_device(TEACHER_SEED,
                                          qwen3_teacher_1p7b(), dev)
    opt = train_step.make_optimizer(2e-4, 1, 10)
    step = train_step.make_kd_step(cfg, DistillConfig(top_k=TRAIN_K), opt,
                                   mode="online_sparse", device=dev)
    state = train_step.init_state(lora, opt)
    torch.cuda.synchronize()
    _cuda.reset_launches()
    times, losses_, norms = [], [], []
    for batch in par_disagg_batches(cfg):
        t0 = time.perf_counter()
        state, m = step(state, model, teacher, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses_.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return {"loss": losses_, "grad_norm": norms, "step_ms": times,
            "launches": dict(_cuda.launches)}


def par_disagg(cfg, full, lora, dev) -> dict:
    """``distill/disaggregate`` on the phase's two ranks: rank 1 draws the
    1.7B teacher and serves its exact top-K (``TeacherService.serve``),
    rank 0 runs the precomputed KD steps on the streamed batches
    (``pipeline_batches``, depth 2). The launch counts are set to 0 just
    before the run on each rank and read just after."""
    from speech_distill_tpu_torch.core.config import MeshConfig
    from speech_distill_tpu_torch.distill import disaggregate
    from speech_distill_tpu_torch.parallel import mesh as meshlib
    ranks = disaggregate.split_devices(1)
    t_mesh = meshlib.make_mesh(MeshConfig(), dev, ranks=ranks[1])
    meshlib.make_mesh(MeshConfig(), dev, ranks=ranks[0])
    teacher = None
    if t_mesh is not None:
        teacher = qwen3.init_params_on_device(TEACHER_SEED,
                                              qwen3_teacher_1p7b(), dev)
    svc = disaggregate.make_teacher_service(
        teacher, None, t_mesh, top_k=TRAIN_K,
        student_vocab_size=cfg.vocab_size, method="exact", depth=2,
        ranks=ranks)
    torch.cuda.synchronize()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    if svc.is_teacher:
        took = svc.serve()
        torch.cuda.synchronize()
        return {"role": "teacher", "extract_ms": [t * 1e3 for t in took],
                "seconds": time.perf_counter() - t0,
                "launches": dict(_cuda.launches)}
    opt = train_step.make_optimizer(2e-4, 1, 10)
    step = train_step.make_kd_step(cfg, DistillConfig(top_k=TRAIN_K), opt,
                                   mode="precomputed", device=dev)
    state = train_step.init_state(par_copy(lora), opt)
    times, losses_, norms = [], [], []
    try:
        for hb in disaggregate.pipeline_batches(
                iter(par_disagg_batches(cfg)), svc):
            t1 = time.perf_counter()
            state, m = step(state, full, None, hb)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
            losses_.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    finally:
        svc.close()                     # the teacher rank returns
    return {"role": "student", "loss": losses_, "grad_norm": norms,
            "step_ms": times, "wait_ms": [w * 1e3 for w in svc.wait_s],
            "seconds": time.perf_counter() - t0,
            "launches": dict(_cuda.launches)}


def par_rank(rank: int, world: int, device: str) -> dict:
    """One rank of phase 18 (a spawned process on the one card, gloo):
    (a) the tp-2 serve in bf16 and in fp32 and the bf16 prefill logits,
    (b) the LoRA KD steps at dp 1 x tp 2 and at dp 2 x tp 1 with ZeRO-1,
    (c) the LoRA KD steps at pp 2, GPipe and interleaved 1F1B, (d) the
    zig-zag KD steps and one stage-1 step at sp 2, (e) the disaggregated
    teacher (:func:`par_disagg`).
    Every rank draws the full-width model on the card from the seed
    (``init_params_on_device``: the same weights in every process) and
    takes its slices (``sharding.shard_params``); the fp32 model is the
    bf16 one upcast."""
    from speech_distill_tpu_torch.core.config import MeshConfig
    from speech_distill_tpu_torch.parallel import mesh as meshlib
    from speech_distill_tpu_torch.parallel import sharding
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    cfg = qwen3_student_0p6b()
    tp2 = meshlib.make_mesh(MeshConfig(dp=1, tp=world), device=dev)
    full = qwen3.init_params_on_device(SEED, cfg, dev)
    out = {"coords": tp2.coords, "backend":
           torch.distributed.get_backend()}
    model = sharding.shard_params(tp2, full, cfg)
    out["serve"] = par_serve(cfg, model, dev, tp2)
    out["prefill_logits"] = par_prefill_logits(model, cfg, dev)
    del model
    f32 = dataclasses.replace(cfg, dtype="float32")
    model = sharding.shard_params(tp2, model_to_tree(full), f32)
    out["serve_fp32"] = par_serve(f32, model, dev, tp2)
    del model
    lora, _ = par_lora(full, cfg, dev)
    batch = par_kd_batch(cfg)
    base = sharding.shard_params(tp2, full, cfg)
    out["kd_tp2"] = par_kd(cfg, base, sharding.shard_lora(tp2, lora), batch,
                           dev, tp2)
    del base
    dp2 = meshlib.make_mesh(MeshConfig(dp=world, tp=1), device=dev)
    out["kd_dp2_zero1"] = par_kd(cfg, sharding.shard_params(dp2, full, cfg),
                                 sharding.shard_lora(dp2, lora), batch, dev,
                                 dp2, zero1=True)
    # pp 2: GPipe, then interleaved 1F1B, each stage holding 14 layers
    pp2 = meshlib.make_mesh(MeshConfig(dp=1, pp=world), device=dev)
    for run, schedule, inter in (("kd_pp2_gpipe", "gpipe", 1),
                                 ("kd_pp2_1f1b_v2", "1f1b",
                                  PAR_PP_INTERLEAVE)):
        pcfg = dataclasses.replace(cfg, pp_microbatches=PAR_PP_MICRO,
                                   pp_interleave=inter)
        base = sharding.shard_params(pp2, full, pcfg)
        out[run] = par_kd(pcfg, base, sharding.shard_lora(pp2, lora, pcfg),
                          batch, dev, pp2, pp_schedule=schedule)
        del base
    # sp 2: the zig-zag ring (the student's attention in plain matmuls,
    # no K1), then stage 1 on the contiguous ring (K2 on 2,048 rows)
    sp2 = meshlib.make_mesh(MeshConfig(dp=1, sp=world), device=dev)
    zcfg = dataclasses.replace(cfg, attn_impl="ring_zigzag")
    out["kd_sp2_zigzag"] = par_kd(zcfg, sharding.shard_params(sp2, full,
                                                              zcfg),
                                  sharding.shard_lora(sp2, lora, zcfg),
                                  par_sp_batch(cfg), dev, sp2)
    out["stage1_sp2"] = par_stage1(dataclasses.replace(cfg,
                                                       attn_impl="ring"),
                                   full, dev, sp2)
    out["kd_disagg"] = par_disagg(cfg, full, lora, dev)
    return out


def parallel(dev, side) -> tuple:
    """Phase 18: the one-process references on the card, then the two
    ranks (``multihost.launch``: spawned, joined through a file store,
    gloo with CUDA tensors staged through the host, NCCL refusing a second
    rank of one device), their results held to the references and the
    kernels at the ranks' shapes to their plain versions. Returns
    (per-rank launch counts by run, the kernels-line entries)."""
    from speech_distill_tpu_torch.parallel import multihost
    t_phase = time.perf_counter()
    cfg = qwen3_student_0p6b()
    L = cfg.num_hidden_layers
    model = qwen3.init_params_on_device(SEED, cfg, dev)
    ref = {"serve": par_serve(cfg, model, dev),
           "prefill_logits": par_prefill_logits(model, cfg, dev)}
    lora, _ = par_lora(model, cfg, dev)
    batch = par_kd_batch(cfg)
    # each run from the same LoRA (a step updates its tree in place)
    ref["kd"] = par_kd(cfg, model, par_copy(lora), batch, dev)
    ref["kd_sp"] = par_kd(cfg, model, par_copy(lora), par_sp_batch(cfg),
                          dev)
    ref["stage1"] = par_stage1(cfg, model, dev)
    ref["kd_disagg"] = par_online(cfg, model, par_copy(lora), dev)
    gc.collect()
    torch.cuda.empty_cache()
    f32 = dataclasses.replace(cfg, dtype="float32")
    tree = model_to_tree(model)
    del model, lora
    model = params_from_jax(tree, f32, dev)
    del tree
    ref["serve_fp32"] = par_serve(f32, model, dev)
    ref["prefill_logits_fp32"] = par_prefill_logits(model, f32, dev)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    t_ref = time.perf_counter() - t_phase

    # NCCL starts on one rank (a group of one): the card's backend
    import torch.distributed as dist
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("nccl", init_method=f"file://{d}/nccl",
                                world_size=1, rank=0)
        one = torch.ones(4, device=dev)
        dist.all_reduce(one)
        torch.cuda.synchronize()
        nccl_ok = bool(torch.all(one == 1))
        dist.destroy_process_group()
    log(f"parallel: NCCL one-rank group all_reduce ok={nccl_ok}; the two "
        f"ranks on one card use gloo (NCCL refuses a device twice), CUDA "
        f"tensors staged through the host")
    if not nccl_ok:
        fail("NCCL one-rank all_reduce")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        try:
            ranks = multihost.launch(par_rank, PAR_WORLD, "cuda:0",
                                     store_dir=d, device="cuda:0",
                                     backend="gloo",
                                     timeout_s=PAR_TIMEOUT_S)
        except RuntimeError as e:
            fail(f"parallel ranks: {e}")
    t_ranks = time.perf_counter() - t0

    counts = {}
    # a pp stage runs its 14 layers on each of the M microbatches, again
    # in the backward's recompute (full remat), and differentiates them;
    # GPipe runs the stack inside forward_train, so every stage runs the
    # final norm on the whole batch a step; 1F1B runs the head on each
    # microbatch on the last stage
    micro = PAR_PP_MICRO * PAR_STEPS
    stage = L // PAR_WORLD * micro
    kd = add_launches({"flash_fwd": 2 * L, "flash_dq": L, "flash_dkv": L},
                      train_launches(L), times=PAR_STEPS)
    for r, res in enumerate(ranks):
        c = {run: res[run]["launches"] for run in PAR_RUNS + ("kd_disagg",)}
        counts[f"rank{r}"] = c
        steps = res["serve"]["decode_steps"]
        pp_k1 = {"flash_fwd": 2 * stage, "flash_dq": stage,
                 "flash_dkv": stage}
        heads = {"gpipe": PAR_STEPS, "1f1b": micro * (r == PAR_WORLD - 1)}
        pp = {sched: add_launches(pp_k1, fused_launches(
                  2 * stage, n, stage, 2 * stage + n))
              for sched, n in heads.items()}
        want = {"serve": add_launches(
                    {"paged_decode": L * steps,
                     "flash_fwd": L * PAR_FLASH_PREFILLS},
                    forward_launches(L, steps
                                     + res["serve"]["prefill_forwards"])),
                "kd_tp2": kd, "kd_dp2_zero1": kd,
                "kd_pp2_gpipe": pp["gpipe"], "kd_pp2_1f1b_v2": pp["1f1b"],
                "kd_sp2_zigzag": add_launches(train_launches(L),
                                              times=PAR_STEPS),
                "stage1_sp2": add_launches(
                    {"lm_head_stats": 1, "lm_head_dh": 1, "lm_head_dw": 1},
                    train_launches(L))}
        for run, w in want.items():
            got = {k: c[run][k] for k in w}
            if got != w:
                fail(f"parallel rank {r} {run}: launches {got} != {w}")
        # fp32 layers take the plain chains
        f32 = {k: c["serve_fp32"][k] for k in FUSED_NAMES
               if c["serve_fp32"][k]}
        if f32:
            fail(f"parallel rank {r} serve_fp32: fused_norm launches {f32}")
        for run in PAR_RUNS[2:]:
            other = {k: v for k, v in c[run].items()
                     if v and k not in want[run]}
            if other:
                fail(f"parallel rank {r} {run}: other kernels {other}")
        if res["serve_fp32"]["launches"]["paged_decode"] != \
                L * res["serve_fp32"]["decode_steps"]:
            fail(f"parallel rank {r}: fp32 serve K4 count")
        # the greedy streams: fp32 equal to the one-process run's; bf16
        # logged (random weights leave near-ties that bf16 rounding flips)
        pre32, pre16 = ([common_prefix(a, b) for a, b in
                         zip(res[run]["tokens"], ref[run]["tokens"])]
                        for run in ("serve_fp32", "serve"))
        log(f"parallel rank {r} coords={res['coords']} backend="
            f"{res['backend']}: greedy common prefix with one process, "
            f"fp32 {pre32} bf16 {pre16} of {PAR_NEW}")
        if res["serve_fp32"]["tokens"] != ref["serve_fp32"]["tokens"]:
            fail(f"parallel rank {r}: fp32 greedy tokens part from the "
                 f"one-process run at {pre32}")
        f32_ = ref["prefill_logits_fp32"]
        e_tp = float(np.abs(res["prefill_logits"] - f32_).max())
        e_one = float(np.abs(ref["prefill_logits"] - f32_).max())
        log(f"parallel rank {r}: bf16 prefill logits max |x - fp32 one "
            f"process|: tp2 {e_tp:.3e}, one process {e_one:.3e} (tp2 within "
            f"{BF16_ERR_RATIO}x; max |fp32| {np.abs(f32_).max():.3e})")
        if not e_tp <= BF16_ERR_RATIO * e_one:
            fail(f"parallel rank {r}: bf16 tp-2 prefill logits {e_tp} "
                 f"against the one-process bf16 {e_one}")
        for run, ref_run in PAR_STEP_REFS.items():
            got, want_ = res[run], ref[ref_run]
            lerr = max(abs(x - y) / abs(y) for x, y in
                       zip(got["loss"], want_["loss"]))
            gerr = max(abs(x - y) / abs(y) for x, y in
                       zip(got["grad_norm"], want_["grad_norm"]))
            log(f"parallel rank {r} {run}: loss {got['loss']} (one process "
                f"{want_['loss']}, rel {lerr:.3e} tol {PAR_LOSS_RTOL}) "
                f"grad_norm rel {gerr:.3e} tol {PAR_GRAD_NORM_RTOL} "
                f"step_ms {got['step_ms']} (one process "
                f"{want_['step_ms']})")
            if not (lerr <= PAR_LOSS_RTOL and gerr <= PAR_GRAD_NORM_RTOL):
                fail(f"parallel rank {r} {run}: loss / grad_norm apart "
                     f"from the one-process run")
    check_par_disagg(ranks, ref, L)
    r0 = ranks[0]
    log("parallel " + json.dumps({
        "world": PAR_WORLD, "device": torch.cuda.get_device_name(0),
        "two_ranks_share_one_card": True,
        "serve_s": {"tp2": [r["serve"]["seconds"] for r in ranks],
                    "one": ref["serve"]["seconds"]},
        "serve_fp32_s": {"tp2": [r["serve_fp32"]["seconds"]
                                 for r in ranks],
                         "one": ref["serve_fp32"]["seconds"]},
        "kd_step_ms": {"tp2": r0["kd_tp2"]["step_ms"],
                       "dp2_zero1": r0["kd_dp2_zero1"]["step_ms"],
                       "pp2_gpipe": r0["kd_pp2_gpipe"]["step_ms"],
                       "pp2_1f1b_v2": r0["kd_pp2_1f1b_v2"]["step_ms"],
                       "one": ref["kd"]["step_ms"]},
        "kd_sp_step_ms": {"sp2_zigzag": r0["kd_sp2_zigzag"]["step_ms"],
                          "one": ref["kd_sp"]["step_ms"]},
        "stage1_step_ms": {"sp2": r0["stage1_sp2"]["step_ms"],
                           "one": ref["stage1"]["step_ms"]},
        "reference_s": t_ref, "ranks_s": t_ranks,
        "launches": counts}))
    entries = par_kernels(dev, side, counts)
    log(f"parallel phase s={time.perf_counter() - t_phase:.2f}")
    return counts, entries


def check_par_disagg(ranks: list, ref: dict, L: int) -> None:
    """The disaggregated run: rank 0 the student, rank 1 the teacher; each
    rank's launches exact (the student's precomputed steps: K1-fwd 2 x 28,
    K1-dq / dkv 28 a step; the teacher's extraction: K1-fwd 28 a batch at
    H 16, KV 8, Dh 128; the layers' elementwise kernels of each),
    nothing else, and the student's losses and grad
    norms held to the one-process online steps."""
    st, te = ranks[0]["kd_disagg"], ranks[1]["kd_disagg"]
    if (st["role"], te["role"]) != ("student", "teacher"):
        fail(f"parallel disaggregated roles {st['role']}, {te['role']}")
    n, Lt = PAR_DISAGG_STEPS, qwen3_teacher_1p7b().num_hidden_layers
    student = add_launches({"flash_fwd": 2 * L, "flash_dq": L,
                            "flash_dkv": L}, train_launches(L),
                           times=n)
    teacher = add_launches({"flash_fwd": Lt}, forward_launches(Lt, 1),
                           times=n)
    for r, got, want in ((0, st, student), (1, te, teacher)):
        have = {k: v for k, v in got["launches"].items() if v}
        if have != want:
            fail(f"parallel disaggregated rank {r}: launches {have} != "
                 f"{want}")
    one = ref["kd_disagg"]
    lerr = rel_gap(st["loss"], one["loss"])
    gerr = rel_gap(st["grad_norm"], one["grad_norm"])
    log("parallel disaggregated " + json.dumps({
        "steps": n, "B": TRAIN_B, "T": TRAIN_T, "K": TRAIN_K,
        "student_rank0": {k: st[k] for k in ("loss", "grad_norm", "step_ms",
                                             "wait_ms", "seconds")},
        "teacher_rank1": {k: te[k] for k in ("extract_ms", "seconds")},
        "one_process_online": {k: one[k] for k in
                               ("loss", "grad_norm", "step_ms",
                                "launches")},
        "loss_rel": lerr, "grad_norm_rel": gerr,
        "tol": [PAR_DISAGG_LOSS_RTOL, PAR_DISAGG_GRAD_NORM_RTOL],
        "note": "two ranks time-slice one card: no overlap is shown"}))
    if not (lerr <= PAR_DISAGG_LOSS_RTOL
            and gerr <= PAR_DISAGG_GRAD_NORM_RTOL):
        fail("parallel disaggregated: loss / grad_norm apart from the "
             "one-process online steps")


def dryrun() -> None:
    """The multi-process dry run (``parallel/multihost_dryrun``) on the
    card: 2 x 2 ranks on cuda:0 over gloo; fails unless every rank
    reports ``MULTIHOST_OK``."""
    from speech_distill_tpu_torch.parallel import multihost_dryrun
    t0 = time.perf_counter()
    try:
        lines = multihost_dryrun.launch(2, 2, device="cuda:0",
                                        backend="gloo", timeout_s=600)
    except RuntimeError as e:
        fail(f"multihost dry run: {e}")
    ok = [x for x in lines if x.startswith(multihost_dryrun.OK_MARK)]
    log(f"multihost dry run: {len(ok)} of 4 ranks {multihost_dryrun.OK_MARK}"
        f" s={time.perf_counter() - t0:.2f}")
    if len(ok) != 4:
        fail(f"multihost dry run: {lines}")


def par_kernels(dev, side, counts: dict) -> list:
    """K4 at the tp-2 pool's KV 4 (G 2), K1-fwd / dq / dkv at the tp-2 KD
    step's H 8, KV 4, and at a pp stage's microbatch (B 2, T 512, H 16,
    KV 8) against their plain versions, timed as at the one-process
    shapes; ``launches`` is rank 0's count in the tp-2 runs, and in the
    two pp runs."""
    r0 = counts["rank0"]
    k4 = k4_check(dev, side, r0["serve"]["paged_decode"], False, KV=4)
    kd = {k: r0["kd_tp2"][k] for k in ("flash_dq", "flash_dkv")}
    kd["flash_fwd"] = r0["kd_tp2"]["flash_fwd"] + r0["serve"]["flash_fwd"]
    rows = check_flash_bwd(dev, kd, side, H=8, KV=4, what="tp2 KD")
    pp = {k: r0["kd_pp2_gpipe"][k] + r0["kd_pp2_1f1b_v2"][k]
          for k in ("flash_fwd", "flash_dq", "flash_dkv")}
    rows += check_flash_bwd(dev, pp, side, what="pp stage microbatch",
                            B=TRAIN_B // PAR_PP_MICRO)
    return [k4] + rows


# the decoder layer's elementwise passes at the two training cells' shapes
# (benchmark/traffic): stage 1's 16 x 4,096 and KD's 32 x 512 tokens; and
# at the serve's (phase 3): a decode step of its 16 slots (T 1) and its
# longest fresh prefill (1,024 wide)
FUSED_SHAPES = (("stage-1", 16, 4096), ("KD", 32, 512), ("decode", 16, 1),
                ("prefill", 1, 1024))
FUSED_HOST_CALLS = 200      # calls a host-cost reading, at 1 token


def fused_norm_kernels(cfg, dev, side) -> list:
    """The one-pass kernels of ``ops/fused_norm`` alone, each timed by
    CUDA-graph replays at :data:`FUSED_SHAPES` beside its byte bound and the
    eager chain the model ran before (the plain forward, and its autograd
    backward: fwd + bwd less fwd); each held against its plain version.
    Then the host microseconds a routed call costs (kernel and eager, at
    one token, device work negligible). Returns the kernels-line
    entries."""
    D, F = cfg.hidden_size, cfg.intermediate_size
    H, KV, Dh = (cfg.num_attention_heads, cfg.num_key_value_heads,
                 cfg.head_dim)
    eps = cfg.rms_norm_eps
    gen = torch.Generator(device="cpu").manual_seed(SEED + 23)

    def draw(*shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen) * scale + shift).to(
            dev, torch.bfloat16)

    def plain_bwd_ms(f, inputs, grads):
        leaves = [t.detach().requires_grad_(True) for t in inputs]
        both = graph_ms(lambda: torch.autograd.grad(
            f(*leaves), leaves, grads), side)
        return max(both - graph_ms(lambda: f(*leaves), side), 0.0)

    entries = []
    for what, B, T in FUSED_SHAPES:
        N = B * T
        x, ln, dy = draw(N, D, scale=2.0), draw(D, shift=1.0), draw(N, D)
        q, k = draw(B, T, H, Dh, scale=3.0), draw(B, T, KV, Dh)
        qs, ks = draw(Dh, shift=1.0), draw(Dh, shift=1.0)
        dqo, dko = draw(B, T, H, Dh), draw(B, T, KV, Dh)
        cos, sin = qwen3.rope_angles(
            torch.arange(T, device=dev)[None].expand(B, T), Dh,
            cfg.rope_theta)
        gate, up, dh = draw(N, F, scale=3.0), draw(N, F), draw(N, F)
        rows = N * (H + KV) * Dh
        cases = {
            "rms_norm": dict(
                fwd=lambda: fused_norm.rms_norm_fwd(x, ln, eps),
                bwd=lambda: fused_norm.rms_norm_bwd(x, ln, eps, dy, False),
                plain=lambda a: fused_norm.rms_norm_plain(a, ln, eps),
                inputs=[x], grads=[dy],
                ref=lambda: (fused_norm.rms_norm_plain(x, ln, eps),
                             fused_norm.rms_norm_bwd_plain(x, ln, eps,
                                                           dy)[0]),
                got=lambda: (fused_norm.rms_norm_fwd(x, ln, eps),
                             fused_norm.rms_norm_bwd(x, ln, eps, dy,
                                                     False)[0]),
                bytes_fwd=4 * N * D, bytes_bwd=6 * N * D,
                shape=[N, D]),
            "qk_norm_rope": dict(
                fwd=lambda: fused_norm.qk_norm_rope_fwd(q, k, cos, sin, qs,
                                                        ks, eps),
                bwd=lambda: fused_norm.qk_norm_rope_bwd(
                    q, k, cos, sin, qs, ks, eps, dqo, dko, False),
                plain=lambda a, b: fused_norm.qk_norm_rope_plain(
                    a, b, cos, sin, qs, ks, eps),
                inputs=[q, k], grads=[dqo, dko],
                ref=lambda: (*fused_norm.qk_norm_rope_plain(
                    q, k, cos, sin, qs, ks, eps),
                    *fused_norm.qk_norm_rope_bwd_plain(
                        q, k, cos, sin, qs, ks, eps, dqo, dko)[:2]),
                got=lambda: (*fused_norm.qk_norm_rope_fwd(
                    q, k, cos, sin, qs, ks, eps),
                    *fused_norm.qk_norm_rope_bwd(
                        q, k, cos, sin, qs, ks, eps, dqo, dko, False)[:2]),
                bytes_fwd=4 * rows + 8 * N * Dh,
                bytes_bwd=6 * rows + 8 * N * Dh,
                shape=[B, T, H, KV, Dh]),
            "swiglu": dict(
                fwd=lambda: fused_norm.swiglu_fwd(gate, up),
                bwd=lambda: fused_norm.swiglu_bwd(gate, up, dh),
                plain=fused_norm.swiglu_plain,
                inputs=[gate, up], grads=[dh],
                ref=lambda: (fused_norm.swiglu_plain(gate, up),
                             *fused_norm.swiglu_bwd_plain(gate, up, dh)),
                got=lambda: (fused_norm.swiglu_fwd(gate, up),
                             *fused_norm.swiglu_bwd(gate, up, dh)),
                bytes_fwd=6 * N * F, bytes_bwd=10 * N * F,
                shape=[N, F]),
        }
        for name, c in cases.items():
            got, ref = c["got"](), c["ref"]()
            torch.cuda.synchronize()
            err = max(((a.float() - b.float()).abs().max()
                       / b.float().abs().max()).item()
                      for a, b in zip(got, ref))
            if not err <= FUSED_REL_TOL:
                fail(f"{name} kernels disagree with their plain versions at "
                     f"the {what} shape: {err}")
            del got, ref
            plain_fwd = graph_ms(lambda: c["plain"](*c["inputs"]), side)
            plain_bwd = plain_bwd_ms(c["plain"], c["inputs"], c["grads"])
            for d in ("fwd", "bwd"):
                ms = graph_ms(c[d], side)
                bound_ms = c[f"bytes_{d}"] / HBM_BYTES_PER_S * 1e3
                plain_ms = plain_fwd if d == "fwd" else plain_bwd
                log(f"{name}_{d} at the {what} shape {c['shape']}: "
                    f"ms={ms:.4f} bound_ms={bound_ms:.4f} (bytes; "
                    f"{100 * bound_ms / ms:.1f}% of it) plain_ms="
                    f"{plain_ms:.4f} (eager; x{plain_ms / ms:.1f}) "
                    f"rel_err={err:.2e} (graph replays)")
                entries.append({
                    "name": f"{name}_{d}", "route": "cuda",
                    "source": "speech_distill_tpu_torch/csrc/fused_norm.cu",
                    "replaces": "speech_distill_tpu_torch/models/qwen3.py "
                                "eager chain (no Pallas kernel)",
                    "path": what, "shape": c["shape"], "ms": ms,
                    "kernel_ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": "bytes",
                    "rel_err": err, "timing": "graph"})
        del x, dy, q, k, dqo, dko, gate, up, dh, cases
        torch.cuda.empty_cache()
    # host cost of a routed call at one token: the kernel's wrapper and
    # Function against the eager chain's launches
    x1, q1, k1 = draw(1, 1, D), draw(1, 1, H, Dh), draw(1, 1, KV, Dh)
    g1, u1 = draw(1, 1, F), draw(1, 1, F)
    c1, s1 = qwen3.rope_angles(torch.zeros(1, 1, device=dev), Dh,
                               cfg.rope_theta)
    calls = {
        "rms_norm": (lambda: fused_norm.rms_norm(x1, ln, eps),
                     lambda: fused_norm.rms_norm_plain(x1, ln, eps)),
        "qk_norm_rope": (
            lambda: fused_norm.qk_norm_rope(q1, k1, c1, s1, qs, ks, eps),
            lambda: fused_norm.qk_norm_rope_plain(q1, k1, c1, s1, qs, ks,
                                                  eps)),
        "swiglu": (lambda: fused_norm.swiglu(g1, u1),
                   lambda: fused_norm.swiglu_plain(g1, u1)),
    }
    host = {}
    for name, fns in calls.items():
        us = []
        for f in fns:
            f()
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(FUSED_HOST_CALLS):
                f()
            us.append((time.perf_counter() - t) / FUSED_HOST_CALLS * 1e6)
            torch.cuda.synchronize()
        host[name] = {"kernel_us": us[0], "eager_us": us[1]}
    log(f"fused_norm host us a call (1 token): {json.dumps(host)}")
    return entries


def main() -> None:
    if not torch.cuda.is_available():
        fail("CUDA is not available: this smoke runs on the GPU only")
    # fp32 products in full fp32 on the card (the plain versions are the
    # references); cuDNN's TF32 default is turned off as well
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_all = time.perf_counter()
    record_card()
    build_kernels()

    cfg = qwen3_student_0p6b()
    t0 = time.perf_counter()
    model = qwen3.init_params(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    log(f"model qwen3_student_0p6b hidden={cfg.hidden_size} layers="
        f"{cfg.num_hidden_layers} heads={cfg.num_attention_heads}/"
        f"{cfg.num_key_value_heads} vocab={cfg.vocab_size} bf16 random "
        f"init seed={SEED} s={time.perf_counter() - t0:.2f}")
    counts = serve(cfg, model)
    t0 = time.perf_counter()
    feature_counts = serve_features(cfg, model, dev)
    log(f"feature serve phase s={time.perf_counter() - t0:.2f}")
    tts_counts = tts_serve(cfg, model, dev)
    engine_counts = decode_engines(cfg, model, dev)
    log(f"device memory allocated after the bf16 serves "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")

    side = torch.cuda.Stream()          # warm-ups of every graph timing
    kernels = [k4_check(dev, side, counts["paged_decode"], False),
               check_flash_serve(dev, counts["flash_fwd"], side)]
    for entry in kernels:   # launches in phases 3b-3d beside phase 3's
        entry["feature_serve_launches"] = feature_counts[entry["name"]]
        entry["tts_serve_launches"] = tts_counts[entry["name"]]
        entry["decode_engines_launches"] = engine_counts.get(entry["name"],
                                                             0)
    check_model_path(cfg, model, dev)
    t0 = time.perf_counter()
    qmodel, qcounts = serve_quant(cfg, model, dev)
    kernels += [check_int4_matmul(dev, qmodel, qcounts["int4_matmul"]),
                k4_check(dev, side, qcounts["paged_decode_int8"], True)]
    check_quant_model_path(cfg, qmodel, dev)
    del qmodel
    log(f"quantized serving phases s={time.perf_counter() - t0:.2f}, "
        f"device memory still allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    kernels += fused_norm_kernels(cfg, dev, side)
    t0 = time.perf_counter()
    train_counts, lora, base = train(cfg, model, dev)
    kernels += check_flash_bwd(dev, train_counts, side)
    check_grad_path(cfg, model, lora, dev)
    check_fused_kd(cfg, base, lora, dev)
    remat_counts = remat_policies(cfg, base, lora, dev)
    del lora, base, model
    log(f"train phases s={time.perf_counter() - t0:.2f}")
    online_counts = online_kd(cfg, dev)
    for entry in kernels:   # K1 at the KD shape: phase 9b's step loops
        if entry.get("path") == "KD":   # and the remat policies' steps
            entry["online_kd_launches"] = online_counts.get(entry["name"],
                                                            0)
            entry["remat_launches"] = {run: c.get(entry["name"], 0)
                                       for run, c in remat_counts.items()}
    t0 = time.perf_counter()
    s1_counts, model, rows = stage1(cfg, dev)
    kernels += check_lm_head(dev, model, s1_counts, side)
    check_stage1_grad_path(cfg, model, rows, dev)
    del model
    kernels += check_flash_stage1(dev, s1_counts, side)
    log(f"stage1 phases s={time.perf_counter() - t0:.2f}")
    cli_counts, cli_dir = cli(dev)
    cv_counts, cv_entry = cosyvoice2(dev, cli_dir.name, side)
    cli_dir.cleanup()
    kernels.append(cv_entry)
    for entry in kernels:   # each CLI's launches of the kernel in phase 15
        entry["cli_launches"] = {name: c.get(entry["name"], 0)
                                 for name, c in cli_counts.items()}
        # and in phase 17's runs
        entry["cosyvoice2_launches"] = {name: c.get(entry["name"], 0)
                                        for name, c in cv_counts.items()}
    synth_counts = synthesis(dev)
    for entry in kernels:   # each synthesize run's launches in phase 16
        entry["synthesize_launches"] = {run: c.get(entry["name"], 0)
                                        for run, c in synth_counts.items()}
    par_counts, par_entries = parallel(dev, side)
    kernels += par_entries
    dryrun()
    for entry in kernels:   # each rank's launches in phase 18's runs
        entry["parallel_launches"] = {
            rank: {run: c.get(entry["name"], 0) for run, c in runs.items()}
            for rank, runs in par_counts.items()}
    log(f"total s={time.perf_counter() - t_all:.2f}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
