"""Configuration for the PyTorch port: the Qwen3 decoder, the sampler, the
TTS engine, and the LoRA and distillation knobs of the KD training step.

Own copy of the fields the port reads from
``speech_distill_tpu/core/config.py`` (the port imports nothing of the JAX
package). Values and defaults are the same, so a config built on one side
describes the same model on the other.
"""
from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field, fields
from typing import Any, Dict, Optional, Union

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def parse_prefix(prefix_str: Optional[str]) -> Union[str, Dict[str, str]]:
    """A CLI prefix flag: a JSON dict string becomes the dict, anything
    else stays the literal string ("" for an empty flag)."""
    if not prefix_str:
        return ""
    try:
        return json.loads(prefix_str)
    except json.JSONDecodeError:
        return prefix_str


def torch_dtype(name: str) -> torch.dtype:
    """Map a config dtype string ("bfloat16", "float32", ...) to torch."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}") from None


def _overlay(cls, *sources: Dict[str, Any]):
    """A dataclass from dicts: later sources win, unknown keys dropped."""
    merged: Dict[str, Any] = {}
    for src in sources:
        if src:
            merged.update(src)
    valid = {f.name for f in fields(cls)}
    return cls(**{k: v for k, v in merged.items() if k in valid})


class _JsonOverlayMixin:
    @classmethod
    def from_initial_and_json(cls, initial_values: Optional[Dict[str, Any]]
                              = None, json_file: Optional[str] = None):
        """The JSON file's values (when the file exists), overlaid by
        ``initial_values``; keys the dataclass lacks are dropped."""
        file_data: Dict[str, Any] = {}
        if json_file and os.path.exists(json_file):
            with open(json_file, "r", encoding="utf-8") as f:
                file_data = json.load(f)
        return _overlay(cls, file_data, initial_values or {})

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclass
class Qwen3Config(_JsonOverlayMixin):
    """Qwen3 decoder (GQA, per-head q/k RMSNorm, NeoX RoPE, SwiGLU).
    Defaults = the SoulX-Podcast-1.7B-dialect teacher. A Qwen2-family
    backbone sets ``attention_bias`` and clears ``qk_norm``."""

    vocab_size: int = 159488
    hidden_size: int = 2048
    intermediate_size: int = 6144
    num_hidden_layers: int = 28
    num_attention_heads: int = 16
    num_key_value_heads: int = 8
    head_dim: int = 128
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1_000_000.0
    max_position_embeddings: int = 40_960
    tie_word_embeddings: bool = True
    attention_bias: bool = False       # True for Qwen2-family backbones
    qk_norm: bool = True               # False for Qwen2-family backbones
    bos_token_id: int = 151643
    eos_token_id: int = 151675         # speech eos
    speech_token_offset: int = 152927  # first semantic speech token id
    dtype: str = "bfloat16"
    logits_dtype: str = "float32"
    # training forward: activation checkpointing of each layer; only the
    # "full" policy (recompute the whole layer in the backward) is ported
    remat: bool = True
    remat_policy: str = "full"
    # auto: the flash kernel where it applies (ops/attention.use_flash);
    # xla: the plain route; pallas: the kernel route, raising where the
    # kernel cannot take the input; ring / ring_zigzag: ring attention
    # over the mesh's sp axis (ops/ring_attention; the JAX names)
    attn_impl: str = "auto"
    # > 0: pipeline the layer stack over the mesh's pp axis in this many
    # microbatches (parallel/pipeline)
    pp_microbatches: int = 0
    # > 1: virtual stages a pp rank (interleaved 1F1B only)
    pp_interleave: int = 1
    # dtype of the lm-head cotangent in the unfused head's backward
    head_bwd_dtype: str = "float32"

    @property
    def q_dim(self) -> int:
        return self.num_attention_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_key_value_heads * self.head_dim

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def torch_logits_dtype(self) -> torch.dtype:
        return torch_dtype(self.logits_dtype)


def qwen2_cosyvoice_backbone(vocab_size: int = 151936) -> Qwen3Config:
    """CosyVoice2's Qwen2-0.5B backbone: hidden 896, FFN 4864, 24 layers,
    14 / 2 heads of 64, tied, q/k/v bias, no q/k norm."""
    return Qwen3Config(
        vocab_size=vocab_size,
        hidden_size=896,
        intermediate_size=4864,
        num_hidden_layers=24,
        num_attention_heads=14,
        num_key_value_heads=2,
        head_dim=64,
        rope_theta=1_000_000.0,
        attention_bias=True,
        qk_norm=False,
        tie_word_embeddings=True,
        max_position_embeddings=32768,
    )


def qwen3_teacher_1p7b() -> Qwen3Config:
    """The SoulX-Podcast-1.7B-dialect teacher: the :class:`Qwen3Config`
    defaults (hidden 2048, FFN 6144, 28 layers, 16 / 8 heads, tied)."""
    return Qwen3Config()


def qwen3_student_0p6b(vocab_size: int = 159488) -> Qwen3Config:
    """Qwen3-0.6B after the speech-vocab expansion."""
    return Qwen3Config(
        vocab_size=vocab_size,
        hidden_size=1024,
        intermediate_size=3072,
        num_hidden_layers=28,
        num_attention_heads=16,
        num_key_value_heads=8,
        head_dim=128,
        tie_word_embeddings=True,
    )


def qwen3_tiny(vocab_size: int = 512, **kw) -> Qwen3Config:
    """Tiny config for tests."""
    base = dict(
        vocab_size=vocab_size,
        hidden_size=64,
        intermediate_size=128,
        num_hidden_layers=2,
        num_attention_heads=4,
        num_key_value_heads=2,
        head_dim=16,
        max_position_embeddings=512,
        speech_token_offset=vocab_size // 2,
        eos_token_id=vocab_size - 1,
    )
    base.update(kw)
    return Qwen3Config(**base)


@dataclass
class LoraConfig:
    """LoRA knobs (defaults: r 32, alpha 64, rsLoRA, PiSSA init, all seven
    projections, embed and lm-head copies trained). ``use_lora`` False is
    full finetuning."""

    use_lora: bool = True
    r: int = 32
    alpha: int = 64
    use_rslora: bool = True
    init_weights: str = "pissa"        # pissa | gaussian | default
    target_modules: tuple = (
        "q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
        "down_proj")
    # full-rank trained alongside LoRA because of the new vocab rows
    modules_to_save: tuple = ("embed_tokens", "lm_head")


TEACHER_QUANTS = ("none", "int8", "int4", "nf4")


@dataclass
class DistillConfig:
    """Stage-2 KD knobs of the training step and the train CLI (the
    reference's defaults).

    ``online_topk_method``: "exact" or "approx". JAX's "approx" is the
    TPU's ``lax.approx_max_k`` (``online_topk_recall`` its recall target),
    which the port has no counterpart of: both take the exact top-K.
    ``online_extract``: "materialized" (the teacher's fp32 logits, then the
    top-K) or "fused" (``ops/fused_lm_loss.fused_extract_top_k`` over vocab
    chunks). ``teacher_quant``: "none", "int8" or "nf4" ("int4" is nf4, as
    in JAX); a quantized teacher forces dense distillation."""

    temperature: float = 2.0
    alpha: float = 0.5
    top_k: int = 128                   # <= 0: dense distillation
    online_topk_method: str = "approx"  # exact | approx (both exact here)
    online_topk_recall: float = 0.95
    online_extract: str = "materialized"  # materialized | fused
    teacher_quant: str = "none"        # none | int8 | int4 == nf4
    learning_rate: float = 5e-5
    num_train_epochs: int = 3
    warmup_steps: int = 1000
    per_device_batch_size: int = 4
    gradient_accumulation_steps: int = 4
    logging_steps: int = 10
    save_total_limit: int = 3
    seed: int = 42
    pad_to_multiple_of: int = 128
    # 0: a whole-epoch shuffle (an exact permutation); > 0: a windowed
    # shuffle buffer of that many rows
    shuffle_buffer_size: int = 0
    lora: LoraConfig = field(default_factory=LoraConfig)

    @property
    def use_dense(self) -> bool:
        """Dense KD: no top-K, or a quantized teacher."""
        return self.top_k <= 0 or self.teacher_quant != "none"


@dataclass
class SamplingParams(_JsonOverlayMixin):
    """Decode sampling params (HF generate processors + VALL-E 2 RAS).

    ``topk_method``: "exact" or "approx". JAX's "approx" is the TPU's
    ``lax.approx_max_k``, which the port has no counterpart of: both map
    to the exact top-k (``ops/sampling.top_k_top_p``)."""

    temperature: float = 0.6
    repetition_penalty: float = 1.25
    top_k: int = 100
    top_p: float = 0.9
    min_tokens: int = 8
    max_tokens: int = 3000
    stop_token_ids: tuple = (151675,)
    use_ras: bool = True
    win_size: int = 25
    tau_r: float = 0.2
    topk_method: str = "exact"         # exact | approx (both exact here)


@dataclass
class EngineConfig(_JsonOverlayMixin):
    """The TTS engine (reference soulxpodcast/config.py:121-142): the
    context bound and the long-form eviction policy's sizes.
    ``max_model_len`` is clipped to the model's
    ``max_position_embeddings``."""

    model: str = ""
    max_model_len: int = 8192
    max_turn_size: int = 10
    turn_tokens_threshold: int = 6192
    prompt_context: int = 2
    history_context: int = 2
    history_text_context: int = 2
    llm: Qwen3Config = field(default_factory=Qwen3Config)
    sampling: SamplingParams = field(default_factory=SamplingParams)

    def __post_init__(self):
        self.max_model_len = min(self.max_model_len,
                                 self.llm.max_position_embeddings)


@dataclass
class MeshConfig:
    """Device-mesh layout (the JAX ``MeshConfig``): dp x pp x sp x tp
    ranks, one process a device. ``dp=-1`` takes the ranks that remain."""

    dp: int = -1                       # -1: all remaining devices
    pp: int = 1                        # pipeline parallel (layer stages)
    sp: int = 1                        # sequence/context parallel (ring attn)
    tp: int = 1
    # activation sequence sharding axis rides on tp when enabled
    shard_sequence: bool = False
