"""HF checkpoint import and export for the Qwen3 port (port of
``speech_distill_tpu/models/hf_loader.py``).

HF ``Qwen3ForCausalLM`` and ``Qwen2ForCausalLM`` checkpoints
(safetensors, or torch ``.bin`` state dicts) load into a
:class:`~speech_distill_tpu_torch.models.qwen3.Qwen3` on a device, and a
JAX-shaped tree (``convert.model_to_tree``, ``lora.merge_and_export``,
``train_step.full_trainable``) goes back out under HF names for
``core/checkpoint.export_hf``. HF Linear weights are [dout, din]; the
port's are [din, dout], so matrices are transposed on the way in and out.
A Qwen2 backbone (CosyVoice2's) has q/k/v biases and no q/k norms.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from speech_distill_tpu_torch.core.config import Qwen3Config
from speech_distill_tpu_torch.models.qwen3 import Qwen3, attn_names

# port layer tree (group, key) -> HF name inside a layer; matrices
# transpose, the rest copy as they are
_MATRICES = {("attn", "q"): "self_attn.q_proj.weight",
             ("attn", "k"): "self_attn.k_proj.weight",
             ("attn", "v"): "self_attn.v_proj.weight",
             ("attn", "o"): "self_attn.o_proj.weight",
             ("mlp", "gate"): "mlp.gate_proj.weight",
             ("mlp", "up"): "mlp.up_proj.weight",
             ("mlp", "down"): "mlp.down_proj.weight"}
_VECTORS = {("input_ln", "scale"): "input_layernorm.weight",
            ("attn", "q_norm"): "self_attn.q_norm.weight",
            ("attn", "k_norm"): "self_attn.k_norm.weight",
            ("attn", "q_bias"): "self_attn.q_proj.bias",
            ("attn", "k_bias"): "self_attn.k_proj.bias",
            ("attn", "v_bias"): "self_attn.v_proj.bias",
            ("post_ln", "scale"): "post_attention_layernorm.weight"}


def _vectors(cfg: Qwen3Config):
    """The vector leaves the config has, with their HF names."""
    names = attn_names(cfg)
    return {gk: n for gk, n in _VECTORS.items()
            if gk[0] != "attn" or gk[1] in names}


def config_from_hf(hf_cfg) -> Qwen3Config:
    """A :class:`Qwen3Config` from a transformers config object or dict.
    Never reads a dtype: the model runs in the config's default (bf16).
    A ``qwen2`` ``model_type`` has no q/k norm and, unless the config says
    otherwise, q/k/v biases."""
    get = (hf_cfg.get if isinstance(hf_cfg, dict)
           else lambda k, d=None: getattr(hf_cfg, k, d))
    is_qwen2 = get("model_type", "qwen3") == "qwen2"
    return Qwen3Config(
        attention_bias=get("attention_bias", is_qwen2),
        qk_norm=not is_qwen2,
        vocab_size=get("vocab_size"),
        hidden_size=get("hidden_size"),
        intermediate_size=get("intermediate_size"),
        num_hidden_layers=get("num_hidden_layers"),
        num_attention_heads=get("num_attention_heads"),
        num_key_value_heads=get("num_key_value_heads"),
        head_dim=get("head_dim",
                     get("hidden_size") // get("num_attention_heads")),
        rms_norm_eps=get("rms_norm_eps", 1e-6),
        rope_theta=get("rope_theta", 1e6),
        max_position_embeddings=get("max_position_embeddings", 40960),
        tie_word_embeddings=get("tie_word_embeddings", True),
    )


def _tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach()
    return torch.from_numpy(np.require(np.asarray(a, np.float32),
                                       requirements=["C", "W"]))


@torch.no_grad()
def from_state_dict(state: Dict[str, Any], cfg: Qwen3Config,
                    dtype: Optional[str] = None, device="cuda") -> Qwen3:
    """A :class:`Qwen3` on ``device`` (CUDA by default; raises without it)
    holding an HF Qwen3ForCausalLM (or, for a Qwen2 config,
    Qwen2ForCausalLM) state dict (tensors or arrays, names
    with or without the ``model.`` prefix), cast to ``dtype`` (default
    ``cfg.dtype``; the model's config carries it)."""
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    model = Qwen3(cfg, device)

    def get(name):
        key = name if name in state else f"model.{name}"
        if key not in state:
            raise KeyError(f"missing weight: {name}")
        return _tensor(state[key])

    model.embed.copy_(get("embed_tokens.weight"))
    model.final_ln.copy_(get("norm.weight"))
    if model.lm_head is not None:
        model.lm_head.copy_(get("lm_head.weight"))
    for i, layer in enumerate(model.layers):
        for (group, key), name in _MATRICES.items():
            getattr(getattr(layer, group), key).copy_(
                get(f"layers.{i}.{name}").T)
        for (group, key), name in _vectors(cfg).items():
            dst = getattr(layer, group)
            dst = getattr(dst, key) if key != "scale" else dst
            dst.copy_(get(f"layers.{i}.{name}"))
    return model


def _np32(a, transpose: bool = False) -> np.ndarray:
    """A C-contiguous fp32 numpy copy of a tensor or array (transposed
    first, on its device, when asked): safetensors writes the raw buffer,
    so a transposed view would round-trip as transposed data."""
    if isinstance(a, torch.Tensor):
        t = a.detach().float()
        t = t.T if transpose else t
        return t.contiguous().cpu().numpy()
    a = np.asarray(a, np.float32)
    return np.ascontiguousarray(a.T if transpose else a)


def to_state_dict(params: Dict[str, Any], cfg: Qwen3Config
                  ) -> Dict[str, np.ndarray]:
    """A JAX-shaped tree of stacked [L, ...] leaves (tensors or arrays) as
    an HF Qwen3 (Qwen2) state dict of C-contiguous fp32 numpy arrays: the
    q/k norms and the q/k/v biases go out where the tree has them."""
    out: Dict[str, np.ndarray] = {
        "model.embed_tokens.weight": _np32(params["embed"]["weight"])}
    lyr = params["layers"]
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}"
        for (group, key), name in _VECTORS.items():
            if key in lyr[group]:
                out[f"{p}.{name}"] = _np32(lyr[group][key][i])
        for (group, key), name in _MATRICES.items():
            out[f"{p}.{name}"] = _np32(lyr[group][key][i], transpose=True)
    out["model.norm.weight"] = _np32(params["final_ln"]["scale"])
    if "lm_head" in params:
        out["lm_head.weight"] = _np32(params["lm_head"]["weight"])
    return out


def read_state_dict(path: str) -> Dict[str, Any]:
    """Every tensor of an HF model directory: its ``*.safetensors`` files
    read as torch tensors in their stored dtype (bf16 files included), or,
    where safetensors is not installed, its ``*.bin`` torch state dicts."""
    state: Dict[str, Any] = {}
    try:
        from safetensors import safe_open
        files = sorted(f for f in os.listdir(path)
                       if f.endswith(".safetensors"))
        for fn in files:
            with safe_open(os.path.join(path, fn), framework="pt") as sf:
                for k in sf.keys():
                    state[k] = sf.get_tensor(k)
    except ImportError:
        files = sorted(f for f in os.listdir(path) if f.endswith(".bin"))
        for fn in files:
            state.update(torch.load(os.path.join(path, fn),
                                    map_location="cpu", weights_only=True))
    if not state:
        raise FileNotFoundError(f"no weights found under {path}")
    return state


def load_pretrained(path: str, dtype: Optional[str] = None,
                    device="cuda") -> Tuple[Qwen3Config, Qwen3]:
    """(config, model) of an HF model directory, the model on ``device``
    (CUDA by default; raises without it) in ``dtype`` (default the
    config's, bf16; ``config.json``'s dtype is never read). The returned
    config is the model's own."""
    with open(os.path.join(path, "config.json")) as f:
        cfg = config_from_hf(json.load(f))
    model = from_state_dict(read_state_dict(path), cfg, dtype, device)
    return model.cfg, model
