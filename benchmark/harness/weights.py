"""Random weights of a Qwen3-layout decoder from a seed, drawn on the
device in one call.

Every matrix is normal(0, 0.02) and every norm scale one, as the JAX
package initialises them. The matrices are views of one flat buffer
filled by a single ``normal_`` from a ``torch.Generator`` seeded with the
run's seed, in the order of :func:`matrix_shapes`; the same seed on the
same device type gives the same weights. The program and the reference
both take their weights from here, each its own copy.
"""
from __future__ import annotations

from typing import Dict, List, Tuple


def matrix_shapes(cfg: dict) -> List[Tuple[str, tuple]]:
    """(name, shape) of every random matrix, stacked over the layers."""
    L, D, F = (cfg["num_hidden_layers"], cfg["hidden_size"],
               cfg["intermediate_size"])
    Dh = cfg["head_dim"]
    QD, KVD = cfg["num_attention_heads"] * Dh, cfg["num_key_value_heads"] * Dh
    V = cfg["vocab_size"]
    out = [("embed", (V, D)),
           ("attn.q", (L, D, QD)), ("attn.k", (L, D, KVD)),
           ("attn.v", (L, D, KVD)), ("attn.o", (L, QD, D)),
           ("mlp.gate", (L, D, F)), ("mlp.up", (L, D, F)),
           ("mlp.down", (L, F, D))]
    if not cfg.get("tie_word_embeddings", True):
        out.append(("lm_head", (V, D)))
    return out


def draw(cfg: dict, seed: int, device, dtype) -> Dict[str, "object"]:
    """{name: tensor} of :func:`matrix_shapes`, views of one buffer."""
    import math

    import torch
    shapes = matrix_shapes(cfg)
    total = sum(math.prod(s) for _, s in shapes)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.empty(total, dtype=dtype, device=device)
    flat.normal_(0.0, 0.02, generator=gen)
    out, at = {}, 0
    for name, shape in shapes:
        n = math.prod(shape)
        out[name] = flat[at:at + n].view(shape)
        at += n
    return out


def load_program_model(cfg_obj, cfg: dict, seed: int, device):
    """The program's ``Qwen3`` filled from :func:`draw`: matrices copied in
    (the program owns its tensors), norm scales one, biases zero."""
    import torch

    from speech_distill_tpu_torch.models import qwen3
    model = qwen3.Qwen3(cfg_obj, device)
    w = draw(cfg, seed, model.device, cfg_obj.torch_dtype)
    with torch.no_grad():
        model.embed.copy_(w["embed"])
        if model.lm_head is not None:
            model.lm_head.copy_(w["lm_head"])
        model.final_ln.fill_(1.0)
        for i, layer in enumerate(model.layers):
            for key in ("q", "k", "v", "o"):
                getattr(layer.attn, key).copy_(w["attn." + key][i])
            for key in ("gate", "up", "down"):
                getattr(layer.mlp, key).copy_(w["mlp." + key][i])
            layer.input_ln.fill_(1.0)
            layer.post_ln.fill_(1.0)
            for name in ("q_norm", "k_norm"):
                if hasattr(layer.attn, name):
                    getattr(layer.attn, name).fill_(1.0)
            for name in ("q_bias", "k_bias", "v_bias"):
                if hasattr(layer.attn, name):
                    getattr(layer.attn, name).zero_()
    del w
    return model
