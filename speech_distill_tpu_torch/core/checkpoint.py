"""Checkpoints of the training state and the HF export (port of
``speech_distill_tpu/core/checkpoint.py``).

Orbax becomes ``torch.save``/``torch.load``: one file ``<step>.pt`` per
saved step under the directory, holding the state's tensors, optimizer
moments and counters as plain containers (so ``torch.load`` runs with
``weights_only=True``), and the newest ``max_to_keep`` files kept. Saves
are synchronous, so :meth:`CheckpointManager.wait` has nothing to wait
for. :func:`export_hf` writes an HF model directory from a plain (merged)
weight tree, the file the JAX package writes.

In a multi-process run (``mesh`` with ``specs_fn``) the ranks' slices are
gathered and rank 0 writes the one-device format, so a run saved at one
mesh layout resumes at another; on restore every rank reads the file and
keeps its slices.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Optional

import torch

_NAME = re.compile(r"^(\d+)\.pt$")


def _to_plain(obj: Any) -> Any:
    """NamedTuples become dicts tagged with their field names."""
    if hasattr(obj, "_fields"):
        return {"__fields__": list(obj._fields),
                "values": [_to_plain(v) for v in obj]}
    if isinstance(obj, dict):
        return {k: _to_plain(v) for k, v in obj.items()}
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    return obj


def _restore_like(template: Any, saved: Any, specs: Any = None,
                  mesh=None) -> Any:
    """``saved`` in the structure, types, devices and dtypes of
    ``template`` (tensors that required grad require it again); with
    ``specs`` (a tree like ``template``, None for whole leaves) each
    sharded tensor is cut to ``mesh``'s slice first."""
    if hasattr(template, "_fields"):
        sp = specs if specs is not None else [None] * len(template)
        return type(template)(*(_restore_like(t, s, p, mesh) for t, s, p in
                                zip(template, saved["values"], sp)))
    if isinstance(template, dict):
        return {k: _restore_like(template[k], saved[k],
                                 specs[k] if isinstance(specs, dict)
                                 else None, mesh) for k in template}
    if isinstance(template, torch.Tensor):
        if specs is not None:
            from speech_distill_tpu_torch.parallel.sharding import (
                shard_leaf)
            saved = shard_leaf(saved, specs, mesh)
        t = saved.to(template.device, template.dtype)
        return t.requires_grad_(True) if template.requires_grad else t
    return saved


class CheckpointManager:
    """save / latest_step / restore / wait, keeping ``max_to_keep``
    checkpoints."""

    def __init__(self, directory: str, max_to_keep: int = 3, mesh=None,
                 specs_fn=None):
        """``mesh`` and ``specs_fn(state) -> specs`` (e.g.
        ``sharding.state_pspecs``): save gathers the ranks' slices and
        rank 0 writes; restore cuts every rank's slices."""
        self.directory = directory
        self.max_to_keep = max_to_keep
        self.mesh = mesh if mesh is not None and mesh.world > 1 else None
        self.specs_fn = specs_fn
        os.makedirs(directory, exist_ok=True)

    def steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in
                      map(_NAME.match, os.listdir(self.directory)) if m)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{step}.pt")

    def save(self, step: int, state):
        if self.mesh is not None:
            from speech_distill_tpu_torch.parallel import multihost
            from speech_distill_tpu_torch.parallel.sharding import (
                gather_state)
            state = gather_state(state, self.specs_fn(state), self.mesh)
            if not self.mesh.is_primary:
                multihost.barrier()
                return
        tmp = self._path(step) + ".tmp"
        torch.save({"state": _to_plain(state)}, tmp)
        os.replace(tmp, self._path(step))
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self._path(old))
        if self.mesh is not None:
            multihost.barrier()

    def wait(self):
        """Saves are synchronous: nothing is in flight."""

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, state_template, step: Optional[int] = None):
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        saved = torch.load(self._path(step), map_location="cpu",
                           weights_only=True)
        if self.mesh is None:
            return _restore_like(state_template, saved["state"])
        return _restore_like(state_template, saved["state"],
                             self.specs_fn(state_template), self.mesh)

    def close(self):
        """Nothing is held open."""


def hf_config(cfg, extra_config: Optional[Dict[str, Any]] = None
              ) -> Dict[str, Any]:
    """The ``config.json`` of :func:`export_hf` for a Qwen3 config."""
    hf_cfg = {
        "architectures": ["Qwen3ForCausalLM"],
        "model_type": "qwen3",
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_hidden_layers,
        "num_attention_heads": cfg.num_attention_heads,
        "num_key_value_heads": cfg.num_key_value_heads,
        "head_dim": cfg.head_dim,
        "rms_norm_eps": cfg.rms_norm_eps,
        "rope_theta": cfg.rope_theta,
        "max_position_embeddings": cfg.max_position_embeddings,
        "tie_word_embeddings": cfg.tie_word_embeddings,
        "torch_dtype": "bfloat16",
        "bos_token_id": cfg.bos_token_id,
        "eos_token_id": cfg.eos_token_id,
    }
    hf_cfg.update(extra_config or {})
    return hf_cfg


def export_hf(params: Dict[str, Any], cfg, out_dir: str,
              extra_config: Optional[Dict[str, Any]] = None) -> None:
    """Write ``config.json`` and ``model.safetensors`` under ``out_dir``
    from a JAX-shaped weight tree (tensors or arrays). The tensors are
    fp32 while the config names ``torch_dtype`` bfloat16: the JAX
    package's artifact, byte for byte."""
    from safetensors.numpy import save_file
    from speech_distill_tpu_torch.models.hf_loader import to_state_dict

    os.makedirs(out_dir, exist_ok=True)
    save_file(to_state_dict(params, cfg),
              os.path.join(out_dir, "model.safetensors"))
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(hf_config(cfg, extra_config), f, indent=2)
