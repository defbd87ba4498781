"""Sharding rules for the training and serving state (port of
``speech_distill_tpu/parallel/sharding.py``).

A spec is a tuple naming, per dim, the mesh axis that dim is split over
(None: whole; a tuple of axes: split over their product, the first axis
major), the layout of a JAX ``PartitionSpec``. JAX places global arrays
by these specs and GSPMD inserts the collectives; here each rank takes
its slice of every leaf (:func:`shard_leaf`), the forward calls the
collectives itself (``models/qwen3``, ``parallel/comm``), and
:func:`gather_leaf` makes a leaf whole again (checkpoints, export).

dp shards the batch; tp shards attention heads, the MLP hidden dim and
the vocab (``models/qwen3.param_pspecs``). A model sharded by
:func:`shard_params` holds its rank's slices under the global config
(``model.cfg``) and the mesh (``model.mesh``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence

import torch

from speech_distill_tpu_torch.core.config import Qwen3Config
from speech_distill_tpu_torch.core.tree import (tree_leaves, tree_map,
                                                tree_unflatten)
from speech_distill_tpu_torch.parallel import comm
from speech_distill_tpu_torch.parallel.mesh import Mesh

Params = Dict[str, Any]

# lora target -> is the *output* dim tp-sharded on the base weight?
_OUT_SHARDED = {"q": True, "k": True, "v": True, "gate": True, "up": True,
                "o": False, "down": False}


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_slices(spec: Sequence, shape: Sequence[int],
                 mesh_shape: Dict[str, int], coords: Dict[str, int]
                 ) -> tuple:
    """The slice of a global array of ``shape`` that the rank at
    ``coords`` holds under ``spec`` (a pure function of the shapes: the
    tests hold it against JAX's ``NamedSharding``). A dim split over
    axes (a, b) takes chunk index a * |b| + b."""
    out = []
    for d, n in enumerate(shape):
        axes = _axes(spec[d]) if d < len(spec) else ()
        parts, idx = 1, 0
        for a in axes:
            parts *= mesh_shape[a]
            idx = idx * mesh_shape[a] + coords[a]
        if n % parts:
            raise ValueError(f"dim {d} of {tuple(shape)} is not divisible "
                             f"by the {parts} shards of {axes}")
        step = n // parts
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


def shard_leaf(x, spec: Sequence, mesh: Mesh):
    """This rank's slice of the global ``x`` (a view for a tensor)."""
    return x[shard_slices(spec, x.shape, mesh.shape, mesh.coords)]


def gather_leaf(x: torch.Tensor, spec: Sequence, mesh: Mesh
                ) -> torch.Tensor:
    """The global leaf from each rank's slice ``x``: an all-gather over
    each sharded dim's axes, minor axis first. Every rank gets it."""
    for d in range(len(spec)):
        for a in reversed(_axes(spec[d])):
            x = comm.all_gather(x, mesh.group(a), dim=d)
    return x


def local_config(cfg: Qwen3Config, tp: int) -> Qwen3Config:
    """The config whose shapes are one tp rank's: H / tp query heads,
    KV / tp KV heads, FFN / tp hidden units, V / tp vocab rows."""
    if tp == 1:
        return cfg
    for name in ("num_attention_heads", "num_key_value_heads",
                 "intermediate_size", "vocab_size"):
        if getattr(cfg, name) % tp:
            raise ValueError(f"{name}={getattr(cfg, name)} is not "
                             f"divisible by tp={tp}")
    return dataclasses.replace(
        cfg, num_attention_heads=cfg.num_attention_heads // tp,
        num_key_value_heads=cfg.num_key_value_heads // tp,
        intermediate_size=cfg.intermediate_size // tp,
        vocab_size=cfg.vocab_size // tp)


def _has_quantized(tree) -> bool:
    from speech_distill_tpu_torch.ops.quant import is_quantized_leaf
    if is_quantized_leaf(tree):
        return True
    return isinstance(tree, dict) and any(_has_quantized(v)
                                          for v in tree.values())


def shard_params(mesh: Mesh, params, cfg: Qwen3Config):
    """A :class:`~speech_distill_tpu_torch.models.qwen3.Qwen3` on
    ``mesh.device`` holding this rank's slices of ``params`` under
    ``qwen3.param_pspecs``: a Qwen3 model, or its JAX-layout weight tree
    (``convert.model_to_tree``, the JAX ``init_params``'s numpy arrays).
    ``model.cfg`` stays the global config; ``model.mesh`` is ``mesh``
    under tp.

    Quantized leaves replicate whole, as in JAX (their scales do not
    split along tp). A model holding any is replicated whole: every rank
    runs the one-device forward on its dp rows (``model.mesh`` None), as
    does every model on a mesh without tp. A whole model already on the
    mesh's device is returned as it is."""
    from speech_distill_tpu_torch.models import qwen3
    from speech_distill_tpu_torch.models.convert import (model_to_tree,
                                                         params_from_jax)
    if isinstance(params, qwen3.Qwen3):
        whole = mesh.tp == 1 or any(isinstance(m, qwen3.QuantWeight)
                                    for m in params.modules())
        if whole and params.device == mesh.device:
            return params              # every rank holds the whole model
        params = model_to_tree(params)
    if mesh.tp == 1 or _has_quantized(params):
        return params_from_jax(params, cfg, mesh.device)
    local = slice_tree(params, qwen3.param_pspecs(cfg), mesh)
    model = params_from_jax(local, local_config(cfg, mesh.tp), mesh.device)
    model.cfg = cfg
    model.mesh = mesh
    return model


def lora_pspecs(lora_params: Params, pp: bool = False) -> Params:
    """Specs of an ``init_lora`` tree: A [L, din, r] / B [L, r, dout]
    shard the dim the base weight shards (dout of q/k/v/gate/up, din of
    o/down); rank r stays whole. Full-rank embed / lm_head copies shard
    the vocab over tp. ``pp`` shards the layer axis (not ported)."""
    lead = "pp" if pp else None
    specs: Params = {}
    if "layers" in lora_params:
        specs["layers"] = {}
        for group, mods in lora_params["layers"].items():
            specs["layers"][group] = {}
            for key in mods:
                if _OUT_SHARDED[key]:
                    specs["layers"][group][key] = {
                        "a": (lead, None, None), "b": (lead, None, "tp")}
                else:
                    specs["layers"][group][key] = {
                        "a": (lead, "tp", None), "b": (lead, None, None)}
    if "embed" in lora_params:
        specs["embed"] = {"weight": ("tp", None)}
    if "lm_head" in lora_params:
        specs["lm_head"] = {"weight": ("tp", None)}
    return specs


def trainable_pspecs(trainable: Params, cfg: Qwen3Config,
                     use_lora: bool = True) -> Params:
    """Specs of a trainable tree: :func:`lora_pspecs`, or for full
    finetuning ``param_pspecs`` over the trainable leaves."""
    if use_lora:
        return lora_pspecs(trainable)
    from speech_distill_tpu_torch.models.qwen3 import param_pspecs

    def prune(t, s):
        return {k: prune(v, s[k]) for k, v in t.items()} \
            if isinstance(t, dict) else s
    return prune(trainable, param_pspecs(cfg))


def tp_partial(trainable: Params, use_lora: bool = True) -> Params:
    """Which trainable leaves are whole on every tp rank but whose
    gradients each rank holds only in part (summed over tp after the
    backward): the q/k norm scales (each rank normalises its own heads),
    LoRA's A of q/k/v/gate/up and B of o/down. The layer norms read the
    whole cotangent (``comm.copy_to_tp`` sits after them) and are not."""
    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(v, path + (k,)) for k, v in t.items()}
        if use_lora:
            if len(path) == 4 and path[0] == "layers":
                key, ab = path[2], path[3]
                return (ab == "a") == _OUT_SHARDED[key]
            return False
        return path[-1] in ("q_norm", "k_norm")
    return walk(trainable, ())


def shard_lora(mesh: Mesh, lora_params: Params) -> Params:
    """This rank's slices of an ``init_lora`` tree, on ``mesh.device``,
    leaves that require grad."""
    specs = lora_pspecs(lora_params)
    return tree_map(lambda x, s: shard_leaf(x.detach(), s, mesh).to(
        mesh.device).clone().requires_grad_(True), lora_params, specs)


def _global_shape(shape, spec, mesh_shape) -> tuple:
    out = list(shape)
    for d in range(min(len(spec), len(shape))):
        for a in _axes(spec[d]):
            out[d] *= mesh_shape[a]
    return tuple(out)


def _zero1_widen(spec: Sequence, shape: Sequence[int],
                 mesh_shape: Dict[str, int]) -> tuple:
    """ZeRO-1 moment spec (the JAX ``_zero1_widen``): also shard the
    leading axis of the GLOBAL ``shape`` over dp when it divides — whole
    leading axes over ("dp",), tp-sharded ones over ("tp", "dp")."""
    dp = int(mesh_shape.get("dp", 1))
    tp = int(mesh_shape.get("tp", 1))
    spec = tuple(spec)
    if dp <= 1 or not len(spec) or not len(shape):
        return spec
    first = spec[0]
    if first is None and shape[0] % dp == 0:
        return (("dp",),) + spec[1:]
    if first == "tp" and shape[0] % (tp * dp) == 0:
        return (("tp", "dp"),) + spec[1:]
    return spec


def zero1_slice(x: torch.Tensor, spec: Sequence, mesh: Mesh):
    """This rank's ZeRO-1 slice of a LOCAL (tp-sharded) leaf ``x`` of
    ``spec``: its leading dim split over dp where :func:`_zero1_widen`
    widens the spec, else None."""
    gshape = _global_shape(x.shape, spec, mesh.shape)
    if _zero1_widen(spec, gshape, mesh.shape) == tuple(spec):
        return None
    n = x.shape[0] // mesh.dp
    return x.narrow(0, mesh.index("dp") * n, n)


def _structure(tree):
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    return None


def shard_opt_state(mesh: Mesh, opt_state, trainable_specs: Params,
                    zero1: bool = False):
    """The optimizer state of a LOCAL trainable tree (``init`` of the
    rank's slices) as the JAX ``shard_opt_state`` lays it out: subtrees
    shaped like the trainable tree (the AdamW moments) follow the leaf
    specs — with ``zero1`` each moment keeps only its dp slice
    (:func:`zero1_slice`) — and the rest (counts) stays whole.

    The 8-bit state (``optim8bit.Adam8bitState``: flat code blocks a leaf)
    takes no spec: the JAX ``shard_opt_state`` fails placing its 1-D codes
    by the leaves' specs, and the port raises ``ValueError`` under tp or
    ZeRO-1. Under dp alone it stays whole on every rank."""
    from speech_distill_tpu_torch.distill.optim8bit import Adam8bitState
    if isinstance(opt_state, Adam8bitState):
        if zero1 or mesh.tp > 1:
            raise ValueError("the 8-bit optimizer state takes no tp or "
                             "ZeRO-1 sharding (its codes are flat blocks "
                             "of each leaf)")
        return opt_state
    spec_struct = _structure(trainable_specs)
    flat_specs = tree_leaves(trainable_specs)

    def place(subtree):
        if not zero1:
            return subtree
        out = []
        for leaf, spec in zip(tree_leaves(subtree), flat_specs):
            s = zero1_slice(leaf, spec, mesh)
            out.append(leaf if s is None else s.clone())
        return tree_unflatten(subtree, out)

    def walk(node):
        if isinstance(node, dict):
            if _structure(node) == spec_struct:
                return place(node)
            return {k: walk(v) for k, v in node.items()}
        return node

    return walk(opt_state)


def shard_batch(mesh: Mesh, batch: Dict[str, Any],
                microbatched: bool = True) -> Dict[str, Any]:
    """This rank's dp rows of a global batch (axis 1 under a leading
    microbatch axis A, else axis 0), on ``mesh.device``. sp (the
    sequence dim) is not ported."""
    spec = (None, "dp") if microbatched else ("dp",)
    return {k: shard_leaf(torch.as_tensor(v), spec, mesh).to(mesh.device)
            for k, v in batch.items()}


def replicate(mesh: Mesh, tree):
    """Every leaf whole on ``mesh.device``."""
    return tree_map(lambda x: torch.as_tensor(x).to(mesh.device), tree)


def gather_tree(tree: Params, specs: Params, mesh: Mesh) -> Params:
    """The global tree from each rank's slices (:func:`gather_leaf`)."""
    return tree_map(lambda x, s: gather_leaf(x.detach(), s, mesh), tree,
                    specs)


def slice_tree(tree: Params, specs: Params, mesh: Mesh) -> Params:
    """This rank's slices of a global tree (:func:`shard_leaf`)."""
    return tree_map(lambda x, s: shard_leaf(x, s, mesh), tree, specs)


def state_pspecs(state, trainable_specs: Params, mesh: Mesh,
                 zero1: bool = False):
    """Specs of a ``TrainState`` (trainable, opt_state, step) of local
    slices: the trainable tree by ``trainable_specs``, the moment subtrees
    alike (widened by :func:`_zero1_widen` under ``zero1``), the rest
    whole (None)."""
    spec_struct = _structure(trainable_specs)
    moments = trainable_specs
    if zero1:
        moments = tree_map(
            lambda p, s: _zero1_widen(s, _global_shape(p.shape, s,
                                                       mesh.shape),
                                      mesh.shape),
            state.trainable, trainable_specs)

    def walk(node):
        if isinstance(node, dict):
            if _structure(node) == spec_struct:
                return moments
            return {k: walk(v) for k, v in node.items()}
        if hasattr(node, "_fields"):
            return type(node)(*(walk(v) for v in node))
        return None
    return type(state)(trainable_specs, walk(state.opt_state),
                       *([None] * (len(state) - 2)))


def _walk_pair(state, specs, fn):
    if isinstance(state, dict):
        return {k: _walk_pair(v, specs[k] if isinstance(specs, dict)
                              else None, fn) for k, v in state.items()}
    if hasattr(state, "_fields"):
        return type(state)(*(_walk_pair(v, s, fn)
                             for v, s in zip(state, specs)))
    if isinstance(state, torch.Tensor) and specs is not None:
        return fn(state, specs)
    return state


def gather_state(state, specs, mesh: Mesh):
    """A one-device state from each rank's: every sharded tensor made
    whole (a collective: every rank calls it and gets the result)."""
    return _walk_pair(state, specs, lambda x, s: gather_leaf(
        x.detach(), s, mesh))
