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
the vocab (``models/qwen3.param_pspecs``); pp shards the layer axis of a
pipelined model (``cfg.pp_microbatches`` > 0 on a mesh with pp > 1:
:func:`pp_sharded`), in interleaved chunk order under
``cfg.pp_interleave`` (:class:`Interleaved`). A model sharded by
:func:`shard_params` holds its rank's slices under the global config
(``model.cfg``) and the mesh (``model.mesh``).

sp splits the sequence. Every rank of an sp group takes the same global
rows (:func:`shard_batch` splits only the batch over dp) and the model's
forward computes only its rank's positions (``qwen3.sequence_layout``:
contiguous, or the zig-zag chunk pair); the steps take the targets of
those positions with :func:`split_sequence`, which shifts the labels and
the speech mask by one on the whole sequence first: position p's target
is the label at p + 1, which may sit on the next rank.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, Sequence

import numpy as np
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


class Interleaved(tuple):
    """A spec whose leading dim (the layer axis, over "pp") is laid out in
    interleaved chunk order: each stage's slice holds its ``v`` chunks
    of L / (pp v) layers (``pipeline._interleave_layer_perm``), and
    :func:`gather_leaf` restores the natural order."""

    def __new__(cls, spec, v: int):
        obj = tuple.__new__(cls, spec)
        obj.v = v
        return obj


def _layer_perm(spec, L: int, mesh: Mesh):
    v = getattr(spec, "v", 1)
    if v <= 1 or mesh.shape.get("pp", 1) <= 1:
        return None
    from speech_distill_tpu_torch.parallel.pipeline import \
        _interleave_layer_perm
    return _interleave_layer_perm(L, mesh.shape["pp"], v)


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
    """This rank's slice of the global ``x`` (a view for a tensor; a copy
    of the layers for an :class:`Interleaved` spec)."""
    perm = _layer_perm(spec, x.shape[0], mesh) if len(spec) else None
    if perm is not None:
        x = x[torch.as_tensor(perm) if isinstance(x, torch.Tensor)
              else perm]
    return x[shard_slices(spec, x.shape, mesh.shape, mesh.coords)]


def gather_leaf(x: torch.Tensor, spec: Sequence, mesh: Mesh
                ) -> torch.Tensor:
    """The global leaf from each rank's slice ``x``: an all-gather over
    each sharded dim's axes, minor axis first (an :class:`Interleaved`
    layer axis put back in order). Every rank gets it."""
    for d in range(len(spec)):
        for a in reversed(_axes(spec[d])):
            x = comm.all_gather(x, mesh.group(a), dim=d)
    perm = _layer_perm(spec, x.shape[0], mesh) if len(spec) else None
    if perm is not None:
        x = x[torch.as_tensor(np.argsort(perm))]
    return x


def pp_sharded(cfg: Qwen3Config, mesh: Mesh) -> bool:
    """Whether a model of ``cfg`` pipelines its layers over the mesh's pp
    axis (``cfg.pp_microbatches`` > 0 and pp > 1): each stage then holds
    L / pp layers. Otherwise every stage holds them all (a teacher whose
    layer count pp does not divide runs whole on every stage)."""
    return (mesh is not None and mesh.shape.get("pp", 1) > 1
            and cfg.pp_microbatches > 0)


def local_config(cfg: Qwen3Config, tp: int, pp: int = 1) -> Qwen3Config:
    """The config whose shapes are one tp rank's: H / tp query heads,
    KV / tp KV heads, FFN / tp hidden units, V / tp vocab rows; and one
    pp stage's L / pp layers."""
    if tp == 1 and pp == 1:
        return cfg
    for name in ("num_attention_heads", "num_key_value_heads",
                 "intermediate_size", "vocab_size"):
        if getattr(cfg, name) % tp:
            raise ValueError(f"{name}={getattr(cfg, name)} is not "
                             f"divisible by tp={tp}")
    L, V = cfg.num_hidden_layers, max(cfg.pp_interleave, 1)
    if L % (pp * (V if pp > 1 else 1)):
        raise ValueError(f"layers {L} not divisible by pp*interleave="
                         f"{pp}*{V}")
    return dataclasses.replace(
        cfg, num_attention_heads=cfg.num_attention_heads // tp,
        num_key_value_heads=cfg.num_key_value_heads // tp,
        intermediate_size=cfg.intermediate_size // tp,
        vocab_size=cfg.vocab_size // tp, num_hidden_layers=L // pp)


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

    A pipelined ``cfg`` (:func:`pp_sharded`) gives each stage its L / pp
    layers (the layers of its chunks under ``cfg.pp_interleave``). On a
    mesh with sp, ``model.mesh`` is set so that a ring ``attn_impl`` takes
    the sp axis (``qwen3.sequence_layout``).

    Quantized leaves replicate whole, as in JAX (their scales do not
    split along tp). A model holding any is replicated whole: every rank
    runs the one-device forward on its dp rows (``model.mesh`` None), as
    does every model on a mesh without tp, pp or sp. A whole model already
    on the mesh's device is returned as it is."""
    from speech_distill_tpu_torch.models import qwen3
    from speech_distill_tpu_torch.models.convert import (model_to_tree,
                                                         params_from_jax)
    pp = mesh.pp if pp_sharded(cfg, mesh) else 1
    split = mesh.tp > 1 or pp > 1
    if isinstance(params, qwen3.Qwen3):
        quant = any(isinstance(m, qwen3.QuantWeight)
                    for m in params.modules())
        if (not split or quant) and params.device == mesh.device:
            if quant or (mesh.sp == 1 and params.cfg == cfg):
                return params          # every rank holds the whole model
            model = copy.copy(params)  # the same weights, under cfg
            model.cfg = cfg
            model.mesh = mesh if mesh.sp > 1 else None
            return model
        params = model_to_tree(params)
    if _has_quantized(params):
        return params_from_jax(params, cfg, mesh.device)
    if not split:
        model = params_from_jax(params, cfg, mesh.device)
        model.mesh = mesh if mesh.sp > 1 else None
        return model
    local = slice_tree(params, qwen3.param_pspecs(cfg, pp=pp > 1), mesh)
    model = params_from_jax(local, local_config(cfg, mesh.tp, pp),
                            mesh.device)
    model.cfg = cfg
    model.mesh = mesh
    return model


def lora_pspecs(lora_params: Params, pp: bool = False,
                interleave: int = 1) -> Params:
    """Specs of an ``init_lora`` tree: A [L, din, r] / B [L, r, dout]
    shard the dim the base weight shards (dout of q/k/v/gate/up, din of
    o/down); rank r stays whole. Full-rank embed / lm_head copies shard
    the vocab over tp. ``pp`` shards the layer axis, in interleaved chunk
    order for ``interleave`` > 1 (:class:`Interleaved`)."""
    lead = "pp" if pp else None

    def spec(*dims):
        return Interleaved(dims, interleave) if pp and interleave > 1 \
            else dims
    specs: Params = {}
    if "layers" in lora_params:
        specs["layers"] = {}
        for group, mods in lora_params["layers"].items():
            specs["layers"][group] = {}
            for key in mods:
                if _OUT_SHARDED[key]:
                    specs["layers"][group][key] = {
                        "a": spec(lead, None, None),
                        "b": spec(lead, None, "tp")}
                else:
                    specs["layers"][group][key] = {
                        "a": spec(lead, "tp", None),
                        "b": spec(lead, None, None)}
    if "embed" in lora_params:
        specs["embed"] = {"weight": ("tp", None)}
    if "lm_head" in lora_params:
        specs["lm_head"] = {"weight": ("tp", None)}
    return specs


def trainable_pspecs(trainable: Params, cfg: Qwen3Config,
                     use_lora: bool = True, mesh: Mesh = None) -> Params:
    """Specs of a trainable tree: :func:`lora_pspecs`, or for full
    finetuning ``param_pspecs`` over the trainable leaves; the layer axis
    over pp when ``cfg`` pipelines on ``mesh`` (:func:`pp_sharded`)."""
    pp = pp_sharded(cfg, mesh)
    if use_lora:
        return lora_pspecs(trainable, pp, cfg.pp_interleave)
    from speech_distill_tpu_torch.models.qwen3 import param_pspecs

    def prune(t, s):
        return {k: prune(v, s[k]) for k, v in t.items()} \
            if isinstance(t, dict) else s
    return prune(trainable, param_pspecs(cfg, pp=pp))


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


def shard_lora(mesh: Mesh, lora_params: Params,
               cfg: Qwen3Config = None) -> Params:
    """This rank's slices of an ``init_lora`` tree, on ``mesh.device``,
    leaves that require grad; a pipelined ``cfg`` (:func:`pp_sharded`)
    gives each stage the factors of its layers."""
    specs = (trainable_pspecs(lora_params, cfg, True, mesh)
             if cfg is not None else lora_pspecs(lora_params))
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
    if not isinstance(spec, tuple):
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
    if tuple(_zero1_widen(spec, gshape, mesh.shape)) == tuple(spec):
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
    microbatch axis A, else axis 0), on ``mesh.device``. The sequence
    stays whole on every sp rank: the forward takes its positions, the
    steps their targets (:func:`split_sequence`)."""
    spec = (None, "dp") if microbatched else ("dp",)
    return {k: shard_leaf(torch.as_tensor(v), spec, mesh).to(mesh.device)
            for k, v in batch.items()}


# next-token targets: shifted by one before the sequence is split
SHIFTED = {"labels": -100, "speech_token_mask": 0}


def split_sequence(mb: Dict[str, torch.Tensor], positions: torch.Tensor
                   ) -> Dict[str, torch.Tensor]:
    """The targets of this sp rank's ``positions`` in a microbatch
    ([B, T, ...] arrays): ``labels`` and ``speech_token_mask`` shifted by
    one on the whole sequence (position p gets the value at p + 1; the
    last position -100 / 0, so it is ignored, as the unsplit losses drop
    it), then every array taken at ``positions``. The teacher's top-K at
    p already pairs with the logits at p. The losses then read these
    pre-shifted targets (``train_step``'s sp route)."""
    out = {}
    for k, v in mb.items():
        if k in SHIFTED:
            v = torch.cat([v[:, 1:], torch.full_like(v[:, :1], SHIFTED[k])],
                          dim=1)
        out[k] = v.index_select(1, positions.to(v.device))
    return out


def gather_sequence(x: torch.Tensor, mesh: Mesh, zigzag: bool,
                    dim: int = 1) -> torch.Tensor:
    """The whole sequence in natural order from each sp rank's positions
    of it (``qwen3.sequence_layout``): an all-gather over sp along
    ``dim``, then the zig-zag order undone."""
    x = comm.all_gather(x, mesh.group("sp"), dim=dim)
    if zigzag:
        from speech_distill_tpu_torch.ops.ring_attention import \
            zigzag_inverse
        inv = torch.as_tensor(zigzag_inverse(x.shape[dim], mesh.sp),
                              dtype=torch.long, device=x.device)
        x = x.index_select(dim, inv)
    return x


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
