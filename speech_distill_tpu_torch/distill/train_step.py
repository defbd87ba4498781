"""The stage-2 KD training and eval steps, and the stage-1 step (port of
``speech_distill_tpu/distill/train_step.py``).

``make_kd_step(mode=...)`` returns ``step(state, base, teacher, batch) ->
(state, metrics)``: the student forward with unmerged LoRA adapters
(``models/qwen3.forward_train``), or with every weight trainable
(``use_lora=False``, the tree of :func:`full_trainable`), the KD loss,
gradients of the trainable tree accumulated over the batch's leading
microbatch axis [A, B, T], and the optax chain of the JAX package — clip
by global norm, then AdamW on a warmup-linear / linear-decay schedule —
applied to the trainable tree. The teacher's top-K rides the batch
("precomputed"), or the teacher :class:`~speech_distill_tpu_torch.models.
qwen3.Qwen3` runs in the step under ``torch.no_grad`` ("online_sparse":
its top-K extracted on the device; "online_dense": its full softmax, the
mode a quantized teacher forces, :func:`quantize_teacher`).
``make_kd_eval_step`` computes the same losses without gradients.

``make_stage1_step`` is the stage-1 warm-up: next-token CE with only the
embedding (and an untied head) trainable and the gradient rows of the old
vocabulary zeroed, through the plain head or the fused CE (the chunked
plain route, or the K2 kernels of ``ops/pallas_lm_loss``).

The JAX step donates its state; the port updates the trainable tensors of
the state in place the same way (``donate=True``), or leaves them as they
were and returns new ones (``donate=False``). ``make_optimizer`` also
builds the 8-bit AdamW (``distill/optim8bit``) and the one-traversal
clip + AdamW (:func:`adamw` with ``fused=True``). JAX's ``split_apply``
(two programs) is the eager step as it is.

``mesh`` (``parallel/mesh.Mesh``): the step of one rank of a dp x pp x sp
x tp run (the JAX step over a ``NamedSharding``-placed state). The student
and the teacher are sharded by ``parallel/sharding.shard_params``, the
trainable tree holds the rank's slices, the batch its dp rows. The loss
divides by counts summed over dp and sp (``comm.dp_denominators``), the
gradients of leaves whole on every tp rank but computed in part are
summed over tp (``sharding.tp_partial``), every gradient over dp and sp,
and the clip's norm counts each tp- or pp-sharded leaf once over its
shards. ``zero1``: each rank keeps its dp slice of the AdamW moments
(``sharding.shard_opt_state``), updates that slice of each leaf and
all-gathers the result over dp.

Under sp (a ring ``attn_impl``) each rank's forward gives its positions
of the sequence (``qwen3.sequence_layout``) and the losses read their
targets, shifted on the whole sequence first (``sharding.
split_sequence``). Under pp the student's stack runs GPipe inside
``forward_train`` (``pp_schedule="gpipe"``) or the hand-scheduled 1F1B
(``"1f1b"``, interleaved with ``cfg.pp_interleave``; precomputed mode):
every stage gets the loss and the same gradient of each leaf replicated
over pp (embed, head, final norm), and its own layers' gradients.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from speech_distill_tpu_torch.core.config import (TEACHER_QUANTS,
                                                  DistillConfig, LoraConfig,
                                                  Qwen3Config)
from speech_distill_tpu_torch.core.device import resolve_device
from speech_distill_tpu_torch.core.tree import (tree_leaves, tree_map,
                                                tree_unflatten)
from speech_distill_tpu_torch.distill import losses
from speech_distill_tpu_torch.distill.lora import lora_scaling
from speech_distill_tpu_torch.models import qwen3
from speech_distill_tpu_torch.models.convert import (model_to_tree,
                                                     params_from_jax)
from speech_distill_tpu_torch.ops.fused_lm_loss import (
    BACKENDS, fused_cross_entropy, fused_extract_top_k, fused_sparse_kd_loss,
    head_dense_kd_loss, head_sparse_kd_loss)
from speech_distill_tpu_torch.ops.quant import quantize_params
from speech_distill_tpu_torch.parallel import comm

Params = Dict[str, Any]


MODES = ("precomputed", "online_sparse", "online_dense")


class Student(NamedTuple):
    """What the student forward reads besides the base model."""
    embed: Optional[torch.Tensor]
    lm_head: Optional[torch.Tensor]
    adapters: Optional[Params]
    adapter_scale: float
    weights: Optional[Params]       # full finetuning: every weight


def _effective_student(trainable: Params, lcfg: LoraConfig,
                       use_lora: bool) -> Student:
    """The JAX ``_effective_student``. LoRA: the trainable copies of the
    saved modules and the unmerged adapters; the base weights are the
    frozen model's own and get no gradient. Full finetuning: every weight
    comes from the trainable tree."""
    if not use_lora:
        return Student(trainable["embed"]["weight"],
                       trainable.get("lm_head", {}).get("weight"), None, 1.0,
                       trainable)
    return Student(trainable.get("embed", {}).get("weight"),
                   trainable.get("lm_head", {}).get("weight"),
                   trainable.get("layers"), lora_scaling(lcfg), None)


def _student_forward(base: qwen3.Qwen3, st: Student, mb: dict, merge: bool,
                     return_hidden: bool, dev):
    return qwen3.forward_train(
        base, mb["input_ids"], attention_mask=mb["attention_mask"],
        embed=st.embed, lm_head=st.lm_head, adapters=st.adapters,
        adapter_scale=st.adapter_scale, merge_adapters=merge,
        weights=st.weights, return_hidden=return_hidden, device=dev)


@torch.no_grad()
def full_trainable(model: qwen3.Qwen3) -> Params:
    """The trainable tree of full finetuning (``use_lora=False``): every
    weight of ``model`` in the JAX layout ({"embed": {"weight"},
    "final_ln": {"scale"}, "layers": stacked [L, ...] leaves, ["lm_head"]}),
    leaves that require grad. The model's own parameters become views of
    these leaves, so an in-place update (``donate=True``) trains the model
    itself."""
    if any(isinstance(m, qwen3.QuantWeight) for m in model.modules()):
        raise ValueError("full finetuning of a quantized model")
    layers = model.layers

    def stack(get, put):
        leaf = torch.stack([get(layer) for layer in layers])
        for i, layer in enumerate(layers):
            put(layer, torch.nn.Parameter(leaf[i], requires_grad=False))
        return leaf.requires_grad_(True)

    tree_layers = {}
    groups = {"attn": qwen3.attn_names(model.cfg),
              "mlp": ("gate", "up", "down")}
    for group, names in groups.items():
        tree_layers[group] = {
            n: stack(lambda l, g=group, n=n: getattr(getattr(l, g), n),
                     lambda l, p, g=group, n=n: setattr(getattr(l, g), n, p))
            for n in names}
    for ln in ("input_ln", "post_ln"):
        tree_layers[ln] = {"scale": stack(
            lambda l, ln=ln: getattr(l, ln),
            lambda l, p, ln=ln: setattr(l, ln, p))}
    tree = {"embed": {"weight": model.embed.detach().requires_grad_(True)},
            "final_ln": {"scale": model.final_ln.detach()
                         .requires_grad_(True)},
            "layers": tree_layers}
    if model.lm_head is not None:
        tree["lm_head"] = {"weight": model.lm_head.detach()
                           .requires_grad_(True)}
    return tree


def quantize_teacher(teacher: qwen3.Qwen3, teacher_quant: str
                     ) -> qwen3.Qwen3:
    """The teacher with quantized weights, as the JAX benchmark builds it:
    "int8" quantizes the projections and the embedding to int8, "nf4" (or
    "int4") the projections to nf4 with the embedding kept. Its forward
    then dequantizes each weight before its product (K3 takes int4 leaves
    only). "none" returns the teacher as it is."""
    if teacher_quant not in TEACHER_QUANTS:
        raise ValueError(f"unknown teacher_quant {teacher_quant!r}")
    if teacher_quant == "none":
        return teacher
    int8 = teacher_quant == "int8"
    tree = quantize_params(model_to_tree(teacher), bits=8 if int8 else 4,
                           quantize_embed=int8,
                           method="int8" if int8 else "nf4")
    return params_from_jax(tree, teacher.cfg, teacher.device)


class TrainState(NamedTuple):
    trainable: Params
    opt_state: Any
    step: int


class Optimizer(NamedTuple):
    """The optax ``GradientTransformation`` shape: ``init(params) ->
    state`` and ``update(grads, state, params) -> (updates, state)``."""
    init: Callable
    update: Callable


def bias_corrections(b1: float, b2: float, count: int):
    """(1 - b1 ** count, 1 - b2 ** count) in fp32 arithmetic, as optax
    computes them from an int32 count."""
    one, t = np.float32(1.0), np.float32(count)
    return (float(one - np.float32(b1) ** t),
            float(one - np.float32(b2) ** t))


def weak(x: float, t: torch.Tensor) -> torch.Tensor:
    """The Python scalar ``x`` as it meets ``t`` in JAX (a weakly typed
    scalar takes the array's dtype: 0.01 * a bf16 leaf is bf16(0.01) times
    it); torch would keep it in fp32."""
    return torch.tensor(x, dtype=t.dtype, device=t.device)


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32."""
    return torch.sqrt(sum(t.float().square().sum()
                          for t in tree_leaves(tree)))


def warmup_linear_schedule(learning_rate: float, warmup_steps: int,
                           total_steps: int) -> Callable[[int], float]:
    """``join_schedules([linear(0 -> lr, warmup), linear(lr -> 0, total -
    warmup)], [warmup])`` as optax evaluates it, in fp32 arithmetic:
    ``count`` -> the learning rate (a Python float holding the fp32
    value)."""
    warmup = max(1, warmup_steps)
    total = max(total_steps, warmup + 1)
    f32 = np.float32

    def linear(init: float, end: float, steps: int, count: int):
        frac = f32(1) - f32(min(max(count, 0), steps)) / f32(steps)
        return f32(init - end) * frac + f32(end)

    def schedule(count: int) -> float:
        if count < warmup:
            return float(linear(0.0, learning_rate, warmup, count))
        return float(linear(learning_rate, 0.0, total - warmup,
                            count - warmup))
    return schedule


def clip_scale(grads: Params, max_grad_norm: float,
               g_norm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The fp32 factor of clip by global norm: 1 under ``max_grad_norm``,
    max / |g| at or over it (no epsilon, unlike ``torch.nn.utils.
    clip_grad_norm_``), selected on the device. ``g_norm``: the norm when
    the caller has it (a sharded tree's, :func:`mesh_norm`)."""
    if g_norm is None:
        g_norm = global_norm(grads)
    return torch.where(g_norm < max_grad_norm, 1.0,
                       max_grad_norm / g_norm.clamp_min(1e-30))


def adamw(schedule: Callable[[int], float], b1: float = 0.9,
          b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0,
          max_grad_norm: float = 1.0, fused: bool = False) -> Optimizer:
    """Clip by global norm, then AdamW at ``schedule(count of earlier
    updates)``, one pass over the leaves; each leaf's arithmetic in fp32
    on the gradient times the fp32 clip factor.

    Default (optax's ``chain(clip_by_global_norm, adamw)``): the moments
    are kept in each parameter's dtype, as optax keeps them (bf16 for a
    bf16 embed copy); the decay is ``wd * p`` in fp32 and the updates are
    fp32. ``fused`` (the JAX ``fused_clip_adamw``, held there leaf-exact
    against the optax chain): the moments are fp32, as JAX's become after
    its first update (a bf16 gradient times the fp32 factor promotes), so
    a checkpoint restores them as they are; the decay is ``wd * p`` in
    p's dtype and each update is cast to its gradient's dtype."""
    moment_dtype = {"dtype": torch.float32} if fused else {}

    def init(params: Params) -> dict:
        def zeros():
            return tree_map(lambda p: torch.zeros_like(
                p, requires_grad=False, **moment_dtype), params)
        return {"count": 0, "mu": zeros(), "nu": zeros()}

    @torch.no_grad()
    def update(grads: Params, state: dict, params: Optional[Params] = None,
               g_norm: Optional[torch.Tensor] = None):
        clip = clip_scale(grads, max_grad_norm, g_norm)
        count = state["count"] + 1
        bc1, bc2 = bias_corrections(b1, b2, count)
        neg_lr = -schedule(state["count"])
        flat_p = (tree_leaves(params) if params is not None
                  else [None] * len(tree_leaves(grads)))
        ups, mus, nus = [], [], []
        for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state["mu"]),
                              tree_leaves(state["nu"]), flat_p):
            gc = g.float() * clip
            m2 = b1 * m.float() + (1.0 - b1) * gc
            v2 = b2 * v.float() + (1.0 - b2) * gc.square()
            upd = (m2 / bc1) / (torch.sqrt(v2 / bc2) + eps)
            if weight_decay and p is not None:
                upd = upd + (weak(weight_decay, p) * p if fused
                             else weight_decay * p.float())
            upd = neg_lr * upd
            ups.append(upd.to(g.dtype) if fused else upd)
            mus.append(m2.to(m.dtype))
            nus.append(v2.to(v.dtype))
        return (tree_unflatten(grads, ups),
                {"count": count, "mu": tree_unflatten(state["mu"], mus),
                 "nu": tree_unflatten(state["nu"], nus)})

    return Optimizer(init, update)


def make_optimizer(learning_rate: float, warmup_steps: int,
                   total_steps: int, weight_decay: float = 0.0,
                   max_grad_norm: float = 1.0, eight_bit: bool = False,
                   fused: bool = False) -> Optimizer:
    """``optax.chain(clip_by_global_norm(max_grad_norm), adamw(schedule,
    b1=0.9, b2=0.999, eps=1e-8, weight_decay))`` (:func:`adamw`) with the
    schedule of :func:`warmup_linear_schedule` evaluated at the count of
    earlier updates, so the first step's learning rate is 0.
    ``eight_bit``: the same chain with int8 / uint8 moments
    (``optim8bit.adamw_8bit``, the reference's bitsandbytes
    ``adamw_8bit``); ``fused``: ``adamw(fused=True)``, JAX's
    ``fused_clip_adamw``."""
    schedule = warmup_linear_schedule(learning_rate, warmup_steps,
                                      total_steps)
    if eight_bit:
        from speech_distill_tpu_torch.distill.optim8bit import adamw_8bit
        return adamw_8bit(schedule, weight_decay=weight_decay,
                          max_grad_norm=max_grad_norm)
    return adamw(schedule, weight_decay=weight_decay,
                 max_grad_norm=max_grad_norm, fused=fused)


@torch.no_grad()
def apply_updates(params: Params, updates: Params,
                  in_place: bool = True) -> Params:
    """p + u rounded to p's dtype (``optax.apply_updates``); in place on
    the parameter tensors, or into new leaves that require grad."""
    def one(p, u):
        new = (p.float() + u).to(p.dtype)
        if in_place:
            p.copy_(new)
            return p
        return new.requires_grad_(True)
    return tree_map(one, params, updates)


def init_state(trainable: Params, optimizer: Optimizer) -> TrainState:
    return TrainState(trainable, optimizer.init(trainable), 0)


def _sharded_axes(spec) -> tuple:
    """The model axes (tp, pp) a leaf's spec splits it over."""
    axes = set()
    for a in spec:
        axes.update(a if isinstance(a, tuple) else (a,))
    return tuple(a for a in ("pp", "tp") if a in axes)


def mesh_norm(grads: Params, specs: Params, mesh) -> torch.Tensor:
    """The global norm of a tree of one rank's slices (dp- and sp-reduced
    gradients): each tp- or pp-sharded leaf's squares summed over its
    axes, each whole leaf counted once."""
    sums: dict = {}
    for g, spec in zip(tree_leaves(grads), tree_leaves(specs)):
        key = _sharded_axes(spec)
        sq = g.float().square().sum()
        sums[key] = sq if key not in sums else sums[key] + sq
    total = torch.zeros((), device=tree_leaves(grads)[0].device)
    for key in sorted(sums, key=lambda k: (not k, k)):   # whole ones last
        total = total + comm.all_reduce_over(
            sums[key], *(mesh.group(a) for a in key))
    return torch.sqrt(total)


def sync_grads(grads: Params, partial: Params, mesh) -> Params:
    """One rank's gradients made those of the global step: the leaves
    each tp rank computes in part (``sharding.tp_partial``) summed over
    tp, then every leaf summed over dp and sp (the loss's counts are
    global, so the sum is the global batch's gradient). Leaves replicated
    over pp already hold the same gradient on every stage."""
    tp, dp, sp = mesh.group("tp"), mesh.group("dp"), mesh.group("sp")
    out = []
    for g, part in zip(tree_leaves(grads), tree_leaves(partial)):
        g = g.contiguous()
        if part:
            comm.all_reduce_(g, tp)
        comm.all_reduce_(g, dp)
        out.append(comm.all_reduce_(g, sp))
    return tree_unflatten(grads, out)


@torch.no_grad()
def zero1_update(optimizer: Optimizer, grads: Params, state: TrainState,
                 specs: Params, mesh, g_norm: torch.Tensor, donate: bool):
    """The ZeRO-1 update: the optimizer on each leaf's dp slice
    (``sharding.zero1_slice``) of the gradient, the parameter and the
    moments the state holds, then the new slices all-gathered over dp
    into the rank's leaf. AdamW is elementwise past the clip, whose norm
    (``g_norm``) is the whole tree's, so the leaves equal the unsharded
    update's. Returns (trainable, opt_state)."""
    from speech_distill_tpu_torch.parallel.sharding import zero1_slice
    leaves = tree_leaves(state.trainable)
    views = [zero1_slice(p, sp, mesh)
             for p, sp in zip(leaves, tree_leaves(specs))]
    g_v = [g if v is None else zero1_slice(g, sp, mesh) for g, v, sp in
           zip(tree_leaves(grads), views, tree_leaves(specs))]
    p_v = [p if v is None else v for p, v in zip(leaves, views)]
    updates, opt_state = optimizer.update(
        tree_unflatten(grads, g_v), state.opt_state,
        tree_unflatten(grads, p_v), g_norm=g_norm)
    dp = mesh.group("dp")
    out = []
    for p, pv, v, u in zip(leaves, p_v, views, tree_leaves(updates)):
        new = (pv.float() + u).to(p.dtype)
        if v is not None:
            new = comm.all_gather(new, dp, dim=0)
        if donate:
            p.copy_(new)
            out.append(p)
        else:
            out.append(new.requires_grad_(True))
    return tree_unflatten(state.trainable, out), opt_state


def _accumulate(loss_and_grad: Callable, trainable: Params, batch: dict):
    """Loss and grads over the leading microbatch axis A, averaged. A == 1
    keeps the grads in each parameter's dtype; A > 1 sums them in fp32."""
    A = batch["input_ids"].shape[0]
    if A == 1:
        return loss_and_grad(trainable, {k: v[0] for k, v in batch.items()})
    acc, per_mb = None, []
    for a in range(A):
        grads, metrics = loss_and_grad(
            trainable, {k: v[a] for k, v in batch.items()})
        g32 = [g.float() for g in tree_leaves(grads)]
        acc = g32 if acc is None else [x + y for x, y in zip(acc, g32)]
        per_mb.append(metrics)
    inv = 1.0 / A
    grads = tree_unflatten(trainable, [x * inv for x in acc])
    metrics = {k: torch.stack([m[k] for m in per_mb]).mean()
               for k in per_mb[0]}
    return grads, metrics


def _teacher_routes(student_cfg: Qwen3Config, distill_cfg: DistillConfig,
                    mode: str, teacher_forward: Optional[Callable],
                    teacher_extract: Optional[Callable]):
    """(teacher_forward, teacher_extract) of an online mode: the teacher
    forward defaults to the port's ``qwen3.forward`` (fp32 logits, no
    grad); with that default and ``online_extract="fused"`` the sparse
    top-K comes from the teacher's hidden states through
    ``fused_extract_top_k``, never holding its [B, T, V] logits."""
    if teacher_forward is not None or mode == "precomputed":
        return teacher_forward, teacher_extract

    def teacher_forward(teacher, ids, mask):
        return qwen3.forward(teacher, ids, attention_mask=mask)

    if teacher_extract is None and distill_cfg.online_extract == "fused":
        def teacher_extract(teacher, ids, mask):
            hidden = qwen3.forward(teacher, ids, attention_mask=mask,
                                   return_hidden=True)
            return fused_extract_top_k(hidden, qwen3.full_lm_head(teacher),
                                       distill_cfg.top_k,
                                       student_cfg.vocab_size)
    return teacher_forward, teacher_extract


def _online_teacher(mode: str, student_cfg: Qwen3Config,
                    distill_cfg: DistillConfig, teacher_forward,
                    teacher_extract, teacher, mb: dict):
    """The teacher's side of an online microbatch, without gradients:
    (top-K values, indices) for "online_sparse", the logits truncated to
    the student vocab for "online_dense". Reads ``teacher_input_ids`` and
    ``teacher_attention_mask`` when the batch has them."""
    ids = mb.get("teacher_input_ids", mb["input_ids"])
    mask = mb.get("teacher_attention_mask", mb["attention_mask"])
    with torch.no_grad():
        if mode == "online_sparse":
            if teacher_extract is not None:
                return teacher_extract(teacher, ids, mask)
            return losses.extract_top_k(
                teacher_forward(teacher, ids, mask), distill_cfg.top_k,
                student_vocab_size=student_cfg.vocab_size,
                method=distill_cfg.online_topk_method,
                recall=distill_cfg.online_topk_recall)
        logits = teacher_forward(teacher, ids, mask)
        check_width(logits.shape[-1], student_cfg.vocab_size)
        return logits[..., :student_cfg.vocab_size]


def check_width(teacher_width: int, student_vocab: int) -> None:
    """Dense KD and agreement compare the teacher's logits with the
    student's over the student vocabulary: a narrower teacher raises
    ``ValueError`` (the JAX steps fail on the shapes). The steps check
    their logits' width, the CLIs the teacher's before it loads."""
    if teacher_width < student_vocab:
        raise ValueError(f"the teacher's logits are {teacher_width} wide, "
                         f"narrower than the student's vocabulary of "
                         f"{student_vocab}")


def _batch_groups(mesh) -> tuple:
    """The groups a loss's counts and metrics are summed over: dp, and sp
    (each sp rank holds a piece of every sequence)."""
    return () if mesh is None else (mesh.group("dp"), mesh.group("sp"))


def _split(base: qwen3.Qwen3, mb: dict, mesh):
    """Under sp: (the student's ``qwen3.sequence_layout``, the targets of
    this rank's positions, ``sharding.split_sequence``) of the microbatch;
    None otherwise."""
    if mesh is None or mesh.sp == 1:
        return None
    from speech_distill_tpu_torch.parallel.sharding import split_sequence
    T = mb["input_ids"].shape[1]
    layout = qwen3.sequence_layout(base, T, mb["input_ids"].device)
    if layout is None:
        raise ValueError(
            f"sp={mesh.sp} needs the student's attn_impl 'ring' or "
            f"'ring_zigzag' (it is {base.cfg.attn_impl!r}) and a sequence "
            f"length dividing by sp (it is {T})")
    keep = ("labels", "speech_token_mask", "teacher_top_k_v",
            "teacher_top_k_i")
    return layout, split_sequence({k: v for k, v in mb.items()
                                   if k in keep}, layout[0])


def _local_teacher(t_out, teacher, T: int, layout):
    """The teacher's outputs at this sp rank's positions (the student's
    ``layout``): as they come when the teacher's forward splits the
    length-T sequence too (``qwen3.sequence_layout``), which must then be
    the student's split, else taken there."""
    own = qwen3.sequence_layout(teacher, T)
    if own is not None:
        if own[1] != layout[1]:
            raise ValueError("the teacher and the student split the "
                             "sequence over sp differently (one zig-zag, "
                             "one contiguous): give both one ring "
                             "attn_impl")
        return t_out
    pos = layout[0]
    return tuple(t.index_select(1, pos) for t in t_out) \
        if isinstance(t_out, tuple) else t_out.index_select(1, pos)


def _pad_row(t: torch.Tensor, value, first: bool) -> torch.Tensor:
    pad = torch.full_like(t[:, :1], value)
    return torch.cat([pad, t] if first else [t, pad], dim=1)


def _presplit_loss_inputs(acts, targets: dict, t_out):
    """The losses' inputs for pre-shifted targets: the losses drop the
    last position of the logits (and the top-K) and the first of the
    labels (and the speech mask), so each gets one padding position there
    and the rank's own positions meet their own targets."""
    mb = {}
    for k, v in targets.items():
        if k in ("labels", "speech_token_mask"):
            mb[k] = _pad_row(v, -100 if k == "labels" else 0, True)
        else:
            mb[k] = _pad_row(v, 0, False)
    if t_out is not None:
        t_out = tuple(_pad_row(t, 0, False) for t in t_out) \
            if isinstance(t_out, tuple) else _pad_row(t_out, 0, False)
    return _pad_row(acts, 0, False), mb, t_out


def _make_1f1b_loss_and_grad(student_cfg: Qwen3Config,
                             distill_cfg: DistillConfig, lcfg: LoraConfig,
                             use_lora: bool, merge_weights: bool, mesh):
    """Loss and gradients of the precomputed sparse-KD step under the
    hand-scheduled 1F1B pipeline (``parallel/pipeline.
    pipelined_grads_interleaved``; ``cfg.pp_interleave`` > 1 adds virtual
    stages), the JAX ``_make_1f1b_grad_fn``: the head runs per microbatch
    on the last stage in sum form over global denominators
    (``losses.sparse_distill_sums``), so the summed microbatches give the
    full-batch masked means; the embedding's gradient chains through the
    pipeline input's (``g_x``), a tied head's is added into it; the frozen
    base stack gets no gradient (LoRA), full finetuning its layers'."""
    from speech_distill_tpu_torch.parallel.pipeline import (
        mesh_pp, pipelined_grads_interleaved)
    if mesh_pp(mesh) <= 1:
        raise ValueError("pp_schedule='1f1b' needs a mesh with pp > 1")
    if merge_weights:
        raise ValueError("pp_schedule='1f1b' differentiates the adapter "
                         "stack directly; merge_weights is unsupported")
    M, V = student_cfg.pp_microbatches, max(student_cfg.pp_interleave, 1)
    if M <= 0:
        raise ValueError("pp_schedule='1f1b' requires pp_microbatches > 0")
    cfg = student_cfg
    names = ("student_loss", "distill_loss", "teacher_loss")

    def loss_and_grad(trainable: Params, mb: dict, base: qwen3.Qwen3,
                      teacher):
        del teacher                  # precomputed: the top-K rides the batch
        st = _effective_student(trainable, lcfg, use_lora)
        ids, labels = mb["input_ids"].long(), mb["labels"]
        smask = mb.get("speech_token_mask")
        B, T = ids.shape
        dev = ids.device
        full_ft = not use_lora
        tied = base.lm_head is None
        embed_grad = full_ft or "embed" in trainable
        head_grad = full_ft or "lm_head" in trainable or (tied and
                                                          embed_grad)
        tp = qwen3.tp_group(base)
        table = base.embed if st.embed is None else st.embed
        with torch.set_grad_enabled(embed_grad):
            x = qwen3.vocab_lookup(table, ids, tp)
        positions = torch.arange(T, device=dev)[None].expand(B, T)
        cos, sin = qwen3.rope_angles(positions, cfg.head_dim, cfg.rope_theta)
        bias = qwen3.causal_bias(mb["attention_mask"], B, T, dev)
        # targets and global denominators of the sum-form head
        shift, valid, idx_s, denom, n_hits = losses.sparse_targets(
            labels, smask, mb["teacher_top_k_i"])
        v_s = mb["teacher_top_k_v"][:, :-1]
        mbs = B // M

        # the stage's chunks: local layers [v Lc, (v + 1) Lc)
        src = st.weights["layers"] if full_ft else st.adapters
        leaves = tree_leaves(src) if src is not None else []
        Lc = len(base.layers) // V
        chunk_leaves = [[l[v * Lc:(v + 1) * Lc] for l in leaves]
                        for v in range(V)]
        run_chunk = qwen3.stage_chunk_fn(base, src, cos, sin, bias, mbs, Lc,
                                         full_ft=full_ft,
                                         scale=st.adapter_scale)

        w_local = qwen3.lm_head_weight(base, st.embed, st.lm_head)
        ln = st.weights["final_ln"]["scale"] if full_ft else base.final_ln
        head_leaves = [w_local, ln] if head_grad else []

        def head_fn(h, m, hl):
            w, g = (hl if hl else (w_local, ln))
            rows = slice(m * mbs, (m + 1) * mbs)
            hn = qwen3.rms_norm(h, g, cfg.rms_norm_eps)
            # the unfused head's product (fp32 logits and cotangent)
            s = qwen3.unembed_train(hn[:, :-1],
                                    comm.gather_from_tp(w, tp, 0), cfg)
            out = losses.sparse_distill_sums(
                s, shift[rows], valid[rows], v_s[rows], idx_s[rows], denom,
                n_hits, distill_cfg.temperature, distill_cfg.alpha)
            return out.total, {"student_loss": out.task,
                               "distill_loss": out.distill,
                               "teacher_loss": out.teacher}

        res = pipelined_grads_interleaved(
            run_chunk, chunk_leaves, x.detach(), head_fn, head_leaves, mesh,
            M, V, grad_x=embed_grad, metric_names=names)
        g_layers = [torch.cat([res.g_chunks[v][j] for v in range(V)])
                    for j in range(len(leaves))]
        grads: Params = {}
        if src is not None:
            grads["layers"] = tree_unflatten(src, g_layers)
        g_w = res.g_head[0] if head_grad else None
        if embed_grad:
            (g_e,) = torch.autograd.grad(x, table, res.g_x.to(x.dtype))
            g_e = g_e.float()
            if tied and head_grad:
                g_e = g_e + g_w
            grads["embed"] = {"weight": g_e}
        if "lm_head" in trainable:
            grads["lm_head"] = {"weight": g_w}
        if full_ft:
            grads["final_ln"] = {"scale": res.g_head[1]}
        metrics = {"loss": res.loss, **res.metrics}
        return tree_unflatten(trainable, tree_leaves(grads)), metrics

    return loss_and_grad


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r} ({MODES})")


def make_kd_step(student_cfg: Qwen3Config, distill_cfg: DistillConfig,
                 optimizer: Optimizer, *, mode: str,
                 teacher_forward: Optional[Callable] = None,
                 teacher_extract: Optional[Callable] = None,
                 use_lora: bool = True, merge_weights: bool = False,
                 donate: bool = True, fused_loss: bool = False,
                 fused_backend: str = "xla", loss_chunk_size: int = 16384,
                 head_loss: str = "fused", split_apply: bool = False,
                 pp_schedule: str = "gpipe", device="cuda", mesh=None,
                 zero1: bool = False):
    """Build the KD step ``step(state, base, teacher, batch) -> (state,
    metrics)``.

    ``mode``: "precomputed" (the batch carries teacher_top_k_v / _i),
    "online_sparse" (the teacher runs in the step; its top-K is extracted
    on the device, ``distill_cfg.top_k`` wide) or "online_dense" (its full
    softmax; the quantized-teacher mode). ``base`` is the student
    :class:`~speech_distill_tpu_torch.models.qwen3.Qwen3` (frozen after
    ``init_lora``; with ``use_lora=False`` the model whose weights
    ``state.trainable = full_trainable(base)`` holds). ``teacher`` is the
    teacher model (unused when precomputed), run through
    ``teacher_forward(teacher, ids, mask) -> logits`` (default: the port's
    ``qwen3.forward``; the model carries its config, so the JAX
    ``teacher_cfg`` has no counterpart) or, for online_sparse,
    ``teacher_extract(teacher, ids, mask) -> (v, i)``.
    ``batch`` maps names to [A, B, T(, K)] arrays or tensors: input_ids,
    attention_mask, labels, optionally speech_token_mask,
    teacher_input_ids and teacher_attention_mask, and teacher_top_k_v /
    _i when precomputed; they are moved to ``device`` (CUDA by default;
    raises without it).

    ``fused_loss`` (precomputed only, as in JAX) takes the loss from row
    statistics (``fused_sparse_kd_loss`` with ``fused_backend`` "xla",
    chunks of ``loss_chunk_size``, or "pallas", the K2 op) and never
    materialises the logits; otherwise ``head_loss``: 'fused' (the
    analytic one-pass backward of ``head_sparse_kd_loss`` /
    ``head_dense_kd_loss``) or 'unfused' (autograd through
    ``unembed_train`` and ``sparse_distill_loss`` / ``dense_distill_loss``).
    ``merge_weights`` folds the adapters into the weights inside the
    forward and lets autograd differentiate the merged product.
    ``split_apply``: JAX's step as two programs, the accumulated gradients
    and then the optimizer's update with the state donated (a workaround
    of the TPU compiler). The eager step already runs the gradients and
    then the update, so the value changes nothing; donation has no eager
    counterpart beyond ``donate``'s in-place update. Metrics (0-dim
    tensors on the device): loss, student_loss, distill_loss, teacher_loss
    and grad_norm (global norm of the grads before clipping).

    ``mesh``: this rank's step of a dp x tp run (see the module's
    docstring), ``device`` then the mesh's; ``zero1`` keeps the moments'
    dp slices (the state from ``sharding.shard_opt_state(...,
    zero1=True)``). Metrics are the global batch's on every rank.
    """
    dev = resolve_device(device if mesh is None else mesh.device)
    _check_mode(mode)
    del split_apply                 # the same step either way (above)
    if fused_backend not in BACKENDS:
        raise ValueError(f"unknown fused_backend {fused_backend!r}")
    if pp_schedule not in ("gpipe", "1f1b"):
        raise ValueError(f"unknown pp_schedule {pp_schedule!r}")
    if pp_schedule == "1f1b" and mode != "precomputed":
        raise ValueError(
            "pp_schedule='1f1b' supports mode='precomputed'; for online KD "
            "disaggregate the teacher (--teacher_devices), which streams "
            "precomputed-style artifacts")
    if head_loss not in ("fused", "unfused"):
        raise ValueError(f"unknown head_loss {head_loss!r}")
    lcfg = distill_cfg.lora
    T, alpha = distill_cfg.temperature, distill_cfg.alpha
    fused_loss = fused_loss and mode == "precomputed"
    fused_head = fused_loss or head_loss == "fused"
    teacher_forward, teacher_extract = _teacher_routes(
        student_cfg, distill_cfg, mode, teacher_forward, teacher_extract)
    pp_1f1b = None
    if pp_schedule == "1f1b":
        pp_1f1b = _make_1f1b_loss_and_grad(student_cfg, distill_cfg, lcfg,
                                           use_lora, merge_weights, mesh)

    def loss_and_grad(trainable: Params, mb: dict, base: qwen3.Qwen3,
                      teacher):
        # the teacher first: its logits are freed (sparse) before the
        # student's are made
        split = _split(base, mb, mesh)
        if mode != "precomputed":
            t_out = _online_teacher(mode, student_cfg, distill_cfg,
                                    teacher_forward, teacher_extract,
                                    teacher, mb)
            if split is not None:
                t_out = _local_teacher(t_out, teacher,
                                       mb["input_ids"].shape[1], split[0])
        st = _effective_student(trainable, lcfg, use_lora)
        acts = _student_forward(base, st, mb, merge_weights, fused_head, dev)
        head = qwen3.full_lm_head(base, st.embed, st.lm_head)
        if split is not None:
            acts, mb, t_out = _presplit_loss_inputs(
                acts, split[1], t_out if mode != "precomputed" else None)
        labels, smask = mb["labels"], mb.get("speech_token_mask")
        if mode == "online_dense":
            if fused_head:
                out = head_dense_kd_loss(acts, head, t_out, labels, smask,
                                         T, alpha)
            else:
                out = losses.dense_distill_loss(acts, t_out, labels, smask,
                                                T, alpha)
            del t_out
        else:
            v, i = (t_out if mode == "online_sparse" else
                    (mb["teacher_top_k_v"], mb["teacher_top_k_i"]))
            args = (labels, v, i, smask, T, alpha)
            if fused_loss:
                out = fused_sparse_kd_loss(acts, head, *args,
                                           chunk_size=loss_chunk_size,
                                           backend=fused_backend)
            elif fused_head:
                out = head_sparse_kd_loss(acts, head, *args)
            else:
                out = losses.sparse_distill_loss(acts, v, i, labels, smask,
                                                 T, alpha)
        leaves = tree_leaves(trainable)
        grads = torch.autograd.grad(out.total, leaves)
        metrics = {"loss": out.total, "student_loss": out.task,
                   "distill_loss": out.distill, "teacher_loss": out.teacher}
        return (tree_unflatten(trainable, list(grads)),
                {k: m.detach() for k, m in metrics.items()})

    if pp_1f1b is not None:
        loss_and_grad = pp_1f1b     # noqa: F811
    groups = _batch_groups(mesh)

    def step(state: TrainState, base: qwen3.Qwen3, teacher, batch: dict):
        batch = _batch_to(batch, dev)
        with comm.dp_denominators(*groups):
            grads, metrics = _accumulate(
                lambda tr, mb: loss_and_grad(tr, mb, base, teacher),
                state.trainable, batch)
        if mesh is None:
            metrics["grad_norm"] = global_norm(grads)
            updates, opt_state = optimizer.update(grads, state.opt_state,
                                                  state.trainable)
            trainable = apply_updates(state.trainable, updates,
                                      in_place=donate)
            return TrainState(trainable, opt_state, state.step + 1), metrics
        from speech_distill_tpu_torch.parallel import sharding
        specs = sharding.trainable_pspecs(state.trainable, student_cfg,
                                          use_lora, mesh)
        grads = sync_grads(grads, sharding.tp_partial(state.trainable,
                                                      use_lora), mesh)
        metrics = {k: comm.all_reduce_over(v, *groups)
                   for k, v in metrics.items()}
        g_norm = metrics["grad_norm"] = mesh_norm(grads, specs, mesh)
        if zero1:
            trainable, opt_state = zero1_update(optimizer, grads, state,
                                                specs, mesh, g_norm, donate)
        else:
            updates, opt_state = optimizer.update(
                grads, state.opt_state, state.trainable, g_norm=g_norm)
            trainable = apply_updates(state.trainable, updates,
                                      in_place=donate)
        return TrainState(trainable, opt_state, state.step + 1), metrics

    return step


def make_kd_eval_step(student_cfg: Qwen3Config, distill_cfg: DistillConfig,
                      *, mode: str,
                      teacher_forward: Optional[Callable] = None,
                      use_lora: bool = True, merge_weights: bool = False,
                      device="cuda", mesh=None):
    """Loss-only evaluation ``eval_step(trainable, base, teacher, batch) ->
    metrics``: the train step's losses through the plain head (the fp32
    [B, T, V] student logits, then ``sparse_distill_loss`` or
    ``dense_distill_loss``) under ``torch.no_grad``, each metric averaged
    over the batch's microbatch axis A. Online modes extract with
    ``losses.extract_top_k`` from the teacher's logits, as in JAX.
    ``mesh``: one rank of a dp x pp x sp x tp run (its dp rows, its
    slices; its positions under sp); the metrics are the global batch's on
    every rank."""
    dev = resolve_device(device if mesh is None else mesh.device)
    groups = _batch_groups(mesh)
    _check_mode(mode)
    lcfg = distill_cfg.lora
    T, alpha = distill_cfg.temperature, distill_cfg.alpha
    teacher_forward, _ = _teacher_routes(student_cfg, distill_cfg, mode,
                                         teacher_forward, None)

    def one(trainable, mb, base, teacher):
        split = _split(base, mb, mesh)
        if mode != "precomputed":
            t_out = _online_teacher(mode, student_cfg, distill_cfg,
                                    teacher_forward, None, teacher, mb)
            if split is not None:
                t_out = _local_teacher(t_out, teacher,
                                       mb["input_ids"].shape[1], split[0])
        st = _effective_student(trainable, lcfg, use_lora)
        logits = _student_forward(base, st, mb, merge_weights, False, dev)
        if split is not None:
            logits, mb, t_out = _presplit_loss_inputs(
                logits, split[1], t_out if mode != "precomputed" else None)
        labels, smask = mb["labels"], mb.get("speech_token_mask")
        if mode == "online_dense":
            out = losses.dense_distill_loss(logits, t_out, labels, smask, T,
                                            alpha)
        else:
            v, i = (t_out if mode == "online_sparse" else
                    (mb["teacher_top_k_v"], mb["teacher_top_k_i"]))
            out = losses.sparse_distill_loss(logits, v, i, labels, smask, T,
                                             alpha)
        return {"loss": out.total, "student_loss": out.task,
                "distill_loss": out.distill, "teacher_loss": out.teacher}

    @torch.no_grad()
    def eval_step(trainable: Params, base: qwen3.Qwen3, teacher,
                  batch: dict):
        batch = _batch_to(batch, dev)
        with comm.dp_denominators(*groups):
            ms = [one(trainable, {k: v[a] for k, v in batch.items()}, base,
                      teacher) for a in range(batch["input_ids"].shape[0])]
        return {k: comm.all_reduce_over(torch.stack([m[k] for m in ms])
                                        .mean(), *groups) for k in ms[0]}

    return eval_step


# ---------------------------------------------------------------------------
# Stage-1 warm-up: new-embedding-only training
# ---------------------------------------------------------------------------


def mask_new_token_grads(grads: Params, old_vocab_size: int) -> Params:
    """Zero the gradient rows below ``old_vocab_size`` of every leaf
    ({"embed": {"weight"}}, {"lm_head": {"weight"}}): only the new
    speech-token rows train (the reference's backward hooks)."""
    def mask_rows(g):
        rows = torch.arange(g.shape[0], device=g.device)[:, None]
        return torch.where(rows >= old_vocab_size, g, torch.zeros_like(g))
    return {key: {"weight": mask_rows(grads[key]["weight"])}
            for key in grads}


def _stage1_tables(trainable: Params):
    return (trainable["embed"]["weight"],
            trainable.get("lm_head", {}).get("weight"))


def _batch_to(batch: dict, dev) -> dict:
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def make_stage1_eval_step(cfg: Qwen3Config, device="cuda", mesh=None):
    """Loss-only stage-1 evaluation ``eval_step(trainable, base, batch)``:
    next-token CE over labels != -100 through the plain head (the fp32
    [B, T, V] logits are materialised, as in JAX). The batch carries the
    [A, B, T] microbatch axis; returns {"loss_sum", "n_tokens"} summed over
    it (sums, not means: the caller aggregates groups by their valid-token
    count, so the overall metric is the exact per-token mean). ``mesh``:
    one rank of a dp x sp run (its dp rows, its positions under sp); the
    sums are the global batch's on every rank."""
    dev = resolve_device(device if mesh is None else mesh.device)
    groups = _batch_groups(mesh)

    @torch.no_grad()
    def eval_step(trainable: Params, base: qwen3.Qwen3, batch: dict):
        embed, lm_head = _stage1_tables(trainable)
        batch = _batch_to(batch, dev)
        loss_sum = torch.zeros((), device=dev)
        n_tokens = torch.zeros((), device=dev)
        for a in range(batch["input_ids"].shape[0]):
            mb = {k: v[a] for k, v in batch.items()}
            logits = qwen3.forward_train(
                base, mb["input_ids"], attention_mask=mb["attention_mask"],
                embed=embed, lm_head=lm_head, return_hidden=False,
                device=dev)
            split = _split(base, mb, mesh)
            if split is not None:
                logits, mb, _ = _presplit_loss_inputs(logits, split[1], None)
            shift = mb["labels"][:, 1:]
            valid = (shift != losses.IGNORE_INDEX).float()
            ce = losses._ce_per_pos(logits[:, :-1, :], shift)
            del logits
            loss_sum += (ce * valid).sum()
            n_tokens += valid.sum()
        return {"loss_sum": comm.all_reduce_over(loss_sum, *groups),
                "n_tokens": comm.all_reduce_over(n_tokens, *groups)}

    return eval_step


def make_stage1_step(cfg: Qwen3Config, optimizer: Optimizer,
                     old_vocab_size: int, donate: bool = True,
                     fused_loss: bool = False, fused_backend: str = "xla",
                     device="cuda", mesh=None):
    """The stage-1 SFT step ``step(state, base, batch) -> (state,
    metrics)``: next-token CE over labels != -100 (TRL SFT semantics) with
    only ``state.trainable`` = {"embed": ..., ["lm_head": ...]} trained
    and the frozen ``base`` model read for everything else (no adapters).
    Gradients are accumulated over the batch's [A, B, T] microbatch axis,
    their rows below ``old_vocab_size`` zeroed, then the optimizer runs.

    ``fused_loss`` takes the CE from row statistics and never materialises
    the [B*T, V] logits (needed at the reference's seq 4096):
    ``fused_cross_entropy`` with ``fused_backend`` "xla" (the chunked
    plain route) or "pallas" (the K2 op). Metrics: loss, grad_norm (of the
    masked grads, before clipping).

    ``mesh``: one rank of a dp x sp run (tp 1, as the JAX CLI's stage-1
    mesh): its dp rows, its positions of each sequence under sp (a ring
    ``attn_impl``; the head, K2 on the card, on its B T / sp rows), the
    counts and the gradients summed over dp and sp.
    """
    dev = resolve_device(device if mesh is None else mesh.device)
    if fused_backend not in BACKENDS:
        raise ValueError(f"unknown fused_backend {fused_backend!r}")
    groups = _batch_groups(mesh)

    def loss_and_grad(trainable: Params, mb: dict, base: qwen3.Qwen3):
        embed, lm_head = _stage1_tables(trainable)
        acts = qwen3.forward_train(
            base, mb["input_ids"], attention_mask=mb["attention_mask"],
            embed=embed, lm_head=lm_head, return_hidden=fused_loss,
            device=dev)
        split = _split(base, mb, mesh)
        if split is not None:
            acts, mb, _ = _presplit_loss_inputs(acts, split[1], None)
        labels = mb["labels"]
        if fused_loss:
            head = qwen3.lm_head_weight(base, embed, lm_head)
            loss = fused_cross_entropy(acts, head, labels,
                                       backend=fused_backend)
        else:
            shift = labels[:, 1:]
            valid = (shift != losses.IGNORE_INDEX).float()
            ce = losses._ce_per_pos(acts[:, :-1, :], shift)
            loss = losses._masked_mean(ce, valid)
        leaves = tree_leaves(trainable)
        grads = torch.autograd.grad(loss, leaves)
        return tree_unflatten(trainable, list(grads)), {"loss": loss.detach()}

    def step(state: TrainState, base: qwen3.Qwen3, batch: dict):
        batch = _batch_to(batch, dev)
        with comm.dp_denominators(*groups):
            grads, metrics = _accumulate(
                lambda tr, mb: loss_and_grad(tr, mb, base), state.trainable,
                batch)
        if mesh is not None:
            grads = tree_map(lambda g: comm.all_reduce_over(g, *groups),
                             grads)
            metrics = {k: comm.all_reduce_over(v, *groups)
                       for k, v in metrics.items()}
        grads = mask_new_token_grads(grads, old_vocab_size)
        metrics["grad_norm"] = global_norm(grads)
        updates, opt_state = optimizer.update(grads, state.opt_state,
                                              state.trainable)
        trainable = apply_updates(state.trainable, updates, in_place=donate)
        return TrainState(trainable, opt_state, state.step + 1), metrics

    return step
