"""Qwen3 decoder in PyTorch (port of ``speech_distill_tpu/models/qwen3.py``).

GQA + per-head q/k RMSNorm + NeoX RoPE + SwiGLU, norms and softmax in
fp32. Two forwards: the serving :func:`forward` (no cache; or a
contiguous cache with per-row RoPE ``positions``, per-row write columns
``cache_positions`` and the layer-skip draft's ``num_layers``, under
``torch.no_grad``) and the grad-enabled :func:`forward_train` of the KD
step (embed and head overrides, unmerged LoRA adapters through
``ops/lora_linear``, per-layer activation checkpointing).

Sequence parallelism (a model whose ``model.mesh`` has sp > 1 and whose
``attn_impl`` is "ring" or "ring_zigzag"): both cache-less forwards take
the whole [B, T] sequence on every sp rank and compute only the rank's
positions (:func:`sequence_layout`: contiguous, or the zig-zag chunk
pair), with RoPE at those global positions and attention over the ring
(``ops/ring_attention``), no [B, 1, T, T] bias; they return that rank's
[B, T / sp, ...] in natural order (``sharding.gather_sequence`` makes the
whole). Pipeline parallelism (``cfg.pp_microbatches`` > 0 on a mesh with
pp > 1, the model holding its stage's layers): the stack runs GPipe over
pp (``parallel/pipeline.pipelined_layers``) and every stage gets the
output. The two do not nest (``ValueError``, as in JAX).

Tensor parallelism (a model from ``parallel/sharding.shard_params``: its
rank's slices under the global ``cfg``, ``model.mesh`` set): q/k/v and
gate/up are column-parallel over the local heads and MLP units, o and down
row-parallel followed by an all-reduce over tp, the embedding
vocab-parallel (rows outside the shard read zero, then an all-reduce) and
the lm head gives local vocab logits, gathered where a full row is needed
(``parallel/comm``; Megatron-LM's layout, JAX's ``param_pspecs``).
Attention runs the existing routes on the local heads.

Quantized weights (``ops/quant`` leaves: int4/int8/nf4 projections, an
int8 embed/head) sit where the dense weights sit, as :class:`QuantWeight`
modules holding buffers; :func:`deq` dequantizes them, a 2-D int4
projection goes through ``ops/quant_matmul`` (K3 on CUDA), and the int8
table is gathered before it is scaled.

Parameters keep the JAX layout of ``param_shapes`` with the layer axis
unstacked: matrices are [din, dout] and apply as ``x @ w``, so
:func:`speech_distill_tpu_torch.models.convert.params_from_jax` copies a
JAX pytree across leaf by leaf.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from speech_distill_tpu_torch.core.config import Qwen3Config, torch_dtype
from speech_distill_tpu_torch.core.device import resolve_device
from speech_distill_tpu_torch.ops.attention import (RING_IMPLS, sdpa,
                                                    use_flash)
from speech_distill_tpu_torch.ops.lora_linear import lora_linear
from speech_distill_tpu_torch.ops.matmul import matmul_f32
from speech_distill_tpu_torch.ops.quant import dequantize_array
from speech_distill_tpu_torch.ops.quant_matmul import quantized_matmul
from speech_distill_tpu_torch.parallel import comm

# per-layer LoRA factors: {group: {key: (a [din, r], b [r, dout])}}
LayerAdapters = Dict[str, Dict[str, Tuple[torch.Tensor, torch.Tensor]]]


def _weight(shape, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                        requires_grad=False)


class QuantWeight(nn.Module):
    """A quantized weight: the tensors of an ``ops/quant`` leaf (``q4`` /
    ``q8`` / ``nf4`` codes and their scales) as buffers, in the leaf's
    layout ([din/2, dout] packed int4, [din, dout] int8, ...)."""

    def __init__(self, leaf: Dict[str, torch.Tensor]):
        super().__init__()
        for name, t in leaf.items():
            self.register_buffer(name, t)

    @property
    def leaf(self) -> Dict[str, torch.Tensor]:
        """The leaf's tensors by name (the module's own buffer dict, read
        on every projection, so not copied)."""
        return self._buffers


def deq(w, dtype=torch.bfloat16) -> torch.Tensor:
    """Weight accessor: a tensor passes through, a :class:`QuantWeight` is
    dequantized to ``dtype`` (the JAX ``deq``)."""
    if isinstance(w, QuantWeight):
        return dequantize_array(w.leaf, dtype)
    return w


def attn_names(cfg: Qwen3Config) -> Tuple[str, ...]:
    """The attention leaves of a layer, as the JAX ``param_shapes`` names
    them: the projections, the q/k norms (``qk_norm``) and the q/k/v
    biases (``attention_bias``, the Qwen2 backbones)."""
    names = ("q", "k", "v", "o")
    if cfg.qk_norm:
        names += ("q_norm", "k_norm")
    if cfg.attention_bias:
        names += ("q_bias", "k_bias", "v_bias")
    return names


class Attention(nn.Module):
    def __init__(self, cfg: Qwen3Config, device, dtype):
        super().__init__()
        D, QD, KVD, Dh = (cfg.hidden_size, cfg.q_dim, cfg.kv_dim,
                          cfg.head_dim)
        self.q = _weight((D, QD), device, dtype)
        self.k = _weight((D, KVD), device, dtype)
        self.v = _weight((D, KVD), device, dtype)
        self.o = _weight((QD, D), device, dtype)
        if cfg.qk_norm:
            self.q_norm = _weight((Dh,), device, dtype)
            self.k_norm = _weight((Dh,), device, dtype)
        if cfg.attention_bias:
            self.q_bias = _weight((QD,), device, dtype)
            self.k_bias = _weight((KVD,), device, dtype)
            self.v_bias = _weight((KVD,), device, dtype)


class MLP(nn.Module):
    def __init__(self, cfg: Qwen3Config, device, dtype):
        super().__init__()
        D, F = cfg.hidden_size, cfg.intermediate_size
        self.gate = _weight((D, F), device, dtype)
        self.up = _weight((D, F), device, dtype)
        self.down = _weight((F, D), device, dtype)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: Qwen3Config, device, dtype):
        super().__init__()
        self.input_ln = _weight((cfg.hidden_size,), device, dtype)
        self.attn = Attention(cfg, device, dtype)
        self.post_ln = _weight((cfg.hidden_size,), device, dtype)
        self.mlp = MLP(cfg, device, dtype)


class Qwen3(nn.Module):
    """The decoder's weights (uninitialised until :func:`init_params` or
    ``params_from_jax`` fills them). ``device`` defaults to CUDA and
    raises without it."""

    def __init__(self, cfg: Qwen3Config, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        dtype = cfg.torch_dtype
        self.cfg = cfg
        self.embed = _weight((cfg.vocab_size, cfg.hidden_size), device,
                             dtype)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, device, dtype)
            for _ in range(cfg.num_hidden_layers))
        self.final_ln = _weight((cfg.hidden_size,), device, dtype)
        self.lm_head = (None if cfg.tie_word_embeddings else
                        _weight((cfg.vocab_size, cfg.hidden_size), device,
                                dtype))
        # the tensor-parallel mesh of a sharded model (None: whole)
        self.mesh = None

    @property
    def device(self) -> torch.device:
        return self.final_ln.device          # never quantized

    def forward(self, input_ids, **kw):
        return forward(self, input_ids, **kw)


def tp_group(model: Qwen3):
    """The tp process group of a sharded model; None when whole."""
    mesh = getattr(model, "mesh", None)
    return mesh.group("tp") if mesh is not None else None


def param_pspecs(cfg: Qwen3Config, pp: bool = False) -> dict:
    """Specs matching the JAX ``init_params`` tree (the JAX
    ``param_pspecs``): tp shards the vocab dim of embed / lm_head, the
    head dim of q/k/v (and their biases), the MLP hidden dim; the layer
    axis leads with None, or with "pp" for a pipelined model (in
    interleaved chunk order under ``cfg.pp_interleave``:
    ``sharding.Interleaved``)."""
    lead = "pp" if pp else None
    attn = {"q": (lead, None, "tp"), "k": (lead, None, "tp"),
            "v": (lead, None, "tp"), "o": (lead, "tp", None)}
    if cfg.qk_norm:
        attn["q_norm"] = (lead, None)
        attn["k_norm"] = (lead, None)
    if cfg.attention_bias:
        attn["q_bias"] = (lead, "tp")
        attn["k_bias"] = (lead, "tp")
        attn["v_bias"] = (lead, "tp")
    specs = {
        "embed": {"weight": ("tp", None)},
        "layers": {
            "input_ln": {"scale": (lead, None)},
            "attn": attn,
            "post_ln": {"scale": (lead, None)},
            "mlp": {"gate": (lead, None, "tp"), "up": (lead, None, "tp"),
                    "down": (lead, "tp", None)},
        },
        "final_ln": {"scale": (None,)},
    }
    if pp and cfg.pp_interleave > 1:
        from speech_distill_tpu_torch.core.tree import tree_map
        from speech_distill_tpu_torch.parallel.sharding import Interleaved
        specs["layers"] = tree_map(
            lambda sp: Interleaved(sp, cfg.pp_interleave), specs["layers"])
    if not cfg.tie_word_embeddings:
        specs["lm_head"] = {"weight": ("tp", None)}
    return specs


def _numpy_init_tree(cfg: Qwen3Config, seed: int) -> dict:
    """The JAX ``init_params`` pytree as float32 numpy, drawn from the same
    numpy generator in the same (sorted-key) leaf order: normal(0, 0.02)
    matrices, ones for norm scales, zeros for the q/k/v biases (drawn from
    nothing), stacked [L, ...] per layer leaf."""
    rng = np.random.default_rng(seed)
    L, D, F = cfg.num_hidden_layers, cfg.hidden_size, cfg.intermediate_size
    QD, KVD, Dh, V = cfg.q_dim, cfg.kv_dim, cfg.head_dim, cfg.vocab_size

    def w(*shape):
        return rng.normal(0.0, 0.02, shape).astype(np.float32)

    def one(*shape):
        return np.ones(shape, np.float32)

    tree = {"embed": {"weight": w(V, D)}, "final_ln": {"scale": one(D)}}
    attn = {"k": w(L, D, KVD), "o": w(L, QD, D), "q": w(L, D, QD),
            "v": w(L, D, KVD)}
    if cfg.qk_norm:
        attn.update(q_norm=one(L, Dh), k_norm=one(L, Dh))
    if cfg.attention_bias:
        attn.update(q_bias=np.zeros((L, QD), np.float32),
                    k_bias=np.zeros((L, KVD), np.float32),
                    v_bias=np.zeros((L, KVD), np.float32))
    tree["layers"] = {
        "attn": attn,
        "input_ln": {"scale": one(L, D)},
        "mlp": {"down": w(L, F, D), "gate": w(L, D, F), "up": w(L, D, F)},
        "post_ln": {"scale": one(L, D)},
    }
    if not cfg.tie_word_embeddings:
        tree["lm_head"] = {"weight": w(V, D)}
    return tree


def init_params(cfg: Qwen3Config, seed: int = 0, device="cuda") -> Qwen3:
    """Random init seeded from numpy: the same weights as the JAX
    ``init_params(jax.random.PRNGKey(seed), cfg)``."""
    from speech_distill_tpu_torch.models.convert import params_from_jax
    return params_from_jax(_numpy_init_tree(cfg, seed), cfg, device)


@torch.no_grad()
def init_params_on_device(seed: int, cfg: Qwen3Config, device="cuda"
                          ) -> Qwen3:
    """Random init drawn on ``device`` (CUDA by default; raises without it)
    from a seeded ``torch.Generator`` there: normal(0, 0.02) matrices,
    ones for the norm scales and zeros for the q/k/v biases, in the
    model's dtype. A full-size teacher's weights never cross the host. The
    stream is torch's, so the weights differ from the JAX
    ``init_params_on_device``'s for the same seed."""
    model = Qwen3(cfg, device)
    gen = torch.Generator(device=model.device).manual_seed(seed)
    for name, p in model.named_parameters():
        if name.endswith("_bias"):
            p.zero_()
        elif p.dim() == 1:
            p.fill_(1.0)
        else:
            p.normal_(0.0, 0.02, generator=gen)
    return model


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------


def vocab_lookup(table: torch.Tensor, input_ids: torch.Tensor, group
                 ) -> torch.Tensor:
    """Embedding rows of ``input_ids``; with a tp ``group`` ``table`` is
    this rank's vocab shard: ids outside it read zero, and the all-reduce
    over tp (identity backward) sums the shards' rows."""
    if group is None:
        return F.embedding(input_ids, table)
    n = table.shape[0]
    local = input_ids - comm._index(group) * n
    inside = (local >= 0) & (local < n)
    rows = F.embedding(local.clamp(0, n - 1), table)
    return comm.reduce_from_tp(
        torch.where(inside[..., None], rows, torch.zeros_like(rows)), group)


def embed_tokens(model: Qwen3, input_ids: torch.Tensor) -> torch.Tensor:
    """Token embedding lookup; an int8 table gathers its rows first and
    scales only them (per-column scale [1, D]) in the model dtype. A
    tensor-parallel model looks up its vocab shard (:func:`vocab_lookup`).
    """
    table = model.embed
    if isinstance(table, QuantWeight):
        dt = model.cfg.torch_dtype
        return table.q8[input_ids].to(dt) * table.scale[0].to(dt)
    group = tp_group(model)
    if group is not None:
        return vocab_lookup(table, input_ids, group)
    return table[input_ids]


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [..., T, head_dim] in NeoX half-rotation layout."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    freq = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * freq
    ang = torch.cat([ang, ang], dim=-1)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: [B, T, N, Dh]; cos/sin: [B, T, Dh] or [T, Dh]; math in fp32."""
    if cos.dim() == 2:
        cos, sin = cos[None], sin[None]
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    half = x.shape[-1] // 2
    xf = x.float()
    rotated = torch.cat([-xf[..., half:], xf[..., :half]], dim=-1)
    return (xf * cos + rotated * sin).to(x.dtype)


def _proj(x: torch.Tensor, w, la: Optional[dict], key: str,
          scale: float, merge: bool) -> torch.Tensor:
    """Projection with optional LoRA (counterpart of the JAX ``_proj``):
    through :func:`lora_linear` (merged forward, skinny backward), or with
    ``merge`` as a plain product with the merged weight, differentiated by
    autograd (the JAX ``merge_weights=True`` path). A quantized weight is
    dequantized to x.dtype, except a 2-D int4 weight on the route of
    ``ops/quant_matmul.int4_route`` (on CUDA: K3, the JAX TPU branch)."""
    if la is None or key not in la:
        if isinstance(w, QuantWeight):
            return quantized_matmul(x, w.leaf)
        return x @ w
    w = deq(w, x.dtype)
    a, b = la[key]
    if merge:
        return x @ (w + (matmul_f32(a, b) * scale).to(w.dtype))
    return lora_linear(x, w, a, b, scale)


def qkv_proj(attn: Attention, x: torch.Tensor, cos, sin, cfg: Qwen3Config,
             la: Optional[dict] = None, scale: float = 1.0,
             merge: bool = False):
    """Project (+ bias) + qk-norm + rope: x [B, T, D] -> q [B, T, H, Dh],
    k/v [B, T, KV, Dh] (a tp rank's own heads: H and KV follow the
    weights). The Qwen2 biases add after the projection, LoRA's delta
    included; a Qwen2 backbone has no q/k norm. Shared with the paged
    decode step."""
    B, T, _ = x.shape
    Dh = cfg.head_dim
    q = _proj(x, attn.q, la, "q", scale, merge)
    k = _proj(x, attn.k, la, "k", scale, merge)
    v = _proj(x, attn.v, la, "v", scale, merge)
    if cfg.attention_bias:
        q, k, v = q + attn.q_bias, k + attn.k_bias, v + attn.v_bias
    q = q.reshape(B, T, -1, Dh)
    k = k.reshape(B, T, -1, Dh)
    v = v.reshape(B, T, -1, Dh)
    if cfg.qk_norm:
        q = rms_norm(q, attn.q_norm, cfg.rms_norm_eps)
        k = rms_norm(k, attn.k_norm, cfg.rms_norm_eps)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def mlp_block(mlp: MLP, y: torch.Tensor, la: Optional[dict] = None,
              scale: float = 1.0, merge: bool = False) -> torch.Tensor:
    """Gated MLP on the already-normed input, SiLU in fp32."""
    g = F.silu(_proj(y, mlp.gate, la, "gate", scale, merge).float()
               ).to(y.dtype)
    return _proj(g * _proj(y, mlp.up, la, "up", scale, merge), mlp.down,
                 la, "down", scale, merge)


@dataclass
class KVCache:
    """Contiguous prefill cache [L, B, S_max, KV, Dh] + tokens written.
    Updated in place (the JAX cache is immutable and returned anew)."""

    k: torch.Tensor
    v: torch.Tensor
    length: int = 0

    @classmethod
    def create(cls, cfg: Qwen3Config, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> "KVCache":
        shape = (cfg.num_hidden_layers, batch, max_len,
                 cfg.num_key_value_heads, cfg.head_dim)
        device = resolve_device(device)
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device), 0)


def _bias(keep: torch.Tensor) -> torch.Tensor:
    """Boolean keep mask -> additive fp32 bias (0 keep, -inf drop)."""
    return torch.zeros(keep.shape, dtype=torch.float32,
                       device=keep.device).masked_fill(~keep, -float("inf"))


def causal_bias(attention_mask: Optional[torch.Tensor], B: int, T: int,
                device) -> torch.Tensor:
    """[B, 1, T, T] additive fp32 bias: 0 keep, -inf drop."""
    pos = torch.arange(T, device=device)
    keep = (pos[None, :] <= pos[:, None]).expand(B, 1, T, T)
    if attention_mask is not None:
        keep = keep & attention_mask.bool()[:, None, None, :]
    return _bias(keep)


def o_proj_and_mlp(layer: DecoderLayer, x, o, cfg: Qwen3Config,
                   la: Optional[LayerAdapters] = None, scale: float = 1.0,
                   merge: bool = False, tp=None):
    """Residual adds around the o-projection and the MLP. With a tp
    group both row-parallel products are summed over tp, and the MLP's
    normed input is marked replicated (:func:`comm.copy_to_tp`)."""
    B, T = x.shape[:2]
    la_attn = la.get("attn") if la is not None else None
    la_mlp = la.get("mlp") if la is not None else None
    x = x + comm.reduce_from_tp(_proj(o.reshape(B, T, -1), layer.attn.o,
                                      la_attn, "o", scale, merge), tp)
    y = comm.copy_to_tp(rms_norm(x, layer.post_ln, cfg.rms_norm_eps), tp)
    return x + comm.reduce_from_tp(mlp_block(layer.mlp, y, la_mlp, scale,
                                             merge), tp)


def layer_forward(layer: DecoderLayer, x: torch.Tensor, cos, sin,
                  mask_bias, cfg: Qwen3Config,
                  la: Optional[LayerAdapters] = None, scale: float = 1.0,
                  merge: bool = False, tp=None, sp=None,
                  zigzag: bool = False) -> torch.Tensor:
    """One decoder layer without a cache (the JAX ``_layer``), with
    optional per-layer LoRA factors, on a tp rank's heads under ``tp``;
    ``sp``: the mesh whose sp ring the ring routes take, on this rank's
    zig-zag chunk pair with ``zigzag`` (:func:`sequence_layout`)."""
    y = comm.copy_to_tp(rms_norm(x, layer.input_ln, cfg.rms_norm_eps), tp)
    q, k, v = qkv_proj(layer.attn, y, cos, sin, cfg,
                       la.get("attn") if la is not None else None, scale,
                       merge)
    return o_proj_and_mlp(layer, x, sdpa(q, k, v, mask_bias, cfg.attn_impl,
                                         sp, zigzag), cfg, la, scale, merge,
                          tp)


def sequence_layout(model, T: int, device=None):
    """(positions, zigzag) of this sp rank's share of a length-T sequence
    when the cache-less forward splits it: a ring ``attn_impl`` on a mesh
    whose sp axis has more than one rank and divides T (the JAX
    ``ring_available``); the zig-zag pair for "ring_zigzag" where T splits
    into 2 sp chunks, else contiguous. None when the forward runs the
    whole sequence (JAX then builds the bias). The one place the layout
    is decided: the forwards, the steps' targets, the online teacher and
    extraction all read it. ``model``: a :class:`Qwen3`, or a model
    holding one as ``backbone`` (the CosyVoice2 teacher)."""
    from speech_distill_tpu_torch.ops import ring_attention as ra
    model = getattr(model, "backbone", model)
    cfg, mesh = model.cfg, getattr(model, "mesh", None)
    if cfg.attn_impl not in RING_IMPLS or not ra.ring_available(mesh, T):
        return None
    zz = cfg.attn_impl == "ring_zigzag" and ra.zigzag_available(mesh, T)
    return ra.local_positions(T, mesh, zz, device), zz


def pipelined(model: Qwen3) -> bool:
    """Whether the model's cache-less forward pipelines its stack over pp
    (``sharding.pp_sharded`` on ``model.mesh``)."""
    from speech_distill_tpu_torch.parallel.sharding import pp_sharded
    return pp_sharded(model.cfg, getattr(model, "mesh", None))


REMAT_POLICIES = ("full", "dots", "half", "everything")
# the matrix products whose outputs "dots" keeps (the JAX checkpoint_dots:
# every dot_general); what the products' wrappers compute around them, and
# a kernel launched from an autograd.Function (K1-fwd, not an aten op, as
# JAX's Pallas call is not a dot), runs again in the backward
DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
           torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default)


def _save_dots():
    from torch.utils.checkpoint import create_selective_checkpoint_contexts
    return create_selective_checkpoint_contexts(list(DOT_OPS))


def _checkpointed(fn, dots: bool = False):
    def run(*args):
        if dots:
            return checkpoint(fn, *args, use_reentrant=False,
                              context_fn=_save_dots)
        return checkpoint(fn, *args, use_reentrant=False)
    return run


def layer_runners(cfg: Qwen3Config, n: int, remat: bool) -> list:
    """Each of ``n`` layers' forward under ``cfg.remat_policy`` (JAX
    ``models/qwen3.py:554-619``): "full" checkpoints the layer (all of it
    runs again in the backward); "dots" keeps the outputs of its matrix
    products (:data:`DOT_OPS`, selective checkpointing) and recomputes the
    rest; "half" checkpoints the first ``n // 2`` layers fully and saves
    everything for the others; "everything" saves every residual, the
    same as no checkpoint (``remat`` False)."""
    policy = cfg.remat_policy
    if policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {policy!r} "
                         f"({REMAT_POLICIES})")
    if not remat or policy == "everything":
        return [layer_forward] * n
    if policy == "half":
        return ([_checkpointed(layer_forward)] * (n // 2)
                + [layer_forward] * (n - n // 2))
    return [_checkpointed(layer_forward, dots=policy == "dots")] * n


def _stack(model: Qwen3, layers, x, cos, sin, mask_bias, layout, *,
           adapters=None, scale: float = 1.0, merge: bool = False,
           weights: Optional[dict] = None, remat: bool = False):
    """The decoder stack of the cache-less forwards: each layer in turn
    (checkpointed with ``remat`` under ``cfg.remat_policy``,
    :func:`layer_runners`), the ring over sp with a ``layout``, or GPipe
    over pp for a pipelined model. ``adapters`` (stacked LoRA factors) or
    ``weights["layers"]`` (full finetuning) are this stage's and ride the
    pipeline as its trainable leaves."""
    cfg, tp = model.cfg, tp_group(model)
    sp = model.mesh if layout is not None else None
    zigzag = layout is not None and layout[1]
    if not pipelined(model):
        per_layer = _layer_adapters(adapters, len(layers))
        runners = layer_runners(cfg, len(layers), remat)
        for run, layer, la in zip(runners, layers, per_layer):
            x = run(layer, x, cos, sin, mask_bias, cfg, la, scale, merge, tp,
                    sp, zigzag)
        return x
    if layout is not None:
        raise ValueError("ring attention (sp) and pipeline (pp) cannot "
                         "nest; use one of them")
    from speech_distill_tpu_torch.core.tree import tree_leaves
    from speech_distill_tpu_torch.parallel.pipeline import pipelined_layers
    src = weights["layers"] if weights is not None else adapters
    M, V = cfg.pp_microbatches, max(cfg.pp_interleave, 1)
    Lc = len(layers) // V
    run = stage_chunk_fn(model, src, cos, sin, mask_bias, x.shape[0] // M,
                         Lc, full_ft=weights is not None, scale=scale,
                         merge=merge)

    def run_chunk(v, h, m, leaves):   # GPipe gives a chunk the whole leaves
        return run(v, h, m, [t[v * Lc:(v + 1) * Lc] for t in leaves])
    leaves = tree_leaves(src) if src is not None else []
    return pipelined_layers(run_chunk, x, model.mesh, M, leaves, V)


def stage_chunk_fn(model: Qwen3, src: Optional[dict], cos, sin, mask_bias,
                   mb: int, Lc: int, *, full_ft: bool, scale: float = 1.0,
                   merge: bool = False) -> Callable:
    """``run_chunk(v, h, m, leaves)`` of the pipeline schedules
    (``parallel/pipeline.py``): this stage's chunk ``v`` (its local layers
    [v Lc, (v + 1) Lc)) applied to microbatch ``m``'s activations ``h``
    (rows [m mb, (m + 1) mb) of ``cos`` / ``sin`` / ``mask_bias``).
    ``leaves`` are the chunk's slices of the leaves of ``src``: stacked
    LoRA factors, or with ``full_ft`` the JAX-layout stacked layer tree
    read in place of the model's layers; ``src`` None is a frozen stack."""
    from speech_distill_tpu_torch.core.tree import tree_unflatten
    cfg, tp = model.cfg, tp_group(model)

    def run_chunk(v, h, m, leaves):
        rows = slice(m * mb, (m + 1) * mb)
        tree = (tree_unflatten(src, list(leaves)) if src is not None
                else None)
        if full_ft:
            lays, per = _layer_views(tree, Lc), [None] * Lc
        else:
            lays = model.layers[v * Lc:(v + 1) * Lc]
            per = _layer_adapters(tree, Lc)
        for layer, la in zip(lays, per):
            h = layer_forward(layer, h, cos[rows], sin[rows],
                              mask_bias[rows], cfg, la, scale, merge, tp)
        return h
    return run_chunk


def _check_flash_prefill(attention_mask: Optional[torch.Tensor],
                         start: int) -> None:
    """The flash route of a cache prefill (T == S) applies causality from
    column 0 and ignores the mask: exact only for a fresh cache (``start``
    0) with right padding (every row's keep mask a run of ones from
    column 0). Raises otherwise; costs one host read of the mask."""
    if start != 0:
        raise ValueError(f"flash prefill at cache column {start}: the "
                         f"kernel's causality starts at column 0")
    if attention_mask is not None:
        m = attention_mask.bool()
        if bool((m[:, 1:] & ~m[:, :-1]).any()):
            raise ValueError("flash prefill with a left-padded mask: the "
                             "kernel assumes right padding")


@torch.no_grad()
def forward(model: Qwen3, input_ids: torch.Tensor, *,
            attention_mask: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None,
            cache: Optional[KVCache] = None,
            cache_positions: Optional[torch.Tensor] = None,
            num_layers: Optional[int] = None,
            inputs_embeds: Optional[torch.Tensor] = None,
            return_hidden: bool = False):
    """Run the decoder.

    ``cache=None``: full causal attention over [B, T]. With a
    :class:`KVCache`, ``input_ids`` is the fresh chunk appended at
    ``cache.length`` (prefill on top of a gathered prefix, or a decode
    step); ``attention_mask`` then covers the full cache window [B, S]
    and queries see keys at columns <= their own. ``positions`` [B, T]:
    per-row RoPE positions (left-padded rows count real tokens, not
    columns); default ``cache.length + t`` (``t`` without a cache).
    ``cache_positions`` [B]: per-row write columns instead of
    ``cache.length`` (the continuous-batching slots; T must be 1), each
    row's query at its own column; RoPE defaults to that column.
    ``num_layers`` (cache path only): run the first K layers, then the
    final norm and head (the layer-skip draft); layers < K write exactly
    what a full forward writes, layers >= K keep their cache contents.
    ``inputs_embeds`` [B, T, D] replaces the embedding lookup
    (``input_ids`` is then unused and may be None), as the CosyVoice2
    teacher's unified table needs. Without a cache the forward may split
    the sequence over sp or pipeline the stack over pp (see the module
    docstring): it then embeds and returns only this sp rank's positions
    (:func:`sequence_layout`).

    The cache is updated in place; the returned :class:`KVCache` shares
    its tensors with length ``cache.length + T`` (callers may rewind it
    to the real end of a padded prefill). A T == S call on CUDA takes
    the flash kernel (``ops/attention.use_flash``), which is exact only
    for a fresh right-padded cache, and is checked to be one.

    Returns logits [B, T, V] (``cfg.logits_dtype``) or hidden states with
    ``return_hidden``, plus the updated cache when one was given.
    """
    cfg = model.cfg
    tp = tp_group(model)
    x = input_ids if inputs_embeds is None else inputs_embeds
    B, T = x.shape[:2]
    dev = model.device if inputs_embeds is None else x.device
    if cache is None:
        if num_layers is not None or cache_positions is not None:
            raise NotImplementedError(
                "num_layers and cache_positions are cache-path features")
        if positions is None:
            positions = torch.arange(T, device=dev)[None].expand(B, T)
        layout = sequence_layout(model, T, dev)
        mask_bias = None
        if layout is not None:        # this rank's positions, ids or rows
            x = x.index_select(1, layout[0].to(x.device))
            positions = positions[:, layout[0]]
        else:
            mask_bias = causal_bias(attention_mask, B, T, dev)
        if inputs_embeds is None:
            x = embed_tokens(model, x)
        cos, sin = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
        x = _stack(model, model.layers, x, cos, sin, mask_bias, layout)
    else:
        if inputs_embeds is None:
            x = embed_tokens(model, x)
        S, start = cache.k.shape[2], cache.length
        k_pos = torch.arange(S, device=dev)
        if cache_positions is not None:
            if T != 1:
                raise ValueError("cache_positions requires T == 1")
            cols = cache_positions.long()
            q_cols = cols[:, None]                              # [B, 1]
            if positions is None:
                positions = q_cols
            rows = torch.arange(B, device=dev)
        else:
            q_cols = (start + torch.arange(T, device=dev))[None]  # [1, T]
            if positions is None:
                positions = q_cols.expand(B, T)
        cos, sin = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
        # keys live at absolute columns [0, S); each query at its column
        keep = (k_pos[None, None, :] <= q_cols[:, :, None])[:, None]
        keep = keep.expand(B, 1, T, S)
        if attention_mask is not None:
            keep = keep & attention_mask.bool()[:, None, None, :]
        mask_bias = _bias(keep)
        layers = model.layers if num_layers is None else \
            model.layers[:num_layers]
        for li, layer in enumerate(layers):
            y = rms_norm(x, layer.input_ln, cfg.rms_norm_eps)
            q, k, v = qkv_proj(layer.attn, y, cos, sin, cfg)
            if cache_positions is not None:
                cache.k[li, rows, cols] = k[:, 0].to(cache.k.dtype)
                cache.v[li, rows, cols] = v[:, 0].to(cache.v.dtype)
            else:
                cache.k[li, :, start:start + T] = k
                cache.v[li, :, start:start + T] = v
            # read back in the compute dtype (an fp32 cache never promotes
            # the hidden state)
            ck, cv = cache.k[li].to(q.dtype), cache.v[li].to(q.dtype)
            if li == 0 and use_flash(q, ck, cfg.attn_impl):
                _check_flash_prefill(attention_mask, start)
            x = o_proj_and_mlp(layer, x, sdpa(q, ck, cv, mask_bias,
                                              cfg.attn_impl), cfg, tp=tp)
        cache = KVCache(cache.k, cache.v, start + T)
    x = rms_norm(x, model.final_ln, cfg.rms_norm_eps)
    out = x if return_hidden else unembed(model, x)
    return out if cache is None else (out, cache)


def _layer_adapters(adapters: Optional[dict], L: int
                    ) -> List[Optional[LayerAdapters]]:
    """Split stacked adapters {group: {key: {"a": [L, din, r],
    "b": [L, r, dout]}}} into one per-layer dict of (a, b) views. One
    ``unbind`` per leaf, so the backward stacks each leaf's gradient
    once."""
    if adapters is None:
        return [None] * L
    out: List[LayerAdapters] = [{} for _ in range(L)]
    for group, mods in adapters.items():
        for key, ab in mods.items():
            for i, pair in enumerate(zip(ab["a"].unbind(0),
                                         ab["b"].unbind(0))):
                out[i].setdefault(group, {})[key] = pair
    return out


class _LayerView:
    """One layer's weights read from stacked [L, ...] leaves, with the
    attribute names of :class:`DecoderLayer` (what :func:`layer_forward`
    reads)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def _layer_views(layers: dict, L: int) -> List[_LayerView]:
    """Per-layer views of a JAX-layout stacked layer tree ({"attn": {q, k,
    v, o, [q_norm, k_norm], [q_bias, k_bias, v_bias]}, "mlp": {gate, up,
    down}, "input_ln": {"scale"},
    "post_ln": {"scale"}}). One ``unbind`` per leaf, so the backward
    stacks each leaf's gradient once."""
    def split(group):
        return {k: t.unbind(0) for k, t in group.items()}
    attn, mlp = split(layers["attn"]), split(layers["mlp"])
    ln_in = layers["input_ln"]["scale"].unbind(0)
    ln_post = layers["post_ln"]["scale"].unbind(0)
    return [_LayerView(input_ln=ln_in[i], post_ln=ln_post[i],
                       attn=_LayerView(**{k: v[i] for k, v in attn.items()}),
                       mlp=_LayerView(**{k: v[i] for k, v in mlp.items()}))
            for i in range(L)]


def forward_train(model: Qwen3, input_ids, *, attention_mask=None,
                  embed: Optional[torch.Tensor] = None,
                  lm_head: Optional[torch.Tensor] = None,
                  adapters: Optional[dict] = None,
                  adapter_scale: float = 1.0,
                  merge_adapters: bool = False,
                  weights: Optional[dict] = None,
                  return_hidden: bool = True, device="cuda"):
    """Grad-enabled forward of the training step (the JAX ``forward`` with
    ``cache=None``).

    ``embed`` / ``lm_head`` replace the model's tables (the trainable
    copies; a tied head reads ``embed``). ``adapters`` are stacked LoRA
    factors shaped like the JAX ``lora_params["layers"]``, applied with
    ``adapter_scale`` through :func:`lora_linear`, or merged into the
    weights with ``merge_adapters``. ``weights`` (full finetuning) is a
    JAX-layout tree of every weight ({"embed", "final_ln", "layers"
    stacked [L, ...], ["lm_head"]}) read in place of the model's own; the
    model then gives only its config. With ``cfg.remat`` the layers are
    checkpointed (``torch.utils.checkpoint``, non-reentrant) under
    ``cfg.remat_policy`` (:func:`layer_runners`: "full", "dots", "half",
    "everything"); the values do not depend on it. Returns the
    final-normed hidden states [B, T, D], or fp32 logits through
    :func:`unembed_train`. A
    tensor-parallel model (``model.mesh``) reads its rank's slices of
    every table (``embed`` / ``lm_head`` / ``weights`` too) and returns
    the whole hidden states, or the whole logits (gathered over tp). On
    an sp ring it returns this rank's positions (:func:`sequence_layout`);
    pipelined over pp, GPipe with each microbatch's stage forward run again
    in the backward (full remat, whatever ``cfg.remat`` and its policy;
    JAX's GPipe checkpoints its layer body under the policy: "dots" keeps
    the products' outputs, "everything" every residual, "full" and "half"
    nothing, and with ``remat`` False it saves everything).

    Runs on ``device`` (CUDA by default; raises without it), where the
    model must live.
    """
    dev = resolve_device(device)
    if model.device != dev:
        raise ValueError(f"model is on {model.device}, not {dev}")
    cfg = model.cfg
    input_ids = torch.as_tensor(input_ids, device=dev).long()
    if attention_mask is not None:
        attention_mask = torch.as_tensor(attention_mask, device=dev)
    B, T = input_ids.shape
    layers, final_ln = model.layers, model.final_ln
    if weights is not None:
        if adapters is not None:
            raise ValueError("weights (full finetuning) and adapters")
        embed = weights["embed"]["weight"]
        lm_head = weights.get("lm_head", {}).get("weight")
        layers = _layer_views(weights["layers"], len(model.layers))
        final_ln = weights["final_ln"]["scale"]
    table = model.embed if embed is None else embed
    tp = tp_group(model)
    positions = torch.arange(T, device=dev)[None].expand(B, T)
    layout = sequence_layout(model, T, dev)
    mask_bias = None
    if layout is not None:
        input_ids, positions = input_ids[:, layout[0]], positions[:, layout[0]]
    else:
        mask_bias = causal_bias(attention_mask, B, T, dev)
    x = vocab_lookup(table, input_ids, tp)
    cos, sin = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    x = _stack(model, layers, x, cos, sin, mask_bias, layout,
               adapters=adapters, scale=adapter_scale, merge=merge_adapters,
               weights=weights, remat=cfg.remat)
    x = rms_norm(x, final_ln, cfg.rms_norm_eps)
    if return_hidden:
        return x
    return comm.gather_from_tp(
        unembed_train(comm.copy_to_tp(x, tp),
                      lm_head_weight(model, embed, lm_head), cfg), tp)


class _Unembed(torch.autograd.Function):
    """hidden @ w^T with fp32 logits; the backward casts d_logits to
    ``bwd_dtype`` before both transpose products (accumulated in fp32), as
    the JAX ``_unembed_mm``. With ``bwd_dtype`` fp32 it is the exact
    gradient of the fp32 logits."""

    @staticmethod
    def forward(ctx, hidden, w, bwd_dtype):
        ctx.save_for_backward(hidden, w)
        ctx.bwd_dtype = bwd_dtype
        return matmul_f32(hidden, w.t())

    @staticmethod
    def backward(ctx, g):
        hidden, w = ctx.saved_tensors
        bd = ctx.bwd_dtype
        gb = g.to(bd)
        dh = matmul_f32(gb, w.to(bd)).to(hidden.dtype)
        g2 = gb.reshape(-1, g.shape[-1])
        h2 = hidden.reshape(-1, hidden.shape[-1]).to(bd)
        dw = matmul_f32(g2.t(), h2).to(w.dtype)
        return dh, dw, None


def unembed_train(hidden: torch.Tensor, w: torch.Tensor,
                  cfg: Qwen3Config) -> torch.Tensor:
    """Differentiable lm-head product, logits in ``cfg.logits_dtype``
    (fp32), backward in ``cfg.head_bwd_dtype``."""
    out = _Unembed.apply(hidden, w, torch_dtype(cfg.head_bwd_dtype))
    return out.to(cfg.torch_logits_dtype)


def flops_per_token(cfg: Qwen3Config, seq_len: int) -> float:
    """Approximate forward FLOPs a token (2 N matmul + attention term),
    the JAX ``flops_per_token``."""
    D, Fd, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    QD, KVD = cfg.q_dim, cfg.kv_dim
    per_layer = 2 * (D * QD + 2 * D * KVD + QD * D + 3 * D * Fd)
    attn = 2 * 2 * QD * seq_len
    return L * (per_layer + attn) + 2 * D * cfg.vocab_size


def lm_head_weight(model: Qwen3, embed: Optional[torch.Tensor] = None,
                   lm_head: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[V, D] unembedding matrix: the ``lm_head`` override, else the
    model's own head, else (tied) the ``embed`` override or the model's
    table. A quantized table is dequantized to bf16, as the JAX ``deq``
    default does."""
    if lm_head is not None:
        return lm_head
    if model.lm_head is not None:
        return deq(model.lm_head)
    return deq(model.embed) if embed is None else embed


def full_lm_head(model: Qwen3, embed: Optional[torch.Tensor] = None,
                 lm_head: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The whole [V, D] head of :func:`lm_head_weight`: a
    tensor-parallel model's vocab shards gathered over tp (the backward
    keeps this rank's rows), for the loss heads that take every vocab
    row."""
    return comm.gather_from_tp(lm_head_weight(model, embed, lm_head),
                               tp_group(model), dim=0)


def unembed(model: Qwen3, hidden: torch.Tensor) -> torch.Tensor:
    """lm-head product with logits in ``cfg.logits_dtype`` (fp32).

    As in the JAX ``preferred_element_type`` product, bf16 operands are
    accumulated in fp32 and the fp32 sum is returned unrounded
    (``ops/matmul.matmul_f32``). A tensor-parallel model's local vocab
    logits are gathered over tp: every rank gets the whole row.
    """
    return comm.gather_from_tp(
        unembed_train(hidden, lm_head_weight(model), model.cfg),
        tp_group(model))
