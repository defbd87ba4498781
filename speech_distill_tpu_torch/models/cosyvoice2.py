"""The CosyVoice2 teacher over the unified vocabulary (port of
``speech_distill_tpu/models/cosyvoice2.py``).

A Qwen2-0.5B backbone (q/k/v biases, no q/k norm: the port's
:class:`~speech_distill_tpu_torch.models.qwen3.Qwen3` with
``attention_bias`` and without ``qk_norm``) with a split embedding and a
split head, made to look like one causal LM over a unified id space:

    [0, text_vocab)              text tokens  -> backbone embed / lm head
    [text_vocab, text_vocab+2)   sos, task    -> llm_embedding (2 rows)
    [text_vocab+2, +2+S+3)       speech       -> speech_embedding / llm_decoder
    remainder                    unmapped     -> zero embed / -10000 logits

S = 6,561 speech codes; the decoder head has S + 3 outputs (eos at S, an
unused one, fill at S + 2). The three embedding tables are concatenated
into one [V_unified, D] table in the model dtype, once per forward, so the
embedding is one gather; the logits are the two heads' products (fp32)
placed into a -10000 filler.

Ids at or past ``unified_vocab_size`` raise ``ValueError`` (JAX's
``jnp.take`` reads a NaN row for them); negative ids down to
``-unified_vocab_size`` wrap to the end of the table, as they do in JAX.
The check is one reduction per forward, or none for host (numpy) ids.
A quantized backbone embedding is refused: JAX fails on it too.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from speech_distill_tpu_torch.core.config import (Qwen3Config,
                                                  qwen2_cosyvoice_backbone)
from speech_distill_tpu_torch.core.device import resolve_device
from speech_distill_tpu_torch.distill.losses import segmented_top_k
from speech_distill_tpu_torch.models import qwen3
from speech_distill_tpu_torch.ops.fused_lm_loss import fused_topk_lse
from speech_distill_tpu_torch.ops.matmul import matmul_f32

NEG_FILL = -10000.0
IGNORE_ID = -1
EXTRACTS = ("materialized", "fused")


@dataclasses.dataclass
class CosyVoice2Config:
    backbone: Qwen3Config = dataclasses.field(
        default_factory=qwen2_cosyvoice_backbone)
    text_vocab_size: int = 152704       # unified text range
    speech_token_size: int = 6561       # codebook entries
    unified_vocab_size: int = 159271    # the merged logit width
    mix_ratio: Tuple[int, int] = (5, 15)

    @property
    def sos_id(self) -> int:
        return self.text_vocab_size

    @property
    def task_id(self) -> int:
        return self.text_vocab_size + 1

    @property
    def speech_offset(self) -> int:
        return self.text_vocab_size + 2

    @property
    def num_decoder_out(self) -> int:
        return self.speech_token_size + 3  # + eos / unused / fill

    @property
    def eos_unified(self) -> int:
        return self.speech_offset + self.speech_token_size

    @property
    def fill_unified(self) -> int:
        return self.speech_offset + self.speech_token_size + 2


def _weight(shape, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                        requires_grad=False)


class _Decoder(nn.Module):
    """The speech head: w [D, S+3] (applied as h @ w) and b [S+3]."""

    def __init__(self, D: int, n: int, device, dtype):
        super().__init__()
        self.w = _weight((D, n), device, dtype)
        self.b = _weight((n,), device, dtype)


class CosyVoice2(nn.Module):
    """The teacher's weights: ``backbone`` (a Qwen2 :class:`Qwen3`),
    ``llm_embedding`` [2, D], ``speech_embedding`` [S+3, D] and
    ``llm_decoder`` (w, b), uninitialised until :func:`init_params`,
    :func:`convert_torch_state` or ``convert.cosyvoice2_params_from_jax``
    fills them. The three small leaves are in ``head_dtype`` (default the
    backbone's; a converted reference checkpoint keeps them fp32, as JAX
    does). ``backbone`` takes a filled :class:`Qwen3` in place of an
    empty one. ``device`` defaults to CUDA and raises without it."""

    def __init__(self, cfg: CosyVoice2Config, device="cuda",
                 head_dtype: Optional[torch.dtype] = None,
                 backbone: Optional[qwen3.Qwen3] = None):
        super().__init__()
        device = resolve_device(device)
        dt = head_dtype or cfg.backbone.torch_dtype
        D, n = cfg.backbone.hidden_size, cfg.num_decoder_out
        self.cfg = cfg
        self.backbone = (qwen3.Qwen3(cfg.backbone, device) if backbone is None
                         else backbone)
        self.llm_embedding = _weight((2, D), device, dt)
        self.speech_embedding = _weight((n, D), device, dt)
        self.llm_decoder = _Decoder(D, n, device, dt)

    @property
    def device(self) -> torch.device:
        return self.backbone.device


@torch.no_grad()
def init_params(cfg: CosyVoice2Config, seed: int = 0,
                device="cuda") -> CosyVoice2:
    """Random init: the backbone as ``qwen3.init_params(cfg.backbone,
    seed)``, then normal(0, 0.02) embeddings and decoder weight and a zero
    decoder bias in the backbone dtype from ``numpy.random.
    default_rng(seed + 1)``. JAX draws these from its own key splits, so
    the weights differ from the JAX ``init_params``'s; tests carry JAX's
    across with ``convert.cosyvoice2_params_from_jax``."""
    from speech_distill_tpu_torch.models.convert import (
        cosyvoice2_params_from_jax)
    rng = np.random.default_rng(seed + 1)
    D, n = cfg.backbone.hidden_size, cfg.num_decoder_out

    def w(*shape):
        return rng.normal(0.0, 0.02, shape).astype(np.float32)
    tree = {"backbone": qwen3._numpy_init_tree(cfg.backbone, seed),
            "llm_embedding": w(2, D), "speech_embedding": w(n, D),
            "llm_decoder": {"w": w(D, n), "b": np.zeros(n, np.float32)}}
    return cosyvoice2_params_from_jax(tree, cfg, device)


@torch.no_grad()
def init_params_on_device(seed: int, cfg: CosyVoice2Config,
                          device="cuda") -> CosyVoice2:
    """Random init drawn on ``device`` (CUDA by default; raises without
    it): the backbone by ``qwen3.init_params_on_device(seed)``, then
    normal(0, 0.02) embeddings and decoder weight and a zero decoder bias
    from a generator there seeded with ``seed + 1``. A full-size teacher's
    weights never cross the host."""
    backbone = qwen3.init_params_on_device(seed, cfg.backbone, device)
    model = CosyVoice2(cfg, backbone.device, backbone=backbone)
    gen = torch.Generator(device=model.device).manual_seed(seed + 1)
    for p in (model.llm_embedding, model.speech_embedding,
              model.llm_decoder.w):
        p.normal_(0.0, 0.02, generator=gen)
    model.llm_decoder.b.zero_()
    return model


def unified_embedding_table(model: CosyVoice2) -> torch.Tensor:
    """[V_unified, D] in the backbone dtype: the text embedding (cut to, or
    zero-padded up to, ``text_vocab_size``), ``llm_embedding``,
    ``speech_embedding`` and a zero tail. Raises ``ValueError`` for a
    quantized backbone embedding (JAX reads ``.shape`` of its int8 leaf
    dict and fails)."""
    cfg = model.cfg
    text = model.backbone.embed
    if isinstance(text, qwen3.QuantWeight):
        raise ValueError("a quantized CosyVoice2 teacher is not supported: "
                         "its unified embedding table needs the dense "
                         "backbone embedding (the JAX package fails on it "
                         "too)")
    D, dt, dev = text.shape[1], text.dtype, text.device
    tv = cfg.text_vocab_size
    pieces = [text[:tv]]
    if text.shape[0] < tv:
        pieces.append(text.new_zeros((tv - text.shape[0], D)))
    pieces.append(model.llm_embedding.to(dt))
    pieces.append(model.speech_embedding.to(dt))
    used = cfg.speech_offset + model.speech_embedding.shape[0]
    if used < cfg.unified_vocab_size:
        pieces.append(torch.zeros((cfg.unified_vocab_size - used, D),
                                  dtype=dt, device=dev))
    return torch.cat(pieces, dim=0)


def check_ids(ids, cfg: CosyVoice2Config) -> torch.Tensor:
    """Unified ids as int64 with negative ids wrapped (``id + V``, as
    JAX's ``jnp.take`` wraps them). Raises ``ValueError`` for an id at or
    past ``unified_vocab_size`` or below ``-unified_vocab_size``: host ids
    are checked on the host, device ids with one reduction and one read."""
    V = cfg.unified_vocab_size
    if isinstance(ids, np.ndarray):
        lo, hi = (int(ids.min()), int(ids.max())) if ids.size else (0, 0)
        ids = torch.from_numpy(ids)
    else:
        lo, hi = (torch.stack(torch.aminmax(ids)).tolist() if ids.numel()
                  else (0, 0))
    if hi >= V or lo < -V:
        raise ValueError(f"token ids in [{lo}, {hi}] are outside the "
                         f"unified vocabulary of {V} (ids >= {V} read NaN "
                         f"rows in the JAX teacher)")
    return torch.remainder(ids.long(), V)


def _hidden(model: CosyVoice2, ids, mask) -> torch.Tensor:
    """The backbone's final-normed hidden states [B, T, D] over the
    unified-table embedding of ``ids``."""
    dev = model.device
    ids = check_ids(ids, model.cfg).to(dev)
    if mask is not None:
        mask = torch.as_tensor(mask, device=dev)
    x = nn.functional.embedding(ids, unified_embedding_table(model))
    return qwen3.forward(model.backbone, None, attention_mask=mask,
                         inputs_embeds=x, return_hidden=True)


@torch.no_grad()
def forward(model: CosyVoice2, input_ids, attention_mask=None
            ) -> torch.Tensor:
    """Unified-vocab teacher logits [B, T, unified_vocab_size] (fp32): the
    backbone head's text logits cut to ``text_vocab_size``, -10000 for the
    sos / task rows and the unmapped ids, the decoder's speech logits at
    the speech offset."""
    cfg = model.cfg
    hidden = _hidden(model, input_ids, attention_mask)
    B, T = hidden.shape[:2]
    lm_w = qwen3.lm_head_weight(model.backbone)
    n_text = min(lm_w.shape[0], cfg.text_vocab_size)
    dec = model.llm_decoder
    n_speech = min(dec.w.shape[1], cfg.num_decoder_out)
    out = torch.full((B, T, cfg.unified_vocab_size), NEG_FILL,
                     dtype=torch.float32, device=hidden.device)
    out[..., :n_text] = matmul_f32(hidden, lm_w[:n_text].t())
    so = cfg.speech_offset
    out[..., so:so + n_speech] = (hidden.float() @ dec.w[:, :n_speech].float()
                                  + dec.b[:n_speech].float())
    return out


def _check_cfg(teacher: CosyVoice2, cfg: CosyVoice2Config) -> None:
    if teacher.cfg != cfg:
        raise ValueError("the teacher's config is not the one the route "
                         "was made for")


def make_teacher_forward(cfg: CosyVoice2Config):
    """The KD step's ``teacher_forward(teacher, ids, mask) -> logits`` for
    a :class:`CosyVoice2` built with ``cfg``."""
    def fn(teacher: CosyVoice2, ids, mask):
        _check_cfg(teacher, cfg)
        return forward(teacher, ids, attention_mask=mask)
    return fn


def make_teacher_extract(cfg: CosyVoice2Config, k: int,
                         student_vocab_size: int, chunk_size: int = 16384,
                         extract: str = "materialized",
                         recall: float = 0.95):
    """Top-K extraction over the split heads, ``fn(teacher, ids, mask) ->
    (fp16 logprobs, int32 indices) [B, T, k]``: the set of
    ``extract_top_k(forward(...), k, student_vocab_size)`` without the
    unified [B, T, V] layout. Each head's top-k and logsumexp are taken on
    its own, the tops merged with the speech indices moved to the speech
    offset, and the joint logsumexp is the ``logaddexp`` of the two (the
    -10000 filler of the unified layout carries no mass in fp32).

    ``extract`` "materialized": each head's fp32 logits, then the exact
    top-k (JAX's ``approx_max_k`` at ``recall``, a TPU primitive, maps to
    the exact top-k); "fused": ``ops/fused_lm_loss.fused_topk_lse`` over
    vocab chunks of ``chunk_size``, never holding a head's logits."""
    if extract not in EXTRACTS:
        raise ValueError(f"unknown extract {extract!r} ({EXTRACTS})")
    del recall
    n_speech = 0
    if student_vocab_size > cfg.speech_offset:
        n_speech = min(cfg.num_decoder_out,
                       student_vocab_size - cfg.speech_offset)
        if k > n_speech:
            raise ValueError(f"top_k {k} exceeds the speech head's "
                             f"{n_speech} outputs")

    def heads(teacher, ids, mask):
        _check_cfg(teacher, cfg)
        hidden = _hidden(teacher, ids, mask)
        B, T, D = hidden.shape
        lm_w = qwen3.lm_head_weight(teacher.backbone)
        n_text = min(lm_w.shape[0], cfg.text_vocab_size, student_vocab_size)
        return hidden.reshape(-1, D), lm_w, n_text, (B, T)

    def merge(tv, ti, lse, tv2, ti2, lse2):
        cand_v = torch.cat([tv, tv2], dim=1)
        cand_i = torch.cat([ti.long(), ti2.long() + cfg.speech_offset], dim=1)
        v, sel = torch.topk(cand_v, k, dim=1)
        return v, cand_i.gather(1, sel), torch.logaddexp(lse, lse2)

    def out(tv, ti, lse, BT):
        v = (tv - lse[:, None]).to(torch.float16)
        return v.reshape(*BT, k), ti.to(torch.int32).reshape(*BT, k)

    @torch.no_grad()
    def fn_fused(teacher, ids, mask):
        h, lm_w, n_text, BT = heads(teacher, ids, mask)
        tv, ti, lse = fused_topk_lse(h, lm_w, k, n_text, chunk_size)
        if n_speech:
            dec = teacher.llm_decoder
            tv2, ti2, lse2 = fused_topk_lse(h, dec.w.t(), k, n_speech,
                                            chunk_size, bias=dec.b)
            tv, ti, lse = merge(tv, ti, lse, tv2, ti2, lse2)
        return out(tv, ti, lse, BT)

    @torch.no_grad()
    def fn_materialized(teacher, ids, mask):
        h, lm_w, n_text, BT = heads(teacher, ids, mask)
        tl = matmul_f32(h, lm_w[:n_text].t())
        lse = torch.logsumexp(tl, dim=-1)
        tv, ti = segmented_top_k(tl, k)
        del tl
        if n_speech:
            dec = teacher.llm_decoder
            sl = (h.float() @ dec.w[:, :n_speech].float()
                  + dec.b[:n_speech].float())
            lse2 = torch.logsumexp(sl, dim=-1)
            tv2, ti2 = torch.topk(sl, k, dim=-1)
            tv, ti, lse = merge(tv, ti, lse, tv2, ti2, lse2)
        return out(tv, ti, lse, BT)

    return fn_materialized if extract == "materialized" else fn_fused


def _f32(t) -> torch.Tensor:
    if isinstance(t, torch.Tensor):
        return t.detach().to(torch.float32).cpu()
    return torch.from_numpy(np.asarray(t, np.float32))


@torch.no_grad()
def convert_torch_state(state: Dict[str, Any], cfg: CosyVoice2Config,
                        device="cuda") -> CosyVoice2:
    """A reference CosyVoice2 torch checkpoint as a :class:`CosyVoice2` on
    ``device`` (CUDA by default; raises without it). The torch names:
    ``llm_embedding.weight`` [2, D], ``speech_embedding.weight`` [S+3, D],
    ``llm_decoder.{weight,bias}`` ([S+3, D], [S+3]) and the Qwen2 backbone
    under ``llm.model.`` (the reference's Qwen2Encoder holds a
    Qwen2ForCausalLM there: ``llm.model.model.layers...``). The backbone
    is cast to its config's dtype, the small leaves kept in fp32, as the
    JAX ``convert_torch_state`` keeps them."""
    from speech_distill_tpu_torch.models.hf_loader import from_state_dict
    dev = resolve_device(device)
    pre = "llm.model."
    backbone = from_state_dict(
        {k[len(pre):]: v for k, v in state.items() if k.startswith(pre)},
        cfg.backbone, device=dev)
    model = CosyVoice2(cfg, dev, head_dtype=torch.float32, backbone=backbone)
    dec = model.llm_decoder
    for dst, name in ((model.llm_embedding, "llm_embedding.weight"),
                      (model.speech_embedding, "speech_embedding.weight"),
                      (dec.w, "llm_decoder.weight"),
                      (dec.b, "llm_decoder.bias")):
        src = _f32(state[name])
        src = src.t() if dst is dec.w else src
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"shape {tuple(src.shape)} != "
                             f"{tuple(dst.shape)}")
        dst.copy_(src)
    return model


def load(path: str, device="cuda") -> CosyVoice2:
    """The CosyVoice2 teacher of the reference torch checkpoint at
    ``path``: ``torch.load`` on the CPU, then :func:`convert_torch_state`
    of ``CosyVoice2Config()`` onto ``device``. Its config is
    ``model.cfg``."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    return convert_torch_state(state, CosyVoice2Config(), device=device)


def torch_state(model: CosyVoice2) -> Dict[str, torch.Tensor]:
    """The model as a reference CosyVoice2 state dict (the names
    :func:`convert_torch_state` reads), tensors in their own dtypes on
    the model's device: the inverse of :func:`convert_torch_state`."""
    from speech_distill_tpu_torch.models.convert import model_to_tree
    from speech_distill_tpu_torch.models.hf_loader import to_state_dict
    bb = model.cfg.backbone
    state = {f"llm.model.{k}": torch.from_numpy(v).to(bb.torch_dtype)
             for k, v in to_state_dict(model_to_tree(model.backbone),
                                       bb).items()}
    dec = model.llm_decoder
    state.update({"llm_embedding.weight": model.llm_embedding.detach(),
                  "speech_embedding.weight": model.speech_embedding.detach(),
                  "llm_decoder.weight": dec.w.detach().t().contiguous(),
                  "llm_decoder.bias": dec.b.detach()})
    return state


# ---------------------------------------------------------------------------
# Training-sequence construction (bistream / unistream interleave)
# ---------------------------------------------------------------------------


def prepare_lm_sequences(cfg: CosyVoice2Config,
                         text_tokens: Sequence[Sequence[int]],
                         speech_tokens: Sequence[Sequence[int]],
                         bistream: Sequence[bool],
                         pad_to: Optional[int] = None):
    """Unified-id inputs and targets, host-side numpy (the reference's
    ``prepare_lm_input_target`` interleaves embeddings; with the unified
    table the ids interleave instead).

    ``bistream[i]``: text and speech mixed in 5:15 chunks with fill
    tokens (when the speech is more than 3x the text); else unistream
    [sos, text..., task, speech..., eos]. Targets are unified speech ids,
    IGNORE_ID elsewhere. Returns (input_ids int32 [B, T], targets int64
    [B, T], lengths int32 [B])."""
    m_t, m_s = cfg.mix_ratio
    seqs: List[List[int]] = []
    tgts: List[List[int]] = []
    for text, speech, bi in zip(text_tokens, speech_tokens, bistream):
        text = list(text)
        speech = list(speech)
        if bi and len(speech) / max(len(text), 1) > m_s / m_t:
            inp = [cfg.sos_id]
            tgt = [IGNORE_ID]
            n_chunks = int(np.ceil((len(text) + 1) / m_t))
            for j in range(n_chunks):
                t_chunk = text[j * m_t:(j + 1) * m_t]
                s_chunk = speech[j * m_s:(j + 1) * m_s]
                if len(t_chunk) == m_t:
                    tgt += [IGNORE_ID] * (m_t - 1)
                    tgt += [cfg.speech_offset + c for c in s_chunk]
                    tgt.append(cfg.fill_unified)
                    inp += t_chunk
                    inp += [cfg.speech_offset + c for c in s_chunk]
                else:
                    tgt += [IGNORE_ID] * len(t_chunk)
                    tgt += [cfg.speech_offset + c for c in speech[j * m_s:]]
                    tgt.append(cfg.eos_unified)
                    inp += t_chunk
                    inp.append(cfg.task_id)
                    inp += [cfg.speech_offset + c for c in speech[j * m_s:]]
        else:
            inp = ([cfg.sos_id] + text + [cfg.task_id]
                   + [cfg.speech_offset + c for c in speech])
            tgt = ([IGNORE_ID] * (1 + len(text))
                   + [cfg.speech_offset + c for c in speech]
                   + [cfg.eos_unified])
        seqs.append(inp)
        tgts.append(tgt)

    lengths = np.asarray([len(s) for s in seqs], np.int32)
    T = pad_to or int(lengths.max())
    B = len(seqs)
    ids = np.zeros((B, T), np.int32)
    targets = np.full((B, T), IGNORE_ID, np.int64)
    for b in range(B):
        n = min(len(seqs[b]), T)
        ids[b, :n] = seqs[b][:n]
        targets[b, :len(tgts[b][:T])] = tgts[b][:T]
    return ids, targets, lengths
