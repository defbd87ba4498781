"""Flow-matching mel decoder: causal 1-D UNet estimator + CFM Euler solver
(port of ``speech_distill_tpu/models/flow.py``).

The reference token -> mel stack:
  * ``CausalConditionalDecoder``: packed input [x, mu, spks, cond]
    (320 ch) -> causal resnet + 4 transformer blocks -> 12 mid blocks ->
    skip-concat up block -> final causal block / proj (80);
  * ``CausalConditionalCFM``: 15 Euler steps on a cosine t-schedule with
    classifier-free guidance rate 0.7 over a doubled batch;
  * ``CausalMaskedDiffWithXvec``: token embedding (6561 -> 512), x-vector
    affine -> 80, the upsampling conformer encoder, proj -> 80.

Layout: channel-last [B, T, C] throughout, as in JAX; convolutions
transpose to [B, C, T] at ``F.conv1d`` only. The modules carry the
reference torch names (``input_embedding``, ``spk_embed_affine_layer``,
``encoder_proj``, ``decoder.estimator.down_blocks.0.1.{i}.attn1.to_q``,
...), so ``state_dict()`` is a reference-format ``flow.pt`` state dict
and loading the released weights is ``load_state_dict``. The functions
take a module where JAX takes its params and keep JAX's names; the Euler
solve is a Python loop (no jit; a CUDA graph of the step is later work).
Attention is plain matmul + softmax under the additive -1e10 chunk-causal
bias, not ``ops/attention.sdpa`` (whose masks are causal).

Incremental streaming keeps per-Euler-step caches (see
:func:`init_incremental_cache`): K/V of every transformer block and the
2-frame input tail of every causal conv, so a chunk solves only its new
frames. The cache holds n_timesteps x 2 CFG rows x (1 + 12 + 1 stacks x
4 blocks = 56 blocks) x (K, V) x 512 (inner) = 15 x 2 x 56 x 2 x 512 =
1,720,320 elements a mel frame for one stream: 3.4 MB in bf16 (the
default), 6.9 MB in fp32. The caches are updated in place.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from speech_distill_tpu_torch.core.device import resolve_device
from speech_distill_tpu_torch.models import flow_encoder
from speech_distill_tpu_torch.models.flow_encoder import FlowEncoderConfig

Cache = Dict[str, dict]


@dataclasses.dataclass
class FlowConfig:
    input_size: int = 512
    output_size: int = 80
    spk_embed_dim: int = 192
    vocab_size: int = 6561
    token_mel_ratio: int = 2
    pre_lookahead_len: int = 3
    n_timesteps: int = 15
    inference_cfg_rate: float = 0.7
    t_scheduler: str = "cosine"
    # estimator
    est_in_channels: int = 320
    est_channels: int = 256
    est_n_blocks: int = 4
    est_num_mid_blocks: int = 12
    est_num_heads: int = 8
    est_head_dim: int = 64
    static_chunk_size: int = 50
    encoder: FlowEncoderConfig = dataclasses.field(
        default_factory=FlowEncoderConfig)


# ---------------------------------------------------------------------------
# modules (reference names)
# ---------------------------------------------------------------------------


class CausalBlock1D(nn.Module):
    """``block`` = CausalConv1d k3, Transpose, LayerNorm, Transpose, Mish:
    parameters at ``block.0`` and ``block.2``."""

    def __init__(self, cin: int, cout: int, device=None):
        super().__init__()
        self.block = nn.ModuleList([
            nn.Conv1d(cin, cout, 3, device=device), nn.Identity(),
            nn.LayerNorm(cout, device=device), nn.Identity(), nn.Mish()])


class CausalResnetBlock1D(nn.Module):
    def __init__(self, cin: int, cout: int, time_dim: int, device=None):
        super().__init__()
        self.mlp = nn.Sequential(nn.Mish(),
                                 nn.Linear(time_dim, cout, device=device))
        self.block1 = CausalBlock1D(cin, cout, device)
        self.block2 = CausalBlock1D(cout, cout, device)
        self.res_conv = nn.Conv1d(cin, cout, 1, device=device)


class Attention(nn.Module):
    """diffusers ``Attention``: q/k/v without bias, ``to_out.0`` with."""

    def __init__(self, c: int, inner: int, device=None):
        super().__init__()
        self.to_q = nn.Linear(c, inner, bias=False, device=device)
        self.to_k = nn.Linear(c, inner, bias=False, device=device)
        self.to_v = nn.Linear(c, inner, bias=False, device=device)
        self.to_out = nn.ModuleList([nn.Linear(inner, c, device=device),
                                     nn.Identity()])


class GELU(nn.Module):
    def __init__(self, din: int, dout: int, device=None):
        super().__init__()
        self.proj = nn.Linear(din, dout, device=device)


class FeedForward(nn.Module):
    def __init__(self, c: int, inner: int, device=None):
        super().__init__()
        self.net = nn.ModuleList([GELU(c, inner, device), nn.Identity(),
                                  nn.Linear(inner, c, device=device)])


class BasicTransformerBlock(nn.Module):
    def __init__(self, c: int, heads: int, head_dim: int, device=None):
        super().__init__()
        self.norm1 = nn.LayerNorm(c, device=device)
        self.attn1 = Attention(c, heads * head_dim, device)
        self.norm3 = nn.LayerNorm(c, device=device)
        self.ff = FeedForward(c, 4 * c, device)


class TimestepEmbedding(nn.Module):
    def __init__(self, din: int, dim: int, device=None):
        super().__init__()
        self.linear_1 = nn.Linear(din, dim, device=device)
        self.linear_2 = nn.Linear(dim, dim, device=device)


def _tf_blocks(cfg: FlowConfig, device) -> nn.ModuleList:
    return nn.ModuleList(
        BasicTransformerBlock(cfg.est_channels, cfg.est_num_heads,
                              cfg.est_head_dim, device)
        for _ in range(cfg.est_n_blocks))


class CausalConditionalDecoder(nn.Module):
    """The estimator: ``down_blocks.0`` = [resnet, blocks, conv],
    ``mid_blocks.{i}`` = [resnet, blocks], ``up_blocks.0`` = [resnet,
    blocks, conv], ``final_block``, ``final_proj``."""

    def __init__(self, cfg: FlowConfig, device=None):
        super().__init__()
        C, Cin = cfg.est_channels, cfg.est_in_channels
        TE = 4 * C
        self.time_mlp = TimestepEmbedding(Cin, TE, device)
        self.down_blocks = nn.ModuleList([nn.ModuleList([
            CausalResnetBlock1D(Cin, C, TE, device), _tf_blocks(cfg, device),
            nn.Conv1d(C, C, 3, device=device)])])
        self.mid_blocks = nn.ModuleList(
            nn.ModuleList([CausalResnetBlock1D(C, C, TE, device),
                           _tf_blocks(cfg, device)])
            for _ in range(cfg.est_num_mid_blocks))
        self.up_blocks = nn.ModuleList([nn.ModuleList([
            CausalResnetBlock1D(2 * C, C, TE, device),
            _tf_blocks(cfg, device), nn.Conv1d(C, C, 3, device=device)])])
        self.final_block = CausalBlock1D(C, C, device)
        self.final_proj = nn.Conv1d(C, cfg.output_size, 1, device=device)


class CausalConditionalCFM(nn.Module):
    def __init__(self, cfg: FlowConfig, device=None):
        super().__init__()
        self.estimator = CausalConditionalDecoder(cfg, device)


class Flow(nn.Module):
    """``CausalMaskedDiffWithXvec``: token embedding, speaker affine, the
    encoder, its projection and the CFM decoder."""

    def __init__(self, cfg: FlowConfig, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.input_embedding = nn.Embedding(cfg.vocab_size, cfg.input_size,
                                            device=dev)
        self.spk_embed_affine_layer = nn.Linear(
            cfg.spk_embed_dim, cfg.output_size, device=dev)
        self.encoder = flow_encoder.UpsampleConformerEncoder(cfg.encoder,
                                                             dev)
        self.encoder_proj = nn.Linear(cfg.encoder.output_size,
                                      cfg.output_size, device=dev)
        self.decoder = CausalConditionalCFM(cfg, dev)
        self.requires_grad_(False)

    @property
    def device(self) -> torch.device:
        return self.input_embedding.weight.device


# ---------------------------------------------------------------------------
# estimator building blocks
# ---------------------------------------------------------------------------


def _causal_conv(x: torch.Tensor, conv: nn.Conv1d, k: int) -> torch.Tensor:
    xt = F.pad(x.transpose(1, 2), (k - 1, 0))
    return F.conv1d(xt, conv.weight, conv.bias).transpose(1, 2)


def _pointwise(x: torch.Tensor, conv: nn.Conv1d) -> torch.Tensor:
    """A 1x1 conv as a matmul on channel-last x."""
    return F.linear(x, conv.weight[:, :, 0], conv.bias)


def _causal_block(blk: CausalBlock1D, x, mask) -> torch.Tensor:
    """CausalBlock1D: conv k3 -> LN -> Mish, masked."""
    h = _causal_conv(x * mask, blk.block[0], 3)
    return F.mish(blk.block[2](h)) * mask


def _causal_resnet(res: CausalResnetBlock1D, x, mask, t_emb
                   ) -> torch.Tensor:
    h = _causal_block(res.block1, x, mask)
    h = h + res.mlp[1](F.mish(t_emb))[:, None, :]
    h = _causal_block(res.block2, h, mask)
    return h + _pointwise(x * mask, res.res_conv)


def _attend(q, k, v, bias, head_dim: int) -> torch.Tensor:
    """q [B, T, H, Dh], k/v [B, S, H, Dh] -> [B, T, H*Dh]."""
    B, T = q.shape[:2]
    scores = (q.transpose(1, 2) @ k.permute(0, 2, 3, 1)) * head_dim ** -0.5
    if bias is not None:
        scores = scores + bias
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    return (w @ v.transpose(1, 2)).transpose(1, 2).reshape(B, T, -1)


def _attention_block(attn: Attention, x, mask_bias, heads: int,
                     head_dim: int) -> torch.Tensor:
    B, T, _ = x.shape
    q = attn.to_q(x).reshape(B, T, heads, head_dim)
    k = attn.to_k(x).reshape(B, T, heads, head_dim)
    v = attn.to_v(x).reshape(B, T, heads, head_dim)
    return attn.to_out[0](_attend(q, k, v, mask_bias, head_dim))


def _feed_forward(ff: FeedForward, h) -> torch.Tensor:
    return ff.net[2](F.gelu(ff.net[0].proj(h)))


def _transformer_block(tb: BasicTransformerBlock, x, mask_bias, heads: int,
                       head_dim: int) -> torch.Tensor:
    """BasicTransformerBlock: LayerNorms, self-attention, exact-GELU FF."""
    x = x + _attention_block(tb.attn1, tb.norm1(x), mask_bias, heads,
                             head_dim)
    return x + _feed_forward(tb.ff, tb.norm3(x))


def _time_embedding(tm: TimestepEmbedding, t: torch.Tensor,
                    in_channels: int) -> torch.Tensor:
    """SinusoidalPosEmb(scale=1000) + TimestepEmbedding MLP. t [B]."""
    half = in_channels // 2
    freq = torch.exp(torch.arange(half, dtype=torch.float32,
                                  device=t.device)
                     * -(np.log(10000.0) / (half - 1)))
    emb = 1000.0 * t[:, None] * freq[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    return tm.linear_2(F.silu(tm.linear_1(emb)))


def _chunk_bias(keep: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros((), dtype=torch.float32, device=keep.device)
    return torch.where(keep, zero, zero - 1e10)


def estimator_forward(est: CausalConditionalDecoder, x: torch.Tensor,
                      mask: torch.Tensor, mu: torch.Tensor, t: torch.Tensor,
                      spks: torch.Tensor, cond: torch.Tensor,
                      cfg: FlowConfig, streaming: bool = False
                      ) -> torch.Tensor:
    """x/mu/cond [B, T, 80], spks [B, 80], t [B] -> velocity [B, T, 80].
    With ``channels=[256]`` the down/up samplers are causal convs (no
    temporal resampling), so one attention bias serves every stage."""
    B, T, _ = x.shape
    heads, hd = cfg.est_num_heads, cfg.est_head_dim
    t_emb = _time_embedding(est.time_mlp, t, cfg.est_in_channels)

    spks_t = spks[:, None, :].expand(B, T, spks.shape[-1])
    h = torch.cat([x, mu, spks_t, cond], dim=-1)          # [B, T, 320]
    m = mask[..., None] if mask.dim() == 2 else mask      # [B, T, 1]

    keep = m[..., 0].bool()[:, None, None, :]
    if streaming:
        pos = torch.arange(T, device=x.device)
        block = (pos // cfg.static_chunk_size + 1) * cfg.static_chunk_size
        keep = keep & (pos[None, :] < block[:, None])[None, None]
    bias = _chunk_bias(keep)

    def tf_stack(blocks, hh):
        for tb in blocks:
            hh = _transformer_block(tb, hh, bias, heads, hd)
        return hh

    down_res, down_tf, down_conv = est.down_blocks[0]
    h = _causal_resnet(down_res, h, m, t_emb)
    h = tf_stack(down_tf, h)
    skip = h
    h = _causal_conv(h * m, down_conv, 3)

    for mid_res, mid_tf in est.mid_blocks:
        h = _causal_resnet(mid_res, h, m, t_emb)
        h = tf_stack(mid_tf, h)

    up_res, up_tf, up_conv = est.up_blocks[0]
    h = torch.cat([h, skip], dim=-1)
    h = _causal_resnet(up_res, h, m, t_emb)
    h = tf_stack(up_tf, h)
    h = _causal_conv(h * m, up_conv, 3)

    h = _causal_block(est.final_block, h, m)
    return _pointwise(h * m, est.final_proj) * m


# ---------------------------------------------------------------------------
# CFM solver
# ---------------------------------------------------------------------------


def t_schedule(cfg: FlowConfig):
    """(t, dt) of each Euler step, fp32 numpy as the JAX solver computes
    them."""
    t_span = np.linspace(0, 1, cfg.n_timesteps + 1, dtype=np.float32)
    if cfg.t_scheduler == "cosine":
        t_span = 1 - np.cos(t_span * 0.5 * np.pi)
    return t_span[:-1], np.diff(t_span)


def _cfg_rows(mu, mask, spks, cond):
    """The conditional rows followed by the unconditional ones (zero mu,
    speaker and prompt condition)."""
    return (torch.cat([mu, torch.zeros_like(mu)]),
            torch.cat([mask, mask]),
            torch.cat([spks, torch.zeros_like(spks)]),
            torch.cat([cond, torch.zeros_like(cond)]))


@torch.no_grad()
def solve_euler(est: CausalConditionalDecoder, z: torch.Tensor,
                mu: torch.Tensor, mask: torch.Tensor, spks: torch.Tensor,
                cond: torch.Tensor, cfg: FlowConfig,
                streaming: bool = False) -> torch.Tensor:
    """Fixed Euler ODE solve with the CFG double batch."""
    ts, dts = t_schedule(cfg)
    B = z.shape[0]
    g = cfg.inference_cfg_rate
    mu2, mask2, spks2, cond2 = _cfg_rows(mu, mask, spks, cond)
    x = z
    for t, dt in zip(ts, dts):
        t2 = torch.full((2 * B,), float(t), dtype=x.dtype, device=x.device)
        v = estimator_forward(est, torch.cat([x, x]), mask2, mu2, t2, spks2,
                              cond2, cfg, streaming)
        x = x + float(dt) * ((1.0 + g) * v[:B] - g * v[B:])
    return x


# ---------------------------------------------------------------------------
# token -> mel
# ---------------------------------------------------------------------------


def _speaker(flow: Flow, embedding: torch.Tensor) -> torch.Tensor:
    """x-vector: L2 normalise, then the affine to 80."""
    emb = embedding / torch.linalg.norm(embedding, dim=1, keepdim=True)
    return flow.spk_embed_affine_layer(emb)


def _embed_tokens(flow: Flow, token: torch.Tensor, token_len: torch.Tensor
                  ) -> torch.Tensor:
    """Masked token embedding; negative ids read row 0 as in JAX. Ids at
    or past the vocabulary are the caller's to refuse
    (``StreamingTokenToWav.flow_job`` raises): an out-of-range row would
    fault here where JAX reads NaN."""
    T = token.shape[1]
    tok_mask = (torch.arange(T, device=token.device)[None, :]
                < token_len[:, None])[..., None]
    x = F.embedding(token.clamp_min(0), flow.input_embedding.weight)
    return x * tok_mask


@torch.no_grad()
def forward_flow(flow: Flow, token: torch.Tensor, token_len: torch.Tensor,
                 prompt_feat: torch.Tensor, prompt_feat_len: torch.Tensor,
                 embedding: torch.Tensor, cfg: FlowConfig,
                 generator: Optional[torch.Generator] = None,
                 streaming: bool = False, finalize: bool = True,
                 noise: Optional[torch.Tensor] = None,
                 enc_len: Optional[torch.Tensor] = None):
    """``CausalMaskedDiffWithXvec.forward``: token [B, T] int, prompt_feat
    [B, Tp, 80], embedding [B, 192] -> (mel [B, T*2, 80] fp32, mel_lens
    [B]).

    ``enc_len`` ([B], needs ``finalize=True``): encode only the first
    ``enc_len`` tokens while positions [enc_len, token_len) serve as the
    inline pre-lookahead context: the padded-width form of the
    ``finalize=False`` context path that incremental streaming calls with
    chunk-aligned ``enc_len``. ``noise`` (the solver's start, [B, T*2,
    80]) is drawn from ``generator`` when not given."""
    emb = _speaker(flow, embedding)
    x = _embed_tokens(flow, token, token_len)

    if finalize:
        el = token_len if enc_len is None else enc_len
        h, h_lens = flow_encoder.forward(flow.encoder, x, el, cfg.encoder,
                                         streaming=streaming)
    else:
        if enc_len is not None:
            raise ValueError("enc_len requires finalize=True (it IS the "
                             "static-shape context form)")
        la = cfg.pre_lookahead_len
        h, h_lens = flow_encoder.forward(
            flow.encoder, x[:, :-la], token_len, cfg.encoder,
            context=x[:, -la:], streaming=streaming)
    h = flow.encoder_proj(h)

    T2 = h.shape[1]
    pos = torch.arange(T2, device=h.device)
    pmask = (pos[None, :] < prompt_feat_len[:, None])[..., None]
    pf = prompt_feat
    if pf.shape[1] < T2:
        pf = F.pad(pf, (0, 0, 0, T2 - pf.shape[1]))
    conds = torch.where(pmask, pf[:, :T2], torch.zeros_like(h))

    mel_mask = (pos[None, :] < h_lens[:, None]).to(h.dtype)
    if noise is None:
        noise = torch.randn(h.shape, generator=generator, dtype=h.dtype,
                            device=h.device)
    feat = solve_euler(flow.decoder.estimator, noise, h,
                       mel_mask[..., None] * 1.0, emb, conds, cfg, streaming)
    return feat.float(), h_lens


# ---------------------------------------------------------------------------
# incremental streaming: per-Euler-step caches
# ---------------------------------------------------------------------------
#
# The chunk-causal estimator guarantees that a completed frame's velocity
# never changes as more frames append, so the ODE trajectory of old frames
# is final: an incremental call computes only the new frames' trajectory,
# attending to the old frames' keys/values at every Euler step. Caching
# those (and the 2-frame input tail of every causal conv) turns the
# streaming recompute (O(n^2/chunk) in all) into O(n) work. Leading axis
# of every leaf: the Euler step (each step's trajectory is its own
# sequence); then, for the mid stack, the mid block.


def init_incremental_cache(cfg: FlowConfig, batch: int, max_frames: int,
                           kv_dtype=torch.bfloat16,
                           param_dtype=torch.float32,
                           device="cuda") -> Cache:
    """Zeroed incremental-stream cache for ``batch`` utterances of up to
    ``max_frames`` mel frames (sizes in the module docstring). bf16 K/V
    drift the mel ~1e-3 from the fp32 recompute; pass
    ``kv_dtype=torch.float32`` for tight parity at twice the memory."""
    dev = resolve_device(device)
    S, B2, C = cfg.n_timesteps, 2 * batch, cfg.est_channels
    nb = cfg.est_n_blocks
    inner = cfg.est_num_heads * cfg.est_head_dim
    M = cfg.est_num_mid_blocks

    def kv(*lead):
        return {t: torch.zeros((S, *lead, nb, B2, max_frames, inner),
                               dtype=kv_dtype, device=dev)
                for t in ("k", "v")}

    def tail(cin, *lead):
        return torch.zeros((S, *lead, B2, 2, cin), dtype=param_dtype,
                           device=dev)

    return {
        "down": {"b1": tail(cfg.est_in_channels), "b2": tail(C),
                 "attn": kv(), "conv": tail(C)},
        "mid": {"b1": tail(C, M), "b2": tail(C, M), "attn": kv(M)},
        "up": {"b1": tail(2 * C), "b2": tail(C), "attn": kv(),
               "conv": tail(C)},
        "final": tail(C),
    }


def _causal_conv_inc(x, tail: torch.Tensor, conv: nn.Conv1d, k: int,
                     f_val: int) -> torch.Tensor:
    """Causal conv over ``x`` [B, F, C] after the previous ``k-1`` input
    frames in ``tail``, which is advanced in place to end at the
    ``f_val``-th new frame."""
    cat = torch.cat([tail.to(x.dtype), x], dim=1)
    out = F.conv1d(cat.transpose(1, 2), conv.weight,
                   conv.bias).transpose(1, 2)
    tail.copy_(cat[:, f_val:f_val + k - 1])
    return out


def _causal_block_inc(blk: CausalBlock1D, x, m, tail, f_val: int):
    h = _causal_conv_inc(x * m, tail, blk.block[0], 3, f_val)
    return F.mish(blk.block[2](h)) * m


def _causal_resnet_inc(res: CausalResnetBlock1D, x, m, t_emb, t1, t2,
                       f_val: int):
    h = _causal_block_inc(res.block1, x, m, t1, f_val)
    h = h + res.mlp[1](F.mish(t_emb))[:, None, :]
    h = _causal_block_inc(res.block2, h, m, t2, f_val)
    return h + _pointwise(x * m, res.res_conv)


def _attention_block_inc(attn: Attention, x, kc, vc, bias, t_past: int,
                         heads: int, head_dim: int):
    """New-frame queries against the cached keys/values ``kc``/``vc``
    [B, Tm, inner]: the F new frames' K/V are written at ``t_past`` first
    (so they see themselves and the past). Keys from ``t_past + F`` on
    are all masked, so only the first ``t_past + F`` are read."""
    B, Fn, _ = x.shape
    end = t_past + Fn
    kc[:, t_past:end] = attn.to_k(x).to(kc.dtype)
    vc[:, t_past:end] = attn.to_v(x).to(vc.dtype)
    q = attn.to_q(x).reshape(B, Fn, heads, head_dim)
    k = kc[:, :end].to(x.dtype).reshape(B, end, heads, head_dim)
    v = vc[:, :end].to(x.dtype).reshape(B, end, heads, head_dim)
    return attn.to_out[0](_attend(q, k, v, bias[..., :end], head_dim))


def _tf_stack_inc(blocks, h, kv, bias, t_past: int, heads: int,
                  head_dim: int):
    for j, tb in enumerate(blocks):
        h = h + _attention_block_inc(tb.attn1, tb.norm1(h), kv["k"][j],
                                     kv["v"][j], bias, t_past, heads,
                                     head_dim)
        h = h + _feed_forward(tb.ff, tb.norm3(h))
    return h


def estimator_incremental(est: CausalConditionalDecoder, x: torch.Tensor,
                          mask: torch.Tensor, mu: torch.Tensor,
                          t: torch.Tensor, spks: torch.Tensor,
                          cond: torch.Tensor, cfg: FlowConfig, cs: Cache,
                          t_past: int, f_val: int) -> torch.Tensor:
    """One Euler step of the estimator over F NEW frames
    [t_past, t_past+F): x/mu/cond [B2, F, 80] (CFG-doubled rows), mask
    [B2, F, 1] marking the ``f_val`` valid new frames, ``cs`` this step's
    cache slice (updated in place). The chunk-causal bias is built from
    global positions, so the result equals the matching rows of
    :func:`estimator_forward` with ``streaming=True`` over the prefix.
    Returns the velocity [B2, F, 80]."""
    B, Fn, _ = x.shape
    heads, hd = cfg.est_num_heads, cfg.est_head_dim
    t_emb = _time_embedding(est.time_mlp, t, cfg.est_in_channels)

    spks_t = spks[:, None, :].expand(B, Fn, spks.shape[-1])
    h = torch.cat([x, mu, spks_t, cond], dim=-1)
    m = mask

    Tm = cs["down"]["attn"]["k"].shape[-2]
    qpos = t_past + torch.arange(Fn, device=x.device)
    kpos = torch.arange(Tm, device=x.device)
    blk = (qpos // cfg.static_chunk_size + 1) * cfg.static_chunk_size
    keep = (kpos[None, :] < blk[:, None]) & (kpos[None, :] < t_past + f_val)
    bias = _chunk_bias(keep)[None, None]

    down_res, down_tf, down_conv = est.down_blocks[0]
    d = cs["down"]
    h = _causal_resnet_inc(down_res, h, m, t_emb, d["b1"], d["b2"], f_val)
    h = _tf_stack_inc(down_tf, h, d["attn"], bias, t_past, heads, hd)
    skip = h
    h = _causal_conv_inc(h * m, d["conv"], down_conv, 3, f_val)

    mc = cs["mid"]
    for j, (mid_res, mid_tf) in enumerate(est.mid_blocks):
        h = _causal_resnet_inc(mid_res, h, m, t_emb, mc["b1"][j],
                               mc["b2"][j], f_val)
        h = _tf_stack_inc(mid_tf, h, {"k": mc["attn"]["k"][j],
                                      "v": mc["attn"]["v"][j]},
                          bias, t_past, heads, hd)

    up_res, up_tf, up_conv = est.up_blocks[0]
    u = cs["up"]
    h = torch.cat([h, skip], dim=-1)
    h = _causal_resnet_inc(up_res, h, m, t_emb, u["b1"], u["b2"], f_val)
    h = _tf_stack_inc(up_tf, h, u["attn"], bias, t_past, heads, hd)
    h = _causal_conv_inc(h * m, u["conv"], up_conv, 3, f_val)

    h = _causal_block_inc(est.final_block, h, m, cs["final"], f_val)
    return _pointwise(h * m, est.final_proj) * m


def _step_slice(tree, i: int):
    if isinstance(tree, dict):
        return {k: _step_slice(v, i) for k, v in tree.items()}
    return tree[i]


@torch.no_grad()
def solve_euler_incremental(est: CausalConditionalDecoder, z: torch.Tensor,
                            mu: torch.Tensor, mask: torch.Tensor,
                            spks: torch.Tensor, cond: torch.Tensor,
                            cfg: FlowConfig, caches: Cache, t_past: int,
                            f_val: int) -> torch.Tensor:
    """Euler solve of the F new frames only (``solve_euler`` restricted
    to [t_past, t_past+F)), advancing the per-step caches in place."""
    ts, dts = t_schedule(cfg)
    B = z.shape[0]
    g = cfg.inference_cfg_rate
    mu2, mask2, spks2, cond2 = _cfg_rows(mu, mask, spks, cond)
    x = z
    for i, (t, dt) in enumerate(zip(ts, dts)):
        t2 = torch.full((2 * B,), float(t), dtype=x.dtype, device=x.device)
        v = estimator_incremental(est, torch.cat([x, x]), mask2, mu2, t2,
                                  spks2, cond2, cfg, _step_slice(caches, i),
                                  t_past, f_val)
        x = x + float(dt) * ((1.0 + g) * v[:B] - g * v[B:])
    return x


@torch.no_grad()
def encode_flow_tokens(flow: Flow, token: torch.Tensor,
                       token_len: torch.Tensor, cfg: FlowConfig,
                       enc_len: torch.Tensor) -> torch.Tensor:
    """Encoder stage of the incremental stream (the ``forward_flow``
    streaming/``enc_len`` encoder section): token prefix -> projected
    features h [B, ratio*W, 80]."""
    x = _embed_tokens(flow, token, token_len)
    h, _ = flow_encoder.forward(flow.encoder, x, enc_len, cfg.encoder,
                                streaming=True)
    return flow.encoder_proj(h)


@torch.no_grad()
def solve_flow_incremental(flow: Flow, mu_new: torch.Tensor,
                           prompt_feat: torch.Tensor,
                           prompt_feat_len: torch.Tensor,
                           embedding: torch.Tensor, cfg: FlowConfig,
                           caches: Cache, t_past: int,
                           noise_new: torch.Tensor, enc_len: int
                           ) -> torch.Tensor:
    """Solver stage of the incremental stream: Euler-solve only the new
    mel frames [t_past, t_past+F) against the per-step caches.

    ``mu_new`` [B, F, 80]: the encoder features at the new frames (from
    :func:`encode_flow_tokens`, sliced at ``t_past``); ``noise_new``
    [B, F, 80]: the utterance's noise buffer sliced likewise; ``enc_len``:
    the tokens encoded so far (host int, every row). Valid new frames are
    ratio*enc_len - t_past; rows past them are masked out of the caches
    and overwritten by the next call. Returns mel_new [B, F, 80] fp32."""
    emb = _speaker(flow, embedding)
    Fn = noise_new.shape[1]
    pos = t_past + torch.arange(Fn, device=mu_new.device)
    pmask = (pos[None, :] < prompt_feat_len[:, None])[..., None]
    Tp = prompt_feat.shape[1]
    pf_rows = prompt_feat[:, pos.clamp(0, Tp - 1)]
    cond_new = torch.where(pmask, pf_rows, torch.zeros_like(pf_rows))

    f_val = cfg.token_mel_ratio * int(enc_len) - t_past
    h_len = cfg.encoder.up_stride * int(enc_len)
    mask_new = (pos < h_len).to(mu_new.dtype)[None, :, None].expand(
        mu_new.shape[0], Fn, 1)
    feat = solve_euler_incremental(flow.decoder.estimator, noise_new, mu_new,
                                   mask_new * 1.0, emb, cond_new, cfg,
                                   caches, t_past, f_val)
    return feat.float()


# ---------------------------------------------------------------------------
# random init (the JAX init's draws, in its order)
# ---------------------------------------------------------------------------


def _numpy_estimator(host: np.random.Generator, cfg: FlowConfig) -> dict:
    C, Cin = cfg.est_channels, cfg.est_in_channels
    TE = C * 4
    inner = cfg.est_num_heads * cfg.est_head_dim
    ffi = C * 4

    def nrm(*shape):
        return host.normal(0, 0.02, shape).astype(np.float32)

    def ones(*shape):
        return np.ones(shape, np.float32)

    def zeros(*shape):
        return np.zeros(shape, np.float32)

    def resnet(cin, cout, n=None):
        def sh(*s):
            return (n,) + s if n is not None else s
        return {
            "block1": {"conv": {"w": nrm(*sh(3, cin, cout)),
                                "b": zeros(*sh(cout))},
                       "ln": {"scale": ones(*sh(cout)),
                              "bias": zeros(*sh(cout))}},
            "block2": {"conv": {"w": nrm(*sh(3, cout, cout)),
                                "b": zeros(*sh(cout))},
                       "ln": {"scale": ones(*sh(cout)),
                              "bias": zeros(*sh(cout))}},
            "mlp": {"w": nrm(*sh(TE, cout)), "b": zeros(*sh(cout))},
            "res": {"w": nrm(*sh(1, cin, cout)), "b": zeros(*sh(cout))},
        }

    def tf_blocks(n, outer=None):
        def sh(*s):
            return ((outer, n) if outer is not None else (n,)) + s
        return {
            "norm1": {"scale": ones(*sh(C)), "bias": zeros(*sh(C))},
            "norm3": {"scale": ones(*sh(C)), "bias": zeros(*sh(C))},
            "attn": {"q": {"w": nrm(*sh(C, inner))},
                     "k": {"w": nrm(*sh(C, inner))},
                     "v": {"w": nrm(*sh(C, inner))},
                     "out": {"w": nrm(*sh(inner, C)), "b": zeros(*sh(C))}},
            "ff1": {"w": nrm(*sh(C, ffi)), "b": zeros(*sh(ffi))},
            "ff2": {"w": nrm(*sh(ffi, C)), "b": zeros(*sh(C))},
        }

    M = cfg.est_num_mid_blocks
    return {
        "time_mlp": {"lin1": {"w": nrm(Cin, TE), "b": zeros(TE)},
                     "lin2": {"w": nrm(TE, TE), "b": zeros(TE)}},
        "down": {"resnet": resnet(Cin, C),
                 "blocks": tf_blocks(cfg.est_n_blocks),
                 "conv": {"w": nrm(3, C, C), "b": zeros(C)}},
        "mid": {"resnet": resnet(C, C, n=M),
                "blocks": tf_blocks(cfg.est_n_blocks, outer=M)},
        "up": {"resnet": resnet(2 * C, C),
               "blocks": tf_blocks(cfg.est_n_blocks),
               "conv": {"w": nrm(3, C, C), "b": zeros(C)}},
        "final_block": {"conv": {"w": nrm(3, C, C), "b": zeros(C)},
                        "ln": {"scale": ones(C), "bias": zeros(C)}},
        "final_proj": {"w": nrm(1, C, cfg.output_size),
                       "b": zeros(cfg.output_size)},
    }


def numpy_init_tree(cfg: FlowConfig, seed: int = 0) -> dict:
    """The JAX ``init_params`` pytree as numpy, drawn in its order from
    ``default_rng(seed)`` (the encoder from a fresh one, as in JAX; JAX
    draws from seed 0)."""
    host = np.random.default_rng(seed)
    D = cfg.input_size
    emb = host.normal(0, 0.02, (cfg.vocab_size, D)).astype(np.float32)
    spk = host.normal(0, 0.02, (cfg.spk_embed_dim,
                                cfg.output_size)).astype(np.float32)
    encoder = flow_encoder.numpy_init_tree(np.random.default_rng(seed),
                                           cfg.encoder)
    proj = host.normal(0, 0.02, (cfg.encoder.output_size,
                                 cfg.output_size)).astype(np.float32)
    return {
        "input_embedding": emb,
        "spk_affine": {"w": spk,
                       "b": np.zeros((cfg.output_size,), np.float32)},
        "encoder": encoder,
        "encoder_proj": {"w": proj,
                         "b": np.zeros((cfg.output_size,), np.float32)},
        "estimator": _numpy_estimator(host, cfg),
    }


def init_params(cfg: FlowConfig, seed: int = 0, device="cuda") -> Flow:
    """Random init seeded from numpy: with seed 0, the weights of the JAX
    ``init_params``."""
    from speech_distill_tpu_torch.models.convert import flow_params_from_jax
    return flow_params_from_jax(numpy_init_tree(cfg, seed), cfg, device)
