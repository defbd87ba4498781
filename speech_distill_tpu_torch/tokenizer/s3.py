"""The S3 / CosyVoice2 semantic speech tokenizer in torch (port of
``speech_distill_tpu/tokenizer/s3.py``).

``speech_tokenizer_v2_25hz``: a whisper-style log-mel (128) -> an audio
encoder -> FSQ -> a 6,561-entry codebook at 25 Hz (reference utils.py:69,
95; soulxpodcast/models/soulxpodcast.py:24-26).

Architecture (s3tokenizer v2, whisper-encoder lineage):
  conv1 k3 s2 + GELU -> conv2 k3 s2 + GELU   (100 Hz mel frames -> 25 Hz)
  + fixed sinusoidal positions
  N pre-LN transformer blocks (MHA: q/v/out biased, k unbiased; GELU MLP)
  ln_post -> FSQ: Linear(d -> 8), tanh * 0.999, round to {-1, 0, 1},
  code = sum_i digit_i * 3^i  (3^8 = 6561 codes)

The modules carry the s3tokenizer checkpoint's names
(``encoder.conv{1,2}``, ``encoder.blocks.{i}.attn.{query,key,value,out}``,
``attn_ln``, ``mlp.{0,2}``, ``mlp_ln``, ``encoder.ln_post``,
``quantizer.project_down``), so ``state_dict()`` is the checkpoint file;
the loader also takes ``quantizer._codebook.project_down.*``.

Precision: ``quantize(precision="float32")`` runs its convolutions and
products in full fp32 whatever the caller's TF32 flags
(``core/device.full_fp32``): FSQ rounds ``tanh(h) * 0.999`` at +-0.5, and
TF32's 10 mantissa bits flip codes near that edge. ``"bfloat16"`` runs
them with bf16 operands (autocast), where codes near an edge may flip, as
JAX's single-pass bf16 products do.
"""
from __future__ import annotations

import dataclasses
import os
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from speech_distill_tpu_torch.audio.mel import log_mel_spectrogram
from speech_distill_tpu_torch.audio.resample import resample
from speech_distill_tpu_torch.core.device import full_fp32, resolve_device

PRECISIONS = ("float32", "bfloat16")


@dataclasses.dataclass
class S3Config:
    n_mels: int = 128
    n_state: int = 1280
    n_head: int = 20
    n_layer: int = 6
    fsq_dim: int = 8
    fsq_level: int = 3
    max_ctx: int = 1500          # positions at 50 Hz (after conv1)

    @property
    def codebook_size(self) -> int:
        return self.fsq_level ** self.fsq_dim  # 6561


def s3_tiny() -> S3Config:
    return S3Config(n_mels=16, n_state=32, n_head=4, n_layer=2, max_ctx=64)


def sinusoids(length: int, channels: int) -> np.ndarray:
    """Whisper's fixed sinusoidal position embedding."""
    log_timescale = np.log(10000) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)],
                          axis=1).astype(np.float32)


# ---------------------------------------------------------------------------
# modules (the checkpoint's names)
# ---------------------------------------------------------------------------


class MultiHeadAttention(nn.Module):
    def __init__(self, n_state: int, dev):
        super().__init__()
        self.query = nn.Linear(n_state, n_state, device=dev)
        self.key = nn.Linear(n_state, n_state, bias=False, device=dev)
        self.value = nn.Linear(n_state, n_state, device=dev)
        self.out = nn.Linear(n_state, n_state, device=dev)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, n_state: int, dev):
        super().__init__()
        self.attn = MultiHeadAttention(n_state, dev)
        self.attn_ln = nn.LayerNorm(n_state, device=dev)
        self.mlp = nn.Sequential(nn.Linear(n_state, 4 * n_state, device=dev),
                                 nn.GELU(),
                                 nn.Linear(4 * n_state, n_state, device=dev))
        self.mlp_ln = nn.LayerNorm(n_state, device=dev)


class AudioEncoder(nn.Module):
    def __init__(self, cfg: S3Config, dev):
        super().__init__()
        D = cfg.n_state
        self.conv1 = nn.Conv1d(cfg.n_mels, D, 3, stride=2, padding=1,
                               device=dev)
        self.conv2 = nn.Conv1d(D, D, 3, stride=2, padding=1, device=dev)
        self.blocks = nn.ModuleList(ResidualAttentionBlock(D, dev)
                                    for _ in range(cfg.n_layer))
        self.ln_post = nn.LayerNorm(D, device=dev)


class FSQQuantizer(nn.Module):
    def __init__(self, cfg: S3Config, dev):
        super().__init__()
        self.project_down = nn.Linear(cfg.n_state, cfg.fsq_dim, device=dev)


class S3Encoder(nn.Module):
    """The tokenizer's weights: ``encoder`` and ``quantizer`` (fp32,
    inference only)."""

    def __init__(self, cfg: S3Config, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.encoder = AudioEncoder(cfg, dev)
        self.quantizer = FSQQuantizer(cfg, dev)
        self.requires_grad_(False)

    @property
    def device(self) -> torch.device:
        return self.encoder.conv1.weight.device


def init_params_on_device(seed: int, cfg: S3Config,
                          device="cuda") -> S3Encoder:
    """Random init drawn on ``device`` (CUDA by default; raises without
    it) from a seeded ``torch.Generator`` there: normal(0, 0.02) weights,
    ones for the LayerNorm scales, zeros for the biases (JAX's init
    kinds). The reference encoder's ~0.5 GB never crosses the host; the
    stream is torch's, so the weights differ from JAX's for a seed."""
    model = S3Encoder(cfg, device)
    gen = torch.Generator(device=model.device).manual_seed(seed)
    for m in model.modules():
        if isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
        elif isinstance(m, (nn.Linear, nn.Conv1d)):
            m.weight.normal_(0.0, 0.02, generator=gen)
        else:
            continue
        if m.bias is not None:
            m.bias.zero_()
    return model


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _attention(attn: MultiHeadAttention, h: torch.Tensor,
               bias: Optional[torch.Tensor], n_head: int) -> torch.Tensor:
    B, T, D = h.shape
    Dh = D // n_head
    scale = Dh ** -0.25
    q = attn.query(h).view(B, T, n_head, Dh) * scale
    k = attn.key(h).view(B, T, n_head, Dh) * scale
    v = attn.value(h).view(B, T, n_head, Dh)
    logits = torch.einsum("bthd,bshd->bhts", q, k).float()
    if bias is not None:
        logits = logits + bias
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    o = torch.einsum("bhts,bshd->bthd", w, v).reshape(B, T, D)
    return attn.out(o)


@torch.no_grad()
def encode(model: S3Encoder, mels: torch.Tensor,
           mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """mels [B, n_mels, T] -> hidden [B, ceil(ceil(T/2)/2), n_state].

    ``mask``: optional [B, T'] validity of the keys (padded batches; a
    padded key's logit gets -1e30). GELU is the exact (erf) form."""
    cfg, enc = model.cfg, model.encoder
    x = F.gelu(enc.conv1(mels))
    x = F.gelu(enc.conv2(x)).transpose(1, 2)           # [B, T', D]
    T = x.shape[1]
    x = x + torch.from_numpy(sinusoids(T, cfg.n_state)).to(x.device)
    bias = None
    if mask is not None:
        bias = torch.where(mask.bool()[:, None, None, :], 0.0, -1e30
                           ).float()
    for blk in enc.blocks:
        x = x + _attention(blk.attn, blk.attn_ln(x), bias, cfg.n_head)
        x = x + blk.mlp(blk.mlp_ln(x))
    return enc.ln_post(x)


@torch.no_grad()
def fsq_encode(model: S3Encoder, hidden: torch.Tensor) -> torch.Tensor:
    """hidden [B, T, D] -> int64 codes [B, T] in [0, 3^8)."""
    cfg = model.cfg
    h = model.quantizer.project_down(hidden.float()).float()
    # tanh clamp (slightly < 1 so round never reaches +-2), round to
    # {-1, 0, 1} (half to even, as jnp.round)
    h = torch.tanh(h) * np.float32(0.999)
    digits = torch.round(h) + (cfg.fsq_level - 1) / 2
    powers = cfg.fsq_level ** torch.arange(cfg.fsq_dim, device=h.device)
    return (digits.long() * powers).sum(-1)


def conv_out_len(n):
    """Output length of one k3/s2/p1 conv: ceil(n/2)."""
    return (n + 1) // 2


@torch.no_grad()
def quantize(model: S3Encoder, mels: torch.Tensor, mels_lens: torch.Tensor,
             precision: str = "float32"
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched mel [B, n_mels, T], lens [B] -> (codes [B, T'], code_lens
    [B]) on the model's device; the reference's call surface (utils.py:95).
    T' = ceil(ceil(T/2)/2), not T // 4 (one frame short when T % 4 != 0).
    Codes past a row's length are 0."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be 'float32' or 'bfloat16', "
                         f"got {precision!r}")
    dev = model.device
    mels = torch.as_tensor(mels, dtype=torch.float32).to(dev)
    lens = torch.as_tensor(mels_lens).to(dev).long()
    T_out = conv_out_len(conv_out_len(mels.shape[-1]))
    code_lens = conv_out_len(conv_out_len(lens))
    mask = torch.arange(T_out, device=dev)[None, :] < code_lens[:, None]
    with full_fp32(), torch.autocast(dev.type, dtype=torch.bfloat16,
                                     enabled=precision == "bfloat16"):
        codes = fsq_encode(model, encode(model, mels, mask))
    return codes * mask, code_lens


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _canonical(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The checkpoint's keys under this module's names: the
    ``quantizer._codebook.`` prefix folded, ``conv1.weight`` style keys
    without ``encoder.`` given it, other keys (buffers of the reference
    module) dropped."""
    out = {}
    for k, v in state.items():
        k = k.replace("quantizer._codebook.", "quantizer.")
        if k.startswith(("conv1.", "conv2.")):
            k = "encoder." + k
        if k.startswith(("encoder.conv", "encoder.blocks.",
                         "encoder.ln_post.", "quantizer.project_down.")):
            out[k] = v
    return out


def config_from_state(state: Dict[str, torch.Tensor]) -> S3Config:
    """The architecture from checkpoint shapes (heads follow whisper's
    64-dim convention: 1280 / 64 = 20 for the real v2)."""
    state = _canonical(state)
    conv1 = state["encoder.conv1.weight"]
    n_state, n_mels = int(conv1.shape[0]), int(conv1.shape[1])
    n_layer = 1 + max(int(k.split(".")[2]) for k in state
                      if k.startswith("encoder.blocks."))
    fsq = state["quantizer.project_down.weight"]
    return S3Config(n_mels=n_mels, n_state=n_state,
                    n_head=max(1, n_state // 64), n_layer=n_layer,
                    fsq_dim=int(fsq.shape[0]))


def from_state_dict(state: Dict[str, torch.Tensor],
                    cfg: Optional[S3Config] = None,
                    device="cuda") -> S3Encoder:
    """An :class:`S3Encoder` on ``device`` holding a checkpoint's weights
    (fp32; every encoder and quantizer weight required)."""
    state = _canonical(state)
    model = S3Encoder(cfg or config_from_state(state), device)
    model.load_state_dict({k: torch.as_tensor(v).float()
                           for k, v in state.items()}, strict=True)
    return model


# ---------------------------------------------------------------------------
# end to end: audio -> codes
# ---------------------------------------------------------------------------


class S3Tokenizer:
    """Audio (any rate) -> 25 Hz codes: a host resample to 16 kHz, the
    log-mel and :func:`quantize` on the model's device. Mels are padded to
    a multiple of ``pad_to_multiple_of`` frames (JAX's compile buckets;
    the codes do not depend on the padding)."""

    def __init__(self, model: S3Encoder, pad_to_multiple_of: int = 128):
        self.model = model
        self.cfg = model.cfg
        self.pad_to = pad_to_multiple_of

    def _mel(self, audio, sr: int) -> torch.Tensor:
        audio = np.asarray(audio, np.float32)
        if sr != 16000:
            audio = resample(audio, sr, 16000)
        return log_mel_spectrogram(
            torch.from_numpy(audio).to(self.model.device), self.cfg.n_mels)

    def __call__(self, audio, sr: int = 16000) -> List[int]:
        """One clip -> its codes."""
        return self.batch([audio], [sr])[0]

    def batch(self, audios, srs=None) -> List[List[int]]:
        """Many clips -> their codes in ONE padded quantize call
        (reference ``get_speech_tokens_batch``, utils.py:102-147)."""
        if not len(audios):
            return []
        mels = [self._mel(a, 16000 if srs is None else int(srs[i]))
                for i, a in enumerate(audios)]
        lens = [m.shape[-1] for m in mels]
        Tp = -(-max(lens) // self.pad_to) * self.pad_to
        batch = torch.stack([F.pad(m, (0, Tp - m.shape[-1])) for m in mels])
        codes, clens = quantize(self.model, batch, torch.tensor(lens))
        codes, clens = codes.cpu().numpy(), clens.tolist()
        return [codes[i, :clens[i]].tolist() for i in range(len(mels))]


def load_s3_tokenizer(ckpt_path: Optional[str] = None,
                      device="cuda") -> S3Tokenizer:
    """The tokenizer of a torch checkpoint (``ckpt_path`` or
    ``$S3_TOKENIZER_CKPT``) on ``device`` (CUDA by default; raises without
    it)."""
    dev = resolve_device(device)
    ckpt_path = ckpt_path or os.environ.get("S3_TOKENIZER_CKPT")
    if not ckpt_path or not os.path.exists(ckpt_path):
        raise FileNotFoundError(
            "S3 tokenizer checkpoint not found. Set S3_TOKENIZER_CKPT to the "
            "torch 'speech_tokenizer_v2_25hz' checkpoint, or provide a "
            "'codes' column in the dataset to skip audio tokenization.")
    state = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and "model" in state:
        state = state["model"]
    return S3Tokenizer(from_state_dict(state, device=dev))


def default_speech_tokens_fn(device="cuda"):
    """speech_tokens_fn for the processors: a lazy singleton over
    ``$S3_TOKENIZER_CKPT`` on ``device`` (the reference's per-process lazy
    global, utils.py:10,66-69). Takes a ``{"array", "sampling_rate"}``
    dict, a wav path (int PCM scaled by 1/32768, as
    ``s3tokenizer.load_audio``) or a 16 kHz array."""
    holder = {}
    lock = threading.Lock()      # the CLIs' worker threads share it

    def fn(audio_input):
        with lock:
            if "tok" not in holder:
                holder["tok"] = load_s3_tokenizer(device=device)
        tok = holder["tok"]
        if isinstance(audio_input, dict):
            return tok(np.asarray(audio_input["array"], np.float32),
                       int(audio_input.get("sampling_rate", 16000)))
        if isinstance(audio_input, str):
            from scipy.io.wavfile import read as wav_read
            sr, data = wav_read(audio_input)
            is_int = np.issubdtype(data.dtype, np.integer)
            data = data.astype(np.float32)
            if is_int:
                data = data / 32768.0
            return tok(data, sr)
        return tok(np.asarray(audio_input, np.float32), 16000)

    return fn
