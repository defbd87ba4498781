"""HiFT vocoder (mel -> waveform), port of
``speech_distill_tpu/models/hift.py``.

The reference HiFTNet: ConvRNNF0Predictor (mel -> F0) -> NSF harmonic
source (SineGen2 for 24 kHz) -> conv-transpose upsample stack [8, 5, 3]
with per-stage source fusion and Snake-activated ResBlocks -> conv_post
-> exp/sin ISTFT head (n_fft 16, hop 4; 480x from 50 Hz mel to 24 kHz).

Layout: channel-last [B, T, C] as in JAX; convolutions transpose to
[B, C, T] at ``F.conv1d`` / ``F.conv_transpose1d`` only. The modules carry
the reference torch names (``conv_pre``, ``ups.{i}``,
``resblocks.{i}.convs1.{j}``, ``f0_predictor.condnet.{2i}``,
``m_source.l_linear``, ...), so a released ``hift.pt`` loads with
``load_state_dict(fold_weight_norm(state))``. STFT/ISTFT are JAX's rFFT +
overlap-add arithmetic (the overlap-add by ``F.fold``, which sums in a
fixed order), with JAX's ``max(wsq, 1e-11)`` divide, not ``torch.istft``.

Randomness: the NSF source takes explicit draws ``(rand_ini [B, H],
noise_u [B, T, H])``, one ``torch.Generator`` for the batch, or one
generator per row; with per-row generators (or per-row draws) each row of
a batched call equals its B = 1 call. Inference only: the parameters do
not require grad.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from speech_distill_tpu_torch.core.device import resolve_device


@dataclasses.dataclass
class HiFTConfig:
    in_channels: int = 80
    base_channels: int = 512
    nb_harmonics: int = 8
    sampling_rate: int = 24000
    nsf_alpha: float = 0.1
    nsf_sigma: float = 0.003
    nsf_voiced_threshold: float = 10.0
    upsample_rates: Tuple[int, ...] = (8, 5, 3)
    upsample_kernel_sizes: Tuple[int, ...] = (16, 11, 7)
    istft_n_fft: int = 16
    istft_hop: int = 4
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilations: Tuple[Tuple[int, ...], ...] = ((1, 3, 5),) * 3
    source_resblock_kernel_sizes: Tuple[int, ...] = (7, 7, 11)
    source_resblock_dilations: Tuple[Tuple[int, ...], ...] = ((1, 3, 5),) * 3
    lrelu_slope: float = 0.1
    audio_limit: float = 0.99
    f0_cond_channels: int = 512

    @property
    def upsample_scale(self) -> int:
        return int(np.prod(self.upsample_rates)) * self.istft_hop


# ---------------------------------------------------------------------------
# modules (reference names)
# ---------------------------------------------------------------------------


class Snake(nn.Module):
    def __init__(self, ch: int, device=None):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(ch, device=device))


class ResBlock(nn.Module):
    def __init__(self, ch: int, k: int, dilations: Sequence[int],
                 device=None):
        super().__init__()
        self.convs1 = nn.ModuleList(
            nn.Conv1d(ch, ch, k, dilation=d, device=device)
            for d in dilations)
        self.convs2 = nn.ModuleList(
            nn.Conv1d(ch, ch, k, device=device) for _ in dilations)
        self.activations1 = nn.ModuleList(Snake(ch, device)
                                          for _ in dilations)
        self.activations2 = nn.ModuleList(Snake(ch, device)
                                          for _ in dilations)


class ConvRNNF0Predictor(nn.Module):
    """``condnet`` = 5 x (Conv1d k3, ELU): convs at 0, 2, 4, 6, 8."""

    def __init__(self, cin: int, ch: int, device=None):
        super().__init__()
        layers = []
        for i in range(5):
            layers += [nn.Conv1d(cin if i == 0 else ch, ch, 3, device=device),
                       nn.ELU()]
        self.condnet = nn.Sequential(*layers)
        self.classifier = nn.Linear(ch, 1, device=device)


class SourceModuleHnNSF(nn.Module):
    def __init__(self, harmonics: int, device=None):
        super().__init__()
        self.l_linear = nn.Linear(harmonics, 1, device=device)


class HiFTGenerator(nn.Module):
    def __init__(self, cfg: HiFTConfig, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        C = cfg.base_channels
        nf2 = cfg.istft_n_fft + 2
        self.f0_predictor = ConvRNNF0Predictor(cfg.in_channels,
                                               cfg.f0_cond_channels, dev)
        self.m_source = SourceModuleHnNSF(cfg.nb_harmonics + 1, dev)
        self.conv_pre = nn.Conv1d(cfg.in_channels, C, 7, device=dev)
        self.ups = nn.ModuleList(
            nn.ConvTranspose1d(C // 2 ** i, C // 2 ** (i + 1), k, u,
                               device=dev)
            for i, (u, k) in enumerate(zip(cfg.upsample_rates,
                                           cfg.upsample_kernel_sizes)))
        self.source_downs = nn.ModuleList()
        self.source_resblocks = nn.ModuleList()
        for i, (k, d) in enumerate(zip(cfg.source_resblock_kernel_sizes,
                                       cfg.source_resblock_dilations)):
            ch = C // 2 ** (i + 1)
            s = _source_stride(cfg, i)
            self.source_downs.append(nn.Conv1d(
                nf2, ch, 1 if s == 1 else 2 * s, stride=s, device=dev))
            self.source_resblocks.append(ResBlock(ch, k, d, dev))
        self.resblocks = nn.ModuleList(
            ResBlock(C // 2 ** (i + 1), k, d, dev)
            for i in range(len(cfg.upsample_rates))
            for k, d in zip(cfg.resblock_kernel_sizes,
                            cfg.resblock_dilations))
        self.conv_post = nn.Conv1d(C // 2 ** len(cfg.upsample_rates), nf2, 7,
                                   device=dev)
        self.requires_grad_(False)

    @property
    def device(self) -> torch.device:
        return self.conv_pre.weight.device


def _source_stride(cfg: HiFTConfig, i: int) -> int:
    """Downsample stride of stage ``i``'s source branch: the product of
    the later upsample rates."""
    return int(np.prod(cfg.upsample_rates[i + 1:], dtype=np.int64))


# ---------------------------------------------------------------------------
# primitives (channel-last [B, T, C])
# ---------------------------------------------------------------------------


def _conv(x: torch.Tensor, conv: nn.Conv1d, stride: int = 1,
          padding: int = 0, dilation: int = 1) -> torch.Tensor:
    return F.conv1d(x.transpose(1, 2), conv.weight, conv.bias,
                    stride=stride, padding=padding,
                    dilation=dilation).transpose(1, 2)


def _conv_transpose(x: torch.Tensor, conv: nn.ConvTranspose1d, stride: int,
                    padding: int) -> torch.Tensor:
    """torch ConvTranspose1d(k, s, p): out = (T-1)*s - 2p + k; weight
    [Cin, Cout, k]."""
    return F.conv_transpose1d(x.transpose(1, 2), conv.weight, conv.bias,
                              stride=stride,
                              padding=padding).transpose(1, 2)


def _snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Snake activation x + sin^2(a x) / a (linear scale)."""
    a = alpha[None, None, :]
    return x + (1.0 / (a + 1e-9)) * torch.square(torch.sin(x * a))


def _resblock(rb: ResBlock, x: torch.Tensor, kernel: int,
              dilations: Sequence[int]) -> torch.Tensor:
    """HiFiGAN/BigVGAN ResBlock with Snake activations."""
    for i, d in enumerate(dilations):
        h = _snake(x, rb.activations1[i].alpha)
        h = _conv(h, rb.convs1[i], padding=(kernel * d - d) // 2,
                  dilation=d)
        h = _snake(h, rb.activations2[i].alpha)
        h = _conv(h, rb.convs2[i], padding=(kernel - 1) // 2)
        x = x + h
    return x


# ---------------------------------------------------------------------------
# STFT / ISTFT heads (torch.stft/istft semantics, center=True)
# ---------------------------------------------------------------------------


def hann_window(n_fft: int, device=None) -> torch.Tensor:
    return torch.from_numpy(
        np.hanning(n_fft + 1)[:-1].astype(np.float32)).to(device)


def _stft(x: torch.Tensor, n_fft: int, hop: int, window: torch.Tensor):
    """x [B, T] -> (real, imag) [B, F, TT]."""
    pad = n_fft // 2
    xp = F.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]
    frames = xp.unfold(-1, n_fft, hop) * window
    spec = torch.fft.rfft(frames, dim=-1)
    return spec.real.transpose(1, 2), spec.imag.transpose(1, 2)


def _overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """[B, TT, n] frames -> [B, n + hop*(TT-1)] summed at hop strides."""
    B, TT, n = frames.shape
    out_len = n + hop * (TT - 1)
    return F.fold(frames.transpose(1, 2), (1, out_len), (1, n),
                  stride=(1, hop)).reshape(B, out_len)


def _istft(real: torch.Tensor, imag: torch.Tensor, n_fft: int, hop: int,
           window: torch.Tensor) -> torch.Tensor:
    """(real, imag) [B, F, TT] -> [B, (TT-1)*hop]."""
    spec = torch.complex(real, imag).transpose(1, 2)         # [B, TT, F]
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1) * window
    TT = frames.shape[1]
    sig = _overlap_add(frames, hop)
    wsq = _overlap_add(torch.square(window).expand(1, TT, n_fft), hop)
    sig = sig / torch.clamp(wsq, min=1e-11)
    pad = n_fft // 2
    return sig[:, pad:sig.shape[1] - pad]


# ---------------------------------------------------------------------------
# F0 predictor + NSF source
# ---------------------------------------------------------------------------


def f0_predict(f0p: ConvRNNF0Predictor, mel: torch.Tensor) -> torch.Tensor:
    """ConvRNNF0Predictor: mel [B, T, 80] -> f0 [B, T]."""
    x = mel
    for conv in f0p.condnet[0::2]:
        x = F.elu(_conv(x, conv, padding=1))
    return torch.abs(f0p.classifier(x))[..., 0]


def _interp_linear(x: torch.Tensor, out_len: int) -> torch.Tensor:
    """F.interpolate(mode='linear', align_corners=False) on [B, T, C], in
    JAX's arithmetic (fp64 positions, fp32 weights)."""
    T = x.shape[1]
    scale = T / out_len
    pos = (np.arange(out_len) + 0.5) * scale - 0.5
    lo = np.clip(np.floor(pos).astype(np.int64), 0, T - 1)
    hi = np.clip(lo + 1, 0, T - 1)
    w = (pos - np.floor(pos)).astype(np.float32)
    w = np.where(pos < 0, np.float32(0.0), w)
    w = torch.from_numpy(w).to(x.device)[None, :, None]
    lo_t = torch.from_numpy(lo).to(x.device)
    hi_t = torch.from_numpy(hi).to(x.device)
    return x[:, lo_t] * (1 - w) + x[:, hi_t] * w


def nsf_draws(generator: Optional[torch.Generator], B: int, T: int, H: int,
              device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The NSF source's random inputs from one generator: (rand_ini
    [B, H] uniform, noise_u [B, T, H] normal), in that order."""
    rand_ini = torch.rand((B, H), generator=generator, device=device)
    noise_u = torch.randn((B, T, H), generator=generator, device=device)
    return rand_ini, noise_u


def nsf_source(src: SourceModuleHnNSF, f0_up: torch.Tensor, cfg: HiFTConfig,
               generator: Optional[torch.Generator] = None,
               per_row_generators: Optional[Sequence[torch.Generator]]
               = None,
               draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
               ) -> torch.Tensor:
    """SineGen2 + SourceModuleHnNSF2: f0_up [B, T_audio, 1] (already
    upsampled x480) -> source s [B, T_audio].

    The random inputs come from ``draws`` when given, else one
    :func:`nsf_draws` a row from ``per_row_generators`` (each row then
    equals its B = 1 call with that generator), else from
    ``generator``."""
    B, T, _ = f0_up.shape
    H = cfg.nb_harmonics + 1
    dev = f0_up.device
    if draws is not None:
        rand_ini, noise_u = draws
    elif per_row_generators is not None:
        rows = [nsf_draws(g, 1, T, H, dev) for g in per_row_generators]
        rand_ini = torch.cat([r[0] for r in rows])
        noise_u = torch.cat([r[1] for r in rows])
    else:
        rand_ini, noise_u = nsf_draws(generator, B, T, H, dev)

    fn = f0_up * torch.arange(1, H + 1, dtype=torch.float32,
                              device=dev)[None, None, :]
    rad = torch.remainder(fn / cfg.sampling_rate, 1.0)
    rand_ini = rand_ini.clone()
    rand_ini[:, 0] = 0.0
    rad[:, 0, :] += rand_ini

    scale = cfg.upsample_scale
    rad_ds = _interp_linear(rad, T // scale)
    phase = torch.cumsum(rad_ds, dim=1) * 2 * np.pi
    phase = _interp_linear(phase * scale, T)
    sines = torch.sin(phase) * cfg.nsf_alpha

    uv = (f0_up > cfg.nsf_voiced_threshold).float()
    noise_amp = uv * cfg.nsf_sigma + (1 - uv) * cfg.nsf_alpha / 3
    sine_waves = sines * uv + noise_amp * noise_u
    return torch.tanh(src.l_linear(sine_waves))[..., 0]


# ---------------------------------------------------------------------------
# generator
# ---------------------------------------------------------------------------


@torch.no_grad()
def decode(hift: HiFTGenerator, mel: torch.Tensor, source: torch.Tensor,
           cfg: HiFTConfig) -> torch.Tensor:
    """mel [B, T, 80] + source [B, T*480] -> waveform [B, T*480]."""
    window = hann_window(cfg.istft_n_fft, mel.device)
    sr, si_ = _stft(source, cfg.istft_n_fft, cfg.istft_hop, window)
    s_stft = torch.cat([sr, si_], dim=1).transpose(1, 2)     # [B, TT, 18]

    x = _conv(mel, hift.conv_pre, padding=3)
    n_up = len(cfg.upsample_rates)
    nk = len(cfg.resblock_kernel_sizes)
    for i in range(n_up):
        x = F.leaky_relu(x, cfg.lrelu_slope)
        k, u = cfg.upsample_kernel_sizes[i], cfg.upsample_rates[i]
        x = _conv_transpose(x, hift.ups[i], u, (k - u) // 2)
        if i == n_up - 1:
            x = torch.cat([x[:, 1:2], x], dim=1)   # reflection pad (1, 0)

        stride = _source_stride(cfg, i)
        sd = hift.source_downs[i]
        if stride == 1:
            si = F.linear(s_stft, sd.weight[:, :, 0], sd.bias)
        else:
            si = _conv(s_stft, sd, stride=stride, padding=stride // 2)
        si = _resblock(hift.source_resblocks[i], si,
                       cfg.source_resblock_kernel_sizes[i],
                       cfg.source_resblock_dilations[i])
        x = x + si

        acc = None
        for j in range(nk):
            r = _resblock(hift.resblocks[i * nk + j], x,
                          cfg.resblock_kernel_sizes[j],
                          cfg.resblock_dilations[j])
            acc = r if acc is None else acc + r
        x = acc / nk

    x = F.leaky_relu(x, 0.01)               # default torch slope here
    x = _conv(x, hift.conv_post, padding=3)
    nf = cfg.istft_n_fft // 2 + 1
    magnitude = torch.clamp(torch.exp(x[..., :nf]), max=1e2)
    phase = torch.sin(x[..., nf:])
    real = (magnitude * torch.cos(phase)).transpose(1, 2)
    imag = (magnitude * torch.sin(phase)).transpose(1, 2)
    wav = _istft(real, imag, cfg.istft_n_fft, cfg.istft_hop, window)
    return torch.clamp(wav, -cfg.audio_limit, cfg.audio_limit)


@torch.no_grad()
def forward(hift: HiFTGenerator, mel: torch.Tensor, cfg: HiFTConfig,
            generator: Optional[torch.Generator] = None,
            cache_source: Optional[torch.Tensor] = None,
            per_row_generators: Optional[Sequence[torch.Generator]] = None,
            draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """mel [B, T, 80] -> (wav [B, T*480], source). ``cache_source``: the
    previous call's source tail, spliced in front (phase continuity in
    streaming synthesis). The NSF draws as in :func:`nsf_source`."""
    f0 = f0_predict(hift.f0_predictor, mel)                  # [B, T]
    # torch.nn.Upsample(scale_factor=480) is a nearest-neighbour repeat
    f0_up = torch.repeat_interleave(f0, cfg.upsample_scale, dim=1)[..., None]
    s = nsf_source(hift.m_source, f0_up, cfg, generator,
                   per_row_generators, draws)
    if cache_source is not None and cache_source.shape[-1] > 0:
        n = cache_source.shape[-1]
        s = torch.cat([cache_source.to(s.dtype), s[:, n:]], dim=1)
    return decode(hift, mel, s, cfg), s


# ---------------------------------------------------------------------------
# random init (the JAX init's draws, in its order) and weight norm
# ---------------------------------------------------------------------------


def numpy_init_tree(cfg: HiFTConfig, seed: int = 0) -> dict:
    """The JAX ``init_params`` pytree as numpy, drawn in its order from
    ``default_rng(seed)`` (JAX draws from seed 0)."""
    host = np.random.default_rng(seed)

    def conv(k, cin, cout):
        return {"w": host.normal(0, 0.01, (k, cin, cout)).astype(np.float32),
                "b": np.zeros((cout,), np.float32)}

    def resblock(ch, k, dil):
        n = len(dil)
        return {
            "convs1": {"w": host.normal(0, 0.01, (n, k, ch, ch)).astype(
                np.float32), "b": np.zeros((n, ch), np.float32)},
            "convs2": {"w": host.normal(0, 0.01, (n, k, ch, ch)).astype(
                np.float32), "b": np.zeros((n, ch), np.float32)},
            "alpha1": np.ones((n, ch), np.float32),
            "alpha2": np.ones((n, ch), np.float32),
        }

    C = cfg.base_channels
    nf2 = cfg.istft_n_fft + 2
    # conv-transpose kernels live as [k, Cout, Cin], biases [Cout]
    ups = [{"w": conv(k, C // 2 ** (i + 1), C // 2 ** i)["w"],
            "b": np.zeros((C // 2 ** (i + 1),), np.float32)}
           for i, k in enumerate(cfg.upsample_kernel_sizes)]
    down_rates = [1] + list(cfg.upsample_rates[::-1][:-1])
    cum = np.cumprod(down_rates)[::-1]
    source_downs, source_resblocks = [], []
    for i, (u, k, d) in enumerate(zip(cum, cfg.source_resblock_kernel_sizes,
                                      cfg.source_resblock_dilations)):
        ch = C // 2 ** (i + 1)
        source_downs.append(conv(1 if u == 1 else int(u) * 2, nf2, ch))
        source_resblocks.append(resblock(ch, k, d))
    resblocks = [[resblock(C // 2 ** (i + 1), k, d)
                  for k, d in zip(cfg.resblock_kernel_sizes,
                                  cfg.resblock_dilations)]
                 for i in range(len(ups))]
    f0_conv = [conv(3, cfg.in_channels if i == 0 else cfg.f0_cond_channels,
                    cfg.f0_cond_channels) for i in range(5)]
    cls_w = host.normal(0, 0.01, (cfg.f0_cond_channels, 1)).astype(
        np.float32)
    src_w = host.normal(0, 0.1, (cfg.nb_harmonics + 1, 1)).astype(np.float32)
    return {
        "f0_predictor": {"conv": f0_conv,
                         "cls": {"w": cls_w,
                                 "b": np.zeros((1,), np.float32)}},
        "m_source": {"linear": {"w": src_w,
                                "b": np.zeros((1,), np.float32)}},
        "conv_pre": conv(7, cfg.in_channels, C),
        "ups": ups,
        "source_downs": source_downs,
        "source_resblocks": source_resblocks,
        "resblocks": resblocks,
        "conv_post": conv(7, C // 2 ** len(ups), nf2),
    }


def init_params(cfg: HiFTConfig, seed: int = 0, device="cuda"
                ) -> HiFTGenerator:
    """Random init seeded from numpy: with seed 0, the weights of the JAX
    ``init_params``."""
    from speech_distill_tpu_torch.models.convert import hift_params_from_jax
    return hift_params_from_jax(numpy_init_tree(cfg, seed), cfg, device)


def fold_weight_norm(state: Dict[str, object]) -> Dict[str, torch.Tensor]:
    """Fold weight norm (``weight_g``/``weight_v`` or
    ``parametrizations.weight.original0/1``) into plain ``weight`` entries;
    fp32 CPU tensors out, for ``load_state_dict``."""
    def t_(a) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.detach().to(torch.float32).cpu()
        return torch.from_numpy(np.asarray(a, np.float32))

    out: Dict[str, torch.Tensor] = {}
    handled = set()
    for k in list(state):
        if k.endswith("weight_g") or k.endswith(
                "parametrizations.weight.original0"):
            base = k.rsplit(".", 1)[0].replace("parametrizations.weight",
                                               "").rstrip(".")
            if k.endswith("weight_g"):
                gk, vk = k, base + ".weight_v"
            else:
                gk, vk = k, k.replace("original0", "original1")
            g, v = t_(state[gk]), t_(state[vk])
            norm = torch.sqrt(torch.sum(v ** 2, dim=tuple(range(1, v.dim())),
                                        keepdim=True))
            out[base + ".weight"] = g * v / torch.clamp(norm, min=1e-12)
            handled.update((gk, vk))
    for k, a in state.items():
        if k not in handled and not k.endswith((".original0", ".original1")):
            out[k] = t_(a)
    return out
