"""CAM++ (D-TDNN) speaker embedding, inference (port of
``speech_distill_tpu/models/campplus.py``).

The published architecture (3D-Speaker / modelscope
``speakerlab.models.campplus.DTDNN.CAMPPlus``, the model campplus.onnx is
exported from; reference soulxpodcast/utils/dataloader.py:93-102,143-154):
an FCM 2-D residual front end -> a D-TDNN backbone of Context-Aware
Masking dense layers -> stats pooling -> a dense embedding, eval-mode
BatchNorm throughout.

The modules carry the torch ``CAMPPlus`` state-dict names (``head.conv1``,
``xvector.block1.tdnnd1.cam_layer.linear_local``, ...), so a released
``campplus.pt`` loads with ``load_state_dict``. JAX pads an utterance to
a frame bucket and re-masks the tail after every layer so one compiled
program serves many lengths; here each utterance runs at its own length
(a batch of mixed lengths one utterance at a time), which is the
computation that masking reproduces. Convolutions and products run in
full fp32 whatever the caller's TF32 flags.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from speech_distill_tpu_torch.core.device import full_fp32, resolve_device


@dataclasses.dataclass(frozen=True)
class CampPlusConfig:
    feat_dim: int = 80
    embedding_size: int = 192
    growth_rate: int = 32
    bn_size: int = 4                     # bottleneck = bn_size * growth
    init_channels: int = 128
    m_channels: int = 32                 # FCM width
    block_layers: tuple = (12, 24, 16)
    block_kernels: tuple = (3, 3, 3)
    block_dilations: tuple = (1, 2, 2)
    seg_len: int = 100                   # CAM segment pooling window


def _nonlinear(channels: int, dev, affine: bool = True) -> nn.Sequential:
    """The reference's ``batchnorm-relu`` holder: only its BatchNorm has
    state (the ReLU is applied by the caller)."""
    return nn.Sequential(OrderedDict(
        batchnorm=nn.BatchNorm1d(channels, affine=affine, device=dev)))


def _bn_relu(holder: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    return F.relu(holder.batchnorm(x))


class BasicResBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, stride: int, dev):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride=(stride, 1),
                               padding=1, bias=False, device=dev)
        self.bn1 = nn.BatchNorm2d(planes, device=dev)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False,
                               device=dev)
        self.bn2 = nn.BatchNorm2d(planes, device=dev)
        self.shortcut = nn.Sequential()
        if stride != 1 or in_planes != planes:
            self.shortcut = nn.Sequential(
                nn.Conv2d(in_planes, planes, 1, stride=(stride, 1),
                          bias=False, device=dev),
                nn.BatchNorm2d(planes, device=dev))

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return F.relu(out + self.shortcut(x))


class FCM(nn.Module):
    """[B, F, T] -> [B, C * F / 8, T] (frequency downsampled 8x)."""

    def __init__(self, cfg: CampPlusConfig, dev):
        super().__init__()
        m = cfg.m_channels
        self.conv1 = nn.Conv2d(1, m, 3, padding=1, bias=False, device=dev)
        self.bn1 = nn.BatchNorm2d(m, device=dev)
        self.layer1 = nn.Sequential(BasicResBlock(m, m, 2, dev),
                                    BasicResBlock(m, m, 1, dev))
        self.layer2 = nn.Sequential(BasicResBlock(m, m, 2, dev),
                                    BasicResBlock(m, m, 1, dev))
        self.conv2 = nn.Conv2d(m, m, 3, stride=(2, 1), padding=1, bias=False,
                               device=dev)
        self.bn2 = nn.BatchNorm2d(m, device=dev)
        self.out_channels = m * (cfg.feat_dim // 8)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x[:, None])))
        out = self.layer2(self.layer1(out))
        out = F.relu(self.bn2(self.conv2(out)))
        B, C, Fq, T = out.shape
        return out.reshape(B, C * Fq, T)


class TDNNLayer(nn.Module):
    def __init__(self, cin: int, cout: int, dev):
        super().__init__()
        self.linear = nn.Conv1d(cin, cout, 5, stride=2, padding=2,
                                bias=False, device=dev)
        self.nonlinear = _nonlinear(cout, dev)

    def forward(self, x):
        return _bn_relu(self.nonlinear, self.linear(x))


class CAMLayer(nn.Module):
    """A local conv gated by sigmoid(MLP(global mean + segment-pooled
    context))."""

    def __init__(self, bn_channels: int, out_channels: int, kernel: int,
                 dilation: int, seg_len: int, dev):
        super().__init__()
        self.seg_len = seg_len
        self.linear_local = nn.Conv1d(
            bn_channels, out_channels, kernel,
            padding=(kernel - 1) // 2 * dilation, dilation=dilation,
            bias=False, device=dev)
        self.linear1 = nn.Conv1d(bn_channels, bn_channels // 2, 1,
                                 device=dev)
        self.linear2 = nn.Conv1d(bn_channels // 2, out_channels, 1,
                                 device=dev)

    def forward(self, x):
        y = self.linear_local(x)
        T = x.shape[-1]
        # avg_pool1d(ceil_mode=True): each segment divides by its in-bounds
        # frames; repeated back over the frames
        seg = F.avg_pool1d(x, self.seg_len, self.seg_len, ceil_mode=True)
        seg = seg.repeat_interleave(self.seg_len, dim=-1)[..., :T]
        context = x.mean(-1, keepdim=True) + seg
        m = torch.sigmoid(self.linear2(F.relu(self.linear1(context))))
        return y * m


class CAMDenseTDNNLayer(nn.Module):
    def __init__(self, cin: int, cfg: CampPlusConfig, kernel: int,
                 dilation: int, dev):
        super().__init__()
        bn = cfg.bn_size * cfg.growth_rate
        self.nonlinear1 = _nonlinear(cin, dev)
        self.linear1 = nn.Conv1d(cin, bn, 1, bias=False, device=dev)
        self.nonlinear2 = _nonlinear(bn, dev)
        self.cam_layer = CAMLayer(bn, cfg.growth_rate, kernel, dilation,
                                  cfg.seg_len, dev)

    def forward(self, x):
        h = self.linear1(_bn_relu(self.nonlinear1, x))
        return self.cam_layer(_bn_relu(self.nonlinear2, h))


class CAMDenseTDNNBlock(nn.ModuleList):
    def __init__(self, n_layers: int, cin: int, cfg: CampPlusConfig,
                 kernel: int, dilation: int, dev):
        super().__init__()
        for i in range(n_layers):
            self.add_module(f"tdnnd{i + 1}", CAMDenseTDNNLayer(
                cin + i * cfg.growth_rate, cfg, kernel, dilation, dev))

    def forward(self, x):
        for layer in self:
            x = torch.cat([x, layer(x)], dim=1)
        return x


class TransitLayer(nn.Module):
    def __init__(self, cin: int, cout: int, dev):
        super().__init__()
        self.nonlinear = _nonlinear(cin, dev)
        self.linear = nn.Conv1d(cin, cout, 1, bias=False, device=dev)

    def forward(self, x):
        return self.linear(_bn_relu(self.nonlinear, x))


class DenseLayer(nn.Module):
    def __init__(self, cin: int, cout: int, dev):
        super().__init__()
        self.linear = nn.Conv1d(cin, cout, 1, bias=False, device=dev)
        self.nonlinear = _nonlinear(cout, dev, affine=False)

    def forward(self, stats):
        return self.nonlinear.batchnorm(F.linear(stats,
                                                 self.linear.weight[..., 0]))


class CAMPPlus(nn.Module):
    """The published CAM++ (eval mode, fp32, inference only)."""

    def __init__(self, cfg: CampPlusConfig = CampPlusConfig(),
                 device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.head = FCM(cfg, dev)
        layers = OrderedDict(tdnn=TDNNLayer(self.head.out_channels,
                                            cfg.init_channels, dev))
        c = cfg.init_channels
        for i, (n, k, d) in enumerate(zip(cfg.block_layers,
                                          cfg.block_kernels,
                                          cfg.block_dilations)):
            layers[f"block{i + 1}"] = CAMDenseTDNNBlock(n, c, cfg, k, d, dev)
            c += n * cfg.growth_rate
            layers[f"transit{i + 1}"] = TransitLayer(c, c // 2, dev)
            c //= 2
        layers["out_nonlinear"] = _nonlinear(c, dev)
        layers["dense"] = DenseLayer(2 * c, cfg.embedding_size, dev)
        self.xvector = nn.Sequential(layers)
        self.requires_grad_(False)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.head.conv1.weight.device


def _stats_pool(x: torch.Tensor) -> torch.Tensor:
    """Mean and unbiased std over the frames (JAX's one-pass form; one
    frame gives std 0)."""
    cnt = x.shape[-1]
    mean = x.sum(-1) / cnt
    var = ((x * x).sum(-1) - cnt * mean * mean) / max(cnt - 1, 1)
    return torch.cat([mean, torch.sqrt(torch.clamp(var, min=0.0))], dim=-1)


@torch.no_grad()
def embed_one(model: CAMPPlus, feat: torch.Tensor) -> torch.Tensor:
    """One utterance's fbank [T, feat_dim] (mean-normalised by the caller,
    as the reference does at dataloader.py:147) -> its x-vector [emb]."""
    xv = model.xvector
    with full_fp32():
        x = model.head(feat.float().T[None])
        x = xv.tdnn(x)
        for i in range(len(model.cfg.block_layers)):
            x = getattr(xv, f"transit{i + 1}")(getattr(xv, f"block{i + 1}")(x))
        x = _bn_relu(xv.out_nonlinear, x)
        return xv.dense(_stats_pool(x))[0]


def forward(model: CAMPPlus, feats: torch.Tensor,
            n_frames: Sequence[int]) -> torch.Tensor:
    """feats [B, T, feat_dim] (rows right-padded), n_frames [B] true
    lengths -> [B, emb]: each row at its own length."""
    return torch.stack([embed_one(model, feats[b, :int(n)])
                        for b, n in enumerate(n_frames)])


def from_state_dict(state: Dict[str, torch.Tensor],
                    cfg: CampPlusConfig = CampPlusConfig(),
                    device="cuda") -> CAMPPlus:
    """A :class:`CAMPPlus` on ``device`` holding a torch ``CAMPPlus``
    state dict (``campplus.pt``)."""
    model = CAMPPlus(cfg, device)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()},
                          strict=True)
    return model


def make_spk_emb_fn(model: CAMPPlus, device="cuda"):
    """Host-callable ``feat [T, feat_dim] -> [emb]`` for
    ``PodcastDataset(spk_emb_fn=...)`` over ``model`` on ``device`` (CUDA
    by default; raises without it): the fbank goes to the device, the
    x-vector comes back as numpy."""
    dev = resolve_device(device)
    if model.device != dev:
        raise ValueError(f"CAM++ is on {model.device}, not {dev}")

    def fn(feat: np.ndarray) -> np.ndarray:
        t = torch.from_numpy(np.asarray(feat, np.float32)).to(model.device)
        return embed_one(model, t).cpu().numpy()

    return fn
