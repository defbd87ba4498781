"""Carry weights and trainable trees across from the JAX package.

The JAX leaves are stacked [L, ...] per layer with [din, dout] matrices;
the port's :class:`~speech_distill_tpu_torch.models.qwen3.Qwen3` keeps the
same matrices per layer. Trees arrive as numpy (``jax.tree.map(
np.asarray, params)``), so this module needs no JAX, or as tensors (the
port's own :func:`model_to_tree`). Quantized leaves (``ops/quant``: a
stacked ``{"q4": [L, K/2, N], "scale": [L, 1, N]}`` and the like, an int8
``embed``) become :class:`~speech_distill_tpu_torch.models.qwen3.QuantWeight`
modules, sliced per layer with their codes kept exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from speech_distill_tpu_torch.core.config import Qwen3Config
from speech_distill_tpu_torch.core.device import resolve_device
from speech_distill_tpu_torch.core.tree import tree_map
from speech_distill_tpu_torch.models.qwen3 import (QuantWeight, Qwen3,
                                                   attn_names)
from speech_distill_tpu_torch.ops.quant import is_quantized_leaf

_MLP = ("gate", "up", "down")


def _copy(dst: torch.nn.Parameter, src) -> None:
    if isinstance(src, torch.Tensor):
        t = src.detach()
    else:
        # bf16 leaves arrive as ml_dtypes arrays; the fp32 view is exact
        t = torch.from_numpy(np.require(np.asarray(src, dtype=np.float32),
                                        requirements=["C", "W"]))
    if tuple(t.shape) != tuple(dst.shape):
        raise ValueError(f"shape {tuple(t.shape)} != {tuple(dst.shape)}")
    dst.data.copy_(t.to(dst.device).to(dst.dtype))


def _exact(a, device) -> torch.Tensor:
    """A leaf tensor of a quantized leaf on ``device``, dtype kept."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(device).contiguous().clone()
    return torch.from_numpy(np.array(a)).to(device)


def _set(module: torch.nn.Module, name: str, src, i=None) -> None:
    """Fill ``module.<name>`` from ``src`` (layer ``i`` of a stacked leaf):
    a dense leaf is copied into the parameter, a quantized leaf replaces it
    with a :class:`QuantWeight`."""
    if not is_quantized_leaf(src):
        _copy(getattr(module, name), src if i is None else src[i])
        return
    device = getattr(module, name).device
    delattr(module, name)
    setattr(module, name, QuantWeight(
        {k: _exact(v if i is None else v[i], device)
         for k, v in src.items()}))


def params_from_jax(tree: dict, cfg: Qwen3Config, device="cuda") -> Qwen3:
    """A :class:`Qwen3` holding the weights of a JAX ``init_params``-shaped
    tree of numpy arrays or tensors: dense leaves cast to ``cfg.dtype``,
    quantized leaves kept exactly. The attention leaves follow the config
    (``qwen3.attn_names``: q/k norms, Qwen2's q/k/v biases)."""
    model = Qwen3(cfg, device)
    _set(model, "embed", tree["embed"]["weight"])
    _copy(model.final_ln, tree["final_ln"]["scale"])
    if model.lm_head is not None:
        _set(model, "lm_head", tree["lm_head"]["weight"])
    lt = tree["layers"]
    for i, layer in enumerate(model.layers):
        _copy(layer.input_ln, lt["input_ln"]["scale"][i])
        _copy(layer.post_ln, lt["post_ln"]["scale"][i])
        for name in attn_names(cfg):
            _set(layer.attn, name, lt["attn"][name], i)
        for name in _MLP:
            _set(layer.mlp, name, lt["mlp"][name], i)
    return model


def cosyvoice2_params_from_jax(tree: dict, cfg, device="cuda",
                               head_dtype=None):
    """A :class:`~speech_distill_tpu_torch.models.cosyvoice2.CosyVoice2`
    holding a JAX ``cosyvoice2`` pytree ({"backbone": a Qwen2 tree,
    "llm_embedding", "speech_embedding", "llm_decoder": {"w", "b"}}) of
    numpy arrays or tensors: the backbone by :func:`params_from_jax`, the
    small leaves in ``head_dtype`` (default the backbone's)."""
    from speech_distill_tpu_torch.models.cosyvoice2 import CosyVoice2
    backbone = params_from_jax(tree["backbone"], cfg.backbone, device)
    model = CosyVoice2(cfg, backbone.device, head_dtype=head_dtype,
                       backbone=backbone)
    _copy(model.llm_embedding, tree["llm_embedding"])
    _copy(model.speech_embedding, tree["speech_embedding"])
    _copy(model.llm_decoder.w, tree["llm_decoder"]["w"])
    _copy(model.llm_decoder.b, tree["llm_decoder"]["b"])
    return model


def _leaf(w):
    """A detached copy: a tensor, or a quantized weight's leaf dict."""
    if isinstance(w, QuantWeight):
        return {k: t.detach().clone() for k, t in w.leaf.items()}
    return w.detach().clone()


def model_to_tree(model: Qwen3) -> dict:
    """The model's weights as a JAX ``init_params``-shaped tree of stacked
    [L, ...] tensors (detached copies; quantized weights as stacked leaf
    dicts)."""
    ls = model.layers

    def stack(get):
        first = get(ls[0])
        if isinstance(first, QuantWeight):
            return {k: torch.stack([get(layer).leaf[k].detach()
                                    for layer in ls]) for k in first.leaf}
        return torch.stack([get(layer).detach() for layer in ls])
    tree = {"embed": {"weight": _leaf(model.embed)},
            "final_ln": {"scale": model.final_ln.detach().clone()},
            "layers": {
                "attn": {n: stack(lambda l, n=n: getattr(l.attn, n))
                         for n in attn_names(model.cfg)},
                "input_ln": {"scale": stack(lambda l: l.input_ln)},
                "mlp": {n: stack(lambda l, n=n: getattr(l.mlp, n))
                        for n in _MLP},
                "post_ln": {"scale": stack(lambda l: l.post_ln)}}}
    if model.lm_head is not None:
        tree["lm_head"] = {"weight": _leaf(model.lm_head)}
    return tree


def trainable_from_jax(tree: dict, cfg: Qwen3Config, device="cuda") -> dict:
    """A JAX LoRA/trainable tree of numpy leaves (adapters [L, din, r] and
    [L, r, dout], saved-module copies [V, D]) as port tensors that require
    grad: adapters in fp32, copies in ``cfg.dtype``."""
    dev = resolve_device(device)

    def leaf(a, dtype):
        arr = np.require(np.asarray(a, dtype=np.float32),
                         requirements=["C", "W"])
        return torch.from_numpy(arr).to(dev, dtype).requires_grad_(True)
    out = {"layers": tree_map(lambda a: leaf(a, torch.float32),
                              tree["layers"])}
    for name in ("embed", "lm_head"):
        if name in tree:
            out[name] = {"weight": leaf(tree[name]["weight"],
                                        cfg.torch_dtype)}
    return out


def tree_to_numpy(tree: dict) -> dict:
    """A tree of tensors as fp32 numpy, for comparison with JAX."""
    return tree_map(lambda t: t.detach().float().cpu().numpy(), tree)


# ---------------------------------------------------------------------------
# The TTS tail: flow and HiFT. A JAX pytree (numpy leaves, conv kernels
# [k, Cin, Cout], matrices [din, dout], stacked blocks) becomes a
# reference-format state dict (torch names, conv weights [Cout, Cin, k],
# Linear weights [dout, din]): the inverse of the JAX
# ``convert_torch_state``, which reads those names. The port's modules
# then load it with ``load_state_dict``.
# ---------------------------------------------------------------------------


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().float().cpu().numpy()
    return np.array(a, np.float32)


def _pick(tree, *idx):
    """``tree`` with every leaf indexed by ``idx`` (a slice of stacked
    blocks)."""
    if isinstance(tree, dict):
        return {k: _pick(v, *idx) for k, v in tree.items()}
    a = tree
    for i in idx:
        a = a[i]
    return a


def _lin(s: dict, name: str, p: dict) -> None:
    s[name + ".weight"] = _np(p["w"]).T
    if "b" in p:
        s[name + ".bias"] = _np(p["b"])


def _conv(s: dict, name: str, p: dict) -> None:
    """A conv kernel [k, Cin, Cout] (or a transposed conv's [k, Cout,
    Cin]) reversed to torch's [Cout, Cin, k] ([Cin, Cout, k])."""
    s[name + ".weight"] = _np(p["w"]).transpose(2, 1, 0)
    s[name + ".bias"] = _np(p["b"])


def _norm(s: dict, name: str, p: dict) -> None:
    s[name + ".weight"] = _np(p["scale"])
    s[name + ".bias"] = _np(p["bias"])


def _flow_encoder_state(s: dict, t: dict, cfg, prefix: str) -> None:
    def embed(name, p):
        _lin(s, f"{prefix}{name}.out.0", p)
        _norm(s, f"{prefix}{name}.out.1", p["ln"])

    def layers(fmt, lt, n):
        for i in range(n):
            p, lp = prefix + fmt.format(i), _pick(lt, i)
            _norm(s, p + ".norm_mha", lp["norm_mha"])
            _norm(s, p + ".norm_ff", lp["norm_ff"])
            a = lp["attn"]
            for ours, theirs in (("q", "linear_q"), ("k", "linear_k"),
                                 ("v", "linear_v"), ("out", "linear_out"),
                                 ("pos", "linear_pos")):
                _lin(s, f"{p}.self_attn.{theirs}", a[ours])
            s[p + ".self_attn.pos_bias_u"] = _np(a["pos_bias_u"])
            s[p + ".self_attn.pos_bias_v"] = _np(a["pos_bias_v"])
            _lin(s, p + ".feed_forward.w_1", {"w": lp["ff"]["w1"],
                                              "b": lp["ff"]["b1"]})
            _lin(s, p + ".feed_forward.w_2", {"w": lp["ff"]["w2"],
                                              "b": lp["ff"]["b2"]})

    embed("embed", t["embed"])
    _conv(s, prefix + "pre_lookahead_layer.conv1",
          t["pre_lookahead"]["conv1"])
    _conv(s, prefix + "pre_lookahead_layer.conv2",
          t["pre_lookahead"]["conv2"])
    layers("encoders.{}", t["encoders"], cfg.num_blocks)
    _conv(s, prefix + "up_layer.conv", t["up_layer"]["conv"])
    embed("up_embed", t["up_embed"])
    layers("up_encoders.{}", t["up_encoders"], cfg.num_up_blocks)
    _norm(s, prefix + "after_norm", t["after_norm"])


def flow_state_from_jax(tree: dict, cfg) -> dict:
    """A JAX flow ``init_params``-shaped tree as a reference ``flow.pt``
    state dict of fp32 numpy arrays."""
    s: dict = {"input_embedding.weight": _np(tree["input_embedding"])}
    _lin(s, "spk_embed_affine_layer", tree["spk_affine"])
    _flow_encoder_state(s, tree["encoder"], cfg.encoder, "encoder.")
    _lin(s, "encoder_proj", tree["encoder_proj"])

    est = "decoder.estimator."
    e = tree["estimator"]

    def causal_block(pref, p):
        _conv(s, pref + ".block.0", p["conv"])
        _norm(s, pref + ".block.2", p["ln"])

    def resnet(pref, p):
        causal_block(pref + ".block1", p["block1"])
        causal_block(pref + ".block2", p["block2"])
        _lin(s, pref + ".mlp.1", p["mlp"])
        _conv(s, pref + ".res_conv", p["res"])

    def tf_stack(fmt, bt):
        for j in range(cfg.est_n_blocks):
            pref, p = fmt.format(j), _pick(bt, j)
            _norm(s, pref + ".norm1", p["norm1"])
            _norm(s, pref + ".norm3", p["norm3"])
            for ours in ("q", "k", "v"):
                _lin(s, f"{pref}.attn1.to_{ours}", p["attn"][ours])
            _lin(s, pref + ".attn1.to_out.0", p["attn"]["out"])
            _lin(s, pref + ".ff.net.0.proj", p["ff1"])
            _lin(s, pref + ".ff.net.2", p["ff2"])

    _lin(s, est + "time_mlp.linear_1", e["time_mlp"]["lin1"])
    _lin(s, est + "time_mlp.linear_2", e["time_mlp"]["lin2"])
    for stage in ("down", "up"):
        pref = f"{est}{stage}_blocks.0"
        resnet(pref + ".0", e[stage]["resnet"])
        tf_stack(pref + ".1.{}", e[stage]["blocks"])
        _conv(s, pref + ".2", e[stage]["conv"])
    for i in range(cfg.est_num_mid_blocks):
        resnet(f"{est}mid_blocks.{i}.0", _pick(e["mid"]["resnet"], i))
        tf_stack(f"{est}mid_blocks.{i}.1.{{}}", _pick(e["mid"]["blocks"], i))
    causal_block(est + "final_block", e["final_block"])
    _conv(s, est + "final_proj", e["final_proj"])
    return s


def hift_state_from_jax(tree: dict, cfg) -> dict:
    """A JAX HiFT ``init_params``-shaped tree as a reference ``hift.pt``
    state dict (weight norm folded) of fp32 numpy arrays."""
    s: dict = {}

    def resblock(pref, p, n):
        for j in range(n):
            _conv(s, f"{pref}.convs1.{j}", _pick(p["convs1"], j))
            _conv(s, f"{pref}.convs2.{j}", _pick(p["convs2"], j))
            s[f"{pref}.activations1.{j}.alpha"] = _np(p["alpha1"][j])
            s[f"{pref}.activations2.{j}.alpha"] = _np(p["alpha2"][j])

    for i, p in enumerate(tree["f0_predictor"]["conv"]):
        _conv(s, f"f0_predictor.condnet.{2 * i}", p)
    _lin(s, "f0_predictor.classifier", tree["f0_predictor"]["cls"])
    _lin(s, "m_source.l_linear", tree["m_source"]["linear"])
    _conv(s, "conv_pre", tree["conv_pre"])
    nk = len(cfg.resblock_kernel_sizes)
    for i in range(len(cfg.upsample_rates)):
        _conv(s, f"ups.{i}", tree["ups"][i])
        _conv(s, f"source_downs.{i}", tree["source_downs"][i])
        resblock(f"source_resblocks.{i}", tree["source_resblocks"][i],
                 len(cfg.source_resblock_dilations[i]))
        for j in range(nk):
            resblock(f"resblocks.{i * nk + j}", tree["resblocks"][i][j],
                     len(cfg.resblock_dilations[j]))
    _conv(s, "conv_post", tree["conv_post"])
    return s


def _load(module: torch.nn.Module, state: dict) -> None:
    module.load_state_dict({k: torch.from_numpy(v) if isinstance(
        v, np.ndarray) else v for k, v in state.items()}, strict=True)


def flow_params_from_jax(tree: dict, cfg, device="cuda"):
    """A :class:`~speech_distill_tpu_torch.models.flow.Flow` (fp32) holding
    the weights of a JAX flow ``init_params``-shaped tree."""
    from speech_distill_tpu_torch.models.flow import Flow
    model = Flow(cfg, device)
    _load(model, flow_state_from_jax(tree, cfg))
    return model


def hift_params_from_jax(tree: dict, cfg, device="cuda"):
    """A :class:`~speech_distill_tpu_torch.models.hift.HiFTGenerator`
    (fp32) holding the weights of a JAX HiFT ``init_params``-shaped
    tree."""
    from speech_distill_tpu_torch.models.hift import HiFTGenerator
    model = HiFTGenerator(cfg, device)
    _load(model, hift_state_from_jax(tree, cfg))
    return model


# ---------------------------------------------------------------------------
# the S3 tokenizer and CAM++ (the JAX pytrees as numpy -> torch names)
# ---------------------------------------------------------------------------


def s3_state_from_jax(tree: dict, cfg) -> dict:
    """A JAX S3 ``init_params``-shaped tree -> the s3tokenizer checkpoint's
    state dict (fp32 numpy)."""
    s = {}
    for i in (1, 2):
        c = tree[f"conv{i}"]
        s[f"encoder.conv{i}.weight"] = _np(c["w"]).transpose(2, 1, 0)
        s[f"encoder.conv{i}.bias"] = _np(c["b"])
    b = tree["blocks"]
    lin = {"q": "attn.query", "k": "attn.key", "v": "attn.value",
           "out": "attn.out", "mlp1": "mlp.0", "mlp2": "mlp.2"}
    for i in range(cfg.n_layer):
        p = f"encoder.blocks.{i}"
        for jname, tname in lin.items():
            s[f"{p}.{tname}.weight"] = _np(b[jname]["w"])[i].T
            if "b" in b[jname]:
                s[f"{p}.{tname}.bias"] = _np(b[jname]["b"])[i]
        for jname, tname in (("ln1", "attn_ln"), ("ln2", "mlp_ln")):
            s[f"{p}.{tname}.weight"] = _np(b[jname]["scale"])[i]
            s[f"{p}.{tname}.bias"] = _np(b[jname]["bias"])[i]
    s["encoder.ln_post.weight"] = _np(tree["ln_post"]["scale"])
    s["encoder.ln_post.bias"] = _np(tree["ln_post"]["bias"])
    s["quantizer.project_down.weight"] = _np(tree["fsq"]["w"]).T
    s["quantizer.project_down.bias"] = _np(tree["fsq"]["b"])
    return {k: np.ascontiguousarray(v) for k, v in s.items()}


def s3_params_from_jax(tree: dict, cfg, device="cuda"):
    """An :class:`~speech_distill_tpu_torch.tokenizer.s3.S3Encoder`
    holding the weights of a JAX S3 tree."""
    from speech_distill_tpu_torch.tokenizer.s3 import from_state_dict
    state = {k: torch.from_numpy(v)
             for k, v in s3_state_from_jax(tree, cfg).items()}
    return from_state_dict(state, cfg, device)


def campplus_state_from_jax(tree: dict, cfg) -> dict:
    """A JAX CAM++ tree (``campplus.convert_torch_state``'s) -> the torch
    ``CAMPPlus`` state dict (fp32 numpy; BatchNorm counters 0)."""
    s = {}

    def bn(name, p):
        s[f"{name}.running_mean"] = _np(p["mean"])
        s[f"{name}.running_var"] = _np(p["var"])
        s[f"{name}.num_batches_tracked"] = np.zeros((), np.int64)
        if "weight" in p:
            s[f"{name}.weight"] = _np(p["weight"])
            s[f"{name}.bias"] = _np(p["bias"])

    head = tree["head"]
    s["head.conv1.weight"] = _np(head["conv1"])
    bn("head.bn1", head["bn1"])
    for layer in ("layer1", "layer2"):
        for i, r in enumerate(head[layer]):
            p = f"head.{layer}.{i}"
            s[f"{p}.conv1.weight"] = _np(r["conv1"])
            bn(f"{p}.bn1", r["bn1"])
            s[f"{p}.conv2.weight"] = _np(r["conv2"])
            bn(f"{p}.bn2", r["bn2"])
            if "shortcut_conv" in r:
                s[f"{p}.shortcut.0.weight"] = _np(r["shortcut_conv"])
                bn(f"{p}.shortcut.1", r["shortcut_bn"])
    s["head.conv2.weight"] = _np(head["conv2"])
    bn("head.bn2", head["bn2"])
    s["xvector.tdnn.linear.weight"] = _np(tree["tdnn"]["linear"])
    bn("xvector.tdnn.nonlinear.batchnorm", tree["tdnn"]["bn"])
    for bi, block in enumerate(tree["blocks"]):
        for li, lp in enumerate(block):
            p = f"xvector.block{bi + 1}.tdnnd{li + 1}"
            bn(f"{p}.nonlinear1.batchnorm", lp["bn1"])
            s[f"{p}.linear1.weight"] = _np(lp["linear1"])
            bn(f"{p}.nonlinear2.batchnorm", lp["bn2"])
            cam = lp["cam"]
            s[f"{p}.cam_layer.linear_local.weight"] = _np(cam["local"])
            for j in (1, 2):
                s[f"{p}.cam_layer.linear{j}.weight"] = _np(cam[f"lin{j}_w"])
                s[f"{p}.cam_layer.linear{j}.bias"] = _np(cam[f"lin{j}_b"])
        tr = tree["transits"][bi]
        bn(f"xvector.transit{bi + 1}.nonlinear.batchnorm", tr["bn"])
        s[f"xvector.transit{bi + 1}.linear.weight"] = _np(tr["linear"])
    bn("xvector.out_nonlinear.batchnorm", tree["out_bn"])
    s["xvector.dense.linear.weight"] = _np(tree["dense"]["linear"])[..., None]
    bn("xvector.dense.nonlinear.batchnorm", tree["dense"]["bn"])
    return {k: np.ascontiguousarray(v) for k, v in s.items()}


def campplus_params_from_jax(tree: dict, cfg, device="cuda"):
    """A :class:`~speech_distill_tpu_torch.models.campplus.CAMPPlus`
    holding the weights of a JAX CAM++ tree."""
    from speech_distill_tpu_torch.models.campplus import from_state_dict
    state = {k: torch.from_numpy(v)
             for k, v in campplus_state_from_jax(tree, cfg).items()}
    return from_state_dict(state, cfg, device)


def load_reference_state(module: torch.nn.Module, state: dict):
    """Load a reference-format state dict (``flow.pt``, or ``hift.pt``
    with weight norm folded) into a port module whose names are the
    reference's: every module tensor must be present; the checkpoint's
    other entries are ignored, as the JAX converters ignore them."""
    missing, _ = module.load_state_dict(state, strict=False)
    if missing:
        raise KeyError(f"checkpoint lacks {len(missing)} tensors, e.g. "
                       f"{missing[:3]}")
    return module
