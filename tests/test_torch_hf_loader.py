"""PyTorch port, HF checkpoint import and export: ``config_from_hf``,
``from_state_dict``, ``to_state_dict``, ``load_pretrained`` and
``core/checkpoint.export_hf`` against the JAX package on the same weights
(trees exactly equal in fp32, exported files bit-equal), and
``load_pretrained`` of directories written by transformers'
``Qwen3ForCausalLM.save_pretrained`` against HF's own logits. CPU,
qwen3_tiny."""
import dataclasses
import json

import numpy as np
import pytest
import jax
import torch

from speech_distill_tpu.core import checkpoint as jckpt
from speech_distill_tpu.core.config import qwen3_tiny as jax_tiny
from speech_distill_tpu.models import hf_loader as jhf
from speech_distill_tpu.models import qwen3 as jq
from speech_distill_tpu_torch.core import checkpoint as tckpt
from speech_distill_tpu_torch.core.config import qwen3_tiny
from speech_distill_tpu_torch.models import hf_loader as thf
from speech_distill_tpu_torch.models import qwen3 as tq
from speech_distill_tpu_torch.models.convert import (model_to_tree,
                                                     params_from_jax)

VOCAB = 96
# the fields both configs carry
FIELDS = ("vocab_size", "hidden_size", "intermediate_size",
          "num_hidden_layers", "num_attention_heads", "num_key_value_heads",
          "head_dim", "rms_norm_eps", "rope_theta", "max_position_embeddings",
          "tie_word_embeddings", "bos_token_id", "eos_token_id",
          "speech_token_offset", "dtype")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: as fast alone on these tiny models, and the
    port's CPU ops then do not oversubscribe the cores the other test
    workers share (a bf16 CLI chain ran 16x slower with 8 threads under
    six busy workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(tie=True, seed=0):
    """(JAX cfg, JAX fp32 numpy tree, port cfg) of one qwen3_tiny."""
    jcfg = dataclasses.replace(jax_tiny(VOCAB), tie_word_embeddings=tie,
                               dtype="float32")
    tree = jax.tree.map(np.asarray,
                        jq.init_params(jax.random.PRNGKey(seed), jcfg))
    tcfg = qwen3_tiny(VOCAB, tie_word_embeddings=tie, dtype="float32")
    return jcfg, tree, tcfg


def _assert_trees_equal(got, ref):
    assert sorted(got) == sorted(ref)
    for k in ref:
        if isinstance(ref[k], dict):
            _assert_trees_equal(got[k], ref[k])
        else:
            g = got[k]
            g = g.detach().float().numpy() if isinstance(g, torch.Tensor) \
                else np.asarray(g, np.float32)
            np.testing.assert_array_equal(g, np.asarray(ref[k], np.float32),
                                          err_msg=k)


def _hf_dict(cfg, **over):
    d = {"model_type": "qwen3", **{f: getattr(cfg, f) for f in (
        "vocab_size", "hidden_size", "intermediate_size",
        "num_hidden_layers", "num_attention_heads", "num_key_value_heads",
        "head_dim", "rms_norm_eps", "rope_theta", "max_position_embeddings",
        "tie_word_embeddings")}}
    d.update(over)
    return d


@pytest.mark.parametrize("form", ["dict", "transformers"])
def test_config_from_hf_matches_jax(form):
    jcfg, _, _ = _pair(tie=False)
    src = _hf_dict(jcfg)
    if form == "transformers":
        from transformers import Qwen3Config as HFQwen3Config
        src = HFQwen3Config(**{k: v for k, v in src.items()
                               if k != "model_type"})
    got, ref = thf.config_from_hf(src), jhf.config_from_hf(src)
    assert {f: getattr(got, f) for f in FIELDS} == \
        {f: getattr(ref, f) for f in FIELDS}
    assert got.dtype == "bfloat16"          # never read from the config


@pytest.mark.parametrize("over", [{"model_type": "qwen2"},
                                  {"attention_bias": True},
                                  {"qk_norm": False}],
                         ids=["qwen2", "attention_bias", "no_qk_norm"])
def test_config_from_hf_reads_qwen2(over):
    """Qwen2 configs are read now (they raised before the CosyVoice2
    backbone was ported): the port's attention_bias and qk_norm equal the
    JAX ``config_from_hf``'s (a qwen2 model_type: bias unless the config
    says otherwise, no q/k norm; a qwen3 one keeps its q/k norm)."""
    jcfg, _, _ = _pair()
    src = _hf_dict(jcfg, **over)
    got, ref = thf.config_from_hf(src), jhf.config_from_hf(src)
    fields = FIELDS[:-1] + ("attention_bias", "qk_norm")
    assert {f: getattr(got, f) for f in fields} == \
        {f: getattr(ref, f) for f in fields}
    want = {"model_type": (True, False), "attention_bias": (True, True),
            "qk_norm": (False, True)}[next(iter(over))]
    assert (got.attention_bias, got.qk_norm) == want


def _qwen2_pair(seed=0):
    """(JAX cfg, JAX fp32 numpy tree with random q/k/v biases, port cfg)
    of a tiny Qwen2 backbone (bias, no q/k norm)."""
    kw = dict(attention_bias=True, qk_norm=False, dtype="float32")
    jcfg = dataclasses.replace(jax_tiny(VOCAB), **kw)
    tree = jax.tree.map(np.asarray,
                        jq.init_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed + 1)
    for name in ("q_bias", "k_bias", "v_bias"):
        a = tree["layers"]["attn"][name]
        tree["layers"]["attn"][name] = rng.normal(size=a.shape).astype(
            np.float32)
    return jcfg, tree, qwen3_tiny(VOCAB, **kw)


def test_qwen2_state_dict_and_export_match_jax(tmp_path):
    """A Qwen2 tree through the HF names both ways equals JAX's exactly
    (the biases under self_attn.{q,k,v}_proj.bias, no q/k norms), the
    exported files are byte-equal, and load_pretrained reads the
    directory back to JAX's tree."""
    jcfg, tree, tcfg = _qwen2_pair()
    state = jhf.to_state_dict(tree, jcfg)
    assert "model.layers.0.self_attn.q_proj.bias" in state
    assert not any("q_norm" in k for k in state)
    model = thf.from_state_dict(state, tcfg, device="cpu")
    _assert_trees_equal(model_to_tree(model),
                        jax.tree.map(np.asarray,
                                     jhf.from_state_dict(state, jcfg)))
    out = thf.to_state_dict(model_to_tree(model), tcfg)
    assert sorted(out) == sorted(state)
    for k, v in out.items():
        np.testing.assert_array_equal(v, np.asarray(state[k]), err_msg=k)
    jckpt.export_hf(tree, jcfg, str(tmp_path / "jax"))
    tckpt.export_hf(model_to_tree(params_from_jax(tree, tcfg, "cpu")), tcfg,
                    str(tmp_path / "port"))
    assert (tmp_path / "port" / "model.safetensors").read_bytes() == \
        (tmp_path / "jax" / "model.safetensors").read_bytes()


@pytest.mark.parametrize("tie", [True, False], ids=["tied", "untied"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_state_dict_round_trip_matches_jax(tie, dtype):
    """HF names -> model -> HF names: the port's trees and state dicts
    equal JAX's exactly, and the state dict is C-contiguous fp32."""
    jcfg, tree, tcfg = _pair(tie)
    state = jhf.to_state_dict(tree, jcfg)
    ref = jax.tree.map(np.asarray, jhf.from_state_dict(state, jcfg, dtype))
    as_torch = {k: torch.from_numpy(np.array(v))
                for k, v in state.items()}
    for src in (state, as_torch):
        model = thf.from_state_dict(src, tcfg, dtype, device="cpu")
        assert model.cfg.dtype == dtype
        assert model.embed.dtype == tq.torch_dtype(dtype)
        _assert_trees_equal(model_to_tree(model), ref)
    out = thf.to_state_dict(model_to_tree(model), tcfg)
    jout = jhf.to_state_dict(ref, jcfg)
    assert sorted(out) == sorted(jout)
    for k, v in out.items():
        assert v.dtype == np.float32 and v.flags["C_CONTIGUOUS"], k
        np.testing.assert_array_equal(v, np.asarray(jout[k]), err_msg=k)
    # the JAX tree of numpy leaves exports the same way
    for k, v in thf.to_state_dict(ref, tcfg).items():
        np.testing.assert_array_equal(v, out[k], err_msg=k)


def test_from_state_dict_missing_weight_raises():
    jcfg, tree, tcfg = _pair()
    state = jhf.to_state_dict(tree, jcfg)
    del state["model.layers.1.mlp.up_proj.weight"]
    with pytest.raises(KeyError, match="layers.1.mlp.up_proj"):
        thf.from_state_dict(state, tcfg, device="cpu")


@pytest.mark.parametrize("tie", [True, False], ids=["tied", "untied"])
def test_export_hf_matches_jax(tmp_path, tie):
    """The same model.safetensors, byte for byte, and config.json; the
    port's load_pretrained reads it back to JAX's tree (fp32 and its
    default bf16)."""
    from safetensors.numpy import load_file
    jcfg, tree, tcfg = _pair(tie)
    model = params_from_jax(tree, tcfg, "cpu")
    jckpt.export_hf(tree, jcfg, str(tmp_path / "jax"))
    tckpt.export_hf(model_to_tree(model), tcfg, str(tmp_path / "port"))
    got = load_file(str(tmp_path / "port" / "model.safetensors"))
    ref = load_file(str(tmp_path / "jax" / "model.safetensors"))
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert (tmp_path / "port" / "model.safetensors").read_bytes() == \
        (tmp_path / "jax" / "model.safetensors").read_bytes()
    read = json.loads((tmp_path / "port" / "config.json").read_text())
    assert read == json.loads((tmp_path / "jax" / "config.json").read_text())
    for dtype in ("float32", None):
        cfg, back = thf.load_pretrained(str(tmp_path / "port"), dtype,
                                        device="cpu")
        jcfg2, jparams = jhf.load_pretrained(str(tmp_path / "jax"), dtype)
        assert cfg.dtype == (dtype or "bfloat16")
        _assert_trees_equal(model_to_tree(back),
                            jax.tree.map(np.asarray, jparams))


def test_load_pretrained_without_weights_raises(tmp_path):
    jcfg, tree, tcfg = _pair()
    tckpt.export_hf(tree, tcfg, str(tmp_path))
    (tmp_path / "model.safetensors").unlink()
    with pytest.raises(FileNotFoundError):
        thf.load_pretrained(str(tmp_path), device="cpu")


@pytest.mark.parametrize("tie", [True, False], ids=["tied", "untied"])
@pytest.mark.parametrize("saved", ["float32", "bfloat16"])
def test_load_pretrained_of_hf_save_matches_hf_logits(tmp_path, tie, saved):
    """A directory written by ``Qwen3ForCausalLM.save_pretrained`` (fp32 or
    bf16 tensors): loaded in fp32, the port's logits match HF's on the
    same weights (atol 2e-4, rtol 2e-3, the JAX package's HF test); loaded
    at the default dtype, every weight is the file's bf16 value."""
    from transformers import Qwen3Config as HFQwen3Config
    from transformers import Qwen3ForCausalLM

    _, _, tcfg = _pair(tie)
    hf_cfg = HFQwen3Config(
        vocab_size=tcfg.vocab_size, hidden_size=tcfg.hidden_size,
        intermediate_size=tcfg.intermediate_size,
        num_hidden_layers=tcfg.num_hidden_layers,
        num_attention_heads=tcfg.num_attention_heads,
        num_key_value_heads=tcfg.num_key_value_heads,
        head_dim=tcfg.head_dim, rms_norm_eps=tcfg.rms_norm_eps,
        rope_theta=tcfg.rope_theta,
        max_position_embeddings=tcfg.max_position_embeddings,
        tie_word_embeddings=tie, attention_bias=False)
    torch.manual_seed(0)
    hf = Qwen3ForCausalLM(hf_cfg).eval()
    hf.to(tq.torch_dtype(saved)).save_pretrained(str(tmp_path))
    hf = hf.float()        # the saved values, upcast exactly
    cfg, model = thf.load_pretrained(str(tmp_path), "float32", device="cpu")
    assert cfg.tie_word_embeddings == tie and model.cfg is cfg
    rng = np.random.default_rng(0)
    ids = rng.integers(0, VOCAB, size=(2, 17))
    mask = np.ones_like(ids)
    mask[1, 13:] = 0       # right padding
    with torch.no_grad():
        ref = hf(input_ids=torch.tensor(ids),
                 attention_mask=torch.tensor(mask)).logits.numpy()
    got = tq.forward(model, torch.tensor(ids),
                     attention_mask=torch.tensor(mask)).numpy()
    valid = mask.astype(bool)
    np.testing.assert_allclose(got[valid], ref[valid], atol=2e-4, rtol=2e-3)
    _, bf = thf.load_pretrained(str(tmp_path), device="cpu")
    assert bf.embed.dtype == torch.bfloat16
    want = hf.model.embed_tokens.weight.detach().to(torch.bfloat16)
    assert torch.equal(bf.embed, want)
    assert torch.equal(bf.layers[1].mlp.down,
                       hf.model.layers[1].mlp.down_proj.weight.detach()
                       .to(torch.bfloat16).T)
