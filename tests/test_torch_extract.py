"""PyTorch port, teacher top-K extraction: ``extract_top_k``,
``chunked_top_k``, ``fused_topk_lse`` and ``fused_extract_top_k`` against
the JAX package's exact routes, and ``extract_teacher_logprobs`` over
ragged sequences against the JAX pipeline on the same teacher weights.
Logits are tie-free, so indices compare exactly (``torch.topk`` promises
no tie order); fp16 values within one fp16 ulp. CPU, fp32."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from speech_distill_tpu.core.config import qwen3_tiny as jax_tiny
from speech_distill_tpu.distill import losses as jlosses
from speech_distill_tpu.models import qwen3 as jq
from speech_distill_tpu.ops import fused_lm_loss as jfused
from speech_distill_tpu.pipelines import extract_logits as jextract
from speech_distill_tpu_torch.core.config import qwen3_tiny
from speech_distill_tpu_torch.distill import losses
from speech_distill_tpu_torch.models import qwen3 as tq
from speech_distill_tpu_torch.models.convert import params_from_jax
from speech_distill_tpu_torch.ops.fused_lm_loss import (fused_extract_top_k,
                                                        fused_topk_lse)
from speech_distill_tpu_torch.pipelines.extract_logits import (
    extract_teacher_logprobs, make_extract_fn)

T_VOCAB, S_VOCAB, K = 200, 176, 8
TEACHER = dict(hidden_size=96, intermediate_size=192)


def _tie_free(shape, seed):
    """Distinct fp32 logits: a permutation of a grid, scaled and shifted."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    return (rng.permutation(n).reshape(shape).astype(np.float32) / n * 12.0
            - 6.0)


def _assert_fp16_close(got, ref):
    """Within one fp16 ulp of the reference value."""
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    ulp = np.spacing(np.abs(ref).astype(np.float16)).astype(np.float32)
    assert np.all(np.abs(got - ref) <= ulp), np.abs(got - ref).max()


@pytest.mark.parametrize("V,k,vocab", [(1200, 16, None), (5000, 8, 4100),
                                       (300, 8, None)],
                         ids=["segmented", "truncated", "small"])
def test_extract_top_k_matches_jax_exact(V, k, vocab):
    x = _tie_free((3, 5, V), seed=V)
    rv, ri = jlosses.extract_top_k(jnp.asarray(x), k, vocab,
                                   method="exact")
    for method in ("exact", "approx"):     # "approx" is exact in the port
        v, i = losses.extract_top_k(torch.from_numpy(x), k, vocab,
                                    method=method)
        assert v.dtype == torch.float16 and i.dtype == torch.int32
        np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
        _assert_fp16_close(v.numpy(), rv)
    with pytest.raises(ValueError):
        losses.extract_top_k(torch.from_numpy(x), k, method="sorted")


@pytest.mark.parametrize("V,k,n", [(4000, 16, 16), (1001, 8, 7),
                                   (100, 8, 16)],
                         ids=["even", "padded", "short"])
def test_chunked_top_k_matches_jax(V, k, n):
    x = _tie_free((4, V), seed=k + V)
    rv, ri = jlosses.chunked_top_k(jnp.asarray(x), k, n)
    v, i = losses.chunked_top_k(torch.from_numpy(x), k, n)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(v.numpy(), np.asarray(rv))


@pytest.mark.parametrize("chunk,limit,bias", [(512, None, False),
                                              (300, 1100, True),
                                              (2048, None, False)],
                         ids=["chunks", "ragged-limit-bias", "one-chunk"])
def test_fused_topk_lse_matches_jax(chunk, limit, bias):
    """Raw top-k logits and lse over vocab chunks (the last one short),
    against the JAX scan over padded chunks."""
    rng = np.random.default_rng(chunk)
    N, D, V, k = 12, 32, 1200, 16
    h = rng.normal(size=(N, D)).astype(np.float32)
    w = rng.normal(size=(V, D)).astype(np.float32)
    b = rng.normal(size=(V,)).astype(np.float32) if bias else None
    rv, ri, rl = jfused.fused_topk_lse(
        jnp.asarray(h), jnp.asarray(w), k, limit, chunk,
        None if b is None else jnp.asarray(b))
    v, i, lse = fused_topk_lse(torch.from_numpy(h), torch.from_numpy(w), k,
                               limit, chunk,
                               None if b is None else torch.from_numpy(b))
    assert i.dtype == torch.int32
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_allclose(v.numpy(), np.asarray(rv), rtol=1e-6,
                               atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(rl), rtol=1e-6,
                               atol=1e-5)


def test_fused_extract_top_k_matches_jax_and_the_materialized_route():
    rng = np.random.default_rng(3)
    B, T, D, V, k = 2, 6, 32, 1500, 8
    h = rng.normal(size=(B, T, D)).astype(np.float32)
    w = rng.normal(size=(V, D)).astype(np.float32)
    rv, ri = jfused.fused_extract_top_k(jnp.asarray(h), jnp.asarray(w), k,
                                        1300, 512)
    th, tw = torch.from_numpy(h), torch.from_numpy(w)
    v, i = fused_extract_top_k(th, tw, k, 1300, 512)
    assert v.shape == (B, T, k) and v.dtype == torch.float16
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    _assert_fp16_close(v.numpy(), rv)
    mv, mi = losses.extract_top_k(th @ tw.t(), k, 1300)
    np.testing.assert_array_equal(i.numpy(), mi.numpy())
    _assert_fp16_close(v.numpy(), mv.numpy())


@pytest.fixture(scope="module")
def teacher():
    jcfg = jax_tiny(T_VOCAB, dtype="float32", remat=False, attn_impl="xla",
                    **TEACHER)
    params = jax.tree.map(np.asarray,
                          jq.init_params(jax.random.PRNGKey(5), jcfg))
    cfg = qwen3_tiny(T_VOCAB, dtype="float32", remat=False, **TEACHER)
    return jcfg, params, params_from_jax(params, cfg, "cpu")


def _features(n, seed=0):
    """Ragged sequences of 5-40 tokens; half name their teacher ids and a
    mask, half plain input ids."""
    rng = np.random.default_rng(seed)
    feats = []
    for j in range(n):
        ids = rng.integers(0, T_VOCAB, int(rng.integers(5, 41))).tolist()
        feats.append({"teacher_input_ids": ids,
                      "teacher_attention_mask": [1] * len(ids)}
                     if j % 2 else {"input_ids": ids})
    return feats


def _port_forward(model, ids, mask):
    return tq.forward(model, ids, attention_mask=mask)


def _port_hidden(model, ids, mask):
    return tq.forward(model, ids, attention_mask=mask, return_hidden=True)


@pytest.mark.parametrize("route", ["materialized", "fused"])
def test_extract_teacher_logprobs_matches_jax(teacher, route):
    """7 ragged sequences in batches of 3 (the last repeat-padded), padded
    to 16: every example's length, order, fp16 values and int32 indices
    against the JAX pipeline."""
    jcfg, params, model = teacher
    feats = _features(7)
    jkw = {}
    kw = {}
    if route == "fused":
        jkw = dict(hidden_forward=lambda p, i, m: jq.forward(
                       p, i, jcfg, attention_mask=m, return_hidden=True),
                   head_weight_fn=jq.lm_head_weight)
        kw = dict(hidden_forward=_port_hidden,
                  head_weight_fn=tq.lm_head_weight)
    rv, ri = jextract.extract_teacher_logprobs(
        jax.tree.map(jnp.asarray, params),
        lambda p, i, m: jq.forward(p, i, jcfg, attention_mask=m), feats,
        top_k=K, batch_size=3, pad_to_multiple_of=16, vocab_limit=S_VOCAB,
        progress=False, **jkw)
    v, i = extract_teacher_logprobs(
        model, _port_forward, feats, top_k=K, batch_size=3,
        pad_to_multiple_of=16, vocab_limit=S_VOCAB, progress=False,
        device="cpu", **kw)
    assert len(v) == len(i) == len(feats)
    for f, a, b, ra, rb in zip(feats, v, i, rv, ri):
        n = len(f.get("teacher_input_ids", f.get("input_ids")))
        assert a.shape == (n, K) and a.dtype == np.float16
        assert b.shape == (n, K) and b.dtype == np.int32
        np.testing.assert_array_equal(b, rb)
        _assert_fp16_close(a, ra)
    assert max(int(x.max()) for x in i) < S_VOCAB


def test_extraction_is_the_same_alone_and_batched(teacher):
    """An example extracted in a padded batch equals it extracted alone."""
    _, _, model = teacher
    feats = _features(5, seed=1)
    v, i = extract_teacher_logprobs(model, _port_forward, feats, top_k=K,
                                    batch_size=4, pad_to_multiple_of=16,
                                    progress=False, device="cpu")
    fn = make_extract_fn(_port_forward, K)
    for f, a, b in zip(feats, v, i):
        ids = f.get("teacher_input_ids", f.get("input_ids"))
        va, ia = fn(model, torch.tensor([ids]), torch.ones(1, len(ids)))
        np.testing.assert_array_equal(b, ia[0].numpy())
        _assert_fp16_close(a, va[0].numpy())


def test_extraction_mesh_raises(teacher):
    """dp extraction runs on gloo ranks (``tests/test_torch_sharding.
    py``), an sp-split teacher there too (``tests/test_torch_ring_
    attention.py``). A mesh with sp over a teacher that runs the whole
    sequence (no ring ``attn_impl``) extracts as without a mesh, as JAX's
    GSPMD extraction gives the same values whatever the sharding."""
    from speech_distill_tpu_torch.parallel.mesh import Mesh
    shape = {"dp": 1, "pp": 1, "sp": 2, "tp": 1}
    mesh = Mesh(shape, {a: 0 for a in shape}, torch.device("cpu"))
    feats = _features(3)
    got = extract_teacher_logprobs(teacher[2], _port_forward, feats,
                                   top_k=K, batch_size=4, mesh=mesh,
                                   progress=False, device="cpu")
    want = extract_teacher_logprobs(teacher[2], _port_forward, feats,
                                    top_k=K, batch_size=4, progress=False,
                                    device="cpu")
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        np.testing.assert_array_equal(a, b)