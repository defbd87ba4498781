"""PyTorch port, agreement evaluation (``distill/evaluate.py``): the
dense step (teacher in the step, metrics streamed over time chunks) and
the sparse step (stored top-K) against the JAX package on the same
weights and batch, a float64 numpy oracle, the identical-model case, the
sparse step at K = V against the dense one, and ``finalize_metrics``.
Counts exact, sums within 1e-4. fp32, qwen3_tiny student, a wider teacher
with a larger vocab, CPU."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from speech_distill_tpu.core.config import qwen3_tiny as jax_tiny
from speech_distill_tpu.distill import evaluate as jev
from speech_distill_tpu.models import qwen3 as jq
from speech_distill_tpu_torch.core.config import qwen3_tiny
from speech_distill_tpu_torch.distill import evaluate as ev
from speech_distill_tpu_torch.models import qwen3 as tq
from speech_distill_tpu_torch.models.convert import params_from_jax

VOCAB, T_VOCAB, K = 64, 72, 5
TEACHER = dict(hidden_size=96, intermediate_size=192)
SUM_RTOL = SUM_ATOL = 1e-4


@pytest.fixture(scope="module")
def models():
    jcfg = jax_tiny(VOCAB, dtype="float32", remat=False, attn_impl="xla")
    jtcfg = jax_tiny(T_VOCAB, dtype="float32", remat=False, attn_impl="xla",
                     **TEACHER)
    s = jax.tree.map(np.asarray, jq.init_params(jax.random.PRNGKey(0), jcfg))
    t = jax.tree.map(np.asarray,
                     jq.init_params(jax.random.PRNGKey(1), jtcfg))
    cfg = qwen3_tiny(VOCAB, dtype="float32", remat=False)
    tcfg = qwen3_tiny(T_VOCAB, dtype="float32", remat=False, **TEACHER)
    return dict(jcfg=jcfg, jtcfg=jtcfg, s=s, t=t, cfg=cfg, tcfg=tcfg,
                student=params_from_jax(s, cfg, "cpu"),
                teacher=params_from_jax(t, tcfg, "cpu"))


def _batch(B=2, T=12, seed=0):
    """The JAX test's batch (tests/test_evaluate.py): right padding in one
    row, the text half's labels masked, the speech mask on the second
    half."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, VOCAB, (B, T)).astype(np.int32)
    mask = np.ones((B, T), np.int32)
    mask[1, T - 3:] = 0
    labels = ids.astype(np.int64).copy()
    labels[:, :T // 2] = -100
    smask = np.zeros((B, T), np.float32)
    smask[:, T // 2:] = 1.0
    return {"input_ids": ids, "attention_mask": mask, "labels": labels,
            "speech_token_mask": smask}


def _jax_sums(sums):
    return {k: float(v) for k, v in jax.device_get(sums).items()}


def _assert_sums(got, ref):
    assert set(got) == set(ref)
    for k in ref:
        if k.startswith("n_"):
            assert float(got[k]) == ref[k], k
        else:
            np.testing.assert_allclose(float(got[k]), ref[k], rtol=SUM_RTOL,
                                       atol=SUM_ATOL, err_msg=k)


def _jax_logits(params, cfg, batch):
    return np.asarray(jq.forward(jax.tree.map(jnp.asarray, params),
                                 jnp.asarray(batch["input_ids"]), cfg,
                                 attention_mask=jnp.asarray(
                                     batch["attention_mask"])))


def _oracle(s_logits, t_logits, batch, k):
    """float64 numpy sums of the dense metrics (the JAX test's oracle),
    the rank with the smallest-index-first tie order."""
    s = np.asarray(s_logits, np.float64)[:, :-1]
    t = np.asarray(t_logits, np.float64)[:, :-1, :s.shape[-1]]
    target = batch["input_ids"][:, 1:]
    mask = batch["attention_mask"]
    all_m = (mask[:, 1:] * mask[:, :-1]).astype(np.float64)
    speech_m = all_m * (batch["speech_token_mask"][:, 1:] != 0)
    label_m = all_m * (batch["labels"][:, 1:] != -100)

    def lsm(x):
        x = x - x.max(-1, keepdims=True)
        return x - np.log(np.exp(x).sum(-1, keepdims=True))
    ls, lt = lsm(s), lsm(t)
    kl = (np.exp(lt) * (lt - ls)).sum(-1)
    ce_s = np.take_along_axis(-ls, target[..., None], -1)[..., 0]
    ce_t = np.take_along_axis(-lt, target[..., None], -1)[..., 0]
    s1 = s.argmax(-1)
    agree1 = (s1 == t.argmax(-1)).astype(np.float64)
    t_at = np.take_along_axis(t, s1[..., None], -1)
    rank = (t > t_at).sum(-1) + ((t == t_at) & (
        np.arange(t.shape[-1]) < s1[..., None])).sum(-1)
    agreek = (rank < k).astype(np.float64)
    out = {}
    for name, m in (("all", all_m), ("speech", speech_m)):
        lm = m * label_m
        out.update({f"n_{name}": m.sum(), f"kl_{name}": (kl * m).sum(),
                    f"agree1_{name}": (agree1 * m).sum(),
                    f"agreek_{name}": (agreek * m).sum(),
                    f"n_label_{name}": lm.sum(),
                    f"ce_s_{name}": (ce_s * lm).sum(),
                    f"ce_t_{name}": (ce_t * lm).sum()})
    return out


@pytest.mark.parametrize("chunk", [4, 128], ids=["chunks", "one-chunk"])
def test_agreement_step_matches_jax_and_the_oracle(models, chunk):
    m = models
    batch = _batch()
    ref = _jax_sums(jev.make_agreement_step(m["jcfg"], m["jtcfg"], k=K,
                                            chunk=chunk)(
        jax.tree.map(jnp.asarray, m["s"]), jax.tree.map(jnp.asarray, m["t"]),
        jax.tree.map(jnp.asarray, batch)))
    step = ev.make_agreement_step(m["cfg"], m["tcfg"], k=K, chunk=chunk,
                                  device="cpu")
    got = step(m["student"], m["teacher"], batch)
    _assert_sums(got, ref)
    oracle = _oracle(_jax_logits(m["s"], m["jcfg"], batch),
                     _jax_logits(m["t"], m["jtcfg"], batch), batch, K)
    _assert_sums(got, oracle)


def test_agreement_reads_the_teacher_ids(models):
    """teacher_input_ids / teacher_attention_mask feed the teacher, as in
    JAX."""
    m = models
    batch = _batch(seed=2)
    rng = np.random.default_rng(9)
    batch["teacher_input_ids"] = rng.integers(0, T_VOCAB, (2, 12)).astype(
        np.int32)
    batch["teacher_attention_mask"] = batch["attention_mask"].copy()
    ref = _jax_sums(jev.make_agreement_step(m["jcfg"], m["jtcfg"], k=K)(
        jax.tree.map(jnp.asarray, m["s"]), jax.tree.map(jnp.asarray, m["t"]),
        jax.tree.map(jnp.asarray, batch)))
    got = ev.make_agreement_step(m["cfg"], k=K, device="cpu")(
        m["student"], m["teacher"], batch)
    _assert_sums(got, ref)


def test_identical_models_agree_perfectly(models):
    m = models
    step = ev.make_agreement_step(m["tcfg"], k=K, device="cpu")
    out = ev.finalize_metrics(step(m["teacher"], m["teacher"], _batch()), K)
    for sl in ("all", "speech"):
        assert out[sl]["top1_agreement"] == 1.0
        assert out[sl][f"top{K}_agreement"] == 1.0
        assert abs(out[sl]["kl_t1"]) < 1e-5
        np.testing.assert_allclose(out[sl]["student_ce"],
                                   out[sl]["teacher_ce"], rtol=1e-6)


def test_top1_rank_follows_the_smallest_index_first_rule():
    """Ties rank the smaller index first: the rank of s1 counts the
    larger values and the equal ones before it."""
    t = torch.tensor([[1.0, 3.0, 3.0, 0.5, 3.0]])
    for s1, want in ((1, 0), (2, 1), (4, 2), (0, 3), (3, 4)):
        assert int(ev._top1_rank_in(t, torch.tensor([s1]))[0]) == want


def _stored_top_k(models, batch, k):
    logits = _jax_logits(models["t"], models["jtcfg"], batch)[..., :VOCAB]
    lsm = jax.nn.log_softmax(jnp.asarray(logits), axis=-1)
    v, i = jax.lax.top_k(lsm, k)
    return dict(batch, teacher_top_k_v=np.asarray(v),
                teacher_top_k_i=np.asarray(i))


@pytest.mark.parametrize("stored", [16, VOCAB], ids=["k16", "k-vocab"])
def test_sparse_agreement_step_matches_jax(models, stored):
    m = models
    sb = _stored_top_k(m, _batch(seed=3), stored)
    ref = _jax_sums(jev.make_sparse_agreement_step(m["jcfg"], k=K)(
        jax.tree.map(jnp.asarray, m["s"]), jax.tree.map(jnp.asarray, sb)))
    got = ev.make_sparse_agreement_step(m["cfg"], k=K, device="cpu")(
        m["student"], sb)
    _assert_sums(got, ref)


def test_sparse_equals_dense_at_k_equals_vocab(models):
    """Stored top-K at K = V holds the whole teacher distribution: the
    sparse step's rates equal the dense step's."""
    m = models
    batch = _batch(seed=4)
    sb = _stored_top_k(m, batch, VOCAB)
    k = 7
    dense = ev.finalize_metrics(ev.make_agreement_step(
        m["cfg"], k=k, device="cpu")(m["student"], m["teacher"], batch), k)
    sparse = ev.finalize_metrics(ev.make_sparse_agreement_step(
        m["cfg"], k=k, device="cpu")(m["student"], sb), k)
    for sl in ("all", "speech"):
        for key in ("top1_agreement", f"top{k}_agreement", "kl_t1",
                    "student_ce", "teacher_ce"):
            np.testing.assert_allclose(sparse[sl][key], dense[sl][key],
                                       rtol=5e-3, atol=5e-4,
                                       err_msg=f"{sl}.{key}")


def test_finalize_metrics_matches_jax(models):
    m = models
    batch = _batch(seed=5)
    sums = ev.make_agreement_step(m["cfg"], k=K, device="cpu")(
        m["student"], m["teacher"], batch)
    assert ev.finalize_metrics(sums, K) == jev.finalize_metrics(
        {k: np.float32(v) for k, v in sums.items()}, K)
    empty = {f"{k}_{sl}": 0.0 for sl in ("all", "speech")
             for k in ("n", "kl", "agree1", "agreek", "n_label", "ce_s",
                       "ce_t")}
    empty.update(n_all=2.0, agree1_all=1.0)
    out = ev.finalize_metrics(empty, k=10)
    assert out == jev.finalize_metrics(empty, k=10)
    assert out["speech"]["top1_agreement"] is None
    assert out["all"]["top1_agreement"] == 0.5
    assert out["all"]["student_ce"] is None


def test_agreement_steps_raise_without_cuda(models, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ev.make_agreement_step(models["cfg"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ev.make_sparse_agreement_step(models["cfg"])
