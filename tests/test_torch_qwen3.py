"""PyTorch port, Qwen3 decoder: the port's forward (no-cache and
cache-prefill) against the JAX ``qwen3.forward`` on the same weights,
carried across with ``params_from_jax``. fp32, qwen3_tiny."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from speech_distill_tpu.core.config import qwen3_tiny as jax_tiny
from speech_distill_tpu.models import qwen3 as jq
from speech_distill_tpu_torch.core.config import qwen3_tiny
from speech_distill_tpu_torch.models import qwen3 as tq
from speech_distill_tpu_torch.models.convert import params_from_jax

LOGITS_ATOL = 1e-4


def _models(seed=0, vocab=64, tie=True):
    jcfg = jax_tiny(vocab, dtype="float32", remat=False,
                    tie_word_embeddings=tie)
    params = jq.init_params(jax.random.PRNGKey(seed), jcfg)
    cfg = qwen3_tiny(vocab, dtype="float32", tie_word_embeddings=tie)
    model = params_from_jax(jax.tree.map(np.asarray, params), cfg, "cpu")
    return jcfg, params, cfg, model


def test_init_params_equals_jax_init():
    """Same seed, same numpy draws: the port's init reproduces JAX's."""
    jcfg, params, cfg, _ = _models(seed=11, tie=False)
    model = tq.init_params(cfg, seed=11, device="cpu")
    ref = params_from_jax(jax.tree.map(np.asarray, params), cfg, "cpu")
    for (name, a), (_, b) in zip(model.named_parameters(),
                                 ref.named_parameters()):
        assert torch.equal(a, b), name


def test_forward_no_cache_matches_jax():
    jcfg, params, cfg, model = _models(seed=1, tie=False)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    mask = np.ones((2, 12), np.int32)
    mask[1, 9:] = 0
    ref = jq.forward(params, jnp.asarray(ids), jcfg,
                     attention_mask=jnp.asarray(mask))
    got = tq.forward(model, torch.from_numpy(ids).long(),
                     attention_mask=torch.from_numpy(mask))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               atol=LOGITS_ATOL, rtol=1e-4)


def test_forward_cache_prefill_and_suffix_match_jax():
    """Prefill a prefix into a cache, then a suffix on top of it: logits
    and the cache contents agree with JAX at every step."""
    jcfg, params, cfg, model = _models(seed=2)
    rng = np.random.default_rng(1)
    S, n0 = 16, 8
    ids = rng.integers(0, cfg.vocab_size, (1, 13)).astype(np.int32)
    mask = (np.arange(S) < 13).astype(np.int32)[None]
    jc = jq.KVCache.create(jcfg, 1, S, jnp.float32)
    tc = tq.KVCache.create(cfg, 1, S, torch.float32, "cpu")
    for lo, hi in ((0, n0), (n0, 13)):
        ref, jc = jq.forward(params, jnp.asarray(ids[:, lo:hi]), jcfg,
                             attention_mask=jnp.asarray(mask), cache=jc)
        got, tc = tq.forward(model, torch.from_numpy(ids[:, lo:hi]).long(),
                             attention_mask=torch.from_numpy(mask),
                             cache=tc)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   atol=LOGITS_ATOL, rtol=1e-4)
        assert tc.length == int(jc.length) == hi
        np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k),
                                   atol=1e-5, rtol=1e-5)


def test_building_blocks_match_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    scale = rng.normal(size=(16,)).astype(np.float32)
    pos = np.arange(5)[None].repeat(2, 0)
    np.testing.assert_allclose(
        tq.rms_norm(torch.from_numpy(x), torch.from_numpy(scale),
                    1e-6).numpy(),
        np.asarray(jq.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6)),
        atol=1e-6, rtol=1e-5)
    tcos, tsin = tq.rope_angles(torch.from_numpy(pos), 16, 1e6)
    jcos, jsin = jq.rope_angles(jnp.asarray(pos), 16, 1e6)
    np.testing.assert_allclose(tcos.numpy(), np.asarray(jcos), atol=1e-6)
    np.testing.assert_allclose(
        tq.apply_rope(torch.from_numpy(x), tcos, tsin).numpy(),
        np.asarray(jq.apply_rope(jnp.asarray(x), jcos, jsin)),
        atol=1e-5, rtol=1e-5)


REMAT_RUNS = ("full", "dots", "half", "everything", "no_remat")


def _held_bytes_and_grads(model, tree, ids):
    """Loss and the gradients of every weight through ``forward_train``,
    and the bytes the forward leaves alive for the backward: the storages
    made during the forward that outlive it (what autograd, a checkpoint
    frame or selective checkpointing's cache keeps; an outer
    ``saved_tensors_hooks`` sees none of the last two)."""
    from torch.multiprocessing.reductions import StorageWeakRef
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves as pt_leaves
    from speech_distill_tpu_torch.core.tree import tree_leaves

    class Made(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.storages = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in pt_leaves(out):
                if isinstance(t, torch.Tensor):
                    st = t.untyped_storage()
                    self.storages[st.data_ptr()] = (StorageWeakRef(st),
                                                    st.nbytes())
            return out

    made = Made()
    with made:
        logits = tq.forward_train(model, ids, weights=tree,
                                  return_hidden=False, device="cpu")
        loss = torch.sum(torch.square(logits)) * 1e-3
    del logits
    held = sum(n for ref, n in made.storages.values() if not ref.expired())
    grads = torch.autograd.grad(loss, tree_leaves(tree))
    return float(loss.detach()), grads, held


@pytest.fixture(scope="module")
def remat_runs():
    """Each remat policy (and remat off) through the port's and JAX's
    forward, on the same weights and ids."""
    import dataclasses
    from speech_distill_tpu_torch.core.tree import tree_leaves
    from speech_distill_tpu_torch.distill.train_step import full_trainable
    jcfg, params, cfg, _ = _models(seed=4, vocab=64, tie=False)
    ids = np.random.default_rng(3).integers(0, 64, (2, 9))
    out = {}
    for run in REMAT_RUNS:
        remat, policy = run != "no_remat", (
            "full" if run == "no_remat" else run)
        model = params_from_jax(jax.tree.map(np.asarray, params),
                                dataclasses.replace(cfg, remat=remat,
                                                    remat_policy=policy),
                                "cpu")
        tree = full_trainable(model)
        loss, grads, held = _held_bytes_and_grads(model, tree,
                                                  torch.from_numpy(ids))
        c = type(jcfg)(**{**jcfg.__dict__, "remat": remat,
                          "remat_policy": policy})

        def f(p, c=c):
            lg = jq.forward(p, jnp.asarray(ids), c)
            return jnp.sum(jnp.square(lg.astype(jnp.float32))) * 1e-3
        jl, jg = jax.jit(jax.value_and_grad(f))(params)
        out[run] = {"loss": loss, "grads": [g.numpy() for g in grads],
                    "held": held, "jax_loss": float(jl),
                    "jax_grads": [np.asarray(g) for g in
                                  jax.tree.leaves(jg)],
                    "n_leaves": len(tree_leaves(tree))}
    return out


@pytest.mark.parametrize("run", REMAT_RUNS)
def test_remat_policy_matches_full_and_jax(remat_runs, run):
    """Each policy's loss and gradients equal "full"'s and JAX's forward
    under the same policy (atol 1e-5, as JAX's
    ``test_remat_half_policy_grads_match``), and the bytes kept for the
    backward fall in the policies' order: full < half < everything and
    full < dots < everything; "everything" keeps what no remat keeps."""
    got, full = remat_runs[run], remat_runs["full"]
    np.testing.assert_allclose(got["loss"], full["loss"], rtol=1e-6)
    np.testing.assert_allclose(got["loss"], got["jax_loss"], rtol=1e-5)
    assert len(got["grads"]) == len(got["jax_grads"]) == got["n_leaves"]
    for a, b, c in zip(got["grads"], full["grads"], got["jax_grads"]):
        np.testing.assert_allclose(a, b, atol=1e-5)
        np.testing.assert_allclose(a, c, atol=1e-5)
    held = {r: remat_runs[r]["held"] for r in REMAT_RUNS}
    if run in ("half", "dots"):
        assert held["full"] < held[run] < held["everything"], held
    elif run == "full":
        assert held["full"] < min(held["half"], held["dots"]), held
    else:
        assert held[run] == held["no_remat"] > held["dots"], held
