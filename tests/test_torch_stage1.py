"""PyTorch port, stage 1 (the embedding warm-up): ``make_stage1_step``
through the plain head, the fused chunked CE and the K2 route, each held
against the JAX step of the same route over two steps (A 1 and A 2, with
and without weight decay); ``make_stage1_eval_step``, the row mask, the
packing, the batch iterator and the eval aggregator. qwen3_tiny(96) in
fp32 with old vocab 48, CPU (the JAX K2 in interpret mode)."""
import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from speech_distill_tpu.core.config import qwen3_tiny as jax_tiny
from speech_distill_tpu.distill import train_step as jts
from speech_distill_tpu.models import qwen3 as jq
from speech_distill_tpu.pipelines.stage1 import pack_sequences as jpack
from speech_distill_tpu_torch.core.config import qwen3_tiny
from speech_distill_tpu_torch.core.trainer import LoopConfig, train_loop
from speech_distill_tpu_torch.distill import train_step as tts
from speech_distill_tpu_torch.models.convert import params_from_jax
from speech_distill_tpu_torch.pipelines import stage1

VOCAB, OLD = 96, 48
ROUTES = {"plain": {}, "fused_xla": dict(fused_loss=True),
          "fused_pallas": dict(fused_loss=True, fused_backend="pallas")}


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_tiny(VOCAB, dtype="float32", remat=False)
    params = jax.tree.map(np.asarray,
                          jq.init_params(jax.random.PRNGKey(0), jcfg))
    cfg = qwen3_tiny(VOCAB, dtype="float32", remat=False)
    return jcfg, params, cfg, params_from_jax(params, cfg, "cpu")


def _batch(A=1, B=2, T=12, seed=0):
    """The batch of tests/test_stage1_fused.py with a leading [A] axis:
    ids over the whole vocab, the first two labels of each row -100."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, VOCAB, (A, B, T)).astype(np.int32)
    labels = ids.astype(np.int64).copy()
    labels[..., :2] = -100
    return {"input_ids": ids, "attention_mask": np.ones((A, B, T), np.int32),
            "labels": labels}


def _trainable(params):
    return {"embed": {"weight": torch.from_numpy(
        params["embed"]["weight"].copy()).requires_grad_()}}


@pytest.mark.parametrize("A,wd", [(1, 0.0), (2, 0.01)],
                         ids=["A1", "A2-decay"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_stage1_steps_match_jax(setup, route, A, wd):
    jcfg, params, cfg, model = setup
    batch = _batch(A=A, seed=A)
    jopt = jts.make_optimizer(1e-2, 1, 10, weight_decay=wd)
    jstep = jts.make_stage1_step(jcfg, jopt, OLD, donate=False,
                                 **ROUTES[route])
    jstate = jts.init_state(
        {"embed": {"weight": jnp.asarray(params["embed"]["weight"])}}, jopt)
    jbase = jax.tree.map(jnp.asarray, params)
    opt = tts.make_optimizer(1e-2, 1, 10, weight_decay=wd)
    step = tts.make_stage1_step(cfg, opt, OLD, device="cpu", **ROUTES[route])
    state = tts.init_state(_trainable(params), opt)
    for rtol in (1e-5, 1e-4):
        jstate, jm = jstep(jstate, jbase, jax.tree.map(jnp.asarray, batch))
        state, m = step(state, model, batch)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=rtol)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
    got = state.trainable["embed"]["weight"].detach().numpy()
    ref = np.asarray(jstate.trainable["embed"]["weight"])
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    start = params["embed"]["weight"]
    if wd == 0.0:
        # old rows get a zero gradient and no decay: bit-equal
        np.testing.assert_array_equal(got[:OLD], start[:OLD])
    else:
        # AdamW decays rows whose gradient is zero, as optax does
        assert not np.array_equal(got[:OLD], start[:OLD])
        np.testing.assert_allclose(got[:OLD], ref[:OLD], atol=1e-7, rtol=0)
    assert not np.array_equal(got[OLD:], start[OLD:])


def test_fused_route_steps_need_a_known_backend(setup):
    *_, cfg, _ = setup
    opt = tts.make_optimizer(1e-2, 1, 10)
    with pytest.raises(ValueError, match="fused_backend"):
        tts.make_stage1_step(cfg, opt, OLD, fused_loss=True,
                             fused_backend="ring", device="cpu")


def test_untied_head_is_trained_and_masked(setup):
    """An untied head: {"embed", "lm_head"} both train, both masked, as
    the JAX step trains them."""
    jcfg, _, _, _ = setup
    jcfg_u = jax_tiny(VOCAB, dtype="float32", remat=False,
                      tie_word_embeddings=False)
    params = jax.tree.map(np.asarray,
                          jq.init_params(jax.random.PRNGKey(3), jcfg_u))
    cfg = qwen3_tiny(VOCAB, dtype="float32", remat=False,
                     tie_word_embeddings=False)
    model = params_from_jax(params, cfg, "cpu")
    batch = _batch(seed=5)
    jtr = {k: {"weight": jnp.asarray(params[k]["weight"])}
           for k in ("embed", "lm_head")}
    jopt = jts.make_optimizer(1e-2, 1, 10)
    jstate, jm = jts.make_stage1_step(jcfg_u, jopt, OLD, donate=False)(
        jts.init_state(jtr, jopt), jax.tree.map(jnp.asarray, params),
        jax.tree.map(jnp.asarray, batch))
    opt = tts.make_optimizer(1e-2, 1, 10)
    tr = {k: {"weight": torch.from_numpy(params[k]["weight"].copy())
              .requires_grad_()} for k in ("embed", "lm_head")}
    state, m = tts.make_stage1_step(cfg, opt, OLD, device="cpu")(
        tts.init_state(tr, opt), model, batch)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-4)


def test_mask_new_token_grads_matches_jax():
    rng = np.random.default_rng(0)
    g = {"embed": {"weight": rng.normal(size=(10, 4)).astype(np.float32)},
         "lm_head": {"weight": rng.normal(size=(10, 4)).astype(np.float32)}}
    ref = jts.mask_new_token_grads(jax.tree.map(jnp.asarray, g), 6)
    got = tts.mask_new_token_grads(
        {k: {"weight": torch.from_numpy(v["weight"])} for k, v in g.items()},
        6)
    for k in g:
        np.testing.assert_array_equal(got[k]["weight"].numpy(),
                                      np.asarray(ref[k]["weight"]))


def test_stage1_eval_step_sums_match_jax(setup):
    jcfg, params, cfg, model = setup
    batch = _batch(A=2, B=3, T=10, seed=7)
    batch["labels"][1, 2] = -100                  # one whole padded row
    jeval = jts.make_stage1_eval_step(jcfg)
    ref = jeval({"embed": {"weight": jnp.asarray(params["embed"]["weight"])}},
                jax.tree.map(jnp.asarray, params),
                jax.tree.map(jnp.asarray, batch))
    got = tts.make_stage1_eval_step(cfg, device="cpu")(
        _trainable(params), model, batch)
    np.testing.assert_allclose(float(got["loss_sum"]),
                               float(ref["loss_sum"]), rtol=1e-5)
    assert float(got["n_tokens"]) == float(ref["n_tokens"]) == 2 * 3 * 8 - 8


@pytest.mark.parametrize("lens,seq", [([5, 3, 9], 4), ([2, 2], 3),
                                      ([1], 8), ([], 4)],
                         ids=["three-rows", "exact", "empty", "no-examples"])
def test_pack_sequences_matches_jax(lens, seq):
    rng = np.random.default_rng(1)
    id_lists = [rng.integers(1, 50, n).tolist() for n in lens]
    got = stage1.pack_sequences(id_lists, seq, eos_id=0)
    ref = jpack(id_lists, seq, eos_id=0)
    assert got.dtype == np.int32 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_stage1_batches_are_the_cli_iterator():
    """[A, B, T] groups of packed rows in the order default_rng(seed +
    epoch).permutation, full groups only, labels equal to the ids."""
    packed = np.arange(7 * 5, dtype=np.int32).reshape(7, 5)
    out = list(stage1.stage1_batches(packed, 2, 3, seed=42, epoch=1))
    order = np.random.default_rng(43).permutation(7)
    assert len(out) == 1
    b = out[0]
    assert b["input_ids"].shape == (3, 2, 5)
    np.testing.assert_array_equal(b["input_ids"].reshape(6, 5),
                                  packed[order[:6]])
    assert b["labels"].dtype == np.int64
    np.testing.assert_array_equal(b["labels"], b["input_ids"])
    assert b["attention_mask"].min() == 1


def test_eval_fn_is_the_exact_per_token_mean(setup):
    """Five rows in groups of two: the padded last group adds no token, so
    the aggregate equals one pass over all five rows."""
    _, params, cfg, model = setup
    rng = np.random.default_rng(9)
    rows = rng.integers(0, VOCAB, (5, 8)).astype(np.int32)
    eval_step = tts.make_stage1_eval_step(cfg, device="cpu")
    state = tts.init_state(_trainable(params), tts.make_optimizer(1e-3, 1, 2))
    got = stage1.make_eval_fn(eval_step, rows, 2, model)(state)
    whole = eval_step(state.trainable, model,
                      {"input_ids": rows[None],
                       "attention_mask": np.ones_like(rows)[None],
                       "labels": rows[None].astype(np.int64)})
    assert float(whole["n_tokens"]) == 5 * 7
    np.testing.assert_allclose(got["loss"], float(whole["loss_sum"]) / 35,
                               rtol=1e-6)


def test_train_loop_takes_what_the_cli_passes(setup, tmp_path):
    """``train_loop`` as ``train_stage1`` drives it: packed rows through
    ``stage1_batches``, the eval aggregator every step, load-best and
    ``tokens_per_batch``. The loop ends on the state of the best eval and
    logs tokens/s each step."""
    _, params, cfg, model = setup
    rng = np.random.default_rng(11)
    examples = [np.concatenate([rng.integers(0, OLD, 3),
                                rng.integers(OLD, VOCAB, 9)]).tolist()
                for _ in range(8)]
    packed = stage1.pack_sequences(examples, 12, eos_id=1)
    train_rows, eval_rows = packed[:6], packed[6:]
    opt = tts.make_optimizer(5e-2, 1, 10, weight_decay=0.01)
    step = tts.make_stage1_step(cfg, opt, OLD, fused_loss=True, device="cpu")
    eval_fn = stage1.make_eval_fn(tts.make_stage1_eval_step(cfg, "cpu"),
                                  eval_rows, 1, model)
    seen = []

    def recorded_eval(state):
        m = eval_fn(state)
        seen.append((m["loss"], state.step,
                     state.trainable["embed"]["weight"].detach().clone()))
        return m
    loop = LoopConfig(num_epochs=2, max_steps=3, logging_steps=1,
                      save_steps=1, save_total_limit=5,
                      output_dir=str(tmp_path), eval_steps=1,
                      load_best_at_end=True)
    final = train_loop(
        step, tts.init_state(_trainable(params), opt), (model,),
        lambda epoch: stage1.stage1_batches(train_rows, 2, 1, 42, epoch),
        loop, eval_fn=recorded_eval, tokens_per_batch=2 * 12, device="cpu")
    assert [s for _, s, _ in seen] == [1, 2, 3]
    _, best_step, best_embed = min(seen, key=lambda x: x[0])
    assert final.step == best_step
    torch.testing.assert_close(final.trainable["embed"]["weight"],
                               best_embed, atol=0, rtol=0)
    with open(tmp_path / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    train_recs = [r for r in recs if "loss" in r]
    assert [r["step"] for r in train_recs] == [1, 2, 3]
    assert all(r["tokens_per_sec"] > 0 for r in train_recs)


def test_fused_route_choice():
    bf = torch.bfloat16
    assert stage1.fused_route(4096, "cuda", bf, 1024) == (True, "pallas")
    assert stage1.fused_route(2048, "cpu", bf, 1024) == (True, "xla")
    assert stage1.fused_route(1024, "cuda", bf, 1024) == (False, "pallas")


@pytest.mark.parametrize("dtype,hidden,backend", [
    ("bfloat16", 1024, "pallas"),     # the 0.6B: K2 takes it
    ("bfloat16", 64, "pallas"),       # qwen3_tiny's width is on the list
    ("float32", 1024, "xla"),         # K2 takes bf16 h and W only
    ("float32", 64, "xla"),           # the JAX pipeline tests' tiny model
    ("bfloat16", 96, "xla"),          # a hidden size off KERNEL_DIMS
])
def test_fused_route_on_a_card_follows_what_k2_takes(dtype, hidden,
                                                     backend):
    """On a card (a "cuda" device, no card needed to choose), the route
    sends a model to K2 only where its wrappers take the model's dtype
    and hidden size; the rest take the chunked plain route, which JAX's
    K2 computes for any D and dtype (it raised in the K2 wrappers
    before)."""
    cfg = qwen3_tiny(hidden_size=hidden, dtype=dtype)
    fused, got = stage1.fused_route(4096, "cuda", cfg.torch_dtype,
                                    cfg.hidden_size)
    assert fused and got == backend
