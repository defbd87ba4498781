"""PyTorch port, pipeline parallelism (``parallel/pipeline.py``) on 2 gloo
ranks (pp 2; spawned once for the file through ``parallel/multihost.
launch``, the JAX side computed in the parent meanwhile) against the JAX
package's unpipelined one-device functions:

  * host side: ``_interleaved_schedule``'s tables and (tB0, tC0, T, K)
    equal JAX's, ``_interleave_layer_perm`` too, ``sparse_distill_sums``
    matches JAX at 1e-6, and sp with pp raises ``ValueError`` as in JAX;
  * the GPipe forward at pp 2 against JAX's unpipelined forward at 2e-4;
  * precomputed KD steps (``num_hidden_layers`` 4, 4 microbatches): GPipe
    (the fused head) against JAX's one-device step, 1F1B and interleaved
    1F1B (V 2) with LoRA and 1F1B with full finetuning against JAX's
    one-device unfused step (the 1F1B head is plain autograd, as JAX's),
    at ``test_pipeline_parallel.py``'s tolerances: loss rtol 1e-5, the
    gradients (through the first step's AdamW moments: its learning rate
    is 0) atol 2e-4 / rtol 2e-3;
  * each rank's peak of stashed chunk inputs equals its slots in the
    tables (the largest is JAX's K);
  * ``train --pp 2 --pp_schedule 1f1b --pp_interleave 2`` against the
    one-process CLI of the port (itself held to JAX's by
    ``test_torch_train_cli.py``) at those tolerances.

fp32 throughout. The children import torch and the port only."""
import dataclasses
import functools
import json
import os
import threading

import numpy as np
import pytest
import torch

from speech_distill_tpu_torch.core.config import (DistillConfig, LoraConfig,
                                                  MeshConfig, qwen3_tiny)
from speech_distill_tpu_torch.parallel import multihost

WORLD = 2
V = 128
B, T, K, M = 8, 16, 8, 4
# name -> (pp_schedule, pp_interleave, use_lora, head_loss of JAX's step)
STEPS = {"gpipe": ("gpipe", 1, True, "fused"),
         "1f1b": ("1f1b", 1, True, "unfused"),
         "interleaved": ("1f1b", 2, True, "unfused"),
         "1f1b_full": ("1f1b", 1, False, "unfused")}
SCHEDULES = [(2, 1, 4), (2, 2, 4), (2, 2, 3), (4, 2, 8)]
TOL = dict(atol=2e-4, rtol=2e-3)


def _cfg(**kw):
    return dataclasses.replace(qwen3_tiny(V, num_hidden_layers=4),
                               dtype="float32", remat=True, **kw)


def _dcfg():
    return DistillConfig(top_k=K, lora=LoraConfig(r=4, alpha=8,
                                                  init_weights="gaussian"))


def _batch():
    """JAX ``test_pipeline_parallel``'s precomputed batch: an ignored
    prefix, right padding and text positions in the speech mask."""
    rng = np.random.default_rng(0)
    labels = rng.integers(0, V, (1, B, T))
    labels[0, 1, :4] = -100
    mask = np.ones((1, B, T), np.int64)
    mask[0, 3, 12:] = 0
    smask = np.ones((1, B, T), np.int64)
    smask[0, 5, :8] = 0
    return {"input_ids": rng.integers(0, V, (1, B, T)),
            "attention_mask": mask, "labels": labels,
            "speech_token_mask": smask,
            "teacher_top_k_v": rng.normal(-2, 1, (1, B, T, K)).astype(
                np.float32),
            "teacher_top_k_i": rng.integers(0, V, (1, B, T, K)).astype(
                np.int32)}


def _jax_trees(layers: int = 4):
    """JAX ``init_params`` (seed 0) and the gaussian LoRA tree (key 2), as
    numpy trees, with the JAX config."""
    import jax
    from speech_distill_tpu.core.config import LoraConfig as JLora
    from speech_distill_tpu.core.config import qwen3_tiny as jtiny
    from speech_distill_tpu.distill.lora import init_lora
    from speech_distill_tpu.models import qwen3 as jq
    jcfg = jtiny(V, num_hidden_layers=layers, dtype="float32", remat=False)
    params = jq.init_params(jax.random.PRNGKey(0), jcfg)
    lora, base = init_lora(jax.random.PRNGKey(2), params, jcfg,
                           JLora(r=4, alpha=8, init_weights="gaussian"))
    trees = {"base": base, "lora": lora, "params": params}
    return {"cfg": jcfg, **trees,
            "np": {k: jax.tree.map(np.asarray, v) for k, v in trees.items()}}


def _torch_tree(tree):
    from speech_distill_tpu_torch.core.tree import tree_map
    return tree_map(lambda x: torch.from_numpy(np.array(x)), tree)


def _numpy(tree):
    from speech_distill_tpu_torch.core.tree import tree_map
    return tree_map(lambda x: x.detach().numpy(), tree)


def _steps(mesh, trees, schedule, interleave, use_lora, n_steps=2):
    """The port's precomputed KD step on this rank: the loss and metrics,
    the trainable tree and the moments after each step, made whole."""
    from speech_distill_tpu_torch.distill import train_step
    from speech_distill_tpu_torch.parallel import sharding
    cfg = _cfg(pp_microbatches=M, pp_interleave=interleave)
    base = sharding.shard_params(
        mesh, trees["base"] if use_lora else trees["params"], cfg)
    tr = (sharding.shard_lora(mesh, _torch_tree(trees["lora"]), cfg)
          if use_lora else train_step.full_trainable(base))
    specs = sharding.trainable_pspecs(tr, cfg, use_lora, mesh)
    opt = train_step.make_optimizer(1e-3, 1, 20)
    st = train_step.init_state(tr, opt)
    st = st._replace(opt_state=sharding.shard_opt_state(
        mesh, st.opt_state, specs))
    step = train_step.make_kd_step(cfg, _dcfg(), opt, mode="precomputed",
                                   use_lora=use_lora, donate=False,
                                   mesh=mesh, pp_schedule=schedule)
    batch = sharding.shard_batch(mesh, _batch())
    out = []
    for _ in range(n_steps):
        st, m = step(st, base, None, batch)
        whole = sharding.gather_state(st, sharding.state_pspecs(
            st, specs, mesh), mesh)
        out.append({"metrics": {k: float(v) for k, v in m.items()},
                    "trainable": _numpy(whole.trainable),
                    "mu": _numpy(whole.opt_state["mu"]),
                    "nu": _numpy(whole.opt_state["nu"])})
    return out


def _ranks(rank, world, trees, ws, out_dir):
    from speech_distill_tpu_torch.models import qwen3
    from speech_distill_tpu_torch.parallel import mesh as meshlib
    from speech_distill_tpu_torch.parallel import pipeline, sharding
    from speech_distill_tpu_torch.pipelines import train as ttrain
    mesh = meshlib.make_mesh(MeshConfig(dp=1, pp=world), device="cpu")
    res = {"coords": mesh.coords}
    model = sharding.shard_params(mesh, trees["params"],
                                  _cfg(pp_microbatches=M))
    b = _batch()
    res["n_layers"] = len(model.layers)
    res["fwd"] = qwen3.forward(
        model, torch.from_numpy(b["input_ids"][0]),
        attention_mask=torch.from_numpy(b["attention_mask"][0])).numpy()
    peaks, engine = {}, pipeline.pipelined_grads_interleaved

    def recorded(name):
        def run(*a, **kw):
            r = engine(*a, **kw)
            peaks.setdefault(name, []).append(r.peak_stash)
            return r
        return run
    for name, (schedule, inter, lora, _) in STEPS.items():
        pipeline.pipelined_grads_interleaved = recorded(name)
        res[name] = _steps(mesh, trees, schedule, inter, lora)
    pipeline.pipelined_grads_interleaved = engine
    res["peaks"] = peaks
    _fp32_loader()
    ttrain.main(_cli_args(ws, os.path.join(out_dir, "pp")) + [
        "--pp", str(world), "--pp_schedule", "1f1b", "--pp_interleave",
        "2", "--coordinator_address", "file://unused", "--num_processes",
        str(world), "--process_id", str(rank)])
    return res


def _fp32_loader():
    from speech_distill_tpu_torch.models import hf_loader as thf
    thf.load_pretrained = functools.partial(thf.load_pretrained,
                                            dtype="float32")


def _cli_args(ws, out):
    return ["--dataset_path", ws["enriched"], "--student_model",
            ws["student"], "--gradient_accumulation_steps", "1",
            "--pad_to_multiple_of", "16", "--test_size", "4",
            "--max_steps", "4", "--warmup_steps", "1",
            "--learning_rate", "2e-4", "--use_lora", "--lora_r", "4",
            "--lora_alpha", "8", "--per_device_train_batch_size", "4",
            "--num_train_epochs", "1", "--output_dir", out,
            "--device", "cpu"]


def make_ws(root, layers: int, n_rows: int = 24):
    """A tiny fp32 student (``layers`` layers, vocab 96, the tiny
    tokenizer of ``tests/test_pipelines.py``) and an enriched dataset of
    ``n_rows`` rows: student / teacher ids with a speech start, and
    stored top-K (K 8, distinct ids) from a seeded generator."""
    datasets = pytest.importorskip("datasets")
    from speech_distill_tpu_torch.core.checkpoint import export_hf
    from speech_distill_tpu_torch.models import qwen3
    from tests.test_pipelines import make_tiny_tokenizer
    student = os.path.join(root, "student")
    tok = make_tiny_tokenizer(student)
    cfg = dataclasses.replace(qwen3_tiny(96, num_hidden_layers=layers),
                              dtype="float32", remat=False)
    export_hf(qwen3._numpy_init_tree(cfg, 0), cfg, student)
    bos = tok.convert_tokens_to_ids("<|semantic_token_start|>")
    rng = np.random.default_rng(5)
    rows = {"student_input_ids": [], "teacher_input_ids": [],
            "student_attention_mask": [], "teacher_attention_mask": [],
            "teacher_top_k_v": [], "teacher_top_k_i": []}
    for _ in range(n_rows):
        n = int(rng.integers(8, 30))
        ids = rng.integers(0, len(tok), n)
        ids[int(rng.integers(1, 4))] = bos
        rows["student_input_ids"].append(ids.tolist())
        rows["teacher_input_ids"].append(ids.tolist())
        rows["student_attention_mask"].append([1] * n)
        rows["teacher_attention_mask"].append([1] * n)
        top = np.argsort(rng.random((n, 96)), axis=-1)[:, :8]
        rows["teacher_top_k_i"].append(top.tolist())
        rows["teacher_top_k_v"].append(
            np.log(rng.dirichlet(np.ones(8), n)).tolist())
    enriched = os.path.join(root, "enriched")
    datasets.Dataset.from_dict(rows).save_to_disk(enriched)
    return {"student": student, "enriched": enriched}


def final_model(path):
    from safetensors.numpy import load_file
    return load_file(os.path.join(path, "final_model", "model.safetensors"))


def cli_metrics(path):
    return [json.loads(x) for x in open(os.path.join(path,
                                                     "metrics.jsonl"))]


@pytest.fixture(scope="module")
def jax_side():
    return _jax_trees()


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    return make_ws(str(tmp_path_factory.mktemp("tpipe")), layers=4)


def _jax_steps(jax_side, use_lora, head_loss, n_steps=2):
    import jax
    from speech_distill_tpu.core.config import DistillConfig as JD
    from speech_distill_tpu.core.config import LoraConfig as JLora
    from speech_distill_tpu.distill import train_step as jts
    dcfg = JD(top_k=K, lora=JLora(r=4, alpha=8, init_weights="gaussian"))
    opt = jts.make_optimizer(1e-3, 1, 20)
    step = jts.make_kd_step(jax_side["cfg"], dcfg, opt, mode="precomputed",
                            donate=False, use_lora=use_lora,
                            head_loss=head_loss)
    base = jax_side["base"] if use_lora else jax_side["params"]
    st = jts.init_state(jax_side["lora"] if use_lora else base, opt)
    batch = {k: jax.numpy.asarray(v) for k, v in _batch().items()}
    out = []
    for _ in range(n_steps):
        st, m = step(st, base, None, batch)
        adam = next(s for s in jax.tree.leaves(
            st.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
            if hasattr(s, "mu"))
        out.append({"metrics": {k: float(v) for k, v in m.items()},
                    "mu": jax.tree.leaves(adam.mu),
                    "nu": jax.tree.leaves(adam.nu)})
    return out


def _jax_forward(jax_side):
    from speech_distill_tpu.models import qwen3 as jq
    b = _batch()
    return np.asarray(jq.forward(jax_side["params"], b["input_ids"][0],
                                 jax_side["cfg"],
                                 attention_mask=b["attention_mask"][0]))


@pytest.fixture(scope="module")
def run(jax_side, ws, tmp_path_factory):
    """The 2 ranks (launched in a thread) and, meanwhile, the JAX side and
    the port's one-process CLI."""
    out = str(tmp_path_factory.mktemp("tpipe_out"))
    box = {}

    def ranks():
        try:
            box["ranks"] = multihost.launch(
                _ranks, WORLD, jax_side["np"], ws, out,
                store_dir=str(tmp_path_factory.mktemp("store")),
                device="cpu", timeout_s=400, threads=1)
        except BaseException as e:            # re-raised below
            box["error"] = e
    th = threading.Thread(target=ranks)
    th.start()
    try:
        refs = {name: _jax_steps(jax_side, lora, head)
                for name, (_, _, lora, head) in STEPS.items()}
        refs["fwd"] = _jax_forward(jax_side)
        from speech_distill_tpu_torch.distill import train_step
        from speech_distill_tpu_torch.models import hf_loader as thf
        from speech_distill_tpu_torch.pipelines import train as ttrain
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(thf, "load_pretrained", functools.partial(
                thf.load_pretrained, dtype="float32"))
            # the 1F1B head is plain autograd in fp32, as JAX's: the
            # reference takes the unfused head too (the fused one rounds
            # d_logits to bf16)
            mp.setattr(train_step, "make_kd_step", functools.partial(
                train_step.make_kd_step, head_loss="unfused"))
            ttrain.main(_cli_args(ws, os.path.join(out, "one")))
    finally:
        th.join()
    if "error" in box:
        raise box["error"]
    return {"ranks": box["ranks"], "refs": refs, "out": out}


# ---------------------------------------------------------------------------
# host side
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("svm", SCHEDULES, ids=lambda s: "S%dV%dM%d" % s)
def test_interleaved_schedule_tables_equal_jax(svm):
    from speech_distill_tpu.parallel import pipeline as jpipe
    from speech_distill_tpu_torch.parallel import pipeline as tpipe
    got, want = tpipe._interleaved_schedule(*svm), \
        jpipe._interleaved_schedule(*svm)
    assert got[1:] == want[1:]                 # (tB0, tC0, T, K)
    assert sorted(got[0]) == sorted(want[0])
    for k in want[0]:
        np.testing.assert_array_equal(got[0][k], want[0][k], err_msg=k)
    slots = tpipe.stage_slots(*svm)
    assert max(slots) == want[4] and len(slots) == svm[0]


@pytest.mark.parametrize("L,S,Vv", [(4, 2, 2), (8, 2, 2), (8, 4, 2),
                                    (12, 2, 3)])
def test_interleave_layer_perm_equals_jax(L, S, Vv):
    from speech_distill_tpu.parallel import pipeline as jpipe
    from speech_distill_tpu_torch.parallel import pipeline as tpipe
    np.testing.assert_array_equal(tpipe._interleave_layer_perm(L, S, Vv),
                                  jpipe._interleave_layer_perm(L, S, Vv))


def test_sparse_distill_sums_matches_jax():
    """Two row slices' sums over the global denominators, each against
    JAX's, and their total against the full batch's masked means."""
    import jax.numpy as jnp
    from speech_distill_tpu.distill import losses as jl
    from speech_distill_tpu_torch.distill import losses as tl
    rng = np.random.default_rng(3)
    s = rng.normal(0, 2, (4, 9, 32)).astype(np.float32)
    labels = rng.integers(0, 32, (4, 9))
    labels[1, :3] = -100
    valid = (labels != -100).astype(np.float32)
    v = rng.normal(-2, 1, (4, 9, 6)).astype(np.float32)
    idx = rng.integers(0, 32, (4, 9, 6)).astype(np.int32)
    idx[:, :, 0] = np.maximum(labels, 0)
    denom = np.float32(max(valid.sum(), 1.0))
    n_hits = np.float32(max(((idx == labels[..., None]) *
                             valid[..., None]).sum(), 1.0))
    totals = np.zeros(4)
    for rows in (slice(0, 2), slice(2, 4)):
        got = tl.sparse_distill_sums(
            torch.from_numpy(s[rows]), torch.from_numpy(labels[rows]),
            torch.from_numpy(valid[rows]), torch.from_numpy(v[rows]),
            torch.from_numpy(idx[rows]), torch.tensor(denom),
            torch.tensor(n_hits), 2.0, 0.5)
        want = jl.sparse_distill_sums(
            jnp.asarray(s[rows]), jnp.asarray(labels[rows]),
            jnp.asarray(valid[rows]), jnp.asarray(v[rows]),
            jnp.asarray(idx[rows]), denom, n_hits, 2.0, 0.5)
        for a, b in zip(got, want):
            np.testing.assert_allclose(float(a), float(b), rtol=1e-6,
                                       atol=1e-6)
        totals += np.array([float(x) for x in got])
    pad = np.zeros((4, 1), np.int64) - 100
    full = tl.sparse_distill_loss(
        torch.from_numpy(np.concatenate([s, s[:, :1]], 1)),
        torch.from_numpy(np.concatenate([v, v[:, :1]], 1)),
        torch.from_numpy(np.concatenate([idx, idx[:, :1]], 1)),
        torch.from_numpy(np.concatenate([pad, labels], 1)), None, 2.0, 0.5)
    np.testing.assert_allclose(totals, [float(x) for x in full], rtol=1e-5)


def test_sp_with_pp_raises_as_jax():
    """The train CLI refuses --sp with --pp (JAX ``train.py:200-202``)
    and an interleave without 1F1B, before anything loads; the forward
    refuses a ring inside a pipeline (JAX ``qwen3.py:544-547``)."""
    from speech_distill_tpu_torch.models import qwen3
    from speech_distill_tpu_torch.parallel.mesh import Mesh
    from speech_distill_tpu_torch.pipelines import train as ttrain
    parse = ttrain.build_parser().parse_args
    with pytest.raises(ValueError, match="cannot combine"):
        ttrain.check_ported(parse(["--dataset_path", "x", "--sp", "2",
                                   "--pp", "2"]))
    with pytest.raises(ValueError, match="requires --pp_schedule 1f1b"):
        ttrain.check_ported(parse(["--dataset_path", "x", "--pp", "2",
                                   "--pp_interleave", "2"]))
    shape = {"dp": 1, "pp": 2, "sp": 2, "tp": 1}
    model = qwen3.init_params(_cfg(attn_impl="ring", pp_microbatches=2),
                              device="cpu")
    model.mesh = Mesh(shape, {a: 0 for a in shape}, torch.device("cpu"))
    with pytest.raises(ValueError, match="cannot nest"):
        qwen3.forward(model, torch.zeros(2, 8, dtype=torch.long))


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------


def test_stages_hold_their_layers(run):
    assert [r["coords"]["pp"] for r in run["ranks"]] == [0, 1]
    assert [r["n_layers"] for r in run["ranks"]] == [2, 2]


def test_gpipe_forward_matches_jax(run):
    """Every stage gets the last stage's logits (the GPipe forward, no
    grad), equal to JAX's unpipelined forward on the valid rows."""
    want = run["refs"]["fwd"]
    valid = _batch()["attention_mask"][0].astype(bool)
    for r in run["ranks"]:
        np.testing.assert_allclose(r["fwd"][valid], want[valid], atol=2e-4,
                                   rtol=2e-4)


@pytest.mark.parametrize("name", list(STEPS))
def test_pipelined_kd_step_matches_jax_one_device(run, name):
    """Each step's loss and metrics, and its gradient through the AdamW
    moments (mu / 0.1 is the first step's clipped gradient, nu / 0.001 its
    square; the first step's learning rate is 0, so the second step sees
    the same parameters). The parameters after the second step are not
    compared: Adam moves an element whose gradient is near zero by the
    learning rate whatever its sign, and a reordered sum flips it."""
    ref = run["refs"][name]
    for r in run["ranks"]:
        for got, want in zip(r[name], ref):
            for k, w in want["metrics"].items():
                np.testing.assert_allclose(
                    got["metrics"][k], w,
                    **(TOL if k == "grad_norm" else dict(rtol=1e-5)),
                    err_msg=k)
        got, want = r[name][0], ref[0]
        for key, scale in (("mu", 0.1), ("nu", 1e-3)):
            g = _leaves(got[key])
            assert len(g) == len(want[key])
            for a, b in zip(g, want[key]):
                np.testing.assert_allclose(a / scale, np.asarray(b) / scale,
                                           **TOL, err_msg=key)


def _leaves(tree):
    from speech_distill_tpu_torch.core.tree import tree_leaves
    return tree_leaves(tree)


@pytest.mark.parametrize("name,inter", [("1f1b", 1), ("interleaved", 2)])
def test_peak_stash_is_the_tables_slots(run, name, inter):
    from speech_distill_tpu_torch.parallel import pipeline as tpipe
    slots = tpipe.stage_slots(WORLD, inter, M)
    K_ = tpipe._interleaved_schedule(WORLD, inter, M)[4]
    for r in run["ranks"]:
        s = r["coords"]["pp"]
        assert r["peaks"][name] == [slots[s]] * 2
    assert max(slots) == K_


def test_train_cli_pp2_interleaved_matches_one_process(run):
    """4 steps of precomputed LoRA KD (per-device batch 4, eval on 4 held
    rows): the pipelined CLI's eval losses and exported model against the
    one-process CLI's with the unfused head."""
    got = cli_metrics(os.path.join(run["out"], "pp"))
    ref = cli_metrics(os.path.join(run["out"], "one"))
    assert [m["step"] for m in got] == [m["step"] for m in ref]
    for g, w in zip(got, ref):
        for k in (k for k in w if "loss" in k):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)
    g = final_model(os.path.join(run["out"], "pp"))
    w = final_model(os.path.join(run["out"], "one"))
    assert sorted(g) == sorted(w)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], **TOL, err_msg=k)
