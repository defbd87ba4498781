"""PyTorch port, sequence parallelism (``ops/ring_attention.py`` and the
sp paths of the forward, the steps and the CLIs) on 4 gloo ranks
(spawned once for the file through ``parallel/multihost.launch``, the JAX
side computed in the parent meanwhile) against the JAX package:

  * host side: ``zigzag_order`` / ``zigzag_inverse`` and ``ring_available``
    / ``zigzag_available`` give JAX's answers; a ring ``attn_impl``
    without an sp mesh is the plain forward (JAX
    ``test_ring_no_active_mesh_falls_back``);
  * ring and zig-zag attention at sp 2 x tp 2 and at sp 4 against JAX's
    ``ring_attention`` / ``zigzag_ring_attention`` on its 8 virtual
    devices: outputs at 1e-5, gradients of q / k / v at 1e-4;
  * ``qwen3.forward`` with "ring" and "ring_zigzag" at sp 2 x tp 2, the
    ranks' positions gathered, against JAX's forward at 2e-4 on the valid
    rows of a right-padded batch;
  * the precomputed LoRA KD step at sp 2 x tp 2, contiguous and zig-zag,
    and the online sparse one with the teacher on the zig-zag ring too,
    against JAX's one-device step with the same head (JAX
    ``test_ring_attention.py``'s tolerances: loss rtol 1e-5; with the
    unfused head the AdamW moments, the gradients' image, atol 1e-5 /
    rtol 1e-4; with the fused head the gradient norm at rtol 1e-4);
  * the stage-1 step at dp 2 x sp 2 (the JAX CLI's mesh for ``--sp 2`` on
    4 devices: tp 1, dp the rest) against JAX's one-device stage-1 step,
    and the KD step there with ZeRO-1;
  * ``train --sp 2 --sp_zigzag`` and ``stage1 --sp 2`` (dp 2 x sp 2)
    against the one-process CLIs of the port (themselves held to JAX's
    by ``test_torch_train_cli.py`` / ``test_torch_pipelines.py``).

fp32 throughout. The children import torch and the port only."""
import dataclasses
import functools
import os
import threading

import numpy as np
import pytest
import torch

from speech_distill_tpu_torch.core.config import (DistillConfig, LoraConfig,
                                                  MeshConfig, qwen3_tiny)
from speech_distill_tpu_torch.parallel import multihost
from tests.test_torch_pipeline import cli_metrics, final_model, make_ws

WORLD = 4
V = 128
B, T, K = 4, 16, 8
H, KVH, DH = 4, 2, 8
MESHES = {"sp2tp2": dict(dp=1, sp=2, tp=2), "sp4": dict(dp=1, sp=4, tp=1)}
IMPLS = ("ring", "ring_zigzag")
# (attn_impl, head_loss, mode): the unfused head's gradients are compared
# element by element; the fused head rounds d_logits to bf16, where the
# ring's reassociated fp32 logits may flip a rounding, so its run is held
# by the loss and the gradient norm; online, the teacher's forward takes
# the ring too and gives the rank's top-K
KD_RUNS = (("ring", "unfused", "precomputed"),
           ("ring_zigzag", "unfused", "precomputed"),
           ("ring_zigzag", "fused", "precomputed"),
           ("ring_zigzag", "unfused", "online_sparse"))
S1_OLD, S1_T = 96, 16          # stage 1: the old vocabulary, the length


def _cfg(**kw):
    return dataclasses.replace(qwen3_tiny(V), dtype="float32", **kw)


def _dcfg():
    return DistillConfig(top_k=K, lora=LoraConfig(r=4, alpha=8,
                                                  init_weights="gaussian"))


def _qkvw():
    rng = np.random.default_rng(7)
    return [rng.normal(0, 1, s).astype(np.float32) for s in
            ((2, T, H, DH), (2, T, KVH, DH), (2, T, KVH, DH), (2, T, H, DH))]


def _batch():
    """A precomputed batch with an ignored prefix, right padding and text
    positions in the speech mask (JAX ``test_pipeline_parallel``'s)."""
    rng = np.random.default_rng(0)
    labels = rng.integers(0, V, (1, B, T))
    labels[0, 1, :4] = -100
    mask = np.ones((1, B, T), np.int64)
    mask[0, 3, 11:] = 0
    labels[0, 3, 11:] = -100
    smask = np.ones((1, B, T), np.int64)
    smask[0, 2, :7] = 0
    return {"input_ids": rng.integers(0, V, (1, B, T)),
            "attention_mask": mask, "labels": labels,
            "speech_token_mask": smask,
            "teacher_top_k_v": rng.normal(-2, 1, (1, B, T, K)).astype(
                np.float32),
            "teacher_top_k_i": rng.integers(0, V, (1, B, T, K)).astype(
                np.int32)}


def _s1_batch():
    """Two [1, 4, 16] stage-1 batches: packed rows, labels the ids."""
    rng = np.random.default_rng(4)
    out = []
    for _ in range(2):
        ids = rng.integers(0, V, (1, 4, S1_T))
        out.append({"input_ids": ids, "attention_mask": np.ones_like(ids),
                    "labels": ids.copy()})
    return out


def _torch_tree(tree):
    from speech_distill_tpu_torch.core.tree import tree_map
    return tree_map(lambda x: torch.from_numpy(np.array(x)), tree)


def _numpy(tree):
    from speech_distill_tpu_torch.core.tree import tree_map
    return tree_map(lambda x: x.detach().numpy(), tree)


def _attention(mesh):
    """Each route's output and q / k / v gradients of sum(out * w) on this
    rank's positions and heads, with the positions and head offsets."""
    from speech_distill_tpu_torch.ops import ring_attention as ra
    q, k, v, w = map(torch.from_numpy, _qkvw())
    t = mesh.index("tp")
    hq = slice(t * H // mesh.tp, (t + 1) * H // mesh.tp)
    hk = slice(t * KVH // mesh.tp, (t + 1) * KVH // mesh.tp)
    out = {}
    for zz in (False, True):
        pos = ra.local_positions(T, mesh, zz)
        ql, kl, vl = (x[:, pos][:, :, hs].clone().requires_grad_(True)
                      for x, hs in ((q, hq), (k, hk), (v, hk)))
        fn = ra.zigzag_ring_attention if zz else ra.ring_attention
        o = fn(ql, kl, vl, mesh)
        (o * w[:, pos][:, :, hq]).sum().backward()
        out["zigzag" if zz else "ring"] = {
            "pos": pos.numpy(), "hq": hq, "hk": hk,
            "o": o.detach().numpy(), "dq": ql.grad.numpy(),
            "dk": kl.grad.numpy(), "dv": vl.grad.numpy()}
    return out


def _forwards(mesh, trees):
    from speech_distill_tpu_torch.models import qwen3
    from speech_distill_tpu_torch.parallel import sharding
    b = _batch()
    out = {}
    for impl in IMPLS:
        model = sharding.shard_params(mesh, trees["params"],
                                      _cfg(attn_impl=impl))
        ids = torch.from_numpy(b["input_ids"][0])
        logits = qwen3.forward(model, ids, attention_mask=torch.from_numpy(
            b["attention_mask"][0]))
        zz = qwen3.sequence_layout(model, T)[1]
        out[impl] = {"local": logits.shape[1],
                     "whole": sharding.gather_sequence(logits, mesh,
                                                       zz).numpy()}
    return out


def _kd_steps(mesh, trees, impl, head_loss, mode, n_steps=2, zero1=False):
    from speech_distill_tpu_torch.distill import train_step
    from speech_distill_tpu_torch.parallel import sharding
    cfg = _cfg(attn_impl=impl, remat=True)
    base = sharding.shard_params(mesh, trees["base"], cfg)
    teacher = sharding.shard_params(mesh, trees["teacher"], cfg)
    tr = sharding.shard_lora(mesh, _torch_tree(trees["lora"]), cfg)
    specs = sharding.trainable_pspecs(tr, cfg, True, mesh)
    opt = train_step.make_optimizer(1e-3, 1, 20)
    st = train_step.init_state(tr, opt)
    st = st._replace(opt_state=sharding.shard_opt_state(
        mesh, st.opt_state, specs, zero1=zero1))
    step = train_step.make_kd_step(cfg, _dcfg(), opt, mode=mode,
                                   donate=False, mesh=mesh,
                                   head_loss=head_loss, zero1=zero1)
    batch = sharding.shard_batch(mesh, _batch())
    out = []
    for _ in range(n_steps):
        st, m = step(st, base, teacher, batch)
        whole = sharding.gather_state(st, sharding.state_pspecs(
            st, specs, mesh, zero1=zero1), mesh)
        out.append({"metrics": {k: float(v) for k, v in m.items()},
                    "mu": _numpy(whole.opt_state["mu"]),
                    "nu": _numpy(whole.opt_state["nu"])})
    return out


def _stage1_steps(mesh, trees):
    from speech_distill_tpu_torch.distill import train_step
    from speech_distill_tpu_torch.parallel import sharding
    cfg = _cfg(attn_impl="ring", remat=True)
    base = sharding.shard_params(mesh, trees["params"], cfg)
    tr = {"embed": {"weight": torch.from_numpy(np.array(
        trees["params"]["embed"]["weight"])).requires_grad_(True)}}
    opt = train_step.make_optimizer(1e-2, 1, 10)
    st = train_step.init_state(tr, opt)
    step = train_step.make_stage1_step(cfg, opt, S1_OLD, donate=False,
                                       fused_loss=True, device="cpu",
                                       mesh=mesh)
    out = []
    for b in _s1_batch():
        st, m = step(st, base, sharding.shard_batch(mesh, b))
        out.append({k: float(v) for k, v in m.items()})
    return out, st.trainable["embed"]["weight"].detach().numpy()


def _ranks(rank, world, trees, ws, out_dir):
    from speech_distill_tpu_torch.parallel import mesh as meshlib
    from speech_distill_tpu_torch.pipelines import stage1 as tstage1
    from speech_distill_tpu_torch.pipelines import train as ttrain
    res = {}
    for name, shape in MESHES.items():
        mesh = meshlib.make_mesh(MeshConfig(**shape), device="cpu")
        res[name] = {"coords": mesh.coords, "attn": _attention(mesh)}
        if name == "sp2tp2":
            res[name]["fwd"] = _forwards(mesh, trees)
            for run in KD_RUNS:
                res[name][run] = _kd_steps(mesh, trees, *run)
    dp2 = meshlib.make_mesh(MeshConfig(tp=1, sp=2), device="cpu")
    res["stage1"] = _stage1_steps(dp2, trees)
    res["dp2sp2_zero1"] = _kd_steps(dp2, trees, "ring", "unfused",
                                    "precomputed", zero1=True)
    _fp32_loader()
    flags = ["--coordinator_address", "file://unused", "--num_processes",
             str(world), "--process_id", str(rank)]
    ttrain.main(_train_args(ws, os.path.join(out_dir, "sp"), 2) +
                ["--sp", "2", "--sp_zigzag"] + flags)
    # stage 1 starts its group from torchrun's variables
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank),
                      MASTER_ADDR="file://unused")
    tstage1.main(_stage1_args(ws, os.path.join(out_dir, "s1sp"), 2) +
                 ["--sp", "2"])
    return res


def _fp32_loader():
    from speech_distill_tpu_torch.models import hf_loader as thf
    thf.load_pretrained = functools.partial(thf.load_pretrained,
                                            dtype="float32")


def _train_args(ws, out, dp):
    return ["--dataset_path", ws["enriched"], "--student_model",
            ws["student"], "--gradient_accumulation_steps", "1",
            "--pad_to_multiple_of", "16", "--test_size", "4",
            "--max_steps", "4", "--warmup_steps", "1",
            "--learning_rate", "2e-4", "--use_lora", "--lora_r", "4",
            "--lora_alpha", "8", "--per_device_train_batch_size",
            str(4 // dp), "--num_train_epochs", "1", "--output_dir", out,
            "--device", "cpu"]


def _stage1_args(ws, out, dp):
    return ["--model_path", ws["student"], "--dataset_path", ws["raw"],
            "--num_epochs", "1", "--gradient_accumulation_steps", "1",
            "--max_seq_length", "16", "--num_new_tokens", "50",
            "--warmup_steps", "1", "--learning_rate", "1e-2",
            "--logging_steps", "1", "--save_steps", "100",
            "--eval_size", "0.25", "--eval_steps", "2", "--num_workers",
            "1", "--batch_size", str(4 // dp), "--eval_batch_size",
            str(4 // dp), "--output_dir", out, "--device", "cpu"]


def _jax_trees():
    import jax
    from speech_distill_tpu.core.config import LoraConfig as JLora
    from speech_distill_tpu.core.config import qwen3_tiny as jtiny
    from speech_distill_tpu.distill.lora import init_lora
    from speech_distill_tpu.models import qwen3 as jq
    jcfg = jtiny(V, dtype="float32", remat=False)
    params = jq.init_params(jax.random.PRNGKey(0), jcfg)
    lora, base = init_lora(jax.random.PRNGKey(2), params, jcfg,
                           JLora(r=4, alpha=8, init_weights="gaussian"))
    trees = {"base": base, "lora": lora, "params": params,
             "teacher": jq.init_params(jax.random.PRNGKey(1), jcfg)}
    return {"cfg": jcfg, **trees,
            "np": {k: jax.tree.map(np.asarray, v) for k, v in trees.items()}}


@pytest.fixture(scope="module")
def jax_side():
    return _jax_trees()


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """The tiny student (2 layers) with its enriched dataset, and a raw
    stage-1 dataset (speech codes and texts)."""
    datasets = pytest.importorskip("datasets")
    root = str(tmp_path_factory.mktemp("tring"))
    out = make_ws(root, layers=2)
    rng = np.random.default_rng(6)
    rows = {"codes": [rng.integers(0, 50, rng.integers(3, 9)).tolist()
                      for _ in range(40)],
            "text": ["hello", "abc", "good day", "xyz"] * 10,
            "lang": ["en", "zh", "yue", "en"] * 10}
    out["raw"] = os.path.join(root, "raw")
    datasets.Dataset.from_dict(rows).save_to_disk(out["raw"])
    return out


def _jax_attention():
    """JAX's ring and zig-zag attention (and q / k / v gradients) on its
    meshes of the same sp / tp, over the global arrays; the zig-zag
    route's inputs and outputs in its permuted order, put back."""
    import jax
    import jax.numpy as jnp
    from speech_distill_tpu.core.config import MeshConfig as JMesh
    from speech_distill_tpu.ops import ring_attention as jra
    from speech_distill_tpu.parallel import mesh as jmesh
    q, k, v, w = map(jnp.asarray, _qkvw())
    out = {}
    for name, shape in MESHES.items():
        sp, tp = shape["sp"], shape["tp"]
        m = jmesh.make_mesh(JMesh(sp=sp, tp=tp))
        order = jra.zigzag_order(T, sp)
        inv = jra.zigzag_inverse(T, sp)
        res = {}
        for route in ("ring", "zigzag"):
            perm = order if route == "zigzag" else np.arange(T)
            back = inv if route == "zigzag" else np.arange(T)
            fn = jra.zigzag_ring_attention if route == "zigzag" \
                else jra.ring_attention

            def loss(q_, k_, v_):
                o = fn(q_[:, perm], k_[:, perm], v_[:, perm], m)
                return jnp.sum(o * w[:, perm]), o
            (_, o), g = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
            res[route] = {"o": np.asarray(o)[:, back],
                          "dq": np.asarray(g[0]), "dk": np.asarray(g[1]),
                          "dv": np.asarray(g[2])}
        out[name] = res
    return out


def _jax_forward(jax_side):
    from speech_distill_tpu.models import qwen3 as jq
    b = _batch()
    return np.asarray(jq.forward(jax_side["params"], b["input_ids"][0],
                                 jax_side["cfg"],
                                 attention_mask=b["attention_mask"][0]))


def _jax_kd(jax_side, head_loss, mode, n_steps=2):
    import jax
    from speech_distill_tpu.core.config import DistillConfig as JD
    from speech_distill_tpu.core.config import LoraConfig as JLora
    from speech_distill_tpu.distill import train_step as jts
    dcfg = JD(top_k=K, lora=JLora(r=4, alpha=8, init_weights="gaussian"))
    opt = jts.make_optimizer(1e-3, 1, 20)
    step = jts.make_kd_step(jax_side["cfg"], dcfg, opt, mode=mode,
                            teacher_cfg=jax_side["cfg"], donate=False,
                            head_loss=head_loss)
    st = jts.init_state(jax_side["lora"], opt)
    batch = {k: jax.numpy.asarray(v) for k, v in _batch().items()}
    out = []
    for _ in range(n_steps):
        st, m = step(st, jax_side["base"], jax_side["teacher"], batch)
        adam = next(s for s in jax.tree.leaves(
            st.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
            if hasattr(s, "mu"))
        out.append({"metrics": {k: float(v) for k, v in m.items()},
                    "mu": jax.tree.leaves(adam.mu),
                    "nu": jax.tree.leaves(adam.nu)})
    return out


def _jax_stage1(jax_side):
    import jax
    import jax.numpy as jnp
    from speech_distill_tpu.distill import train_step as jts
    opt = jts.make_optimizer(1e-2, 1, 10)
    step = jts.make_stage1_step(jax_side["cfg"], opt, S1_OLD, donate=False,
                                fused_loss=True, fused_backend="xla")
    st = jts.init_state({"embed": {"weight": jnp.asarray(
        jax_side["params"]["embed"]["weight"])}}, opt)
    out = []
    for b in _s1_batch():
        st, m = step(st, jax_side["params"],
                     jax.tree.map(jnp.asarray, b))
        out.append({k: float(v) for k, v in m.items()})
    return out, np.asarray(st.trainable["embed"]["weight"])


def _one_process_clis(ws, out):
    from speech_distill_tpu_torch.models import hf_loader as thf
    from speech_distill_tpu_torch.pipelines import stage1 as tstage1
    from speech_distill_tpu_torch.pipelines import train as ttrain
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(thf, "load_pretrained", functools.partial(
            thf.load_pretrained, dtype="float32"))
        ttrain.main(_train_args(ws, os.path.join(out, "one"), 1))
        tstage1.main(_stage1_args(ws, os.path.join(out, "s1one"), 1))


@pytest.fixture(scope="module")
def run(jax_side, ws, tmp_path_factory):
    """The 4 ranks (launched in a thread) and, meanwhile, the JAX side and
    the port's one-process CLIs."""
    out = str(tmp_path_factory.mktemp("tring_out"))
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
        refs = {"attn": _jax_attention(), "fwd": _jax_forward(jax_side),
                "kd": {(h, mode): _jax_kd(jax_side, h, mode)
                       for _, h, mode in KD_RUNS},
                "stage1": _jax_stage1(jax_side)}
        _one_process_clis(ws, out)
    finally:
        th.join()
    if "error" in box:
        raise box["error"]
    return {"ranks": box["ranks"], "refs": refs, "out": out}


# ---------------------------------------------------------------------------
# host side
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T_,sp", [(16, 2), (16, 4), (24, 3), (64, 4)])
def test_zigzag_order_and_inverse_equal_jax(T_, sp):
    from speech_distill_tpu.ops import ring_attention as jra
    from speech_distill_tpu_torch.ops import ring_attention as ra
    np.testing.assert_array_equal(ra.zigzag_order(T_, sp),
                                  jra.zigzag_order(T_, sp))
    np.testing.assert_array_equal(ra.zigzag_inverse(T_, sp),
                                  jra.zigzag_inverse(T_, sp))


@pytest.mark.parametrize("sp", [1, 2, 4])
def test_ring_and_zigzag_availability_equal_jax(sp):
    """JAX's predicates read ``mesh.shape`` only, so they take the port's
    mesh as it is."""
    from speech_distill_tpu.ops import ring_attention as jra
    from speech_distill_tpu_torch.ops import ring_attention as ra
    from speech_distill_tpu_torch.parallel.mesh import Mesh
    shape = {"dp": 1, "pp": 1, "sp": sp, "tp": 1}
    mesh = Mesh(shape, {a: 0 for a in shape}, torch.device("cpu"))
    for m in (mesh, None):
        for n in (6, 8, 12, 16):
            assert ra.ring_available(m, n) == jra.ring_available(m, n)
            assert ra.zigzag_available(m, n) == jra.zigzag_available(m, n)


@pytest.mark.parametrize("impl", IMPLS)
def test_ring_without_sp_mesh_is_the_plain_forward(jax_side, impl):
    """A ring ``attn_impl`` without an sp axis builds the bias and takes
    the plain route (JAX ``test_ring_no_active_mesh_falls_back``)."""
    from speech_distill_tpu_torch.models import qwen3
    from speech_distill_tpu_torch.models.convert import params_from_jax
    ids = torch.from_numpy(_batch()["input_ids"][0])
    got = qwen3.forward(params_from_jax(jax_side["np"]["params"],
                                        _cfg(attn_impl=impl), "cpu"), ids)
    want = qwen3.forward(params_from_jax(jax_side["np"]["params"],
                                         _cfg(attn_impl="xla"), "cpu"), ids)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    assert qwen3.sequence_layout(qwen3.Qwen3(_cfg(attn_impl=impl), "cpu"),
                                 T) is None


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("route", ["ring", "zigzag"])
def test_ring_attention_matches_jax(run, mesh, route):
    """Each rank's positions and heads of the output and of the q / k / v
    gradients, assembled, against JAX's over the global arrays."""
    want = run["refs"]["attn"][mesh][route]
    got = {k: np.full_like(want[k], np.nan) for k in want}
    for r in run["ranks"]:
        a = r[mesh]["attn"][route]
        pos = a["pos"]
        for k, hs in (("o", a["hq"]), ("dq", a["hq"]), ("dk", a["hk"]),
                      ("dv", a["hk"])):
            got[k][:, pos, hs] = a[k]
    np.testing.assert_allclose(got["o"], want["o"], atol=1e-5, rtol=1e-5)
    for k in ("dq", "dk", "dv"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=1e-4,
                                   err_msg=k)


@pytest.mark.parametrize("impl", IMPLS)
def test_forward_on_the_ring_matches_jax(run, impl):
    """Each rank computes T / sp positions; gathered in natural order
    they are JAX's logits on the valid rows."""
    want = run["refs"]["fwd"]
    valid = _batch()["attention_mask"][0].astype(bool)
    for r in run["ranks"]:
        got = r["sp2tp2"]["fwd"][impl]
        assert got["local"] == T // 2
        np.testing.assert_allclose(got["whole"][valid], want[valid],
                                   atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("impl,head,mode", KD_RUNS)
def test_kd_step_sp2_tp2_matches_jax_one_device(run, impl, head, mode):
    """Two steps' losses and metrics; with the unfused head the AdamW
    moments too (the gradients' image: the first step's learning rate is
    0, so the second sees the same parameters)."""
    ref = run["refs"]["kd"][head, mode]
    for r in run["ranks"]:
        for got, want in zip(r["sp2tp2"][impl, head, mode], ref):
            for k, w in want["metrics"].items():
                np.testing.assert_allclose(got["metrics"][k], w, rtol=1e-4
                                           if k == "grad_norm" else 1e-5,
                                           err_msg=k)
            if head == "fused":
                continue
            for key in ("mu", "nu"):
                g = _leaves(got[key])
                assert len(g) == len(want[key])
                for a, b in zip(g, want[key]):
                    np.testing.assert_allclose(a, np.asarray(b), atol=1e-5,
                                               rtol=1e-4, err_msg=key)


def test_kd_step_dp2_sp2_zero1_matches_jax_one_device(run):
    """ZeRO-1 over dp with sp: each rank keeps its dp slice of the
    moments, made whole here, as at dp x tp."""
    ref = run["refs"]["kd"]["unfused", "precomputed"]
    for r in run["ranks"]:
        for got, want in zip(r["dp2sp2_zero1"], ref):
            np.testing.assert_allclose(got["metrics"]["loss"],
                                       want["metrics"]["loss"], rtol=1e-5)
            for key in ("mu", "nu"):
                for a, b in zip(_leaves(got[key]), want[key]):
                    np.testing.assert_allclose(a, np.asarray(b), atol=1e-5,
                                               rtol=1e-4, err_msg=key)


def _leaves(tree):
    from speech_distill_tpu_torch.core.tree import tree_leaves
    return tree_leaves(tree)


def test_stage1_step_dp2_sp2_matches_jax_one_device(run):
    """Two steps of the fused-CE stage-1 step on the ring (dp 2 x sp 2),
    as ``test_torch_stage1.py`` holds the one-device step."""
    ref_m, ref_e = run["refs"]["stage1"]
    for r in run["ranks"]:
        got_m, got_e = r["stage1"]
        for g, w in zip(got_m, ref_m):
            np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5)
            np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                       rtol=1e-4)
        np.testing.assert_allclose(got_e, ref_e, atol=1e-4, rtol=0)


@pytest.mark.parametrize("cli,one,keys", [
    ("sp", "one", ("eval_loss",)), ("s1sp", "s1one", ("loss", "eval_loss"))])
def test_cli_sp2_matches_one_process(run, cli, one, keys):
    """``train --sp 2 --sp_zigzag`` (4 steps of precomputed LoRA KD) and
    ``stage1 --sp 2`` (eval every 2 steps, load-best) at dp 2 x sp 2, on
    the global batches of the one-process run: its metrics at rtol 1e-5
    and its exported model at rtol 1e-4 / atol 1e-6."""
    got = cli_metrics(os.path.join(run["out"], cli))
    ref = cli_metrics(os.path.join(run["out"], one))
    assert [m["step"] for m in got] == [m["step"] for m in ref]
    assert any(k in m for m in ref for k in keys)
    for g, w in zip(got, ref):
        for k in keys:
            if k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)
    g = final_model(os.path.join(run["out"], cli))
    w = final_model(os.path.join(run["out"], one))
    assert sorted(g) == sorted(w)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)
