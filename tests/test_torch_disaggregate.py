"""PyTorch port, the disaggregated teacher (``distill/disaggregate.py``) on
4 gloo ranks (spawned once for the file through ``parallel/multihost.
launch``: ranks 0-1 the student's, 2-3 the teacher's, as
``split_devices(2)`` gives them; the JAX side computed in the parent
meanwhile) against the JAX package's ``test_disaggregate.py``:

  * ``split_devices``'s bounds;
  * depth-2 lookahead over 5 batches (teacher dp 2): each yielded batch
    carries its own extraction, indices equal to JAX's ``TeacherService``
    on the same weights, values within 2e-3;
  * 3 KD steps with the student at dp 2 and the teacher at tp 2 against
    JAX's monolithic online-sparse step with exact extraction (loss rtol
    1e-5; trainable leaves atol 1e-5, rtol 1e-4), and the student at pp 2
    under 1F1B with the teacher at dp 2 against JAX's monolithic step
    with the unfused head;
  * the CosyVoice2 teacher through ``extract_fn`` (teacher dp 2): index
    sets equal to JAX's ``make_teacher_extract``, values within 1e-5;
  * 4 streams consumed by 4 threads at once on each student rank (an
    echoing teacher): each batch gets its own extraction.

fp32 throughout. The children import torch and the port only."""
import dataclasses
import threading

import numpy as np
import pytest
import torch

from speech_distill_tpu_torch.core.config import (DistillConfig, LoraConfig,
                                                  MeshConfig, qwen3_tiny)
from speech_distill_tpu_torch.distill import disaggregate
from speech_distill_tpu_torch.parallel import multihost

WORLD, N_TEACHER = 4, 2
V, B, T, K = 128, 8, 16, 8
# the CosyVoice2 teacher: a tiny Qwen2 backbone over a unified vocab
CV_TEXT, CV_SPEECH, CV_UNIFIED, CV_K = 104, 20, 130, 6


def _cfg(**kw):
    return dataclasses.replace(qwen3_tiny(V), dtype="float32", remat=False,
                               **kw)


def _dcfg():
    return DistillConfig(top_k=K, online_topk_method="exact",
                         lora=LoraConfig(r=4, alpha=8,
                                         init_weights="gaussian"))


def _batches(n, seed=0):
    """JAX ``test_disaggregate._batches``: [1, 8, 16] int32 ids, a full
    mask, random labels."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        out.append({
            "input_ids": rng.integers(0, V, (1, B, T)).astype(np.int32),
            "attention_mask": np.ones((1, B, T), np.int32),
            "labels": rng.integers(0, V, (1, B, T)).astype(np.int32)})
    return out


def _cv_backbone_kw():
    return dict(vocab_size=100, hidden_size=32, intermediate_size=64,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, head_dim=8, attention_bias=True,
                qk_norm=False, dtype="float32", remat=False,
                max_position_embeddings=256)


def _cv_batches(cfg, n=2):
    """Unified ids: text, sos, speech and eos in every row."""
    rng = np.random.default_rng(4)
    out = []
    for _ in range(n):
        ids = np.concatenate([
            rng.integers(0, 100, (B, 6)), np.full((B, 1), cfg.sos_id),
            rng.integers(cfg.speech_offset, cfg.speech_offset + CV_SPEECH,
                         (B, 4)), np.full((B, 1), cfg.eos_unified)],
            axis=1).astype(np.int32)
        out.append({"input_ids": ids[None],
                    "attention_mask": np.ones_like(ids)[None]})
    return out


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------


def _torch_tree(tree):
    from speech_distill_tpu_torch.core.tree import tree_map
    return tree_map(lambda x: torch.from_numpy(np.array(x)), tree)


def _service(trees, s_cfg, t_cfg, **kw):
    """The two meshes (every rank builds both) and the service; the
    teacher ranks serve until the students close it and get None."""
    from speech_distill_tpu_torch.models.convert import params_from_jax
    from speech_distill_tpu_torch.parallel import mesh as meshlib
    ranks = disaggregate.split_devices(N_TEACHER)
    t_mesh = meshlib.make_mesh(t_cfg, "cpu", ranks=ranks[1])
    s_mesh = meshlib.make_mesh(s_cfg, "cpu", ranks=ranks[0])
    teacher = kw.pop("teacher", None)
    if t_mesh is not None and teacher is None:
        teacher = params_from_jax(trees["teacher"], _cfg(), "cpu")
    svc = disaggregate.make_teacher_service(
        teacher if t_mesh is not None else None, None, t_mesh,
        top_k=kw.pop("top_k", K), student_vocab_size=kw.pop("svs", V),
        method="exact", depth=2, ranks=ranks, **kw)
    if svc.is_teacher:
        svc.serve()
        return None, None
    return svc, s_mesh


def _ordering(trees):
    svc, _ = _service(trees, MeshConfig(), MeshConfig(dp=2))
    if svc is None:
        return None
    batches = _batches(5)
    got = list(disaggregate.pipeline_batches(iter(batches), svc))
    in_flight = len(svc)
    svc.close()
    return {"in_flight": in_flight, "n": len(got),
            "ids_equal": all(np.array_equal(a["input_ids"], b["input_ids"])
                             for a, b in zip(got, batches)),
            "v": [g["teacher_top_k_v"][0] for g in got],
            "i": [g["teacher_top_k_i"][0] for g in got]}


def _kd(trees, s_cfg, t_cfg, schedule):
    """3 precomputed KD steps on the streamed batches (the student's
    slices made whole after them)."""
    from speech_distill_tpu_torch.core.tree import tree_leaves
    from speech_distill_tpu_torch.distill import train_step
    from speech_distill_tpu_torch.parallel import sharding
    svc, mesh = _service(trees, s_cfg, t_cfg)
    if svc is None:
        return None
    cfg = _cfg(pp_microbatches=4) if schedule == "1f1b" else _cfg()
    base = sharding.shard_params(mesh, trees["base"], cfg)
    opt = train_step.make_optimizer(1e-3, 1, 20)
    tr = sharding.shard_lora(mesh, _torch_tree(trees["lora"]), cfg)
    specs = sharding.trainable_pspecs(tr, cfg, True, mesh)
    st = train_step.init_state(tr, opt)
    st = st._replace(opt_state=sharding.shard_opt_state(mesh, st.opt_state,
                                                        specs))
    step = train_step.make_kd_step(
        cfg, _dcfg(), opt, mode="precomputed", donate=False, device="cpu",
        mesh=mesh, pp_schedule=schedule)
    ms = []
    try:
        for hb in disaggregate.pipeline_batches(
                iter([{**b, "labels": b["labels"].astype(np.int64)}
                      for b in _batches(3)]), svc):
            st, m = step(st, base, None, sharding.shard_batch(mesh, hb))
            ms.append(m)
    finally:
        svc.close()
    whole = multihost.fetch_replicated(st.trainable, specs, mesh)
    return {"loss": [float(m["loss"]) for m in ms],
            "trainable": [t.numpy() for t in tree_leaves(whole)]}


def _cosyvoice2(trees):
    from speech_distill_tpu_torch.core.config import Qwen3Config
    from speech_distill_tpu_torch.models import cosyvoice2 as cv2
    from speech_distill_tpu_torch.models.convert import (
        cosyvoice2_params_from_jax)
    from speech_distill_tpu_torch.parallel import mesh as meshlib
    cfg = cv2.CosyVoice2Config(
        backbone=Qwen3Config(**_cv_backbone_kw()), text_vocab_size=CV_TEXT,
        speech_token_size=CV_SPEECH, unified_vocab_size=CV_UNIFIED)
    ranks = disaggregate.split_devices(N_TEACHER)
    teacher = None
    if multihost.process_index() in ranks[1]:
        teacher = cosyvoice2_params_from_jax(trees["cv2"], cfg, "cpu")
    svc, _ = _service(trees, MeshConfig(), MeshConfig(dp=2),
                      teacher=teacher, top_k=CV_K, svs=CV_UNIFIED,
                      extract_fn=cv2.make_teacher_extract(cfg, CV_K,
                                                          CV_UNIFIED),
                      shard=False)
    if svc is None:
        return None
    got = list(disaggregate.pipeline_batches(iter(_cv_batches(cfg)), svc))
    svc.close()
    return {"v": [g["teacher_top_k_v"][0] for g in got],
            "i": [g["teacher_top_k_i"][0] for g in got]}


def _stress():
    """4 streams consumed by 4 threads at once on each student rank (a
    shortened switch interval), the teacher echoing each row's ids: every
    batch must get its own extraction, every thread end in time."""
    import sys

    def echo(teacher, ids, mask):
        i = ids.to(torch.int32)[..., None].repeat(1, 1, 2)
        return i.to(torch.float16), i
    svc, _ = _service(None, MeshConfig(), MeshConfig(dp=2),
                      teacher="unused", top_k=2, extract_fn=echo,
                      shard=False)
    if svc is None:
        return None
    rng = np.random.default_rng(7)
    data = [[{"input_ids": rng.integers(0, 2048, (1, B, T)),
              "attention_mask": np.ones((1, B, T), np.int64)}
             for _ in range(6)] for _ in range(4)]
    # opened in the main thread, in one order on every student rank
    streams = [disaggregate.pipeline_batches(iter(d), svc) for d in data]
    ok = [False] * len(streams)

    def consume(j):
        got = list(streams[j])
        ok[j] = len(got) == 6 and all(
            np.array_equal(g["teacher_top_k_i"][..., 0], g["input_ids"])
            and np.array_equal(g["teacher_top_k_v"][..., 1],
                               g["input_ids"].astype(np.float16))
            for g in got)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=consume, args=(j,))
                   for j in range(len(streams))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        alive = [t.is_alive() for t in threads]
    finally:
        sys.setswitchinterval(interval)
    svc.close()
    return {"ok": ok, "alive": alive, "in_flight": len(svc)}


def _ranks(rank, world, trees):
    return {"split": disaggregate.split_devices(N_TEACHER),
            "ordering": _ordering(trees),
            "dp2_tp2": _kd(trees, MeshConfig(dp=2), MeshConfig(tp=2),
                           "gpipe"),
            "pp2_1f1b": _kd(trees, MeshConfig(pp=2), MeshConfig(dp=2),
                            "1f1b"),
            "cosyvoice2": _cosyvoice2(trees),
            "stress": _stress()}


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------


def _jax_side():
    import jax
    from speech_distill_tpu.core.config import LoraConfig as JLora
    from speech_distill_tpu.core.config import qwen3_tiny as jtiny
    from speech_distill_tpu.distill.lora import init_lora
    from speech_distill_tpu.models import cosyvoice2 as jcv2
    from speech_distill_tpu.models import qwen3 as jq
    jcfg = jtiny(V, dtype="float32", remat=False)
    params = jq.init_params(jax.random.PRNGKey(0), jcfg)
    teacher = jq.init_params(jax.random.PRNGKey(1), jcfg)
    lora, base = init_lora(jax.random.PRNGKey(2), params, jcfg,
                           JLora(r=4, alpha=8, init_weights="gaussian"))
    cv_cfg = _jax_cv_cfg()
    cv = jcv2.init_params(jax.random.PRNGKey(3), cv_cfg)
    trees = {"base": base, "lora": lora, "teacher": teacher, "cv2": cv}
    return {"cfg": jcfg, "cv_cfg": cv_cfg, **trees,
            "np": {k: jax.tree.map(np.asarray, v) for k, v in trees.items()}}


def _jax_cv_cfg():
    from speech_distill_tpu.core.config import Qwen3Config as JQwen3Config
    from speech_distill_tpu.models import cosyvoice2 as jcv2
    return jcv2.CosyVoice2Config(
        backbone=JQwen3Config(attn_impl="xla", **_cv_backbone_kw()),
        text_vocab_size=CV_TEXT, speech_token_size=CV_SPEECH,
        unified_vocab_size=CV_UNIFIED)


def _jax_ordering(js):
    """JAX's TeacherService (dp 4 over its last 4 devices) and
    pipeline_batches over the same 5 batches."""
    from speech_distill_tpu.core.config import MeshConfig as JMesh
    from speech_distill_tpu.distill import disaggregate as jdg
    from speech_distill_tpu.parallel import mesh as jmesh
    _, t_devs = jdg.split_devices(4)
    svc = jdg.make_teacher_service(
        js["teacher"], js["cfg"], jmesh.make_mesh(JMesh(dp=4),
                                                  devices=t_devs),
        top_k=K, student_vocab_size=V, method="exact", depth=2)
    got = list(jdg.pipeline_batches(iter(_batches(5)), svc))
    return {"v": [np.asarray(g["teacher_top_k_v"][0]) for g in got],
            "i": [np.asarray(g["teacher_top_k_i"][0]) for g in got]}


def _jax_online(js, head_loss):
    """JAX's monolithic online-sparse steps with exact extraction."""
    import jax
    from speech_distill_tpu.core.config import DistillConfig as JD
    from speech_distill_tpu.core.config import LoraConfig as JLora
    from speech_distill_tpu.distill import train_step as jts
    dcfg = JD(top_k=K, online_topk_method="exact",
              lora=JLora(r=4, alpha=8, init_weights="gaussian"))
    opt = jts.make_optimizer(1e-3, 1, 20)
    step = jts.make_kd_step(js["cfg"], dcfg, opt, mode="online_sparse",
                            teacher_cfg=js["cfg"], donate=False,
                            head_loss=head_loss)
    st, losses = jts.init_state(js["lora"], opt), []
    for hb in _batches(3):
        st, m = step(st, js["base"], js["teacher"], hb)
        losses.append(float(m["loss"]))
    return {"loss": losses,
            "trainable": [np.asarray(x) for x in
                          jax.tree.leaves(st.trainable)]}


def _jax_cosyvoice2(js):
    import jax.numpy as jnp
    from speech_distill_tpu.models import cosyvoice2 as jcv2
    fn = jcv2.make_teacher_extract(js["cv_cfg"], CV_K, CV_UNIFIED)
    out = {"v": [], "i": []}
    for b in _cv_batches(js["cv_cfg"]):
        v, i = fn(js["cv2"], jnp.asarray(b["input_ids"][0]),
                  jnp.asarray(b["attention_mask"][0]))
        out["v"].append(np.asarray(v, np.float32))
        out["i"].append(np.asarray(i))
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    js = _jax_side()
    box = {}

    def ranks():
        try:
            box["ranks"] = multihost.launch(
                _ranks, WORLD, js["np"],
                store_dir=str(tmp_path_factory.mktemp("store")),
                device="cpu", timeout_s=400, threads=1)
        except BaseException as e:            # re-raised below
            box["error"] = e
    th = threading.Thread(target=ranks)
    th.start()
    try:
        refs = {"ordering": _jax_ordering(js),
                "fused": _jax_online(js, "fused"),
                "unfused": _jax_online(js, "unfused"),
                "cosyvoice2": _jax_cosyvoice2(js)}
    finally:
        th.join()
    if "error" in box:
        raise box["error"]
    return {"ranks": box["ranks"], "refs": refs}


def _students(run, name):
    res = [r[name] for r in run["ranks"]]
    assert res[N_TEACHER:] == [None] * N_TEACHER     # the teacher ranks
    return res[:WORLD - N_TEACHER]


def test_split_devices_bounds(run):
    """The trailing ranks go to the teacher; 0 < n < world, as in JAX."""
    for r in run["ranks"]:
        assert r["split"] == ([0, 1], [2, 3])
    assert disaggregate.split_devices(1, range(3)) == ([0, 1], [2])
    for n in (0, 3, -1):
        with pytest.raises(ValueError, match="must be in"):
            disaggregate.split_devices(n, range(3))
    with pytest.raises(ValueError):         # one process: no rank to spare
        disaggregate.split_devices(1)


def test_pipeline_batches_ordering_and_alignment(run):
    ref = run["refs"]["ordering"]
    for got in _students(run, "ordering"):
        assert got["n"] == 5 and got["in_flight"] == 0 and got["ids_equal"]
        for v, i, jv, ji in zip(got["v"], got["i"], ref["v"], ref["i"]):
            assert v.dtype == np.float16 and i.dtype == np.int32
            np.testing.assert_array_equal(i, ji)
            np.testing.assert_allclose(v.astype(np.float32),
                                       jv.astype(np.float32), atol=2e-3)


@pytest.mark.parametrize("name,ref", [("dp2_tp2", "fused"),
                                      ("pp2_1f1b", "unfused")])
def test_disaggregated_matches_monolithic_online(run, name, ref):
    """The student at dp 2 (teacher tp 2) against JAX's monolithic step;
    at pp 2 under 1F1B (teacher dp 2) against JAX's with the unfused
    head (the 1F1B head's numerics)."""
    want = run["refs"][ref]
    for got in _students(run, name):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        assert len(got["trainable"]) == len(want["trainable"])
        for a, b in zip(got["trainable"], want["trainable"]):
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-4)


def test_concurrent_streams_get_their_own_extractions(run):
    for got in _students(run, "stress"):
        assert got == {"ok": [True] * 4, "alive": [False] * 4,
                       "in_flight": 0}


def test_cosyvoice2_teacher_through_extract_fn(run):
    ref = run["refs"]["cosyvoice2"]
    for got in _students(run, "cosyvoice2"):
        for v, i, jv, ji in zip(got["v"], got["i"], ref["v"], ref["i"]):
            np.testing.assert_array_equal(np.sort(i, -1), np.sort(ji, -1))
            np.testing.assert_allclose(np.sort(v.astype(np.float32), -1),
                                       np.sort(jv, -1), atol=1e-5,
                                       rtol=1e-5)
