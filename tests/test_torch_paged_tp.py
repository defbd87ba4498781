"""PyTorch port, ``PagedEngine(mesh=)``: 4 gloo ranks (dp 2 x tp 2, one
process each, spawned once for the file through
``parallel/multihost.launch``) serve the cases of ``test_paged_tp.py`` —
greedy tokens equal to JAX's ``PagedEngine(mesh=dp2 x tp2)`` on the 8
virtual devices and to the one-process port, the int8 pool with
preemption — and the shard-local paged attention (each rank's dp rows and
tp heads) against JAX's shard_mapped kernel in interpret mode. Beyond the
JAX cases: a sampled serve (top-k, RAS, per-request overrides, prefix
hits and preemption) whose tokens equal the one-process port's, the
draws made for the global slot batch and sliced.

The children import torch and the port only (JAX is imported lazily, on
the parent's side)."""
import dataclasses
import threading

import numpy as np
import pytest
import torch

from speech_distill_tpu_torch.core.config import (MeshConfig, SamplingParams,
                                                  qwen3_tiny)
from speech_distill_tpu_torch.parallel import multihost

WORLD = 4
VOCAB = 48


def _greedy(max_tokens=6):
    return dict(stop_token_ids=(VOCAB - 1,), max_tokens=max_tokens,
                min_tokens=max_tokens, top_k=1, temperature=1.0,
                use_ras=False, repetition_penalty=1.0)


def _sampled():
    return dict(stop_token_ids=(VOCAB - 1,), max_tokens=20, min_tokens=2,
                top_k=5, top_p=0.9, temperature=0.9, use_ras=True,
                win_size=4, tau_r=0.5, repetition_penalty=1.1)


def _cfg():
    return dataclasses.replace(qwen3_tiny(VOCAB), dtype="float32",
                               remat=False)


def _prompts(seed, n, lo, hi):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, VOCAB - 2, int(rng.integers(lo, hi))).tolist()
            for _ in range(n)]


def _sampled_prompts():
    rng = np.random.default_rng(4)
    common = rng.integers(1, VOCAB - 2, 16).tolist()
    return [common + rng.integers(1, VOCAB - 2, k).tolist()
            for k in (3, 5, 2, 7, 4, 6)]


# (weights seed, sampler, prompts, max_new, engine options)
CASES = {
    "dp2tp2": (3, _greedy(), _prompts(0, 5, 3, 11), 6,
               dict(cache_dtype=torch.float32)),
    "int8_preempt": (5, _greedy(), _prompts(2, 4, 3, 9), 5,
                     dict(cache_dtype=torch.int8, prefix_sharing=False,
                          num_pages=8)),
    "sampled": (7, _sampled(), _sampled_prompts(), 20,
                dict(cache_dtype=torch.float32, slots=4, num_pages=8,
                     per_request_sampling=True, seed=11)),
}
ENGINE = dict(slots=2, max_len=64, page_size=8, chunk_steps=3)
OVERRIDES = [{"temperature": 0.7}, None, {"top_p": 0.5}, None,
             {"repetition_penalty": 1.3}, None]


def _serve(model, cfg, name, device="cpu", mesh=None):
    from speech_distill_tpu_torch.infer.paged import PagedEngine
    seed, sp, prompts, max_new, kw = CASES[name]
    eng = PagedEngine(model, cfg, SamplingParams(**sp), mesh=mesh,
                      device=device, **{**ENGINE, **kw})
    extra = ({"sampling_per_request": OVERRIDES}
             if kw.get("per_request_sampling") else {})
    if name == "sampled":
        # a second serve: the first one's finished streams are prefix hits
        eng.serve(prompts[:2], max_new=max_new,
                  sampling_per_request=OVERRIDES[:2])
    out = eng.serve(prompts, max_new=max_new, **extra)
    return {"tokens": out, "preemptions": eng.preemptions,
            "n_prefills": eng.n_prefills, "prefix_hits": eng.prefix_hits}


def _attention_inputs():
    rng = np.random.default_rng(7)
    B, KV, G, Dh, P, ps, mp = 4, 2, 3, 64, 16, 64, 4
    return dict(
        q=rng.normal(size=(B, KV, G, Dh)).astype(np.float32),
        k=rng.normal(size=(P, KV, ps, Dh)).astype(np.float32),
        v=rng.normal(size=(P, KV, ps, Dh)).astype(np.float32),
        bt=rng.permutation(P)[:B * mp].reshape(B, mp).astype(np.int32),
        lengths=np.asarray([0, ps // 2 + 3, ps, 2 * ps + 17], np.int32))


def _ranks(rank, world):
    """Every case on one rank of the dp 2 x tp 2 mesh."""
    from speech_distill_tpu_torch.models import qwen3
    from speech_distill_tpu_torch.ops.paged_attention import paged_attention
    from speech_distill_tpu_torch.parallel import comm, sharding
    from speech_distill_tpu_torch.parallel import mesh as meshlib
    mesh = meshlib.make_mesh(MeshConfig(dp=2, tp=2), device="cpu")
    cfg = _cfg()
    out = {"coords": mesh.coords}
    for name, case in CASES.items():
        model = sharding.shard_params(mesh, qwen3._numpy_init_tree(
            cfg, case[0]), cfg)
        out[name] = _serve(model, cfg, name, mesh=mesh)
    # the shard-local kernel: this rank's dp rows x tp heads, then the
    # blocks gathered
    x = {k: torch.from_numpy(v) for k, v in _attention_inputs().items()}
    rows, heads = ("dp", None, None, None), (None, "tp", None, None)
    o = paged_attention(
        sharding.shard_leaf(sharding.shard_leaf(x["q"], rows, mesh),
                            heads, mesh),
        sharding.shard_leaf(x["k"], heads, mesh),
        sharding.shard_leaf(x["v"], heads, mesh),
        sharding.shard_leaf(x["bt"], ("dp", None), mesh),
        sharding.shard_leaf(x["lengths"], ("dp",), mesh))
    o = comm.all_gather(o, mesh.group("tp"), dim=1)
    out["attention"] = comm.all_gather(o, mesh.group("dp"), dim=0).numpy()
    return out


def _one_process(name):
    from speech_distill_tpu_torch.models import qwen3
    cfg = _cfg()
    return _serve(qwen3.init_params(cfg, CASES[name][0], device="cpu"), cfg,
                  name)


def _jax_mesh_serve(name):
    import jax
    import jax.numpy as jnp
    from speech_distill_tpu.core.config import MeshConfig as JMesh
    from speech_distill_tpu.core.config import SamplingParams as JSP
    from speech_distill_tpu.core.config import qwen3_tiny as jtiny
    from speech_distill_tpu.infer.paged import PagedEngine
    from speech_distill_tpu.models import qwen3 as jq
    from speech_distill_tpu.parallel import mesh as jmesh
    from speech_distill_tpu.parallel import sharding as jsharding
    seed, sp, prompts, max_new, kw = CASES[name]
    jcfg = jtiny(VOCAB, dtype="float32", remat=False)
    params = jq.init_params(jax.random.PRNGKey(seed), jcfg)
    m = jmesh.make_mesh(JMesh(dp=2, tp=2), devices=jax.devices()[:4])
    kw = {**kw, "cache_dtype": {torch.float32: jnp.float32,
                                torch.int8: jnp.int8}[kw["cache_dtype"]]}
    eng = PagedEngine(jsharding.shard_params(m, params, jcfg), jcfg,
                      JSP(**sp), mesh=m, attn_impl="xla", **ENGINE, **kw)
    return eng.serve(prompts, max_new=max_new)


def _jax_attention():
    """The Pallas kernel shard_mapped over (dp, tp) in interpret mode."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as PS
    from speech_distill_tpu.core.config import MeshConfig as JMesh
    from speech_distill_tpu.ops.paged_attention import paged_attention
    from speech_distill_tpu.parallel import mesh as jmesh
    x = _attention_inputs()
    m = jmesh.make_mesh(JMesh(dp=2, tp=2), devices=jax.devices()[:4])
    fn = jax.shard_map(
        lambda q_, k_, v_, bt_, ln_: paged_attention(q_, k_, v_, bt_, ln_,
                                                     interpret=True),
        mesh=m,
        in_specs=(PS("dp", "tp", None, None), PS(None, "tp", None, None),
                  PS(None, "tp", None, None), PS("dp", None), PS("dp")),
        out_specs=PS("dp", "tp", None, None), check_vma=False)
    return np.asarray(fn(*(jnp.asarray(x[k]) for k in
                           ("q", "k", "v", "bt", "lengths"))))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The 4 ranks (launched in a thread) and, meanwhile, the references:
    JAX's mesh serves and shard_mapped kernel, the one-process port."""
    box = {}

    def ranks():
        try:
            box["ranks"] = multihost.launch(
                _ranks, WORLD, store_dir=str(tmp_path_factory.mktemp(
                    "pgtp")), device="cpu", timeout_s=240, threads=1)
        except BaseException as e:            # re-raised below
            box["error"] = e
    th = threading.Thread(target=ranks)
    th.start()
    try:
        refs = {"one": {name: _one_process(name) for name in CASES},
                "jax": {name: _jax_mesh_serve(name)
                        for name in ("dp2tp2", "int8_preempt")},
                "attention": _jax_attention()}
    finally:
        th.join()
    if "error" in box:
        raise box["error"]
    return {"ranks": box["ranks"], **refs}


def test_ranks_hold_the_dp2_tp2_mesh(run):
    assert sorted((r["coords"]["dp"], r["coords"]["tp"])
                  for r in run["ranks"]) == [(0, 0), (0, 1), (1, 0), (1, 1)]


@pytest.mark.parametrize("name", ["dp2tp2", "int8_preempt"])
def test_paged_serve_mesh_matches_jax_and_one_process(run, name):
    """``test_paged_tp.py``'s two serves: every rank returns the tokens
    of JAX's dp 2 x tp 2 engine and of the one-process port."""
    ref, one = run["jax"][name], run["one"][name]
    assert one["tokens"] == ref
    for r in run["ranks"]:
        assert r[name]["tokens"] == ref
        assert r[name]["preemptions"] == one["preemptions"]
    if name == "int8_preempt":
        assert run["ranks"][0][name]["preemptions"] > 0 \
            or run["ranks"][0][name]["n_prefills"] >= 4


def test_sampled_serve_matches_one_process(run):
    """Top-k, RAS and per-request overrides over dp-sharded slots: the
    draws are the global batch's, so every rank samples the one-process
    port's tokens, through prefix hits and preemption."""
    one = run["one"]["sampled"]
    assert one["prefix_hits"] > 0 and one["preemptions"] > 0
    for r in run["ranks"]:
        assert r["sampled"] == one


def test_shard_local_attention_matches_jax_shard_map(run):
    """Each rank's dp rows x tp heads through the port's paged attention
    (the plain version on CPU tensors, K4 on the card), gathered, against
    the Pallas kernel shard_mapped over (dp, tp) in interpret mode
    (``test_paged_tp.py::test_shard_mapped_kernel_matches_oracle``)."""
    for r in run["ranks"]:
        np.testing.assert_allclose(r["attention"], run["attention"],
                                   atol=2e-5, rtol=1e-4)
