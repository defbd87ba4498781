"""PyTorch port, the parallel layer's host-side rules against the JAX
package's: the mesh shape arithmetic (``parallel/mesh.mesh_shape``)
against JAX ``make_mesh`` over the 8 virtual CPU devices of
``tests/conftest.py``; every leaf's slice under ``param_pspecs``,
``lora_pspecs`` and ZeRO-1's widened specs against JAX's
``NamedSharding`` index maps, rank by rank; ``shard_params``'s local
model; ``initialize`` as a no-op for one process; ``local_batch_size``
and ``make_global_batch`` against ``test_multihost.py``'s and JAX's
``shard_batch``; the host split of ``shuffled_stream``. No process group
is started here: a rank's view is a ``Mesh`` with its coordinates."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from speech_distill_tpu.core.config import LoraConfig as JLoraConfig
from speech_distill_tpu.core.config import MeshConfig as JMeshConfig
from speech_distill_tpu.core.config import qwen3_tiny as jtiny
from speech_distill_tpu.core import trainer as jtrainer
from speech_distill_tpu.distill.lora import init_lora as jinit_lora
from speech_distill_tpu.models import qwen3 as jqwen3
from speech_distill_tpu.parallel import mesh as jmesh
from speech_distill_tpu.parallel import sharding as jsharding
from speech_distill_tpu_torch.core import trainer as ttrainer
from speech_distill_tpu_torch.core.config import MeshConfig, qwen3_tiny
from speech_distill_tpu_torch.core.tree import tree_leaves
from speech_distill_tpu_torch.models import qwen3
from speech_distill_tpu_torch.models.convert import model_to_tree
from speech_distill_tpu_torch.parallel import mesh as meshlib
from speech_distill_tpu_torch.parallel import multihost, sharding

needs8 = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")

LAYOUTS = [dict(dp=-1, tp=2), dict(), dict(sp=2, tp=2), dict(pp=2, tp=2)]


@needs8
@pytest.mark.parametrize("kw", LAYOUTS, ids=["dp4tp2", "dp8", "sp2tp2",
                                             "pp2tp2"])
def test_mesh_shape_matches_jax(kw):
    """The four layouts of ``test_sharding.py::test_mesh_construction``,
    pp and sp included, as shapes."""
    ref = dict(jmesh.make_mesh(JMeshConfig(**kw)).shape)
    assert meshlib.mesh_shape(MeshConfig(**kw), 8) == ref


@needs8
@pytest.mark.parametrize("kw", [dict(dp=3, tp=2), dict(sp=3), dict(pp=3)])
def test_mesh_shape_errors_match_jax(kw):
    with pytest.raises(ValueError):
        jmesh.make_mesh(JMeshConfig(**kw))
    with pytest.raises(ValueError):
        meshlib.mesh_shape(MeshConfig(**kw), 8)


@pytest.mark.parametrize("kw", [dict(sp=2), dict(pp=2)])
def test_make_mesh_raises_for_sp_and_pp(kw, monkeypatch):
    """One process asking for 2 ranks raises the arithmetic's
    ``ValueError``; on a world of two (faked, with the device mesh
    stubbed) ``make_mesh`` builds the sp or pp axis like any other, with
    JAX's shape (the real groups: ``tests/test_torch_ring_attention.py``,
    ``tests/test_torch_pipeline.py``)."""
    import torch.distributed as dist
    import torch.distributed.device_mesh as dm
    with pytest.raises(ValueError):          # one process: 2 ranks asked
        meshlib.make_mesh(MeshConfig(**kw), device="cpu")
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    made = {}

    class FakeDeviceMesh:
        def __init__(self, device_type, shape, mesh_dim_names):
            made.update(type=device_type, shape=shape, names=mesh_dim_names)

        def get_local_rank(self, axis):
            return 0
    monkeypatch.setattr(dm, "init_device_mesh", FakeDeviceMesh)
    mesh = meshlib.make_mesh(MeshConfig(**kw), device="cpu")
    axis = next(iter(kw))
    want = jmesh.make_mesh(JMeshConfig(**kw), devices=jax.devices()[:2])
    assert mesh.shape == {a: int(want.shape[a]) for a in meshlib.AXES}
    assert made == {"type": "cpu", "names": meshlib.AXES,
                    "shape": tuple(mesh.shape[a] for a in meshlib.AXES)}
    assert getattr(mesh, axis) == 2 and mesh.world == 2


def _jax_mesh(dp, tp):
    return jmesh.make_mesh(JMeshConfig(dp=dp, tp=tp),
                           devices=jax.devices()[:dp * tp])


def _coords(jm):
    """{device id: its (dp, pp, sp, tp) coordinates} of a JAX mesh."""
    out = {}
    for idx in np.ndindex(jm.devices.shape):
        out[jm.devices[idx].id] = dict(zip(jm.axis_names, idx))
    return out


def _norm(sl, n):
    return slice(sl.start or 0, n if sl.stop is None else sl.stop)


def _canon(spec):
    """A spec as JAX's ``PartitionSpec`` canonicalises it: a one-axis
    tuple is the axis."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _check_specs(jm, jspecs, tspecs, shapes):
    """Each leaf's spec equals JAX's, and every rank's slice equals the
    device's index in JAX's ``NamedSharding``."""
    coords = _coords(jm)
    mshape = dict(jm.shape)
    n = 0
    for js, ts, shape in zip(jax.tree.leaves(jspecs, is_leaf=lambda x:
                                             isinstance(x, P)),
                             tspecs if isinstance(tspecs, list)
                             else tree_leaves(tspecs), shapes):
        assert _canon(js) == _canon(ts)
        index = NamedSharding(jm, js).devices_indices_map(shape)
        for dev, idx in index.items():
            got = sharding.shard_slices(ts, shape, mshape, coords[dev.id])
            want = tuple(_norm(s, d) for s, d in zip(idx, shape))
            assert got == want, (ts, shape, coords[dev.id])
            n += 1
    assert n


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32", remat=False)


def _jf32(cfg):
    return type(cfg)(**{**cfg.__dict__, "dtype": "float32",
                        "remat": False})


@needs8
@pytest.mark.parametrize("dp,tp", [(4, 2), (2, 4), (1, 8)])
@pytest.mark.parametrize("family", ["qwen3", "qwen2"])
def test_param_slices_match_jax(dp, tp, family):
    kw = dict(attention_bias=True, qk_norm=False) if family == "qwen2" \
        else {}
    jcfg = _jf32(jtiny(128, **kw))
    tcfg = _f32(qwen3_tiny(128, **kw))
    params = jqwen3.init_params(jax.random.PRNGKey(0), jcfg)
    shapes = [x.shape for x in jax.tree.leaves(params)]
    _check_specs(_jax_mesh(dp, tp), jqwen3.param_pspecs(jcfg),
                 qwen3.param_pspecs(tcfg), shapes)


@needs8
@pytest.mark.parametrize("dp,tp", [(4, 2), (2, 4)])
def test_lora_slices_match_jax(dp, tp):
    jcfg = _jf32(jtiny(128))
    params = jqwen3.init_params(jax.random.PRNGKey(0), jcfg)
    lora, _ = jinit_lora(jax.random.PRNGKey(2), params, jcfg,
                         JLoraConfig(r=4, alpha=8, init_weights="gaussian"))
    shapes = [x.shape for x in jax.tree.leaves(lora)]
    tl = jax.tree.map(lambda x: torch.from_numpy(np.asarray(x)), lora)
    _check_specs(_jax_mesh(dp, tp), jsharding.lora_pspecs(lora),
                 sharding.lora_pspecs(tl), shapes)


@needs8
@pytest.mark.parametrize("dp,tp", [(4, 2), (2, 4), (8, 1)])
def test_zero1_slices_match_jax(dp, tp):
    """ZeRO-1's widened moment specs (leading axes over dp, the vocab
    over (tp, dp)) and their slices, leaf by leaf; and ``zero1_slice``
    of each rank's tp slice is its slice of the global leaf."""
    jcfg = _jf32(jtiny(128))
    jm = _jax_mesh(dp, tp)
    params = jqwen3.init_params(jax.random.PRNGKey(0), jcfg)
    lora, _ = jinit_lora(jax.random.PRNGKey(2), params, jcfg,
                         JLoraConfig(r=4, alpha=8, init_weights="gaussian"))
    leaves = jax.tree.leaves(lora)
    jspecs = [jsharding._zero1_widen(s, x.shape, jm) for s, x in zip(
        jax.tree.leaves(jsharding.lora_pspecs(lora),
                        is_leaf=lambda x: isinstance(x, P)), leaves)]
    tl = jax.tree.map(lambda x: torch.from_numpy(np.asarray(x)), lora)
    mshape = dict(jm.shape)
    tspecs = [sharding._zero1_widen(s, tuple(x.shape), mshape)
              for s, x in zip(tree_leaves(sharding.lora_pspecs(tl)),
                              tree_leaves(tl))]
    _check_specs(jm, jspecs, tspecs, [x.shape for x in leaves])
    assert any(isinstance(s[0], tuple) for s in tspecs)
    coords = _coords(jm)
    for x, spec, wide in zip(tree_leaves(tl),
                             tree_leaves(sharding.lora_pspecs(tl)), tspecs):
        for c in coords.values():
            m = meshlib.Mesh(mshape, c, torch.device("cpu"))
            local = sharding.shard_leaf(x, spec, m)
            z = sharding.zero1_slice(local, spec, m)
            want = sharding.shard_leaf(x, wide, m)
            torch.testing.assert_close(local if z is None else z, want,
                                       rtol=0, atol=0)


@pytest.mark.parametrize("family", ["qwen3", "qwen2"])
def test_shard_params_holds_each_rank_slice(family):
    """The local model of ``shard_params`` holds exactly each leaf's
    slice under ``param_pspecs``, under the global config."""
    kw = dict(attention_bias=True, qk_norm=False) if family == "qwen2" \
        else {}
    cfg = _f32(qwen3_tiny(128, **kw))
    tp = 2
    tree = qwen3._numpy_init_tree(cfg, 3)
    specs = qwen3.param_pspecs(cfg)
    shape = {"dp": 1, "pp": 1, "sp": 1, "tp": tp}
    for r in range(tp):
        m = meshlib.Mesh(shape, {**shape, "dp": 0, "pp": 0, "sp": 0,
                                 "tp": r}, torch.device("cpu"))
        model = sharding.shard_params(m, tree, cfg)
        assert model.cfg is cfg and model.mesh is m
        got = tree_leaves(model_to_tree(model))
        want = tree_leaves(sharding.slice_tree(tree, specs, m))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)


def test_shard_params_replicates_a_quantized_model():
    from speech_distill_tpu_torch.models.convert import params_from_jax
    from speech_distill_tpu_torch.ops.quant import quantize_params
    cfg = _f32(qwen3_tiny(128))
    from speech_distill_tpu_torch.core.tree import tree_map
    q = quantize_params(tree_map(torch.from_numpy,
                                 qwen3._numpy_init_tree(cfg, 3)), bits=8)
    model = params_from_jax(q, cfg, "cpu")
    shape = {"dp": 1, "pp": 1, "sp": 1, "tp": 2}
    m = meshlib.Mesh(shape, {**shape, "tp": 1, "dp": 0},
                     torch.device("cpu"))
    assert sharding.shard_params(m, model, cfg) is model
    assert model.mesh is None


def test_local_config_divides_the_sharded_dims():
    cfg = qwen3_tiny(128)
    loc = sharding.local_config(cfg, 2)
    assert (loc.num_attention_heads, loc.num_key_value_heads,
            loc.intermediate_size, loc.vocab_size) == (
        cfg.num_attention_heads // 2, cfg.num_key_value_heads // 2,
        cfg.intermediate_size // 2, cfg.vocab_size // 2)
    with pytest.raises(ValueError, match="divisible"):
        sharding.local_config(cfg, 3)


@pytest.mark.parametrize("use_lora", [True, False], ids=["lora", "full"])
def test_tp_partial_leaves(use_lora):
    """The leaves whole on every tp rank whose gradients the ranks hold
    in part: LoRA's A of q/k/v/gate/up and B of o/down; the q/k norms of
    full finetuning."""
    from speech_distill_tpu_torch.core.config import LoraConfig
    from speech_distill_tpu_torch.distill import train_step
    from speech_distill_tpu_torch.distill.lora import init_lora
    cfg = _f32(qwen3_tiny(128))
    model = qwen3.init_params(cfg, 0, device="cpu")
    if use_lora:
        tr, _ = init_lora(model, cfg, LoraConfig(r=4, alpha=8,
                                                 init_weights="gaussian"),
                          torch.Generator().manual_seed(0), device="cpu")
        part = sharding.tp_partial(tr)
        lay = part["layers"]
        assert lay["attn"]["q"] == {"a": True, "b": False}
        assert lay["attn"]["o"] == {"a": False, "b": True}
        assert lay["mlp"]["down"] == {"a": False, "b": True}
        assert part["embed"]["weight"] is False
    else:
        tr = train_step.full_trainable(model)
        part = sharding.tp_partial(tr, use_lora=False)
        assert part["layers"]["attn"]["q_norm"] is True
        assert part["layers"]["attn"]["q"] is False
        assert part["layers"]["input_ln"]["scale"] is False


def test_initialize_noop_single_process(monkeypatch):
    for v in ("SDT_COORDINATOR", "SDT_NUM_PROCESSES", "SDT_PROCESS_ID",
              "WORLD_SIZE", "RANK", "MASTER_ADDR"):
        monkeypatch.delenv(v, raising=False)
    assert multihost.initialize(None, None, None) is False
    assert multihost.initialize(None, 1, 0) is False
    assert multihost.process_count() == 1 and multihost.is_primary()


def test_initialize_needs_every_part(monkeypatch):
    monkeypatch.delenv("SDT_PROCESS_ID", raising=False)
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(ValueError, match="process"):
        multihost.initialize("localhost:1", 2, None, device="cpu")


def test_local_batch_size():
    from speech_distill_tpu.parallel import multihost as jmh
    assert multihost.local_batch_size(8) == jmh.local_batch_size(8) == 8
    m = meshlib.Mesh({"dp": 2, "pp": 1, "sp": 1, "tp": 2},
                     {"dp": 1, "pp": 0, "sp": 0, "tp": 0},
                     torch.device("cpu"))
    assert multihost.local_batch_size(8, m) == 4
    with pytest.raises(ValueError, match="divisible"):
        multihost.local_batch_size(7, m)


@needs8
@pytest.mark.parametrize("microbatched", [True, False])
def test_make_global_batch_matches_shard_batch(microbatched):
    """Each rank's rows are JAX ``shard_batch``'s shard on its device
    (dp 4 x tp 2), for the [A, B, T] and the [B, T] batch."""
    jm = _jax_mesh(4, 2)
    rng = np.random.default_rng(0)
    shape = (2, 8, 16) if microbatched else (8, 16)
    batch = {"input_ids": rng.integers(0, 100, shape).astype(np.int32),
             "attention_mask": np.ones(shape, np.int32)}
    ref = jsharding.shard_batch(jm, batch, microbatched=microbatched)
    coords = _coords(jm)
    for k in batch:
        for shard in ref[k].addressable_shards:
            m = meshlib.Mesh(dict(jm.shape), coords[shard.device.id],
                             torch.device("cpu"))
            got = multihost.make_global_batch(m, batch, microbatched)
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(shard.data))


def test_fetch_replicated_single_process_passthrough():
    tree = {"w": torch.arange(8.0), "b": torch.ones(2, 2)}
    out = multihost.fetch_replicated(tree)
    np.testing.assert_array_equal(out["w"].numpy(), np.arange(8.0))
    np.testing.assert_array_equal(out["b"].numpy(), np.ones((2, 2)))


def test_put_batch_and_replicate():
    """``put_batch``: a rank's dp rows of the leading dim; ``replicate``:
    every leaf whole on the rank's device."""
    m = meshlib.Mesh({"dp": 2, "pp": 1, "sp": 1, "tp": 2},
                     {"dp": 1, "pp": 0, "sp": 0, "tp": 1},
                     torch.device("cpu"))
    x = np.arange(24).reshape(4, 6)
    assert meshlib.batch_sharding(m) == ("dp",) and meshlib.replicated(m) == ()
    np.testing.assert_array_equal(meshlib.put_batch(m, {"x": x})["x"].numpy(),
                                  x[2:])
    np.testing.assert_array_equal(sharding.replicate(m, {"x": x})["x"]
                                  .numpy(), x)


@pytest.mark.parametrize("buffer", [None, 5])
@pytest.mark.parametrize("hosts", [(2, 0), (2, 1), (3, 2)])
def test_shuffled_stream_host_split_matches_jax(buffer, hosts):
    items = list(range(23))
    ref = list(jtrainer.shuffled_stream(items, 7, 1, buffer, *hosts))
    got = list(ttrainer.shuffled_stream(items, 7, 1, buffer, *hosts))
    assert got == ref and set(got) == set(items[hosts[1]::hosts[0]])


def test_row_draws_slice_the_global_draw():
    from speech_distill_tpu_torch.ops.sampling import RowDraws, categorical
    logits = torch.randn(6, 11)
    full = categorical(torch.Generator().manual_seed(3), logits)
    rows = [categorical(RowDraws(torch.Generator().manual_seed(3), 6, r0),
                        logits[r0:r0 + 3]) for r0 in (0, 3)]
    assert torch.equal(torch.cat(rows), full)


def test_state_pspecs_widen_only_the_moments():
    from speech_distill_tpu_torch.core.config import LoraConfig
    from speech_distill_tpu_torch.distill import train_step
    from speech_distill_tpu_torch.distill.lora import init_lora
    cfg = _f32(qwen3_tiny(128))
    tr, _ = init_lora(qwen3.init_params(cfg, 0, device="cpu"), cfg,
                      LoraConfig(r=4, alpha=8, init_weights="gaussian"),
                      torch.Generator().manual_seed(0), device="cpu")
    opt = train_step.make_optimizer(1e-3, 1, 20)
    st = train_step.init_state(tr, opt)
    m = meshlib.Mesh({"dp": 2, "pp": 1, "sp": 1, "tp": 1},
                     {"dp": 1, "pp": 0, "sp": 0, "tp": 0},
                     torch.device("cpu"))
    specs = sharding.lora_pspecs(tr)
    sp = sharding.state_pspecs(st, specs, m, zero1=True)
    assert sp.trainable is specs and sp.step is None
    assert sp.opt_state["count"] is None
    assert sp.opt_state["mu"]["embed"]["weight"] == (("tp", "dp"), None)
    assert sp.opt_state["nu"]["layers"]["attn"]["q"]["a"] == (
        ("dp",), None, None)
    z = sharding.shard_opt_state(m, st.opt_state, specs, zero1=True)
    assert z["mu"]["embed"]["weight"].shape[0] == \
        tr["embed"]["weight"].shape[0] // 2
    assert z["count"] == 0


def test_eight_bit_state_takes_no_tp_or_zero1():
    from speech_distill_tpu_torch.distill import train_step
    tr = {"w": torch.zeros(8, 4, requires_grad=True)}
    st = train_step.make_optimizer(1e-3, 1, 20, eight_bit=True).init(tr)
    m = meshlib.Mesh({"dp": 2, "pp": 1, "sp": 1, "tp": 1},
                     {"dp": 0, "pp": 0, "sp": 0, "tp": 0},
                     torch.device("cpu"))
    assert sharding.shard_opt_state(m, st, {"w": (None, None)}) is st
    with pytest.raises(ValueError, match="8-bit"):
        sharding.shard_opt_state(m, st, {"w": (None, None)}, zero1=True)
