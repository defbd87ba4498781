"""PyTorch port, the native serving runtime (C++ allocator and prefix
trie over ctypes) against the port's Python twins: a seeded differential
run of every operation, serves with either runtime against each other and
against the JAX engine, and builds by two processes at once. The build
needs g++; these tests fail, not skip, when it does not build."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from speech_distill_tpu.core.config import SamplingParams as JaxSP
from speech_distill_tpu.core.config import qwen3_tiny as jax_tiny
from speech_distill_tpu.infer import paged as jpaged
from speech_distill_tpu.models import qwen3 as jq
from speech_distill_tpu_torch.core.config import SamplingParams, qwen3_tiny
from speech_distill_tpu_torch.infer import paged as tpaged
from speech_distill_tpu_torch.models.convert import params_from_jax
from speech_distill_tpu_torch.native import serving

ROOT = Path(__file__).resolve().parents[1]


def test_runtime_builds_and_loads():
    assert serving.available(), serving.unavailable_reason()
    assert serving.lib_path().exists()


def test_pool_differential():
    """500 seeded alloc / free / share operations: returned pages, free
    counts and every refcount agree after each one."""
    rng = np.random.default_rng(0)
    py, nat = tpaged.PagePool(24), serving.NativePagePool(24)
    held = []
    for step in range(500):
        op = rng.integers(0, 3)
        if op == 0:
            n = int(rng.integers(1, 6))
            a, b = py.alloc(n), nat.alloc(n)
            assert a == b, f"step {step}: alloc {a} != {b}"
            if a is not None:
                held.append(list(a))
        elif op == 1 and held:
            pages = held.pop(int(rng.integers(0, len(held))))
            py.free(pages)
            nat.free(pages)
        elif op == 2 and held:
            pages = held[int(rng.integers(0, len(held)))]
            py.share(pages)
            nat.share(pages)
            held.append(list(pages))
        assert py.free_pages == nat.free_pages, f"step {step}"
        assert [py.refcount(p) for p in range(24)] == \
            [nat.refcount(p) for p in range(24)], f"step {step}"


def test_registry_differential():
    """500 seeded match / register / evict / alloc-with-eviction
    operations over prompts with heavy shared prefixes."""
    rng = np.random.default_rng(1)
    ps = 4
    py_pool, nat_pool = tpaged.PagePool(64), serving.NativePagePool(64)
    py_reg, nat_reg = tpaged.PrefixRegistry(), serving.NativePrefixRegistry()
    base = rng.integers(0, 9, 16).tolist()
    prompts = [base[:int(rng.integers(4, 17))]
               + rng.integers(0, 9, int(rng.integers(0, 13))).tolist()
               for _ in range(12)]
    for step in range(500):
        op = rng.integers(0, 4)
        ids = prompts[int(rng.integers(0, len(prompts)))]
        if op == 0:
            mp = int(rng.integers(1, 8))
            assert py_reg.match(ids, ps, mp) == nat_reg.match(ids, ps, mp), \
                f"step {step}"
        elif op == 1 and len(ids) >= ps:
            a = py_pool.alloc(len(ids) // ps)
            b = nat_pool.alloc(len(ids) // ps)
            assert a == b, f"step {step}"
            if a is not None:
                py_reg.register(ids, a, ps, py_pool)
                nat_reg.register(ids, b, ps, nat_pool)
                # the stream drops its own reference, as serve() does
                py_pool.free(a)
                nat_pool.free(b)
        elif op == 2:
            assert py_reg.evict_one(py_pool) == nat_reg.evict_one(nat_pool)
        elif op == 3:
            n = int(rng.integers(1, 10))
            a, b = py_reg.alloc(py_pool, n), nat_reg.alloc(nat_pool, n)
            assert a == b, f"step {step}"
            if a is not None:
                py_pool.free(a)
                nat_pool.free(b)
        assert py_pool.free_pages == nat_pool.free_pages, f"step {step}"
    assert len(nat_reg) > 0


def test_serve_native_equals_python_runtime_and_jax():
    """Prefix hits, preemption and a second call over the persistent
    registry: the native runtime, the Python twins and the JAX engine give
    the same tokens and counters."""
    V = 48
    jcfg = jax_tiny(V, dtype="float32", remat=False)
    params = jq.init_params(jax.random.PRNGKey(3), jcfg)
    cfg = qwen3_tiny(V, dtype="float32")
    model = params_from_jax(jax.tree.map(np.asarray, params), cfg, "cpu")
    greedy = dict(stop_token_ids=(V - 1,), max_tokens=6, min_tokens=6,
                  top_k=1, temperature=1.0, use_ras=False,
                  repetition_penalty=1.0)
    rng = np.random.default_rng(0)
    common = rng.integers(1, V - 2, 8).tolist()
    prompts = [common + rng.integers(1, V - 2,
                                     int(rng.integers(3, 11))).tolist()
               for _ in range(6)]
    kw = dict(slots=2, max_len=64, page_size=8, chunk_steps=3, num_pages=12,
              prefill_chunk=8)
    engines = {rt: tpaged.PagedEngine(model, cfg, SamplingParams(**greedy),
                                      device="cpu", native_runtime=rt, **kw)
               for rt in (True, False)}
    jeng = jpaged.PagedEngine(params, jcfg, JaxSP(**greedy),
                              cache_dtype=jnp.float32, attn_impl="xla",
                              native_runtime=False, **kw)
    for batch, max_new in ((prompts, 6), (prompts[:3], 4)):
        ref = jeng.serve(batch, max_new=max_new)
        for eng in engines.values():
            assert eng.serve(batch, max_new=max_new) == ref
            assert (eng.prefix_hits, eng.prefix_hit_tokens,
                    eng.preemptions, eng.n_prefill_chunks) == \
                (jeng.prefix_hits, jeng.prefix_hit_tokens,
                 jeng.preemptions, jeng.n_prefill_chunks)
    assert engines[True].runtime == "native"
    assert engines[False].runtime == "python"
    assert engines[True].prefix_hits > 0


def test_native_off_switch(monkeypatch):
    """SDT_NATIVE=0 makes the default the Python twins and a demand for
    the native runtime an error."""
    monkeypatch.setenv("SDT_NATIVE", "0")
    cfg = qwen3_tiny(32, dtype="float32")
    from speech_distill_tpu_torch.models import qwen3
    model = qwen3.init_params(cfg, seed=0, device="cpu")
    sp = SamplingParams(top_k=1, stop_token_ids=(31,))
    kw = dict(slots=2, max_len=32, page_size=8, device="cpu")
    eng = tpaged.PagedEngine(model, cfg, sp, **kw)
    eng.serve([[1, 2, 3]], max_new=2)
    assert eng.runtime == "python"
    monkeypatch.setattr(serving, "_lib", None)
    monkeypatch.setattr(serving, "_error", None)
    with pytest.raises(RuntimeError, match="SDT_NATIVE=0"):
        tpaged.PagedEngine(model, cfg, sp, native_runtime=True,
                           **kw).serve([[1, 2, 3]], max_new=2)


BUILD_AND_LOAD = """
import sys
from speech_distill_tpu_torch.native import serving
lib = serving.load(sys.argv[1])
h = lib.sdt_pool_new(3)
assert lib.sdt_pool_free_pages(h) == 3
print(serving.lib_path(sys.argv[1]))
"""


def test_concurrent_builds_into_one_fresh_directory(tmp_path):
    """Two processes build the runtime into one empty directory at once;
    both load a whole library and no temporary file is left behind."""
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_AND_LOAD,
                               str(tmp_path)], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    assert {out.strip() for out, _ in outs} == \
        {str(serving.lib_path(tmp_path))}
    assert [f.name for f in tmp_path.iterdir()] == \
        [serving.lib_path(tmp_path).name]
