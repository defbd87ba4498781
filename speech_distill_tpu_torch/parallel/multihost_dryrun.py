"""Multi-process dry run: n processes of d ranks each prove the full KD
step equals one process's, a checkpoint round trip and ``train_loop``
over the mesh (port of ``speech_distill_tpu/parallel/multihost_dryrun.py``).

JAX runs one process a host over d virtual CPU devices and lets dp cross
the processes. The port runs one process a device, so n x d ranks are
spawned (``multihost.launch``) onto the mesh dp=n, sp=d // 2, tp=2: dp
across the "hosts", sp and tp within one. Each rank checks

  * the online-sparse KD step with ``attn_impl="ring"`` on the mesh
    against the same step in one process (loss rtol 1e-5; trainable
    leaves atol 1e-5, rtol 1e-4);
  * a checkpoint save and restore over the mesh, bit-equal;
  * ``train_loop`` for 3 steps with ``save_steps=2``, the primary writing
    ``metrics.jsonl``;

and prints the ``MULTIHOST_OK`` line. Usage:

  python -m speech_distill_tpu_torch.parallel.multihost_dryrun [n] [d]

(default 2 processes x 4 ranks, rank r on card r: ``launch(n, d,
device=...)`` puts every rank on one device, ``"cpu"`` in the tests;
ranks sharing a card need ``backend="gloo"``.)
"""
from __future__ import annotations

import dataclasses
import os
import sys
import tempfile
from typing import Optional

OK_MARK = "MULTIHOST_OK"


def _worker(rank: int, world: int, n_processes: int, local_devices: int,
            ckpt_dir: str, device: Optional[str]) -> str:
    import numpy as np
    import torch

    from speech_distill_tpu_torch.core.checkpoint import CheckpointManager
    from speech_distill_tpu_torch.core.config import (DistillConfig,
                                                      LoraConfig, MeshConfig,
                                                      qwen3_tiny)
    from speech_distill_tpu_torch.core.tree import tree_leaves, tree_map
    from speech_distill_tpu_torch.core.trainer import LoopConfig, train_loop
    from speech_distill_tpu_torch.distill import train_step
    from speech_distill_tpu_torch.distill.lora import init_lora
    from speech_distill_tpu_torch.models import qwen3
    from speech_distill_tpu_torch.parallel import mesh as meshlib
    from speech_distill_tpu_torch.parallel import multihost, sharding

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = meshlib.make_mesh(MeshConfig(dp=n_processes,
                                        sp=local_devices // 2, tp=2),
                             device=device)
    dev = mesh.device
    cfg = dataclasses.replace(qwen3_tiny(128), dtype="float32", remat=False)
    base = qwen3.init_params(cfg, seed=0, device=dev)
    teacher = qwen3.init_params(cfg, seed=1, device=dev)
    dcfg = DistillConfig(top_k=8, online_topk_method="exact",
                         lora=LoraConfig(r=4, alpha=8,
                                         init_weights="gaussian"))
    lora, base = init_lora(base, cfg, dcfg.lora,
                           torch.Generator().manual_seed(2), device=dev)
    opt = train_step.make_optimizer(1e-3, 1, 20)

    def copy(tree):
        return tree_map(lambda x: x.detach().clone().requires_grad_(True),
                        tree)

    rng = np.random.default_rng(0)
    A, B, T = 2, 8, 32

    def draw(r):
        return {"input_ids": r.integers(0, 128, (A, B, T)),
                "attention_mask": np.ones((A, B, T), np.int64),
                "labels": r.integers(0, 128, (A, B, T))}
    full = draw(rng)

    # one process: the same step on this rank's device, no mesh
    step = train_step.make_kd_step(cfg, dcfg, opt, mode="online_sparse",
                                   donate=False, device=dev)
    s0, m0 = step(train_step.init_state(copy(lora), opt), base, teacher,
                  full)
    loss0 = float(m0["loss"])

    # the mesh: dp across the processes, sp x tp within one
    cfg_r = dataclasses.replace(cfg, attn_impl="ring")
    base_s = sharding.shard_params(mesh, base, cfg_r)
    teacher_s = sharding.shard_params(mesh, teacher, cfg_r)
    lora_s = sharding.shard_lora(mesh, copy(lora), cfg_r)
    specs = sharding.trainable_pspecs(lora_s, cfg_r, True, mesh)

    def fresh_state():
        st = train_step.init_state(lora_s, opt)
        return st._replace(opt_state=sharding.shard_opt_state(
            mesh, st.opt_state, specs))
    step_r = train_step.make_kd_step(cfg_r, dcfg, opt, mode="online_sparse",
                                     donate=False, device=dev, mesh=mesh)
    st, m1 = step_r(fresh_state(), base_s, teacher_s,
                    multihost.make_global_batch(mesh, full))
    loss1 = float(m1["loss"])
    np.testing.assert_allclose(loss1, loss0, rtol=1e-5)
    whole = multihost.fetch_replicated(st.trainable, specs, mesh)
    for a, b in zip(tree_leaves(s0.trainable), tree_leaves(whole)):
        np.testing.assert_allclose(b.cpu().numpy(),
                                   a.detach().cpu().numpy(), atol=1e-5,
                                   rtol=1e-4)

    # a checkpoint over the mesh: gathered to rank 0, cut on restore
    def state_specs(s):
        return sharding.state_pspecs(s, specs, mesh)
    mgr = CheckpointManager(os.path.join(ckpt_dir, "ckpt"), max_to_keep=2,
                            mesh=mesh, specs_fn=state_specs)
    mgr.save(1, st)
    restored = mgr.restore(st, 1)
    for a, b in zip(tree_leaves(st.trainable),
                    tree_leaves(restored.trainable)):
        if not torch.equal(a.detach(), b.detach()):
            raise AssertionError("the restored state differs")
    mgr.close()

    # train_loop over the mesh: every rank streams the global batches and
    # keeps its dp rows, the primary writes the metrics
    out_dir = os.path.join(ckpt_dir, "loop")

    def batch_iter(epoch):
        for s in range(3):
            yield draw(np.random.default_rng(100 + s))
    final = train_loop(
        step_r, fresh_state(), (base_s, teacher_s), batch_iter,
        LoopConfig(num_epochs=1, max_steps=3, logging_steps=1,
                   save_steps=2, output_dir=out_dir,
                   load_best_at_end=False),
        device=dev, mesh=mesh, state_specs=state_specs)
    if final.step != 3:
        raise AssertionError(f"train_loop ended at step {final.step}")
    if mesh.is_primary and not os.path.exists(
            os.path.join(out_dir, "metrics.jsonl")):
        raise AssertionError("the primary wrote no metrics.jsonl")
    multihost.barrier(mesh)
    line = (f"{OK_MARK} rank={rank}/{world} mesh={mesh.shape} "
            f"coords={mesh.coords} loss single={loss0:.6f} "
            f"multihost={loss1:.6f} ckpt=ok")
    print(line, flush=True)
    return line


def launch(n_processes: int = 2, local_devices: int = 4, device=None,
           backend: Optional[str] = None, timeout_s: float = 900) -> list:
    """Spawn the n x d ranks (``multihost.launch``: rank r on card r, or
    every rank on ``device``) and check every one reports OK; returns
    their lines."""
    from speech_distill_tpu_torch.parallel import multihost
    world = n_processes * local_devices
    with tempfile.TemporaryDirectory(prefix="sdt_mh_") as d:
        ckpt = os.path.join(d, "shared")
        os.makedirs(ckpt)
        lines = multihost.launch(_worker, world, n_processes, local_devices,
                                 ckpt, device, store_dir=d, device=device,
                                 backend=backend, timeout_s=timeout_s,
                                 threads=1 if device == "cpu" else None)
    missing = [r for r, line in enumerate(lines) if OK_MARK not in line]
    if missing:
        raise RuntimeError(f"multihost dry run: ranks {missing} did not "
                           f"report {OK_MARK}")
    print(f"dryrun_multihost ok: {n_processes} processes x "
          f"{local_devices} ranks", flush=True)
    return lines


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    n = int(argv[0]) if argv else 2
    d = int(argv[1]) if len(argv) > 1 else 4
    launch(n, d)


if __name__ == "__main__":
    main()
