"""The device mesh of the port (port of ``speech_distill_tpu/parallel/
mesh.py``).

JAX builds a named ``jax.sharding.Mesh`` over the devices of one
controller. The port runs one process a device over ``torch.distributed``
(NCCL on the card, gloo on the CPU) and builds a
``torch.distributed.device_mesh`` with the same four named dims, in the
same row-major order: rank = ((dp * PP + pp) * SP + sp) * TP + tp. A
:class:`Mesh` is one rank's view of it: the shape, this rank's index on
each axis, the process group of each axis and the rank's device.

Axes:
  dp — data parallel (batch dim)
  pp — pipeline parallel (layer stages, ``parallel/pipeline``)
  sp — sequence/context parallel (ring attention,
       ``ops/ring_attention``)
  tp — tensor parallel (attention heads / mlp hidden / vocab)

An axis's process group orders its ranks by their index on the axis, so
a neighbour on the sp ring or the pp chain is an index in that group.

JAX's ``serialize_collective_chains`` has no counterpart: it orders two
independent collective chains of one XLA:CPU program against a deadlock
of XLA's thunk executor. Here each rank issues its collectives in program
order, so independent chains never interleave.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import torch

from speech_distill_tpu_torch.core.config import MeshConfig
from speech_distill_tpu_torch.core.device import resolve_device

DP_AXIS = "dp"
PP_AXIS = "pp"
SP_AXIS = "sp"
TP_AXIS = "tp"
AXES = (DP_AXIS, PP_AXIS, SP_AXIS, TP_AXIS)


def mesh_shape(cfg: Optional[MeshConfig], n: int) -> Dict[str, int]:
    """The (dp, pp, sp, tp) sizes of a mesh over ``n`` devices, with the
    JAX ``make_mesh``'s arithmetic and errors: pp / sp / tp default to 1,
    ``dp=-1`` takes what remains."""
    cfg = cfg or MeshConfig()
    tp = max(1, cfg.tp)
    sp = max(1, getattr(cfg, "sp", 1))
    pp = max(1, getattr(cfg, "pp", 1))
    if n % (tp * sp * pp) != 0:
        raise ValueError(
            f"device count {n} not divisible by pp*sp*tp={pp * sp * tp}")
    dp = cfg.dp if cfg.dp > 0 else n // (tp * sp * pp)
    if dp * pp * sp * tp != n:
        raise ValueError(
            f"dp*pp*sp*tp={dp * pp * sp * tp} != device count {n}")
    return {DP_AXIS: dp, PP_AXIS: pp, SP_AXIS: sp, TP_AXIS: tp}


def rank_device(device=None) -> torch.device:
    """This rank's device: ``device`` when given (``"cpu"`` only when the
    caller asks for it), else ``cuda:LOCAL_RANK`` (0 without the
    variable); raises without CUDA."""
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    return resolve_device(device)


class Mesh:
    """One rank's view of the (dp, pp, sp, tp) mesh: ``shape`` (axis ->
    size), ``coords`` (axis -> this rank's index), ``device``, and
    :meth:`group` (the process group of an axis; None for an axis of
    one rank, where every collective of ``parallel/comm`` is the
    identity)."""

    def __init__(self, shape: Dict[str, int], coords: Dict[str, int],
                 device: torch.device, device_mesh=None):
        self.shape = dict(shape)
        self.coords = dict(coords)
        self.device = device
        self.device_mesh = device_mesh

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        return self.coords[axis]

    @property
    def dp(self) -> int:
        return self.shape[DP_AXIS]

    @property
    def tp(self) -> int:
        return self.shape[TP_AXIS]

    @property
    def sp(self) -> int:
        return self.shape[SP_AXIS]

    @property
    def pp(self) -> int:
        return self.shape[PP_AXIS]

    @property
    def world(self) -> int:
        n = 1
        for a in AXES:
            n *= self.shape[a]
        return n

    @property
    def rank(self) -> int:
        r = 0
        for a in AXES:
            r = r * self.shape[a] + self.coords[a]
        return r

    @property
    def is_primary(self) -> bool:
        return self.rank == 0

    def group(self, axis: Optional[str] = None):
        """The process group of ``axis`` (None: every rank); None when it
        holds one rank."""
        if self.device_mesh is None:
            return None
        if axis is None:
            import torch.distributed as dist
            return dist.group.WORLD if self.world > 1 else None
        if self.shape[axis] == 1:
            return None
        return self.device_mesh.get_group(axis)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, coords={self.coords}, "
                f"device={self.device})")


def make_mesh(cfg: Optional[MeshConfig] = None, device=None) -> Mesh:
    """The (dp, pp, sp, tp) mesh over every rank of the process group
    (one rank when none is initialized; ``multihost.initialize`` starts
    one). ``device``: this rank's device (:func:`rank_device`)."""
    import torch.distributed as dist

    n = dist.get_world_size() if dist.is_initialized() else 1
    shape = mesh_shape(cfg, n)
    dev = rank_device(device)
    if n == 1:
        return single_device_mesh(dev)
    from torch.distributed.device_mesh import init_device_mesh
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dm = init_device_mesh(dev.type, tuple(shape[a] for a in AXES),
                          mesh_dim_names=AXES)
    coords = {a: dm.get_local_rank(a) for a in AXES}
    return Mesh(shape, coords, dev, dm)


def single_device_mesh(device=None) -> Mesh:
    return Mesh({a: 1 for a in AXES}, {a: 0 for a in AXES},
                rank_device(device))


_ACTIVE_MESH: Optional[Mesh] = None


def set_active_mesh(mesh: Optional[Mesh]) -> None:
    """Register the mesh that ops needing explicit collectives read when
    no mesh is passed to them (``ops/attention.sdpa``'s ring routes);
    pipelines set it once after :func:`make_mesh`."""
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh


def get_active_mesh() -> Optional[Mesh]:
    return _ACTIVE_MESH


class active_mesh:
    """Context manager form of :func:`set_active_mesh` (tests)."""

    def __init__(self, mesh: Optional[Mesh]):
        self.mesh = mesh

    def __enter__(self):
        global _ACTIVE_MESH
        self.prev = _ACTIVE_MESH
        _ACTIVE_MESH = self.mesh
        return self.mesh

    def __exit__(self, *exc):
        global _ACTIVE_MESH
        _ACTIVE_MESH = self.prev
        return False


def batch_sharding(mesh: Mesh) -> tuple:
    """The spec of a batch: the leading dim over dp, the rest whole."""
    return (DP_AXIS,)


def replicated(mesh: Mesh) -> tuple:
    return ()


def put_batch(mesh: Mesh, tree: dict) -> dict:
    """This rank's dp rows (leading dim) of a host batch, on its device."""
    from speech_distill_tpu_torch.parallel.sharding import shard_leaf
    return {k: shard_leaf(torch.as_tensor(v), batch_sharding(mesh), mesh
                          ).to(mesh.device) for k, v in tree.items()}
