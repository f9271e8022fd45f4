"""Device meshes: the counterpart of the JAX package's
``parallel/mesh.py`` over ``torch.distributed``.

A mesh is a ``DeviceMesh`` over the initialised world (one process per
rank, ``parallel.distributed.init_process_group``) whose six dims carry
the JAX names in the JAX order, outer to inner:

  pp    pipeline parallel: decoder layers split into stages
        (``parallel/pp_train.py``, ``ops/pipeline.py``)
  dp    data parallel: parameters replicated
  fsdp  data parallel with parameters sharded (FSDP2's ``fully_shard``)
  sp    sequence parallel: each rank holds a block of the sequence
        (ring or Ulysses attention, ``ops/ring_attention.py``)
  ep    expert parallel: the MoE experts split over its ranks
  tp    tensor parallel: heads, the MLP's width and the vocabulary split

Rank order is row-major over the dims, so tp ranks are neighbours, as
JAX's device order puts tp on neighbouring chips. A batch's rows are
split over ``(dp, fsdp)`` and its sequence over ``sp`` (JAX's
``activation_spec(seq_sharded=True)``): ep and tp ranks hold the same
tokens. ``ShardedTrainer`` replicates its work over ``pp``;
``PipelinedTrainer`` gives each pp rank a stage (``pp_stage``).

A serve mesh (``serve_mesh``) is tp only: every other axis is 1, as in
the JAX engine's ``resolve_serve_mesh``.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

AXES = ("pp", "dp", "fsdp", "sp", "ep", "tp")
# the axes a batch is split over, outer first (JAX's P(("dp", "fsdp")))
BATCH_AXES = ("dp", "fsdp")


@dataclass(frozen=True)
class MeshConfig:
    """Degrees for each parallelism axis. -1 on one axis = fill remaining."""

    pp: int = 1
    dp: int = 1
    fsdp: int = -1
    sp: int = 1
    ep: int = 1
    tp: int = 1

    def resolved(self, n_devices: int) -> Dict[str, int]:
        sizes = {"pp": self.pp, "dp": self.dp, "fsdp": self.fsdp,
                 "sp": self.sp, "ep": self.ep, "tp": self.tp}
        fill_axes = [a for a, s in sizes.items() if s == -1]
        known = math.prod(s for s in sizes.values() if s != -1)
        if n_devices % known != 0:
            raise ValueError(
                f"{n_devices} devices not divisible by fixed axes {sizes}")
        rest = n_devices // known
        if not fill_axes:
            if known != n_devices:
                raise ValueError(
                    f"mesh {sizes} covers {known} devices, have {n_devices}")
        elif len(fill_axes) == 1:
            sizes[fill_axes[0]] = rest
        else:
            raise ValueError("at most one axis may be -1")
        return sizes


def create_mesh(config: Optional[MeshConfig] = None,
                device_type: Optional[str] = None) -> DeviceMesh:
    """The mesh over every rank of the initialised world, its dims named
    AXES. ``device_type`` defaults to the world's ("cuda" over NCCL)."""
    config = config or MeshConfig()
    if not dist.is_initialized():
        raise RuntimeError("create_mesh needs an initialised process group "
                           "(parallel.distributed.init_process_group)")
    sizes = config.resolved(dist.get_world_size())
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(sizes[a] for a in AXES),
                            mesh_dim_names=AXES)


def single_device_mesh(device_type: Optional[str] = None) -> DeviceMesh:
    """Every axis of size 1, over a world of one process."""
    return create_mesh(MeshConfig(fsdp=1), device_type)


def serve_mesh(tp: int, device_type: Optional[str] = None) -> DeviceMesh:
    """The serving engine's mesh over the initialised world:
    ``create_mesh(MeshConfig(tp=tp, fsdp=1))``, every other axis 1."""
    return create_mesh(MeshConfig(tp=tp, fsdp=1), device_type)


def check_serve_mesh(mesh: DeviceMesh) -> int:
    """The tp degree of a serve mesh; refuses a mesh with no "tp" axis, or
    with another axis above 1 (serving splits over tp only)."""
    names = tuple(mesh.mesh_dim_names or ())
    if "tp" not in names:
        raise ValueError(
            f"serve mesh must carry a 'tp' axis (got {names}); build it with "
            f"parallel.mesh.create_mesh(MeshConfig(tp=...)) — standard axes "
            f"are {AXES}")
    sizes = mesh_sizes(mesh)
    other = {a: n for a, n in sizes.items() if a != "tp" and n > 1}
    if other:
        raise ValueError(f"serving splits over tp only, but the mesh has "
                         f"{other}: build it with serve_mesh(tp)")
    return sizes["tp"]


def mesh_sizes(mesh: DeviceMesh) -> Dict[str, int]:
    """{axis name: size} of ``mesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


# ---------------------------------------------------------------------------
# The ambient mesh, as in JAX: a thread-local stack of meshes entered by
# ``active_mesh``
# ---------------------------------------------------------------------------
class _MeshStack(threading.local):
    def __init__(self):
        self.stack: List[DeviceMesh] = []


_ACTIVE_MESHES = _MeshStack()


class active_mesh:
    """Context manager marking ``mesh`` as the ambient mesh of this
    thread."""

    def __init__(self, mesh: DeviceMesh):
        self.mesh = mesh

    def __enter__(self) -> DeviceMesh:
        _ACTIVE_MESHES.stack.append(self.mesh)
        return self.mesh

    def __exit__(self, *exc):
        _ACTIVE_MESHES.stack.pop()
        return False


def current_mesh() -> Optional[DeviceMesh]:
    """The innermost ``active_mesh``, or None."""
    return _ACTIVE_MESHES.stack[-1] if _ACTIVE_MESHES.stack else None


# ---------------------------------------------------------------------------
# The batch split: JAX's activation_spec(seq_sharded=True),
# P(("dp", "fsdp"), "sp")
# ---------------------------------------------------------------------------
def _place(mesh, axes) -> Tuple[int, int]:
    """The rank's index and the count of parts over ``axes``, outer
    first."""
    idx, n = 0, 1
    for axis in axes:
        size = mesh.size(AXES.index(axis))
        idx, n = idx * size + mesh.get_local_rank(axis), n * size
    return idx, n


def batch_rows(mesh: DeviceMesh, x):
    """This rank's rows of a global batch array or tensor ``x`` [B, ...]:
    of ``n`` = dp x fsdp equal parts along dim 0, the part at the rank's
    place on ``(dp, fsdp)``, dp the outer axis."""
    idx, n = _place(mesh, BATCH_AXES)
    if x.shape[0] % n:
        raise ValueError(f"batch of {x.shape[0]} rows does not split over "
                         f"dp x fsdp = {n} ranks")
    rows = x.shape[0] // n
    return x[idx * rows:(idx + 1) * rows]


def seq_columns(mesh: DeviceMesh, x):
    """This rank's block of the sequence (dim 1) of ``x`` [B, S, ...]: of
    ``sp`` equal parts, the one at the rank's place on sp."""
    idx, n = _place(mesh, ("sp",))
    if x.shape[1] % n:
        raise ValueError(f"sequence of {x.shape[1]} positions does not "
                         f"split over sp = {n} ranks")
    cols = x.shape[1] // n
    return x[:, idx * cols:(idx + 1) * cols]


def batch_shard(mesh: DeviceMesh, x):
    """This rank's part of a global batch ``x`` [B, S, ...]: its rows over
    ``(dp, fsdp)`` (``batch_rows``) and its sequence block over ``sp``
    (``seq_columns``)."""
    return seq_columns(mesh, batch_rows(mesh, x))


def pp_stage(mesh: DeviceMesh) -> Tuple[int, int]:
    """This rank's pipeline stage and the number of stages: its place on
    ``pp`` and the axis's size."""
    return mesh.get_local_rank("pp"), mesh.size(AXES.index("pp"))
