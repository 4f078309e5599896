"""Meshes over an initialized ``torch.distributed`` process group.

Counterpart of ``repro.launch.mesh``.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` whose dimensions carry the
reference's axis names: ("model",) for tensor-parallel serving, ("data",
"model") for data x tensor parallelism, ("pod", ...) for the pod-axis
gradient reduction.  Each rank is one process; the caller starts the
processes and initializes the default process group (its address, world
size and rank) before building a mesh.  A mesh needs exactly as many
ranks as it has places, so a world too small raises and a mesh never
quietly runs on fewer ranks than asked.

Ranks may share a device: on one card every rank runs on ``cuda:0``
over gloo (NCCL refuses two ranks on one device), which takes CUDA
tensors for the collectives the sharded path runs.

``mesh_context`` makes a mesh the ambient one, as the reference's
``shard_map`` does for the code it maps: a packed plane marked with
``tp_axis`` finds that axis's process group in it.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

_ACTIVE: list = []


def _world(need: int, what: str) -> int:
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(f"{what} needs an initialized torch.distributed "
                           f"process group of {need} ranks "
                           f"(dist.init_process_group)")
    world = dist.get_world_size()
    if world != need:
        raise ValueError(f"{what} needs {need} ranks, the process group has "
                         f"{world}")
    return world


def _mesh(shape: Sequence[int], axes: Sequence[str], device_type: str,
          what: str) -> DeviceMesh:
    _world(math.prod(shape), what)
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_tp_mesh(n_shards: int, device_type: str = "cuda") -> DeviceMesh:
    """1-D ("model",) mesh for tensor-parallel serving over ``n_shards``
    ranks."""
    return _mesh((n_shards,), ("model",), device_type,
                 f"make_tp_mesh({n_shards})")


def make_serving_mesh(dp: int, tp: int,
                      device_type: str = "cuda") -> DeviceMesh:
    """("data", "model") mesh: batch rows over ``dp`` data shards, packed
    planes over ``tp`` model shards; ``dp * tp`` ranks."""
    return _mesh((dp, tp), ("data", "model"), device_type,
                 f"make_serving_mesh(dp={dp}, tp={tp})")


# the reference's meshes by name, (shape, axis names): the production
# single pod of 16 x 16 places and two such pods, and the tiny ones of
# the machinery tests
MESHES = {
    "single_16x16": ((16, 16), ("data", "model")),
    "multi_2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "tiny_2x2": ((2, 2), ("data", "model")),
    "tiny_2x2x2": ((2, 2, 2), ("pod", "data", "model")),
}


def mesh_shape(name: str) -> dict:
    """A named mesh's axis names and sizes, in order, with no process
    group: what the launch dry run lays tensors out over."""
    shape, axes = MESHES[name]
    return dict(zip(axes, shape))


def production_mesh_shape(multi_pod: bool = False) -> dict:
    return mesh_shape("multi_2x16x16" if multi_pod else "single_16x16")


def make_production_mesh(multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """The reference's production mesh: (16, 16) over ("data", "model"),
    or with ``multi_pod`` (2, 16, 16) over ("pod", "data", "model"); needs
    a process group of exactly 256 or 512 ranks."""
    sizes = production_mesh_shape(multi_pod)
    return _mesh(tuple(sizes.values()), tuple(sizes), device_type,
                 f"make_production_mesh(multi_pod={multi_pod})")


def make_test_mesh(shape=(2, 2), axes=("data", "model"),
                   device_type: str = "cuda") -> DeviceMesh:
    """A mesh of any small shape and axis names (the tests' and the
    sharded checks'), on the card unless ``device_type`` is "cpu"."""
    return _mesh(shape, axes, device_type, f"make_test_mesh({shape})")


def make_host_mesh(device_type: str = "cuda") -> DeviceMesh:
    """The one-rank ("data", "model") mesh of a plain single-process run,
    on the card unless ``device_type`` is "cpu"."""
    return _mesh((1, 1), ("data", "model"), device_type, "make_host_mesh()")


def axis_size(mesh: Optional[DeviceMesh], name: str) -> int:
    """The size of mesh axis ``name``, 1 when the mesh has no such axis
    (or there is no mesh)."""
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(name))


@contextlib.contextmanager
def mesh_context(mesh: DeviceMesh):
    """Make ``mesh`` the ambient mesh of the code inside."""
    _ACTIVE.append(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.pop()


def current_mesh() -> Optional[DeviceMesh]:
    return _ACTIVE[-1] if _ACTIVE else None


def axis_group(name: str):
    """The process group of this rank along axis ``name`` of the ambient
    mesh; raises without one."""
    mesh = current_mesh()
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        raise RuntimeError(f"planes sharded over {name!r} need a mesh with "
                           f"that axis (launch.mesh.mesh_context)")
    return mesh.get_group(name)
