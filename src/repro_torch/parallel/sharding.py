"""Logical-axis sharding rules and the tensor-parallel split of packed
MXInt planes.

Counterpart of ``repro.parallel.sharding``.  The mesh axes are ("pod",
"data", "model") or ("data", "model"); the logical axes of the model zoo
map onto them by ``ShardingRules``:

  batch      -> (pod, data)        activations / inputs
  seq        -> None
  embed      -> None               d_model stays whole across TP
  q_heads    -> model              attention heads (TP)
  kv_heads   -> model
  mlp        -> model              FFN hidden
  vocab      -> model              embedding / unembedding tables
  expert     -> model              MoE expert dim
  lru        -> model              recurrent channel dim
  layers     -> None               stacked-layers leading dim
  pods       -> pod                per-pod state (error feedback)

``logical_to_pspec`` returns the per-dimension assignment that the
reference puts in a ``PartitionSpec``: a tuple with, for each dimension,
None, one mesh axis name, or a tuple of names.

Serving shards explicitly, as the reference's ``shard_map`` does: each
rank holds its slice of every sharded plane (``shard_packed_params``)
and the kernel-mode linear runs on it and adds the collective
(``kernels.ops.mxint_linear``).  The reference's ``named_sharding_tree``
(device placement of global arrays), ``shard_map_compat``,
``ambient_mesh`` and ``maybe_constraint`` (sharding hints inside a
trace) are JAX mechanics with no eager counterpart: a rank's tensors are
its shards, and ``launch.mesh.mesh_context`` names the mesh whose groups
the collectives run over.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core.quantize import MXTensor
from repro_torch.models.model_api import Param, tree_map

STRATEGIES = ("column", "row")


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    batch: Optional[Tuple[str, ...]] = ("pod", "data")
    seq: Optional[str] = None
    embed: Optional[str] = None
    q_heads: Optional[str] = "model"
    kv_heads: Optional[str] = "model"
    heads: Optional[str] = "model"
    mlp: Optional[str] = "model"
    vocab: Optional[str] = "model"
    expert: Optional[str] = "model"
    lru: Optional[str] = "model"
    layers: Optional[str] = None
    kv_seq: Optional[str] = None
    patch: Optional[str] = None
    classes: Optional[str] = None
    conv: Optional[str] = None
    pods: Optional[str] = "pod"
    cap: Optional[Tuple[str, ...]] = ("pod", "data")
    fsdp: Optional[str] = None

    def get(self, name: Optional[str]):
        if name is None:
            return None
        return getattr(self, name)


LOGICAL_RULES = ShardingRules()


def _filter_axes(assignment, mesh_axis_names):
    """Drop mesh axes absent from the mesh (a single pod drops "pod")."""
    if assignment is None:
        return None
    if isinstance(assignment, str):
        return assignment if assignment in mesh_axis_names else None
    kept = tuple(a for a in assignment if a in mesh_axis_names)
    return kept if kept else None


def logical_to_pspec(axes: Tuple[Optional[str], ...], rules: ShardingRules,
                     mesh_axis_names, shape: Optional[Tuple[int, ...]] = None,
                     mesh_shape: Optional[dict] = None) -> tuple:
    """Logical axes -> the per-dimension mesh assignment.

    Drops mesh axes absent from the mesh, uses a mesh axis at most once,
    and, given ``shape`` and ``mesh_shape``, keeps the longest prefix of
    an assignment whose mesh axes divide the dimension (a (pod, data)
    batch degrades to (pod,) or to replication for a small dim)."""
    used = set()
    out = []
    for i, name in enumerate(axes):
        a = _filter_axes(rules.get(name), mesh_axis_names)
        if a is None:
            out.append(None)
            continue
        names = (a,) if isinstance(a, str) else a
        names = tuple(n for n in names if n not in used)
        if shape is not None and mesh_shape is not None and i < len(shape):
            while names:
                prod = 1
                for n in names:
                    prod *= mesh_shape[n]
                if prod > 0 and shape[i] % prod == 0:
                    break
                names = names[:-1]
        used.update(names)
        if not names:
            out.append(None)
        elif len(names) == 1:
            out.append(names[0])
        else:
            out.append(names)
    return tuple(out)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def mesh_axis_names(mesh) -> tuple:
    """A mesh's axis names: a ``DeviceMesh``'s ``mesh_dim_names``, or a
    sequence of names as it is."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh)


def params_pspecs(axes_tree, rules: ShardingRules, mesh):
    """An axes tree (``model_api.axes_tree``; dicts and lists of axes
    tuples) -> the same tree of assignments."""
    names = mesh_axis_names(mesh)

    def walk(t):
        if _is_axes(t):
            return logical_to_pspec(t, rules, names)
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        raise TypeError(f"not an axes tree leaf: {t!r}")

    return walk(axes_tree)


# ---------------------------------------------------------------------------
# tensor-parallel sharding of packed MXInt planes (serving)
# ---------------------------------------------------------------------------
def _tp_decision(value, n_shards: int, strategy: str):
    """(the mantissa axis that shards under ``strategy``, the tp_mode), or
    None when the leaf stays whole: not packed, not divisible, or a split
    that would cut a shared-exponent block."""
    if not isinstance(value, MXTensor):
        return None
    shape = tuple(value.mantissa.shape)
    if len(shape) < 2:
        return None
    scale_axis = value.scale_axis % len(shape)
    if strategy == "column":
        axis, mode = len(shape) - 1, "gather"
        if axis == scale_axis:
            return None          # the output axis carries the blocks
                                 # (embedding tables)
    elif strategy == "row":
        axis, mode = scale_axis, "psum"
        if axis != len(shape) - 2:
            return None          # blocks not on the contracted axis: the
                                 # leaf is read by a dequantize, not the
                                 # kernel
        if (shape[axis] // value.block_size) % n_shards:
            return None          # blocks would straddle shards
    else:
        raise ValueError(f"unknown tp strategy {strategy!r}")
    if shape[axis] % n_shards:
        return None
    return axis, mode


def tp_shard_packed_params(packed_params, n_shards: int,
                           axis_name: str = "model",
                           strategy: str = "column"):
    """Mark the packed leaves that shard under ``strategy``.

    'column' shards every packed weight along its output (last) axis:
    each rank contracts the whole K for its columns and the linear
    gathers the slices, bit for bit the single-device result.  'row'
    shards along the contraction (block) axis: the linear slices the
    replicated activations to the rank's K rows and all-reduces the
    partial products, close to but not bit for bit the single-device
    result; pack with ``pack_params_mxint(..., tp_shards=n_shards)`` so
    that blocks never straddle ranks.

    Returns ``(marked, specs)``: the tree with ``tp_axis``/``tp_mode`` set
    on the sharded ``MXTensor`` leaves, and per leaf the assignment tuple
    of its mantissa plane's dimensions (``axis_name`` at the sharded
    axis; ``()`` for a whole leaf), the reference's in_specs.  Biases,
    norm scales and positional tables stay whole: the bias is added after
    the collective."""
    def mark(p: Param) -> Param:
        d = _tp_decision(p.value, n_shards, strategy)
        if d is None:
            return p
        return Param(p.value._replace(tp_axis=axis_name, tp_mode=d[1]),
                     p.axes)

    def spec(p: Param) -> tuple:
        d = _tp_decision(p.value, n_shards, strategy)
        if d is None:
            return ()
        ndim = p.value.mantissa.ndim
        return tuple(axis_name if i == d[0] else None for i in range(ndim))

    return tree_map(mark, packed_params), tree_map(spec, packed_params)


def shard_axis(value: MXTensor) -> Optional[int]:
    """The mantissa axis a marked leaf is sharded along, or None."""
    if not isinstance(value, MXTensor) or value.tp_mode is None:
        return None
    nd = value.mantissa.ndim
    if value.tp_mode == "gather":
        return nd - 1
    if value.tp_mode == "psum":
        return value.scale_axis % nd
    raise ValueError(f"unknown tp_mode {value.tp_mode!r}")


def shard_packed_params(marked, mesh):
    """This rank's local planes of a marked tree: each sharded leaf's
    mantissa and exponent planes cut along its sharded axis into the
    mesh axis's size, the rank's piece kept (contiguous copies); every
    other leaf as it is."""
    names = mesh_axis_names(mesh)

    def local(p: Param) -> Param:
        v = p.value
        axis = shard_axis(v)
        if axis is None:
            return p
        dim = names.index(v.tp_axis)
        n, r = mesh.size(dim), mesh.get_local_rank(v.tp_axis)

        def piece(t):
            size = t.shape[axis] // n
            return t.narrow(axis, r * size, size).contiguous()

        return Param(v._replace(mantissa=piece(v.mantissa),
                                exponent=piece(v.exponent)), p.axes)

    return tree_map(local, marked)
