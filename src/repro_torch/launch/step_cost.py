"""Count what one step does, op by op, as it runs (on ``meta`` or a card).

The port's counterpart of ``repro.launch.hlo_cost``'s role: the reference
parses XLA's compiled program; the port has no compiled program, so
``StepCost``, a ``TorchDispatchMode``, watches the aten ops of one eager
run of the step and records:

* **FLOPs by dtype**: the per-op formulas of ``torch.utils.flop_counter``
  (mm, addmm, bmm, baddbmm, convolution, SDPA and their backwards), keyed
  by the op's compute dtype (the dtype of its first tensor operand:
  "bf16", "f16", "f32", "f64", "int8", ...).  Their sum equals
  ``FlopCounterMode``'s on the same step;
* **bytes**: each aten op's operand and result bytes, views, metadata
  ops, allocations without a write (``empty*``) and collectives
  excluded.  In an eager program nothing is fused, so that is the
  traffic the step moves;
* **the live-bytes peak**: every storage an op creates is counted live
  until the storage is freed (``weakref.finalize`` on it); the peak is
  the transient bytes above the arguments, which existed before;
* **product events**: for each product or embedding lookup whose operand
  derives from a tagged tensor (``tag``: a parameter leaf, through
  casts, views and a dequantize, never through an op that mixes in an
  untagged tensor; a packed leaf's two planes are one leaf), the leaf's
  tag (an exponent plane's with the ``EXPONENT`` suffix), the op, the shapes and the output
  bytes, outside the backward pass.  ``launch.roofline`` derives the
  collective term from these and the layout.
"""
from __future__ import annotations

import weakref
from collections import defaultdict
from typing import Any, Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakTensorKeyDictionary

DTYPE_NAMES = {torch.bfloat16: "bf16", torch.float16: "f16",
               torch.float32: "f32", torch.float64: "f64",
               torch.int8: "int8", torch.uint8: "uint8",
               torch.int16: "int16", torch.int32: "int32",
               torch.int64: "int64"}

# the tag suffix of a packed leaf's exponent plane: a lookup in it is no
# second lookup of the leaf; an op that combines both planes is the leaf's
EXPONENT = "#exponent"

aten = torch.ops.aten
_PRODUCTS = {aten.mm, aten.addmm, aten.bmm, aten.baddbmm}
_LOOKUPS = {aten.embedding, aten.index_select, aten.index}
# allocations whose contents no op has written yet: live, but no traffic
_NO_TRAFFIC = {aten.empty, aten.empty_like, aten.empty_strided,
               aten.new_empty, aten.new_empty_strided, aten.detach,
               aten.alias, aten.lift_fresh, aten._local_scalar_dense}
_METADATA = {aten.sym_size, aten.sym_stride, aten.sym_numel,
             aten.sym_storage_offset, aten.size, aten.stride, aten.dim,
             aten.numel, aten.is_contiguous, aten.storage_offset,
             aten.is_same_size, aten.is_non_overlapping_and_dense}


def dtype_name(dtype) -> str:
    return DTYPE_NAMES.get(dtype, str(dtype).replace("torch.", ""))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _in_backward() -> bool:
    return torch._C._current_autograd_node() is not None


class StepCost(TorchDispatchMode):
    """Counts one step: ``with StepCost(tags) as c: step(...)``; then
    ``c.counts()``.  ``tags`` maps tensors (the parameters' values and
    planes) to a leaf name; ``tag_tree`` builds it from a Param tree."""

    def __init__(self, tags: Optional[WeakTensorKeyDictionary] = None):
        super().__init__()
        self.tags = tags if tags is not None else WeakTensorKeyDictionary()
        self.flops_by_dtype: Dict[str, int] = defaultdict(int)
        self.bytes = 0
        self.n_ops = 0
        self.live = 0
        self.peak = 0
        self.events: List[Dict[str, Any]] = []
        self._seen = set()               # id() of the live storages

    # -- live bytes -----------------------------------------------------------
    def _free(self, key, n):
        self._seen.discard(key)
        self.live -= n

    def _track(self, t: torch.Tensor, inputs) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._seen or any(st is i for i in inputs):
            return
        n = st.nbytes()
        self._seen.add(key)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, n)

    # -- provenance -----------------------------------------------------------
    def _tag_of(self, tensors) -> Optional[str]:
        """The one tag every non-scalar operand carries, else None."""
        tag = None
        for t in tensors:
            if t.dim() == 0:
                continue
            got = self.tags.get(t)
            if got is not None:
                got = got.removesuffix(EXPONENT)
            if got is None or (tag is not None and got != tag):
                return None
            tag = got
        return tag

    def _event(self, func, tensors, outs) -> None:
        tagged = [(i, self.tags.get(t)) for i, t in enumerate(tensors)
                  if self.tags.get(t) is not None]
        if len(tagged) != 1:
            return
        i, tag = tagged[0]
        others = [t for j, t in enumerate(tensors) if j != i]
        self.events.append({
            "op": str(func.overloadpacket).replace("aten.", ""),
            "leaf": tag, "operand": i,
            "shapes": [tuple(t.shape) for t in tensors],
            "act_bytes": sum(_nbytes(t) for t in others if t.dim() > 0),
            "out_shape": tuple(outs[0].shape) if outs else (),
            "out_bytes": sum(_nbytes(o) for o in outs)})

    # -- dispatch -------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        if packet in _METADATA:
            return out
        flat_in, _ = tree_flatten((args, kwargs))
        tensors = [t for t in flat_in if isinstance(t, torch.Tensor)]
        flat_out, _ = tree_flatten(out)
        outs = [t for t in flat_out if isinstance(t, torch.Tensor)]
        self.n_ops += 1
        if packet in flop_registry:
            n = flop_registry[packet](*args, **kwargs, out_val=out)
            if n:
                self.flops_by_dtype[dtype_name(tensors[0].dtype)] += int(n)
        storages = [t.untyped_storage() for t in tensors]
        for o in outs:
            self._track(o, storages)
        namespace = packet._qualified_op_name.split("::")[0]
        if not (func.is_view or packet in _NO_TRAFFIC
                or "c10d" in namespace):
            self.bytes += sum(_nbytes(t) for t in tensors) + \
                sum(_nbytes(o) for o in outs)
        if not _in_backward():
            if packet in _PRODUCTS or packet in _LOOKUPS:
                self._event(func, tensors, outs)
            elif outs and packet not in _PRODUCTS:
                tag = self._tag_of(tensors)
                if tag is not None:
                    for o in outs:
                        self.tags[o] = tag
        return out

    def counts(self) -> Dict[str, Any]:
        """The step's global counts, plain numbers."""
        return {"flops_by_dtype": dict(sorted(self.flops_by_dtype.items())),
                "flops": sum(self.flops_by_dtype.values()),
                "bytes": self.bytes,
                "transient_peak_bytes": self.peak,
                "n_ops": self.n_ops,
                "events": list(self.events)}


def tag_tree(tree, prefix: str = "",
             tags: Optional[WeakTensorKeyDictionary] = None):
    """Tag every tensor of a Param tree (a packed leaf's mantissa and
    exponent planes alike) with its path, for ``StepCost``."""
    from repro_torch.core.quantize import MXTensor
    from repro_torch.models.model_api import Param
    tags = tags if tags is not None else WeakTensorKeyDictionary()

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{path}/{k}" if path else str(k))
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, f"{path}/{i}")
        elif isinstance(t, Param):
            walk(t.value, path)
        elif isinstance(t, MXTensor):
            tags[t.mantissa] = path
            tags[t.exponent] = path + EXPONENT
        elif isinstance(t, torch.Tensor):
            tags[t] = path

    walk(tree, prefix)
    return tags
