"""Launch records: what a kernel wrapper hands the card in one launch.

Each kernel module has a pure ``launch_config(...)`` that builds a
``LaunchRecord`` from the module's geometry function (``gemm_geometry``,
``ln_geometry``, ``softmax_geometry``, ``gelu_geometry``,
``kernel_route`` / ``decode_geometry``), and its wrapper launches from
that record: the grid, the threads and the shared memory the C entry is
given, or checks, are the record's.  So the static checks of
``repro_torch.analysis.launch_contracts`` and the launches on the card
read one source.

``record_launches()`` collects the records of the launches made inside
it (the wrappers ``emit`` each record just before they launch; on the CPU
the plain versions run and nothing is recorded, but the launch fixture,
whose record is the thing under test, records on both).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, List, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Operand:
    """One operand of a launch.  ``vector_bytes``: the width of the
    vector accesses the route reads or writes it with (0: element by
    element); ``offset``: its start's offset from a 16-byte boundary
    (``data_ptr() % 16`` on the card; the sweep's own tensors start on
    one)."""
    name: str
    shape: Tuple[int, ...]
    dtype: str
    vector_bytes: int = 0
    offset: int = 0


@dataclasses.dataclass(frozen=True)
class LaunchRecord:
    """One launch: the kernel (``ops.LAUNCH_COUNTERS`` name), the CUDA
    function or route it runs, the grid (x, y, z) and the threads of a
    CTA, the dynamic and static shared memory a CTA holds, the operands,
    the CTAs an SM is assumed to hold at once (``per_sm``), the geometry
    values the C entry is given (``args``), and the output
    as a 2-D view ``out_shape`` whose element each CTA writes:
    ``tiles()`` returns an (n, 4) int64 array of [r0, r1, c0, c1)
    rectangles, one a tile that some CTA writes (a CTA's grid-stride
    passes are one each)."""
    kernel: str
    function: str
    grid: Tuple[int, int, int]
    threads: int
    smem_dynamic: int
    smem_static: int
    operands: Tuple[Operand, ...]
    out_shape: Tuple[int, int]
    tiles: Callable[[], np.ndarray] = dataclasses.field(compare=False,
                                                        repr=False)
    per_sm: int = 1
    args: Tuple = ()
    label: str = ""

    @property
    def smem(self) -> int:
        return self.smem_dynamic + self.smem_static

    @property
    def ctas(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


def operand(name: str, t, vector_bytes: int = 0) -> Operand:
    """An ``Operand`` of tensor ``t``."""
    off = t.data_ptr() % 16 if t.device.type == "cuda" else 0
    return Operand(name, tuple(t.shape), str(t.dtype).replace("torch.", ""),
                   vector_bytes, off)


def spec(name: str, shape, dtype: torch.dtype, vector_bytes: int = 0,
         offset: int = 0) -> Operand:
    """An ``Operand`` from a shape and dtype (the sweep has no tensors)."""
    return Operand(name, tuple(int(s) for s in shape),
                   str(dtype).replace("torch.", ""), vector_bytes, offset)


def rects(r0, r1, c0, c1) -> np.ndarray:
    """(n, 4) int64 rectangles from broadcastable bounds, empty ones
    dropped."""
    r0, r1, c0, c1 = np.broadcast_arrays(*(np.asarray(v, dtype=np.int64)
                                           for v in (r0, r1, c0, c1)))
    out = np.stack([a.reshape(-1) for a in (r0, r1, c0, c1)], axis=1)
    return out[(out[:, 1] > out[:, 0]) & (out[:, 3] > out[:, 2])]


def row_tiles(rows: int, cols: int, per_cta: int, n_ctas: int):
    """CTA c writes rows [c * per_cta, (c + 1) * per_cta) whole."""
    def tiles():
        c = np.arange(n_ctas, dtype=np.int64)
        return rects(c * per_cta, np.minimum(rows, (c + 1) * per_cta), 0,
                     cols)
    return tiles


def stride_tiles(items: int, width: int, threads: int, grid: int):
    """A grid-stride loop over ``items`` items of ``width`` elements in a
    (1, items * width) view: thread t of CTA c takes items c * threads + t
    + k * grid * threads, so pass k of CTA c writes a run of ``threads``
    items."""
    def tiles():
        passes = -(-items // (grid * threads))
        run = (np.arange(passes, dtype=np.int64)[:, None] * grid
               + np.arange(grid, dtype=np.int64)[None, :])
        start = run * threads
        return rects(0, 1, np.minimum(items, start) * width,
                     np.minimum(items, start + threads) * width)
    return tiles


_ACTIVE: List[List[LaunchRecord]] = []


def emit(rec: LaunchRecord, **tensors) -> None:
    """Hand ``rec`` to every active ``record_launches``, the operands
    named in ``tensors`` replaced by those tensors' (the launch's own:
    their alignment on the card; None keeps the record's).  Costs one test
    when nothing records."""
    if not _ACTIVE:
        return
    rec = dataclasses.replace(rec, operands=tuple(
        o if tensors.get(o.name) is None
        else operand(o.name, tensors[o.name], o.vector_bytes)
        for o in rec.operands))
    for sink in _ACTIVE:
        sink.append(rec)


@contextlib.contextmanager
def record_launches():
    """The list of the ``LaunchRecord``s emitted inside."""
    sink: List[LaunchRecord] = []
    _ACTIVE.append(sink)
    try:
        yield sink
    finally:
        # by identity: two sinks of equal contents are still two sinks
        del _ACTIVE[next(i for i, s in enumerate(_ACTIVE) if s is sink)]

