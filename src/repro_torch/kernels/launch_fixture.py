"""The launch fixture: a no-op kernel launched at a chosen geometry.

Replaces ``repro/analysis/fixtures.py:_capture_2d`` (its ``pallas_call``
at line 43), the no-op kernel the reference's analysis self-tests
fabricate so that they go through the real capture machinery, with
``csrc/launch_fixture.cu``.  Here the fabricated launch goes through the
same ``LaunchRecord`` recorder the real wrappers use, and on the card it
really launches: the runtime itself takes a legal configuration and
refuses an illegal one (too much shared memory, too many threads, a grid
y past 65,535), so the limits the static contracts hold every record to
are the card's own.

The kernel reads its arguments and writes nothing; its plain version
does nothing, so the output keeps its contents on either device.
``launches`` counts the launches the runtime took.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.launch_record import (LaunchRecord, emit,
                                               record_launches, rects, spec)

launches = 0

# the device attributes ``launch_fixture_device_attrs`` reads, in order
DEVICE_ATTRS = ("smem_per_block_optin", "smem_per_sm", "smem_per_block",
                "smem_reserved_per_block", "max_threads_per_block",
                "max_threads_per_sm", "max_blocks_per_sm", "max_grid_x",
                "max_grid_y", "max_grid_z", "sm_count",
                "max_registers_per_block")

TileMap = Callable[[int, int], Tuple[int, int]]


def launch_config(shape, block, *, grid=None, threads: int = 256,
                  smem: int = 0, out_tile: Optional[TileMap] = None,
                  dtype=torch.float32, offset: int = 0,
                  vector_bytes: int = 0,
                  label: str = "fixture") -> LaunchRecord:
    """The record of a fabricated 2-D launch over an output of ``shape``
    in tiles of ``block``: grid (x, y) (default: one CTA a tile), CTA (x,
    y) writing tile ``out_tile(x, y)`` (default: (x, y)), ``threads`` a
    CTA and ``smem`` bytes of dynamic shared memory; the output read with
    ``vector_bytes`` accesses from ``offset`` bytes past 16."""
    rows, cols = shape
    br, bc = block
    grid = tuple(grid or (-(-rows // br), -(-cols // bc)))
    tile = out_tile or (lambda x, y: (x, y))

    def tiles():
        t = np.array([tile(x, y) for x in range(grid[0])
                      for y in range(grid[1])], dtype=np.int64).reshape(-1, 2)
        return rects(t[:, 0] * br, np.minimum(rows, (t[:, 0] + 1) * br),
                     t[:, 1] * bc, np.minimum(cols, (t[:, 1] + 1) * bc))
    return LaunchRecord("launch_fixture", "launch_fixture_kernel",
                        (grid[0], grid[1], 1), threads, smem, 0,
                        (spec("out", shape, dtype, vector_bytes, offset),),
                        (rows, cols), tiles, 1, (), label)


@functools.lru_cache(maxsize=None)
def _entry():
    return _build.entry("launch_fixture", [ctypes.c_void_p] + [
        ctypes.c_int] * 6 + [ctypes.c_void_p] * 2)


def noop_rows(out: torch.Tensor) -> torch.Tensor:
    """Plain version: nothing; ``out`` keeps its contents."""
    return out


def launch_fixture(out: torch.Tensor, rec: LaunchRecord):
    """Launch the no-op kernel at ``rec``'s geometry over ``out``.  A CPU
    tensor runs the plain version (nothing).  On a CUDA tensor returns
    (attribute rc, launch rc), the ``cudaError_t`` values of the shared
    memory opt-in and of the launch, and raises ``RuntimeError`` unless
    both are 0."""
    global launches
    emit(rec)
    if out.device.type == "cpu":
        noop_rows(out)
        return None
    _build.require_cuda("launch_fixture", out)
    rc = (ctypes.c_int * 2)()
    _entry()(out.data_ptr(), out.shape[0], out.shape[1], rec.grid[0],
             rec.grid[1], rec.threads, rec.smem_dynamic,
             ctypes.cast(rc, ctypes.c_void_p), _build.stream_ptr(out.device))
    if rc[0] or rc[1]:
        raise RuntimeError(f"launch_fixture: the runtime refused grid "
                           f"{rec.grid[:2]}, {rec.threads} threads, "
                           f"{rec.smem_dynamic} bytes of shared memory "
                           f"(cudaError {rc[0]} / {rc[1]})")
    launches += 1
    return rc[0], rc[1]


def _launch_2d(shape, block, *, device="cuda", **kw):
    """Counterpart of the reference's ``_capture_2d``: fabricate one 2-D
    launch of the fixture kernel through the real recorder and, on the
    card (the default), the runtime; ``device="cpu"`` only records.
    Returns the records."""
    with record_launches() as recs:
        launch_fixture(torch.empty(shape, device=device),
                       launch_config(shape, block, **kw))
    return recs


def device_attrs(device=None) -> dict:
    """The card's launch limits (``DEVICE_ATTRS``), read with
    ``cudaDeviceGetAttribute``."""
    dev = torch.device(device or "cuda").index or 0
    fn = _build.library("launch_fixture").launch_fixture_device_attrs
    out = (ctypes.c_int * len(DEVICE_ATTRS))()
    _build.check(fn(dev, out), "launch_fixture_device_attrs")
    return dict(zip(DEVICE_ATTRS, list(out)))


@contextlib.contextmanager
def armed(lib: str):
    """Arm library ``lib``'s dry run (``csrc/launch_query.cuh``) on the
    calling thread for the block, and disarm it however the block ends;
    yields the 8 values its next launch entry on this thread fills.  A
    launch from another thread meanwhile launches."""
    arm = getattr(_build.library(lib), f"{lib}_query")
    arm.argtypes = [ctypes.c_void_p]
    arm.restype = None
    out = (ctypes.c_longlong * 8)()
    arm(ctypes.addressof(out))
    try:
        yield out
    finally:
        arm(None)


def query(lib: str, entry: Callable, *args) -> dict:
    """The dry run of one launch: call the C launch entry ``entry`` of
    library ``lib`` with ``args`` (null pointers) with the library's
    query armed; returns its grid, threads, shared memory, registers and
    occupancy, as the launch would have had them, without launching."""
    with armed(lib) as out:
        rc = entry(*args)
    _build.check(rc, f"{lib} query")
    keys = ("grid_x", "grid_y", "grid_z", "threads", "smem_dynamic",
            "smem_static", "registers", "ctas_per_sm")
    return dict(zip(keys, list(out)))
