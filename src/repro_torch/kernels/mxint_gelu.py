"""MXInt GELU / SiLU datapath (paper §III-B-2, Eq. 12).

Replaces ``repro/kernels/mxint_gelu.py:mxint_gelu`` (its ``pallas_call``
at line 80) with ``csrc/mxint_gelu.cu``.  Per act block:

    block-quantize x onto the MXInt grid, then
    y = x                 for x >= a       (ReLU tail)
    y = LUT[fix(x)]       for -a < x < a   (2^k-entry table, Fig. 6)
    y = 0                 for x <= -a
    and requantize y onto the block's own (forwarded) exponent.

The requantized mantissas are clipped to +-(2^(m-1) - 1), as the Pallas
kernel clips them (``mxint_gelu.py:43-45``); the reference's sim path
clips negatives to -2^(m-1) instead, so this op follows the kernel.

On the H100 the kernel is bound by memory: DeiT's (rows, 4d) FFN tile is
read once and written once.  ``gelu_geometry`` picks the route from the
shape and the alignment alone and sizes a grid-stride grid from the SM
count: power-of-two act blocks of 4-128 on 16-byte aligned data give each
lane one float4 (block / 4 adjacent lanes a block, up to the whole warp,
the block amax by warp shuffles), so a warp instruction moves 512
contiguous bytes; any other block up to 128 runs one thread per act
block.  The LUT sits in shared memory.  Longer act blocks and LUTs past
``MAX_LUT`` entries (Table VI's vanilla 14 bits) take the generic route
(``gelu_route``): the scalar route's kernel instanced with the LUT read
from device memory, an act block a thread at any length.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.core import luts
from repro_torch.core.mx_types import NonlinearConfig
from repro_torch.core.quantize import pow2i
from repro_torch.kernels import _build
from repro_torch.kernels.launch_record import (LaunchRecord, emit, spec,
                                               stride_tiles)
from repro_torch.kernels.mxint_matmul import sm_count
from repro_torch.kernels.mxint_layernorm import (MAX_BLOCK, MAX_LUT,
                                                 block_quantize_rows, f32,
                                                 lut_tensor, resolve_act_block)

MAX_THREADS = 256          # a CTA at most; fewer where that fills more SMs
MIN_THREADS = 64
THREADS_PER_SM = 2048      # resident threads of an SM: the grid's cap
VEC_BLOCKS = (4, 8, 16, 32, 64, 128)   # act blocks of the float4 route
SMEM_BYTES = 4 * MAX_LUT   # a CTA's shared memory: the LUT copy

# the generic route's kernel: the scalar route's, its LUT in device memory
GENERIC_KERNEL = "gelu_scalar_kernel<generic>"

launches = 0
generic_launches = 0    # launches of the generic route (within launches)


class GeluGeometry(NamedTuple):
    vec: int       # 4: a float4 a lane; 1: an act block a thread
    threads: int   # a CTA
    grid: int      # CTAs, walking the items grid-stride


@functools.lru_cache(maxsize=None)
def gelu_geometry(numel: int, block: int, n_sm: int,
                  aligned: bool = True) -> GeluGeometry:
    """The kernel's route and grid for ``numel`` f32 elements in act
    blocks of ``block`` on a card of ``n_sm`` SMs; ``aligned``: input and
    output start on 16 bytes.  CTAs shrink to MIN_THREADS until the items
    fill every SM; the grid stops at the SMs' resident threads."""
    vec = 4 if block in VEC_BLOCKS and aligned else 1
    items = numel // (4 if vec == 4 else block)
    threads = MAX_THREADS
    while threads > MIN_THREADS and -(-items // threads) < n_sm:
        threads //= 2
    grid = min(-(-items // threads), n_sm * (THREADS_PER_SM // threads))
    return GeluGeometry(vec, threads, max(grid, 1))


@functools.lru_cache(maxsize=None)
def launch_config(rows: int, d: int, *, act_block: int, lut_bits: int,
                  domain: float, fn: str, n_sm: int, aligned: bool = True,
                  label: str = "") -> LaunchRecord:
    """The launch ``mxint_gelu`` makes for (rows, d) f32 elements on a card
    of ``n_sm`` SMs (``aligned``: input and output start on 16 bytes): the
    ``gelu_geometry`` route and its capped grid-stride grid.  Raises
    ``ValueError`` first for a format outside the kernel's domain."""
    act_block = resolve_act_block(d, act_block)
    table, _ = gelu_table(fn, lut_bits, domain)
    generic = gelu_route(act_block, len(table)) == "generic"
    numel = rows * d
    # the generic route walks the scalar route's items: an act block a
    # thread
    geom = gelu_geometry(numel, act_block, n_sm, aligned and not generic)
    vec = 0 if generic else geom.vec      # the C entry's route code
    width = 4 if geom.vec == 4 else act_block
    vb = 16 if geom.vec == 4 else 0
    ops_ = (spec("x", (rows, d), torch.float32, vb),
            spec("out", (rows, d), torch.float32, vb))
    return LaunchRecord(
        "mxint_gelu",
        GENERIC_KERNEL if generic else
        "gelu_vec4_kernel" if geom.vec == 4 else "gelu_scalar_kernel",
        (geom.grid, 1, 1), geom.threads, 0, 0 if generic else SMEM_BYTES,
        ops_, (1, numel),
        stride_tiles(numel // width, width, geom.threads, geom.grid),
        max(1, THREADS_PER_SM // geom.threads),
        (vec, geom.threads, geom.grid), label)


def gelu_route(act_block: int, lut_n: int) -> str:
    """'core' (act blocks up to MAX_BLOCK, a LUT of at most MAX_LUT
    entries in shared memory), else 'generic' (any act block, a LUT of any
    length read from device memory)."""
    return "core" if act_block <= MAX_BLOCK and lut_n <= MAX_LUT \
        else "generic"


def gelu_table(fn: str, lut_bits: int, domain: float):
    """(table, effective domain) of ``fn``; 'silu' doubles the domain and
    adds one index bit, as the reference kernel does."""
    index_bits = NonlinearConfig(gelu_lut_bits=lut_bits,
                                 gelu_domain=domain).gelu_index_bits
    if fn == "gelu":
        return luts.gelu_table(index_bits, float(domain)), float(domain)
    if fn == "silu":
        return luts.silu_table(index_bits + 1, 2.0 * domain), 2.0 * domain
    raise ValueError(fn)


def gelu_rows(x: torch.Tensor, table: torch.Tensor, *, act_block: int,
              mant_bits: int, domain: float) -> torch.Tensor:
    """Plain version of the Eq. 12 LUT datapath on (rows, d) f32."""
    r, d = x.shape
    m, e = block_quantize_rows(x, act_block, mant_bits)
    scale = pow2i(e)[..., None]
    xq = m * scale                                      # on-grid values
    n = table.shape[0]
    idx = torch.floor((xq + domain) * f32(n / (2.0 * domain)))
    y_small = table[idx.clamp(0, n - 1).long()]
    y = torch.where(xq >= domain, xq,
                    torch.where(xq <= -domain, torch.zeros_like(xq), y_small))
    lim = float(2 ** (mant_bits - 1) - 1)
    ym = torch.round(y / scale).clamp(-lim, lim)
    return (ym * scale).reshape(r, d)


@functools.lru_cache(maxsize=None)
def entry():
    """The C entry point ``mxint_gelu_launch`` (every route)."""
    return _build.entry("mxint_gelu", [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_float] * 2 +
        [ctypes.c_int] * 3 + [ctypes.c_void_p])


def mxint_gelu(x: torch.Tensor, *, act_block: int = 16, mant_bits: int = 8,
               lut_bits: int = 5, domain: float = 3.0,
               fn: str = "gelu") -> torch.Tensor:
    """Elementwise MXInt GELU (or SiLU) over a (rows, d) f32 tensor.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel.
    """
    rows, d = x.shape
    act_block = resolve_act_block(d, act_block)
    table, eff_domain = gelu_table(fn, lut_bits, domain)
    lut = lut_tensor(table, x.device)
    if x.device.type == "cpu":
        return gelu_rows(x, lut, act_block=act_block, mant_bits=mant_bits,
                         domain=eff_domain)
    global launches, generic_launches
    if x.dtype != torch.float32:
        raise ValueError("mxint_gelu kernel takes f32 rows")
    _build.require_cuda("mxint_gelu", x, lut)
    out = torch.empty_like(x)
    n = len(table)
    rec = launch_config(rows, d, act_block=act_block, lut_bits=lut_bits,
                        domain=domain, fn=fn, n_sm=sm_count(x.device),
                        aligned=(x.data_ptr() % 16 == 0 and
                                 out.data_ptr() % 16 == 0))
    emit(rec, x=x, out=out)
    rc = entry()(x.data_ptr(), lut.data_ptr(), out.data_ptr(), x.numel(),
             act_block, mant_bits, n, f32(eff_domain),
             f32(n / (2.0 * eff_domain)), *rec.args,
             _build.stream_ptr(x.device))
    _build.check(rc, "mxint_gelu")
    if rec.function == GENERIC_KERNEL:
        generic_launches += 1
    launches += 1
    return out
