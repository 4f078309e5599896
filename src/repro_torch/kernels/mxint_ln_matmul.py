"""Fused MXInt LayerNorm -> matmul.

Replaces ``repro/kernels/mxint_ln_matmul.py:mxint_ln_matmul`` (its
``pallas_call`` at line 121) with ``csrc/mxint_ln_matmul.cu``:

    y[M, N] = Q_act(Q_grid(LN(x)))[M, d] @ (w_mant * 2^w_exp)[d, N]

the Fig. 3 LayerNorm (or RMSNorm) of each row, its output quantization
onto the act grid, a round trip through ``x.dtype``, then the same
contraction as ``mxint_matmul``.  No bias: the wrapper adds it.  It must
equal LN followed by ``mxint_linear`` bit for bit, and does so by
construction, since both run the same stages in the same order.

The Pallas grid carries the normalized tile across an ordered N axis;
CUDA blocks run in no order, so each CTA normalizes its own 16-32 rows
into shared memory (as int8 or int16 act mantissas and exponents), while
the first weight tiles load, and then streams its ``n_per`` column tiles
through the GEMM core of ``mxint_matmul`` (int8 tensor cores, any of its
variants: int8 or int16 planes, act blocks nested in the weight blocks or
not, ``csrc/mxint_common.cuh``).  The normalization is the row stage
``mxint_layernorm`` runs (``ln_rows``), on every thread of the CTA: x is
read once, f32 or bf16 as it comes, and the aligned mantissas are staged
in place in the rows' slots of the act tile, which the LN output's act
mantissas then overwrite.  Its rsqrt LUT is copied to shared memory up to
MAX_LUT entries; a longer one (Table VI's 13-bit vanilla LUT) is read by
index from device memory, once a row.  The tiles come from
``gemm_geometry`` (without K chunks: the CTA holds its whole normalized
rows); where the column range is split over several CTAs, each repeats
the LN of its rows.

On the H100, at DeiT-Base batch 16 the FFN ``wi`` reads x (3152, 768) f32
(9.7 MB) and 2.4 MB of planes and writes (3152, 3072) f32 (38.7 MB):
about 15 us at 3.35 TB/s, against 7.5 us for its 14.9 G int8 operations
on the tensor cores and 14 us for the ordered f32 sum's two operations per
output element and act block at the published f32 rate: like
``mxint_matmul`` it is bound by instruction issue in that epilogue.

Formats the core route does not take (``ln_matmul_route``: LN blocks
the LN stage does not take on its route, as 24, 48 or an unaligned 32;
int32 planes, act mantissas of 17-24 bits and the other formats of
``mxint_matmul``'s generic route) take the generic route: each warp
normalizes its CTA's rows with the generic row stage into shared memory,
then the generic GEMM runs over them (``csrc/mxint_generic.cuh``), the
same stages in the same order.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.core import luts
from repro_torch.kernels import _build
from repro_torch.kernels.launch_record import LaunchRecord, emit, spec
from repro_torch.kernels.mxint_layernorm import (LN_PIECE, MAX_LN_BLOCK,
                                                 aligned4, ln_route_ok, f32,
                                                 kernel_operands, layernorm_rows,
                                                 ln_piece, lut_tensor)
from repro_torch.kernels.mxint_matmul import (PLANE_BYTES, check_planes,
                                              gemm_geometry, gemm_launch,
                                              generic_args, generic_launch,
                                              launch_args, matmul_blocks,
                                              matmul_route, segmented,
                                              sm_count)

launches = 0


def ln_matmul_rows(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   w_mant: torch.Tensor, w_exp: torch.Tensor, *,
                   w_block: int, act_block: int, mant_bits: int,
                   lut_bits: int, rms_only: bool) -> torch.Tensor:
    """Plain version: the LN rows, quantized onto the act grid, through
    x.dtype and back, then the matmul's block products in K order."""
    y = layernorm_rows(x.to(torch.float32), gamma, beta, act_block=act_block,
                       mant_bits=mant_bits, lut_bits=lut_bits,
                       rms_only=rms_only, quantize_out=True)
    y = y.to(x.dtype).to(torch.float32)            # the x.dtype round trip
    return matmul_blocks(y, w_mant, w_exp, w_block=w_block,
                         act_block=act_block, act_mant_bits=mant_bits)


@functools.lru_cache(maxsize=None)
def launch_config(M: int, N: int, d: int, *, w_block: int, act_block: int,
                  mant_bits: int, lut_bits: int, n_sm: int,
                  x_dtype=torch.float32, params_dtype=torch.float32,
                  aligned: bool = True, w_dtype=torch.int8,
                  label: str = "") -> LaunchRecord:
    """The launch ``mxint_ln_matmul`` makes for x (M, d) and (d, N)
    planes on a card of ``n_sm`` SMs: on the core route the LN stage's
    piece (``aligned``: rows and scales start on four elements) and the
    GEMM core's tiles over whole rows; else the generic route.  Raises
    ``ValueError`` first for a format outside both, as the wrapper
    does."""
    act_block = min(act_block, d)
    route = ln_matmul_route(d, w_block, act_block, mant_bits, lut_bits,
                            w_dtype, aligned)
    xb = torch.tensor([], dtype=x_dtype).element_size()
    pb = torch.tensor([], dtype=params_dtype).element_size()
    piece = ln_piece(act_block, aligned) if route == "core" else 0
    vec = LN_PIECE if piece else 0
    ops_ = (spec("x", (M, d), x_dtype, vec * xb),
            spec("gamma", (d,), params_dtype, vec * pb),
            spec("beta", (d,), params_dtype, vec * pb),
            spec("w_mant", (d, N), w_dtype),
            spec("w_exp", (d // w_block, N), torch.int8),
            spec("out", (M, N), torch.float32,
                 16 if N % 4 == 0 and route == "core" else 0))
    if route == "generic":
        return generic_launch("mxint_ln_matmul", M, N, d, w_block, act_block,
                              mant_bits, w_dtype, True, ops_, label, ln_d=d,
                              x_dtype=x_dtype)
    w_bytes = PLANE_BYTES[w_dtype]
    geom = gemm_geometry(M, N, d, n_sm, fused_ln=True, act_block=act_block,
                         wide=mant_bits > 8, w_bytes=w_bytes,
                         seg=segmented(act_block, w_block, w_bytes))
    return gemm_launch("mxint_ln_matmul", geom, M, N, d, act_block,
                       mant_bits, ops_, label, fused_ln=True, piece=piece)


def ln_matmul_route(d: int, w_block: int, act_block: int, mant_bits: int,
                    lut_bits: int, w_dtype=torch.int8,
                    aligned: bool = True) -> str:
    """'core' where ``mxint_matmul``'s GEMM core takes the format and the
    LN stage takes the act block on its route (``ln_route_ok``), at any
    LUT length; else 'generic' (any LN block and alignment, every format
    of the generic GEMM).  Raises ``ValueError`` outside both."""
    ok = matmul_route(d, w_block, act_block, mant_bits, w_dtype) == "core" \
        and ln_route_ok(act_block, ln_piece(act_block, aligned),
                        MAX_LN_BLOCK)
    return "core" if ok else "generic"


@functools.lru_cache(maxsize=None)
def ln_matmul_entry():
    """The C entry point ``mxint_ln_matmul_launch``."""
    return _build.entry("mxint_ln_matmul", [ctypes.c_void_p] * 7 + [
        ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int, ctypes.c_float] +
        [ctypes.c_int] * 10 + [ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def ln_matmul_generic_entry():
    """The C entry point ``mxint_ln_matmul_generic_launch``."""
    return _build.entry("mxint_ln_matmul_generic", [ctypes.c_void_p] * 7 + [
        ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_int, ctypes.c_float] +
        [ctypes.c_int] * 3 + [ctypes.c_void_p], lib="mxint_ln_matmul")


generic_launches = 0        # launches of the generic route (within launches)
LUT_BITS = 5                # the rsqrt LUT's width unless a call names one


def mxint_ln_matmul(x: torch.Tensor, gamma: torch.Tensor,
                    beta: Optional[torch.Tensor], w_mant: torch.Tensor,
                    w_exp: torch.Tensor, *, w_block: int, act_block: int = 16,
                    mant_bits: int = 8, lut_bits: int = LUT_BITS,
                    rms_only: bool = False) -> torch.Tensor:
    """MXIntLN(x) @ (w_mant * 2^w_exp) for x (M, d); no bias.

    A CPU tensor runs the plain version; a CUDA tensor launches the GEMM
    core with its LN stage where ``ln_matmul_route`` picks it (int8 or
    int16 planes, 2-16 bits, act blocks that the LN stage takes on its
    route, any LUT length), else the generic route (every format of the
    reference), and raises for any other format before it touches the
    card (and where a core format's launch fails: no fallback).
    """
    M, d = x.shape
    act_block = min(act_block, d)
    check_planes(d, w_mant, w_exp, w_block, act_block)
    if x.device.type == "cpu":
        if beta is None:
            beta = torch.zeros_like(gamma)
        return ln_matmul_rows(x, gamma, beta, w_mant, w_exp, w_block=w_block,
                              act_block=act_block, mant_bits=mant_bits,
                              lut_bits=lut_bits, rms_only=rms_only)
    global launches, generic_launches
    # the kernel reads f32 or bf16 rows and scales as they come (the
    # reference's kernel reads them as f32; bf16 to f32 is exact)
    x, gamma, beta = kernel_operands(x.contiguous(), gamma, beta)
    if w_exp.dtype != torch.int8:
        raise ValueError("mxint_ln_matmul kernel takes int8 exponents")
    N = w_mant.shape[1]
    rec = launch_config(M, N, d, w_block=w_block, act_block=act_block,
                        mant_bits=mant_bits, lut_bits=lut_bits,
                        n_sm=sm_count(x.device), x_dtype=x.dtype,
                        params_dtype=gamma.dtype,
                        aligned=aligned4(x, gamma, beta),
                        w_dtype=w_mant.dtype)
    lut = lut_tensor(luts.rsqrt_table(lut_bits), x.device)
    _build.require_cuda("mxint_ln_matmul", x, gamma, lut, w_mant, w_exp,
                        *([] if beta is None else [beta]))
    out = torch.empty(M, N, dtype=torch.float32, device=x.device)
    emit(rec, x=x, gamma=gamma, beta=beta, w_mant=w_mant, w_exp=w_exp,
         out=out)
    xp, wmp, wep, outp = launch_args(x, w_mant, w_exp, out)
    ln = (f32(1.0 / d), 2 ** lut_bits, f32(2 ** lut_bits / 1.5),
          int(rms_only), int(x.dtype == torch.bfloat16),
          int(gamma.dtype == torch.bfloat16))
    bp = None if beta is None else beta.data_ptr()
    if len(rec.args) == 1:                        # the generic route
        rc = ln_matmul_generic_entry()(
            xp, gamma.data_ptr(), bp, lut.data_ptr(), wmp, wep, outp, M, d,
            N, *generic_args(d, w_block, act_block, mant_bits, w_mant.dtype,
                             True, rec.args[0]), *ln,
            _build.stream_ptr(x.device))
        generic_launches += 1
    else:
        rc = ln_matmul_entry()(
            xp, gamma.data_ptr(), bp, lut.data_ptr(), wmp, wep, outp, M, d,
            N, w_block, mant_bits, act_block, *ln, *rec.args,
            _build.stream_ptr(x.device))
    _build.check(rc, "mxint_ln_matmul")
    launches += 1
    return out
