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
into shared memory (as int8 act mantissas and exponents), while the first
weight tiles load, and then streams its column tiles through the GEMM core
of ``mxint_matmul`` (int8 tensor cores, ``csrc/mxint_common.cuh``).  The
normalization is the row stage ``mxint_layernorm`` runs (``ln_rows``), on
every thread of the CTA: x is read once, f32 or bf16 as it comes, and the
aligned mantissas are staged in place in the rows' slots of the act tile,
which the LN output's act mantissas then overwrite.  The
tiles come from ``gemm_geometry`` (without K chunks: the CTA holds its
whole normalized rows); where the column range is split over several
CTAs, each repeats the LN of its rows.

On the H100, at DeiT-Base batch 16 the FFN ``wi`` reads x (3152, 768) f32
(9.7 MB) and 2.4 MB of planes and writes (3152, 3072) f32 (38.7 MB):
about 15 us at 3.35 TB/s, against 7.5 us for its 14.9 G int8 operations
on the tensor cores and 14 us for the ordered f32 sum's two operations per
output element and act block at the published f32 rate: like
``mxint_matmul`` it is bound by instruction issue in that epilogue.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.core import luts
from repro_torch.kernels import _build
from repro_torch.kernels.launch_record import LaunchRecord, emit, spec
from repro_torch.kernels.mxint_layernorm import (LN_PIECE, MAX_LN_BLOCK,
                                                 MAX_LUT, aligned4,
                                                 check_ln_route, f32,
                                                 kernel_operands, layernorm_rows,
                                                 ln_piece, lut_tensor)
from repro_torch.kernels.mxint_matmul import (check_act_format, check_planes,
                                              gemm_geometry, gemm_launch,
                                              launch_args, matmul_blocks,
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
                  aligned: bool = True, label: str = "") -> LaunchRecord:
    """The launch ``mxint_ln_matmul`` makes for x (M, d) and (d, N)
    planes on a card of ``n_sm`` SMs: the LN stage's piece (``aligned``:
    rows and scales start on four elements) and the GEMM core's tiles over
    whole rows.  Raises ``ValueError`` first for a format outside the
    kernel's domain, as the wrapper does."""
    act_block = min(act_block, d)
    check_act_format(mant_bits, act_block, w_block)
    piece = ln_piece(act_block, aligned)
    check_ln_route(act_block, piece, MAX_LN_BLOCK)
    if 2 ** lut_bits > MAX_LUT or d % 16 or d % w_block:
        raise ValueError("mxint_ln_matmul kernel takes int8 planes, rows of "
                         f"a multiple of 16 and at most {MAX_LUT} LUT "
                         "entries")
    geom = gemm_geometry(M, N, d, n_sm, fused_ln=True, act_block=act_block,
                         wide=mant_bits > 8)
    xb = torch.tensor([], dtype=x_dtype).element_size()
    pb = torch.tensor([], dtype=params_dtype).element_size()
    vec = LN_PIECE if piece else 0
    ops_ = (spec("x", (M, d), x_dtype, vec * xb),
            spec("gamma", (d,), params_dtype, vec * pb),
            spec("beta", (d,), params_dtype, vec * pb),
            spec("w_mant", (d, N), torch.int8),
            spec("w_exp", (d // w_block, N), torch.int8),
            spec("out", (M, N), torch.float32, 16 if N % 4 == 0 else 0))
    rec = gemm_launch("mxint_ln_matmul", geom, M, N, d, act_block,
                      mant_bits, ops_, label, fused_ln=True)
    return dataclasses.replace(rec, args=(piece,) + rec.args)


@functools.lru_cache(maxsize=None)
def ln_matmul_entry():
    """The C entry point ``mxint_ln_matmul_launch``."""
    return _build.entry("mxint_ln_matmul", [ctypes.c_void_p] * 7 + [
        ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int, ctypes.c_float] +
        [ctypes.c_int] * 9 + [ctypes.c_void_p])


def mxint_ln_matmul(x: torch.Tensor, gamma: torch.Tensor,
                    beta: Optional[torch.Tensor], w_mant: torch.Tensor,
                    w_exp: torch.Tensor, *, w_block: int, act_block: int = 16,
                    mant_bits: int = 8, lut_bits: int = 5,
                    rms_only: bool = False) -> torch.Tensor:
    """MXIntLN(x) @ (w_mant * 2^w_exp) for x (M, d); no bias.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel,
    which takes ``mxint_matmul``'s act formats (2-16 bits; act blocks that
    divide 16, or multiples of 16 up to 256 dividing ``w_block``) where its
    LN stage takes the block (``check_ln_route``: past 16 on rows and
    scales aligned to four elements), and raises otherwise before it
    touches the card.
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
    global launches
    # the kernel reads f32 or bf16 rows and scales as they come (the
    # reference's kernel reads them as f32; bf16 to f32 is exact)
    x, gamma, beta = kernel_operands(x.contiguous(), gamma, beta)
    if w_mant.dtype != torch.int8 or w_exp.dtype != torch.int8:
        raise ValueError("mxint_ln_matmul kernel takes int8 planes")
    N = w_mant.shape[1]
    rec = launch_config(M, N, d, w_block=w_block, act_block=act_block,
                        mant_bits=mant_bits, lut_bits=lut_bits,
                        n_sm=sm_count(x.device), x_dtype=x.dtype,
                        params_dtype=gamma.dtype,
                        aligned=aligned4(x, gamma, beta))
    lut = lut_tensor(luts.rsqrt_table(lut_bits), x.device)
    _build.require_cuda("mxint_ln_matmul", x, gamma, lut, w_mant, w_exp,
                        *([] if beta is None else [beta]))
    out = torch.empty(M, N, dtype=torch.float32, device=x.device)
    emit(rec, x=x, gamma=gamma, beta=beta, w_mant=w_mant, w_exp=w_exp,
         out=out)
    xp, wmp, wep, outp = launch_args(x, w_mant, w_exp, out)
    rc = ln_matmul_entry()(
        xp, gamma.data_ptr(), None if beta is None else beta.data_ptr(),
        lut.data_ptr(), wmp, wep, outp, M, d, N, w_block, mant_bits,
        act_block, f32(1.0 / d), 2 ** lut_bits, f32(2 ** lut_bits / 1.5),
        int(rms_only), int(x.dtype == torch.bfloat16),
        int(gamma.dtype == torch.bfloat16), *rec.args,
        _build.stream_ptr(x.device))
    _build.check(rc, "mxint_ln_matmul")
    launches += 1
    return out
