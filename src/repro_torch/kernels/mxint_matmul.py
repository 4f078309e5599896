"""MXInt matmul with in-kernel activation quantization (paper Fig. 2b).

Replaces ``repro/kernels/mxint_matmul.py:mxint_matmul`` (its
``pallas_call`` at line 164, on the ``quantize_act=True`` path the kernel
datapath uses) with ``csrc/mxint_matmul.cu``:

    y[M, N] = Q_act(x)[M, K] @ (w_mant * 2^w_exp)[K, N]

``w_mant`` is a (K, N) int8 mantissa plane and ``w_exp`` a
(K / w_block, N) int8 exponent plane.  Each 16-element activation block
along K is quantized as ``_quantize_act_tile`` does; the int32 dot of that
block with the int8 weight mantissas is exact, and scaling it by
2^(e_x + e_w) is exact too, because 16 divides ``w_block`` so one block
pair shares one scale.  The scaled block products are added into an f32
accumulator in increasing K order.

On the H100, at DeiT-Base batch 16 the FFN ``wo`` reads x (3152, 3072) f32
(38.7 MB), 2.4 MB of planes and writes (3152, 768) f32 (9.7 MB): about
15 us of memory traffic against 7.5 us of int8 tensor-core work, so the
function is bound by memory.  This first kernel uses ``dp4a`` on CUDA
cores, not ``wgmma``, so it runs far from either bound.  Each block of
256 threads quantizes its 32 rows of x once into shared memory (int8
mantissas plus one exponent per 16-block) and then walks its N tiles,
staging 64x64 weight tiles through shared memory.  A K beyond 4096
(Llama-3-8B's FFN ``wo``, K 14336) does not fit shared memory whole: the
same launch then walks K in 4096-wide chunks, quantizes each in turn and
adds its block products onto the partial sums of the block's (at most 8)
N tiles, which stay in registers, in the same K order.  One call is one
launch.

The plain version accumulates the same block products in the same order,
so kernel and plain version agree bit for bit; against the reference's
f32 dot they differ in the order of the f32 sums across blocks.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.quantize import pow2i
from repro_torch.kernels import _build
from repro_torch.kernels.mxint_layernorm import (block_quantize_rows,
                                                 lut_tensor)

ACT_BLOCK = 16        # the CUDA kernel's activation block

launches = 0


@functools.lru_cache(maxsize=None)
def _pow2_table() -> tuple:
    """pow2i(n) for every block scale exponent n = e_x + e_w in [-254,
    254] (both exponents are int8 in [-127, 127])."""
    return tuple(pow2i(torch.arange(-254, 255)).tolist())


def matmul_blocks(x: torch.Tensor, w_mant: torch.Tensor, w_exp: torch.Tensor,
                  *, w_block: int, act_block: int,
                  act_mant_bits: int) -> torch.Tensor:
    """Plain version: block products summed in increasing K order.  The
    block scales come from a table of ``pow2i``, the same exact values."""
    M, K = x.shape
    N = w_mant.shape[1]
    nb = K // act_block
    xm, xe = block_quantize_rows(x, act_block, act_mant_bits)
    wm = w_mant.to(torch.float32).reshape(nb, act_block, N)
    we = w_exp.to(torch.int32).repeat_interleave(w_block // act_block, dim=0)
    table = lut_tensor(_pow2_table(), x.device)
    xe = xe + 254
    acc = torch.zeros(M, N, dtype=torch.float32, device=x.device)
    for k in range(nb):
        acc = acc + (xm[:, k] @ wm[k]) * table[xe[:, k, None] + we[None, k]]
    return acc


def check_planes(K: int, w_mant, w_exp, w_block: int, act_block: int):
    """Raise unless the planes fit x's K and the blocks nest."""
    N = w_mant.shape[1] if w_mant.dim() == 2 else -1
    if tuple(w_mant.shape) != (K, N) or \
            tuple(w_exp.shape) != (K // w_block, N) or K % w_block or \
            K % act_block or w_block % act_block:
        raise ValueError(
            f"planes {tuple(w_mant.shape)} / {tuple(w_exp.shape)} do not fit "
            f"K={K}, w_block={w_block}, act_block={act_block}")


def launch_args(x, w_mant, w_exp, out):
    return (x.data_ptr(), w_mant.data_ptr(), w_exp.data_ptr(), out.data_ptr())


def mxint_matmul(x: torch.Tensor, w_mant: torch.Tensor, w_exp: torch.Tensor,
                 *, w_block: int, act_block: int = 16,
                 act_mant_bits: int = 8) -> torch.Tensor:
    """y = Q_act(x) @ (w_mant * 2^w_exp) for x (M, K) f32.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel.
    """
    M, K = x.shape
    check_planes(K, w_mant, w_exp, w_block, act_block)
    if x.device.type == "cpu":
        return matmul_blocks(x, w_mant, w_exp, w_block=w_block,
                             act_block=act_block, act_mant_bits=act_mant_bits)
    global launches
    if x.dtype != torch.float32 or act_block != ACT_BLOCK or \
            w_mant.dtype != torch.int8 or w_exp.dtype != torch.int8:
        raise ValueError("mxint_matmul kernel takes f32 x, int8 planes and "
                         f"act_block == {ACT_BLOCK}")
    _build.require_cuda("mxint_matmul", x, w_mant, w_exp)
    N = w_mant.shape[1]
    out = torch.empty(M, N, dtype=torch.float32, device=x.device)
    fn = _build.entry("mxint_matmul", [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 5 + [ctypes.c_void_p])
    rc = fn(*launch_args(x, w_mant, w_exp, out), M, K, N, w_block,
            act_mant_bits, _build.stream_ptr(x.device))
    _build.check(rc, "mxint_matmul")
    launches += 1
    return out
