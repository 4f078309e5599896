"""Bit-accurate MXInt datapaths for LayerNorm, GELU/SiLU and softmax
(paper §III-B), the "sim" oracle, and the related-work baselines.

Counterpart of ``repro.core.nonlinear``.  Every step mirrors a hardware
stage:

  LayerNorm (Fig. 3):  requantize to the max exponent -> integer mean and
                       variance -> LUT_{1/sqrt} with the even/odd exponent
                       split of Eq. 9.
  GELU (Fig. 6):       ReLU tails and a LUT over [-a, a) (Eq. 12), the
                       input's block exponent forwarded to the output.
  Softmax (Eq. 14-20): max-subtract in the shared-exponent domain,
                       e^x = 2^n * LUT_pow2(r), division in (mantissa,
                       exponent) form.

The fixed-point emulations of the related work (8-bit integer LayerNorm,
GELU and softmax, SDA's ReLU6 GELU) give the Tables II-IV baselines.

Powers of two come from ``pow2i``, never a float ``exp2``.  The float sums
whose result depends on their order have one order on every device: the
LayerNorm variance and the Eq. 19 softmax sum run in the kernels' lane
order (``warp_row_sum``), and the rsqrt and pow2 stages are the kernels'
own, so these datapaths give the kernels' bits on the same inputs (GELU
differs: sim clips a negative mantissa at -2^(b-1), the kernels at
-(2^(b-1) - 1)); the baselines' means and sums run in float64 and round
once to float32.  Every division by a constant divides by a tensor (``div``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import luts
from repro_torch.core.mx_types import MXFormat, NonlinearConfig
from repro_torch.core.quantize import (MXTensor, dequantize, div, pow2i,
                                       quantize, repeat_blocks,
                                       requantize_to_max_exponent)
from repro_torch.kernels.mxint_layernorm import (f32, lut_tensor,
                                                 rsqrt_lut_stage, warp_row_sum)
from repro_torch.kernels.mxint_softmax import exp2_datapath

_LOG2E = f32(1.4426950408889634)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
def _quantize_with_exponent(y: torch.Tensor, exponent: torch.Tensor,
                            block: int, axis: int, mant_bits: int) -> MXTensor:
    """Quantize ``y`` onto a given per-block exponent (GELU forwards the
    input exponent to the output); mantissas clip to [-2^(b-1),
    2^(b-1) - 1]."""
    axis = axis % y.ndim
    scale = repeat_blocks(pow2i(-exponent.to(torch.int32)), block, axis)
    m = torch.clamp(torch.round(y * scale),
                    -(2 ** (mant_bits - 1)), 2 ** (mant_bits - 1) - 1)
    fmt = MXFormat(mant_bits=mant_bits, block_size=block)
    return MXTensor(m.to(fmt.mant_dtype), exponent, axis - y.ndim,
                    mant_bits, block)


def _ordered_sum(v: torch.Tensor, axis: int, block: int) -> torch.Tensor:
    """Sum of f32 ``v`` along ``axis`` (kept at size 1) in the kernels'
    order: blocks of ``block`` elements dealt to 32 lanes, then a
    butterfly (``warp_row_sum``)."""
    vt = v.movedim(axis, -1)
    n = vt.shape[-1]
    s = warp_row_sum(vt.reshape(-1, n // block, block))
    return s.reshape(vt.shape[:-1] + (1,)).movedim(-1, axis)


def _rsqrt_datapath(var: torch.Tensor, lut_bits: int) -> torch.Tensor:
    """Paper Eq. 8-9: 1/sqrt(var) from a mantissa LUT and an exponent
    shift (the kernels' stage; floor division and modulo split the
    exponent); var clamps at one accumulator LSB, 2^-24."""
    lut = lut_tensor(luts.rsqrt_table(lut_bits), var.device)
    return rsqrt_lut_stage(var, lut, lut_bits)


def _lut_act(xf: torch.Tensor, table: tuple, bits: int,
             domain: float) -> torch.Tensor:
    """Eq. 12: x above the domain, 0 below it, the LUT entry of x's bin
    inside."""
    n = 2 ** bits
    idx = torch.floor((xf + domain) * f32(n / (2.0 * domain)))
    y_small = lut_tensor(table, xf.device)[idx.clamp(0, n - 1).long()]
    return torch.where(xf >= domain, xf,
                       torch.where(xf <= -domain, torch.zeros_like(xf),
                                   y_small))


# ---------------------------------------------------------------------------
# LayerNorm (paper §III-B-1)
# ---------------------------------------------------------------------------
def mxint_layernorm(x: MXTensor, gamma: Optional[torch.Tensor],
                    beta: Optional[torch.Tensor], cfg: NonlinearConfig,
                    out_fmt: MXFormat, rms_only: bool = False) -> MXTensor:
    """MXInt LayerNorm over the last axis (Fig. 3).  The shared exponent
    cancels between the centred value and sqrt(Var), so the datapath runs
    on the aligned integer mantissas.  ``rms_only``: RMSNorm, no centring.
    """
    m, _ = requantize_to_max_exponent(x, axis=-1)      # lambda cancels
    mf = m.to(torch.float32)
    d = mf.shape[-1]
    if rms_only:
        centered = mf
    else:
        # integer mantissas: exact in float64, one rounding
        total = mf.double().sum(-1, keepdim=True).float()
        centered = mf - div(total, d)
    var = div(_ordered_sum(centered * centered, -1, x.block_size), d)
    y = centered * _rsqrt_datapath(var, cfg.ln_lut_bits)
    if gamma is not None:
        y = y * gamma
    if beta is not None and not rms_only:
        y = y + beta
    return quantize(y, out_fmt, axis=-1)


# ---------------------------------------------------------------------------
# GELU / SiLU (paper §III-B-2)
# ---------------------------------------------------------------------------
def mxint_gelu(x: MXTensor, cfg: NonlinearConfig,
               out_mant_bits: Optional[int] = None) -> MXTensor:
    """MXInt GELU (Eq. 12 / Fig. 6): ReLU tails outside [-a, a], the LUT
    inside; the input block exponent is forwarded to the output."""
    a = float(cfg.gelu_domain)
    bits = cfg.gelu_index_bits
    y = _lut_act(dequantize(x), luts.gelu_table(bits, a), bits, a)
    return _quantize_with_exponent(y, x.exponent, x.block_size, x.scale_axis,
                                   out_mant_bits or x.mant_bits)


def mxint_silu(x: MXTensor, cfg: NonlinearConfig,
               out_mant_bits: Optional[int] = None) -> MXTensor:
    """SiLU through the same three-piece LUT datapath, over twice GELU's
    domain with one more index bit (SiLU's negative tail decays slower)."""
    a = 2.0 * float(cfg.gelu_domain)
    bits = cfg.gelu_index_bits + 1
    y = _lut_act(dequantize(x), luts.silu_table(bits, a), bits, a)
    return _quantize_with_exponent(y, x.exponent, x.block_size, x.scale_axis,
                                   out_mant_bits or x.mant_bits)


# ---------------------------------------------------------------------------
# Softmax (paper §III-B-3)
# ---------------------------------------------------------------------------
def exp_datapath(z: torch.Tensor, r_bits: int) -> torch.Tensor:
    """e^x ~= 2^n * LUT_pow2(r) for z = x * log2(e) <= 0 (Eq. 14-19), with
    n floored at -126 (the kernels' stage)."""
    lut = lut_tensor(luts.pow2_table(r_bits), z.device)
    return exp2_datapath(z, lut, r_bits)


def mxint_softmax(x: MXTensor, cfg: NonlinearConfig, out_fmt: MXFormat,
                  axis: int = -1) -> MXTensor:
    """MXInt softmax along ``axis``, the block axis: requantize to the max
    exponent, integer max-subtract, z = t * log2(e), 2^n * LUT_pow2(r),
    the Eq. 19 sum, the Eq. 20 divide in (mantissa, exponent) form."""
    m, lam = requantize_to_max_exponent(x, axis=axis)
    t = (m - m.amax(dim=axis, keepdim=True)).to(torch.float32)
    z = t * pow2i(lam) * _LOG2E
    p = exp_datapath(z, cfg.softmax_r_bits)
    s_m, s_e = torch.frexp(_ordered_sum(p, axis, x.block_size))
    y = (p / s_m) * pow2i(-s_e)
    return quantize(y, out_fmt, axis=axis)


# ---------------------------------------------------------------------------
# float in, float out
# ---------------------------------------------------------------------------
def softmax_value(x: torch.Tensor, cfg: NonlinearConfig, act_fmt: MXFormat,
                  out_fmt: Optional[MXFormat] = None,
                  axis: int = -1) -> torch.Tensor:
    xq = quantize(x, act_fmt, axis=axis)
    return dequantize(mxint_softmax(xq, cfg, out_fmt or act_fmt, axis=axis))


def layernorm_value(x: torch.Tensor, gamma, beta, cfg: NonlinearConfig,
                    act_fmt: MXFormat, rms_only: bool = False) -> torch.Tensor:
    xq = quantize(x, act_fmt, axis=-1)
    return dequantize(mxint_layernorm(xq, gamma, beta, cfg, act_fmt,
                                      rms_only=rms_only))


def gelu_value(x: torch.Tensor, cfg: NonlinearConfig,
               act_fmt: MXFormat) -> torch.Tensor:
    return dequantize(mxint_gelu(quantize(x, act_fmt, axis=-1), cfg))


def silu_value(x: torch.Tensor, cfg: NonlinearConfig,
               act_fmt: MXFormat) -> torch.Tensor:
    return dequantize(mxint_silu(quantize(x, act_fmt, axis=-1), cfg))


# ---------------------------------------------------------------------------
# related-work datapaths (Tables II-IV): 8-bit fixed-point emulations
# ---------------------------------------------------------------------------
def _fixed_point_qdq(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Symmetric per-tensor fixed-point quantize-dequantize."""
    lim = 2 ** (bits - 1)
    amax = torch.clamp(x.abs().amax(), min=1e-12)
    scale = div(amax, lim - 1)
    return torch.clamp(torch.round(x / scale), -lim, lim - 1) * scale


def _mean64(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Mean along ``axis`` (kept) in float64, rounded once to float32."""
    return div(x.double().sum(axis, keepdim=True), x.shape[axis]).float()


def fixedpoint_layernorm(x: torch.Tensor, gamma, beta, bits: int = 8,
                         eps: float = 1e-6) -> torch.Tensor:
    """Integer-datapath LayerNorm after Huang et al. [9] / SDA [5]; the
    biased variance."""
    xq = _fixed_point_qdq(x, bits)
    mean = _mean64(xq, -1)
    var = torch.var(xq.double(), dim=-1, keepdim=True, correction=0).float()
    # the IEEE float32 square root (through float64): torch's CPU float32
    # sqrt is not correctly rounded
    y = (xq - mean) / torch.sqrt((var + eps).double()).float()
    if gamma is not None:
        y = y * gamma
    if beta is not None:
        y = y + beta
    return _fixed_point_qdq(y, bits)


def fixedpoint_gelu(x: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Polynomial-erf integer GELU after HeatViT [2] / [9] (Eq. 11), the
    I-BERT second-order erf."""
    xq = _fixed_point_qdq(x, bits)
    a, b, c = -0.2888, -1.769, 1.0
    s = torch.sign(xq)
    xa = torch.clamp(div(xq, f32(2.0 ** 0.5)).abs(), max=-b)
    l_erf = s * (a * (xa + b) ** 2 + c)
    y = xq * 0.5 * (1.0 + l_erf)
    return _fixed_point_qdq(y, bits)


def relu6_gelu(x: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """SDA [5]: GELU approximated as ReLU6."""
    xq = _fixed_point_qdq(x, bits)
    return _fixed_point_qdq(torch.clamp(xq, 0.0, 6.0), bits)


def fixedpoint_softmax(x: torch.Tensor, bits: int = 8,
                       axis: int = -1) -> torch.Tensor:
    """Max-subtract integer softmax after I-ViT [23] / HeatViT [2]:
    z = n + r with r in (-1, 0], 2^r ~= 1 + r / 2."""
    xq = _fixed_point_qdq(x, bits)
    z = (xq - xq.amax(dim=axis, keepdim=True)) * _LOG2E
    n = torch.ceil(z)
    r = z - n
    p = (1.0 + 0.5 * r) * pow2i(n.clamp(min=-126.0).to(torch.int32))
    total = p.double().sum(axis, keepdim=True).float()
    return _fixed_point_qdq(p / total, bits)
