"""Shape plumbing around the MXInt kernels.

Counterpart of ``repro.kernels.ops`` for the kernels this port has: the
wrappers flatten leading dims into rows, resolve block sizes exactly as
``repro.core.quantize._resolve_block`` does, call the kernel op and add
any bias after it.  The kernels take every DeiT shape as it is (ragged
rows, N = 1000, K = 192, 197-length rows), so nothing is padded.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.quantize import _resolve_block
from repro_torch.kernels.mxint_gelu import mxint_gelu
from repro_torch.kernels.mxint_layernorm import f32, mxint_layernorm
from repro_torch.kernels.mxint_ln_matmul import mxint_ln_matmul
from repro_torch.kernels.mxint_matmul import mxint_matmul
from repro_torch.kernels.mxint_softmax import mxint_softmax

# the whole-row 'paper' attention holds the full score matrix; beyond this
# many scores per (batch, head) the reference switches to its blocked
# flash kernel, which the LM slice of the port brings
PAPER_MAX_SCORES = 512 * 512


def _flatten_rows(x: torch.Tensor):
    return x.reshape(-1, x.shape[-1]).contiguous(), x.shape[:-1]


def mxint_linear(x: torch.Tensor, w_mant: torch.Tensor, w_exp: torch.Tensor,
                 bias: Optional[torch.Tensor] = None, *, w_block: int,
                 act_block: int = 16, act_mant_bits: int = 8) -> torch.Tensor:
    """y = Q_act(x) @ W_mx (+ bias) for any leading dims of x (..., K)."""
    x2, lead = _flatten_rows(x.to(torch.float32))
    K = x2.shape[1]
    y = mxint_matmul(x2, w_mant, w_exp, w_block=w_block,
                     act_block=_resolve_block(K, act_block),
                     act_mant_bits=act_mant_bits)
    if bias is not None:
        y = y + bias
    return y.reshape(*lead, y.shape[-1]).to(x.dtype)


def mxint_layernorm_op(x: torch.Tensor, gamma: torch.Tensor,
                       beta: Optional[torch.Tensor] = None, *,
                       act_block: int = 16, mant_bits: int = 8,
                       lut_bits: int = 5, rms_only: bool = False,
                       quantize_out: bool = False) -> torch.Tensor:
    """MXInt LayerNorm/RMSNorm over the last axis (paper Fig. 3)."""
    x2, lead = _flatten_rows(x.to(torch.float32))
    y = mxint_layernorm(x2, gamma, beta,
                        act_block=_resolve_block(x.shape[-1], act_block),
                        mant_bits=mant_bits, lut_bits=lut_bits,
                        rms_only=rms_only, quantize_out=quantize_out)
    return y.reshape(x.shape)


def mxint_ln_linear_op(x: torch.Tensor, gamma: torch.Tensor,
                       beta: Optional[torch.Tensor], w_mant: torch.Tensor,
                       w_exp: torch.Tensor,
                       bias: Optional[torch.Tensor] = None, *, w_block: int,
                       act_block: int = 16, mant_bits: int = 8,
                       lut_bits: int = 5,
                       rms_only: bool = False) -> torch.Tensor:
    """Fused MXInt LayerNorm/RMSNorm -> linear (+ bias), any leading dims.
    Bit-identical to ``mxint_layernorm_op(quantize_out=True)`` followed by
    ``mxint_linear``."""
    x2, lead = _flatten_rows(x)
    K = x2.shape[1]
    y = mxint_ln_matmul(x2, gamma, beta, w_mant, w_exp, w_block=w_block,
                        act_block=_resolve_block(K, act_block),
                        mant_bits=mant_bits, lut_bits=lut_bits,
                        rms_only=rms_only)
    if bias is not None:
        y = y + bias
    return y.reshape(*lead, y.shape[-1]).to(x.dtype)


def mxint_softmax_op(x: torch.Tensor, *, act_block: int = 16,
                     mant_bits: int = 8, r_bits: int = 2,
                     quantize_out: bool = False) -> torch.Tensor:
    """Whole-row MXInt softmax over the last axis (paper Eq. 14-20)."""
    x2, _ = _flatten_rows(x.to(torch.float32))
    y = mxint_softmax(x2, act_block=_resolve_block(x.shape[-1], act_block),
                      mant_bits=mant_bits, r_bits=r_bits,
                      quantize_out=quantize_out)
    return y.reshape(x.shape)


def mxint_gelu_op(x: torch.Tensor, *, fn: str = "gelu", act_block: int = 16,
                  mant_bits: int = 8, lut_bits: int = 5,
                  domain: float = 3.0) -> torch.Tensor:
    """Elementwise MXInt GELU/SiLU through the LUT datapath (Eq. 12)."""
    x2, _ = _flatten_rows(x.to(torch.float32))
    y = mxint_gelu(x2, act_block=_resolve_block(x.shape[-1], act_block),
                   mant_bits=mant_bits, lut_bits=lut_bits, domain=domain,
                   fn=fn)
    return y.reshape(x.shape)


def attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 act_block: int = 16, mant_bits: int = 8,
                 r_bits: int = 2) -> torch.Tensor:
    """(B, H, S, D) unmasked attention, the whole-row 'paper' variant.

    The score and P.V products stay ``torch.matmul`` (the reference leaves
    them to XLA outside any Pallas kernel); the Eq. 14-20 softmax runs in
    the softmax kernel, probabilities quantized on the act grid.  K and V
    may carry fewer heads than q (GQA, laid out KV-major); the group folds
    into query rows, so K/V are never copied per query head.
    """
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    groups = h // hkv
    if sq * sk > PAPER_MAX_SCORES:
        raise NotImplementedError(
            "score matrices beyond 512x512 need the blocked flash attention "
            "kernel, which comes with the LM slice of the port")
    qf = q.reshape(b * hkv, groups * sq, d).to(torch.float32)
    kf = k.reshape(b * hkv, sk, d).to(torch.float32)
    vf = v.reshape(b * hkv, sk, d).to(torch.float32)
    s = torch.matmul(qf, kf.transpose(1, 2)) * f32(d ** -0.5)
    p = mxint_softmax_op(s, act_block=act_block, mant_bits=mant_bits,
                         r_bits=r_bits, quantize_out=True)
    o = torch.matmul(p, vf)
    return o.to(q.dtype).reshape(b, h, sq, d)
