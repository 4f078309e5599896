"""``mxint_sim`` backend: the "sim" and "packed" execution modes.

Counterpart of ``repro.datapath.mxint_sim``: the bit-accurate emulation of
the paper's MXInt datapaths, the oracle the kernels are held against.
Linears quantize-dequantize their weights and activations in "sim" (equal
to the integer datapath: products of mantissas of at most 8 bits are
exact and the float64 accumulation is lossless at these sizes) or
dequantize pre-packed ``MXTensor`` planes in "packed".  When
``quantize_nonlinear`` routes an op here, LayerNorm, softmax and GELU/SiLU
run the ``core.nonlinear`` datapaths; ``emulate`` and ``nl_emulate`` swap
in the Tables II-V baselines.
"""
from __future__ import annotations

import torch

from repro_torch.core import nonlinear as nl
from repro_torch.core.quantize import div
from repro_torch.datapath.base import Datapath


class MXIntSimDatapath(Datapath):
    name = "mxint_sim"
    quantized_nonlinear = True

    def __init__(self, qdq_linears: bool):
        self.qdq_linears = qdq_linears

    def nl_emulate(self, q, op: str):
        """The active Tables II-IV baseline for ``op``, or None (MXInt)."""
        return q.nl_emulate if self.nl_on(q, op) else None

    # -- norms ---------------------------------------------------------------
    def rmsnorm(self, x, gamma, *, q, eps: float = 1e-6):
        if self.nl_emulate(q, "layernorm") == "fixedpoint":
            # the 8-bit fixed-point RMS variant of the [9] / SDA datapath
            xf = nl._fixed_point_qdq(x.to(torch.float32), 8)
            ms = div((xf.double() * xf.double()).sum(-1, keepdim=True),
                     xf.shape[-1])
            y = xf * torch.rsqrt(ms + eps).float()
            return (nl._fixed_point_qdq(y, 8) * gamma.value).to(x.dtype)
        if self.nl_on(q, "layernorm"):
            y = nl.layernorm_value(x.to(torch.float32), gamma.value, None,
                                   q.nonlinear, q.act_fmt, rms_only=True)
            return y.to(x.dtype)
        return self._float_rmsnorm(x, gamma, eps)

    def layernorm(self, x, gamma, beta, *, q, eps: float = 1e-6):
        if self.nl_emulate(q, "layernorm") == "fixedpoint":
            y = nl.fixedpoint_layernorm(x.to(torch.float32), gamma.value,
                                        beta.value, bits=8, eps=eps)
            return y.to(x.dtype)
        if self.nl_on(q, "layernorm"):
            y = nl.layernorm_value(x.to(torch.float32), gamma.value,
                                   beta.value, q.nonlinear, q.act_fmt)
            return y.to(x.dtype)
        return self._float_layernorm(x, gamma, beta, eps)

    # -- activations / softmax / exp -----------------------------------------
    def act(self, x, kind: str, *, q):
        em = self.nl_emulate(q, "gelu")
        if em == "fixedpoint":
            return nl.fixedpoint_gelu(x.to(torch.float32)).to(x.dtype)
        if em == "relu6":
            return nl.relu6_gelu(x.to(torch.float32)).to(x.dtype)
        if self.nl_on(q, "gelu"):
            f = {"gelu": nl.gelu_value, "silu": nl.silu_value}[kind]
            return f(x.to(torch.float32), q.nonlinear, q.act_fmt).to(x.dtype)
        return super().act(x, kind, q=q)

    def softmax(self, x, *, q, axis: int = -1):
        if self.nl_emulate(q, "softmax") in ("fixedpoint", "relu6"):
            return nl.fixedpoint_softmax(x.to(torch.float32),
                                         axis=axis).to(x.dtype)
        if self.nl_on(q, "softmax"):
            y = nl.softmax_value(x.to(torch.float32), q.nonlinear, q.act_fmt,
                                 axis=axis)
            return y.to(x.dtype)
        return super().softmax(x, q=q, axis=axis)

    def exp(self, x, *, q):
        """The exp gate through the Eq. 14-19 pow2 datapath when softmax
        runs the MXInt LUTs."""
        if self.nl_on(q, "softmax"):
            return nl.exp_datapath(x * nl._LOG2E, q.nonlinear.softmax_r_bits)
        return super().exp(x, q=q)

    # -- attention -----------------------------------------------------------
    def _attention_use_direct(self, q, s: int, kv_len: int) -> bool:
        # the MXInt softmax datapath computes whole rows: always direct
        # when the non-linears are quantized
        return q.quantize_nonlinear or s * kv_len <= 512 * 512
