"""The ``Datapath`` backend protocol.

A datapath answers, for every quantized operator the models emit, where
the op executes and with what numerics.  One stateless backend instance
exists per execution mode, registered in ``repro_torch.datapath`` and
resolved once per config through ``QuantConfig.datapath``; the model
layers are thin forwarding wrappers over these methods and never branch
on the mode themselves.

The base class carries the float implementations and the attention
orchestration the float and sim backends share.  Float products, sums
and transcendentals run in float64 and round once to float32 (then to the
model dtype), so every device gives the same bits unless the exact value
lies within about 2^-29 of a float32 rounding boundary.  Composite hooks
are ``None`` here and a bound method on backends that provide them; a
provided composite must be bit-identical to the op sequence it replaces.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.quantize import (MXTensor, dequantize, div, fake_quant,
                                       fp8_e4m3_qdq, per_tensor_int_qdq)


def _via64(fn, x: torch.Tensor, *args, **kw) -> torch.Tensor:
    """``fn`` on x in float64, rounded once to float32, then x's dtype."""
    return fn(x.double(), *args, **kw).float().to(x.dtype)


class Datapath:
    """Execution backend for the quantized-op protocol.

    quantized_nonlinear: this backend can run the MXInt non-linear
      datapaths (``nl_on`` consults it).
    qdq_linears: the float weights and activations of linears pass
      through the quantize-dequantize grid ("fake", "sim"; "packed" and
      "kernel" consume packed planes, "off" is plain float).
    layernorm_linear: composite hook, LayerNorm/RMSNorm followed by a
      quantized linear with the normalized tile kept on chip; must equal
      ``linear(layernorm(x), w, b)`` bit for bit.
    """

    name: str = "base"
    quantized_nonlinear: bool = False
    qdq_linears: bool = False

    layernorm_linear = None

    def nl_on(self, q, op: str) -> bool:
        """Does ``op`` run the MXInt non-linear datapath under ``q``?"""
        return (q.enabled and q.quantize_nonlinear and
                self.quantized_nonlinear and op in q.nl_ops)

    def fuses_norm_linear(self, q, x=None, w=None) -> bool:
        """Will ``layernorm_linear`` fuse for this call?  When False,
        callers feeding several linears from one norm normalize once."""
        return False

    # -- weights and linears -------------------------------------------------
    def qdq_weight(self, w: torch.Tensor, *, q) -> torch.Tensor:
        """A float weight on this backend's weight grid (blocks along the
        contraction axis 0; identity unless ``qdq_linears``)."""
        if not self.qdq_linears:
            return w
        if q.emulate == "int":
            return per_tensor_int_qdq(w, q.weight_fmt.mant_bits)
        if q.emulate == "fp8":
            return fp8_e4m3_qdq(w)
        return fake_quant(w, q.weight_fmt.mant_bits, q.weight_fmt.block_size,
                          0)

    def qdq_act(self, x: torch.Tensor, *, q) -> torch.Tensor:
        """Activations on the act grid (identity unless ``qdq_linears``)."""
        if not self.qdq_linears:
            return x
        if q.emulate == "int":
            return per_tensor_int_qdq(x, q.act_fmt.mant_bits)
        if q.emulate == "fp8":
            return fp8_e4m3_qdq(x)
        return fake_quant(x, q.act_fmt.mant_bits, q.act_fmt.block_size, -1)

    def weight_value(self, wv, *, q, dtype) -> torch.Tensor:
        """A weight leaf as float: packed ``MXTensor`` planes dequantized,
        a float tensor through ``qdq_weight`` (the seam of embed and
        unembed)."""
        if isinstance(wv, MXTensor):
            return dequantize(wv, dtype=dtype)
        return self.qdq_weight(wv, q=q).to(dtype)

    def linear(self, x: torch.Tensor, w, b=None, *, q) -> torch.Tensor:
        """y = x @ w (+ b); w/b are Params, w may hold packed planes."""
        wf = self.weight_value(w.value, q=q, dtype=x.dtype)
        xf = self.qdq_act(x, q=q)
        y = torch.matmul(xf.double(), wf.double()).float().to(x.dtype)
        if b is not None:
            y = y + b.value.to(y.dtype)
        return y

    # -- norms --------------------------------------------------------------
    @staticmethod
    def _float_layernorm(x, gamma, beta, eps):
        xf = x.double()
        mu = div(xf.sum(-1, keepdim=True), xf.shape[-1])
        var = div(((xf - mu) ** 2).sum(-1, keepdim=True), xf.shape[-1])
        y = ((xf - mu) * torch.rsqrt(var + eps)).float()
        return (y * gamma.value + beta.value).to(x.dtype)

    @staticmethod
    def _float_rmsnorm(x, gamma, eps):
        xf = x.double()
        ms = div((xf * xf).sum(-1, keepdim=True), xf.shape[-1])
        y = (xf * torch.rsqrt(ms + eps)).float()
        return (y * gamma.value).to(x.dtype)

    def layernorm(self, x, gamma, beta, *, q, eps: float = 1e-6):
        return self._float_layernorm(x, gamma, beta, eps)

    def rmsnorm(self, x, gamma, *, q, eps: float = 1e-6):
        return self._float_rmsnorm(x, gamma, eps)

    # -- activations / softmax / exp ----------------------------------------
    def act(self, x, kind: str, *, q):
        return _via64({"gelu": F.gelu, "silu": F.silu}[kind], x)

    def softmax(self, x, *, q, axis: int = -1):
        return _via64(torch.softmax, x, dim=axis)

    def exp(self, x, *, q):
        """e^x for scalar gate datapaths."""
        return _via64(torch.exp, x)

    # -- attention ----------------------------------------------------------
    def _attention_use_direct(self, q, s: int, kv_len: int) -> bool:
        return s * kv_len <= 512 * 512

    def attention(self, qv, k, v, *, q, positions, causal: bool, window: int,
                  scale: float, chunk: int):
        """Cache-less attention core.  qv: (b, s, kv, g, hd); k/v: (b, S,
        kv, hd); positions (1|b, s).  Returns (b, s, kv, g, hd): the
        masked softmax of the whole score matrix up to 512 x 512 scores,
        query blocks beyond, each row masked from its own positions."""
        from repro_torch.models import attention as A
        s, kv_len = qv.shape[1], k.shape[1]
        if self._attention_use_direct(q, s, kv_len):
            mask = A.positions_mask(positions, s, kv_len, causal, window)
            return A._direct_attention(qv, k, v, mask[:, None, None], q,
                                       scale)
        return A._q_chunked_attention(qv, k, v, causal=causal, window=window,
                                      chunk=chunk, scale=scale,
                                      positions=positions)

    def attention_decode(self, qv, ck, cv, valid, *, q, scale: float):
        """Single-position decode over a cache ring: the ring's scores
        through this backend's softmax.  qv: (b, 1, kv, g, hd); ck/cv:
        (b, W, kv, hd); valid: (b, W) per-row ring validity (a (W,)
        vector broadcasts).  Returns qv's shape."""
        from repro_torch.models import attention as A
        v2 = valid if valid.ndim == 2 else valid[None]
        mask = v2[:, None, None, None, :]
        return A._direct_attention(qv, ck.to(qv.dtype), cv.to(qv.dtype), mask,
                                   q, scale)
