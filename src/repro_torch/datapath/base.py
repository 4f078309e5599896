"""The ``Datapath`` backend protocol.

A datapath answers, for every quantized operator the models emit, where
the op executes and with what numerics.  One stateless backend instance
exists per execution mode, registered in ``repro_torch.datapath`` and
resolved once per config through ``QuantConfig.datapath``; the model
layers are thin forwarding wrappers over these methods and never branch
on the mode themselves.

The base class carries the float reference implementations.  Composite
hooks are ``None`` here and a bound method on backends that provide them;
a provided composite must be bit-identical to the op sequence it replaces.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.quantize import MXTensor, dequantize


class Datapath:
    """Execution backend for the quantized-op protocol.

    quantized_nonlinear: this backend can run the MXInt non-linear
      datapaths (``nl_on`` consults it).
    layernorm_linear: composite hook, LayerNorm/RMSNorm followed by a
      quantized linear with the normalized tile kept on chip; must equal
      ``linear(layernorm(x), w, b)`` bit for bit.
    """

    name: str = "base"
    quantized_nonlinear: bool = False

    layernorm_linear = None

    def nl_on(self, q, op: str) -> bool:
        """Does ``op`` run the MXInt non-linear datapath under ``q``?"""
        return (q.enabled and q.quantize_nonlinear and
                self.quantized_nonlinear and op in q.nl_ops)

    def fuses_norm_linear(self, q, x=None, w=None) -> bool:
        """Will ``layernorm_linear`` fuse for this call?  When False,
        callers feeding several linears from one norm normalize once."""
        return False

    # -- weights -------------------------------------------------------------
    def weight_value(self, wv, *, q, dtype) -> torch.Tensor:
        """A weight leaf as float: packed ``MXTensor`` planes dequantized,
        a float tensor cast (the dequantize seam of embed and unembed)."""
        if isinstance(wv, MXTensor):
            return dequantize(wv, dtype=dtype)
        return wv.to(dtype)

    # -- linears ------------------------------------------------------------
    def linear(self, x: torch.Tensor, w, b=None, *, q) -> torch.Tensor:
        """y = x @ w (+ b); w/b are Params, w may hold packed planes."""
        raise NotImplementedError

    # -- norms --------------------------------------------------------------
    @staticmethod
    def _float_layernorm(x, gamma, beta, eps):
        xf = x.to(torch.float32)
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        return (y * gamma.value + beta.value).to(x.dtype)

    @staticmethod
    def _float_rmsnorm(x, gamma, eps):
        xf = x.to(torch.float32)
        y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
        return (y * gamma.value).to(x.dtype)

    def layernorm(self, x, gamma, beta, *, q, eps: float = 1e-6):
        return self._float_layernorm(x, gamma, beta, eps)

    def rmsnorm(self, x, gamma, *, q, eps: float = 1e-6):
        return self._float_rmsnorm(x, gamma, eps)

    # -- activations / softmax ----------------------------------------------
    def act(self, x, kind: str, *, q):
        return {"gelu": F.gelu, "silu": F.silu}[kind](x)

    def softmax(self, x, *, q, axis: int = -1):
        return torch.softmax(x, dim=axis)

    # -- attention ----------------------------------------------------------
    def attention(self, qv, k, v, *, q, positions, causal: bool, window: int,
                  scale: float, chunk: int):
        """Cache-less attention core.  qv: (b, s, kv, g, hd); k/v: (b, S,
        kv, hd).  Returns (b, s, kv, g, hd)."""
        raise NotImplementedError

    def attention_decode(self, qv, ck, cv, valid, *, q, scale: float):
        """Single-position decode over a cache ring.  qv: (b, 1, kv, g,
        hd); ck/cv: (b, W, kv, hd); valid: (b, W) per-row ring validity.
        Returns qv's shape."""
        raise NotImplementedError
