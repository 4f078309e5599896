"""``hopper_kernel`` backend: the "kernel" execution mode on Hopper.

Counterpart of ``repro.datapath.pallas_kernel``.  Linears feed packed int8
mantissa/exponent planes straight into ``mxint_linear`` (no dequantize:
device-memory traffic is the quantized bytes); with ``quantize_nonlinear``
the non-linear ops run the in-kernel MXInt datapaths, and LayerNorm fuses
into the consuming linear through ``layernorm_linear``.  Serving only:
nothing here carries a gradient.

Planes marked by ``parallel.sharding.tp_shard_packed_params`` are this
rank's shard: the linear runs on them and adds the collective of their
``tp_mode`` over the ambient mesh's ``tp_axis`` group
(``launch.mesh.mesh_context``).  A plane sharded along its contraction
axis ('psum') is never fused with the norm, which needs the whole row:
the norm runs first (``mxint_layernorm``), then ``mxint_matmul``.
"""
from __future__ import annotations

import torch

from repro_torch.core import nonlinear as nl
from repro_torch.core.quantize import MXTensor, pack_weight
from repro_torch.datapath.base import Datapath
from repro_torch.kernels import ops
from repro_torch.launch.mesh import axis_group


class HopperKernelDatapath(Datapath):
    name = "hopper_kernel"
    quantized_nonlinear = True

    # -- linears -------------------------------------------------------------
    @staticmethod
    def _packed(wv, q) -> MXTensor:
        if isinstance(wv, MXTensor):
            return wv
        return pack_weight(wv.to(torch.float32), q.weight_fmt, axis=0)

    @staticmethod
    def _bias(b):
        return None if b is None else b.value.to(torch.float32)

    @staticmethod
    def _tp(wv: MXTensor) -> dict:
        """The collective arguments of a (possibly sharded) plane."""
        if wv.tp_axis is None:
            return {}
        return dict(tp_group=axis_group(wv.tp_axis), tp_mode=wv.tp_mode)

    def linear(self, x, w, b=None, *, q):
        return self._linear_planes(x, self._packed(w.value, q), b, q)

    def _linear_planes(self, x, wv: MXTensor, b, q):
        return ops.mxint_linear(x, wv.mantissa, wv.exponent, self._bias(b),
                                w_block=wv.block_size, quantize_act=True,
                                act_block=q.act_fmt.block_size,
                                act_mant_bits=q.act_fmt.mant_bits,
                                **self._tp(wv))

    # -- norms ---------------------------------------------------------------
    def rmsnorm(self, x, gamma, *, q, eps: float = 1e-6):
        if not self.nl_on(q, "layernorm"):
            return self._float_rmsnorm(x, gamma, eps)
        y = ops.mxint_layernorm_op(
            x, gamma.value, None, act_block=q.act_fmt.block_size,
            mant_bits=q.act_fmt.mant_bits, lut_bits=q.nonlinear.ln_lut_bits,
            rms_only=True, quantize_out=True)
        return y.to(x.dtype)

    def layernorm(self, x, gamma, beta, *, q, eps: float = 1e-6):
        if not self.nl_on(q, "layernorm"):
            return self._float_layernorm(x, gamma, beta, eps)
        y = ops.mxint_layernorm_op(
            x, gamma.value, beta.value, act_block=q.act_fmt.block_size,
            mant_bits=q.act_fmt.mant_bits, lut_bits=q.nonlinear.ln_lut_bits,
            quantize_out=True)
        return y.to(x.dtype)

    # -- fused LN -> linear composite ----------------------------------------
    def fuses_norm_linear(self, q, x=None, w=None) -> bool:
        """The fused kernel needs the MXInt LN datapath and planes that
        are not sharded along their contraction axis (the LN normalizes
        the whole row); it takes any shape.  Callers hoist the norm when
        this says False."""
        if not self.nl_on(q, "layernorm"):
            return False
        return not (w is not None and isinstance(w.value, MXTensor)
                    and w.value.tp_mode == "psum")

    def layernorm_linear(self, x, gamma, beta, w, b=None, *, q,
                         eps: float = 1e-6, rms_only: bool = False):
        """Fused norm + quantized matmul; bit-identical to the norm
        followed by ``linear``, which it runs instead for a float norm or
        a 'psum'-sharded plane."""
        wv = self._packed(w.value, q)
        if not self.nl_on(q, "layernorm") or wv.tp_mode == "psum":
            h = (self.rmsnorm(x, gamma, q=q, eps=eps) if rms_only
                 else self.layernorm(x, gamma, beta, q=q, eps=eps))
            return self._linear_planes(h, wv, b, q)
        return ops.mxint_ln_linear_op(
            x, gamma.value, None if beta is None else beta.value,
            wv.mantissa, wv.exponent, self._bias(b), w_block=wv.block_size,
            act_block=q.act_fmt.block_size, mant_bits=q.act_fmt.mant_bits,
            lut_bits=q.nonlinear.ln_lut_bits, rms_only=rms_only,
            **self._tp(wv))

    # -- activations / softmax -----------------------------------------------
    def act(self, x, kind: str, *, q):
        if not self.nl_on(q, "gelu"):
            return super().act(x, kind, q=q)
        cfg = q.nonlinear
        y = ops.mxint_gelu_op(x, fn=kind, act_block=q.act_fmt.block_size,
                              mant_bits=q.act_fmt.mant_bits,
                              lut_bits=cfg.gelu_lut_bits,
                              domain=cfg.gelu_domain)
        return y.to(x.dtype)

    def softmax(self, x, *, q, axis: int = -1):
        if not self.nl_on(q, "softmax"):
            return super().softmax(x, q=q, axis=axis)
        if axis not in (-1, x.ndim - 1):
            # the whole-row kernel reduces the last axis; along another
            # axis the op is the sim datapath, as in the reference
            y = nl.softmax_value(x.to(torch.float32), q.nonlinear, q.act_fmt,
                                 axis=axis)
            return y.to(x.dtype)
        y = ops.mxint_softmax_op(x, act_block=q.act_fmt.block_size,
                                 mant_bits=q.act_fmt.mant_bits,
                                 r_bits=q.nonlinear.softmax_r_bits,
                                 quantize_out=True)
        return y.to(x.dtype)

    # -- attention -----------------------------------------------------------
    def attention(self, qv, k, v, *, q, positions, causal: bool, window: int,
                  scale: float, chunk: int):
        """Heads-major attention through the kernels: the whole-row MXInt
        softmax ('paper') while a (batch, head) holds at most 512x512
        scores, the online MXInt flash kernel beyond that, the float flash
        kernel without the MXInt softmax.  Query positions are the row
        indices, as in the reference's kernel path."""
        b, s, kvh, g, hd = qv.shape
        S = k.shape[1]
        qh = qv.permute(0, 2, 3, 1, 4).reshape(b, kvh * g, s, hd)
        kh = k.permute(0, 2, 1, 3)
        vh = v.permute(0, 2, 1, 3)
        if self.nl_on(q, "softmax"):
            cfg = dict(causal=causal, window=window,
                       act_block=q.act_fmt.block_size,
                       mant_bits=q.act_fmt.mant_bits,
                       r_bits=q.nonlinear.softmax_r_bits)
            if s * S <= ops.PAPER_MAX_SCORES:
                o = ops.attention_op(qh, kh, vh, softmax_variant="paper",
                                     **cfg)
            else:
                o = ops.attention_op(qh, kh, vh, softmax_variant="online",
                                     exp_mode="mxint", quantize_scores=True,
                                     **cfg)
        else:
            o = ops.attention_op(qh, kh, vh, causal=causal, window=window,
                                 exp_mode="float")
        return o.reshape(b, kvh, g, s, hd).permute(0, 3, 1, 2, 4)

    def attention_decode(self, qv, ck, cv, valid, *, q, scale: float):
        """One fused kernel over the ring: scores, the online (optionally
        Eq. 14-20 quantized) softmax and P.V.  The G query heads of a KV
        head are the kernel's rows; the cache goes in untransposed."""
        qd = qv[:, 0]                                  # (b, kv, g, hd)
        kd = ck.to(qv.dtype)
        vd = cv.to(qv.dtype)
        if self.nl_on(q, "softmax"):
            od = ops.attention_decode_op(
                qd, kd, vd, valid, exp_mode="mxint",
                r_bits=q.nonlinear.softmax_r_bits, quantize_scores=True,
                act_block=q.act_fmt.block_size,
                mant_bits=q.act_fmt.mant_bits)
        else:
            od = ops.attention_decode_op(qd, kd, vd, valid)
        return od[:, None]                             # (b, 1, kv, g, hd)
