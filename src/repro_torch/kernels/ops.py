"""Shape plumbing around the MXInt kernels.

Counterpart of ``repro.kernels.ops`` for the kernels this port has: the
wrappers flatten leading dims into rows, resolve block sizes exactly as
``repro.core.quantize._resolve_block`` does, call the kernel op and add
any bias after it.  The kernels take every shape as it is (ragged rows,
N = 1000, K = 192, 197-length rows, key counts that are not a multiple
of the flash tile), so nothing is padded in memory.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.core.mx_types import NEG_INF
from repro_torch.core.quantize import _resolve_block
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import mxint_gelu as _gelu
from repro_torch.kernels import launch_fixture as _fixture
from repro_torch.kernels import mxint_layernorm as _layernorm
from repro_torch.kernels import mxint_ln_matmul as _ln_matmul
from repro_torch.kernels import mxint_matmul as _matmul
from repro_torch.kernels import mxint_softmax as _softmax
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_decode)
from repro_torch.kernels.launch_fixture import launch_fixture
from repro_torch.kernels.mxint_gelu import mxint_gelu
from repro_torch.kernels.mxint_layernorm import f32, mxint_layernorm
from repro_torch.kernels.mxint_ln_matmul import mxint_ln_matmul
from repro_torch.kernels.mxint_matmul import mxint_matmul
from repro_torch.kernels.mxint_softmax import mxint_softmax
from repro_torch.parallel import collectives

# kernel name -> (its module, the module's launch counter)
LAUNCH_COUNTERS = {"mxint_matmul": (_matmul, "launches"),
                   "mxint_ln_matmul": (_ln_matmul, "launches"),
                   "mxint_softmax": (_softmax, "launches"),
                   "mxint_gelu": (_gelu, "launches"),
                   "mxint_layernorm": (_layernorm, "launches"),
                   "flash_attention": (_flash, "launches"),
                   "flash_attention_decode": (_flash, "decode_launches"),
                   "launch_fixture": (_fixture, "launches")}
# the kernels a model runs (the launch fixture serves the static checks)
SERVED_KERNELS = tuple(n for n in LAUNCH_COUNTERS if n != "launch_fixture")
# route name -> (its module, the route's own launch counter): the generic
# routes' launches, each also counted in its kernel's LAUNCH_COUNTERS
ROUTE_COUNTERS = {"mxint_matmul/generic": (_matmul, "generic_launches"),
                  "mxint_ln_matmul/generic": (_ln_matmul, "generic_launches"),
                  "mxint_softmax/generic": (_softmax, "generic_launches"),
                  "mxint_gelu/generic": (_gelu, "generic_launches"),
                  "mxint_layernorm/generic": (_layernorm, "generic_launches"),
                  "flash_attention/generic": (_flash, "generic_launches"),
                  "flash_attention_decode/generic": (
                      _flash, "generic_decode_launches")}

# the whole-row 'paper' attention holds the full score matrix; beyond this
# many scores per (batch, head) the backend takes the blocked flash kernel
PAPER_MAX_SCORES = 512 * 512


def launch_counts() -> Dict[str, int]:
    """Kernel name -> CUDA launches so far (the plain versions launch
    nothing)."""
    return {n: getattr(m, a) for n, (m, a) in LAUNCH_COUNTERS.items()}


def route_counts() -> Dict[str, int]:
    """Route name -> CUDA launches of the generic routes so far."""
    return {n: getattr(m, a) for n, (m, a) in ROUTE_COUNTERS.items()}


def _flatten_rows(x: torch.Tensor):
    return x.reshape(-1, x.shape[-1]).contiguous(), x.shape[:-1]


def _tp_collective(y: torch.Tensor, tp_group, tp_mode) -> torch.Tensor:
    """The collective of a sharded linear's output, before its bias."""
    if tp_mode == "gather":
        return collectives.all_gather_cat(y, tp_group, dim=1)
    if tp_mode == "psum":
        return collectives.all_reduce_sum(y, tp_group)
    raise ValueError(f"unknown tp_mode {tp_mode!r}")


def mxint_linear(x: torch.Tensor, w_mant: torch.Tensor, w_exp: torch.Tensor,
                 bias: Optional[torch.Tensor] = None, *, w_block: int,
                 quantize_act: bool = False, act_block: int = 16,
                 act_mant_bits: int = 8, tp_group=None,
                 tp_mode: Optional[str] = None) -> torch.Tensor:
    """y = Q_act(x) @ W_mx (+ bias) for any leading dims of x (..., K);
    with ``quantize_act=False`` (the reference's default; every port
    caller passes it) x @ W_mx in float64 products, rounded once.

    tp_group / tp_mode: with a process group, the planes are this rank's
    shard.  'gather': the planes are a slice of the N columns; the rank
    contracts the whole K and the slices are gathered in rank order, so
    the result is the single-device one bit for bit.  'psum': the planes
    are a slice of the K rows; ``x`` comes whole, is cut to the rank's K
    rows, and the partial products are summed over the group (two sums
    added, not one: close to the single-device result, not equal).  The
    bias is added after the collective, to the whole row."""
    x2, lead = _flatten_rows(x.to(torch.float32))
    if tp_group is not None and tp_mode == "psum":
        k_local = w_mant.shape[0]
        r = dist.get_rank(tp_group)
        x2 = x2[:, r * k_local:(r + 1) * k_local].contiguous()
    K = x2.shape[1]
    y = mxint_matmul(x2, w_mant, w_exp, w_block=w_block,
                     act_block=_resolve_block(K, act_block),
                     act_mant_bits=act_mant_bits, quantize_act=quantize_act)
    if tp_group is not None:
        y = _tp_collective(y, tp_group, tp_mode)
    if bias is not None:
        y = y + bias
    return y.reshape(*lead, y.shape[-1]).to(x.dtype)


def mxint_layernorm_op(x: torch.Tensor, gamma: torch.Tensor,
                       beta: Optional[torch.Tensor] = None, *,
                       act_block: int = 16, mant_bits: int = 8,
                       lut_bits: int = 5, rms_only: bool = False,
                       quantize_out: bool = False) -> torch.Tensor:
    """MXInt LayerNorm/RMSNorm over the last axis (paper Fig. 3); f32 out.
    The kernel takes f32 and bf16 rows as they come."""
    x2, lead = _flatten_rows(x)
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
                       lut_bits: int = 5, rms_only: bool = False,
                       tp_group=None,
                       tp_mode: Optional[str] = None) -> torch.Tensor:
    """Fused MXInt LayerNorm/RMSNorm -> linear (+ bias), any leading dims.
    Bit-identical to ``mxint_layernorm_op(quantize_out=True)`` followed by
    ``mxint_linear``.  Sharded only by columns (``tp_mode='gather'``): the
    LN needs the whole row, which a K-sharded plane never sees, so the
    datapath runs those as the norm then ``mxint_linear``."""
    if tp_mode not in (None, "gather") or \
            (tp_group is not None and tp_mode is None):
        raise ValueError(f"the fused norm -> linear shards only with "
                         f"tp_mode='gather', got tp_mode={tp_mode!r}")
    x2, lead = _flatten_rows(x)
    K = x2.shape[1]
    y = mxint_ln_matmul(x2, gamma, beta, w_mant, w_exp, w_block=w_block,
                        act_block=_resolve_block(K, act_block),
                        mant_bits=mant_bits, lut_bits=lut_bits,
                        rms_only=rms_only)
    if tp_group is not None:
        y = _tp_collective(y, tp_group, tp_mode)
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


def _paper_softmax_attention(qf, kf, vf, *, causal: bool, window: int,
                             act_block: int, mant_bits: int, r_bits: int,
                             groups: int) -> torch.Tensor:
    """Whole-row attention: the score and P.V products stay outside the
    kernels (the reference leaves them to XLA outside any Pallas kernel)
    and the Eq. 14-20 softmax runs in the softmax kernel.  Both products
    are computed in float64 and rounded once to float32, so they do not
    depend on the device's summation order; around them the reference's
    order holds: the rounded product times the float32 scale, then the
    mask, and the kernel's quantized P into P.V.  qf: (b*kv, g*sq, d)
    with the g query heads of a KV head as group-major rows, so the query
    position of row i is i % sq."""
    gsq, d = qf.shape[1], qf.shape[2]
    sq, sk = gsq // groups, kf.shape[1]
    s = torch.matmul(qf.double(), kf.double().transpose(1, 2)).float() \
        * f32(d ** -0.5)
    masked = bool(causal or window > 0)
    if masked:
        q_pos = (torch.arange(gsq, device=qf.device) % sq)[:, None]
        k_pos = torch.arange(sk, device=qf.device)[None, :]
        mask = torch.ones((gsq, sk), dtype=torch.bool, device=qf.device)
        if causal:
            mask &= q_pos >= k_pos
        if window > 0:
            mask &= (q_pos - k_pos) < window
        s = torch.where(mask[None], s, NEG_INF)
    p = mxint_softmax_op(s, act_block=act_block, mant_bits=mant_bits,
                         r_bits=r_bits, quantize_out=True)
    if masked:
        p = torch.where(mask[None], p, 0.0)
    return torch.matmul(p.double(), vf.double()).float()


def attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool = True, window: int = 0,
                 exp_mode: str = "float", r_bits: int = 2,
                 quantize_scores: bool = False,
                 softmax_variant: str = "online", act_block: int = 16,
                 mant_bits: int = 8) -> torch.Tensor:
    """(B, H, S, D) attention through the kernels.

    softmax_variant:
      'online' -- the flash kernel (online softmax over 128-key tiles);
                  ``exp_mode='mxint'`` runs the Eq. 14-19 exp LUT in it and
                  ``quantize_scores`` adds the Eq. 2-3 score and Eq. 20
                  probability quantization.  Any Sq and Sk: the kernel
                  treats keys past Sk as the reference's wrapper padding.
      'paper'  -- whole-row MXInt softmax through the softmax kernel; it
                  holds the whole score matrix.

    K and V may carry fewer heads than q (GQA, laid out KV-major: q head i
    reads KV head i // groups).  Neither path copies K/V per query head.
    The flash kernel takes any head dim and resolves the score act block
    against its 128-key tile, as the reference does.
    """
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    groups = h // hkv
    if softmax_variant == "paper":
        o = _paper_softmax_attention(
            q.reshape(b * hkv, groups * sq, d).to(torch.float32),
            k.reshape(b * hkv, sk, d).to(torch.float32),
            v.reshape(b * hkv, sk, d).to(torch.float32), causal=causal,
            window=window, act_block=act_block, mant_bits=mant_bits,
            r_bits=r_bits, groups=groups)
        return o.to(q.dtype).reshape(b, h, sq, d)
    o = flash_attention(
        q.reshape(b * h, sq, d).contiguous(),
        k.reshape(b * hkv, sk, d).contiguous(),
        v.reshape(b * hkv, sk, d).contiguous(), causal=causal,
        window=window, exp_mode=exp_mode, r_bits=r_bits,
        quantize_scores=quantize_scores, act_block=act_block,
        mant_bits=mant_bits, scale=d ** -0.5, kv_groups=groups)
    return o.reshape(b, h, sq, d)


def attention_decode_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        valid: torch.Tensor, *, exp_mode: str = "float",
                        r_bits: int = 2, quantize_scores: bool = False,
                        act_block: int = 16,
                        mant_bits: int = 8) -> torch.Tensor:
    """Single-position decode attention over a KV cache ring.

    q: (B, Hkv, G, D), the G query heads of each KV head as rows; k, v:
    (B, W, Hkv, D) in the cache's native layout (not transposed or copied
    per step); valid: (B, W) nonzero where row b's slot holds a live key
    (a (W,) vector is shared by the batch).  Returns (B, Hkv, G, D).
    Invalid slots follow the model's NEG_INF masking through the
    quantizer; the kernel treats slots past W as the reference's wrapper
    padding.
    """
    b, W = q.shape[0], k.shape[1]
    if valid.ndim == 1:
        valid = valid[None, :].expand(b, W)
    return flash_attention_decode(
        q.contiguous(), k.contiguous(), v.contiguous(),
        valid.to(torch.int32).contiguous(), exp_mode=exp_mode,
        r_bits=r_bits, quantize_scores=quantize_scores, act_block=act_block,
        mant_bits=mant_bits, scale=q.shape[-1] ** -0.5)
