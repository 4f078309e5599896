"""Recurrent mixers: RG-LRU (RecurrentGemma) and mLSTM/sLSTM (xLSTM).

Counterpart of ``repro/models/recurrent.py``, function for function.

RG-LRU (arXiv:2402.19427):
    r_t = sigmoid(W_a x_t);  i_t = sigmoid(W_i x_t)
    a_t = exp(c * softplus(Lambda) * (-r_t))        # 'a' in (0,1), c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
  A prefill runs the reference's associative scan on the linear
  recurrence (its odd/even recursion, so the products round in its
  order); decode is the one-step update.  The block wraps the LRU with
  linear_x -> temporal conv(4) -> LRU, gated by GELU(linear_y), then
  linear_out.

mLSTM (arXiv:2405.04517), chunkwise-parallel form:
    C_t = f_t C_{t-1} + i_t v_t k_t^T ;  n_t = f_t n_{t-1} + i_t k_t
    h_t = o_t * (C_t q_t) / max(|n_t . q_t|, 1)
  with scalar-per-head gates, the carry (C, n) crossing chunk boundaries
  and a masked quadratic inside each chunk.  The exponential input gate
  runs through the backend's ``exp`` (the Eq. 14-19 pow2 LUT in "sim"
  and "packed" with the MXInt non-linears, float e^x otherwise, kernel
  mode included, as in the reference).

sLSTM: scalar memory, inherently sequential: a loop over time, two
linears a token.

The linears go through the backend (``layers.linear``, the matmul kernel
in kernel mode); the gates' transcendentals, the RG-LRU's square root,
the mLSTM's products and sums and its cumulative sums run in float64 and
round once to float32, so
they do not depend on the device; the elementwise updates are float32
operations in the reference's order.  States are lists of tensors (the
reference's tuples), so the slot-prefill scatter walks them.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.mx_types import QuantConfig
from repro_torch.kernels.mxint_layernorm import f32
from repro_torch.models import layers as L
from repro_torch.models.model_api import ModelConfig

_C_RGLRU = 8.0


def _f64(fn, x: torch.Tensor, *args) -> torch.Tensor:
    """``fn`` of float32 ``x`` in float64, rounded once to float32."""
    return fn(x.double(), *args).float()


def _einsum(eq: str, *xs: torch.Tensor) -> torch.Tensor:
    return torch.einsum(eq, *(x.double() for x in xs)).float()


def _value(p) -> torch.Tensor:
    """A parameter read raw (never packed: vectors and conv taps), f32."""
    return p.value.to(torch.float32)


# ===========================================================================
# RG-LRU
# ===========================================================================
def rglru_param_spec(cfg: ModelConfig) -> Dict:
    """(shape, axes, init) leaves of the recurrent block's mixer."""
    d = cfg.d_model
    w = cfg.lru_width or d
    return {
        "linear_y": ((d, w), ("embed", "lru"), "dense"),
        "linear_x": ((d, w), ("embed", "lru"), "dense"),
        "linear_out": ((w, d), ("lru", "embed"), "dense"),
        "conv_w": ((cfg.conv_width, w), ("conv", "lru"), ("normal", 0.5)),
        "conv_b": ((w,), ("lru",), "zeros"),
        "w_a": ((w, w), ("lru", None), "dense"),
        "w_i": ((w, w), ("lru", None), "dense"),
        "lam": ((w,), ("lru",), ("linspace", 0.3, 1.7)),
    }


def _rglru_gates(p, x, quant):
    r = _f64(torch.sigmoid, L.linear(x, p["w_a"], q=quant).float())
    i = _f64(torch.sigmoid, L.linear(x, p["w_i"], q=quant).float())
    log_a = (-_C_RGLRU * _f64(F.softplus, _value(p["lam"]))) * r
    a = _f64(torch.exp, log_a)
    # float64 and rounded once: the IEEE float32 square root on every
    # device (torch's CPU float32 sqrt is not correctly rounded; the
    # card's and XLA's are)
    beta = _f64(torch.sqrt, torch.clamp(1.0 - a * a, min=f32(1e-12)))
    return a, beta * (i * x.float())


def associative_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of h_t = a_t h_{t-1} + b_t along axis 1, by the
    reference's (``jax.lax.associative_scan``) odd/even recursion:
    adjacent pairs combined, the half-length scan, then the even
    elements from the odd ones.  combine((a1, b1), (a2, b2)) = (a1 a2,
    a2 b1 + b2), the later element second.  Returns (the products of a,
    h)."""
    def combine(c1, c2):
        a1, b1 = c1
        a2, b2 = c2
        return a1 * a2, a2 * b1 + b2

    def scan(el):
        n = el[0].shape[1]
        if n < 2:
            return el
        odd = scan(combine([e[:, 0:n - 1:2] for e in el],
                           [e[:, 1::2] for e in el]))
        if n % 2 == 0:
            even = combine([e[:, :-1] for e in odd],
                           [e[:, 2::2] for e in el])
        else:
            even = combine(odd, [e[:, 2::2] for e in el])
        out = []
        for e, ev, od in zip(el, even, odd):
            t = torch.empty_like(e)
            t[:, 0:1] = e[:, 0:1]
            t[:, 2::2] = ev
            t[:, 1::2] = od
            out.append(t)
        return out

    return tuple(scan([a, b]))


def rglru_scan(p, x: torch.Tensor, quant: QuantConfig,
               h0: Optional[torch.Tensor] = None):
    """x: (b, s, w) -> (outputs in x's dtype, final state (b, w) f32)."""
    a, b_in = _rglru_gates(p, x, quant)
    if h0 is not None:
        b_in = b_in.clone()
        b_in[:, 0] = b_in[:, 0] + a[:, 0] * h0
    _, hh = associative_scan(a, b_in)
    return hh.to(x.dtype), hh[:, -1]


def rglru_step(p, x: torch.Tensor, h: torch.Tensor, quant: QuantConfig):
    """x: (b, 1, w); h: (b, w)."""
    a, b_in = _rglru_gates(p, x, quant)
    h_new = a[:, 0] * h + b_in[:, 0]
    return h_new.to(x.dtype)[:, None], h_new


def _temporal_conv(p, x: torch.Tensor, state: Optional[torch.Tensor]):
    """Depthwise causal conv of width K; state: (b, K-1, w) history.  The
    taps are summed as the reference's Python ``sum``: 0 + t0 + t1 + ..."""
    K = p["conv_w"].value.shape[0]
    w = _value(p["conv_w"])
    if state is None:
        pad = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1).float()
    s = x.shape[1]
    out = sum(xp[:, i:i + s] * w[i] for i in range(K))
    new_state = xp[:, -(K - 1):].to(x.dtype) if K > 1 else None
    return (out + _value(p["conv_b"])).to(x.dtype), new_state


def rglru_block(p, x: torch.Tensor, cfg: ModelConfig, *,
                quant: QuantConfig, state=None, decode: bool = False):
    """RecurrentGemma recurrent block.  state: {'conv': (b, K-1, w),
    'h': (b, w)} or None."""
    y = L.act_fn(L.linear(x, p["linear_y"], q=quant), "gelu", quant)
    u = L.linear(x, p["linear_x"], q=quant)
    u, new_conv = _temporal_conv(p, u,
                                 state["conv"] if state is not None else None)
    if decode:
        out, h_new = rglru_step(p, u, state["h"], quant)
    else:
        out, h_new = rglru_scan(p, u, quant,
                                state["h"] if state is not None else None)
    o = L.linear(out * y, p["linear_out"], q=quant)
    return o, {"conv": new_conv, "h": h_new.to(x.dtype)}


def rglru_state_init(cfg: ModelConfig, batch: int, dtype, device):
    w = cfg.lru_width or cfg.d_model
    return {"conv": torch.zeros((batch, cfg.conv_width - 1, w), dtype=dtype,
                                device=device),
            "h": torch.zeros((batch, w), dtype=dtype, device=device)}


RGLRU_STATE_AXES = {"conv": ("batch", None, "lru"), "h": ("batch", "lru")}


# ===========================================================================
# mLSTM (chunkwise gated linear attention form)
# ===========================================================================
def mlstm_param_spec(cfg: ModelConfig) -> Dict:
    d, H, hd = cfg.d_model, cfg.n_heads, cfg.hd
    proj = H * hd
    return {
        "wq": ((d, proj), ("embed", "q_heads"), "dense"),
        "wk": ((d, proj), ("embed", "q_heads"), "dense"),
        "wv": ((d, proj), ("embed", "q_heads"), "dense"),
        "wo": ((proj, d), ("q_heads", "embed"), "dense"),
        "w_f": ((d, H), ("embed", "heads"), "dense"),
        "b_f": ((H,), ("heads",), ("full", 3.0)),
        "w_i": ((d, H), ("embed", "heads"), "dense"),
        "up": ((d, 2 * d), ("embed", "mlp"), "dense"),
        "down": ((d, d), ("mlp", "embed"), "dense"),
    }


def _mlstm_gates(p, x, quant):
    """Scalar-per-head gates; the exp input gate through the backend's
    ``exp``."""
    f_logit = L.linear(x, p["w_f"], q=quant).float() + _value(p["b_f"])
    log_f = -_f64(F.softplus, -f_logit)               # log sigmoid(f) <= 0
    i_logit = L.linear(x, p["w_i"], q=quant).float()
    log_i = torch.clamp(i_logit, max=0.0)             # stabilized exp gate
    return log_f, quant.datapath.exp(log_i, q=quant)


def mlstm_scan(p, x: torch.Tensor, cfg: ModelConfig, quant: QuantConfig,
               state=None, chunk: int = 256):
    """Chunkwise-parallel mLSTM.  x: (b, s, d) -> (y, (C, n) final).  The
    sequence must be a whole number of chunks of min(chunk, s), as the
    reference asserts."""
    b, s, d = x.shape
    H, hd = cfg.n_heads, cfg.hd
    sc = f32(hd ** -0.5)
    q = L.linear(x, p["wq"], q=quant).reshape(b, s, H, hd) * sc
    k = L.linear(x, p["wk"], q=quant).reshape(b, s, H, hd) * sc
    v = L.linear(x, p["wv"], q=quant).reshape(b, s, H, hd)
    log_f, i_gate = _mlstm_gates(p, x, quant)        # (b, s, H)

    chunk = min(chunk, s)
    assert s % chunk == 0, (s, chunk)
    if state is None:
        C = torch.zeros((b, H, hd, hd), dtype=torch.float32, device=x.device)
        n = torch.zeros((b, H, hd), dtype=torch.float32, device=x.device)
    else:
        C, n = state
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=x.device))[None, :, :, None]
    outs = []
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        qf, kf, vf = (t[:, sl].float() for t in (q, k, v))
        lf, ig = log_f[:, sl], i_gate[:, sl]
        lf_cum = _f64(torch.cumsum, lf, 1)           # (b, c, H)
        # inter-chunk: (prod f up to t) * C_in q_t
        qd = qf * _f64(torch.exp, lf_cum)[..., None]
        h_inter = _einsum("bchd,bhde->bche", qd, C)
        n_inter = _einsum("bchd,bhd->bch", qd, n)
        # intra-chunk: masked quadratic with relative decay
        rel = lf_cum[:, :, None, :] - lf_cum[:, None, :, :]   # t >= s kept
        w = torch.where(causal, _f64(torch.exp, rel), 0.0)
        w = w * ig[:, None, :, :]                    # input gate at source s
        sw = _einsum("bthd,bshd->btsh", qf, kf) * w
        h_intra = _einsum("btsh,bshe->bthe", sw, vf)
        n_intra = _f64(torch.sum, sw, 2)
        h = h_inter + h_intra
        denom = torch.clamp(torch.abs(n_inter + n_intra), min=1.0)[..., None]
        outs.append(h / denom)                        # (b, c, H, hd)
        # carry update
        total = _f64(torch.exp, lf_cum[:, -1])       # (b, H)
        src = _f64(torch.exp, lf_cum[:, -1:, :] - lf_cum)
        kw = kf * (src * ig)[..., None]
        C = C * total[:, :, None, None] + _einsum("bchd,bche->bhde", kw, vf)
        n = n * total[:, :, None] + _f64(torch.sum, kw, 1)
    y = torch.cat(outs, dim=1).reshape(b, s, H * hd).to(x.dtype)
    return y, (C, n)


def mlstm_step(p, x: torch.Tensor, cfg: ModelConfig, quant: QuantConfig,
               state):
    """Single-token decode.  x: (b, 1, d); state: (C (b, H, hd, hd), n)."""
    b = x.shape[0]
    H, hd = cfg.n_heads, cfg.hd
    sc = f32(hd ** -0.5)
    q = L.linear(x, p["wq"], q=quant).reshape(b, H, hd).float() * sc
    k = L.linear(x, p["wk"], q=quant).reshape(b, H, hd).float() * sc
    v = L.linear(x, p["wv"], q=quant).reshape(b, H, hd).float()
    log_f, i_gate = _mlstm_gates(p, x, quant)
    f = _f64(torch.exp, log_f[:, 0])                  # (b, H)
    ig = i_gate[:, 0]
    C, n = state
    kg = k * ig[..., None]
    C = C * f[:, :, None, None] + kg[..., :, None] * v[..., None, :]
    n = n * f[:, :, None] + kg
    h = _einsum("bhde,bhd->bhe", C, q)
    denom = torch.clamp(torch.abs(_einsum("bhd,bhd->bh", n, q)), min=1.0)
    out = (h / denom[..., None]).reshape(b, 1, H * hd).to(x.dtype)
    return out, (C, n)


def mlstm_block(p, x, cfg, *, quant, state=None, decode=False):
    """The mLSTM mixer and its up/down projection (xLSTM block style)."""
    if decode:
        inner, new_state = mlstm_step(p, x, cfg, quant, state)
    else:
        inner, new_state = mlstm_scan(p, x, cfg, quant, state)
    o = L.linear(inner, p["wo"], q=quant)
    u = L.linear(x + o, p["up"], q=quant)
    u1, u2 = torch.chunk(u, 2, dim=-1)
    gate = _f64(torch.sigmoid, u2.float()).to(x.dtype)
    return L.linear(u1 * gate, p["down"], q=quant), list(new_state)


def mlstm_state_init(cfg: ModelConfig, batch: int, device):
    H, hd = cfg.n_heads, cfg.hd
    return [torch.zeros((batch, H, hd, hd), dtype=torch.float32,
                        device=device),
            torch.zeros((batch, H, hd), dtype=torch.float32, device=device)]


MLSTM_STATE_AXES = [("batch", "heads", None, None), ("batch", "heads", None)]


# ===========================================================================
# sLSTM (sequential scalar memory)
# ===========================================================================
def slstm_param_spec(cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    return {
        "w_in": ((d, 4 * d), ("embed", "mlp"), "dense"),
        "r_in": ((d, 4 * d), ("embed", "mlp"), ("normal", 0.1)),
        "b_in": ((4 * d,), ("mlp",), "zeros"),
        "wo": ((d, d), ("embed", "embed"), "dense"),
    }


def _slstm_cell(p, xt, state, quant):
    """xt: (b, d); state: (h, c, n, m) each (b, d)."""
    h, c, n, m = state
    z = L.linear(xt, p["w_in"], q=quant).float() + \
        L.linear(h, p["r_in"], q=quant).float() + _value(p["b_in"])
    zi, zf, zz, zo = torch.chunk(z, 4, dim=-1)
    # exponential gating with stabilizer state m (xLSTM Eq. 15-17)
    log_i = torch.clamp(zi, max=0.0)
    log_f = -_f64(F.softplus, -zf)
    m_new = torch.maximum(log_f + m, log_i)
    i_s = _f64(torch.exp, log_i - m_new)
    f_s = _f64(torch.exp, log_f + m - m_new)
    c_new = f_s * c + i_s * _f64(torch.tanh, zz)
    n_new = f_s * n + i_s
    h_new = _f64(torch.sigmoid, zo) * c_new / torch.clamp(n_new, min=1.0)
    return h_new, c_new, n_new, m_new


def slstm_scan(p, x, cfg, quant, state=None):
    """A loop over time: two linears (the input's and the recurrent one's)
    a token, then the output projection over the whole sequence."""
    b, s, d = x.shape
    if state is None:
        state = slstm_state_init(cfg, b, x.device)
    carry = tuple(t.float() for t in state)
    hs = []
    for t in range(s):
        carry = _slstm_cell(p, x[:, t], carry, quant)
        hs.append(carry[0])
    y = torch.stack(hs, dim=1).to(x.dtype)
    return L.linear(y, p["wo"], q=quant), list(carry)


def slstm_step(p, x, cfg, quant, state):
    new = _slstm_cell(p, x[:, 0], state, quant)
    return L.linear(new[0][:, None].to(x.dtype), p["wo"], q=quant), list(new)


def slstm_state_init(cfg: ModelConfig, batch: int, device):
    return [torch.zeros((batch, cfg.d_model), dtype=torch.float32,
                        device=device) for _ in range(4)]


SLSTM_STATE_AXES = [("batch", None)] * 4
