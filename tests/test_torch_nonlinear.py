"""The port's ``core/nonlinear.py`` and the quantize-dequantize functions of
``core/quantize.py`` against ``repro.core`` on the CPU.

Inputs come from numpy with a seed and go through both packages.  The
reference runs with its ``jnp.exp2`` made exact on integer inputs (a
scoped fixture), so its scales are the exact powers of two the port builds
with ``pow2i``.  Every MXInt datapath is held bit for bit.  The
fixed-point baselines' means, variance and softmax sum run in float64 in
the port and in XLA's float32 order in the reference; they are held to
2^-21 of their output scale (measured gap: at most 4.8e-7, one float32
ulp of the per-tensor scale or of a sum, which moves every element of the
8-bit grid by that ulp).  No input reaches below 2^-126.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import nonlinear as jnl  # noqa: E402
from repro.core.mx_types import MXFormat as JMXFormat  # noqa: E402
from repro.core.mx_types import NonlinearConfig as JNonlinearConfig  # noqa: E402
from repro_torch.core import nonlinear as nl  # noqa: E402
from repro_torch.core import quantize as tq  # noqa: E402
from repro_torch.core.mx_types import MXFormat, NonlinearConfig  # noqa: E402
from repro_torch.kernels import mxint_gelu  # noqa: E402

jq = importlib.import_module("repro.core.quantize")

# (shape, mant_bits, act block): a block that divides, a 197-wide row
# (block resolves to 1), a block of 8 at 6 bits, a 3-D tensor
SHAPES = [((6, 64), 8, 16), ((4, 197), 8, 16), ((8, 768), 8, 16),
          ((5, 3, 96), 6, 8)]
CFGS = [dict(), dict(ln_lut_bits=4, gelu_lut_bits=4, softmax_r_bits=3)]
FP_TOL = 2.0 ** -21


@pytest.fixture(scope="module", autouse=True)
def jax_reference():
    """Make ``jnp.exp2`` exact on integer-valued inputs for the reference."""
    orig = jnp.exp2

    def exact_exp2(x):
        x = jnp.asarray(x)
        if not jnp.issubdtype(x.dtype, jnp.floating):
            return orig(x)
        fl = jnp.floor(x)
        exact = jnp.ldexp(jnp.ones_like(x),
                          jnp.clip(fl, -300, 300).astype(jnp.int32))
        return jnp.where(x == fl, exact, orig(x))

    mp = pytest.MonkeyPatch()
    mp.setattr(jnp, "exp2", exact_exp2)
    jax.clear_caches()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)       # as in test_torch_lm.py
    yield
    torch.set_num_threads(threads)
    mp.undo()
    jax.clear_caches()


def _x(shape, seed, scale=3.0):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return x * np.float32(scale)


def _pair(a):
    return torch.from_numpy(np.array(a)), jnp.asarray(a)


def _equal(got, want):
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))


def _close(got, want, tol=FP_TOL):
    got, want = got.numpy(), np.asarray(want)
    gap = float(np.abs(got - want).max())
    assert gap <= tol * float(np.abs(want).max()), gap


def _mx_equal(got, want):
    _equal(got.mantissa, want.mantissa)
    _equal(got.exponent, want.exponent)
    assert (got.scale_axis, got.mant_bits, got.block_size) == \
        (want.scale_axis, want.mant_bits, want.block_size)


# ---------------------------------------------------------------------------
# the MXInt datapaths, bit for bit
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,mb,blk", SHAPES)
@pytest.mark.parametrize("ci", range(len(CFGS)))
def test_value_datapaths_bit_exact(shape, mb, blk, ci):
    cfg, jcfg = NonlinearConfig(**CFGS[ci]), JNonlinearConfig(**CFGS[ci])
    fmt, jfmt = MXFormat(mb, blk), JMXFormat(mb, blk)
    seed = shape[-1] + ci
    x, jx = _pair(_x(shape, seed))
    g, jg = _pair(1.0 + 0.1 * _x(shape[-1:], seed + 1, 1.0))
    b, jb = _pair(0.1 * _x(shape[-1:], seed + 2, 1.0))
    for rms in (False, True):
        _equal(nl.layernorm_value(x, g, b, cfg, fmt, rms_only=rms),
               jnl.layernorm_value(jx, jg, jb, jcfg, jfmt, rms_only=rms))
    _equal(nl.gelu_value(x, cfg, fmt), jnl.gelu_value(jx, jcfg, jfmt))
    _equal(nl.silu_value(x, cfg, fmt), jnl.silu_value(jx, jcfg, jfmt))
    for axis in range(-1, -len(shape) - 1, -1):     # non-last axes too
        _equal(nl.softmax_value(4 * x, cfg, fmt, axis=axis),
               jnl.softmax_value(4 * jx, jcfg, jfmt, axis=axis))


@pytest.mark.parametrize("shape,mb,blk", SHAPES[:2])
def test_mxtensor_datapaths_bit_exact(shape, mb, blk):
    """The MXTensor-level functions, with the options the value wrappers
    leave at their defaults: LN without gamma or beta, a narrower output
    format, GELU/SiLU with another output width, softmax to MXInt6."""
    cfg, jcfg = NonlinearConfig(), JNonlinearConfig()
    x, jx = _pair(_x(shape, 11))
    xq = tq.quantize(x, MXFormat(mb, blk))
    jxq = jq.quantize(jx, JMXFormat(mb, blk))
    out, jout = MXFormat(6, blk), JMXFormat(6, blk)
    _mx_equal(nl.mxint_layernorm(xq, None, None, cfg, out),
              jnl.mxint_layernorm(jxq, None, None, jcfg, jout))
    _mx_equal(nl.mxint_gelu(xq, cfg, out_mant_bits=6),
              jnl.mxint_gelu(jxq, jcfg, out_mant_bits=6))
    _mx_equal(nl.mxint_silu(xq, cfg), jnl.mxint_silu(jxq, jcfg))
    _mx_equal(nl.mxint_softmax(xq, cfg, out), jnl.mxint_softmax(jxq, jcfg,
                                                                jout))
    e = tq.quantize(x, MXFormat(mb, blk)).exponent
    _mx_equal(nl._quantize_with_exponent(0.5 * x, e, xq.block_size, -1, mb),
              jnl._quantize_with_exponent(0.5 * jx, jnp.asarray(e.numpy()),
                                          jxq.block_size, -1, mb))


def test_gelu_clips_negative_mantissas_at_minus_2_pow_b():
    """Sim clips a requantized GELU mantissa to [-128, 127] at 8 bits; the
    kernels' plain version clips to +-127.  A block of values near -0.011
    has the exponent 2^-13, and its LUT output -0.023 needs -187."""
    a = np.full((2, 16), -0.011, np.float32)
    a[1] = 0.011
    x, jx = _pair(a)
    cfg = NonlinearConfig()
    got = nl.gelu_value(x, cfg, MXFormat(8, 16))
    _equal(got, jnl.gelu_value(jx, JNonlinearConfig(), JMXFormat(8, 16)))
    m = nl.mxint_gelu(tq.quantize(x, MXFormat(8, 16)), cfg).mantissa
    assert int(m.min()) == -128
    table, domain = mxint_gelu.gelu_table("gelu", 5, 3.0)
    kern = mxint_gelu.gelu_rows(x, torch.tensor(table), act_block=16,
                                mant_bits=8, domain=domain)
    assert float(kern[0, 0]) == -127 * 2.0 ** -13 != float(got[0, 0])


def test_rsqrt_and_exp_datapaths_bit_exact():
    rng = np.random.default_rng(3)
    # variances across odd and even exponents, below the 2^-24 clamp, at
    # bucket edges
    var = np.concatenate([np.exp2(rng.uniform(-30, 30, 400)),
                          [2.0 ** -30, 2.0 ** -24, 0.5, 1.0, 2.0, 3.0,
                           1.5 * 2.0 ** 9, 0.0]]).astype(np.float32)
    v, jv = _pair(var)
    for bits in (3, 5, 6):
        _equal(nl._rsqrt_datapath(v, bits), jnl._rsqrt_datapath(jv, bits))
    z = np.concatenate([-np.abs(rng.normal(size=500) * 40), [0.0, -0.5,
                        -1.0, -125.5, -126.0, -127.0, -300.0]])
    z, jz = _pair(z.astype(np.float32))
    for r_bits in (1, 2, 4):
        _equal(nl.exp_datapath(z, r_bits), jnl.exp_datapath(jz, r_bits))


# ---------------------------------------------------------------------------
# the related-work baselines
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(6, 64), (4, 197), (8, 768)])
def test_fixed_point_baselines(shape):
    """Per-element stages bit for bit; the means, variance and sums to
    ``FP_TOL`` (float64 against XLA's float32 order, module docstring)."""
    x, jx = _pair(_x(shape, shape[-1] + 7))
    g, jg = _pair(1.0 + 0.1 * _x(shape[-1:], 1, 1.0))
    b, jb = _pair(0.1 * _x(shape[-1:], 2, 1.0))
    for bits in (4, 8):
        _equal(nl._fixed_point_qdq(x, bits), jnl._fixed_point_qdq(jx, bits))
    _equal(nl.fixedpoint_gelu(x), jnl.fixedpoint_gelu(jx))
    _equal(nl.relu6_gelu(x), jnl.relu6_gelu(jx))
    _close(nl.fixedpoint_layernorm(x, g, b), jnl.fixedpoint_layernorm(
        jx, jg, jb))
    _close(nl.fixedpoint_layernorm(x, None, None, bits=6),
           jnl.fixedpoint_layernorm(jx, None, None, bits=6))
    for axis in (-1, 0):
        _close(nl.fixedpoint_softmax(x, axis=axis),
               jnl.fixedpoint_softmax(jx, axis=axis))


def test_fixedpoint_layernorm_variance_is_biased():
    x = torch.tensor([[1.0, 2.0, 3.0, 4.0]])
    y = nl.fixedpoint_layernorm(x, None, None, bits=16, eps=0.0)
    # biased variance 1.25: the ends sit at +-1.5 / sqrt(1.25)
    np.testing.assert_allclose(float(y[0, -1]), 1.5 / 1.25 ** 0.5, rtol=1e-4)


# ---------------------------------------------------------------------------
# core/quantize.py: QDQ, fake quantization and the Table V emulations
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,axis,fmt", [((6, 64), -1, (8, 16)),
                                            ((192, 40), 0, (6, 256)),
                                            ((3, 96, 8), 1, (4, 32))])
def test_quantize_dequantize_and_fake_quant(shape, axis, fmt):
    x, jx = _pair(_x(shape, shape[0]))
    _equal(tq.quantize_dequantize(x, MXFormat(*fmt), axis),
           jq.quantize_dequantize(jx, JMXFormat(*fmt), axis))
    _equal(tq.fake_quant(x, *fmt, axis), jq.fake_quant(jx, *fmt, axis))


def test_fake_quant_gradient_is_straight_through():
    x, jx = _pair(_x((4, 64), 5))
    w, jw = _pair(_x((4, 64), 6))
    want = jax.grad(lambda a: jnp.sum(jq.fake_quant(a, 8, 16, -1) * jw))(jx)
    xt = x.clone().requires_grad_(True)
    (tq.fake_quant(xt, 8, 16, -1) * w).sum().backward()
    _equal(xt.grad, want)
    np.testing.assert_array_equal(xt.grad.numpy(), w.numpy())


@pytest.mark.parametrize("bits", [4, 6, 8])
def test_per_tensor_int_qdq(bits):
    for shape in ((6, 64), (197,)):
        x, jx = _pair(_x(shape, bits))
        _equal(tq.per_tensor_int_qdq(x, bits), jq.per_tensor_int_qdq(jx, bits))
    z, jz = _pair(np.zeros((3, 4), np.float32))
    _equal(tq.per_tensor_int_qdq(z, bits), jq.per_tensor_int_qdq(jz, bits))


def test_fp8_e4m3_qdq_edges():
    """Ties round half to even, +-448 saturates (and beyond), tiny
    magnitudes down to e4m3's subnormal step 2^-9 and below it."""
    ties = [1.0625, 1.1875, 2.125, 2.375, -1.0625, -3.25 + 0.125,
            0.0625 * 1.0625, 240.0 + 8.0, 416.0 + 16.0]
    sat = [448.0, -448.0, 449.0, 464.0, 480.0, 1e6, -1e6, 3e38]
    tiny = [2.0 ** -6, 2.0 ** -7, 2.0 ** -9, 2.0 ** -10, 3 * 2.0 ** -11,
            2.0 ** -11, 1e-3, 1e-30, -2.0 ** -10, 0.0, -0.0]
    a = np.array(ties + sat + tiny, np.float32)
    rnd = _x((512,), 9, scale=50.0)
    for arr in (a, rnd):
        x, jx = _pair(arr)
        _equal(tq.fp8_e4m3_qdq(x), jq.fp8_e4m3_qdq(jx))
    got = tq.fp8_e4m3_qdq(torch.tensor([1.0625, 1.1875, 449.0, 2.0 ** -10]))
    np.testing.assert_array_equal(got.numpy(), [1.0, 1.25, 448.0, 0.0])
