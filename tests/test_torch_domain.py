"""The kernels' whole domain: every format the reference's kernels take.

Each case here is a format that the fast CUDA routes did not take before
the generic routes (``matmul_route``, ``ln_matmul_route``, ``ln_route``,
``softmax_route``, ``gelu_route``, ``flash_route``, ``decode_route``):
act blocks that do not nest in the weight block (12 or 512 against 256)
and int16 planes, which the GEMM core now takes by segment; int32 planes,
17-24-bit act mantissas, K not a multiple of 16,
LUTs past 256 entries, flash head dims past 256 and score act blocks 12
(resolved to 8), 64 and 128, and ``quantize_act=False``.  On the CPU each
port plain version is held to the reference's function (its Pallas
kernel in interpret mode, under the same scoped fixes as the other port
tests): block quantization, exponents and LUT lookups bit for bit, f32
sums within the tolerance each test states beside the measured gap.  The
generic plain version of the matmul is also held, bit for bit, to the
block-by-block plain version it replaced, on every in-domain format of
the launch sweep; DeiT-Tiny is served at the widened format against the
reference's ``mode='sim'``; and the DSE CLI evaluates W12, W10 and W8 in
kernel mode on the CPU.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from repro.configs import deit as jdeit  # noqa: E402
from repro.core.mx_types import MXFormat as JMXFormat  # noqa: E402
from repro.core.mx_types import NonlinearConfig as JNonlinear  # noqa: E402
from repro.core.mx_types import QuantConfig as JQuantConfig  # noqa: E402
from repro.core.quantize import pack_weight as jpack  # noqa: E402
from repro.core.quantize import quantize_dequantize as jqdq  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.mxint_gelu import mxint_gelu as j_gelu  # noqa: E402
from repro.kernels.mxint_layernorm import mxint_layernorm as j_ln  # noqa: E402
from repro.kernels.mxint_ln_matmul import mxint_ln_matmul as j_lnmm  # noqa: E402
from repro.kernels.mxint_matmul import mxint_matmul as j_mm  # noqa: E402
from repro.kernels.mxint_softmax import mxint_softmax as j_sm  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.models.model_api import unwrap  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.analysis import launch_contracts as LC  # noqa: E402
from repro_torch.configs import deit  # noqa: E402
from repro_torch.core.mx_types import (MXFormat, NonlinearConfig,  # noqa: E402
                                       QuantConfig)
from repro_torch.core.quantize import pack_weight  # noqa: E402
from repro_torch.kernels import (flash_attention as fa,  # noqa: E402
                                 mxint_gelu, mxint_layernorm,
                                 mxint_ln_matmul, mxint_matmul,
                                 mxint_softmax, ops)
from repro_torch.kernels.mxint_layernorm import (  # noqa: E402
    block_quantize_rows, lut_tensor)
from repro_torch.models.vit import ViT  # noqa: E402
from repro_torch.serving.engine import ServeConfig, ViTServingEngine  # noqa: E402

# the widened format DeiT-Base is served at on the card: W12 planes (int16),
# act block 12 (which does not nest in the 256-element weight blocks),
# Table VI's vanilla LUT widths
SERVED_NL = dict(ln_lut_bits=13, gelu_lut_bits=14, softmax_r_bits=16)


@pytest.fixture(scope="module", autouse=True)
def jax_reference():
    """Run the reference on this jax: alias the renamed Pallas compiler
    params and make ``jnp.exp2`` exact on integer-valued inputs."""
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
    mp.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
               raising=False)
    mp.setattr(jnp, "exp2", exact_exp2)
    jax.clear_caches()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)       # as in test_torch_lm.py
    yield
    torch.set_num_threads(threads)
    mp.undo()
    jax.clear_caches()


def _x(shape, seed=0, scale=1.0):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return x * np.float32(scale)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _planes(K, N, fmt, seed):
    """The port's and the reference's planes of one weight (equal)."""
    w = _x((K, N), seed, scale=K ** -0.5)
    p = pack_weight(_t(w), fmt)
    jp = jpack(jnp.asarray(w), JMXFormat(fmt.mant_bits, fmt.block_size))
    np.testing.assert_array_equal(p.mantissa.numpy(), np.asarray(jp.mantissa))
    np.testing.assert_array_equal(p.exponent.numpy(), np.asarray(jp.exponent))
    return p, jp


# ---------------------------------------------------------------------------
# the generic plain version against the one it replaced
# ---------------------------------------------------------------------------
def _blocks_before(x, w_mant, w_exp, *, w_block, act_block, act_mant_bits):
    """The block-by-block plain version before the generic route (act
    blocks nested in the weight blocks), kept as it was."""
    from repro_torch.kernels.mxint_matmul import _pow2_table
    M, K = x.shape
    N = w_mant.shape[1]
    nb = K // act_block
    xm, xe = block_quantize_rows(x, act_block, act_mant_bits)
    w_max = torch.iinfo(w_mant.dtype).max
    x_max = 2 ** (act_mant_bits - 1) - 1
    exact = torch.float32 if act_block * x_max * w_max < 2 ** 24 \
        else torch.float64
    xm = xm.to(exact).transpose(0, 1)
    wm = w_mant.to(exact).reshape(nb, act_block, N)
    we = w_exp.to(torch.int32).repeat_interleave(w_block // act_block, dim=0)
    xe = xe.transpose(0, 1)
    x_lo, x_hi = int(xe.min()), int(xe.max())
    w_lo, w_hi = int(we.min()), int(we.max())
    folded = (min(x_lo, w_lo, x_lo + w_lo) >= -126 and
              x_hi + w_hi + (act_block * x_max * w_max).bit_length() < 128
              and x_hi + x_max.bit_length() < 128
              and w_hi + int(w_max).bit_length() < 128)
    fold_w = folded and M > act_block
    table = lut_tensor(_pow2_table(), x.device)
    if folded:
        xm = xm * table[xe + 254].to(exact)[..., None]
        w_scale = table[we + 254].to(exact)[:, None, :]
        if fold_w:
            wm = wm * w_scale
    else:
        xe = xe + 254
    acc = torch.zeros(M, N, dtype=torch.float32)
    prods = torch.matmul(xm, wm)
    if folded and not fold_w:
        prods = prods * w_scale
    prods = prods.to(torch.float32)
    if not folded:
        prods = prods * table[xe[:, :, None] + we[:, None, :]]
    for p in prods:
        acc = acc + p
    return acc


def _sweep_formats():
    """(w_block, act_block, act mantissa bits) of every matmul record of
    the launch sweep in the fast routes' domain (the cases before the
    generic routes)."""
    out = set()
    for _, kernel, kw in (LC.reference_cases() + LC.serving_cases() +
                          LC.widened_cases()):
        if kernel == "mxint_matmul":
            out.add((kw["w_block"], kw["act_block"], kw["act_mant_bits"]))
        elif kernel == "mxint_ln_matmul":
            out.add((kw["w_block"], min(kw["act_block"], kw["d"]),
                     kw["mant_bits"]))
    return sorted(out)


@pytest.mark.parametrize("w_block,act_block,bits", _sweep_formats(),
                         ids=lambda v: str(v))
def test_generic_plain_equals_the_block_plain_on_sweep_formats(
        w_block, act_block, bits):
    """Inside the fast route's domain a segment is the act block, so the
    generic plain version runs the same operations: bit for bit, at small
    and large M (the weight scales folded into the dots or the planes)
    and at subnormal scales (the pow2 table)."""
    K, N = 2 * w_block, 24
    p = pack_weight(_t(_x((K, N), w_block, scale=K ** -0.5)),
                    MXFormat(8, w_block))
    for M, scale in ((3, 1.0), (40, 1.0), (5, 2.0 ** -120)):
        x = _t(_x((M, K), M + act_block, scale=scale))
        kw = dict(w_block=w_block, act_block=act_block, act_mant_bits=bits)
        got = mxint_matmul.matmul_blocks(x, p.mantissa, p.exponent, **kw)
        want = _blocks_before(x, p.mantissa, p.exponent, **kw)
        assert torch.equal(got, want)


def test_segments_cut_k_at_both_blocks():
    starts, lens = mxint_matmul.segments(48, 16, 12)
    assert starts.tolist() == [0, 12, 16, 24, 32, 36]
    assert lens.tolist() == [12, 4, 8, 8, 4, 12]
    starts, lens = mxint_matmul.segments(1024, 256, 512)
    assert starts.tolist() == [0, 256, 512, 768] and set(lens) == {256}


# ---------------------------------------------------------------------------
# the matmul kernels at the widened formats, against the reference
# ---------------------------------------------------------------------------
# (label, M, K, N, weight format, act block, act mantissa bits, tolerance
# over the output scale, route).  The reference's f32 dot rounds products
# past 24 bits (W16 x A16, W20, W24) and sums in another order; the port's
# segment dots are exact.  The GEMM core takes int16 planes and act blocks
# that do not nest, by segment; the generic route K off 16, int32 planes,
# 17-24-bit acts and segment dots that may pass 2^31 (W16 x A16).
MATMUL_CASES = [
    ("act-block-12", 8, 3072, 40, MXFormat(8, 256), 12, 8, 1e-6, "core"),
    ("act-block-512", 8, 3072, 40, MXFormat(8, 256), 512, 8, 1e-6, "core"),
    ("act-block-24-w96", 6, 768, 32, MXFormat(8, 96), 24, 8, 1e-6, "core"),
    ("k-200", 5, 200, 24, MXFormat(8, 8), 8, 8, 1e-6, "generic"),
    ("w12-int16-a12", 7, 768, 48, MXFormat(12, 256), 12, 8, 1e-6, "core"),
    ("w16-a16", 4, 512, 32, MXFormat(16, 256), 16, 16, 2e-6, "generic"),
    ("w20-int32-a17", 4, 512, 32, MXFormat(20, 256), 16, 17, 2e-6,
     "generic"),
    ("w24-a24-b256", 3, 512, 16, MXFormat(24, 256), 256, 24, 2e-6,
     "generic"),
]


@pytest.mark.parametrize("case", MATMUL_CASES, ids=lambda c: c[0])
def test_matmul_widened_formats_vs_pallas(case):
    """Measured gaps over the output scale at these seeds: 0 at 8-bit acts
    (every product and partial sum exact in the reference's f32 too),
    3.1e-7 to 4.6e-7 past 16 bits (W16 x A16 the largest)."""
    label, M, K, N, fmt, block, bits, tol, route = case
    p, jp = _planes(K, N, fmt, seed=K + N)
    x = _x((M, K), seed=M, scale=2.0)
    assert mxint_matmul.matmul_route(K, fmt.block_size, block, bits,
                                     p.mantissa.dtype) == route
    got = mxint_matmul.mxint_matmul(_t(x), p.mantissa, p.exponent,
                                    w_block=p.block_size, act_block=block,
                                    act_mant_bits=bits, quantize_act=True)
    want = np.asarray(j_mm(jnp.asarray(x), jp.mantissa, jp.exponent,
                           w_block=jp.block_size, act_block=block,
                           act_mant_bits=bits, quantize_act=True, bm=M,
                           bn=N, bk=K, interpret=True))
    # the act quantization bit for bit: the reference's own grid values
    xq, xe = block_quantize_rows(_t(x), block, bits)
    np.testing.assert_array_equal(
        (xq * torch.pow(2.0, xe.float())[..., None]).reshape(M, K).numpy(),
        np.asarray(jqdq(jnp.asarray(x), JMXFormat(bits, block))))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=tol * float(np.abs(want).max()))


def test_matmul_float_activations_vs_pallas():
    """``quantize_act=False``: f32 x times the exact weights, float64
    products and sums rounded once, against the reference's f32 dot.
    Measured gap: 4.6e-7 of the output scale."""
    K, N, M = 768, 40, 6
    p, jp = _planes(K, N, MXFormat(6, 256), seed=3)
    x = _x((M, K), seed=4)
    assert mxint_matmul.matmul_route(K, 256, 16, 8, torch.int8,
                                     False) == "float"
    got = ops.mxint_linear(_t(x), p.mantissa, p.exponent, w_block=256)
    want = np.asarray(jops.mxint_linear(jnp.asarray(x), jp.mantissa,
                                        jp.exponent, w_block=256))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * float(np.abs(want).max()))
    # the plain version's order: exactly the float64 sum in K order
    w = p.mantissa.double() * torch.pow(2.0, p.exponent.double()) \
        .repeat_interleave(256, dim=0)
    acc = torch.zeros(M, N, dtype=torch.float64)
    for k in range(K):
        acc = acc + _t(x).double()[:, k:k + 1] * w[k]
    assert torch.equal(got, acc.float())


# (label, M, d, N, weight format, act block, act bits, LUT bits, RMS,
# route): the core where the GEMM core takes the format and the LN stage
# the act block on its route (48 and 24 it does not: a block a thread
# takes 16 at most, the four-element route powers of two)
LNMM_CASES = [
    ("w12-a12-lut13", 6, 768, 40, MXFormat(12, 256), 12, 8, 13, False,
     "core"),
    ("a48-w96", 5, 768, 24, MXFormat(8, 96), 48, 8, 5, False, "generic"),
    ("rms-a24-bits20", 4, 384, 24, MXFormat(8, 384), 24, 20, 5, True,
     "generic"),
]


@pytest.mark.parametrize("case", LNMM_CASES, ids=lambda c: c[0])
def test_ln_matmul_widened_formats_vs_pallas(case):
    """The fused kernel at the widened formats (W12 planes and the 13-bit
    LUT on the core; the rest on its generic route).  Measured gaps: 0 at
    8 bits, 5.7e-7 of the output scale at 20 bits (held to 1e-6: the LN
    variance, the row sum and the matmul sums run in other orders than the
    reference's, and its f32 products of 20-bit mantissas round)."""
    label, M, d, N, fmt, block, bits, lut_bits, rms, route = case
    p, jp = _planes(d, N, fmt, seed=d + N)
    x = _x((M, d), seed=M + d, scale=2.0)
    g = 1.0 + 0.1 * _x((d,), seed=1)
    b = 0.1 * _x((d,), seed=2)
    assert mxint_ln_matmul.ln_matmul_route(
        d, fmt.block_size, block, bits, lut_bits,
        p.mantissa.dtype) == route
    got = mxint_ln_matmul.mxint_ln_matmul(
        _t(x), _t(g), _t(b), p.mantissa, p.exponent, w_block=p.block_size,
        act_block=block, mant_bits=bits, lut_bits=lut_bits, rms_only=rms)
    want = np.asarray(j_lnmm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                             jp.mantissa, jp.exponent, w_block=jp.block_size,
                             act_block=block, mant_bits=bits,
                             lut_bits=lut_bits, rms_only=rms, bm=M, bn=N,
                             interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * float(np.abs(want).max()))


# ---------------------------------------------------------------------------
# the row kernels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("block,lut_bits,bits,tol", [
    (24, 5, 8, 0.0), (256, 5, 8, 0.0), (12, 13, 8, 0.0),
    (16, 13, 20, 1e-6)])
def test_layernorm_widened_formats_vs_pallas(block, lut_bits, bits, tol):
    """Act blocks past the fast routes' (24 at any alignment, 256), the
    vanilla 13-bit rsqrt LUT (8192 entries): bit for bit (the variance is
    an f32 sum in another order; measured: no rsqrt bucket moved at these
    seeds).  20-bit mantissas: the integer row sum passes 2^24, which the
    port sums exactly and the reference's f32 mean does not; measured gap
    4.1e-7 of the output scale, held to 1e-6."""
    rows, d = 8, 768
    x = _x((rows, d), seed=block + lut_bits, scale=2.0)
    x[0, :block] *= np.float32(40.0)
    g = 1.0 + 0.1 * _x((d,), seed=1)
    b = 0.1 * _x((d,), seed=2)
    assert mxint_layernorm.ln_route(rows, d, block, lut_bits, 132) \
        == "generic" or block == 16
    got = mxint_layernorm.mxint_layernorm(
        _t(x), _t(g), _t(b), act_block=block, mant_bits=bits,
        lut_bits=lut_bits, quantize_out=True)
    want = np.asarray(j_ln(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                           act_block=block, mant_bits=bits,
                           lut_bits=lut_bits, quantize_out=True,
                           block_rows=rows, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=tol * float(np.abs(want).max()))


def test_layernorm_row_sum_exact_past_2_24():
    """The integer row sum of 24-bit mantissas over 768 elements passes
    2^24: summed exactly (float64) and rounded once, as the kernels
    convert their int64 sum."""
    rows, d = 2, 768
    x = np.abs(_x((rows, d), seed=5)) + np.float32(1.0)
    g = np.ones(d, np.float32)
    b = np.zeros(d, np.float32)
    got = mxint_layernorm.layernorm_rows(
        _t(x), _t(g), _t(b), act_block=16, mant_bits=24, lut_bits=5,
        rms_only=False, quantize_out=False)
    m, e = block_quantize_rows(_t(x), 16, 24)
    mf, _ = mxint_layernorm.requantize_rows(m, e)
    s = mf.to(torch.int64).sum(dim=(1, 2))
    assert int(s.abs().max()) > 2 ** 24
    want_mean = s.double().float() * mxint_layernorm.f32(1.0 / d)
    centered = mf - want_mean[:, None, None]
    var = mxint_layernorm.warp_row_sum(centered * centered) * \
        mxint_layernorm.f32(1.0 / d)
    assert torch.isfinite(got).all() and var.shape == (rows, 1)


@pytest.mark.parametrize("n,block,r_bits", [
    (256, 256, 2), (197, 1, 16), (240, 12, 10), (256, 64, 16)])
def test_softmax_widened_formats_vs_pallas(n, block, r_bits):
    """A whole-row act block, Table VI's vanilla r 16 (a 65,536-entry
    pow2 LUT read from device memory on the card), r 10: bit for bit but
    for the row sum's order; measured gap: 0 at these seeds."""
    rows = 8
    x = _x((rows, n), seed=n + block, scale=4.0)
    assert mxint_softmax.softmax_route(block, r_bits) == "generic"
    got = mxint_softmax.mxint_softmax(_t(x), act_block=block, r_bits=r_bits,
                                      quantize_out=True)
    want = np.asarray(j_sm(jnp.asarray(x), act_block=block, r_bits=r_bits,
                           quantize_out=True, block_rows=rows,
                           interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * float(np.abs(want).max()))


@pytest.mark.parametrize("block,lut_bits,fn", [
    (256, 5, "gelu"), (12, 14, "gelu"), (3072, 8, "gelu"), (12, 10, "silu")])
def test_gelu_widened_formats_vs_pallas(block, lut_bits, fn):
    """Act blocks past 128 (the whole row at 3072) and LUTs past 256
    entries (Table VI's vanilla 14 bits): bit for bit."""
    rows, d = 6, 3072
    x = _x((rows, d), seed=block + lut_bits, scale=2.0)
    table, _ = mxint_gelu.gelu_table(fn, lut_bits, 3.0)
    assert mxint_gelu.gelu_route(block, len(table)) == "generic"
    got = mxint_gelu.mxint_gelu(_t(x), act_block=block, lut_bits=lut_bits,
                                fn=fn)
    want = j_gelu(jnp.asarray(x), act_block=block, lut_bits=lut_bits, fn=fn,
                  block_rows=rows, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------
# (label, head dim, query heads a KV head, score act block, r_bits,
# exp_mode, quantized scores, S, tolerance over the output scale).  Head
# dims past 256 go to the reference's Pallas function itself: its ops
# wrapper pads them to 384 and falls back to a whole-row oracle.  At S 300
# (a padded last tile) one row of the 1200 sits at an MXInt rounding tie
# and moves by 1.0e-5 of the scale, at block 16 as at 8 and 64.
FLASH_CASES = [
    ("d288-q", 288, 2, 16, 2, "mxint", True, 256, 5e-7),     # 3.6e-7
    ("d288-float", 288, 1, 16, 2, "float", False, 256, 2e-6),  # 7.1e-7
    ("act-block-12", 32, 2, 12, 2, "mxint", True, 300, 3e-5),  # 1.0e-5
    ("act-block-64", 32, 2, 64, 2, "mxint", True, 300, 3e-5),  # 1.0e-5
    ("act-block-64-s256", 32, 2, 64, 2, "mxint", True, 256, 5e-7),  # 2.2e-7
    ("act-block-128", 32, 1, 128, 2, "mxint", True, 256, 5e-7),  # 2.2e-7
    ("r-bits-10", 32, 2, 16, 10, "mxint", True, 256, 5e-7),   # 3.2e-7
]


def _gap(got, want):
    want = np.asarray(want)
    return (float(np.abs(got.float().numpy() - want).max()),
            float(np.abs(want).max()))


@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: c[0])
def test_flash_widened_formats_vs_pallas(case):
    """Measured gaps as noted beside each case (the f32 q.k and P.V sums
    in another order)."""
    from repro.kernels.flash_attention import flash_attention as j_fa
    label, d, g, block, r_bits, mode, quant, S, tol = case
    b, hkv = 1, 2
    q = _x((b, hkv * g, S, d), 1, 1.5)
    k = _x((b, hkv, S, d), 2, 1.5)
    v = _x((b, hkv, S, d), 3)
    assert fa.flash_route(torch.bfloat16, d, g,
                          fa.resolve_act_block(block) if quant else 1,
                          r_bits) == "generic" or block == 12
    kw = dict(causal=True, exp_mode=mode, quantize_scores=quant,
              act_block=block, r_bits=r_bits)
    got = ops.attention_op(_t(q), _t(k), _t(v), softmax_variant="online",
                           **kw)
    if d > 256:
        want = j_fa(jnp.asarray(q.reshape(-1, S, d)),
                    jnp.asarray(k.reshape(-1, S, d)),
                    jnp.asarray(v.reshape(-1, S, d)), kv_groups=g,
                    interpret=True, **kw).reshape(q.shape)
    else:
        want = jops.attention_op(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), softmax_variant="online",
                                 **kw)
    gap, scale = _gap(got, want)
    assert gap <= tol * scale, (gap, scale)


def test_flash_act_block_resolves_against_the_tile():
    assert [fa.resolve_act_block(b) for b in (12, 16, 24, 64, 128, 200)] == \
        [8, 16, 16, 64, 128, 128]
    q = _t(_x((2, 40, 16), 1))
    k = _t(_x((2, 40, 16), 2))
    kw = dict(exp_mode="mxint", quantize_scores=True)
    assert torch.equal(fa.flash_attention(q, k, k, act_block=12, **kw),
                       fa.flash_attention(q, k, k, act_block=8, **kw))


@pytest.mark.parametrize("d,block,g", [(272, 16, 4), (32, 64, 3),
                                       (32, 12, 2)])
def test_decode_widened_formats_vs_pallas(d, block, g):
    """Decode at head dim 272 and score act blocks 64 and 12 (resolved to
    8); measured gaps 3.0e-7 (head dim 272), 8.8e-8 and 9.3e-8 of the
    output scale."""
    b, hkv, W = 2, 2, 300
    q = _x((b, hkv, g, d), 4, 1.5)
    k = _x((b, W, hkv, d), 5, 1.5)
    v = _x((b, W, hkv, d), 6)
    valid = np.ones((b, W), np.int32)
    valid[0, 37:] = 0
    valid[1, 150:170] = 0
    kw = dict(exp_mode="mxint", quantize_scores=True, act_block=block)
    got = ops.attention_decode_op(_t(q), _t(k), _t(v), _t(valid), **kw)
    want = jops.attention_decode_op(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), jnp.asarray(valid), **kw)
    gap, scale = _gap(got, want)
    assert gap <= 5e-7 * scale, (gap, scale)


# ---------------------------------------------------------------------------
# DeiT-Tiny at the served widened format, and the DSE CLI
# ---------------------------------------------------------------------------
def test_deit_tiny_widened_kernel_mode_vs_reference_sim():
    """Two DeiT-Tiny layers in kernel mode at W12 planes (int16), act
    block 12 and the vanilla LUTs (the GEMMs on the core's segment walk,
    the row kernels on their generic routes), against
    the reference's bit-accurate ``mode='sim'`` at the same format: argmax
    equal, logits within 1e-3 of their scale (one moved act-grid step
    moves a logit about 1%, see test_torch_vit.py).  Measured gap at this
    seed: 0 (the logits are bit-identical)."""
    fmt = dict(weight_fmt=(12, 256), act_fmt=(8, 12))
    jq = JQuantConfig(mode="sim", quantize_nonlinear=True,
                      weight_fmt=JMXFormat(*fmt["weight_fmt"]),
                      act_fmt=JMXFormat(*fmt["act_fmt"]),
                      nonlinear=JNonlinear(**SERVED_NL))
    q = QuantConfig(mode="kernel", quantize_nonlinear=True,
                    weight_fmt=MXFormat(*fmt["weight_fmt"]),
                    act_fmt=MXFormat(*fmt["act_fmt"]),
                    nonlinear=NonlinearConfig(**SERVED_NL))
    jcfg = dataclasses.replace(jdeit.BY_NAME["deit_tiny"], n_layers=2,
                               n_classes=100, quant=jq)
    jm = build_model(jcfg)
    jp = jm.init(jax.random.key(0))
    pm = ViT(dataclasses.replace(deit.BY_NAME["deit_tiny"], n_layers=2,
                                 n_classes=100, quant=q))
    pp = convert.vit_params(pm, jax.tree_util.tree_map(np.asarray,
                                                       unwrap(jp)),
                            device="cpu")
    imgs = np.random.default_rng(0).normal(size=(2, 224, 224, 3)).astype(
        np.float32)
    want = np.asarray(jax.jit(jm.logits)(jp, jnp.asarray(imgs)))
    eng = ViTServingEngine(pm, pp, ServeConfig(
        batch=2, pack_weights=True, weight_fmt=MXFormat(*fmt["weight_fmt"])),
        device="cpu")
    planes = [leaf for leaf in jax.tree_util.tree_leaves(
        eng.params, is_leaf=lambda t: hasattr(t, "value"))
        if hasattr(getattr(leaf, "value", None), "mantissa")]
    assert planes and all(p.value.mantissa.dtype == torch.int16
                          for p in planes)
    labels, got = eng.classify(imgs)
    np.testing.assert_array_equal(labels.numpy(), want.argmax(-1))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-3 * float(np.abs(want).max()))


def test_dse_cli_evaluates_wide_weights_in_kernel_mode(tmp_path):
    """``python -m repro_torch.dse --mode kernel --weight-bits 12,10,8
    --device cpu`` over one block: int16 planes at W12 and W10."""
    from repro_torch.dse.__main__ import main
    rep = main(["--arch", "deit_micro", "--layers", "1", "--batch", "4",
                "--mode", "kernel", "--weight-bits", "12,10,8", "--device",
                "cpu", "--out", str(tmp_path / "r.json")])
    assert rep["n_candidates"] == 3
