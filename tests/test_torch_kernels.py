"""Each kernel's plain version against its Pallas function (interpret).

The plain version is what the op runs on the CPU and what the CUDA kernel
is held to on the card.  Inputs come from numpy with a seed; the
reference runs under two scoped fixes for the installed jax (the
``TPUCompilerParams`` alias and an exact ``exp2`` on integer inputs).

Tolerances follow the parity contract in ROADMAP.md: stages that give the
same bits in any order are bit-exact; f32 sums taken in another order
(matmul accumulation across blocks, the LN variance, the softmax sum) are
held to the measured gap stated in each test.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from repro.core.mx_types import MXFormat as JMXFormat  # noqa: E402
from repro.core.quantize import pack_weight as jpack  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.mxint_gelu import mxint_gelu as j_gelu  # noqa: E402
from repro.kernels.mxint_layernorm import mxint_layernorm as j_ln  # noqa: E402
from repro.kernels.mxint_ln_matmul import mxint_ln_matmul as j_lnmm  # noqa: E402
from repro.kernels.mxint_matmul import mxint_matmul as j_mm  # noqa: E402
from repro.kernels.mxint_softmax import mxint_softmax as j_sm  # noqa: E402
from repro_torch.core.mx_types import MXFormat  # noqa: E402
from repro_torch.core.quantize import pack_weight  # noqa: E402
from repro_torch.kernels import (mxint_gelu, mxint_layernorm,  # noqa: E402
                                 mxint_ln_matmul, mxint_matmul,
                                 mxint_softmax, ops)


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
    yield
    mp.undo()
    jax.clear_caches()


def _x(shape, seed=0, scale=1.0):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return x * np.float32(scale)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _planes(K, N, seed):
    w = _x((K, N), seed, scale=K ** -0.5)
    fmt = MXFormat(6, 256)
    p = pack_weight(_t(w), fmt)
    jp = jpack(jnp.asarray(w), JMXFormat(6, 256))
    np.testing.assert_array_equal(p.mantissa.numpy(), np.asarray(jp.mantissa))
    return p, jp


# ---------------------------------------------------------------------------
# row kernels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("rows,d,rms,qout", [
    (8, 192, False, True),            # DeiT-Tiny width
    (8, 64, True, False),             # RMSNorm, raw output
    (5, 768, False, True),            # DeiT-Base width, ragged rows
])
def test_layernorm_plain_vs_pallas(rows, d, rms, qout):
    x = _x((rows, d), seed=d, scale=2.0)
    x[0, :16] *= np.float32(40.0)      # one outlier block: shifts saturate
    g = 1.0 + 0.1 * _x((d,), seed=1)
    b = 0.1 * _x((d,), seed=2)
    got = mxint_layernorm.mxint_layernorm(
        _t(x), _t(g), _t(b), act_block=16, rms_only=rms, quantize_out=qout)
    want = j_ln(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                act_block=16, rms_only=rms, quantize_out=qout,
                block_rows=rows, interpret=True)
    # the variance is an f32 sum in another order: a flip of the rsqrt LUT
    # bucket would change a whole row; measured: none at these seeds
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("rows,n,block", [
    (6, 197, 1),                      # DeiT score rows: block resolves to 1
    (4, 64, 16),
])
def test_softmax_plain_vs_pallas(rows, n, block):
    x = _x((rows, n), seed=n, scale=4.0)
    got = mxint_softmax.mxint_softmax(_t(x), act_block=block,
                                      quantize_out=True)
    want = j_sm(jnp.asarray(x), act_block=block, quantize_out=True,
                block_rows=rows, interpret=True)
    # the row sum of 2^z is an f32 sum in another order; measured: the
    # quantized probabilities agree bit for bit at these seeds
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    raw = mxint_softmax.mxint_softmax(_t(x), act_block=block)
    np.testing.assert_allclose(raw.sum(-1).numpy(), 1.0, rtol=0.3)


@pytest.mark.parametrize("fn", ["gelu", "silu"])
def test_gelu_plain_vs_pallas(fn):
    x = _x((6, 64), seed=11, scale=3.0)
    x[1, :16] = np.float32(-0.001)    # the tiny-value block: -127 clip
    x[2, 16:32] = np.float32(5.0)     # the ReLU tail
    got = mxint_gelu.mxint_gelu(_t(x), act_block=16, fn=fn)
    want = j_gelu(jnp.asarray(x), act_block=16, fn=fn, block_rows=6,
                  interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # -0.001 quantizes on exponent -16; its LUT value, about -0.023, needs a
    # mantissa below the range: the port follows the Pallas clip at -127
    # (the reference's sim path clips at -128)
    np.testing.assert_array_equal(got.numpy()[1, :16],
                                  np.float32(-127 * 2.0 ** -16))


# ---------------------------------------------------------------------------
# matmul kernels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("M,K,N", [(10, 192, 40), (9, 64, 24)])
def test_matmul_plain_vs_pallas(M, K, N):
    x = _x((M, K), seed=M + K)
    p, jp = _planes(K, N, seed=N)
    got = mxint_matmul.mxint_matmul(_t(x), p.mantissa, p.exponent,
                                    w_block=p.block_size)
    want = j_mm(jnp.asarray(x), jp.mantissa, jp.exponent,
                w_block=jp.block_size, quantize_act=True, bm=M, bn=N, bk=K,
                interpret=True)
    # block products are exact; only the f32 sum across blocks runs in
    # another order, so the contract allows a few ulp of the output scale.
    # Measured gap at these seeds: 0 (bit-identical).
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=4e-6 * float(np.abs(want).max()))


def test_ln_matmul_plain_vs_pallas_and_unfused():
    M, d, N = 8, 64, 40
    x = _x((M, d), seed=3, scale=2.0)
    g = 1.0 + 0.1 * _x((d,), seed=4)
    b = 0.1 * _x((d,), seed=5)
    p, jp = _planes(d, N, seed=6)
    got = mxint_ln_matmul.mxint_ln_matmul(_t(x), _t(g), _t(b), p.mantissa,
                                          p.exponent, w_block=p.block_size)
    want = j_lnmm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                  jp.mantissa, jp.exponent, w_block=jp.block_size, bm=M,
                  bn=N, interpret=True)
    # same contract as the matmul; measured gap: 0 (bit-identical)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=4e-6 * float(np.abs(want).max()))
    # fused == LN op then linear op, bit for bit
    h = ops.mxint_layernorm_op(_t(x), _t(g), _t(b), quantize_out=True)
    unfused = ops.mxint_linear(h, p.mantissa, p.exponent,
                               w_block=p.block_size)
    np.testing.assert_array_equal(got.numpy(), unfused.numpy())


def test_linear_op_ragged_deit_head():
    """Leading dims, ragged rows, N = 1000 and a bias, as the DeiT head."""
    x = _x((2, 3, 192), seed=8)
    p, jp = _planes(192, 1000, seed=9)
    bias = 0.01 * _x((1000,), seed=10)
    got = ops.mxint_linear(_t(x), p.mantissa, p.exponent, _t(bias),
                           w_block=p.block_size)
    want = jops.mxint_linear(jnp.asarray(x), jp.mantissa, jp.exponent,
                             jnp.asarray(bias), w_block=jp.block_size,
                             quantize_act=True)
    assert got.shape == (2, 3, 1000)
    # same contract as the matmul; measured gap: 0 (bit-identical)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=4e-6 * float(np.abs(want).max()))


def test_attention_op_paper_vs_pallas():
    """Whole-row attention at DeiT-Tiny head shape (197 tokens, hd 64).
    The score and P.V products are f32 matmuls in another order, held to
    1e-5 of the output scale; measured gap: 0 (bit-identical).  A score
    matrix beyond 512x512 takes the online flash path instead of raising."""
    q, k, v = (_x((1, 2, 197, 64), seed=s) for s in (1, 2, 3))
    got = ops.attention_op(_t(q), _t(k), _t(v), causal=False,
                           softmax_variant="paper")
    want = jops.attention_op(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=False, softmax_variant="paper")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))
    long = ops.attention_op(*(_t(_x((1, 1, 600, 8), seed=s))
                              for s in (4, 5, 6)))
    assert long.shape == (1, 1, 600, 8) and bool(torch.isfinite(long).all())


def test_cpu_calls_do_not_count_launches():
    mods = (mxint_matmul, mxint_ln_matmul, mxint_softmax, mxint_gelu,
            mxint_layernorm)
    before = [m.launches for m in mods]
    mxint_gelu.mxint_gelu(_t(_x((2, 32))))
    mxint_softmax.mxint_softmax(_t(_x((2, 32))))
    assert [m.launches for m in mods] == before
