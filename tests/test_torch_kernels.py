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
from repro_torch.core.mx_types import NEG_INF, MXFormat  # noqa: E402
from repro_torch.core.quantize import (  # noqa: E402
    _resolve_block, pack_weight, pow2i)
from repro_torch.kernels import (mxint_gelu, mxint_layernorm,  # noqa: E402
                                 mxint_ln_matmul, mxint_matmul,
                                 mxint_softmax, ops)
from repro_torch.kernels.mxint_layernorm import (  # noqa: E402
    block_quantize_rows)


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
@pytest.mark.parametrize("rows,d,rms,qout,block", [
    pytest.param(8, 192, False, True, 16, id="8-192-False-True"),  # DeiT-Tiny
    pytest.param(8, 64, True, False, 16, id="8-64-True-False"),    # raw RMS
    pytest.param(5, 768, False, True, 16, id="5-768-False-True"),  # DeiT-Base
    pytest.param(2, 4096, True, True, 16, id="2-4096-rms"),   # Llama-3-8B
    pytest.param(3, 768, False, True, 8, id="3-768-b8"),
    pytest.param(4, 384, True, True, 8, id="4-384-b8-48-blocks"),
])
def test_layernorm_plain_vs_pallas(rows, d, rms, qout, block):
    """48 blocks (d 768 at block 16, d 384 at block 8): lanes 0-15 of the
    variance chains take two blocks, lanes 16-31 one."""
    x = _x((rows, d), seed=d, scale=2.0)
    x[0, :16] *= np.float32(40.0)      # one outlier block: shifts saturate
    g = 1.0 + 0.1 * _x((d,), seed=1)
    b = 0.1 * _x((d,), seed=2)
    got = mxint_layernorm.mxint_layernorm(
        _t(x), _t(g), _t(b), act_block=block, rms_only=rms,
        quantize_out=qout)
    want = j_ln(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                act_block=block, rms_only=rms, quantize_out=qout,
                block_rows=rows, interpret=True)
    # the variance is an f32 sum in another order: a flip of the rsqrt LUT
    # bucket would change a whole row; measured: none at these seeds
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_ln_kernel_operands():
    """What the LN kernels receive: bf16 and f32 rows and scales as they
    come (the same tensors: no conversion op), f16 and scales of two types
    as f32, and scales that do not hold one value a column rejected."""
    x = torch.zeros(2, 8, dtype=torch.bfloat16)
    g = torch.ones(8, dtype=torch.bfloat16)
    got = mxint_layernorm.kernel_operands(x, g, None)
    assert got[0] is x and got[1] is g and got[2] is None
    xh, gh, bh = mxint_layernorm.kernel_operands(x.half(), g, g.float())
    assert (xh.dtype, gh.dtype, bh.dtype) == (torch.float32,) * 3
    with pytest.raises(ValueError):
        mxint_layernorm.kernel_operands(x, g[:4], None)
    with pytest.raises(ValueError):
        mxint_layernorm.kernel_operands(x, g, g[:7])


def test_layernorm_ops_take_bf16_rows():
    """bf16 rows and scales, as a bf16 model hands them to the ops: the
    same bits as their exact f32 values, through the Pallas function and
    through the fused LN -> linear op."""
    x = torch.from_numpy(_x((2, 3, 256), seed=12, scale=2.0)).to(
        torch.bfloat16)
    g = (1.0 + 0.1 * torch.from_numpy(_x((256,), seed=13))).to(
        torch.bfloat16)
    got = ops.mxint_layernorm_op(x, g, None, rms_only=True,
                                 quantize_out=True)
    assert got.dtype == torch.float32 and got.shape == x.shape
    want = j_ln(jnp.asarray(x.float().reshape(6, 256).numpy()),
                jnp.asarray(g.float().numpy()), jnp.zeros(256, jnp.float32),
                act_block=16, rms_only=True, quantize_out=True, block_rows=6,
                interpret=True)
    np.testing.assert_array_equal(got.reshape(6, 256).numpy(),
                                  np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), ops.mxint_layernorm_op(x.float(), g.float(), None,
                                            rms_only=True,
                                            quantize_out=True).numpy())
    p, _ = _planes(256, 24, seed=14)
    fused = ops.mxint_ln_linear_op(x, g, None, p.mantissa, p.exponent,
                                   w_block=p.block_size, rms_only=True)
    assert fused.dtype == torch.bfloat16
    unfused = ops.mxint_linear(got.to(torch.bfloat16), p.mantissa,
                               p.exponent, w_block=p.block_size,
                               quantize_act=True)
    np.testing.assert_array_equal(fused.float().numpy(),
                                  unfused.float().numpy())


def _causal_masked(x):
    """Score rows masked as ``_paper_softmax_attention`` masks a causal
    (query, key) grid: row i holds query position i % n; keys after it get
    NEG_INF."""
    rows, n = x.shape
    keep = np.arange(n)[None, :] <= (np.arange(rows) % n)[:, None]
    return np.where(keep, x, np.float32(NEG_INF)).astype(np.float32)


# n on both sides of the register route's limit (32 elements a lane: n 1024
# at act blocks 1 and 16), masked causal score rows at DeiT's 197 and 512
@pytest.mark.parametrize("rows,n,block,masked", [
    pytest.param(6, 197, 1, False, id="6-197-1"),   # DeiT score rows
    pytest.param(4, 64, 16, False, id="4-64-16"),
    pytest.param(6, 197, 1, True, id="6-197-1-causal"),
    pytest.param(4, 512, 16, True, id="4-512-16-causal"),
    pytest.param(2, 1024, 1, False, id="2-1024-1-regs"),
    pytest.param(2, 1025, 1, False, id="2-1025-1-long"),
    pytest.param(2, 1024, 16, False, id="2-1024-16-regs"),
    pytest.param(2, 1040, 16, False, id="2-1040-16-long"),
])
def test_softmax_plain_vs_pallas(rows, n, block, masked):
    x = _x((rows, n), seed=n, scale=4.0)
    if masked:
        x = _causal_masked(x)
    got = mxint_softmax.mxint_softmax(_t(x), act_block=block,
                                      quantize_out=True)
    want = j_sm(jnp.asarray(x), act_block=block, quantize_out=True,
                block_rows=rows, interpret=True)
    got, want = got.numpy(), np.asarray(want)
    if masked:
        # a masked key's score (NEG_INF) sets the row's exponent lambda, so
        # every other key's 2^z falls to 2^-126 and its probability to
        # 2^-127..2^-126; XLA's CPU backend flushes subnormals to zero, so
        # the reference gives 0 there.  Every larger element is bit for bit
        small = np.abs(got) <= np.float32(2.0 ** -126)
        np.testing.assert_array_equal(want[small], 0.0)
        got, want = got[~small], want[~small]
    # the row sum of 2^z is an f32 sum in another order; measured: the
    # quantized probabilities agree bit for bit at these seeds
    np.testing.assert_array_equal(got, want)
    if not masked:
        raw = mxint_softmax.mxint_softmax(_t(x), act_block=block)
        np.testing.assert_allclose(raw.sum(-1).numpy(), 1.0, rtol=0.3)


@pytest.mark.parametrize("fn,block", [
    pytest.param("gelu", 16, id="gelu"),
    pytest.param("silu", 16, id="silu"),
    pytest.param("gelu", 8, id="gelu-b8"),
    pytest.param("silu", 8, id="silu-b8"),
    pytest.param("gelu", 4, id="gelu-b4"),
    pytest.param("silu", 4, id="silu-b4"),
])
def test_gelu_plain_vs_pallas(fn, block):
    x = _x((6, 64), seed=11, scale=3.0)
    x[1, :16] = np.float32(-0.001)    # the tiny-value blocks: -127 clip
    x[2, 16:32] = np.float32(5.0)     # the ReLU tail
    got = mxint_gelu.mxint_gelu(_t(x), act_block=block, fn=fn)
    want = j_gelu(jnp.asarray(x), act_block=block, fn=fn, block_rows=6,
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
                                    w_block=p.block_size, quantize_act=True)
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
                               w_block=p.block_size, quantize_act=True)
    np.testing.assert_array_equal(got.numpy(), unfused.numpy())


def test_linear_op_ragged_deit_head():
    """Leading dims, ragged rows, N = 1000 and a bias, as the DeiT head."""
    x = _x((2, 3, 192), seed=8)
    p, jp = _planes(192, 1000, seed=9)
    bias = 0.01 * _x((1000,), seed=10)
    got = ops.mxint_linear(_t(x), p.mantissa, p.exponent, _t(bias),
                           w_block=p.block_size, quantize_act=True)
    want = jops.mxint_linear(jnp.asarray(x), jp.mantissa, jp.exponent,
                             jnp.asarray(bias), w_block=jp.block_size,
                             quantize_act=True)
    assert got.shape == (2, 3, 1000)
    # same contract as the matmul; measured gap: 0 (bit-identical)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=4e-6 * float(np.abs(want).max()))


def test_attention_op_paper_vs_pallas():
    """Whole-row attention at DeiT-Tiny head shape (197 tokens, hd 64).
    The port computes the score and P.V products in float64 and rounds
    each once to float32; the reference's are f32 matmuls.  Held to 1e-5
    of the output scale; measured gap: 2.98e-7 of 0.698 (4.3e-7 of the
    scale, 22182 of 25216 elements differ in their last bits; 0 while the
    port's products were f32 matmuls too).  A score matrix beyond 512x512
    takes the online flash path instead of raising."""
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


# ---------------------------------------------------------------------------
# the row kernels' routes and geometry (csrc/mxint_softmax.cu, mxint_gelu.cu)
# ---------------------------------------------------------------------------
WARP = mxint_layernorm.WARP
SMEM_LIMIT = 232448                    # the H100's shared memory a CTA


def _softmax_lane_walk(n, block, per_lane, vec):
    """A model of softmax_regs_kernel's walk (``lane_step``): for each
    lane, the row offsets of its elements in the order it adds them, the
    float4 starts, and the elements its ``last`` bits mark as block ends."""
    nb = n // block
    lanes = []
    for lane in range(WARP):
        cnt = (nb - lane + WARP - 1) // WARP * block
        off, j = lane * block, 0
        offs, starts, last = [], [], []
        for e in range(0, per_lane, vec):
            if e < cnt:
                offs.extend(range(off, off + vec))
                starts.append(off)
            if j + vec == block and e + vec - 1 < cnt:
                last.append(e + vec - 1)
            j, off = j + vec, off + vec
            if j == block:
                j, off = 0, off + (WARP - 1) * block
        lanes.append((cnt, offs, starts, last))
    return lanes


SOFTMAX_SHAPES = [(37824, 197, 1), (37, 64, 16), (2048, 512, 16),
                  (64, 20, 1), (64, 33, 1), (64, 100, 1), (300, 1024, 1),
                  (300, 1025, 1), (300, 1024, 16), (300, 1040, 16),
                  (2, 262144, 16), (100, 96, 12), (100, 300, 15),
                  (7, 960, 5), (3, 1, 1)]


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("rows,n,block", SOFTMAX_SHAPES)
def test_softmax_geometry(rows, n, block, aligned):
    """The route by shape and alignment; on the register route every
    element of a row in exactly one lane, each lane's elements in
    ``warp_row_sum``'s order (blocks lane, lane + 32, ..., element by
    element), block ends where the requantize needs them, float4 accesses
    on 16-byte boundaries; a warp for every row."""
    g = mxint_softmax.softmax_geometry(rows, n, block, aligned)
    need = mxint_softmax.lane_elements(n, block)
    assert (g.route == "long") == (need > mxint_softmax.REG_MAX_PER_LANE)
    per_cta = mxint_softmax.ROW_THREADS // WARP
    assert g.grid * per_cta >= rows > (g.grid - 1) * per_cta
    assert mxint_softmax.SMEM_BYTES <= SMEM_LIMIT
    if g.route == "long":
        assert g.per_lane == 0 and g.vec == 1
        return
    assert g.per_lane in mxint_softmax.REG_PER_LANE and g.per_lane >= need
    assert g.vec == (4 if block % 4 == 0 and aligned else 1)
    assert g.per_lane % g.vec == 0
    seen = np.zeros(n, np.int32)
    nb = n // block
    for lane, (cnt, offs, starts, last) in enumerate(
            _softmax_lane_walk(n, block, g.per_lane, g.vec)):
        order = [b * block + i for b in range(lane, nb, WARP)
                 for i in range(block)]
        assert offs == order and cnt == len(order) <= g.per_lane
        assert last == [e for e in range(cnt) if (e + 1) % block == 0]
        if g.vec == 4:
            assert all(o % 4 == 0 for o in starts)
        seen[offs] += 1
    assert (seen == 1).all()


def test_every_softmax_shape_has_a_route():
    """Every row length up to 2048 at every act block the ops resolve (and
    the longest whole-row score row) maps to a route; the register route
    takes every row whose lane holds at most 32 elements."""
    for n in range(1, 2049):
        for want in range(1, 17):
            block = _resolve_block(n, want)
            g = mxint_softmax.softmax_geometry(1, n, block)
            if mxint_softmax.lane_elements(n, block) <= 32:
                assert g.route == "regs" and g.per_lane >= \
                    mxint_softmax.lane_elements(n, block)
            else:
                assert g.route == "long"
    assert mxint_softmax.softmax_geometry(
        2, ops.PAPER_MAX_SCORES, 16).route == "long"


GELU_SHAPES = [(3152, 3072, 16), (4, 14336, 16), (1024, 14336, 16),
               (37, 768, 16), (37, 768, 8), (37, 768, 4), (37, 197, 1),
               (37, 194, 2), (37, 96, 12), (1, 16, 16), (3, 8, 4)]


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("n_sm", [132, 114])
@pytest.mark.parametrize("rows,d,block", GELU_SHAPES)
def test_gelu_geometry(rows, d, block, n_sm, aligned):
    """A numpy model of both routes' grid-stride walk: every item (a
    float4, or an act block on the scalar route) visited exactly once; on
    the float4 route each act block in block / 4 adjacent lanes of one
    warp, visited in one step (the shuffles run warp-uniformly), its xor
    partners inside the group; CTAs spread over the SMs where the items
    allow, and never more than the SMs hold."""
    numel = rows * d
    g = mxint_gelu.gelu_geometry(numel, block, n_sm, aligned)
    assert g.vec == (4 if block in (4, 8, 16) and aligned else 1)
    assert g.threads in (64, 128, 256) and g.threads % WARP == 0
    assert 1 <= g.grid <= n_sm * mxint_gelu.THREADS_PER_SM // g.threads
    assert mxint_gelu.SMEM_BYTES <= SMEM_LIMIT
    items = numel // (4 if g.vec == 4 else block)
    if g.threads < mxint_gelu.MAX_THREADS:    # larger CTAs: fewer than SMs
        assert -(-items // (2 * g.threads)) < n_sm
    assert g.grid >= min(n_sm, -(-items // g.threads))
    stride = g.grid * g.threads
    tid = np.arange(stride)
    steps = -(-items // stride)
    q = tid[None, :] + stride * np.arange(steps)[:, None]   # (step, thread)
    live = q < items
    assert (np.bincount(q[live], minlength=items) == 1).all()
    if g.vec == 1:
        return
    G = block // 4
    lane = tid % WARP
    assert ((lane ^ np.arange(G)[:, None]) // G == lane // G).all()
    # the block of each live float4, and the (step, warp) that loads it
    blk = q[live] // G
    warp = np.broadcast_to((tid // WARP)[None, :], q.shape)[live]
    step = np.broadcast_to(np.arange(steps)[:, None], q.shape)[live]
    key = step.astype(np.int64) * (stride // WARP) + warp
    first = np.full(items // G, -1, np.int64)
    first[blk] = key
    assert (first[blk] == key).all()            # one warp step a block
    assert (np.bincount(blk, minlength=items // G) == G).all()
    # element i of the tensor lies in float4 i // 4, act block i // block
    elems = np.arange(0, numel, 997)
    assert ((elems // 4) // G == elems // block).all()


def test_gelu_requantize_product_equals_quotient():
    """The CUDA kernel requantizes g / 2^e as g * 2^-e: for every block
    exponent e in [-127, 127] both are the correctly rounded value of the
    same real number, subnormal and overflowing results included."""
    rng = np.random.default_rng(0)
    g = np.concatenate([
        rng.normal(size=4000).astype(np.float32) * np.float32(3.0),
        np.float32(2.0) ** rng.integers(-149, 128, size=2000).astype(
            np.float32) * rng.uniform(1, 2, size=2000).astype(np.float32),
        np.array([0.0, -0.0, 1.0, -1.0, 3.4e38, -3.4e38, 1e-45],
                 np.float32)]).astype(np.float32)
    with np.errstate(over="ignore", under="ignore"):
        for e in range(-127, 128):
            scale = np.ldexp(np.float32(1.0), e).astype(np.float32)
            inv = np.ldexp(np.float32(1.0), -e).astype(np.float32)
            np.testing.assert_array_equal(g * inv, g / scale)


# ---------------------------------------------------------------------------
# the LN row stage (ln_rows in csrc/mxint_common.cuh) and its two kernels
# ---------------------------------------------------------------------------
LN_ROWVARS_BYTES = 16                  # struct LnRowVars


def _ln_walk(rows, d, block, vec, threads):
    """A model of ln_rows' piece walk: piece p = t + k T (step k, thread t)
    is piece p % ppr of row p / ppr, of n = vec (4) or block elements.
    Returns [(k, t, r, j)] for the valid pieces, n, ppr and the steps."""
    n = vec or block
    ppr = d // n
    total = rows * ppr
    steps = -(-total // threads)
    walk = [(k, t, p // ppr, p % ppr * n) for k in range(steps)
            for t in range(threads) for p in [t + k * threads] if p < total]
    return walk, n, ppr, steps


def _fold_model(rows, ppr, threads, steps, vals, op):
    """fold_rows (csrc/mxint_common.cuh) over every step: a warp whose
    valid pieces lie in one row (ln_step's uniform) reduces, then one
    atomic; else one atomic a lane."""
    total = rows * ppr
    slot = [None] * rows
    for k in range(steps):
        for w in range(threads // WARP):
            pw = k * threads + w * WARP
            if pw >= total:
                continue
            ps = [p for p in range(pw, pw + WARP) if p < total]
            uniform = pw // ppr == min(pw + WARP - 1, total - 1) // ppr
            groups = [(pw // ppr, ps)] if uniform else \
                [(p // ppr, [p]) for p in ps]
            for r, members in groups:
                v = op(vals[p] for p in members)
                slot[r] = v if slot[r] is None else op([slot[r], v])
    return slot


LN_SHAPES = [(3152, 768, 16), (4, 4096, 16), (1024, 4096, 16),
             (37, 192, 16), (37, 768, 8), (37, 768, 4), (37, 768, 12),
             (37, 197, 1), (3, 96, 3), (24, 768, 16), (1, 16, 16)]


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("rows,d,block", LN_SHAPES)
def test_ln_stage_walk(rows, d, block, aligned):
    """The stage's thread-to-element mapping, as mxint_layernorm (a CTA of
    up to 8 rows) and mxint_ln_matmul (16-32 rows) run it: every element
    of every row in exactly one piece; on the vector route each piece on
    four-element boundaries, each act block in block / 4 adjacent lanes of
    one warp step, aligned so that its xor partners stay in the group, its
    leader the lane of its first piece; the row max and row sum folds give
    every row's own max and sum."""
    vec = mxint_layernorm.ln_piece(block, aligned)
    assert vec == (4 if block in (4, 8, 16) and aligned else 0)
    geom = mxint_layernorm.ln_geometry(rows, d, block, 132, aligned)
    R = min(rows, geom.rows_per_cta)
    for threads, cta_rows in ((mxint_layernorm.LN_THREADS, R),
                              (512, min(rows, 24)), (256, min(rows, 16))):
        walk, n, ppr, steps = _ln_walk(cta_rows, d, block, vec, threads)
        seen = np.zeros((cta_rows, d), np.int32)
        groups = {}
        for k, t, r, j in walk:
            seen[r, j:j + n] += 1
            if vec:
                assert j % 4 == 0
            groups.setdefault((r, j // block), []).append((k, t, j))
        assert (seen == 1).all()
        G = block // n if vec else 1
        for (r, b), members in groups.items():
            assert len(members) == G and len({k for k, _, _ in members}) == 1
            ts = sorted(t for _, t, _ in members)
            assert ts == list(range(ts[0], ts[0] + G)) and ts[0] % G == 0
            leader = [j for _, t, j in members if t % WARP % G == 0]
            assert leader == [b * block]
        rng = np.random.default_rng(rows + d)
        vals = rng.integers(-1000, 1000, size=cta_rows * ppr)
        want_max = vals.reshape(cta_rows, ppr).max(1)
        want_sum = vals.reshape(cta_rows, ppr).sum(1)
        assert _fold_model(cta_rows, ppr, threads, steps, vals,
                           max) == want_max.tolist()
        assert _fold_model(cta_rows, ppr, threads, steps, vals,
                           sum) == want_sum.tolist()


@pytest.mark.parametrize("d,block", [(768, 16), (4096, 16), (192, 16),
                                     (768, 8), (384, 8), (197, 1), (96, 3),
                                     (768, 32), (768, 128), (1024, 256)])
def test_ln_variance_chains_in_warp_row_sum_order(d, block):
    """Each of a row's 32 variance chains reads the staged row (int8 at
    mxint_ln_matmul's stride d + 16, int32 at mxint_layernorm's d) at
    blocks l, l + 32, ... element by element, as ``warp_row_sum`` adds
    them: the float32 sums agree bit for bit (values over 2^40 of range,
    so that another order would round otherwise)."""
    rng = np.random.default_rng(d + block)
    nb = d // block
    c2 = (rng.normal(size=d) * 2.0 ** rng.integers(-20, 20, size=d)) ** 2
    c2 = c2.astype(np.float32)
    for ld in (d + 16, d):
        staged = np.zeros(4 * ld, np.float32)           # the row in slot 2
        staged[2 * ld:2 * ld + d] = c2
        acc = np.zeros(WARP, np.float32)
        for lane in range(WARP):
            for b in range(lane, nb, WARP):
                for i in range(block):
                    acc[lane] = acc[lane] + staged[2 * ld + b * block + i]
        s = WARP
        while s > 1:
            s //= 2
            acc = acc[:s] + acc[s:2 * s]
        want = mxint_layernorm.warp_row_sum(_t(c2.reshape(1, nb, block)))
        np.testing.assert_array_equal(acc.view(np.int32),
                                      want.numpy().reshape(1).view(np.int32))


@pytest.mark.parametrize("rows,bm,d,aligned", [
    (4, 16, 4096, True), (24, 24, 768, True), (10, 24, 768, False),
    (32, 32, 4096, True), (17, 32, 192, True)])
def test_ln_matmul_stage_in_place(rows, bm, d, aligned):
    """mxint_ln_matmul's stage in its act tile sA (int8, row stride d + 16):
    the phases touch only the valid rows' first d bytes, the zero fill
    only the rows past M, the row scalars only each row's 16 padding
    bytes (never read by the GEMM core, which reads K columns); the
    variance chains (phase 3) read every staged mantissa, and in phase 4
    each thread overwrites exactly the bytes of its own pieces, which it
    read in that phase: no mantissa a chain or another thread has yet to
    read is overwritten (the phases are apart by __syncthreads)."""
    threads = (bm + 15) // 16 * 256         # gemm_threads(bm)
    sa = d + 16
    vec = mxint_layernorm.ln_piece(16, aligned)
    walk, n, _, _ = _ln_walk(rows, d, 16, vec, threads)
    reads4, writes4 = {}, {}
    for k, t, r, j in walk:
        for i in range(n):
            addr = r * sa + j + i
            assert j + i < d
            reads4.setdefault(addr, set()).add(t)
            writes4.setdefault(addr, set()).add(t)
    assert reads4 == writes4 and all(len(v) == 1 for v in writes4.values())
    chain = set()
    nb = d // 16
    for r in range(rows):
        for lane in range(WARP):
            for b in range(lane, nb, WARP):
                chain.update(r * sa + b * 16 + i for i in range(16))
    assert chain == set(writes4)
    rowvars = {r * sa + d + i for r in range(bm)
               for i in range(LN_ROWVARS_BYTES)}
    assert sa - d == LN_ROWVARS_BYTES and not rowvars & chain
    zero = {r * sa + i for r in range(rows, bm) for i in range(d)}
    assert not zero & chain and not zero & rowvars
    assert threads >= bm                    # a thread sets each row's vars


@pytest.mark.parametrize("mant_bits", range(2, 17))
def test_act_quant_of_grid_values_is_exact(mant_bits):
    """mxint_ln_matmul stores the LN output's grid mantissas as its act
    mantissas: act quantization of values on the MXInt grid gives the
    grid's mantissas and exponents, but for a block whose mantissas are
    all 0, whose act exponent is 0, at every scale from below the
    subnormals to 2^120 (the plain version quantizes twice)."""
    rng = np.random.default_rng(mant_bits)
    scales = np.arange(-170, 121, 3)
    y = rng.normal(size=(len(scales), 64, 16)) * \
        2.0 ** (scales[:, None, None] + rng.integers(-4, 5, size=(1, 64, 1)))
    y[:, ::9] = 0.0
    y = torch.from_numpy(y.reshape(-1, 16).astype(np.float32))
    m1, e1 = block_quantize_rows(y, 16, mant_bits)
    grid = mxint_layernorm.requantize_to_grid(y, 16, mant_bits)
    m2, e2 = block_quantize_rows(grid, 16, mant_bits)
    np.testing.assert_array_equal(m2.numpy(), m1.numpy())
    zero = m1.abs().amax(-1) == 0
    np.testing.assert_array_equal(
        e2.numpy(), torch.where(zero, torch.zeros_like(e1), e1).numpy())
    assert bool(zero.any()) and bool((e1[zero] != 0).any())


def _f32(v):
    return np.float32(v)


def _block_exp(amax, mant_bits):
    _, k = np.frexp(np.maximum(amax, np.float32(np.finfo(np.float32).tiny)))
    return np.where(amax > 0, np.clip(k - 1 - (mant_bits - 2), -127, 127), 0)


def _pow2(n):
    return np.ldexp(np.float32(1.0), np.asarray(n)).astype(np.float32)


def _quant(v, e, lim):
    return np.clip(np.rint((v * _pow2(-e)).astype(np.float32)), -lim, lim)


def _ln_stage_model(x, gamma, beta, block, mant_bits, rms_only, vec,
                    threads, rows_per_cta, quantize_out):
    """ln_rows and the layernorm kernel's epilogue in numpy float32, phase
    by phase, over the piece walk: stage q and e, fold the row max, shift
    in place and fold the integer sum, the 32 chains and the butterfly,
    then each piece's output and its block's requantization."""
    rows, d = x.shape
    lim = float(2 ** (mant_bits - 1) - 1)
    inv_d = _f32(1.0 / d)
    nb = d // block
    table = mxint_layernorm.lut_tensor(
        mxint_layernorm.luts.rsqrt_table(5), "cpu")
    out = np.zeros_like(x)
    for r0 in range(0, rows, rows_per_cta):
        xr = x[r0:r0 + rows_per_cta]
        R = xr.shape[0]
        walk, n, ppr, steps = _ln_walk(R, d, block, vec, threads)
        m = np.zeros((R, d), np.int64)
        e = np.zeros((R, nb), np.int64)
        for _, _, r, j in walk:                         # phase 1
            b = j // block
            amax = np.abs(xr[r, b * block:(b + 1) * block]).max()
            e[r, b] = _block_exp(amax, mant_bits)
            m[r, j:j + n] = _quant(xr[r, j:j + n], e[r, b], lim)
        emax = _fold_model(R, ppr, threads, steps, np.repeat(
            e, block // n, axis=1).reshape(-1), max)
        isum = [0] * R
        for _, _, r, j in walk:                         # phase 2
            sh = min(emax[r] - e[r, j // block], 31)
            m[r, j:j + n] >>= sh
            isum[r] += int(m[r, j:j + n].sum())
        for r in range(R):                              # phase 3
            mean = _f32(0.0) if rms_only else _f32(_f32(isum[r]) * inv_d)
            c = m[r].astype(np.float32) - (0 if rms_only else mean)
            var = mxint_layernorm.warp_row_sum(
                _t((c * c).astype(np.float32).reshape(1, nb, block)))
            inv = mxint_layernorm.rsqrt_lut_stage(var * inv_d, table, 5)
            inv = _f32(inv.item())
            y = ((c * inv).astype(np.float32) * gamma).astype(np.float32)
            if not rms_only:
                y = (y + beta).astype(np.float32)
            if quantize_out:                            # phase 4
                yb = y.reshape(nb, block)
                eo = _block_exp(np.abs(yb).max(1), mant_bits)
                y = (_quant(yb, eo[:, None], lim) * _pow2(eo)[:, None]
                     ).astype(np.float32).reshape(d)
            out[r0 + r] = y
    return out


@pytest.mark.parametrize("rows,d,block,rms,mant_bits,qout", [
    (10, 768, 16, False, 8, True), (3, 4096, 16, True, 8, True),
    (9, 768, 8, False, 8, False), (5, 96, 4, True, 8, True),
    (7, 192, 12, False, 8, True), (6, 197, 1, False, 8, True),
    (4, 768, 16, False, 12, True)])
def test_ln_stage_model_matches_plain_version(rows, d, block, rms,
                                              mant_bits, qout):
    """The stage's phases, on both routes and over several CTAs, give the
    plain version's values: quantize and stage, then shift in place, is
    ``requantize_rows``' floor; the integer row sum, one rounding to f32,
    is its f32 sum; the chains are ``warp_row_sum``.  Equal as values, as
    the card's check compares them: where the plain version's float floor
    keeps a -0.0 mantissa the integer shift gives 0, and the output is
    -0.0 against 0.0 (the kernels have done so since they were ported)."""
    x = _x((rows, d), seed=d + block, scale=2.0)
    x[0, :block] *= np.float32(40.0)   # shifts saturate at 31
    g = (1.0 + 0.1 * _x((d,), seed=3)).astype(np.float32)
    b = (0.1 * _x((d,), seed=4)).astype(np.float32)
    want = mxint_layernorm.layernorm_rows(
        _t(x), _t(g), _t(b), act_block=block, mant_bits=mant_bits,
        lut_bits=5, rms_only=rms, quantize_out=qout).numpy()
    for aligned in (True, False):
        vec = mxint_layernorm.ln_piece(block, aligned)
        got = _ln_stage_model(x, g, b, block, mant_bits, rms, vec,
                              mxint_layernorm.LN_THREADS, 4, qout)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_sm", [132, 114])
@pytest.mark.parametrize("aligned", [True, False])
def test_every_ln_shape_has_a_route(n_sm, aligned):
    """Every row length the ops accept at every act block they resolve
    maps to a route of the layernorm kernel whose shared memory fits the
    H100's 227 KB a CTA (the global-stage route where one row does not);
    the grid covers every row; a CTA takes more than one row only while
    the card still gets two CTAs an SM."""
    limit = mxint_layernorm.SMEM_LIMIT
    ds = list(range(1, 2049)) + [3072, 4096, 8192, 14336, 16384, 57216,
                                 57344, 65536, 262144]
    for d in ds:
        for want in (1, 2, 4, 8, 12, 16):
            block = _resolve_block(d, want)
            for rows in (1, 4, 37, 1024, 3152):
                g = mxint_layernorm.ln_geometry(rows, d, block, n_sm, aligned)
                assert g.vec == mxint_layernorm.ln_piece(block, aligned)
                R = g.rows_per_cta
                assert R in (1, 2, 4, 8) and g.grid * R >= rows > \
                    (g.grid - 1) * R
                assert R == 1 or -(-rows // R) >= 2 * n_sm
                if g.stage_words:
                    assert R == 1 and g.smem == 0 and g.route.endswith(
                        "global")
                    assert 4 * d + d // block > \
                        limit - mxint_layernorm.LN_STATIC_SMEM
                    assert 4 * g.stage_words >= 4 * d + d // block
                    assert g.stage_words % 4 == 0
                else:
                    assert g.smem == R * (4 * d + d // block)
                    assert g.smem + mxint_layernorm.LN_STATIC_SMEM <= limit


# ---------------------------------------------------------------------------
# the int8 tensor-core GEMM core: geometry, fragment layout, epilogue
# ---------------------------------------------------------------------------
# (M, N, K, fused LN): DeiT-Base batch 16, Llama-3-8B decode at batch 4 and
# 1024-token scoring, ragged shapes
GEMM_SHAPES = [
    (3152, 768, 3072, False), (3152, 3072, 768, True),
    (3152, 2304, 768, True), (3152, 768, 768, False),
    (4, 4096, 4096, True), (4, 1024, 4096, True), (4, 14336, 4096, True),
    (4, 4096, 4096, False), (4, 4096, 14336, False),
    (1024, 4096, 4096, True), (1024, 14336, 4096, True),
    (1024, 1024, 4096, True), (1024, 4096, 14336, False),
    (37, 1000, 192, False), (1, 1024, 4096, False), (16, 4096, 4096, True),
    (17, 1000, 768, False), (33, 1024, 14336, False), (64, 4096, 4096, True),
    (200, 4096, 14336, False), (500, 4096, 4096, True),
]
DECODE_N = (1024, 4096, 14336)


@pytest.mark.parametrize("n_sm", [132, 114])
@pytest.mark.parametrize("M,N,K,fused_ln", GEMM_SHAPES)
def test_gemm_geometry(M, N, K, fused_ln, n_sm):
    """Every output element in exactly one CTA's tile, K never split across
    CTAs, shared memory within the H100's 227 KB a CTA, and at least one
    CTA per SM for a decode batch."""
    g = mxint_matmul.gemm_geometry(M, N, K, n_sm, fused_ln=fused_ln)
    assert g.bm in ((16,) if M <= 16 else (24, 32))
    assert g.bn >= 4 and g.bn <= mxint_matmul.MAX_TILE_COLS
    assert g.bn & (g.bn - 1) == 0 and g.bk % 16 == 0 and 2 <= g.ns <= 4
    # the grid is rows x column groups: no axis splits K; a chunked CTA
    # walks all of K itself and holds its tiles' sums in registers
    assert len(g.grid) == 2
    assert g.chunked == (not fused_ln and K > mxint_matmul.MAX_CHUNK)
    if g.chunked:
        assert g.n_per <= mxint_matmul.MAX_ACC_TILES
    rows = np.zeros(M, np.int32)
    for x in range(g.grid[0]):
        rows[x * g.bm:(x + 1) * g.bm] += 1
    cols = np.zeros(N, np.int32)
    tiles = -(-N // g.bn)
    for y in range(g.grid[1]):
        n_tiles = min(g.n_per, tiles - y * g.n_per)   # the kernel's rule
        assert n_tiles >= 1
        for t in range(n_tiles):
            c0 = (y * g.n_per + t) * g.bn
            cols[c0:c0 + g.bn] += 1
    assert (rows == 1).all() and (cols == 1).all()
    kc = K if fused_ln else min(K, mxint_matmul.MAX_CHUNK)
    assert mxint_matmul.gemm_smem_bytes(g.bm, g.bn, g.bk, g.ns, kc) <= \
        mxint_matmul.SMEM_LIMIT
    if M <= 16 and N in DECODE_N:
        assert g.grid[0] * g.grid[1] >= n_sm


def _byte_perm(a, b, sel):
    """CUDA __byte_perm: output byte i is byte (sel >> 4 i) & 7 of the
    8-byte value b:a."""
    src = (int(b) << 32) | int(a)
    return sum(((src >> (8 * ((sel >> (4 * i)) & 7))) & 0xFF) << (8 * i)
               for i in range(4))


def _bytes(v):
    return np.array([(v >> (8 * i)) & 0xFF for i in range(4)],
                    np.uint8).view(np.int8)


@pytest.mark.parametrize("bn", [4, 8, 16, 32, 64, 128])
def test_mma_fragments_from_staged_tile(bn):
    """A numpy model of the core's staging (``w_row``, ``w_stride``) and of
    the B-fragment loads and ``__byte_perm`` selectors of ``mma_block``
    (csrc/mxint_common.cuh): lane (g, t) must hold K rows 4t..4t+3 of one
    column in each n8 tile's register, as PTX's m16n8k16 .s8 B layout
    wants (rows 4t + i, column g, i-th byte); the 16-bit loads must be free
    of bank conflicts; and the C layout, stored as ``store_tile`` does,
    must give A @ W at the right columns."""
    rng = np.random.default_rng(bn)
    bk = 32
    W = rng.integers(-127, 128, size=(bk, bn)).astype(np.int8)
    ld = mxint_matmul.w_stride(bn)
    stage = np.zeros(bk * ld + 16 * ld, np.int8)        # rows read past bn
    for r in range(bk):
        s0 = mxint_matmul.w_row(r) * ld
        stage[s0:s0 + bn] = W[r]
    raw = stage.view(np.uint8)
    for wc in range(0, max(bn, 16), 16):
        live = min(16, bn - wc)                        # columns of the tile
        for kb in range(bk // 16):
            frag = {}
            for i in range(4):
                banks = {}
                for lane in range(32):
                    g, t = lane >> 2, lane & 3
                    off = (kb * 16 + t + 4 * i) * ld + wc + 2 * g
                    banks.setdefault((off // 4) % 32, set()).add(off // 4)
                    frag.setdefault(lane, []).append(
                        int(raw[off]) | (int(raw[off + 1]) << 8))
                assert all(len(w) == 1 for w in banks.values()), \
                    "bank conflict"
            A = rng.integers(-127, 128, size=(16, 16)).astype(np.int64)
            out = np.zeros((16, 16), np.int64)
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                x = frag[lane]
                x01 = _byte_perm(x[0], x[1], 0x5410)
                x23 = _byte_perm(x[2], x[3], 0x5410)
                b = [_bytes(_byte_perm(x01, x23, 0x6420)),
                     _bytes(_byte_perm(x01, x23, 0x7531))]
                for p in range(2):
                    col = 2 * g + p
                    if col < live:                     # PTX B layout
                        np.testing.assert_array_equal(
                            b[p], W[kb * 16 + 4 * t:kb * 16 + 4 * t + 4,
                                    wc + col])
            # D of n8 tile p per the PTX C layout, then store_tile's order
            Wk = W[kb * 16:kb * 16 + 16].astype(np.int64)
            cols = [wc + c for c in range(16)]
            Bt = [np.stack([Wk[:, c] if c < bn else np.zeros(16, np.int64)
                            for c in cols[p::2]], 1) for p in range(2)]
            D = [A @ Bt[p] for p in range(2)]
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                acc = [[D[p][g, 2 * t], D[p][g, 2 * t + 1],
                        D[p][g + 8, 2 * t], D[p][g + 8, 2 * t + 1]]
                       for p in range(2)]
                for h in range(2):
                    v = [acc[0][2 * h], acc[1][2 * h], acc[0][2 * h + 1],
                         acc[1][2 * h + 1]]
                    out[g + 8 * h, 4 * t:4 * t + 4] = v
            want = A @ np.stack([Wk[:, c] if c < bn else np.zeros(16, np.int64)
                                 for c in cols], 1)
            np.testing.assert_array_equal(out[:, :live], want[:, :live])


def _pow2_e8(e):
    """The core's pow2_e8: max((e + 127) << 23, 0x00400000) as f32 bits."""
    e = np.asarray(e, np.int32)
    return np.maximum((e + 127) << 23, 0x00400000).view(np.float32)


def test_block_scale_product_is_exact():
    """pow2_e8(e_a) * pow2_e8(e_w), rounded once, is pow2i(e_a + e_w) for
    every pair of int8 exponents: exact to 2^-149, 0 below, inf above."""
    e = np.arange(-127, 128, dtype=np.int32)
    with np.errstate(over="ignore", under="ignore"):
        got = _pow2_e8(e)[:, None] * _pow2_e8(e)[None, :]
    want = pow2i(torch.from_numpy(e[:, None] + e[None, :])).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert np.isinf(got[-1, -1]) and got[0, 0] == 0.0


def test_dot_bias_conversion_is_exact():
    """The mma's C input 0x4B400000: its int32 D = bias + dot, read as f32
    minus 1.5 * 2^23, is (float)dot for every |dot| <= 16 * 128 * 127."""
    lim = 16 * 128 * 127
    dot = np.concatenate([np.arange(-lim, -lim + 4097),
                          np.arange(-4096, 4097),
                          np.arange(lim - 4096, lim + 1)]).astype(np.int32)
    got = (dot + np.int32(0x4B400000)).view(np.float32) - \
        np.float32(12582912.0)
    np.testing.assert_array_equal(got, dot.astype(np.float32))
    assert not np.signbit(got[dot == 0]).any()


def test_bias_rounding_is_rint():
    """``quant_mant_small``: x * inv plus 1.5 * 2^23, read as int32 bits
    minus 0x4B400000, then clamped, is (int)quant_mant's rintf (half to
    even) and clamp for every |x * inv| < 2^22: the int8 LN stage's
    mantissas (|x * inv| < 2^(mant_bits - 1))."""
    rng = np.random.default_rng(3)
    v = np.concatenate([np.arange(-600, 601) / np.float32(4.0),
                        rng.uniform(-2.0 ** 21, 2.0 ** 21, 20000),
                        [2.0 ** 22 - 0.5, -2.0 ** 22 + 0.5, 0.0, -0.0,
                         127.5, -127.5, 128.5]]).astype(np.float32)
    for lim in (1, 7, 127, 2 ** 21):
        got = (v + np.float32(12582912.0)).view(np.int32) - 0x4B400000
        got = np.clip(got, -lim, lim)
        want = np.clip(np.rint(v), -lim, lim).astype(np.int32)
        np.testing.assert_array_equal(got, want)


def _core_model(x, w_mant, w_exp, w_block):
    """The core's epilogue in numpy float32: per act block in K order,
    acc = acc + ((bias + dot) as f32 - 1.5 * 2^23) * (pow2_e8(e_a) *
    pow2_e8(e_w)), each operation rounded once."""
    xm, xe = block_quantize_rows(x, 16, 8)
    xm = xm.numpy().astype(np.int64)
    xe = xe.numpy().astype(np.int32)
    wm = w_mant.numpy().astype(np.int64)
    we = w_exp.numpy().astype(np.int32)
    M, nb = xe.shape
    acc = np.zeros((M, wm.shape[1]), np.float32)
    with np.errstate(over="ignore", under="ignore", invalid="ignore"):
        for k in range(nb):
            dot = (xm[:, k] @ wm[16 * k:16 * k + 16]).astype(np.int32)
            v = (dot + np.int32(0x4B400000)).view(np.float32) - \
                np.float32(12582912.0)
            s = _pow2_e8(xe[:, k])[:, None] * \
                _pow2_e8(we[16 * k // w_block])[None, :]
            acc = acc + v * s
    return acc


@pytest.mark.parametrize("x_scale,w_scale,case", [
    (1.0, 1.0, "normal"), (2.0 ** -120, 1.0, "subnormal"),
    (2.0 ** -120, 2.0 ** -30, "flush"), (2.0 ** 110, 2.0 ** 30, "overflow")])
def test_core_epilogue_matches_plain_version(x_scale, w_scale, case):
    """The core's two rounded steps per block (no FMA) give the plain
    version's bits, also where e_a + e_w is below -126 (subnormal scales)
    or below -149, and where the products overflow."""
    rng = np.random.default_rng(7)
    M, K, N = 6, 512, 24
    x = torch.from_numpy((rng.normal(size=(M, K)) * x_scale)
                         .astype(np.float32))
    p = pack_weight(torch.from_numpy(
        (rng.normal(size=(K, N)) * K ** -0.5 * w_scale).astype(np.float32)),
        MXFormat(8, 256))
    got = _core_model(x, p.mantissa, p.exponent, p.block_size)
    want = mxint_matmul.matmul_blocks(x, p.mantissa, p.exponent,
                                      w_block=p.block_size, act_block=16,
                                      act_mant_bits=8).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    xe = block_quantize_rows(x, 16, 8)[1]
    s = xe.min() + int(p.exponent.min())
    if case == "subnormal":
        assert -149 <= s < -126
    if case == "flush":
        assert s < -149
    if case == "overflow":                  # inf products, inf - inf
        assert not np.isfinite(got).any()


@pytest.mark.parametrize("bits", [1, 17, 24])
def test_matmul_kernel_refuses_wide_act_mantissas(bits):
    """The GEMM core's act tile holds int16 at most: a mantissa of more
    than 16 bits would wrap in the cast, so the wrapper sends it to the
    generic route before it touches the card (as ``mxint_ln_matmul``
    does); below 2 bits no route takes it, and the wrapper raises."""
    if bits < 2:
        with pytest.raises(ValueError, match="act_mant_bits"):
            mxint_matmul.matmul_route(256, 256, 16, bits)
    else:
        assert mxint_matmul.matmul_route(256, 256, 16, bits) == "generic"


@pytest.mark.parametrize("bits", range(2, 17))
def test_matmul_kernel_takes_2_to_8_bit_act_mantissas(bits):
    """2-8 bits (an int8 act tile) and, since the act tile holds int16
    above 8 bits, 9-16: the GEMM core."""
    assert mxint_matmul.matmul_route(256, 256, 16, bits) == "core"


def test_wide_act_format_raises_before_any_launch():
    """``QuantConfig(mode="kernel", act_fmt=MXFormat(20, 16))`` and an act
    block of 12 reach ``mxint_matmul`` through every linear.  Both are now
    in the domain: the generic route takes 20-bit acts and the GEMM core,
    by segment, act block 12 (``matmul_route``), the plain version
    computes them on the CPU, as the reference does, and a tensor off the
    CPU (here a meta tensor) raises only at the device check, before
    anything is built or launched.  A format outside every route (act
    mantissas of 25 bits) raises in the route check."""
    from repro_torch.core.mx_types import QuantConfig
    from repro_torch.core.quantize import MXTensor
    from repro_torch.models.model_api import Param
    K, N = 96, 32
    before = ops.launch_counts()
    for fmt in (MXFormat(20, 16), MXFormat(8, 12)):
        q = QuantConfig(mode="kernel", act_fmt=fmt)
        assert mxint_matmul.matmul_route(K, 48, fmt.block_size,
                                         fmt.mant_bits) == (
            "generic" if fmt.mant_bits > 16 else "core")

        def linear(device):
            w = MXTensor(torch.zeros(K, N, dtype=torch.int8, device=device),
                         torch.zeros(K // 48, N, dtype=torch.int8,
                                     device=device), -2, 8, 48)
            x = torch.ones(3, K, device=device)
            return q.datapath.linear(x, Param(w, ("embed", "mlp")), q=q)

        with pytest.raises(ValueError, match="CUDA device"):
            linear("meta")
        assert linear("cpu").shape == (3, N)
    with pytest.raises(ValueError, match="act_mant_bits"):
        mxint_matmul.matmul_route(K, 48, 16, 25)
    assert ops.launch_counts() == before


# ---------------------------------------------------------------------------
# the widened act formats
# ---------------------------------------------------------------------------
WIDE_FORMATS = [(4, 8), (8, 8), (32, 8), (64, 8), (16, 10), (16, 12),
                (16, 16), (32, 12)]


def _wide_tol(block, bits, want):
    """The parity contract for the matmul kernels: bit for bit where both
    packages' block dots are exact (every partial sum below 2^24: 8-bit
    acts at any block here); past that the reference's f32 dot rounds its
    partial sums (terms up to 16 x 32767 x 127 > 2^24) and the plain
    version's (float64, rounded once) does not.  Measured: the matmul bit
    for bit at these seeds; the fused kernel at 16 bits 9 of 320 elements
    apart, by 6.5e-6 of the output scale; held to 2e-5 of it."""
    exact = block * (2 ** (bits - 1) - 1) * 127 < 2 ** 24
    return 0.0 if exact else 2e-5 * float(np.abs(want).max())


@pytest.mark.parametrize("block,bits", WIDE_FORMATS)
def test_matmul_wide_act_formats_plain_vs_pallas(block, bits):
    M, K, N = 10, 256, 40
    x = _x((M, K), seed=block + bits)
    p, jp = _planes(K, N, seed=N)
    got = mxint_matmul.mxint_matmul(_t(x), p.mantissa, p.exponent,
                                    w_block=p.block_size, act_block=block,
                                    act_mant_bits=bits, quantize_act=True)
    want = np.asarray(j_mm(jnp.asarray(x), jp.mantissa, jp.exponent,
                           w_block=jp.block_size, act_block=block,
                           act_mant_bits=bits, quantize_act=True, bm=M, bn=N,
                           bk=K, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=_wide_tol(block, bits, want))


@pytest.mark.parametrize("block,bits", WIDE_FORMATS)
def test_ln_matmul_wide_act_formats_plain_vs_pallas(block, bits):
    """f32 rows against the reference's fused kernel; the fused op equals
    LN then the linear op bit for bit, bf16 rows too (past 8 bits the LN
    output's round trip through bf16 rounds it, and the plain version
    quantizes the rounded values anew, as the reference does)."""
    M, d, N = 8, 256, 40
    x = _x((M, d), seed=3, scale=2.0)
    g = 1.0 + 0.1 * _x((d,), seed=4)
    b = 0.1 * _x((d,), seed=5)
    p, jp = _planes(d, N, seed=6)
    got = mxint_ln_matmul.mxint_ln_matmul(
        _t(x), _t(g), _t(b), p.mantissa, p.exponent, w_block=p.block_size,
        act_block=block, mant_bits=bits)
    want = np.asarray(j_lnmm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                             jp.mantissa, jp.exponent, w_block=jp.block_size,
                             act_block=block, mant_bits=bits, bm=M, bn=N,
                             interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=_wide_tol(block, bits, want))
    for xt in (_t(x), _t(x).to(torch.bfloat16)):
        fused = ops.mxint_ln_linear_op(xt, _t(g), _t(b), p.mantissa,
                                       p.exponent, w_block=p.block_size,
                                       act_block=block, mant_bits=bits)
        h = ops.mxint_layernorm_op(xt, _t(g), _t(b), act_block=block,
                                   mant_bits=bits, quantize_out=True)
        unfused = ops.mxint_linear(h.to(xt.dtype), p.mantissa, p.exponent,
                                   w_block=p.block_size, act_block=block,
                                   act_mant_bits=bits, quantize_act=True)
        np.testing.assert_array_equal(fused.float().numpy(),
                                      unfused.float().numpy())


@pytest.mark.parametrize("block", [32, 64, 128])
@pytest.mark.parametrize("kernel", ["layernorm", "softmax", "gelu"])
def test_row_kernels_wide_blocks_plain_vs_pallas(kernel, block):
    """Act blocks past 16: a block over 8, 16 or 32 float4 lanes on the
    card; the plain versions against the Pallas functions, bit for bit
    (the LN variance and the softmax sum run in another order: measured,
    no flip at these seeds)."""
    if kernel == "layernorm":
        x = _x((5, 768), seed=block, scale=2.0)
        x[0, :block] *= np.float32(40.0)
        g, b = 1.0 + 0.1 * _x((768,), seed=1), 0.1 * _x((768,), seed=2)
        got = mxint_layernorm.mxint_layernorm(_t(x), _t(g), _t(b),
                                              act_block=block,
                                              quantize_out=True)
        want = j_ln(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                    act_block=block, quantize_out=True, block_rows=5,
                    interpret=True)
    elif kernel == "softmax":
        x = _x((4, 256), seed=block, scale=4.0)
        got = mxint_softmax.mxint_softmax(_t(x), act_block=block,
                                          quantize_out=True)
        want = j_sm(jnp.asarray(x), act_block=block, quantize_out=True,
                    block_rows=4, interpret=True)
    else:
        x = _x((6, 256), seed=block, scale=3.0)
        x[2, :block] = np.float32(5.0)
        got = mxint_gelu.mxint_gelu(_t(x), act_block=block)
        want = j_gelu(jnp.asarray(x), act_block=block, block_rows=6,
                      interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("rows,d,block,threads", [
    (3152, 768, 32, 512), (37, 768, 64, 256), (24, 768, 128, 512),
    (16, 768, 256, 256), (4, 4096, 256, 512), (8, 768, 128, 256)])
def test_ln_stage_walk_wide_blocks(rows, d, block, threads):
    """Blocks of 32-256 on the vector route: each block is G = block / 4
    consecutive threads of one warp step, aligned to G (up to a warp: its
    xor partners; 64: the two warps of an aligned pair, which meet at their
    named barrier in ``wide_group_max``), every lane of a block in the same step
    (the shuffles and the barrier need every lane)."""
    assert mxint_layernorm.ln_piece(block, True) == 4
    assert mxint_layernorm.ln_piece(block, False) == 0
    walk, n, ppr, steps = _ln_walk(min(rows, 32), d, block, 4, threads)
    G = block // 4
    groups = {}
    for k, t, r, j in walk:
        groups.setdefault((r, j // block), []).append((k, t))
    for members in groups.values():
        ts = sorted(t for _, t in members)
        assert len({k for k, _ in members}) == 1
        assert ts == list(range(ts[0], ts[0] + G)) and ts[0] % G == 0
        if G > WARP:
            assert ts[0] // WARP % 2 == 0 and G == 2 * WARP


@pytest.mark.parametrize("block", [1, 2, 4, 8])
def test_block_mask_selects_each_blocks_columns(block):
    """``block_mask`` (csrc/mxint_common.cuh): for a block that divides 16,
    lane t's A word holds columns 4t..4t+3 of the k16 step; the mask keeps
    exactly the bytes of block j, so the j-th mma's dot is block j's."""
    def block_mask(rel, n):
        s, e = min(max(rel, 0), 4), min(max(rel + n, 0), 4)
        return ((1 << (8 * e)) - (1 << (8 * s))) & 0xFFFFFFFF

    for j in range(16 // block):
        for t in range(4):
            m = block_mask(j * block - 4 * t, block)
            cols = [4 * t + i for i in range(4) if (m >> (8 * i)) & 0xFF]
            assert all((m >> (8 * i)) & 0xFF in (0, 0xFF) for i in range(4))
            assert cols == [c for c in range(4 * t, 4 * t + 4)
                            if j * block <= c < (j + 1) * block]


def test_wide_act_mantissa_split_is_exact():
    """9-16-bit act mantissas: the int16 tile's little-endian bytes taken
    by ``__byte_perm`` 0x6420 (low bytes, u8) and 0x7531 (high bytes, s8)
    of a lane's two words give m = 256 hi + lo for every int16, and a
    block's dot of 256 * (hi . w) + (lo . w) is the exact dot, in int32,
    up to 256 elements of 16 bits against 8-bit weights."""
    m = np.append(np.arange(-32767, 32768), 0).astype(np.int16)
    raw = m.view(np.uint8).reshape(-1, 8)         # 4 int16 = two words
    words = raw.view("<u4").reshape(-1, 2)
    lo = np.array([_byte_perm(a, b, 0x6420) for a, b in words[::97]],
                  np.uint32)
    hi = np.array([_byte_perm(a, b, 0x7531) for a, b in words[::97]],
                  np.uint32)
    lo_b = lo.view(np.uint8).astype(np.int64).reshape(-1, 4)
    hi_b = hi.view(np.uint8).view(np.int8).astype(np.int64).reshape(-1, 4)
    want = m.reshape(-1, 4)[::97].astype(np.int64)
    np.testing.assert_array_equal(hi_b * 256 + lo_b, want)
    rng = np.random.default_rng(0)
    a = rng.integers(-32767, 32768, size=(64, 256))
    w = rng.integers(-127, 128, size=(256, 8))
    a[0], w[:, 0] = 32767, 127                    # the largest dot
    dot = a @ w
    hi_a, lo_a = a >> 8, a & 0xFF
    np.testing.assert_array_equal(256 * (hi_a @ w) + lo_a @ w, dot)
    assert np.abs(dot).max() < 2 ** 31 and np.abs(hi_a @ w).max() < 2 ** 31


@pytest.mark.parametrize("block,wide", [(16, False), (4, False), (1, False),
                                        (32, False), (256, False),
                                        (16, True), (32, True), (1, True),
                                        (256, True)])
@pytest.mark.parametrize("M,N,K,fused_ln", [
    (3152, 768, 3072, False), (3152, 3072, 768, True), (4, 4096, 4096, True),
    (4, 4096, 14336, False), (1024, 4096, 14336, False),
    (33, 1024, 14336, False)])
def test_gemm_geometry_act_formats(M, N, K, fused_ln, block, wide):
    """Every act format's tiles fit the H100's shared memory; bk and the
    staged chunk are whole act blocks (and k16 steps); a K longer than
    the chunk is walked in chunks (at most MAX_ACC_TILES column tiles a
    CTA); the fused kernel holds its whole rows; and the default format's
    geometry is the one the default arguments give."""
    g = mxint_matmul.gemm_geometry(M, N, K, 132, fused_ln=fused_ln,
                                   act_block=block, wide=wide)
    unit = max(block, 16)
    kc = K if fused_ln else g.kc
    assert g.bk % unit == 0 and kc % unit == 0 and g.kc <= max(
        K, mxint_matmul.MAX_CHUNK)
    assert g.chunked == (K > g.kc) and (not fused_ln or not g.chunked)
    if g.chunked:
        assert g.n_per <= mxint_matmul.MAX_ACC_TILES
    assert mxint_matmul.gemm_smem_bytes(g.bm, g.bn, g.bk, g.ns, kc, block,
                                        2 if wide else 1) <= \
        mxint_matmul.SMEM_LIMIT
    if block == 16 and not wide:
        assert g == mxint_matmul.gemm_geometry(M, N, K, 132,
                                               fused_ln=fused_ln)


@pytest.mark.parametrize("block,w_block,ok", [
    (1, 256, True), (2, 32, True), (4, 256, True), (8, 256, True),
    (16, 16, True), (32, 256, True), (256, 256, True), (64, 32, False),
    (12, 48, False), (24, 48, False), (512, 512, False), (3, 48, False)])
def test_act_block_domain(block, w_block, ok):
    """The act blocks that nest (the GEMM core's V 0-2); the core runs the
    others by segment (V 3), so every one takes the core."""
    assert mxint_matmul.act_block_ok(block, w_block) == ok
    assert mxint_matmul.segmented(block, w_block) == (not ok)
    K = 2 * max(block, w_block) * 3
    assert mxint_matmul.matmul_route(K, w_block, block, 8) == "core"


# (K, w_block, act block, plane dtype, act bits, fused LN) the GEMM core
# takes by segment: act blocks that do not nest (DeiT's 12 against 256;
# 24 on 96-blocks, 48 on 128-blocks; 512 across 256-blocks; 3, 40, 100), int16
# planes at nested and other blocks, 9-16-bit acts (four mmas a step)
SEGMENT_FORMATS = [
    (48, 16, 12, torch.int8, 8, False), (3072, 256, 12, torch.int16, 8, False),
    (768, 256, 12, torch.int16, 8, True), (3072, 256, 12, torch.int8, 8, False),
    (768, 96, 24, torch.int8, 8, False), (768, 128, 48, torch.int8, 8, False),
    (3072, 256, 512, torch.int8, 8, False), (288, 48, 3, torch.int16, 8, True),
    (640, 64, 40, torch.int8, 8, False), (3200, 128, 100, torch.int8, 6, False),
    (3072, 256, 16, torch.int16, 8, False), (768, 256, 16, torch.int16, 12, True),
    (3072, 256, 16, torch.int16, 12, False), (768, 256, 12, torch.int16, 12, True),
    (12288, 256, 12, torch.int16, 8, False), (4096, 4096, 32, torch.int16, 8, True),
]


@pytest.mark.parametrize("M", [3152, 4])
@pytest.mark.parametrize("K,w_block,block,w_dtype,bits,fused", SEGMENT_FORMATS)
def test_segment_walk_geometry_and_byte_split(K, w_block, block, w_dtype,
                                              bits, fused, M):
    """The GEMM core's segment walk (V 3-4), modelled on the CPU: over the
    stages and chunks of the format's own geometry, its pieces (step,
    columns, segment end) join into exactly ``segments()``, each piece
    inside one k16 step, and each lane's ``block_mask`` keeps exactly the
    piece's columns of its A word; the act block a piece reads is the one
    of its columns.  ``launch_config`` of the format returns the core's
    segment instance within the H100's shared memory at 132 SMs.  And the
    int16 plane split: 256 hi + lo restores every int16, and the
    ``load_b16`` selectors give each lane the PTX B layout of both bytes
    from the staged tile, free of bank conflicts."""
    N = 768
    assert mxint_matmul.matmul_route(K, w_block, block, bits,
                                     w_dtype) == "core"
    w_bytes = mxint_matmul.PLANE_BYTES[w_dtype]
    assert mxint_matmul.segmented(block, w_block, w_bytes)
    if fused:
        rec = mxint_ln_matmul.launch_config(
            M, N, K, w_block=w_block, act_block=block, mant_bits=bits,
            lut_bits=13, n_sm=132, w_dtype=w_dtype)
    else:
        rec = mxint_matmul.launch_config(
            M, N, K, w_block=w_block, act_block=block, act_mant_bits=bits,
            n_sm=132, w_dtype=w_dtype)
    V = 4 if bits > 8 else 3
    assert rec.function.endswith(f"V{V}>") and rec.args[-1] == w_bytes
    assert rec.smem <= mxint_matmul.SMEM_LIMIT
    g = mxint_matmul.gemm_geometry(M, N, K, 132, fused_ln=fused,
                                   act_block=block, wide=bits > 8,
                                   w_bytes=w_bytes, seg=True)
    kc = K if fused else g.kc
    assert g.bk % 16 == 0 and kc % mxint_matmul.seg_unit(block) == 0
    assert (g.bm, g.bn, g.n_per, g.bk, g.ns) == rec.args[1 if fused else 0:][:5]
    pieces = mxint_matmul.segment_walk(K, w_block, block, g.bk, kc)
    starts, lens = mxint_matmul.segments(K, w_block, block)
    got, s0 = [], 0
    for step, p0, p1, ends in pieces:
        assert 16 * step <= p0 < p1 <= 16 * step + 16
        assert p0 == (got[-1][1] if got and not got[-1][2] else s0)
        if not got or got[-1][2]:
            got.append([p0, p1, ends])
        else:
            got[-1][1:] = [p1, ends]
        s0 = p1
        for t in range(4):                  # lane group t: columns 4t..
            m = mxint_matmul.block_mask(p0 - 16 * step - 4 * t, p1 - p0)
            cols = {16 * step + 4 * t + i for i in range(4)
                    if (m >> (8 * i)) & 0xFF}
            assert cols == set(range(max(p0, 16 * step + 4 * t),
                                     min(p1, 16 * step + 4 * t + 4)))
    assert s0 == K and all(e for *_, e in got)
    assert [a for a, _, _ in got] == starts.tolist()
    assert [b - a for a, b, _ in got] == lens.tolist()
    # the int16 split, for every value: a signed high and unsigned low byte
    v = np.arange(-2 ** 15, 2 ** 15, dtype=np.int64)
    hi, lo = v >> 8, v & 0xFF
    assert (hi >= -128).all() and (hi <= 127).all() and (lo >= 0).all() \
        and (lo <= 255).all()
    np.testing.assert_array_equal(256 * hi + lo, v)
    if w_bytes == 2:
        _check_int16_fragments(g.bn)


def _check_int16_fragments(bn):
    """``load_b16``: lane (g, t) reads the 4-byte pieces of staged rows
    4 i + t (K rows 4 t + i) at columns 2 g, 2 g + 1 and splits them with
    its ``__byte_perm`` selectors into the high (s8) and low (u8) bytes of
    each column's K rows 4 t..4 t + 3, free of bank conflicts."""
    rng = np.random.default_rng(bn)
    W = rng.integers(-2 ** 15, 2 ** 15, size=(16, bn)).astype(np.int16)
    ld = mxint_matmul.w_stride(bn, 2)
    stage = np.zeros(16 * ld + 64, np.uint8)
    for r in range(16):
        s0 = mxint_matmul.w_row(r) * ld
        stage[s0:s0 + 2 * bn] = W[r].view(np.uint8)
    for wc in range(0, max(bn, 16), 16):
        words = {}
        for i in range(4):
            banks = {}
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                off = (t + 4 * i) * ld + 2 * (wc + 2 * g)
                banks.setdefault((off // 4) % 32, set()).add(off // 4)
                words.setdefault(lane, []).append(
                    int(stage[off:off + 4].view(np.uint32)[0]))
            assert all(len(w) == 1 for w in banks.values()), "bank conflict"
        for lane, x in words.items():
            g, t = lane >> 2, lane & 3
            l01, l23 = (_byte_perm(x[0], x[1], 0x6240),
                        _byte_perm(x[2], x[3], 0x6240))
            h01, h23 = (_byte_perm(x[0], x[1], 0x7351),
                        _byte_perm(x[2], x[3], 0x7351))
            lo = [_bytes(_byte_perm(l01, l23, 0x5410)).view(np.uint8),
                  _bytes(_byte_perm(l01, l23, 0x7632)).view(np.uint8)]
            hi = [_bytes(_byte_perm(h01, h23, 0x5410)),
                  _bytes(_byte_perm(h01, h23, 0x7632))]
            for p in range(2):
                col = wc + 2 * g + p
                if col < bn:
                    w = W[4 * t:4 * t + 4, col].astype(np.int64)
                    np.testing.assert_array_equal(hi[p], w >> 8)
                    np.testing.assert_array_equal(lo[p], w & 0xFF)
                    np.testing.assert_array_equal(
                        256 * hi[p].astype(np.int64) + lo[p], w)


@pytest.mark.parametrize("block,aligned,ok", [
    (16, False, True), (12, False, True), (32, True, True), (128, True, True),
    (32, False, False), (48, True, False), (256, True, False)])
def test_ln_route_domain(block, aligned, ok):
    """The row kernels take blocks up to 16 a thread at any alignment and
    powers of two up to 128 on aligned rows; the fused kernel's LN stage
    up to 256."""
    piece = mxint_layernorm.ln_piece(block, aligned)
    assert mxint_layernorm.ln_route_ok(block, piece) == ok
    assert mxint_layernorm.ln_route_ok(
        256, mxint_layernorm.ln_piece(256, True),
        mxint_layernorm.MAX_LN_BLOCK)
