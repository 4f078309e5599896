"""The plain versions of the two flash kernels against their Pallas
functions (interpret mode), through ``ops.attention_op`` (the online path)
and ``ops.attention_decode_op`` of both packages; and the masked
whole-row ('paper') attention against the reference's.

The plain version is what the op runs on the CPU and what the CUDA kernel
is held to on the card.  Inputs come from numpy with a seed; the reference
runs under two scoped fixes for the installed jax (the
``TPUCompilerParams`` alias and an exact ``exp2`` on integer inputs).

Tolerance: the q.k and P.V products and the row sum run in another order
than the reference's (XLA's dot and reduce against the kernel's fixed
order), and the float exp is the kernels' own (Cephes expf, about 1 ulp)
rather than XLA's, so scores differ in their last bits.  In float mode
that stays at the ulp level: 2e-6 of the output scale.  In mxint mode such
a difference can move a value across a LUT-index or an Eq. 2-3 / Eq. 20
rounding boundary, one LUT step (2^0.25) or one act-grid step of one
probability, which moves that query row's output (32 elements at most at
these seeds).  Each mxint case is held to 3-8 times the gap measured at
its seed (as a fraction of the output scale, in the case's comment): a
plain version without the interior P grid-requantize misses the reference
by 6.7e-3 to 1.3e-2 in the quantized cases, far outside.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from repro.core.mx_types import NEG_INF as J_NEG_INF  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.flash_attention import _PAD_FILL  # noqa: E402
from repro_torch.core.mx_types import NEG_INF  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402


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


def _x(shape, seed, scale=1.0):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return x * np.float32(scale)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _gap(got, want):
    want = np.asarray(want)
    return float(np.abs(got.numpy() - want).max()), \
        float(np.abs(want).max())


def test_sentinels_equal_reference():
    assert NEG_INF == J_NEG_INF
    assert fa.PAD_FILL == _PAD_FILL


# (causal, window, kv_groups, exp_mode, quantize_scores, S, tolerance as a
# fraction of the output scale); S = 300 leaves a 44-key padded last tile
FLASH_CASES = [
    (True, 0, 1, "float", False, 256, 2e-6),      # measured 2.7e-7
    (True, 100, 2, "float", False, 300, 2e-6),    # measured 3.6e-7
    (False, 0, 4, "float", False, 300, 2e-6),     # measured 5.0e-7
    (True, 0, 2, "mxint", False, 256, 1e-3),      # measured 2.2e-4
    (False, 0, 2, "mxint", True, 256, 2e-6),      # measured 3.6e-7
    (True, 0, 1, "mxint", True, 300, 5e-7),       # measured 1.4e-7
    (True, 64, 4, "mxint", True, 256, 2e-7),      # measured 3.6e-8
    (True, 200, 4, "mxint", True, 300, 3e-3),     # measured 1.0e-3
]


@pytest.mark.parametrize(
    "causal,window,groups,exp_mode,quantize,S,tol", FLASH_CASES,
    ids=[f"{'causal' if c[0] else 'full'}-w{c[1]}-g{c[2]}-{c[3]}"
         f"{'-q' if c[4] else ''}-S{c[5]}" for c in FLASH_CASES])
def test_flash_plain_vs_pallas(causal, window, groups, exp_mode, quantize, S,
                               tol):
    b, hkv, d = 1, 2, 32
    h = hkv * groups
    q = _x((b, h, S, d), 1, 1.5)
    k = _x((b, hkv, S, d), 2, 1.5)
    v = _x((b, hkv, S, d), 3)
    kw = dict(causal=causal, window=window, exp_mode=exp_mode,
              quantize_scores=quantize, softmax_variant="online")
    got = ops.attention_op(_t(q), _t(k), _t(v), **kw)
    want = jops.attention_op(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             **kw)
    gap, scale = _gap(got, want)
    assert got.shape == (b, h, S, d)
    assert gap <= tol * scale, (gap, scale)


# (kv_groups G, exp_mode, quantize_scores, W, tolerance); W = 300 pads
DECODE_CASES = [
    (2, "float", False, 300, 2e-6),               # measured 2.1e-7
    (4, "float", False, 256, 2e-6),               # measured 3.9e-7
    (2, "mxint", True, 300, 5e-7),                # measured 1.2e-7
    (4, "mxint", True, 300, 3e-7),                # measured 6.7e-8
    (4, "mxint", False, 300, 2e-6),               # measured 3.8e-7
]


@pytest.mark.parametrize(
    "g,exp_mode,quantize,W,tol", DECODE_CASES,
    ids=[f"g{c[0]}-{c[1]}{'-q' if c[2] else ''}-W{c[3]}"
         for c in DECODE_CASES])
def test_decode_plain_vs_pallas(g, exp_mode, quantize, W, tol):
    b, hkv, d = 3, 2, 32
    q = _x((b, hkv, g, d), 4, 1.5)
    k = _x((b, W, hkv, d), 5, 1.5)
    v = _x((b, W, hkv, d), 6)
    # ragged per-row validity: a short row, a ring that wrapped (a hole in
    # the middle), and a full row
    valid = np.zeros((b, W), np.int32)
    valid[0, :37] = 1
    valid[1, :] = 1
    valid[1, 150:170] = 0
    valid[2, :] = 1
    kw = dict(exp_mode=exp_mode, quantize_scores=quantize)
    got = ops.attention_decode_op(_t(q), _t(k), _t(v), _t(valid), **kw)
    want = jops.attention_decode_op(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), jnp.asarray(valid), **kw)
    gap, scale = _gap(got, want)
    assert got.shape == (b, hkv, g, d)
    assert gap <= tol * scale, (gap, scale)


# head dim 256, 10 query heads over one KV head (RecurrentGemma-2B's local
# attention): (causal, window, exp_mode, quantize_scores, S, tolerance)
WIDE_FLASH_CASES = [
    (True, 128, "mxint", True, 300, 5e-7),        # measured 7.7e-8
    (True, 0, "float", False, 260, 2e-6),         # measured 5.1e-7
]


@pytest.mark.parametrize(
    "causal,window,exp_mode,quantize,S,tol", WIDE_FLASH_CASES,
    ids=[f"d256-g10-w{c[1]}-{c[2]}{'-q' if c[3] else ''}-S{c[4]}"
         for c in WIDE_FLASH_CASES])
def test_flash_plain_vs_pallas_head_dim_256(causal, window, exp_mode,
                                            quantize, S, tol):
    """The plain version at head dim 256 (the widened kernels' width),
    10 query heads reading one KV head, against the reference's Pallas
    ``flash_attention``."""
    b, hkv, g, d = 1, 1, 10, 256
    q = _x((b, hkv * g, S, d), 11, 1.5)
    k = _x((b, hkv, S, d), 12, 1.5)
    v = _x((b, hkv, S, d), 13)
    kw = dict(causal=causal, window=window, exp_mode=exp_mode,
              quantize_scores=quantize, softmax_variant="online")
    got = ops.attention_op(_t(q), _t(k), _t(v), **kw)
    want = jops.attention_op(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             **kw)
    gap, scale = _gap(got, want)
    assert got.shape == (b, hkv * g, S, d)
    assert gap <= tol * scale, (gap, scale)


@pytest.mark.parametrize("quantize", [True, False], ids=["mxint-q", "mxint"])
def test_decode_plain_vs_pallas_head_dim_256(quantize):
    """The decode plain version at head dim 256, G 10 over one KV head, on
    a ring of 300 slots: a short row, a wrapped window ring (a hole where
    the window's first slot is) and a full row."""
    b, hkv, g, d, W = 3, 1, 10, 256, 300
    q = _x((b, hkv, g, d), 14, 1.5)
    k = _x((b, W, hkv, d), 15, 1.5)
    v = _x((b, W, hkv, d), 16)
    valid = np.zeros((b, W), np.int32)
    valid[0, :37] = 1
    valid[1, :] = 1
    valid[1, 200:201] = 0
    valid[2, :] = 1
    kw = dict(exp_mode="mxint", quantize_scores=quantize)
    got = ops.attention_decode_op(_t(q), _t(k), _t(v), _t(valid), **kw)
    want = jops.attention_decode_op(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), jnp.asarray(valid), **kw)
    gap, scale = _gap(got, want)
    # measured: 1.3e-7 with quantized scores, 5.8e-7 without
    assert got.shape == (b, hkv, g, d)
    assert gap <= (1e-6 if quantize else 2e-6) * scale, (gap, scale)


def test_head_dims_past_256_raise():
    """272 is past the widest head dim the fast kernels take: no op raises
    any more.  Both ops compute on the CPU, and on the card both take the
    generic route (``flash_route``, ``decode_route``), whose record fits
    the card; a head dim whose rows do not fit shared memory still
    raises."""
    q = torch.from_numpy(_x((10, 8, 272), 7))
    o = fa.flash_attention(q, q[:1], q[:1], kv_groups=10)
    d = fa.flash_attention_decode(q[None, :1, :2], q[None, :, :1],
                                  q[None, :, :1],
                                  torch.ones(1, 10, dtype=torch.int32))
    assert o.shape == q.shape and d.shape == (1, 1, 2, 272)
    assert bool(torch.isfinite(o).all() and torch.isfinite(d).all())
    assert fa.flash_route(torch.bfloat16, 272, 10, 16, 2) == "generic"
    assert fa.decode_route(272, 16, 2) == "generic"
    assert "generic" in fa.launch_config(10, 8, 8, 272, kv_groups=10).function
    with pytest.raises(ValueError, match="head dims"):
        fa.launch_config(2, 8, 8, 40000)


# (causal, window, kv_groups, S): masked whole-row attention, S <= 512
PAPER_CASES = [
    (True, 0, 1, 197),                            # measured 7.7e-8
    (True, 64, 2, 256),                           # measured 5.8e-8
    (False, 100, 4, 300),                         # measured 6.6e-7
    (True, 0, 4, 512),                            # measured 1.7e-7
    (True, 200, 2, 512),                          # measured 5.8e-8
]


@pytest.mark.parametrize(
    "causal,window,groups,S", PAPER_CASES,
    ids=[f"{'causal' if c[0] else 'full'}-w{c[1]}-g{c[2]}-S{c[3]}"
         for c in PAPER_CASES])
def test_paper_attention_masked_vs_pallas(causal, window, groups, S):
    """The 'paper' path with the causal/window masks (NEG_INF before the
    softmax kernel, p zeroed after) and GQA folded KV-major.  The score
    and P.V products are f32 matmuls in another order than XLA's, so a
    score can sit one ulp off and move one probability by one act-grid
    step: held to 3e-6 of the output scale (measured gaps in the cases'
    comments)."""
    b, hkv, d = 1, 2, 32
    h = hkv * groups
    q = _x((b, h, S, d), 11, 1.5)
    k = _x((b, hkv, S, d), 12, 1.5)
    v = _x((b, hkv, S, d), 13)
    kw = dict(causal=causal, window=window, softmax_variant="paper")
    got = ops.attention_op(_t(q), _t(k), _t(v), **kw)
    want = jops.attention_op(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             **kw)
    gap, scale = _gap(got, want)
    assert got.shape == (b, h, S, d)
    assert gap <= 3e-6 * scale, (gap, scale)


def test_decode_equals_flash_rows_of_one_query():
    """The two plain versions share one key loop: a decode row equals the
    non-causal flash row of the same query over the same keys."""
    b, hkv, g, d, W = 1, 2, 2, 16, 200
    q, k, v = _x((b, hkv, g, d), 7), _x((b, W, hkv, d), 8), \
        _x((b, W, hkv, d), 9)
    kw = dict(exp_mode="mxint", quantize_scores=True)
    dec = ops.attention_decode_op(_t(q), _t(k), _t(v),
                                  torch.ones(W, dtype=torch.int32), **kw)
    fl = ops.attention_op(_t(q.reshape(b, hkv * g, 1, d)),
                          _t(k.transpose(0, 2, 1, 3)),
                          _t(v.transpose(0, 2, 1, 3)), causal=False, **kw)
    assert torch.equal(dec.reshape(-1), fl.reshape(-1))


# (S, window, exp_mode, quantize_scores): causal, G = 4; S = 300 leaves a
# padded last tile, window 256 at S = 650 skips leading tiles too
SKIP_CASES = [(S, w, mode, qs) for S, w in ((1024, 0), (300, 0), (650, 256))
              for mode, qs in (("mxint", True), ("float", False))]


@pytest.mark.parametrize(
    "S,window,exp_mode,quantize", SKIP_CASES,
    ids=[f"S{c[0]}-w{c[1]}-{c[2]}{'-q' if c[3] else ''}" for c in SKIP_CASES])
def test_flash_tile_skipping_is_exact(S, window, exp_mode, quantize):
    """The plain version walking each 128-position block over its
    ``tile_span`` only (trailing causal tiles and leading window tiles
    left out, the last visited tile run as an interior one plus the
    normalization-only epilogue) equals it walking every tile, bit for
    bit."""
    hkv, g, d = 1, 4, 32
    q = _t(_x((hkv * g, S, d), 21, 1.5))
    k = _t(_x((hkv, S, d), 22, 1.5))
    v = _t(_x((hkv, S, d), 23))
    kw = dict(causal=True, window=window, kv_groups=g, exp_mode=exp_mode,
              r_bits=2, quantize_scores=quantize, act_block=16, mant_bits=8,
              scale=fa.f32(d ** -0.5))
    n_tiles = -(-S // fa.TILE_K)
    spans = [fa.tile_span(b0, min(b0 + fa.TILE_K, S) - 1, n_tiles, True,
                          window) for b0 in range(0, S, fa.TILE_K)]
    assert spans[0] == (0, 0) and spans[-1][1] == n_tiles - 1
    if window:
        assert spans[-1][0] > 0
    skip = fa.flash_rows(q, k, v, skip_tiles=True, **kw)
    full = fa.flash_rows(q, k, v, skip_tiles=False, **kw)
    assert torch.isfinite(skip).all()
    assert torch.equal(skip, full)


# (kv_groups G, head dim D, exp_mode, quantize_scores)
TILE_STOP_CASES = [(g, d, mode, qs) for g in (1, 4, 8) for d in (32, 128)
                   for mode, qs in (("mxint", True), ("float", False))]


@pytest.mark.parametrize(
    "g,d,exp_mode,quantize", TILE_STOP_CASES,
    ids=[f"g{c[0]}-d{c[1]}-{c[2]}{'-q' if c[3] else ''}"
         for c in TILE_STOP_CASES])
def test_decode_tile_stop_is_exact(g, d, exp_mode, quantize):
    """The plain decode stopping each batch row at its last tile that
    holds a valid slot (that tile run as an interior one, then the
    normalization-only epilogue) equals it walking every tile of the ring,
    bit for bit: rows that end in the first tile, at and just past tile
    edges, mid-ring, in the padded last tile, with a hole, in a wrapped
    window ring (leading invalid slots), and with no valid slot at all."""
    hkv, W = 2, 600                       # 5 tiles, the last 88 keys wide
    ends = (37, 128, 129, 256, 300, W)
    b = len(ends) + 3
    valid = np.zeros((b, W), np.int32)
    for i, n in enumerate(ends):
        valid[i, :n] = 1
    valid[len(ends), :400] = 1            # a hole
    valid[len(ends), 150:170] = 0
    valid[len(ends) + 1, 200:450] = 1     # a wrapped window ring
    valid = _t(valid)                     # the last row has no valid slot
    assert fa.stop_tiles(valid) == [0, 0, 1, 1, 2, 4, 3, 3, 4]
    q = _t(_x((b, hkv, g, d), 31, 1.5))
    k = _t(_x((b, W, hkv, d), 32, 1.5))
    v = _t(_x((b, W, hkv, d), 33))
    kw = dict(exp_mode=exp_mode, r_bits=2, quantize_scores=quantize,
              act_block=16, mant_bits=8, scale=fa.f32(d ** -0.5))
    stop = fa.decode_rows(q, k, v, valid, skip_tiles=True, **kw)
    full = fa.decode_rows(q, k, v, valid, skip_tiles=False, **kw)
    assert torch.isfinite(stop).all()
    assert torch.equal(stop, full)


H100_SMS = 132
# (B, Hkv, G, D, bytes per element)
GEOMETRY_CASES = [(4, 8, 4, 128, 2), (1, 8, 4, 128, 2), (4, 4, 8, 128, 2),
                  (4, 8, 1, 64, 2), (4, 8, 1, 128, 4), (64, 8, 4, 128, 2),
                  (4, 8, 3, 100, 2), (4, 8, 12, 128, 2), (4, 8, 5, 128, 4)]


@pytest.mark.parametrize("b,hkv,g,d,size", GEOMETRY_CASES,
                         ids=[f"b{c[0]}-h{c[1]}-g{c[2]}-d{c[3]}-e{c[4]}"
                              for c in GEOMETRY_CASES])
def test_decode_geometry(b, hkv, g, d, size):
    """Every query row and column falls in exactly one CTA; slices are
    whole 16-byte chunks that fit the shared-memory budget, split no
    further than filling the SMs or one P.V chain per thread needs."""
    rows, cols, n_split = fa.decode_geometry(b, hkv, g, d, size, H100_SMS)
    row_blocks = -(-g // rows)
    assert 1 <= rows <= fa.DECODE_MAX_ROWS and (row_blocks - 1) * rows < g
    assert row_blocks == -(-g // fa.DECODE_MAX_ROWS)
    assert cols * size % 16 == 0 and cols * size <= fa.DECODE_SLICE_BYTES
    assert (n_split - 1) * cols < d <= n_split * cols
    ctas = b * hkv * row_blocks * n_split
    if n_split > 1:
        # one slice fewer would leave SMs idle or threads with two chains
        assert b * hkv * row_blocks * (n_split - 1) < H100_SMS \
            or rows * -(-d // (n_split - 1)) > fa.DECODE_THREADS \
            or -(-d // (n_split - 1)) * size > fa.DECODE_SLICE_BYTES
    if (b, hkv, g, d, size) == (4, 8, 4, 128, 2):   # Llama-3-8B, batch 4
        assert (rows, cols, n_split, ctas) == (4, 32, 4, 128)


def test_flash_tol_share_catches_a_skipped_requantize(monkeypatch):
    """The card holds bf16 ``flash_attention`` with quantized scores to
    ``chip_smoke.FLASH_TOL``.  A plain version that leaves P off the act
    grid moves most rows; a tensor-core sum that rounds a tie the other
    way moves a few rows, by as much or more.  So the share of elements
    within one bf16 ulp, not the largest gap, is what catches the fault:
    here it falls far below the card's limit."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    share_limit = cs.FLASH_TOL[(True, True)][0]
    q = _t(_x((4, 300, 64), 41, 1.5)).to(torch.bfloat16)
    k = _t(_x((1, 300, 64), 42, 1.5)).to(torch.bfloat16)
    v = _t(_x((1, 300, 64), 43)).to(torch.bfloat16)
    kw = dict(causal=True, window=0, kv_groups=4, exp_mode="mxint", r_bits=2,
              quantize_scores=True, act_block=16, mant_bits=8,
              scale=fa.f32(0.125))
    want = fa.flash_rows(q, k, v, **kw).to(torch.bfloat16)
    monkeypatch.setattr(fa, "_grid", lambda y, block, mant_bits: y)
    bad = fa.flash_rows(q, k, v, **kw).to(torch.bfloat16)
    share, _ = cs.within_bf16_ulp(torch, bad, want)
    assert share < 0.9 < share_limit, share


def test_tile_span_bounds():
    assert fa.tile_span(0, 127, 8, True, 0) == (0, 0)
    assert fa.tile_span(992, 1023, 8, True, 0) == (0, 7)
    assert fa.tile_span(32, 63, 8, False, 0) == (0, 7)
    assert fa.tile_span(512, 639, 6, True, 256) == (2, 4)
    # a window past every key still visits the last tile
    assert fa.tile_span(900, 960, 2, False, 10) == (1, 1)


def test_bf16_cpu_tensor_runs_the_plain_version():
    """On a CPU tensor the op runs the plain version whatever the dtype;
    the dtype only picks the CUDA kernel."""
    q = _t(_x((4, 200, 16), 24)).to(torch.bfloat16)
    k = _t(_x((1, 200, 16), 25)).to(torch.bfloat16)
    v = _t(_x((1, 200, 16), 26)).to(torch.bfloat16)
    before = fa.launches
    got = fa.flash_attention(q, k, v, causal=True, exp_mode="mxint",
                             quantize_scores=True, kv_groups=4)
    want = fa.flash_rows(q, k, v, causal=True, window=0, kv_groups=4,
                         exp_mode="mxint", r_bits=2, quantize_scores=True,
                         act_block=16, mant_bits=8, scale=fa.f32(0.25))
    assert got.dtype == torch.bfloat16 and fa.launches == before
    assert torch.equal(got, want.to(torch.bfloat16))


def test_kernel_route_by_dtype():
    """bf16 takes the tensor-core kernel, float32 the ordered one; a bf16
    head dim that is not a multiple of 16 raises."""
    assert fa.kernel_route(torch.bfloat16, 128, 4) == "mma"
    assert fa.kernel_route(torch.bfloat16, 16, 1) == "mma"
    assert fa.kernel_route(torch.float32, 100, 4) == "ordered"
    # head dims past 128: two warps a row group, 64 query rows a block
    assert fa.kernel_route(torch.bfloat16, 256, 10) == "mma"
    assert fa.kernel_route(torch.bfloat16, 160, 64) == "mma"
    assert fa.kernel_route(torch.float32, 256, 10) == "ordered"
    with pytest.raises(NotImplementedError, match="kv_groups 65 > 64"):
        fa.kernel_route(torch.bfloat16, 256, 65)
    with pytest.raises(NotImplementedError, match="multiple of 16"):
        fa.kernel_route(torch.bfloat16, 72, 4)
    with pytest.raises(NotImplementedError, match="kv_groups"):
        fa.kernel_route(torch.bfloat16, 64, 256)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.kernel_route(torch.float16, 64, 1)


def test_flash_ops_check_their_arguments():
    q = torch.zeros(2, 8, 272)
    with pytest.raises(ValueError, match="exp_mode"):
        fa.flash_attention(q, q, q, exp_mode="exp")
    with pytest.raises(ValueError, match="mxint"):
        fa.flash_attention(q[..., :16], q[..., :16], q[..., :16],
                           quantize_scores=True)
    with pytest.raises(ValueError, match="kv_groups"):
        fa.flash_attention(q[..., :16], q[:1, :, :16], q[:1, :, :16])


def test_cpu_calls_do_not_count_launches():
    before = (fa.launches, fa.decode_launches)
    q = torch.from_numpy(_x((2, 130, 16), 10))
    fa.flash_attention(q, q, q)
    fa.flash_attention_decode(q[None, :, :2], q[None].transpose(1, 2),
                              q[None].transpose(1, 2),
                              torch.ones(1, 130, dtype=torch.int32))
    assert (fa.launches, fa.decode_launches) == before
