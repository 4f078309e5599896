"""The port's recurrent mixers (``repro_torch.models.recurrent``) against
the reference's (``repro.models.recurrent``), function for function, on
the same numpy-seeded inputs and the reference's own parameters.

Widths are small (d 32, lru width 32, 2 heads of 16); every function runs
in "off" and in "sim" (the MXInt non-linears: the mLSTM exp gate through
the Eq. 14-19 pow2 LUT), and the blocks and scans (which call every gate,
step and cell) also in kernel mode, where the port's linears and GELU run
their kernels' plain versions and the reference its Pallas kernels in
interpret mode, under the scoped fixes of ``test_torch_lm.py`` (its
``jax_reference`` fixture).  The reference's functions are jitted at
``xla_backend_optimization_level`` 0, as the LM tests do.

Tolerances: the port computes the gates' transcendentals (sigmoid,
softplus, exp, tanh) and the mLSTM's products, sums and cumulative sums
in float64 rounded once to float32, XLA in float32; the results differ
in the last bits (measured: at most 3.6e-7 of the scale in any case
here), and in sim and kernel mode a value next to an MXInt rounding
boundary could move one act-grid step in the next linear (about 1% of a
value; none moved at these inputs).  Each case is held to ``TOL`` of its
output's scale; the measured gaps are written beside it.  The
associative scan, fed the same (a, b), and the temporal convolution are
bit for bit.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import recurrentgemma_2b as jrg  # noqa: E402
from repro.configs import xlstm_350m as jxl  # noqa: E402
from repro.core.mx_types import MXINT8_WEIGHT as J_W8  # noqa: E402
from repro.core.mx_types import QuantConfig as JQuantConfig  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.models import recurrent as JR  # noqa: E402
from repro.models.model_api import unwrap  # noqa: E402
from repro.serving.engine import make_slot_prefill_step as j_slot  # noqa: E402
from repro.serving.engine import pack_params_mxint as j_pack  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import recurrentgemma_2b as rg  # noqa: E402
from repro_torch.configs import xlstm_350m as xl  # noqa: E402
from repro_torch.core.mx_types import MXINT8_WEIGHT, QuantConfig  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import recurrent as R  # noqa: E402
from repro_torch.models.model_api import Param  # noqa: E402
from repro_torch.models.transformer import DecoderLM  # noqa: E402
from repro_torch.serving.engine import (make_slot_prefill_step,  # noqa: E402
                                        pack_params_mxint)
from test_torch_lm import jax_reference  # noqa: E402,F401  (fixture)

MODES = {"off": dict(mode="off"),
         "sim": dict(mode="sim", quantize_nonlinear=True),
         "kernel": dict(mode="kernel", quantize_nonlinear=True)}
# the gates, steps and cells alone; the blocks and scans run them in all
# three modes
PARTS = ("off", "sim")
# largest gap over the output's scale, per mode (see the module note;
# measured at most 3.6e-7 in "off", 2.0e-7 in "sim" and kernel mode: no
# act-grid step moved at these inputs)
TOL = {"off": 1e-6, "sim": 1e-6, "kernel": 1e-6}
JCFG = dataclasses.replace(jrg.SMOKE, d_model=32, lru_width=32, n_heads=2,
                           n_kv_heads=1, head_dim=16)
PCFG = dataclasses.replace(rg.SMOKE, d_model=32, lru_width=32, n_heads=2,
                           n_kv_heads=1, head_dim=16)


def _ref_jit(fn):
    return jax.jit(fn, compiler_options={"xla_backend_optimization_level": 0})


def _port_params(jparams):
    return {k: Param(torch.from_numpy(np.array(v.value, np.float32)),
                     v.axes) for k, v in jparams.items()}


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) *
            scale).astype(np.float32)


def _gap(got, want, tol):
    """Largest |got - want| over want's scale; asserts it is <= tol."""
    got = np.asarray(got.detach() if hasattr(got, "detach") else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    gap = float(np.abs(got - want).max()) / scale
    assert gap <= tol, (gap, tol)
    return gap


def _quants(mode):
    return JQuantConfig(**MODES[mode]), QuantConfig(**MODES[mode])


@pytest.fixture(scope="module")
def rglru():
    jp = JR.init_rglru_params(jax.random.key(1), JCFG, jnp.float32)
    return jp, _port_params(jp)


@pytest.fixture(scope="module")
def mlstm():
    jp = JR.init_mlstm_params(jax.random.key(2), JCFG, jnp.float32)
    return jp, _port_params(jp)


@pytest.fixture(scope="module")
def slstm():
    jp = JR.init_slstm_params(jax.random.key(3), JCFG, jnp.float32)
    return jp, _port_params(jp)


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [1, 2, 5, 16, 37, 64])
def test_associative_scan_bit_for_bit(n):
    """The port's odd/even recursion on the reference's combine: the same
    products in the same order, so the same bits at any length."""
    a = np.random.default_rng(n).uniform(0.05, 1.0, (2, n, 8)).astype(
        np.float32)
    b = _x((2, n, 8), n + 100)

    def combine(c1, c2):
        return c1[0] * c2[0], c2[0] * c1[1] + c2[1]

    want = _ref_jit(lambda a, b: jax.lax.associative_scan(
        combine, (a, b), axis=1))(a, b)
    got = R.associative_scan(torch.from_numpy(a), torch.from_numpy(b))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("mode", PARTS)
def test_rglru_gates(rglru, mode):
    jp, pp = rglru
    jq, pq = _quants(mode)
    x = _x((2, 16, 32), 4)
    wa, wb = _ref_jit(lambda p, x: JR._rglru_gates(p, x, jq))(jp, x)
    ga, gb = R._rglru_gates(pp, torch.from_numpy(x), pq)
    # measured: off 3.6e-7, sim 1.4e-7
    _gap(ga, wa, TOL[mode])
    _gap(gb, wb, TOL[mode])


@pytest.mark.parametrize("mode", PARTS)
def test_rglru_gates_take_the_ieee_square_root(rglru, mode):
    """sqrt(1 - a^2) is the correctly rounded float32 square root, as
    XLA's and the card's are (torch's CPU float32 sqrt is not correctly
    rounded, so the card and the CPU once differed in a last bit here):
    the gates' second output equals numpy's IEEE square root times the
    input gate times x in float32, bit for bit."""
    _, pp = rglru
    _, pq = _quants(mode)
    x = torch.from_numpy(_x((4, 256, 32), 5))
    a, b = R._rglru_gates(pp, x, pq)
    i = R._f64(torch.sigmoid, L.linear(x, pp["w_i"], q=pq).float()).numpy()
    an = a.numpy()
    beta = np.sqrt(np.maximum(np.float32(1) - an * an, np.float32(1e-12)))
    np.testing.assert_array_equal(b.numpy(), beta * (i * x.numpy()))


@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("mode", PARTS)
def test_rglru_scan(rglru, mode, h0):
    jp, pp = rglru
    jq, pq = _quants(mode)
    x = _x((2, 16, 32), 5)
    h = _x((2, 32), 6) if h0 else None
    wy, wh = _ref_jit(lambda p, x, h: JR.rglru_scan(p, x, jq, h))(jp, x, h)
    gy, gh = R.rglru_scan(pp, torch.from_numpy(x), pq,
                          None if h is None else torch.from_numpy(h))
    # measured: 1.1e-7 in both modes, with and without h0
    _gap(gy, wy, TOL[mode])
    _gap(gh, wh, TOL[mode])


@pytest.mark.parametrize("mode", PARTS)
def test_rglru_step(rglru, mode):
    jp, pp = rglru
    jq, pq = _quants(mode)
    x, h = _x((2, 1, 32), 7), _x((2, 32), 8)
    wy, wh = _ref_jit(lambda p, x, h: JR.rglru_step(p, x, h, jq))(jp, x, h)
    gy, gh = R.rglru_step(pp, torch.from_numpy(x), torch.from_numpy(h), pq)
    # measured: 7.3e-8 in both modes
    _gap(gy, wy, TOL[mode])
    _gap(gh, wh, TOL[mode])


@pytest.mark.parametrize("state", [False, True])
def test_temporal_conv_bit_for_bit(rglru, state):
    """Python's sum over the taps, 0 + t0 + t1 + t2 + t3, in float32."""
    jp, pp = rglru
    x = _x((2, 9, 32), 9)
    st = _x((2, 3, 32), 10) if state else None
    wy, ws = _ref_jit(lambda p, x, s: JR._temporal_conv(p, x, s))(jp, x, st)
    gy, gs = R._temporal_conv(pp, torch.from_numpy(x),
                              None if st is None else torch.from_numpy(st))
    np.testing.assert_array_equal(gy.numpy(), np.asarray(wy))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))


@pytest.mark.parametrize("mode", list(MODES))
def test_rglru_block_prefill_then_decode(rglru, mode):
    """A 16-token prefill from a zero state, then two decode steps."""
    jp, pp = rglru
    jq, pq = _quants(mode)
    x = _x((2, 16, 32), 11)
    st = JR.rglru_state_init(JCFG, 2, jnp.float32)
    wo, ws = _ref_jit(lambda p, x, s: JR.rglru_block(
        p, x, JCFG, quant=jq, state=s))(jp, x, st)
    pst = R.rglru_state_init(PCFG, 2, torch.float32, "cpu")
    go, gs = R.rglru_block(pp, torch.from_numpy(x), PCFG, quant=pq,
                           state=pst)
    # measured over the prefill and both steps: off 3.3e-7, sim and
    # kernel 1.3e-7
    _gap(go, wo, TOL[mode])
    _gap(gs["h"], ws["h"], TOL[mode])
    _gap(gs["conv"], ws["conv"], TOL[mode])
    step = _ref_jit(lambda p, x, s: JR.rglru_block(
        p, x, JCFG, quant=jq, state=s, decode=True))
    for i in range(2):
        xt = _x((2, 1, 32), 12 + i)
        wo, ws = step(jp, xt, ws)
        go, gs = R.rglru_block(pp, torch.from_numpy(xt), PCFG, quant=pq,
                               state=gs, decode=True)
        _gap(go, wo, TOL[mode])
        _gap(gs["h"], ws["h"], TOL[mode])


def test_prefill_then_decode_against_one_longer_prefill(rglru):
    """Decode's sequential update and the scan's odd/even recursion round
    in different orders, so a 16-token prefill and a decode step need not
    equal a 17-token prefill in bits: held to 1e-6 of the scale in both
    packages alike (measured: 0 in both at this size)."""
    jp, pp = rglru
    q, jq = QuantConfig(mode="off"), JQuantConfig(mode="off")
    xn = _x((2, 17, 32), 14)
    x = torch.from_numpy(xn)
    whole, _ = R.rglru_block(pp, x, PCFG, quant=q)
    _, st = R.rglru_block(pp, x[:, :16], PCFG, quant=q,
                          state=R.rglru_state_init(PCFG, 2, torch.float32,
                                                   "cpu"))
    last, _ = R.rglru_block(pp, x[:, 16:], PCFG, quant=q, state=st,
                            decode=True)
    _gap(last, whole[:, 16:].numpy(), 1e-6)
    jwhole, _ = _ref_jit(lambda p, x: JR.rglru_block(
        p, x, JCFG, quant=jq))(jp, xn)
    _, jst = _ref_jit(lambda p, x, s: JR.rglru_block(
        p, x, JCFG, quant=jq, state=s))(
            jp, xn[:, :16], JR.rglru_state_init(JCFG, 2, jnp.float32))
    jlast, _ = _ref_jit(lambda p, x, s: JR.rglru_block(
        p, x, JCFG, quant=jq, state=s, decode=True))(jp, xn[:, 16:], jst)
    _gap(np.asarray(jlast), np.asarray(jwhole)[:, 16:], 1e-6)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", PARTS)
def test_mlstm_gates(mlstm, mode):
    jp, pp = mlstm
    jq, pq = _quants(mode)
    x = _x((2, 16, 32), 15)
    wf, wi = _ref_jit(lambda p, x: JR._mlstm_gates(p, x, jq))(jp, x)
    gf, gi = R._mlstm_gates(pp, torch.from_numpy(x), pq)
    # measured: 8.2e-8 off, 7.7e-8 sim (the LUT gate)
    _gap(gf, wf, TOL[mode])
    _gap(gi, wi, TOL[mode])


@pytest.mark.parametrize("mode", list(MODES))
def test_mlstm_scan_across_two_chunks(mlstm, mode):
    """16 tokens in chunks of 8: the carry (C, n) crosses a chunk
    boundary; from a zero state and from a given one."""
    jp, pp = mlstm
    jq, pq = _quants(mode)
    x = _x((2, 16, 32), 16)
    C0, n0 = _x((2, 2, 16, 16), 17, 0.1), _x((2, 2, 16), 18, 0.1)
    for st in (None, (C0, n0)):
        wy, (wC, wn) = _ref_jit(lambda p, x, s: JR.mlstm_scan(
            p, x, JCFG, jq, s, chunk=8))(jp, x, st)
        gy, (gC, gn) = R.mlstm_scan(
            pp, torch.from_numpy(x), PCFG, pq,
            None if st is None else [torch.from_numpy(t) for t in st],
            chunk=8)
        # measured: off 3.1e-7, sim 1.4e-7, kernel 1.3e-7
        _gap(gy, wy, TOL[mode])
        _gap(gC, wC, TOL[mode])
        _gap(gn, wn, TOL[mode])


def test_mlstm_scan_chunk_assertion(mlstm):
    """A sequence that is not a whole number of chunks is refused, as the
    reference asserts (12 tokens in chunks of 8)."""
    jp, pp = mlstm
    x = _x((1, 12, 32), 19)
    with pytest.raises(AssertionError):
        JR.mlstm_scan(jp, x, JCFG, JQuantConfig(), chunk=8)
    with pytest.raises(AssertionError):
        R.mlstm_scan(pp, torch.from_numpy(x), PCFG, QuantConfig(), chunk=8)


@pytest.mark.parametrize("mode", list(MODES))
def test_mlstm_block_prefill_then_decode(mlstm, mode):
    jp, pp = mlstm
    jq, pq = _quants(mode)
    x = _x((2, 16, 32), 20)
    wo, ws = _ref_jit(lambda p, x: JR.mlstm_block(
        p, x, JCFG, quant=jq))(jp, x)
    go, gs = R.mlstm_block(pp, torch.from_numpy(x), PCFG, quant=pq)
    # measured over the prefill and both steps: off 2.8e-7, sim 1.2e-7,
    # kernel 9.3e-8
    _gap(go, wo, TOL[mode])
    step = _ref_jit(lambda p, x, s: JR.mlstm_block(
        p, x, JCFG, quant=jq, state=s, decode=True))
    for i in range(2):
        xt = _x((2, 1, 32), 21 + i)
        wo, ws = step(jp, xt, ws)
        go, gs = R.mlstm_block(pp, torch.from_numpy(xt), PCFG, quant=pq,
                               state=gs, decode=True)
        _gap(go, wo, TOL[mode])
        _gap(gs[0], ws[0], TOL[mode])
        _gap(gs[1], ws[1], TOL[mode])


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", PARTS)
def test_slstm_cell(slstm, mode):
    jp, pp = slstm
    jq, pq = _quants(mode)
    xt = _x((2, 32), 23)
    st = tuple(_x((2, 32), 24 + i, 0.5) for i in range(3)) + (
        _x((2, 32), 27, 0.1) - 1.0,)
    want = _ref_jit(lambda p, x, s: JR._slstm_cell(p, x, s, jq))(jp, xt, st)
    got = R._slstm_cell(pp, torch.from_numpy(xt),
                        [torch.from_numpy(t) for t in st], pq)
    # measured: off 2.2e-7, sim 1.1e-7
    for g, w in zip(got, want):
        _gap(g, w, TOL[mode])


@pytest.mark.parametrize("mode", list(MODES))
def test_slstm_scan_then_step(slstm, mode):
    jp, pp = slstm
    jq, pq = _quants(mode)
    x = _x((2, 12, 32), 28)
    wy, ws = _ref_jit(lambda p, x: JR.slstm_scan(p, x, JCFG, jq))(jp, x)
    gy, gs = R.slstm_scan(pp, torch.from_numpy(x), PCFG, pq)
    # measured over the scan and the step: off 2.5e-7, sim and kernel
    # 2.0e-7
    _gap(gy, wy, TOL[mode])
    for g, w in zip(gs, ws):
        _gap(g, w, TOL[mode])
    xt = _x((2, 1, 32), 29)
    wy, ws = _ref_jit(lambda p, x, s: JR.slstm_step(p, x, JCFG, jq, s))(
        jp, xt, ws)
    gy, gs = R.slstm_step(pp, torch.from_numpy(xt), PCFG, pq, gs)
    _gap(gy, wy, TOL[mode])
    for g, w in zip(gs, ws):
        _gap(g, w, TOL[mode])


# ---------------------------------------------------------------------------
# the model's trees: packing, conversion, the slot prefill's pad tokens
# ---------------------------------------------------------------------------
def _ref_model(jcfg, mode="kernel"):
    jm = build_model(dataclasses.replace(
        jcfg, quant=JQuantConfig(**MODES[mode])))
    jp = jax.jit(jm.init)(jax.random.key(0))
    return jm, jp


def _ref_layer_leaves(cfg, tree):
    """The reference tree's leaves per port layer: unit leaves indexed by
    their unit repeat, tail leaves as they are."""
    def take(a, u):
        if hasattr(a, "mantissa"):          # packed planes: both stacked
            return a._replace(mantissa=a.mantissa[u], exponent=a.exponent[u])
        return a[u]

    out = []
    for u in range(cfg.resolved_n_units):
        for j, kind in enumerate(cfg.unit):
            out.append(jax.tree_util.tree_map(
                lambda a, u=u: take(a, u), tree["units"][f"u{j}_{kind}"],
                is_leaf=lambda a: hasattr(a, "mantissa")))
    for j, kind in enumerate(cfg.tail):
        out.append(tree["tail"][f"t{j}_{kind}"])
    return out


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    return {prefix: tree}


@pytest.mark.parametrize("name,n_units", [("recurrentgemma", 1),
                                          ("recurrentgemma", 4),
                                          ("xlstm", 2)])
def test_packing_rule_on_unit_and_tail_leaves(name, n_units):
    """The size rule counts a unit leaf as one of a stack of ``n_units``
    and a tail leaf alone, as the reference does: RecurrentGemma SMOKE's
    64 x 64 ``w_a`` (4096 entries) stays float at 1 unit and in the tail,
    and is packed at 4 units (16384); the packed planes equal the
    reference's."""
    jc, pc = {"recurrentgemma": (jrg, rg), "xlstm": (jxl, xl)}[name]
    layers = n_units * len(jc.SMOKE.unit) + len(jc.SMOKE.tail)
    jcfg = dataclasses.replace(jc.SMOKE, n_units=n_units, n_layers=layers)
    pcfg = dataclasses.replace(pc.SMOKE, n_units=n_units, n_layers=layers)
    jm, jp = _ref_model(jcfg, "off")
    pm = DecoderLM(pcfg)
    arrays = jax.tree_util.tree_map(np.asarray, unwrap(jp))
    pp = pack_params_mxint(convert.lm_params(pm, arrays, device="cpu"),
                           MXINT8_WEIGHT, pm.layer_stacks())
    ref = unwrap(j_pack(jp, J_W8))
    packed = 0
    for layer, ref_layer in zip(pp["layers"],
                                _ref_layer_leaves(pcfg, ref)):
        mine, theirs = _flat(layer), _flat(ref_layer)
        assert mine.keys() == theirs.keys()
        for k, p in mine.items():
            r = theirs[k]
            assert hasattr(p.value, "mantissa") == hasattr(r, "mantissa"), k
            if hasattr(r, "mantissa"):
                packed += 1
                np.testing.assert_array_equal(p.value.mantissa.numpy(),
                                              np.asarray(r.mantissa))
                np.testing.assert_array_equal(p.value.exponent.numpy(),
                                              np.asarray(r.exponent))
    # at one unit no SMOKE layer leaf reaches 16384 entries
    assert bool(packed) == (n_units > 1)
    w_a = [lp["mix"]["w_a"].value for lp in pp["layers"] if "w_a" in
           lp["mix"]]
    if name == "recurrentgemma":
        unit_packed = [hasattr(w, "mantissa") for w in w_a[:2 * n_units]]
        assert unit_packed == [n_units >= 4] * (2 * n_units)
        assert not any(hasattr(w, "mantissa") for w in w_a[2 * n_units:])
        # the list-length rule (5 or 14 layers x 4096 entries) would
        # have packed every one of them, the tail's included
        naive = pack_params_mxint(convert.lm_params(pm, arrays, "cpu"),
                                  MXINT8_WEIGHT)
        assert all(hasattr(lp["mix"]["w_a"].value, "mantissa")
                   for lp in naive["layers"] if "w_a" in lp["mix"])


@pytest.mark.parametrize("name", ["recurrentgemma", "xlstm"])
def test_lm_params_round_trip(name):
    """The reference's unit stacks and tail leaves land in the port's
    layer order (unit repeats, then the tail) and come back unchanged;
    keys that differ from the config's are refused."""
    jc, pc = {"recurrentgemma": (jrg, rg), "xlstm": (jxl, xl)}[name]
    jm, jp = _ref_model(jc.SMOKE, "off")
    pm = DecoderLM(pc.SMOKE)
    arrays = jax.tree_util.tree_map(np.asarray, unwrap(jp))
    pp = convert.lm_params(pm, arrays, device="cpu")
    assert [("ffn" in lp) for lp in pp["layers"]] == [
        k in ("attn", "rec") for k in pm.kinds]
    back = _ref_layer_leaves(pm.cfg, arrays)
    for layer, ref in zip(pp["layers"], back):
        mine, theirs = _flat(layer), _flat(ref)
        assert mine.keys() == theirs.keys()
        for k, p in mine.items():
            np.testing.assert_array_equal(p.value.numpy(), theirs[k])
    for k in ("embed", "final_norm"):
        np.testing.assert_array_equal(pp[k].value.numpy(), arrays[k])
    bad = dict(arrays, tail={})
    if pm.cfg.tail:
        with pytest.raises(ValueError, match="keys"):
            convert.lm_params(pm, bad, device="cpu")
    bad = dict(arrays, units={"u0_attn": {}})
    with pytest.raises(ValueError, match="keys"):
        convert.lm_params(pm, bad, device="cpu")


@pytest.mark.parametrize("name", ["recurrentgemma", "xlstm"])
def test_slot_prefill_state_absorbs_the_pad_tokens(name):
    """A 37-token prompt right-padded to its 64-token bucket: the
    recurrent layers run over all 64 tokens, so their state is the state
    after the padded prompt, in both packages (a reference caveat the port
    mirrors); the logits are taken at token 37 and the index is 37.  In
    "off" (float weights), so the two packages' states agree to float32
    rounding (measured: 1.8e-6 of the scale for RecurrentGemma, 2.0e-6 for
    xLSTM, over 64 tokens) and the port's slot state
    equals its padded prefill's bit for bit."""
    jc, pc = {"recurrentgemma": (jrg, rg), "xlstm": (jxl, xl)}[name]
    jm, jp = _ref_model(jc.SMOKE, "off")
    pm = DecoderLM(dataclasses.replace(pc.SMOKE,
                                       quant=QuantConfig(**MODES["off"])))
    arrays = jax.tree_util.tree_map(np.asarray, unwrap(jp))
    pp = convert.lm_params(pm, arrays, device="cpu")
    n, P = 37, 64
    toks = np.zeros((1, P), np.int32)
    toks[0, :n] = np.random.default_rng(30).integers(0, 512, size=n)
    tok, cache = make_slot_prefill_step(pm, 128, "cpu")(
        pp, torch.from_numpy(toks), n, 0, pm.cache_init(1, 128, "cpu"))
    assert int(cache["index"][0]) == n
    _, padded = pm.prefill(pp, torch.from_numpy(toks),
                           pm.cache_init(1, 128, "cpu"))
    _, short = pm.prefill(pp, torch.from_numpy(toks[:, :n]),
                          pm.cache_init(1, 128, "cpu"))
    jtok, jcache = _ref_jit(j_slot(jm, 128))(
        jp, jnp.asarray(toks), n, 0, jm.cache_init(1, 128))
    assert int(tok[0]) == int(jtok[0])
    ref_states = _ref_layer_leaves(jm.cfg, jcache)

    def leaves(st):
        return list(st.values()) if isinstance(st, dict) else list(st)

    moved = False
    for i, kind in enumerate(pm.kinds):
        if kind == "attn":
            continue
        for a, b, c, d in zip(leaves(cache["layers"][i]),
                              leaves(padded["layers"][i]),
                              leaves(ref_states[i]),
                              leaves(short["layers"][i])):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
            _gap(a, c, 1e-5)
            moved |= not torch.equal(a, d)
    assert moved          # the pad tokens did change the state
