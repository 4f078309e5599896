"""The port's mixture-of-experts FFN (``repro_torch.models.moe``) against
the reference's ``repro.models.moe.moe_ffn`` on the CPU.

The SMOKE configs of Mixtral-8x7B (4 experts, top-2) and
Granite-MoE-3B (8 experts, top-4) run in kernel mode on MXInt8 planes
(the router, gates and SiLU through the kernels' plain versions) and in
"sim" mode on float weights, on the same seeded numpy inputs.  Cases: a
plain batch; a capacity factor small enough that experts drop tokens; a
router whose columns tie exactly (lower expert index first, as
``jax.lax.top_k`` orders ties); a decode-shaped batch whose idle rows
(one repeated hidden state) take capacity from the real rows; the
load-balancing loss.  The reference runs with the two scoped fixes for
the installed jax that ``test_torch_lm.py`` uses, jitted at
``xla_backend_optimization_level`` 0.

Tolerance: outputs within 1e-5 of their scale (measured: at most 4.1e-7,
the port's float64 expert products rounded once against XLA's float32
dot, a last-bit difference); the load-balancing loss, a float64 softmax
in the port and a float32 one in the reference, within 1e-6 relative
(measured: at most 9.3e-8).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from repro.configs import granite_moe_3b_a800m as jgranite  # noqa: E402
from repro.configs import mixtral_8x7b as jmixtral  # noqa: E402
from repro.core.mx_types import MXINT8_WEIGHT as J_W8  # noqa: E402
from repro.core.mx_types import QuantConfig as JQuantConfig  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models.model_api import Param as JParam  # noqa: E402
from repro.serving.engine import _contraction_axis as j_axis  # noqa: E402
from repro.serving.engine import _should_pack as j_should_pack  # noqa: E402
from repro.serving.engine import pack_params_mxint as j_pack  # noqa: E402
from repro_torch.configs import granite_moe_3b_a800m as granite  # noqa: E402
from repro_torch.configs import mixtral_8x7b as mixtral  # noqa: E402
from repro_torch.core.mx_types import MXINT8_WEIGHT, QuantConfig  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models.model_api import Param  # noqa: E402
from repro_torch.models.transformer import DecoderLM  # noqa: E402
from repro_torch.serving.engine import (contraction_axis,  # noqa: E402
                                        pack_params_mxint, should_pack)

CONFIGS = {"mixtral_8x7b": (jmixtral, mixtral),
           "granite_moe_3b_a800m": (jgranite, granite)}
MODES = {"kernel": True, "sim": False}       # mode -> MXInt8 planes
TOL = 1e-5
AUX_TOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def jax_reference():
    """Run the reference on this jax: alias the renamed Pallas compiler
    params and make ``jnp.exp2`` exact on integer-valued inputs.  Each
    torch transcendental the port calls runs once on one element first:
    the CPU build may compute them inexactly on a first multi-threaded
    call."""
    orig = jnp.exp2

    def exact_exp2(x):
        x = jnp.asarray(x)
        if not jnp.issubdtype(x.dtype, jnp.floating):
            return orig(x)
        fl = jnp.floor(x)
        exact = jnp.ldexp(jnp.ones_like(x),
                          jnp.clip(fl, -300, 300).astype(jnp.int32))
        return jnp.where(x == fl, exact, orig(x))

    for fn in (torch.exp, torch.log):
        fn(torch.ones(1))
        fn(torch.ones(1, dtype=torch.float64))
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


def _configs(name, mode, **moe):
    jcfg, pcfg = CONFIGS[name]
    kw = dict(mode=mode, quantize_nonlinear=True)
    j = dataclasses.replace(jcfg.SMOKE, quant=JQuantConfig(**kw),
                            moe=dataclasses.replace(jcfg.SMOKE.moe, **moe))
    p = dataclasses.replace(pcfg.SMOKE, quant=QuantConfig(**kw),
                            moe=dataclasses.replace(pcfg.SMOKE.moe, **moe))
    return j, p


def _arrays(cfg, seed):
    """Seeded numpy values for the leaves of ``moe_param_spec``."""
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(shape) * shape[-2] ** -0.5).astype(
        np.float32) for k, (shape, _, _) in M.moe_param_spec(cfg).items()}


def _run(name, mode, x, arrays=None, **moe):
    """(reference y, aux, port y, aux, port params, port config) of one
    ``moe_ffn`` call on numpy x (b, s, d)."""
    jcfg, pcfg = _configs(name, mode, **moe)
    arrays = _arrays(pcfg, 0) if arrays is None else arrays
    spec = M.moe_param_spec(pcfg)
    jp = {k: JParam(jnp.asarray(v), spec[k][1]) for k, v in arrays.items()}
    pp = {k: Param(torch.from_numpy(v), spec[k][1])
          for k, v in arrays.items()}
    if MODES[mode]:
        jp, pp = j_pack(jp, J_W8), pack_params_mxint(pp, MXINT8_WEIGHT)
    ref = jax.jit(lambda p, x: JM.moe_ffn(x, p, jcfg, quant=jcfg.quant),
                  compiler_options={"xla_backend_optimization_level": 0})
    jy, ja = ref(jp, jnp.asarray(x))
    py, pa = M.moe_ffn(torch.from_numpy(x), pp, pcfg, quant=pcfg.quant)
    return np.asarray(jy), float(ja), py.numpy(), float(pa), pp, pcfg


def _check(jy, ja, py, pa):
    assert py.shape == jy.shape
    gap, scale = float(np.abs(py - jy).max()), float(np.abs(jy).max())
    assert gap <= TOL * scale, (gap, scale)
    assert abs(pa - ja) <= AUX_TOL * abs(ja), (pa, ja)
    assert ja > 0.0


def _routed(pp, pcfg, x):
    """Pairs each expert is routed in the port (its router and top-k)."""
    xs = torch.from_numpy(x).reshape(-1, pcfg.d_model)
    logits = L.linear(xs, pp["router"], q=pcfg.quant).to(torch.float32)
    _, idx = M.top_k(logits, pcfg.moe.top_k)
    return torch.bincount(idx.reshape(-1), minlength=pcfg.moe.num_experts)


def _x(cfg, shape, seed):
    return np.random.default_rng(seed).standard_normal(
        shape + (cfg.d_model,)).astype(np.float32)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", list(CONFIGS))
def test_moe_ffn_vs_reference(name, mode):
    """A (2, 24) batch: outputs and the load-balancing loss."""
    x = _x(CONFIGS[name][1].SMOKE, (2, 24), 1)
    jy, ja, py, pa, pp, pcfg = _run(name, mode, x)
    _check(jy, ja, py, pa)
    assert M.capacity(48, pcfg) == {"mixtral_8x7b": 32,
                                    "granite_moe_3b_a800m": 32}[name]


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", list(CONFIGS))
def test_overflow_drops_vs_reference(name, mode):
    """capacity_factor 0.5 (C 24 for 96 tokens): the busiest experts
    overflow and drop their later tokens, in both packages alike."""
    x = _x(CONFIGS[name][1].SMOKE, (3, 32), 2)
    jy, ja, py, pa, pp, pcfg = _run(name, mode, x, capacity_factor=0.5)
    _check(jy, ja, py, pa)
    C = M.capacity(96, pcfg)
    assert C == 24 < M.capacity(96, CONFIGS[name][1].SMOKE)
    counts = _routed(pp, pcfg, x)
    assert int(counts.max()) > C, (counts, C)


def test_top_k_orders_ties_by_index():
    """Integer-valued logits with many exact ties: the port's top_k gives
    ``jax.lax.top_k``'s values and indices (lower index first)."""
    rng = np.random.default_rng(3)
    logits = rng.integers(-2, 3, size=(64, 8)).astype(np.float32)
    for k in (1, 2, 4, 8):
        jv, ji = jax.lax.top_k(jnp.asarray(logits), k)
        pv, pi = M.top_k(torch.from_numpy(logits), k)
        np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", list(CONFIGS))
def test_router_tie_takes_lower_expert(name, mode):
    """Every router column equal to column 0: each token's logits tie
    across all experts, so every token goes to experts 0..k-1 (which then
    overflow), as in the reference."""
    pcfg = CONFIGS[name][1].SMOKE
    arrays = _arrays(pcfg, 4)
    arrays["router"] = np.repeat(arrays["router"][:, :1],
                                 pcfg.moe.num_experts, axis=1)
    x = _x(pcfg, (2, 16), 5)
    jy, ja, py, pa, pp, cfg = _run(name, mode, x, arrays)
    _check(jy, ja, py, pa)
    counts = _routed(pp, cfg, x).tolist()
    k = pcfg.moe.top_k
    assert counts == [32] * k + [0] * (pcfg.moe.num_experts - k)
    assert M.capacity(32, cfg) < 32                 # and they overflow


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", list(CONFIGS))
def test_idle_decode_rows_compete_for_capacity(name, mode):
    """A decode-shaped batch (32, 1): 28 idle rows carrying one repeated
    hidden state come first and route alike, so their experts overflow
    and the 4 real rows after them lose choices, in both packages."""
    pcfg = CONFIGS[name][1].SMOKE
    x = _x(pcfg, (32, 1), 6)
    x[:28] = x[0]
    jy, ja, py, pa, pp, cfg = _run(name, mode, x)
    _check(jy, ja, py, pa)
    assert int(_routed(pp, cfg, x).max()) > M.capacity(32, cfg)


@pytest.mark.parametrize("which", ["FULL", "SMOKE"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_packing_decisions_are_the_references(name, which):
    """Every MoE layer leaf (the norm, the router, the expert stacks): the
    port's per-layer leaf, one of n_layers, packs exactly when the
    reference's layer-stacked leaf does, a matrix along the same axis
    (one less, without the layers axis).  Shapes only: nothing is
    allocated."""
    cfg = getattr(CONFIGS[name][1], which)
    spec = DecoderLM(cfg).layer_spec()
    leaves = [spec["ln2"]] + list(spec["ffn"].values())
    packed = []
    for shape, axes, _ in leaves:
        p = Param(torch.empty(shape, device="meta"), axes)
        j = JParam(jax.ShapeDtypeStruct((cfg.n_layers,) + shape,
                                        jnp.float32), ("layers",) + axes)
        assert should_pack(p, cfg.n_layers) == j_should_pack(j), axes
        if len(shape) > 1:
            assert contraction_axis(p) + 1 == j_axis(j), axes
        packed.append(should_pack(p, cfg.n_layers))
    # the norm never; the experts always; the router at full size only
    assert packed == [False, which == "FULL", True, True, True]


def test_decoder_rejects_what_is_not_ported():
    """The decoder takes the moe FFN kind and needs its MoEConfig; a block
    kind it does not know raises (the recurrent kinds are ported)."""
    with pytest.raises(ValueError, match="MoEConfig"):
        DecoderLM(dataclasses.replace(mixtral.SMOKE, moe=None))
    with pytest.raises(NotImplementedError, match="block kinds"):
        DecoderLM(dataclasses.replace(mixtral.SMOKE, unit=("cross",)))
    assert DecoderLM(dataclasses.replace(mixtral.SMOKE, unit=("rec",))
                     ).kinds == ("rec", "rec")
    model = DecoderLM(mixtral.SMOKE)
    ffn = model.layer_spec()["ffn"]
    assert ffn["wi"][:2] == ((4, 64, 96), ("expert", "embed", "mlp"))
    assert ffn["wo"][:2] == ((4, 96, 64), ("expert", "mlp", "embed"))
    assert ffn["router"][:2] == ((64, 4), ("embed", "expert"))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_serving_skips_the_load_balancing_loss(name, monkeypatch):
    """``moe_ffn(with_aux=False)`` gives the same outputs and no loss; a
    slot prefill and a decode step never compute the loss, ``loss`` does
    (once a layer)."""
    pcfg = dataclasses.replace(CONFIGS[name][1].SMOKE,
                               quant=QuantConfig(mode="kernel",
                                                 quantize_nonlinear=True))
    model = DecoderLM(pcfg)
    params = model.init(7, device="cpu", pack_fmt=MXINT8_WEIGHT)
    x = torch.from_numpy(_x(pcfg, (2, 8), 8))
    y, aux = M.moe_ffn(x, params["layers"][0]["ffn"], pcfg, quant=pcfg.quant)
    y2, none = M.moe_ffn(x, params["layers"][0]["ffn"], pcfg,
                         quant=pcfg.quant, with_aux=False)
    assert none is None and float(aux) > 0.0 and torch.equal(y, y2)
    calls = []
    real = M.aux_loss
    monkeypatch.setattr(M, "aux_loss",
                        lambda *a: calls.append(1) or real(*a))
    tokens = torch.from_numpy(np.random.default_rng(9).integers(
        0, pcfg.vocab, size=(2, 8)).astype(np.int32))
    cache = model.cache_init(2, 16, "cpu")
    _, cache = model.prefill(params, tokens, cache)
    model.decode_step(params, tokens[:, :1], cache)
    assert not calls
    model.loss(params, {"tokens": tokens})
    assert len(calls) == pcfg.n_layers


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_expert_products_from_float64_planes(dtype):
    """MXInt8 expert stacks dequantized straight to float64 give the
    products of the stacks dequantized to the model dtype; the per-expert
    counts equal ``torch.bincount``'s."""
    pcfg = mixtral.SMOKE
    arrays = _arrays(pcfg, 10)
    w = pack_params_mxint({"wi": Param(torch.from_numpy(arrays["wi"]),
                                       M.EXPERT_AXES)}, MXINT8_WEIGHT)["wi"]
    assert w.value.mant_bits == 8
    quant = QuantConfig(mode="kernel", quantize_nonlinear=True)
    h = torch.from_numpy(_x(pcfg, (4, 8), 11)).to(dtype)
    wv = quant.datapath.weight_value(w.value, q=quant, dtype=dtype)
    want = torch.einsum("ecd,edf->ecf", h.double(), wv.double()).float().to(
        dtype)
    assert torch.equal(M._expert_mm(h, w, "ecd,edf->ecf", quant), want)
    idx = torch.from_numpy(np.random.default_rng(12).integers(
        0, 40, size=97))
    assert torch.equal(M._counts(idx, 40), torch.bincount(idx, minlength=40))
