"""The port's "off", "fake", "sim" and "packed" backends and per-layer
overrides against the reference on the CPU.

Each backend's per-op methods, DeiT-Micro and 2-layer DeiT-Tiny logits,
the kernel/sim-FFN mixed DeiT and the SMOKE Llama-3 go through both
packages on the same numpy inputs.  The reference runs with two scoped
fixes for the installed jax (the ``TPUCompilerParams`` alias and an exact
``exp2`` on integer inputs) and its LM steps are jitted at
``xla_backend_optimization_level`` 0, as in ``test_torch_lm.py``.

Tolerances.  The MXInt non-linear datapaths are held bit for bit.  The
port's float products, sums and transcendentals run in float64 and round
once to float32, the reference's in XLA's float32 order: per op that is a
few float32 ulps (``OP_TOL``).  In a quantized model one such ulp can move
a later MXInt rounding step by a grid step, which moves the logits by
about 1% of their scale; those models are held to ``MODEL_TOL`` with
argmax equal on every row (the measured gaps stand beside each case).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from repro.configs import deit as jdeit  # noqa: E402
from repro.configs import llama3_8b as jllama  # noqa: E402
from repro.core.mx_types import MXINT8_WEIGHT as J_W8  # noqa: E402
from repro.core.mx_types import QuantConfig as JQuantConfig  # noqa: E402
from repro.core.mx_types import QuantOverride as JQuantOverride  # noqa: E402
from repro.datapath import resolve as j_resolve  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.model_api import Param as JParam  # noqa: E402
from repro.models.model_api import unwrap  # noqa: E402
from repro.serving.engine import ServeConfig as JServeConfig  # noqa: E402
from repro.serving.engine import ServingEngine as JServingEngine  # noqa: E402
from repro.serving.engine import make_decode_step as j_decode_step  # noqa: E402
from repro.serving.engine import make_prefill_step as j_prefill_step  # noqa: E402
from repro.serving.engine import pack_params_mxint as j_pack  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import deit  # noqa: E402
from repro_torch.configs import llama3_8b as llama  # noqa: E402
from repro_torch.core.mx_types import (MXINT6_WEIGHT, MXINT8_WEIGHT,  # noqa: E402
                                       MXFormat, QuantConfig,
                                       QuantOverride)
from repro_torch.datapath import register_backend, resolve  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.model_api import Param  # noqa: E402
from repro_torch.models.transformer import DecoderLM  # noqa: E402
from repro_torch.models.vit import ViT  # noqa: E402
from repro_torch.serving.engine import (ServeConfig,  # noqa: E402
                                        ServingEngine, ViTServingEngine,
                                        pack_params_mxint)

OP_TOL = 2.0 ** -20
MODEL_TOL = 5e-2
MODES = ("off", "fake", "sim", "packed")
VARIANTS = {"plain": {}, "nl": {"quantize_nonlinear": True},
            "nl_subset": {"quantize_nonlinear": True,
                          "nl_ops": ("layernorm",)}}
MIXED = "block/*/ffn"
# the port's backend names -> the reference's
BACKEND_NAMES = {"torch_float": "xla_float", "mxint_sim": "mxint_sim",
                 "hopper_kernel": "pallas_kernel"}


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

    for fn in (torch.exp, torch.sin, torch.cos, torch.log, torch.erf):
        fn(torch.ones(1, dtype=torch.float64))
        fn(torch.ones(1))
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


def _configs(mode, **kw):
    """(port config, reference config); ``overrides=MIXED`` gives sim
    FFNs in both."""
    pkw, jkw = dict(kw), dict(kw)
    if kw.pop("overrides", None) == MIXED:
        pkw["overrides"] = ((MIXED, QuantOverride(mode="sim")),)
        jkw["overrides"] = ((MIXED, JQuantOverride(mode="sim")),)
    return QuantConfig(mode=mode, **pkw), JQuantConfig(mode=mode, **jkw)


def _gap(got, want):
    got = np.asarray(got.detach() if hasattr(got, "detach") else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max()), float(np.abs(want).max())


def _close(got, want, tol):
    gap, scale = _gap(got, want)
    assert gap <= tol * scale, (gap, scale)
    return gap


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    arr = {"x": rng.normal(size=(3, 37, 64)),
           "w": rng.normal(size=(64, 48)) * 0.1,
           "b": rng.normal(size=(48,)),
           "g": rng.normal(size=(64,)),
           "beta": rng.normal(size=(64,))}
    arr = {k: v.astype(np.float32) for k, v in arr.items()}
    return ({k: torch.from_numpy(v) for k, v in arr.items()},
            {k: jnp.asarray(v) for k, v in arr.items()})


# ---------------------------------------------------------------------------
# per-op methods of each backend
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_linear_and_norms_per_op(data, mode, variant):
    t, j = data
    q, jq = _configs(mode, **VARIANTS[variant])
    _close(L.linear(t["x"], Param(t["w"], ("embed", "mlp")),
                    Param(t["b"], ("mlp",)), q=q),
           JL.linear(j["x"], JParam(j["w"], ("embed", "mlp")),
                     JParam(j["b"], ("mlp",)), q=jq), OP_TOL)
    got = L.layernorm(t["x"], Param(t["g"], ("embed",)),
                      Param(t["beta"], ("embed",)), q=q)
    want = JL.layernorm(j["x"], JParam(j["g"], ("embed",)),
                        JParam(j["beta"], ("embed",)), q=jq)
    got_rms = L.rmsnorm(t["x"], Param(t["g"], ("embed",)), q=q)
    want_rms = JL.rmsnorm(j["x"], JParam(j["g"], ("embed",)), q=jq)
    if q.datapath.nl_on(q, "layernorm"):       # the MXInt datapath
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got_rms.numpy(), np.asarray(want_rms))
    else:
        _close(got, want, OP_TOL)
        _close(got_rms, want_rms, OP_TOL)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_act_softmax_exp_per_op(data, mode, variant):
    t, j = data
    q, jq = _configs(mode, **VARIANTS[variant])
    dp = q.datapath
    for kind in ("gelu", "silu"):
        got, want = L.act_fn(t["x"], kind, q), JL.act_fn(j["x"], kind, jq)
        if dp.nl_on(q, "gelu"):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        else:
            _close(got, want, OP_TOL)
    for axis in (-1, 1):
        got = L.softmax(4 * t["x"], q, axis=axis)
        want = JL.softmax(4 * j["x"], jq, axis=axis)
        if dp.nl_on(q, "softmax"):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        else:
            _close(got, want, OP_TOL)
    z = -t["x"].abs() * 3
    got, want = dp.exp(z, q=q), jq.datapath.exp(-jnp.abs(j["x"]) * 3, q=jq)
    if dp.nl_on(q, "softmax"):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        _close(got, want, OP_TOL)


@pytest.mark.parametrize("mode,emulate", [("fake", "int"), ("fake", "fp8"),
                                          ("sim", "int"), ("sim", "fp8")])
def test_linear_emulate_baselines(data, mode, emulate):
    t, j = data
    q, jq = _configs(mode, emulate=emulate)
    _close(L.linear(t["x"], Param(t["w"], ("embed", "mlp")), q=q),
           JL.linear(j["x"], JParam(j["w"], ("embed", "mlp")), q=jq), OP_TOL)


@pytest.mark.parametrize("nl_emulate", ("fixedpoint", "relu6"))
def test_nl_emulate_baselines_per_op(data, nl_emulate):
    """Tables II-IV baselines: fixed-point LN, fixed-point or ReLU6 GELU,
    fixed-point softmax for both; held to OP_TOL (their float64 means
    and sums, test_torch_nonlinear.py)."""
    t, j = data
    q, jq = _configs("sim", quantize_nonlinear=True, nl_emulate=nl_emulate)
    _close(L.layernorm(t["x"], Param(t["g"], ("embed",)),
                       Param(t["beta"], ("embed",)), q=q),
           JL.layernorm(j["x"], JParam(j["g"], ("embed",)),
                        JParam(j["beta"], ("embed",)), q=jq), OP_TOL)
    _close(L.rmsnorm(t["x"], Param(t["g"], ("embed",)), q=q),
           JL.rmsnorm(j["x"], JParam(j["g"], ("embed",)), q=jq), OP_TOL)
    _close(L.act_fn(t["x"], "gelu", q), JL.act_fn(j["x"], "gelu", jq), OP_TOL)
    _close(L.softmax(t["x"], q), JL.softmax(j["x"], jq), OP_TOL)


def _attn_inputs(b, s, S, kvh, g, hd, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=shape).astype(np.float32) * 1.5
            for shape in ((b, s, kvh, g, hd), (b, S, kvh, hd),
                          (b, S, kvh, hd))]
    return ([torch.from_numpy(a) for a in arrs],
            [jnp.asarray(a) for a in arrs])


@pytest.mark.parametrize("mode,variant", [("off", "plain"), ("fake", "plain"),
                                          ("sim", "nl"), ("packed", "nl"),
                                          ("sim", "plain")])
@pytest.mark.parametrize("s,causal,window,chunk", [
    (24, False, 0, 1024),       # direct
    (24, True, 5, 1024),        # direct, causal window
    (520, True, 0, 260)])       # 520^2 > 512^2: query blocks, unless sim
def test_attention_per_op(mode, variant, s, causal, window, chunk):
    """The cache-less attention core, on per-row positions offset by row
    (left-padded batches)."""
    q, jq = _configs(mode, **VARIANTS[variant])
    (qv, k, v), (jqv, jk, jv) = _attn_inputs(2, s, s, 2, 2, 16, s)
    pos = np.arange(s)[None, :] + np.array([[0], [3]])
    got = q.datapath.attention(qv, k, v, q=q, positions=torch.from_numpy(pos),
                               causal=causal, window=window, scale=0.25,
                               chunk=chunk)
    want = jq.datapath.attention(jqv, jk, jv, q=jq,
                                 positions=jnp.asarray(pos), causal=causal,
                                 window=window, scale=0.25, chunk=chunk)
    # measured gap: at most 6e-7 of the scale (float products), 0 where
    # the direct path's rows all tie on no MXInt rounding boundary
    _close(got, want, OP_TOL if variant == "plain" else MODEL_TOL)
    direct = q.datapath._attention_use_direct(q, s, s)
    assert direct == jq.datapath._attention_use_direct(jq, s, s)


@pytest.mark.parametrize("mode,variant", [("off", "plain"), ("sim", "nl"),
                                          ("packed", "nl")])
def test_attention_decode_per_op(mode, variant):
    """The float decode over a ring with per-row validity and a hole."""
    q, jq = _configs(mode, **VARIANTS[variant])
    (qv, k, v), (jqv, jk, jv) = _attn_inputs(3, 1, 40, 2, 4, 16, 7)
    valid = np.zeros((3, 40), bool)
    valid[0, :5], valid[1, :40], valid[2, 10:33] = True, True, True
    valid[1, 20:24] = False
    got = q.datapath.attention_decode(qv, k, v, torch.from_numpy(valid),
                                      q=q, scale=0.25)
    want = jq.datapath.attention_decode(jqv, jk, jv, jnp.asarray(valid),
                                        q=jq, scale=0.25)
    assert got.shape == (3, 1, 2, 4, 16)
    _close(got, want, OP_TOL if variant == "plain" else MODEL_TOL)


def test_kernel_softmax_non_last_axis_equals_sim(data):
    """The kernel backend's softmax along a non-last axis is the sim
    datapath, as in the reference; along the last axis it is the kernel
    (its plain version here), which equals sim too."""
    t, j = data
    qk, jqk = _configs("kernel", quantize_nonlinear=True)
    qs, _ = _configs("sim", quantize_nonlinear=True)
    for axis in (1, 0, -1):
        got = L.softmax(4 * t["x"], qk, axis=axis)
        np.testing.assert_array_equal(
            got.numpy(), L.softmax(4 * t["x"], qs, axis=axis).numpy())
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(JL.softmax(4 * j["x"], jqk, axis=axis)))


# ---------------------------------------------------------------------------
# configs, overrides and the registry
# ---------------------------------------------------------------------------
def test_scoped_merge_order_and_caching():
    fmt4 = MXFormat(4, 16)
    ovs = (("block/*", QuantOverride(mode="sim", act_fmt=fmt4)),
           ("block/1/*", QuantOverride(mode="packed")),
           ("head", QuantOverride(quantize_nonlinear=False)))
    q = QuantConfig(mode="kernel", quantize_nonlinear=True, overrides=ovs)
    jq = JQuantConfig(mode="kernel", quantize_nonlinear=True, overrides=tuple(
        (p, JQuantOverride(**o.patch())) for p, o in ovs))
    assert q.has_overrides and not q.scoped("block/0/ffn").has_overrides
    for scope in ("block/0/ffn", "block/1/attn", "head", "patch", None):
        s, js = q.scoped(scope), jq.scoped(scope)
        assert s.describe() == js.describe(), scope
        assert BACKEND_NAMES[resolve(q, scope).name] == \
            j_resolve(jq, scope).name
    one = q.scoped("block/1/attn")
    assert getattr(one, "mode") == "packed" and one.act_fmt == fmt4
    assert one is q.scoped("block/1/attn")                  # cached
    assert one.scoped("block/1/attn") is one                # idempotent
    assert q.scoped(None) is q and q.scoped("patch") == dataclasses.replace(
        q, overrides=())
    assert resolve(q, "block/0/ffn").name == "mxint_sim"
    assert q.scoped("head").datapath.name == "hopper_kernel"
    assert QuantOverride(mode="sim").patch() == {"mode": "sim"}


@pytest.mark.parametrize("kw,err", [
    (dict(mode="bogus"), ValueError),
    (dict(emulate="int4"), ValueError),
    (dict(mode="kernel", emulate="int"), ValueError),
    (dict(mode="kernel", nl_emulate="fixedpoint"), ValueError),
    (dict(overrides=("block/*",)), ValueError),
    (dict(overrides=(("", None),)), ValueError),
    (dict(overrides=(("block/*", {"mode": "sim"}),)), TypeError)])
def test_quant_config_validation_matches_reference(kw, err):
    with pytest.raises(err):
        QuantConfig(**kw)
    with pytest.raises(err):
        JQuantConfig(**kw)


def test_register_backend_rejects_a_second_registration():
    with pytest.raises(ValueError, match="already"):
        register_backend("sim", resolve(QuantConfig(mode="off")))
    assert QuantConfig(mode="sim").datapath.name == "mxint_sim"


# ---------------------------------------------------------------------------
# DeiT end to end
# ---------------------------------------------------------------------------
_REF = {}


def _deit(name, n_layers, n_classes):
    """(reference params, their numpy arrays), made once per model."""
    key = (name, n_layers, n_classes)
    if key not in _REF:
        jcfg = dataclasses.replace(jdeit.BY_NAME[name], n_layers=n_layers,
                                   n_classes=n_classes)
        jp = build_model(jcfg).init(jax.random.key(0))
        _REF[key] = jp, jax.tree_util.tree_map(np.asarray, unwrap(jp))
    return _REF[key]


# (mode, config kwargs, measured gap over the logit scale at DeiT-Micro,
# at 2-layer DeiT-Tiny)
DEIT_CASES = {
    "off": ("off", {}, "8.0e-7, 7.5e-7"),
    "fake": ("fake", {}, "0, 0"),
    "sim": ("sim", {"quantize_nonlinear": True}, "0, 0"),
    "packed": ("packed", {"quantize_nonlinear": True}, "8.1e-8, 1.1e-2"),
    "sim_int": ("sim", {"emulate": "int"}, "1.7e-7, 9.6e-3"),
    "sim_fp8": ("sim", {"emulate": "fp8"}, "0, 0"),
    "sim_fixedpoint": ("sim", {"quantize_nonlinear": True,
                               "nl_emulate": "fixedpoint"}, "0, 0"),
    "sim_relu6": ("sim", {"quantize_nonlinear": True,
                          "nl_emulate": "relu6"}, "0, 1.8e-2"),
    "mixed": ("kernel", {"quantize_nonlinear": True, "overrides": MIXED},
              "0, 0"),
}


@pytest.mark.parametrize("name,n_layers,n_classes,size", [
    ("deit_micro", 4, 10, 32), ("deit_tiny", 2, 100, 224)])
@pytest.mark.parametrize("case", DEIT_CASES)
def test_deit_logits_vs_reference(name, n_layers, n_classes, size, case):
    """Logits of two images through ``ViTServingEngine``; "packed" and the
    mixed kernel/sim-FFN model on MXInt6 planes packed by each package,
    the others on the float weights.  Off: 1e-5 of the logit scale; the
    quantized models: MODEL_TOL (module docstring; gaps measured at this
    seed in ``DEIT_CASES``)."""
    mode, kw, _measured = DEIT_CASES[case]
    q, jq = _configs(mode, **kw)
    jp, arrays = _deit(name, n_layers, n_classes)
    jm = build_model(dataclasses.replace(jdeit.BY_NAME[name],
                                         n_layers=n_layers,
                                         n_classes=n_classes, quant=jq))
    pm = ViT(dataclasses.replace(deit.BY_NAME[name], n_layers=n_layers,
                                 n_classes=n_classes, quant=q))
    packed = mode in ("packed", "kernel")
    imgs = np.random.default_rng(0).normal(
        size=(2, size, size, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jm.logits)(
        j_pack(jp, jq.weight_fmt) if packed else jp, jnp.asarray(imgs)))
    eng = ViTServingEngine(pm, convert.vit_params(pm, arrays, device="cpu"),
                           ServeConfig(batch=2, pack_weights=packed),
                           device="cpu")
    labels, got = eng.classify(imgs)
    np.testing.assert_array_equal(labels.numpy(), want.argmax(-1))
    _close(got, want, 1e-5 if mode == "off" else MODEL_TOL)


def test_mixed_deit_runs_sim_ffns_and_kernel_attention(monkeypatch):
    """Under the mixed config a forward calls the kernels 3 + 5 per layer:
    the patch linear, LN1 into q, k, v, the softmax and ``wo`` of each
    block, the final LN and the head; no GELU kernel and no FFN linear."""
    calls = {}
    for name in ("mxint_matmul", "mxint_ln_matmul", "mxint_softmax",
                 "mxint_gelu", "mxint_layernorm"):
        fn = getattr(ops, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(ops, name, counted)
    n = 3
    q, _ = _configs("kernel", quantize_nonlinear=True, overrides=MIXED)
    pm = ViT(dataclasses.replace(deit.DEIT_MICRO, n_layers=n, quant=q))
    pp = pack_params_mxint(pm.init(1, device="cpu"), MXINT6_WEIGHT)
    pm.logits(pp, torch.zeros(2, 32, 32, 3))
    assert calls == {"mxint_matmul": n + 2, "mxint_ln_matmul": 3 * n,
                     "mxint_softmax": n, "mxint_layernorm": 1}
    assert sum(calls.values()) == 3 + 5 * n


def test_sim_against_kernel_within_tolerance():
    """The port's "sim" against its kernel mode (the plain versions here)
    on the same weights and images, 4-layer DeiT-Tiny, 1000 classes.  The
    linears' sums run in another order (float64 against the kernels'
    ordered f32 steps) and sim's GELU clips at -128 where the kernel clips
    at -127, so a later MXInt rounding step moves now and then.  Measured:
    3.7e-2 of the logit scale, argmax equal on 4 of 4 rows (at 8 layers
    and 8 images, 3.6e-2 and 7 of 8).  ``chip_smoke.py`` holds full-depth
    DeiT-Base on the card to the same limits (``SIM_KERNEL_TOL``): a
    largest gap of 0.1 of the scale and 3/4 of the rows' argmax equal."""
    base = dataclasses.replace(deit.DEIT_TINY, n_layers=4, n_classes=1000)
    q_sim, _ = _configs("sim", quantize_nonlinear=True)
    q_ker, _ = _configs("kernel", quantize_nonlinear=True)
    sim = ViT(dataclasses.replace(base, quant=q_sim))
    ker = ViT(dataclasses.replace(base, quant=q_ker))
    params = sim.init(0, device="cpu")
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(4, 224, 224, 3)).astype(np.float32))
    with torch.no_grad():
        a = sim.logits(params, x)
        b = ker.logits(pack_params_mxint(params, MXINT6_WEIGHT), x)
    gap, scale = _gap(a, b)
    assert gap <= 0.1 * scale, (gap, scale)
    assert float((a.argmax(-1) == b.argmax(-1)).float().mean()) >= 0.75


# ---------------------------------------------------------------------------
# the SMOKE Llama-3
# ---------------------------------------------------------------------------
MAX_LEN = 300


def _ref_jit(fn):
    return jax.jit(fn, compiler_options={"xla_backend_optimization_level": 0})


@pytest.fixture(scope="module")
def smoke_arrays():
    jm = build_model(jllama.SMOKE)
    jp = jax.jit(jm.init)(jax.random.key(0))
    return jp, jax.tree_util.tree_map(np.asarray, unwrap(jp))


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(
        0, llama.SMOKE.vocab, size=shape).astype(np.int32)


@pytest.mark.parametrize("mode", ["off", "sim", "packed"])
def test_smoke_llama_vs_reference(smoke_arrays, mode):
    """Prefill logits of a right-padded prompt, 8 decode steps of a batch
    of 2 (the float decode over the ring) and the loss at 640 tokens (off:
    query blocks; sim, packed: the direct MXInt softmax) and at 512.
    "packed" serves MXInt8 planes.  Logits to 1e-5 of their scale and the
    loss to 1e-5 relative (measured: prefill 4.8e-7 off, 0 sim and packed;
    loss 0 off, at most 1.2e-6 sim and packed), tokens identical."""
    jp, arrays = smoke_arrays
    q, jq = _configs(mode, **({} if mode == "off" else
                              {"quantize_nonlinear": True}))
    jm = build_model(dataclasses.replace(jllama.SMOKE, quant=jq))
    pm = DecoderLM(dataclasses.replace(llama.SMOKE, quant=q))
    packed = mode == "packed"
    jeng = JServingEngine(jm, jax.jit(lambda p: j_pack(p, J_W8))(jp)
                          if packed else jp,
                          JServeConfig(max_len=MAX_LEN, batch=2))
    jeng._prefill = _ref_jit(j_prefill_step(jm))
    jeng._decode = _ref_jit(j_decode_step(jm))
    peng = ServingEngine(pm, convert.lm_params(pm, arrays, device="cpu"),
                         ServeConfig(max_len=MAX_LEN, batch=2,
                                     pack_weights=packed,
                                     weight_fmt=MXINT8_WEIGHT), device="cpu")
    toks = np.zeros((1, 64), np.int32)
    toks[0, :37] = _tokens((37,), 1)
    want, _ = _ref_jit(jm.prefill)(jeng.params, jnp.asarray(toks),
                                  jm.cache_init(1, MAX_LEN),
                                  lengths=jnp.asarray([37], jnp.int32))
    got, _ = pm.prefill(peng.params, torch.from_numpy(toks),
                        pm.cache_init(1, MAX_LEN, "cpu"),
                        lengths=torch.tensor([37]))
    _close(got, want, 1e-5)
    np.testing.assert_array_equal(got.numpy().argmax(-1),
                                  np.asarray(want).argmax(-1))
    prompt = _tokens((2, 37), 2)
    np.testing.assert_array_equal(
        peng.generate({"tokens": prompt}, max_new_tokens=9).numpy(),
        np.asarray(jeng.generate({"tokens": jnp.asarray(prompt)},
                                 max_new_tokens=9)))
    for n in (640, 512):
        tk = _tokens((1, n), 3 + n)
        want = float(_ref_jit(jm.loss)(jeng.params,
                                       {"tokens": jnp.asarray(tk)}))
        got = float(pm.loss(peng.params, {"tokens": torch.from_numpy(tk)}))
        assert abs(got - want) <= 1e-5 * abs(want), (n, got, want)


def test_embed_and_unembed_go_through_weight_value(smoke_arrays):
    """In "sim" a float embedding table is quantize-dequantized whole
    (blocks along the vocab axis) before rows are gathered, as the
    reference does; packed planes gather first and dequantize those rows."""
    _, arrays = smoke_arrays
    q = QuantConfig(mode="sim", quantize_nonlinear=True)
    table = Param(torch.from_numpy(np.array(arrays["embed"])),
                  ("vocab", "embed"))
    toks = torch.from_numpy(_tokens((2, 5), 9)).long()
    got = L.embed_lookup(toks, table, q, torch.float32)
    qdq = q.datapath.weight_value(table.value, q=q, dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(), qdq[toks].numpy())
    jq = JQuantConfig(mode="sim", quantize_nonlinear=True)
    want = JL.embed_lookup(jnp.asarray(toks.numpy()), JParam(jnp.asarray(
        arrays["embed"]), ("vocab", "embed")), jq, jnp.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    packed = pack_params_mxint({"e": table}, MXINT8_WEIGHT)["e"]
    np.testing.assert_array_equal(
        L.embed_lookup(toks, packed, q, torch.float32).numpy(),
        q.datapath.weight_value(packed.value, q=q,
                                dtype=torch.float32)[toks].numpy())
