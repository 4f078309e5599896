"""The port's VLM, LLaVA-NeXT-Mistral-7B, against the reference.

SMOKE (2 layers, d 64, 4 query heads over 2, 8 vision positions of dim
32): the reference's parameters through ``convert.lm_params`` (with
``vision_proj``), both packages packing them to MXInt8 planes, in kernel
mode (``QuantConfig(mode='kernel', quantize_nonlinear=True)``): the
packed planes (the projector stays float, as the reference's packing
rule leaves a weight without a named contraction axis); the prefill's
logits with vision embeddings; ``generate`` with vision embeddings in
kernel mode and in "sim", each against the reference in the same mode;
``loss`` with vision embeddings; the kernel launches, derived per block kind and pinned at
full depth.  The reference's fixes and jit are ``test_torch_lm.py``'s.
Measured: the logits and losses bit-identical, the tokens identical.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import test_torch_lm as base  # noqa: E402
from repro.configs import llava_next_mistral_7b as jllava  # noqa: E402
from repro.core.mx_types import MXINT8_WEIGHT as J_W8  # noqa: E402
from repro.core.mx_types import QuantConfig as JQuantConfig  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.models.model_api import unwrap  # noqa: E402
from repro.serving.engine import pack_params_mxint as j_pack  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import llava_next_mistral_7b as llava  # noqa: E402
from repro_torch.core.mx_types import MXINT8_WEIGHT, QuantConfig  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.launches import lm_launches  # noqa: E402
from repro_torch.serving.engine import ServeConfig, ServingEngine  # noqa: E402
from test_torch_lm import jax_reference  # noqa: E402,F401  (fixture)

SIM = dict(mode="sim", quantize_nonlinear=True)


def _batch(rows, tokens, seed, cfg=llava.SMOKE):
    """numpy tokens and float32 vision embeddings for the first
    ``cfg.vision_tokens`` positions."""
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, size=(rows, tokens)).astype(
                np.int32),
            "vision_embeds": rng.normal(size=(
                rows, cfg.vision_tokens, cfg.vision_dim)).astype(np.float32)}


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def vlm():
    """(reference model, its engine, port model, its engine) on the SMOKE
    parameters packed to MXInt8 planes, in kernel mode."""
    jm = j_build_model(dataclasses.replace(
        jllava.SMOKE, quant=JQuantConfig(**base.KERNEL)))
    pm = build_model(dataclasses.replace(llava.SMOKE,
                                         quant=QuantConfig(**base.KERNEL)))
    jp = jax.jit(jm.init)(jax.random.key(0))
    pp = convert.lm_params(pm, jax.tree_util.tree_map(np.asarray, unwrap(jp)),
                           device="cpu")
    jeng = base._ref_engine(jm, jax.jit(lambda p: j_pack(p, J_W8))(jp),
                            batch=2, pack=False)
    peng = ServingEngine(pm, pp, ServeConfig(
        max_len=base.MAX_LEN, batch=2, pack_weights=True,
        weight_fmt=MXINT8_WEIGHT), device="cpu")
    return jm, jeng, pm, peng


def test_configs_are_the_references():
    """FULL and SMOKE equal the reference's field for field, over the
    fields the port's ModelConfig has."""
    for which in ("FULL", "SMOKE"):
        j, p = getattr(jllava, which), getattr(llava, which)
        for f in dataclasses.fields(p):
            if f.name not in ("quant", "dtype"):
                assert getattr(p, f.name) == getattr(j, f.name), f.name
        assert str(p.dtype).split(".")[-1] == str(jnp.dtype(j.dtype))
    assert llava.FULL.vision_tokens == jllava.VISION_TOKENS == 2880


def test_packed_planes_equal_reference(vlm):
    """Every layer leaf, the tables and the projector packed or float as
    the reference's are, with the same planes or values."""
    jm, jeng, pm, peng = vlm
    ref = unwrap(jeng.params)
    for layer, (rl, u) in zip(peng.params["layers"],
                              base._ref_layers(pm.cfg, ref)):
        theirs = dict(base._leaves(rl))
        for key, p in base._leaves(layer):
            r = theirs[key] if u is None else jax.tree_util.tree_map(
                lambda a: a[u], theirs[key])
            if hasattr(r, "mantissa"):
                np.testing.assert_array_equal(p.value.mantissa.numpy(),
                                              np.asarray(r.mantissa))
                np.testing.assert_array_equal(p.value.exponent.numpy(),
                                              np.asarray(r.exponent))
            else:
                np.testing.assert_array_equal(p.value.numpy(), np.asarray(r))
    for name in ("embed", "unembed"):
        np.testing.assert_array_equal(peng.params[name].value.mantissa.numpy(),
                                      np.asarray(ref[name].mantissa))
    proj = peng.params["vision_proj"]
    assert isinstance(proj.value, torch.Tensor) and \
        not hasattr(ref["vision_proj"], "mantissa")
    assert proj.axes == (None, "embed")
    np.testing.assert_array_equal(proj.value.numpy(),
                                  np.asarray(ref["vision_proj"]))


def test_prefill_logits_with_vision_embeds_vs_reference(vlm):
    """A 24-token prefill whose first 8 positions are the projected vision
    embeddings: logits held to 1e-5 of their scale (measured gap 0, bit-
    identical), argmax equal; without the embeddings the logits differ."""
    jm, jeng, pm, peng = vlm
    b = _batch(2, 24, 1)
    # the reference engine's prefill step, compiled once for this shape
    # and the generate case's
    want, _ = jeng._prefill(jeng.params, _jnp(b),
                            jm.cache_init(2, base.MAX_LEN))
    got, cache = pm.prefill(peng.params, torch.from_numpy(b["tokens"]),
                            pm.cache_init(2, base.MAX_LEN, "cpu"),
                            torch.from_numpy(b["vision_embeds"]))
    base._close(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy().argmax(-1),
                                  np.asarray(want).argmax(-1))
    assert cache["index"].tolist() == [24, 24]
    plain, _ = pm.prefill(peng.params, torch.from_numpy(b["tokens"]),
                          pm.cache_init(2, base.MAX_LEN, "cpu"))
    assert not torch.equal(plain, got)


@pytest.mark.parametrize("mode", ["kernel", "sim"])
def test_generate_tokens_vs_reference(vlm, mode):
    """``generate`` with vision embeddings (a 24-token prompt, 6 new
    tokens) on the same planes, against the reference in the same mode:
    tokens identical.  (The two modes differ from each other, in both
    packages: the kernels clip the GELU at -127, sim at -128, and sum
    their products in another order.)"""
    jm, jeng, pm, peng = vlm
    b = _batch(2, 24, 2)
    if mode == "sim":
        jeng = base._ref_engine(j_build_model(dataclasses.replace(
            jllava.SMOKE, quant=JQuantConfig(**SIM))), jeng.params, batch=2,
            pack=False)
        peng = ServingEngine(build_model(dataclasses.replace(
            llava.SMOKE, quant=QuantConfig(**SIM))), peng.params,
            ServeConfig(max_len=base.MAX_LEN, batch=2), device="cpu")
    np.testing.assert_array_equal(
        peng.generate(b, max_new_tokens=6).numpy(),
        np.asarray(jeng.generate(_jnp(b), max_new_tokens=6)))


def test_loss_with_vision_embeds_vs_reference(vlm):
    """A 64-token loss with vision embeddings (the whole-row attention):
    held to 1e-6 relative (measured 0, bit-identical)."""
    jm, jeng, pm, peng = vlm
    b = _batch(2, 64, 3)
    want = float(base._ref_jit(jm.loss)(jeng.params, _jnp(b)))
    with torch.no_grad():
        got = float(pm.loss(peng.params, b))
    assert abs(got - want) <= 1e-6 * abs(want), (got, want)


def test_kernel_launch_structure(monkeypatch, vlm):
    """A prefill with vision embeddings launches the decoder's kernels and
    one ``mxint_matmul`` more (the projector, packed at each call); a
    decode step the decoder's; a 64-token loss with vision embeddings the
    whole-row softmax in each layer and the projector.  At full depth:
    258 a prefill, 289 a decode step, 290 a score."""
    _, _, pm, peng = vlm
    calls = dict.fromkeys(ops.LAUNCH_COUNTERS, 0)
    for name in calls:
        def counted(*a, _fn=getattr(ops, name), _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(ops, name, counted)

    def take():
        out = dict(calls)
        for k in calls:
            calls[k] = 0
        return out

    b = _batch(2, 24, 4)
    cache = pm.cache_init(2, base.MAX_LEN, "cpu")
    _, cache = peng._prefill(peng.params, {
        k: torch.from_numpy(v) for k, v in b.items()}, cache)
    assert take() == lm_launches(pm.cfg, 24, vision=True)
    peng._decode(peng.params, torch.zeros(2, 1, dtype=torch.int32), cache)
    assert take() == lm_launches(pm.cfg, 1, decode=True)
    with torch.no_grad():
        pm.loss(peng.params, _batch(1, 64, 5))
    assert take() == lm_launches(pm.cfg, 64, score=True, vision=True)
    full = llava.FULL
    got = (sum(lm_launches(full, 3072, vision=True).values()),
           sum(lm_launches(full, 1, decode=True).values()),
           sum(lm_launches(full, 3072, score=True, vision=True).values()))
    assert got == (258, 289, 290)
