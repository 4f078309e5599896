"""The port's encoder-decoder, SeamlessM4T-medium (``EncDecLM``),
against the reference.

SMOKE (2 encoder and 2 decoder layers, d 64, 4 heads, d_ff 128): the
reference's parameters through ``convert.encdec_params``, both packages
packing them to MXInt8 planes: the packed planes; ``generate`` (the
reference serves the encoder-decoder through its prefill and decode
steps) in kernel mode (``QuantConfig(mode='kernel',
quantize_nonlinear=True)``) and in "sim" at 40 frames (the whole-row
encoder attention) and at 640 (past 512 x 512 scores: the flash kernel
in kernel mode, query blocks in "sim"), with the prefill's logits and
its cross K/V (``encode_kv`` of ``encode``); ``loss``; the packing rule on a config of 3 encoder and 2
decoder layers, whose block lists are stacks of different sizes; the
kernel launches, derived per block kind and pinned at full depth.  The
reference's fixes and jit are ``test_torch_lm.py``'s.  Each test states
its tolerance and the gap it measured.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import test_torch_lm as base  # noqa: E402
from repro.configs import seamless_m4t_medium as jseamless  # noqa: E402
from repro.core.mx_types import MXINT8_WEIGHT as J_W8  # noqa: E402
from repro.core.mx_types import QuantConfig as JQuantConfig  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.models.model_api import unwrap  # noqa: E402
from repro.serving.engine import make_decode_step as j_decode_step  # noqa: E402
from repro.serving.engine import make_prefill_step as j_prefill_step  # noqa: E402
from repro.serving.engine import pack_params_mxint as j_pack  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import seamless_m4t_medium as seamless  # noqa: E402
from repro_torch.core.mx_types import MXINT8_WEIGHT, QuantConfig  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import EncDecLM, build_model  # noqa: E402
from repro_torch.models.launches import encdec_launches  # noqa: E402
from repro_torch.serving.engine import (ServeConfig,  # noqa: E402
                                        ServingEngine, pack_params_mxint)
from test_torch_lm import jax_reference  # noqa: E402,F401  (fixture)

MODES = {"kernel": base.KERNEL, "sim": dict(mode="sim",
                                           quantize_nonlinear=True)}
MAX_LEN = 64
PROMPT = 8
NEW_TOKENS = 5
# At 640 frames the encoder's attention sums in another order than the
# reference's: in kernel mode the flash kernel's plain version walks the
# 128-key tiles in the CUDA kernel's order, the reference's Pallas kernel
# in its own (the op itself agrees to 3.6e-7 of its scale,
# tests/test_torch_flash.py); in "sim" the query-blocked float attention
# runs its exp and sums in float64 rounded once, the reference's in
# float32.  A last-bit difference moves MXInt act-grid steps downstream,
# as the parity contract allows for these sums, and a moved step moves
# the rows that read it.  Measured at 640 frames (2 rows): kernel mode,
# the prefill's logits 0.0199 of 0.492 apart (4.0%; 512 of 1024
# elements), the cross K/V up to 0.124 of 4.40 (2.8%; 12% of the
# elements); "sim", the logits 0.0222 of 0.492 (4.5%), the cross K/V up
# to 0.138 of 4.38 (3.1%; 4% of the elements); the tokens identical.
# That attention is the whole cause: the same prefill with the
# reference's own attention op in the encoder (``_ref_attention``) gives
# logits and cross K/V bit-identical to the reference's in both modes.
# At 40 frames (the whole-row attention) the logits and cross K/V are
# bit-identical in both modes, and the kernel-mode loss within 7.7e-8
# relative.
LOSS_TOL = 1e-6
ENCODE_TOL = {40: 1e-5, 640: 8e-2}


def _batch(rows, frames, tokens, seed, d=seamless.SMOKE.d_model):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, seamless.SMOKE.vocab, size=(
                rows, tokens)).astype(np.int32),
            "frames": rng.normal(size=(rows, frames, d)).astype(np.float32)}


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _models(mode, cfg=None, jcfg=None):
    q = MODES[mode]
    jm = j_build_model(dataclasses.replace(jcfg or jseamless.SMOKE,
                                           quant=JQuantConfig(**q)))
    pm = build_model(dataclasses.replace(cfg or seamless.SMOKE,
                                         quant=QuantConfig(**q)))
    return jm, pm


@pytest.fixture(scope="module")
def params():
    """(the reference's SMOKE parameters, the same packed to MXInt8 planes;
    the port's float parameters, its planes)."""
    jm, pm = _models("kernel")
    jp = jax.jit(jm.init)(jax.random.key(0))
    pp = convert.encdec_params(pm, jax.tree_util.tree_map(
        np.asarray, unwrap(jp)), device="cpu")
    return (jp, jax.jit(lambda p: j_pack(p, J_W8))(jp), pp,
            pack_params_mxint(pp, MXINT8_WEIGHT, pm.layer_stacks()))


def _ref_generate(jm, params, batch, new_tokens):
    """The reference's greedy generation through its prefill and decode
    steps (its ``ServingEngine`` builds a slot prefill, which the
    encoder-decoder has not): (tokens, the prefill's logits, its cache)."""
    prefill = base._ref_jit(j_prefill_step(jm))
    decode = base._ref_jit(j_decode_step(jm))
    logits, cache = prefill(params, _jnp(batch),
                            jm.cache_init(batch["tokens"].shape[0], MAX_LEN))
    first = cache
    tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
    out = [tok]
    for _ in range(new_tokens - 1):
        tok, cache = decode(params, tok, cache)
        out.append(tok)
    return np.asarray(jnp.concatenate(out, axis=1)), logits, first


def _ref_attention(mode, monkeypatch):
    """Route the port's cache-less attention past 512 x 512 scores (the
    encoder's at 640 frames) through the reference's backend in ``mode``,
    jitted as the reference's steps are; smaller calls stay the port's."""
    jq = JQuantConfig(**MODES[mode])
    backend = type(QuantConfig(**MODES[mode]).datapath)
    own = backend.attention

    def attention(self, qv, k, v, *, positions, causal, window, scale,
                  chunk, **kw):
        if qv.shape[1] * k.shape[1] <= ops.PAPER_MAX_SCORES:
            return own(self, qv, k, v, positions=positions, causal=causal,
                       window=window, scale=scale, chunk=chunk, **kw)
        ref = base._ref_jit(lambda *a: jq.datapath.attention(
            *a[:3], q=jq, positions=a[3], causal=causal, window=window,
            scale=scale, chunk=chunk))
        return torch.from_numpy(np.array(ref(*(
            jnp.asarray(t.numpy()) for t in (qv, k, v, positions)))))

    monkeypatch.setattr(backend, "attention", attention)


def test_configs_are_the_references():
    """FULL and SMOKE equal the reference's field for field, over the
    fields the port's ModelConfig has; ``build_model`` builds
    ``EncDecLM`` for them."""
    for which in ("FULL", "SMOKE"):
        j, p = getattr(jseamless, which), getattr(seamless, which)
        for f in dataclasses.fields(p):
            if f.name not in ("quant", "dtype"):
                assert getattr(p, f.name) == getattr(j, f.name), f.name
        assert str(p.dtype).split(".")[-1] == str(jnp.dtype(j.dtype))
        assert isinstance(build_model(p), EncDecLM)


def _ref_blocks(tree, n):
    return [jax.tree_util.tree_map(lambda a: a[i], tree) for i in range(n)]


def _same_leaves(mine, theirs):
    """Each leaf packed or float as the reference's, with its planes or
    values."""
    theirs = dict(base._leaves(theirs))
    got = base._leaves(mine)
    assert {k for k, _ in got} == set(theirs)
    for key, p in got:
        r = theirs[key]
        if hasattr(r, "mantissa"):
            np.testing.assert_array_equal(p.value.mantissa.numpy(),
                                          np.asarray(r.mantissa))
            np.testing.assert_array_equal(p.value.exponent.numpy(),
                                          np.asarray(r.exponent))
        else:
            assert not hasattr(p.value, "mantissa"), key
            np.testing.assert_array_equal(p.value.numpy(), np.asarray(r))


def test_packed_planes_equal_reference(params):
    """Every block of both lists, the tables and the norms, packed or
    float as the reference's stacked leaves are: block i is slice i."""
    _, jpp, _, planes = params
    ref = unwrap(jpp)
    for key, n in (("enc_blocks", 2), ("dec_blocks", 2)):
        for mine, theirs in zip(planes[key], _ref_blocks(ref[key], n)):
            _same_leaves(mine, theirs)
    _same_leaves({k: v for k, v in planes.items() if not k.endswith(
        "blocks")}, {k: v for k, v in ref.items() if not k.endswith(
            "blocks")})
    with pytest.raises(ValueError, match="enc_blocks"):
        convert.encdec_params(_models("kernel")[1], {"embed": ref["embed"]},
                              device="cpu")


def test_packing_sizes_each_block_list_by_its_own_depth():
    """3 encoder and 2 decoder layers at d 80, d_ff 96: a (80, 80) or
    (80, 96) leaf reaches the packing rule's 16384 elements as a stack
    of 3 (19200, 23040) and not of 2 (12800, 15360), so the encoder's
    attention and FFN weights are packed and the decoder's are not,
    as the reference's stacked leaves decide; ``init`` packs as it
    draws by the same rule."""
    cfg = dataclasses.replace(seamless.SMOKE, n_encoder_layers=3,
                              n_layers=2, d_model=80, d_ff=96)
    jcfg = dataclasses.replace(jseamless.SMOKE, n_encoder_layers=3,
                               n_layers=2, d_model=80, d_ff=96)
    jm, pm = _models("kernel", cfg, jcfg)
    jp = jax.jit(jm.init)(jax.random.key(1))
    ref = unwrap(jax.jit(lambda p: j_pack(p, J_W8))(jp))
    planes = pack_params_mxint(convert.encdec_params(
        pm, jax.tree_util.tree_map(np.asarray, unwrap(jp)), device="cpu"),
        MXINT8_WEIGHT, pm.layer_stacks())
    for key, n in (("enc_blocks", 3), ("dec_blocks", 2)):
        assert len(planes[key]) == n
        for mine, theirs in zip(planes[key], _ref_blocks(ref[key], n)):
            _same_leaves(mine, theirs)
    enc, dec = planes["enc_blocks"][0], planes["dec_blocks"][0]
    assert all(hasattr(enc["mix"][w].value, "mantissa")
               for w in ("wq", "wk", "wv", "wo"))
    assert hasattr(enc["ffn"]["wi"].value, "mantissa")
    assert not any(hasattr(dec[a][w].value, "mantissa")
                   for a in ("self_attn", "cross_attn")
                   for w in ("wq", "wk", "wv", "wo"))
    assert not hasattr(dec["ffn"]["wi"].value, "mantissa")
    drawn = pm.init(0, device="cpu", pack_fmt=MXINT8_WEIGHT)
    for key in ("enc_blocks", "dec_blocks"):
        for da, db in zip(drawn[key], planes[key]):
            for a, b in zip(base._leaves(da), base._leaves(db)):
                assert hasattr(a[1].value, "mantissa") == \
                    hasattr(b[1].value, "mantissa"), (key, a[0])


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("frames", [40, 640])
def test_generate_tokens_vs_reference(params, mode, frames):
    """``ServingEngine.generate`` of 2 rows (an 8-token prompt, 5 new
    tokens) against the reference's prefill and decode steps in the same
    mode: tokens identical.  The prefill's cross K/V of every decoder
    layer (``encode_kv`` of ``encode``) and its logits held to
    ``ENCODE_TOL`` of their scale by frame count; at 640 frames, with the
    reference's encoder attention (``_ref_attention``), bit for bit.
    Kernel mode on the planes, "sim" on the float parameters."""
    jp, jpp, pp, planes = params
    jm, pm = _models(mode)
    packed = mode == "kernel"
    b = _batch(2, frames, PROMPT, 2)
    want, wlogits, wcache = _ref_generate(jm, jpp if packed else jp, b,
                                          NEW_TOKENS)
    eng = ServingEngine(pm, planes if packed else pp, ServeConfig(
        max_len=MAX_LEN, batch=2), device="cpu")
    assert eng._prefill_slot is None
    np.testing.assert_array_equal(
        eng.generate(b, max_new_tokens=NEW_TOKENS).numpy(), want)
    logits, cache = eng._prefill(eng.params, b, pm.cache_init(2, MAX_LEN,
                                                              "cpu"))
    tol = ENCODE_TOL[frames]
    base._close(logits.numpy(), wlogits, tol)
    assert len(cache["enc_kv"]) == 2 and int(cache["index"]) == PROMPT
    for i, (k, v) in enumerate(cache["enc_kv"]):
        base._close(k.numpy(), wcache["enc_kv"][0][i], tol)
        base._close(v.numpy(), wcache["enc_kv"][1][i], tol)
    if frames > 512:
        # the witness: with the reference's encoder attention, bit for bit
        with pytest.MonkeyPatch.context() as mp:
            _ref_attention(mode, mp)
            logits, cache = eng._prefill(eng.params, b, pm.cache_init(
                2, MAX_LEN, "cpu"))
        np.testing.assert_array_equal(logits.numpy(), np.asarray(wlogits))
        for i, (k, v) in enumerate(cache["enc_kv"]):
            np.testing.assert_array_equal(k.numpy(),
                                          np.asarray(wcache["enc_kv"][0][i]))
            np.testing.assert_array_equal(v.numpy(),
                                          np.asarray(wcache["enc_kv"][1][i]))


def test_loss_vs_reference(params):
    """The mean next-token loss of 2 x 16 tokens given 40 frames, kernel
    mode on the planes, against the reference: within ``LOSS_TOL``
    relative (measured 7.7e-8).  "off" is held in
    ``tests/test_torch_train_step.py`` with its gradients; the flash
    route at 640 frames by ``test_generate_tokens_vs_reference``."""
    _, jpp, _, planes = params
    jm, pm = _models("kernel")
    b = _batch(2, 40, 16, 3)
    want = float(base._ref_jit(jm.loss)(jpp, _jnp(b)))
    with torch.no_grad():
        got = float(pm.loss(planes, b))
    assert abs(got - want) <= LOSS_TOL * abs(want), (got, want)


def test_kernel_launch_structure(monkeypatch, params):
    """The SMOKE's prefill at 40 and 640 frames, a decode step and a loss
    held to ``encdec_launches``; no ``mxint_ln_matmul`` (the norms are
    separate RMSNorms).  At full depth (12 + 12 layers): 302 a prefill
    (at 1024 frames the encoder's flash kernel, at 256 its whole-row
    softmax) and 169 a decode step."""
    _, _, _, planes = params
    _, pm = _models("kernel")
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

    eng = ServingEngine(pm, planes, ServeConfig(max_len=MAX_LEN, batch=2),
                        device="cpu")
    for frames in (40, 640):
        b = _batch(2, frames, PROMPT, 4)
        cache = pm.cache_init(2, MAX_LEN, "cpu")
        _, cache = eng._prefill(eng.params, {
            k: torch.from_numpy(v) for k, v in b.items()}, cache)
        assert take() == encdec_launches(pm.cfg, frames, PROMPT)
        assert int(cache["index"]) == PROMPT and cache["index"].ndim == 0
        eng._decode(eng.params, torch.zeros(2, 1, dtype=torch.int32), cache)
        assert take() == encdec_launches(pm.cfg, frames, 1, decode=True)
    with torch.no_grad():
        pm.loss(eng.params, _batch(1, 40, 16, 5))
    assert take() == encdec_launches(pm.cfg, 40, 16, score=True)
    full = seamless.FULL
    for frames, encoder in ((1024, "flash_attention"),
                            (256, "mxint_softmax")):
        pre = encdec_launches(full, frames, 16)
        assert pre[encoder] >= 12 and pre["mxint_ln_matmul"] == 0
        assert (sum(pre.values()), sum(encdec_launches(
            full, frames, 1, decode=True).values())) == (302, 169)
