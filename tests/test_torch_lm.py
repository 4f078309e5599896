"""The port's decoder LM slice against the reference ``DecoderLM`` in
kernel mode (``QuantConfig(mode='kernel', quantize_nonlinear=True)``).

Each case that takes the ``config`` or the ``lm`` fixture runs here for
``llama3_8b``, and for each other config in a file of its own
(``CONFIG_FILES``), so that the test runner can give the configs to
several workers: ``qwen3_14b`` (per-head q/k RMSNorm, 2 query heads per
KV head in SMOKE, head dim 16); ``phi4_mini_3_8b`` (tied embeddings: one
packed table serves the row gather and the unembedding; 3 query heads
per KV head, head dim 8); ``deepseek_67b`` (3 layers, one KV head for 8
query heads) and the mixture-of-experts decoders ``mixtral_8x7b`` (4
experts top-2, a 16-slot sliding-window ring) and
``granite_moe_3b_a800m`` (8 experts top-4, tied embeddings), whose
``loss`` adds the layers' load-balancing loss; the recurrent families,
``recurrentgemma_2b`` ((rec, rec, attn) and a (rec, rec) tail, a 16-slot
local-attention ring) and ``xlstm_350m`` (two units of 3 mLSTM + 1
sLSTM, no FFN), whose files keep a part of the cases.  The reference's
SMOKE parameters (f32) go through
``convert.lm_params``; both packages pack them to MXInt8 planes and serve
or score the same numpy tokens.  The reference runs under two scoped fixes
for the installed jax (the ``TPUCompilerParams`` alias and an exact
``exp2`` on integer inputs).

The reference's steps are compiled with ``xla_backend_optimization_level``
0.  At the default level XLA's CPU backend rounds some fused float
expressions differently from the same operations run one by one (the
reference's own ``jax.disable_jit()`` run differs from its jitted run),
and with random SMOKE weights one MXInt rounding step that moves is
enough to change a token: the top two logits lie 0.3% of their scale
apart, one moved act-grid step moves the logits by 2.5%.  At level 0 the
reference's jitted steps round as its op-by-op run does.

Tolerance: the port's attention products and row sums run in another
order than the reference's and its RoPE and prefill softmax call torch's
transcendental functions rather than XLA's, and its MoE expert products
run in float64 against XLA's float32 dot, so logits are held to 1e-5 of
their scale (measured gap: 0, bit-identical, for all six configs: the
next MXInt stage absorbs the last-bit differences); generated tokens
must be identical.
"""
import dataclasses
import inspect
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from repro.configs import deepseek_67b as jdeepseek  # noqa: E402
from repro.configs import granite_moe_3b_a800m as jgranite  # noqa: E402
from repro.configs import llama3_8b as jllama  # noqa: E402
from repro.configs import mixtral_8x7b as jmixtral  # noqa: E402
from repro.configs import phi4_mini_3_8b as jphi  # noqa: E402
from repro.configs import qwen3_14b as jqwen  # noqa: E402
from repro.configs import recurrentgemma_2b as jrg  # noqa: E402
from repro.configs import xlstm_350m as jxl  # noqa: E402
from repro.core.mx_types import MXINT8_WEIGHT as J_W8  # noqa: E402
from repro.core.mx_types import NEG_INF as J_NEG_INF  # noqa: E402
from repro.core.mx_types import QuantConfig as JQuantConfig  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.models.model_api import unwrap  # noqa: E402
from repro.serving.engine import ServeConfig as JServeConfig  # noqa: E402
from repro.serving.engine import ServingEngine as JServingEngine  # noqa: E402
from repro.serving.engine import make_decode_step as j_decode_step  # noqa: E402
from repro.serving.engine import make_prefill_step as j_prefill_step  # noqa: E402
from repro.serving.engine import make_slot_prefill_step as j_slot_step  # noqa: E402
from repro.serving.engine import pack_params_mxint as j_pack  # noqa: E402
from repro.serving.scheduler import BatchScheduler as JBatchScheduler  # noqa: E402
from repro.serving.scheduler import Request as JRequest  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import deepseek_67b as deepseek  # noqa: E402
from repro_torch.configs import granite_moe_3b_a800m as granite  # noqa: E402
from repro_torch.configs import llama3_8b as llama  # noqa: E402
from repro_torch.configs import mixtral_8x7b as mixtral  # noqa: E402
from repro_torch.configs import phi4_mini_3_8b as phi  # noqa: E402
from repro_torch.configs import qwen3_14b as qwen  # noqa: E402
from repro_torch.configs import recurrentgemma_2b as rg  # noqa: E402
from repro_torch.configs import xlstm_350m as xl  # noqa: E402
from repro_torch.core.mx_types import (MXINT8_WEIGHT, NEG_INF,  # noqa: E402
                                       QuantConfig)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.launches import lm_launches  # noqa: E402
from repro_torch.models.transformer import DecoderLM, EncDecLM  # noqa: E402
from repro_torch.serving.engine import (ServeConfig,  # noqa: E402
                                        ServingEngine, make_decode_step,
                                        pack_params_mxint)
from repro_torch.serving.scheduler import BatchScheduler, Request  # noqa: E402

KERNEL = dict(mode="kernel", quantize_nonlinear=True)
MAX_LEN = 300                # three 128-slot tiles, the last one padded
# config name -> (reference config module, port config module)
CONFIGS = {"llama3_8b": (jllama, llama), "qwen3_14b": (jqwen, qwen),
           "phi4_mini_3_8b": (jphi, phi),
           "deepseek_67b": (jdeepseek, deepseek),
           "mixtral_8x7b": (jmixtral, mixtral),
           "granite_moe_3b_a800m": (jgranite, granite),
           "recurrentgemma_2b": (jrg, rg), "xlstm_350m": (jxl, xl)}
# the file that runs each config's cases: one config a file, so that the
# test runner's workers share them out (``--dist loadfile`` gives a whole
# file to one worker)
CONFIG_FILES = {"llama3_8b": "test_torch_lm.py",
                "qwen3_14b": "test_torch_lm_qwen3.py",
                "phi4_mini_3_8b": "test_torch_lm_phi4.py",
                "deepseek_67b": "test_torch_lm_deepseek.py",
                "mixtral_8x7b": "test_torch_lm_mixtral.py",
                "granite_moe_3b_a800m": "test_torch_lm_granite.py",
                "recurrentgemma_2b": "test_torch_lm_recurrent.py",
                "xlstm_350m": "test_torch_lm_xlstm.py"}
HERE = ("llama3_8b",)
RECURRENT = ("recurrentgemma_2b", "xlstm_350m")
assert set(CONFIG_FILES) == set(CONFIGS) and all(
    (Path(__file__).parent / f).is_file() for f in CONFIG_FILES.values())
VOCAB = 512                  # every SMOKE config's
SMOKE_NAMES = {pcfg.SMOKE.name: name for name, (_, pcfg) in CONFIGS.items()}
# the loss's tolerance, relative: Llama's losses are bit-identical (measured
# gap 0).  The online flash path sums its scores and P.V in another order
# than the reference's, so one moved act-grid step is within the parity
# contract: Qwen3's 640-token logits differ at 1 of 640 positions, by
# 7.2e-3 of their scale 0.733 (argmax equal), and its loss by 6.2e-6 (9.9e-7
# relative); Phi-4-mini's logits are bit-identical and its losses differ by
# one ulp (4.8e-7, torch's and XLA's log-softmax sums).  DeepSeek-67B's
# 640-token loss differs by 2.4e-6 (3.8e-7 relative), its 512-token loss
# not at all; Mixtral's and Granite-MoE's losses, the layers' load-
# balancing loss included, are bit-identical.  Held to 1e-5.
LOSS_TOL = {"llama3_8b": 1e-6, "qwen3_14b": 1e-5, "phi4_mini_3_8b": 1e-5,
            "deepseek_67b": 1e-5, "mixtral_8x7b": 1e-5,
            "granite_moe_3b_a800m": 1e-5}


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

    for fn in (torch.exp, torch.sin, torch.cos, torch.log):
        fn(torch.ones(1))
    mp = pytest.MonkeyPatch()
    mp.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
               raising=False)
    mp.setattr(jnp, "exp2", exact_exp2)
    jax.clear_caches()
    # one intra-op thread: the test runner's workers share the cores, and
    # torch's default of one spinning thread a core in every worker left
    # the suite several times slower than the same work in one thread a
    # worker; the results do not depend on it
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    mp.undo()
    jax.clear_caches()


def _ref_jit(fn):
    """The reference's jit at backend optimization level 0 (see above)."""
    return jax.jit(fn, compiler_options={"xla_backend_optimization_level": 0})


def _ref_engine(jm, params, batch, pack=True):
    eng = JServingEngine(jm, params, JServeConfig(
        max_len=MAX_LEN, batch=batch, pack_weights=pack, weight_fmt=J_W8))
    eng._prefill = _ref_jit(j_prefill_step(jm))
    eng._decode = _ref_jit(j_decode_step(jm))
    eng._prefill_slot = _ref_jit(j_slot_step(jm, MAX_LEN))
    return eng


def _models(name, window=None):
    """Both packages' SMOKE models in kernel mode; ``window`` replaces the
    config's own (0 for the dense configs, 16 for Mixtral)."""
    jcfg, pcfg = CONFIGS[name]
    w = pcfg.SMOKE.window if window is None else window
    jm = build_model(dataclasses.replace(jcfg.SMOKE, window=w,
                                         quant=JQuantConfig(**KERNEL)))
    pm = DecoderLM(dataclasses.replace(pcfg.SMOKE, window=w,
                                       quant=QuantConfig(**KERNEL)))
    return jm, pm


def test_smoke_configs_are_the_references():
    """FULL and SMOKE of each port config equal the reference's field for
    field, over the fields the port's ModelConfig has (the ``MoEConfig``
    field for field too)."""
    for jcfg, pcfg in CONFIGS.values():
        for which in ("FULL", "SMOKE"):
            j, p = getattr(jcfg, which), getattr(pcfg, which)
            for f in dataclasses.fields(p):
                if f.name in ("quant", "dtype", "moe"):
                    continue
                assert getattr(p, f.name) == getattr(j, f.name), \
                    (j.name, which, f.name)
            assert (p.moe is None) == (j.moe is None), (j.name, which)
            if p.moe is not None:
                assert dataclasses.asdict(p.moe) == dataclasses.asdict(
                    j.moe), (j.name, which)
            assert str(p.dtype).split(".")[-1] == str(
                jnp.dtype(j.dtype)), (j.name, which)
        assert pcfg.SMOKE.vocab == VOCAB


def make_lm(name):
    """(reference model, its engine, port model, its engine), both with
    the SMOKE parameters of config ``name`` packed to MXInt8 planes."""
    jm, pm = _models(name)
    jp = jax.jit(jm.init)(jax.random.key(0))
    arrays = jax.tree_util.tree_map(np.asarray, unwrap(jp))
    pp = convert.lm_params(pm, arrays, device="cpu")
    jeng = _ref_engine(jm, jax.jit(lambda p: j_pack(p, J_W8))(jp), batch=2,
                       pack=False)
    peng = ServingEngine(pm, pp, ServeConfig(max_len=MAX_LEN, batch=2,
                                             pack_weights=True,
                                             weight_fmt=MXINT8_WEIGHT),
                         device="cpu")
    return jm, jeng, pm, peng


@pytest.fixture(scope="module", params=HERE)
def config(request):
    """The config a case runs for (the files of ``CONFIG_FILES`` give
    the others)."""
    return request.param


@pytest.fixture(scope="module")
def lm(config):
    return make_lm(config)


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(
        0, VOCAB, size=shape).astype(np.int32)


def _close(got, want, tol=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    gap, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert gap <= tol * scale, (gap, scale)
    return gap


def test_neg_inf_equals_reference():
    assert NEG_INF == J_NEG_INF


def _ref_layers(cfg, tree):
    """(the reference subtree, the unit repeat or None) of each port
    layer: the unit repeats, then the tail."""
    out = [(tree["units"][f"u{j}_{k}"], u)
           for u in range(cfg.resolved_n_units)
           for j, k in enumerate(cfg.unit)]
    return out + [(tree["tail"][f"t{j}_{k}"], None)
                  for j, k in enumerate(cfg.tail)]


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _leaves(tree[k], prefix + (k,))]
    return [(prefix, tree)]


def test_packed_planes_equal_reference(lm):
    """Every leaf of every layer is packed or float as the reference's is,
    with its planes or values: a unit layer's slice of the reference's
    stack, a tail layer's own leaf."""
    jm, jeng, pm, peng = lm
    ref = unwrap(jeng.params)
    for layer, (rl, u) in zip(peng.params["layers"],
                              _ref_layers(pm.cfg, ref)):
        theirs = dict(_leaves(rl))
        mine = _leaves(layer)
        assert {k for k, _ in mine} == set(theirs)
        for key, p in mine:
            r = theirs[key]
            if hasattr(r, "mantissa"):
                np.testing.assert_array_equal(
                    p.value.mantissa.numpy(),
                    np.asarray(r.mantissa if u is None else r.mantissa[u]))
                np.testing.assert_array_equal(
                    p.value.exponent.numpy(),
                    np.asarray(r.exponent if u is None else r.exponent[u]))
            else:
                assert not hasattr(p.value, "mantissa"), key
                np.testing.assert_array_equal(
                    p.value.numpy(), np.asarray(r if u is None else r[u]))
    tables = ("embed",) if pm.cfg.tie_embeddings else ("embed", "unembed")
    assert set(tables) == {k for k in ref if k in ("embed", "unembed")}
    for name in tables:
        p, r = peng.params[name].value, ref[name]
        np.testing.assert_array_equal(p.mantissa.numpy(),
                                      np.asarray(r.mantissa))
        np.testing.assert_array_equal(p.exponent.numpy(),
                                      np.asarray(r.exponent))
    arrays = {"embed": np.zeros((7, 64), np.float32),
              "units": {"u0_attn": {}}, "tail": {}}
    with pytest.raises(ValueError, match="keys"):
        convert.lm_params(pm, arrays, device="cpu")


def test_slot_prefill_logits_vs_reference(lm):
    jm, jeng, pm, peng = lm
    n, P = 37, 64
    toks = np.zeros((1, P), np.int32)
    toks[0, :n] = _tokens((n,), 1)
    want, _ = _ref_jit(jm.prefill)(jeng.params, jnp.asarray(toks),
                                  jm.cache_init(1, MAX_LEN),
                                  lengths=jnp.asarray([n], jnp.int32))
    got, cache = pm.prefill(peng.params, torch.from_numpy(toks),
                            pm.cache_init(1, MAX_LEN, "cpu"),
                            lengths=torch.tensor([n]))
    assert int(cache["index"][0]) == n
    # measured gap: 0 (bit-identical)
    _close(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy().argmax(-1),
                                  np.asarray(want).argmax(-1))


def test_eight_decode_steps_identical_tokens(lm):
    """A 37-token prompt and 8 decode steps over the 300-slot ring (three
    128-slot tiles, a padded last one)."""
    jm, jeng, pm, peng = lm
    prompt = _tokens((2, 37), 2)
    want = np.asarray(jeng.generate({"tokens": jnp.asarray(prompt)},
                                    max_new_tokens=9))
    got = peng.generate({"tokens": prompt}, max_new_tokens=9).numpy()
    np.testing.assert_array_equal(got, want)


def test_loss_at_640_tokens_vs_reference(lm):
    """640 tokens: 640^2 scores exceed 512^2, so every layer runs the
    online MXInt flash path over five 128-key tiles."""
    jm, jeng, pm, peng = lm
    toks = _tokens((1, 640), 3)
    want = float(_ref_jit(jm.loss)(jeng.params,
                                   {"tokens": jnp.asarray(toks)}))
    got = float(pm.loss(peng.params, {"tokens": torch.from_numpy(toks)}))
    # measured gap: 0 (bit-identical) for Llama, Mixtral and Granite-MoE;
    # the others see LOSS_TOL
    tol = LOSS_TOL[SMOKE_NAMES[pm.cfg.name]]
    assert abs(got - want) <= tol * abs(want), (got, want)


def test_loss_at_512_tokens_vs_reference(lm):
    """512 tokens: 512^2 scores fit the whole-row path, so every layer
    runs the causal-masked 'paper' attention through the softmax kernel."""
    jm, jeng, pm, peng = lm
    toks = _tokens((1, 512), 7)
    want = float(_ref_jit(jm.loss)(jeng.params,
                                   {"tokens": jnp.asarray(toks)}))
    got = float(pm.loss(peng.params, {"tokens": torch.from_numpy(toks)}))
    # measured gap: 0 (bit-identical) for Llama, Phi-4-mini, DeepSeek-67B,
    # Mixtral and Granite-MoE, 4.8e-7 (one ulp, 7.6e-8 relative) for Qwen3;
    # the logits are bit-identical
    tol = LOSS_TOL[SMOKE_NAMES[pm.cfg.name]]
    assert abs(got - want) <= tol * abs(want), (got, want)


def _serve(sched_cls, req_cls, engine, prompts, new_tokens):
    sched = sched_cls(engine, batch_size=2)
    for uid, (pr, n) in enumerate(zip(prompts, new_tokens)):
        sched.submit(req_cls(uid=uid, prompt=pr, max_new_tokens=n))
    done = sched.run()
    return {r.uid: list(r.generated) for r in done}


def test_batch_scheduler_tokens_equal_reference(lm):
    """5 requests through slot-level admission at batch 2: rows are
    refilled while the other row decodes."""
    jm, jeng, pm, peng = lm
    lens, new = [37, 12, 60, 9, 16], [4, 6, 3, 5, 7]    # buckets 64, 16
    prompts = [_tokens((n,), 10 + i) for i, n in enumerate(lens)]
    want = _serve(JBatchScheduler, JRequest, jeng, prompts, new)
    got = _serve(BatchScheduler, Request, peng, prompts, new)
    assert got == want
    assert [len(got[i]) for i in range(5)] == new


def test_wave_admission_and_eos(lm):
    """Wave admission (whole-batch drain) serves the same tokens as slot
    admission; an eos token ends its request at that token."""
    _, _, _, peng = lm
    prompts = [_tokens((n,), 20 + i) for i, n in enumerate([9, 30, 14])]
    got = {}
    for admission in ("slot", "wave"):
        sched = BatchScheduler(peng, batch_size=2, admission=admission)
        for uid, pr in enumerate(prompts):
            sched.submit(Request(uid=uid, prompt=pr, max_new_tokens=5))
        got[admission] = {r.uid: r.generated for r in sched.run()}
    assert got["wave"] == got["slot"]
    eos = got["slot"][1][2]
    sched = BatchScheduler(peng, batch_size=2, eos_id=eos)
    for uid, pr in enumerate(prompts):
        sched.submit(Request(uid=uid, prompt=pr, max_new_tokens=5))
    done = {r.uid: r.generated for r in sched.run()}
    assert done[1] == got["slot"][1][:got["slot"][1].index(eos) + 1]
    with pytest.raises(ValueError, match="prefill_len"):
        BatchScheduler(peng, batch_size=2, prefill_len=8).submit(
            Request(uid=9, prompt=prompts[1]))


def test_temperature_samples_with_the_engine_seed(lm):
    """temperature > 0 samples each decode step from the engine's seeded
    generator: one seed gives one sequence, another seed another, and
    both leave greedy decoding; the first token stays greedy."""
    _, _, pm, peng = lm
    prompt = _tokens((2, 20), 8)
    greedy = peng.generate({"tokens": prompt}, max_new_tokens=6)

    def sample(seed):
        eng = ServingEngine(pm, peng.params, ServeConfig(
            max_len=MAX_LEN, batch=2, temperature=1.0), device="cpu",
            seed=seed)
        return eng.generate({"tokens": prompt}, max_new_tokens=6)

    a, again, other = sample(0), sample(0), sample(1)
    assert torch.equal(a, again)
    assert not torch.equal(a, other)
    assert not torch.equal(a, greedy)
    assert torch.equal(a[:, 0], greedy[:, 0])
    assert bool(((a >= 0) & (a < VOCAB)).all())
    with pytest.raises(ValueError, match="generator"):
        make_decode_step(pm, temperature=0.5)


def test_window_ring_decode_vs_reference(lm):
    """window 64 < max_len: an 80-token prompt takes the SWA prefill
    scatter, then 8 decode steps wrap the 64-slot ring."""
    _, jeng0, _, peng0 = lm
    jm, pm = _models(SMOKE_NAMES[peng0.model.cfg.name], window=64)
    jeng = _ref_engine(jm, jeng0.params, batch=1, pack=False)
    peng = ServingEngine(pm, peng0.params, ServeConfig(max_len=MAX_LEN,
                                                       batch=1),
                         device="cpu")
    prompt = _tokens((1, 80), 4)
    ring = min(MAX_LEN, pm.cfg.local_attn_window or 64)
    for kind, c in zip(pm.kinds, pm.cache_init(1, MAX_LEN, "cpu")["layers"]):
        if kind == "attn":
            assert c["k"].shape == (1, ring, pm.cfg.n_kv_heads, pm.cfg.hd)
    want = np.asarray(jeng.generate({"tokens": jnp.asarray(prompt)},
                                    max_new_tokens=9))
    got = peng.generate({"tokens": prompt}, max_new_tokens=9).numpy()
    np.testing.assert_array_equal(got, want)


def test_kernel_launch_structure(monkeypatch, config):
    """Per decode step: 5 fused norm->linears, 2 linears, 1 SiLU and 1
    decode attention per layer, then the final RMSNorm; a slot prefill the
    same without attention kernels; a 640-token loss 1 flash attention per
    layer, a 512-token loss 1 whole-row softmax per layer instead.  With
    qk-norm (Qwen3) every layer adds 2 RMSNorms (q and k, per head) to
    each: at Qwen3-14B's 40 layers a decode step launches 11 x 40 + 1 =
    441 kernels and a slot prefill 10 x 40 + 1 = 401.  A MoE layer runs 3
    fused norm->linears (q, k, v), 2 linears (the attention's out and the
    router), the RMSNorm before the FFN, the gates' softmax and the
    experts' SiLU: as many launches as a dense layer, 289 a decode step and
    257 a slot prefill at Mixtral-8x7B's 32 layers.  The recurrent
    configs run their SMOKE stacks, held to ``lm_launches``: at full depth
    RecurrentGemma-2B launches 263 kernels a slot prefill and 271 a decode
    step, xLSTM-350M 580 a 64-token slot prefill (its 3 sLSTM layers 2 a
    token) and 202 a decode step."""
    names = tuple(ops.LAUNCH_COUNTERS)    # the launch fixture's too
    calls = dict.fromkeys(names, 0)
    for name in names:
        fn = getattr(ops, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(ops, name, counted)
    L = 3
    smoke = CONFIGS[config][1].SMOKE
    dense = smoke.unit == ("attn",)
    if dense:
        smoke = dataclasses.replace(smoke, n_layers=L, n_units=None)
    pm = DecoderLM(dataclasses.replace(smoke, quant=QuantConfig(**KERNEL)))
    pp = pm.init(1, device="cpu", pack_fmt=MXINT8_WEIGHT)
    eng = ServingEngine(pm, pp, ServeConfig(max_len=64, batch=2),
                        device="cpu")
    norms = 2 if smoke.qk_norm else 0
    moe = smoke.ffn_kind == "moe"
    per_layer = {"mxint_ln_matmul": (3 if moe else 5) * L,
                 "mxint_matmul": 2 * L, "mxint_gelu": L,
                 "mxint_layernorm": 1 + (norms + moe) * L,
                 "mxint_softmax": L if moe else 0, "launch_fixture": 0}

    def take():
        out = dict(calls)
        for k in calls:
            calls[k] = 0
        return out

    cache = pm.cache_init(2, 64, "cpu")
    eng._prefill_slot(eng.params, torch.from_numpy(_tokens((1, 16), 5)), 11,
                      1, cache)
    prefill = take()
    assert prefill == lm_launches(pm.cfg, 16)
    if not dense:
        eng._decode(eng.params, torch.zeros(2, 1, dtype=torch.int32), cache)
        assert take() == lm_launches(pm.cfg, 1, decode=True)
        # xLSTM takes whole 256-token mLSTM chunks: 640 would not do
        for n in (640, 512) if "attn" in pm.kinds else (512,):
            pm.loss(eng.params, {"tokens": _tokens((1, n), 6)})
            assert take() == lm_launches(pm.cfg, n, score=True)
        full = CONFIGS[config][1].FULL
        got = (sum(lm_launches(full, 64).values()),
               sum(lm_launches(full, 1, decode=True).values()))
        assert got == {"recurrentgemma_2b": (263, 271),
                       "xlstm_350m": (580, 202)}[config]
        return
    assert prefill == {**per_layer, "flash_attention": 0,
                       "flash_attention_decode": 0}
    assert sum(prefill.values()) == (8 + norms) * L + 1
    eng._decode(eng.params, torch.zeros(2, 1, dtype=torch.int32), cache)
    step = take()
    assert step == {**per_layer, "flash_attention": 0,
                    "flash_attention_decode": L} == \
        lm_launches(pm.cfg, 1, decode=True)
    assert sum(step.values()) == (9 + norms) * L + 1
    if smoke.qk_norm:               # the full config's counts, by the same
        full = qwen.FULL.n_layers   # per-layer structure
        assert ((9 + norms) * full + 1, (8 + norms) * full + 1) == (441, 401)
    if moe:
        full = mixtral.FULL.n_layers
        assert (9 * full + 1, 8 * full + 1) == (289, 257)
    pm.loss(eng.params, {"tokens": _tokens((1, 640), 6)})
    assert take() == {**per_layer, "flash_attention": L,
                      "flash_attention_decode": 0} == \
        lm_launches(pm.cfg, 640, score=True)
    pm.loss(eng.params, {"tokens": _tokens((1, 512), 6)})
    assert take() == {**per_layer,
                      "mxint_softmax": per_layer["mxint_softmax"] + L,
                      "flash_attention": 0, "flash_attention_decode": 0} == \
        lm_launches(pm.cfg, 512, score=True)


def test_init_packs_each_tensor_as_it_goes():
    pm = DecoderLM(dataclasses.replace(llama.SMOKE,
                                       quant=QuantConfig(**KERNEL)))
    packed = pm.init(3, device="cpu", pack_fmt=MXINT8_WEIGHT)
    plain = pm.init(3, device="cpu")
    again = pack_params_mxint(plain, MXINT8_WEIGHT)
    for name in ("embed", "unembed"):
        assert torch.equal(packed[name].value.mantissa,
                           again[name].value.mantissa)
    wi = packed["layers"][1]["ffn"]["wi"].value
    assert torch.equal(wi.mantissa, again["layers"][1]["ffn"]["wi"].value
                       .mantissa)
    # the SMOKE q projection stays float, as the reference's size rule says
    assert not hasattr(packed["layers"][0]["mix"]["wq"].value, "mantissa")


def test_entry_points_default_to_cuda():
    for fn in (ServingEngine.__init__, DecoderLM.init, DecoderLM.cache_init,
               EncDecLM.init, EncDecLM.cache_init, convert.lm_params,
               convert.encdec_params):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-device error is moot")
    pm = DecoderLM(dataclasses.replace(llama.SMOKE,
                                       quant=QuantConfig(**KERNEL)))
    with pytest.raises(RuntimeError, match="cuda"):
        ServingEngine(pm, pm.init(0, device="cpu"), ServeConfig(batch=2))


def per_config_cases(config: str, path: str) -> dict:
    """The cases of this file that run per config (they take the
    ``config`` or the ``lm`` fixture), for the file at ``path`` that runs
    ``config`` to collect; it must be that config's file."""
    assert CONFIG_FILES[config] == Path(path).name, (config, path)
    return {name: fn for name, fn in globals().items()
            if name.startswith("test_")
            and {"config", "lm"} & set(inspect.signature(fn).parameters)}
