"""The port's training stack against the reference's, on the CPU.

AdamW and the schedules, the LM, seq2seq and image streams and the
gradient codec against the reference from the same numpy seeds; then the
port's own contracts: microbatches, the modes that carry no gradient,
the score path without autograd, checkpoints, the loop and an exact
crash-and-resume.  One train step against the reference's is in
``tests/test_torch_train_step.py``.

The reference runs under the two scoped fixes of the other port tests
(the ``TPUCompilerParams`` alias and an exact ``exp2`` on integer
inputs), its steps jitted at ``xla_backend_optimization_level`` 0, where
they round as its op-by-op run does.  Each test states its tolerance and
the gap it measured.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from repro.core import gradient_compression as jgc  # noqa: E402
from repro.data import pipeline as jdata  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
from repro_torch.configs import deit, llama3_8b, mixtral_8x7b  # noqa: E402
from repro_torch.core import gradient_compression as gc  # noqa: E402
from repro_torch.core.mx_types import (MXINT6_WEIGHT,  # noqa: E402
                                       QuantConfig, QuantOverride)
from repro_torch.data import pipeline as data  # noqa: E402
from repro_torch.models.model_api import (Param, tree_leaves,  # noqa: E402
                                          tree_unflatten)
from repro_torch.models.transformer import DecoderLM  # noqa: E402
from repro_torch.models.vit import ViT  # noqa: E402
from repro_torch.optim import adamw, schedules  # noqa: E402
from repro_torch.serving.engine import pack_params_mxint  # noqa: E402
from repro_torch.train import (abstract_train_state,  # noqa: E402
                               make_eval_step, make_train_state,
                               make_train_step)
from repro_torch.train.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.train.loop import LoopConfig, TrainLoop  # noqa: E402

LR = 1e-3


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


def _ref_jit(fn):
    return jax.jit(fn, compiler_options={"xla_backend_optimization_level": 0})


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _rel_gap(got, want):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    scale = float(np.abs(want).max())
    return float(np.abs(got - want).max()) / (scale if scale else 1.0)


# ---------------------------------------------------------------------------
# optimizer and schedules
# ---------------------------------------------------------------------------
def _random_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(6, 5)).astype(np.float32),
            "b": {"x": rng.normal(size=(7,)).astype(np.float32),
                  "y": (3 * rng.normal(size=(2, 3, 4))).astype(np.float32)}}


def _port_tree(tree):
    if isinstance(tree, dict):
        return {k: _port_tree(v) for k, v in tree.items()}
    return Param(torch.from_numpy(tree.copy()), (None,) * tree.ndim)


@pytest.mark.parametrize("clip", [1.0, 0.0])
@pytest.mark.parametrize("n_updates", [1, 10])
def test_adamw_against_reference(clip, n_updates):
    """Random trees, random gradients each update; clipping on (the
    gradients' norm is 14.6-17.6, so it clips) and off.  Tolerance 2e-6
    of each leaf's scale, 1e-6 for the norm; measured: params and moments
    bit-identical after 1 update and without clipping; after 10 clipped
    updates the params bit-identical, the moments within 2.8e-7 and the
    norms within 1.2e-7 (each leaf's float32 sum of squares runs in
    another order, so the clip scale moves by an ulp)."""
    cfg = adamw.AdamWConfig(clip_norm=clip)
    jcfg = jadamw.AdamWConfig(clip_norm=clip)
    params = _random_tree(0)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jst = jadamw.adamw_init(jp)
    pp = _port_tree(params)
    st = adamw.adamw_init(pp)
    for i in range(n_updates):
        g = _random_tree(100 + i)
        jp, jst, jnorm = jadamw.adamw_update(
            jax.tree_util.tree_map(jnp.asarray, g), jst, jp,
            jnp.asarray(LR, jnp.float32), jcfg)
        pp, st, norm = adamw.adamw_update(_port_tree(g), st, pp,
                                          torch.tensor(LR), cfg)
        assert _rel_gap(norm, jnorm) <= 1e-6
    assert int(st.step) == int(jst.step) == n_updates
    for got, want in ((pp, jp), (st.mu, jst.mu), (st.nu, jst.nu)):
        for g_leaf, w_leaf in zip(tree_leaves(got),
                                  jax.tree_util.tree_leaves(want)):
            assert g_leaf.value.dtype == torch.float32
            assert _rel_gap(g_leaf.value, w_leaf) <= 2e-6


def test_adamw_keeps_float32_moments_and_param_dtype():
    pp = {"w": Param(torch.ones(4, dtype=torch.bfloat16).requires_grad_(),
                     ("embed",))}
    st = adamw.adamw_init(pp)
    assert st.mu["w"].value.dtype == torch.float32
    assert st.mu["w"].axes == ("embed",)
    g = {"w": Param(torch.full((4,), 1e6, dtype=torch.bfloat16), ("embed",))}
    new, st2, norm = adamw.adamw_update(g, st, pp, torch.tensor(1e-3),
                                        adamw.AdamWConfig(clip_norm=1.0))
    assert float(norm) > 1e5                       # the pre-clip norm
    assert new["w"].value.dtype == torch.bfloat16
    assert new["w"].value.requires_grad and new["w"].value.is_leaf
    assert int(st2.step) == 1 and int(st.step) == 0   # nothing mutated


def test_adamw_quadratic_convergence():
    params = {"w": Param(torch.tensor([3.0, -2.0]), (None,))}
    state = adamw.adamw_init(params)
    cfg = adamw.AdamWConfig(weight_decay=0.0, clip_norm=0.0)
    for _ in range(300):
        g = {"w": Param(2 * params["w"].value, (None,))}
        params, state, _ = adamw.adamw_update(g, state, params,
                                              torch.tensor(0.05), cfg)
    assert float(params["w"].value.abs().max()) < 0.05


def test_schedules_against_reference():
    """Every third step of the three schedules; tolerance 1e-6 relative
    for the cosine (torch's and XLA's cos may differ), measured 0: all
    three are bit-identical."""
    for s in range(0, 120, 3):
        js = jnp.asarray(s, jnp.int32)
        ts = torch.tensor(s, dtype=torch.int32)
        assert float(schedules.linear_warmup(ts, 10, 0.5)) == \
            float(jsched.linear_warmup(js, 10, 0.5))
        want = float(jsched.cosine_schedule(js, peak=1.0, warmup_steps=10,
                                            total_steps=100, floor=0.1))
        got = float(schedules.cosine_schedule(ts, peak=1.0, warmup_steps=10,
                                              total_steps=100, floor=0.1))
        assert abs(got - want) <= 1e-6 * abs(want)
        assert float(schedules.constant_schedule(ts, 3e-4)) == \
            float(jsched.constant_schedule(js, 3e-4))
    lrs = [float(schedules.cosine_schedule(s, peak=1.0, warmup_steps=10,
                                           total_steps=100))
           for s in range(0, 100, 10)]
    assert lrs[0] < lrs[1] and lrs[-1] < lrs[2]


# ---------------------------------------------------------------------------
# data streams
# ---------------------------------------------------------------------------
def _same_batches(got, want):
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        g = got[k].numpy()
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("shard", [(0, 1), (0, 2), (1, 2)])
def test_lm_stream_equals_reference(shard):
    """Bit for bit, sharded, seeked, with and without vision embeddings."""
    idx, n = shard
    for vis in ((0, 0), (3, 8)):
        kw = dict(vocab=97, batch=8, seq_len=12, seed=7, shard_index=idx,
                  num_shards=n, vision_tokens=vis[0], vision_dim=vis[1])
        ref = jdata.SyntheticLMData(**kw)
        got = data.SyntheticLMData(device="cpu", **kw)
        for _ in range(2):
            _same_batches(got.next_batch(), ref.next_batch())
        got.state.next_index = ref.state.next_index = 5
        _same_batches(got.next_batch(), ref.next_batch())
        _same_batches(got.batch_at(1), ref.batch_at(1))
        assert got.state.to_dict() == {"seed": 7, "next_index": 6}


def test_seq2seq_and_image_streams_equal_reference():
    for shard in ((0, 1), (1, 2)):
        kw = dict(vocab=50, batch=4, seq_len=8, d_model=16, seed=3,
                  shard_index=shard[0], num_shards=shard[1])
        ref, got = jdata.SyntheticSeq2SeqData(**kw), \
            data.SyntheticSeq2SeqData(device="cpu", **kw)
        for _ in range(2):
            _same_batches(got.next_batch(), ref.next_batch())
    kw = dict(n_classes=100, batch=6, image_size=32, seed=0, noise=1.0,
              class_sep=0.25)
    ref, got = jdata.SyntheticImageData(**kw), \
        data.SyntheticImageData(device="cpu", **kw)
    for _ in range(2):
        _same_batches(got.next_batch(), ref.next_batch())


def test_lm_stream_is_learnable():
    """Bigram structure: successor counts far below the vocabulary."""
    toks = data.SyntheticLMData(vocab=64, batch=32, seq_len=64, seed=3,
                                device="cpu").next_batch()["tokens"].numpy()
    pairs = {}
    for row in toks:
        for a, b in zip(row[:-1], row[1:]):
            pairs.setdefault(int(a), []).append(int(b))
    assert np.mean([len(set(v)) for v in pairs.values() if len(v) >= 4]) < 16


def test_streams_default_to_cuda():
    import inspect
    for cls in (data.SyntheticLMData, data.SyntheticSeq2SeqData,
                data.SyntheticImageData):
        assert inspect.signature(cls.__init__).parameters[
            "device"].default == "cuda"


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(64,), (5, 7), (3, 32, 4), (1,)])
def test_compress_leaf_equals_reference(shape):
    """Bit for bit: mantissas, exponents, dequantized values, residual and
    padding, including a leaf padded to whole blocks and a zero block."""
    g = np.random.default_rng(1).normal(size=shape).astype(np.float32) * 3
    if g.size >= 64:
        g.reshape(-1)[32:64] = 0.0
    jmx, jdeq, jres, jpad = jgc.compress_leaf(jnp.asarray(g))
    mx, deq, res, pad = gc.compress_leaf(torch.from_numpy(g))
    assert pad == jpad
    np.testing.assert_array_equal(mx.mantissa.numpy(),
                                  np.asarray(jmx.mantissa))
    np.testing.assert_array_equal(mx.exponent.numpy(),
                                  np.asarray(jmx.exponent))
    np.testing.assert_array_equal(deq.numpy(), np.asarray(jdeq))
    np.testing.assert_array_equal(res.numpy(), np.asarray(jres))


def test_compression_error_feedback_converges():
    """EF-SGD on a quadratic: with the residual fed back, compressed
    gradient steps still converge (the reference's own test)."""
    w = torch.from_numpy(np.random.default_rng(0).normal(size=(64,))
                         .astype(np.float32))
    target = torch.ones(64)
    err = gc.init_error_state({"w": Param(torch.zeros(64), (None,))})
    e = err["w"].value
    for _ in range(200):
        g = 2 * (w - target)
        _, deq, e, _ = gc.compress_leaf(g + e)
        w = w - 0.05 * deq
    assert float((w - target).abs().max()) < 0.05
    assert gc.compression_ratio() == jgc.compression_ratio() > 3.5


@pytest.mark.parametrize("n_micro", [2, 4])
def test_microbatches_against_one_batch(n_micro):
    """Accumulating n equal slices gives the whole batch's mean loss and
    gradients (the loss is a mean over the batch); tolerance 1e-5 of the
    scale; measured: the loss and grad norm bit-identical, the first
    moments within 1.7e-7 (float32 sums in another order)."""
    pm = ViT(deit.DEIT_MICRO)
    st = make_train_state(pm, 0, "cpu")
    b = data.SyntheticImageData(n_classes=10, batch=8, image_size=32,
                                seed=2, device="cpu").next_batch()
    one = make_train_step(pm, lr_fn=lambda s: torch.tensor(LR))
    many = make_train_step(pm, lr_fn=lambda s: torch.tensor(LR),
                           microbatches=n_micro)
    s1, m1 = one(st, b)
    s2, m2 = many(st, b)
    assert abs(float(m1["loss"]) - float(m2["loss"])) <= \
        1e-5 * abs(float(m1["loss"]))
    assert _rel_gap(m2["grad_norm"], m1["grad_norm"]) <= 1e-5
    for a, c in zip(tree_leaves(s1.opt.mu), tree_leaves(s2.opt.mu)):
        assert _rel_gap(c.value, a.value) <= 1e-5


def test_train_step_refuses_kernel_mode_and_packed_planes():
    kernel = ViT(dataclasses.replace(deit.DEIT_MICRO, quant=QuantConfig(
        mode="kernel", quantize_nonlinear=True)))
    with pytest.raises(ValueError, match="kernel"):
        make_train_step(kernel, lr_fn=lambda s: torch.tensor(LR))
    mixed = ViT(dataclasses.replace(deit.DEIT_MICRO, quant=QuantConfig(
        mode="off", overrides=(("block/*/ffn",
                                QuantOverride(mode="kernel")),))))
    with pytest.raises(ValueError, match="kernel"):
        make_train_step(mixed, lr_fn=lambda s: torch.tensor(LR))
    pm = ViT(dataclasses.replace(deit.DEIT_MICRO, quant=QuantConfig(
        mode="sim", quantize_nonlinear=True)))
    st = make_train_state(pm, 0, "cpu")
    packed = st._replace(params=pack_params_mxint(st.params, MXINT6_WEIGHT))
    step = make_train_step(pm, lr_fn=lambda s: torch.tensor(LR))
    b = data.SyntheticImageData(n_classes=10, batch=2, image_size=32,
                                seed=0, device="cpu").next_batch()
    calls = []
    orig = pm.logits
    pm.logits = lambda *a, **k: calls.append(1) or orig(*a, **k)
    with pytest.raises(ValueError, match="packed"):
        step(packed, b)
    assert not calls                             # raised before a forward
    # a pod mesh takes the compressed pod-axis reduction (run on gloo
    # ranks in test_torch_tp.py); it needs the state's error feedback
    pod = make_train_step(pm, lr_fn=lambda s: LR, grad_compression=True,
                          mesh=type("Mesh", (), {"axis_names": ("pod",)})())
    with pytest.raises(ValueError, match="error state"):
        pod(st, b)
    # without a pod mesh compression is off, as in the reference
    make_train_step(pm, lr_fn=lambda s: LR, grad_compression=True)


def test_lm_loss_with_and_without_autograd_equal():
    """The score path (no_grad) and the training path give the same loss
    bit for bit, and only the latter builds a graph."""
    pm = DecoderLM(mixtral_8x7b.SMOKE)
    st = make_train_state(pm, 0, "cpu")
    b = {"tokens": torch.from_numpy(np.random.default_rng(0).integers(
        0, 512, size=(2, 24)).astype(np.int32))}
    with torch.no_grad():
        scored = pm.loss(st.params, b)
    trained = pm.loss(st.params, b)
    assert not scored.requires_grad and trained.requires_grad
    assert scored.item() == trained.item()
    assert make_eval_step(pm)(st.params, b).item() == scored.item()


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
def _lm_state(seed=0):
    pm = DecoderLM(llama3_8b.SMOKE)
    return pm, make_train_state(pm, seed, "cpu")


def _leaves_equal(a, b):
    from repro_torch.train.checkpoint import _flatten
    fa, fb = _flatten(a), _flatten(b)
    assert [p for p, _, _ in fa] == [p for p, _, _ in fb]
    for (_, x, _), (_, y, _) in zip(fa, fb):
        assert x.dtype == y.dtype and torch.equal(x.detach(), y.detach())


def test_checkpoint_round_trip(tmp_path):
    pm, st = _lm_state()
    st, _ = make_train_step(pm, lr_fn=lambda s: torch.tensor(LR))(
        st, data.SyntheticLMData(vocab=512, batch=2, seq_len=8, seed=1,
                                 device="cpu").next_batch())
    mgr = CheckpointManager(str(tmp_path), keep_last=2)
    mgr.save(3, st, extra={"data_state": {"seed": 1, "next_index": 42}})
    restored, extra = mgr.restore(st)
    assert extra["data_state"]["next_index"] == 42
    _leaves_equal(restored, st)
    assert restored.params["layers"][1]["mix"]["wq"].axes == \
        ("embed", "q_heads")
    leaf = restored.params["embed"].value
    assert leaf.requires_grad and leaf.is_leaf
    assert not restored.opt.mu["embed"].value.requires_grad
    manifest = json.loads((tmp_path / "step_000003" /
                           "manifest.json").read_text())
    assert (tmp_path / "LATEST").read_text() == "3"
    assert {l["dtype"] for l in manifest["leaves"]} == {"float32", "int32"}
    assert manifest["leaves"][0]["axes"] is not None
    # the meta-device state is a restore target that allocates nothing
    like = abstract_train_state(pm)
    assert all(p.value.is_meta for p in tree_leaves(like.params))
    again, _ = mgr.restore(like, device="cpu")
    _leaves_equal(again, st)


def test_checkpoint_atomic_commit_ignores_tmp(tmp_path):
    pm, st = _lm_state()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, st)
    crash = tmp_path / "step_000002.tmp"        # a crashed writer
    crash.mkdir()
    (crash / "manifest.json").write_text("{corrupt")
    assert mgr.latest_step() == 1
    restored, _ = mgr.restore(st)
    assert int(restored.step) == int(st.step)
    mgr.save(2, st)                              # replaces the stale tmp
    assert mgr.latest_step() == 2 and not crash.exists()


def test_checkpoint_retention(tmp_path):
    pm, st = _lm_state()
    mgr = CheckpointManager(str(tmp_path), keep_last=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, st)
    steps = sorted(p.name for p in tmp_path.iterdir()
                   if p.name.startswith("step_"))
    assert steps == ["step_000003", "step_000004"]


def test_checkpoint_restores_into_another_dtype(tmp_path):
    """The elastic cast: float32 leaves restored as bf16 (round to
    nearest even, as numpy's cast in the reference)."""
    pm, st = _lm_state()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, st)
    from repro_torch.train.checkpoint import _flatten, _rebuild
    like = _rebuild(st, {p: torch.empty(
        x.shape, device="meta",
        dtype=torch.bfloat16 if x.dtype == torch.float32 else x.dtype)
        for p, x, _ in _flatten(st)})
    restored, _ = mgr.restore(like, device="cpu")
    got = restored.params["embed"].value
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, st.params["embed"].value.detach().to(
        torch.bfloat16))


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------
def _loop(tmp_path, total, state=None, seed=5):
    pm = DecoderLM(llama3_8b.SMOKE)
    state = state or make_train_state(pm, 0, "cpu")
    d = data.SyntheticLMData(vocab=512, batch=4, seq_len=16, seed=seed,
                             device="cpu")
    step = make_train_step(pm, lr_fn=lambda s: torch.tensor(LR))
    cfg = LoopConfig(total_steps=total, checkpoint_every=2, log_every=1,
                     checkpoint_dir=str(tmp_path / "ck"),
                     metrics_path=str(tmp_path / "metrics.jsonl"),
                     heartbeat_path=str(tmp_path / "hb.json"))
    return pm, d, TrainLoop(train_step=step, state=state, data=d, cfg=cfg)


def test_loop_loss_decreases(tmp_path):
    """The reference's check: 60 steps of the SMOKE Llama-3 at lr 3e-3,
    batch 8 x 32, the last five losses 0.1 below the first five."""
    pm = DecoderLM(llama3_8b.SMOKE)
    loop = TrainLoop(
        train_step=make_train_step(pm, lr_fn=lambda s: torch.tensor(3e-3)),
        state=make_train_state(pm, 0, "cpu"),
        data=data.SyntheticLMData(vocab=512, batch=8, seq_len=32, seed=5,
                                  device="cpu"),
        cfg=LoopConfig(total_steps=60, checkpoint_every=1000, log_every=1,
                       checkpoint_dir=str(tmp_path / "ck")))
    metrics = loop.run(start_step=0)
    first = np.mean([m["loss"] for m in metrics[:5]])
    last = np.mean([m["loss"] for m in metrics[-5:]])
    assert last < first - 0.1, (first, last)
    assert metrics[-1]["telemetry"]["histograms"]["span/train/step/ms"][
        "count"] >= 60


def test_crash_and_resume_equals_straight_run(tmp_path):
    """4 steps, a "crash", a fresh loop resumed from the step-4
    checkpoint for 2 more: params, moments, step and data position equal
    a straight 6-step run's bit for bit."""
    _, d1, straight = _loop(tmp_path / "a", total=6)
    straight.run()
    _, _, first = _loop(tmp_path / "b", total=4)
    first.run()
    _, d2, resumed = _loop(tmp_path / "b", total=6)
    assert resumed.try_resume() == 4
    assert d2.state.next_index == 4
    assert int(resumed.state.step) == 4
    resumed.run(start_step=4)
    _leaves_equal(resumed.state, straight.state)
    assert d2.state.next_index == d1.state.next_index == 6
    hb = json.loads((tmp_path / "b" / "hb.json").read_text())
    assert hb["step"] == 6
    lines = (tmp_path / "b" / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(l)["step"] for l in lines] == [1, 2, 3, 4, 5, 6]
    assert [m["loss"] for m in resumed.metrics] == \
        [m["loss"] for m in straight.metrics[4:]]


def test_loop_flags_stragglers(tmp_path):
    """A step slower than straggler_factor x the EMA is logged as one."""
    _, _, loop = _loop(tmp_path, total=6)
    loop.cfg.log_every = 100
    inner = loop.step_fn
    n = [0]

    def slow(state, batch):
        n[0] += 1
        if n[0] == 5:                      # 4x the EMA on top of the step
            import time as _t
            _t.sleep(4 * loop._ema_step_time + 0.2)
        return inner(state, batch)
    loop.step_fn = slow
    metrics = loop.run(start_step=0)
    assert [m["step"] for m in metrics if m["straggler"]] == [5]


def test_tree_unflatten_round_trip():
    tree = {"b": [1, {"z": 2, "a": 3}], "a": 4}
    assert tree_leaves(tree) == [4, 1, 3, 2]
    assert tree_unflatten(tree, tree_leaves(tree)) == tree
    with pytest.raises(ValueError):
        tree_unflatten(tree, [1, 2, 3, 4, 5])
