"""Sharded serving and the pod-axis gradient path on gloo CPU ranks,
against the port's single-device engine and the reference.

One spawn of 4 ranks (``repro_torch.parallel.spawn``) runs every rank-side
task of ``repro_torch.serving.sharded_check`` on one process group: a
("data", "model") mesh of 2 x 2, its "model" rows (two tensor-parallel
meshes of 2, ranks 0-1 and 2-3) and its "data" columns, and a ("pod",
"model") mesh whose "pod" columns hold the pod-axis checks.  This process
computes the oracles: the port's single-device engine, the reference's
``mode='sim'`` logits (its own oracle, ``repro/serving/sharded_check.py``),
``repro.kernels.ref.mxint_matmul_ref`` and the reference's
``compress_leaf``, gradients and AdamW.

Model: DeiT-Tiny widths, 2 layers, 100 classes, MXInt6 planes, MXInt8
acts, batch 4, the reference's parameters converted.
"""
import dataclasses
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from repro.configs import deit as jdeit  # noqa: E402
from repro.configs import smoke_config  # noqa: E402
from repro.core import gradient_compression as jgc  # noqa: E402
from repro.core.mx_types import MXINT6_WEIGHT as J6  # noqa: E402
from repro.core.mx_types import QuantConfig as JQuantConfig  # noqa: E402
from repro.data import pipeline as jdata  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models.model_api import unwrap  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.serving.engine import pack_params_mxint as j_pack  # noqa: E402
from repro.train.state import make_train_state as j_train_state  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import deit, llama3_8b  # noqa: E402
from repro_torch.core.mx_types import MXINT6_WEIGHT, QuantConfig  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.launches import vit_launches  # noqa: E402
from repro_torch.models.model_api import tree_leaves  # noqa: E402
from repro_torch.models.vit import ViT  # noqa: E402
from repro_torch.parallel.spawn import spawn  # noqa: E402
from repro_torch.serving import sharded_check as SC  # noqa: E402
from repro_torch.serving.engine import pack_params_mxint  # noqa: E402

KERNEL = QuantConfig(mode="kernel", quantize_nonlinear=True)
BATCH = 4
TP_MESH = ((2, 2), ("data", "model"), "model")
DP_TP_MESH = ((2, 2), ("data", "model"), None)
DP_MESH = ((2, 2), ("data", "model"), "data")
POD_MESH = ((2, 2), ("pod", "model"), "pod")
LR = 1e-3
STREAM = (3, 1, 2)
# the row strategy against the single-device engine on the same planes,
# as a share of the logit scale (the two K halves summed apart, then
# added): sharded_check's ROW_TOL, 1e-3; measured 0 at this seed
ROW_TOL = SC.ROW_TOL
# the port's logits against the reference's sim oracle, as a share of the
# logit scale.  Measured 1.64e-2 (column, default planes; 0.0452 of 2.75)
# and 1.45e-2 (row, row-packed planes; 0.0404 of 2.79): images 0-2 are
# bit for bit, image 3 differs by one moved act-grid step, so
# test_torch_vit.py's 1e-3 (which holds on its two images, images 0-1
# here) does not hold on this batch.  The cause is the whole-row
# attention core's float products, which the port computes in float64
# and rounds once and the reference sums in float32: the sharded logits
# equal the single-device engine's bit for bit, that engine equals the
# port's own "sim" mode bit for bit, and that mode with its attention
# core routed through the reference's (``_ref_sim_attention``) equals the
# reference's sim logits bit for bit on all four images (tested below).
SIM_TOL = 2e-2


@pytest.fixture(scope="module", autouse=True)
def jax_reference():
    """Run the reference on this jax: alias the renamed Pallas compiler
    params and make ``jnp.exp2`` exact on integer-valued inputs; torch on
    one intra-op thread, as in every port test file."""
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
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    mp.undo()
    jax.clear_caches()


def _ref_jit(fn):
    return jax.jit(fn, compiler_options={"xla_backend_optimization_level": 0})


def _ref_sim_attention(mp):
    """Route the port's "sim" attention core (scores, softmax, P.V)
    through the reference's sim backend's ``attention``, jitted as the
    reference's steps are."""
    jq = JQuantConfig(mode="sim", quantize_nonlinear=True)

    def attention(self, qv, k, v, *, q, positions, causal, window, scale,
                  chunk):
        ref = _ref_jit(lambda *a: jq.datapath.attention(
            *a[:3], q=jq, positions=a[3], causal=causal, window=window,
            scale=scale, chunk=chunk))
        return torch.from_numpy(np.array(ref(*(
            jnp.asarray(t.detach().numpy()) for t in (qv, k, v, positions)))))

    mp.setattr(type(SC.SIM.datapath), "attention", attention)


@pytest.fixture(scope="module")
def case():
    """The inputs: DeiT-Tiny (the reference's sim model and parameters, the
    port's kernel-mode config and the converted parameters, 4 images) and
    the SMOKE Llama-3 (the reference's train state, the converted
    parameters, a 4 x 32 token batch)."""
    jcfg = dataclasses.replace(jdeit.DEIT_TINY, n_layers=2, n_classes=100,
                               quant=JQuantConfig(mode="sim",
                                                  quantize_nonlinear=True))
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.key(0))
    cfg = dataclasses.replace(deit.DEIT_TINY, n_layers=2, n_classes=100,
                              quant=KERNEL)
    pp = convert.vit_params(ViT(cfg), jax.tree_util.tree_map(
        np.asarray, unwrap(jp)), device="cpu")
    jlm = jbuild(smoke_config("llama3_8b"))
    jst = jax.jit(lambda k: j_train_state(jlm, k))(jax.random.key(0))
    pm = build_model(llama3_8b.SMOKE)
    batch = jdata.SyntheticLMData(vocab=512, batch=4, seq_len=32,
                                  seed=5).next_batch()
    return {"jm": jm, "jp": jp, "cfg": cfg, "params": pp,
            "images": SC.images(BATCH, 224, 0),
            "jlm": jlm, "jst": jst, "pm": pm,
            "lm_params": convert.lm_params(pm, jax.tree_util.tree_map(
                np.asarray, unwrap(jst.params)), device="cpu"),
            "batch": {k: np.asarray(v) for k, v in batch.items()}}


def _row_linear_inputs(params):
    """DeiT-Tiny's out-projection planes of layer 0, packed for 2 ranks
    (K 192, block 96), and 2 x 197 rows of activations."""
    packed = pack_params_mxint(params, MXINT6_WEIGHT, tp_shards=2)
    w = packed["blocks"]["attn"]["wo"].value.layer(0)
    x = np.random.default_rng(5).normal(size=(2 * 197, 192)).astype(
        np.float32)
    return x, w.mantissa.numpy(), w.exponent.numpy(), w.block_size


def _grad_inputs():
    rng = np.random.default_rng(6)
    shapes = [(37,), (5, 7), (64,)]
    grads = [[rng.normal(size=s).astype(np.float32) for s in shapes]
             for _ in range(2)]
    errs = [[(1e-3 * rng.normal(size=s)).astype(np.float32) for s in shapes]
            for _ in range(2)]
    return grads, errs


def _tasks(case):
    common = dict(cfg=case["cfg"], params=case["params"],
                  imgs=case["images"], batch=BATCH)
    x, mant, exp, block = _row_linear_inputs(case["params"])
    grads, errs = _grad_inputs()
    return [
        ("serve", TP_MESH, dict(common, strategy="column", stream=STREAM)),
        ("serve", TP_MESH, dict(common, strategy="row")),
        ("serve", DP_TP_MESH, dict(common, strategy="column")),
        ("serve", DP_MESH, dict(common, strategy="column")),
        ("row_linear", TP_MESH, dict(x=x, mant=mant, exp=exp, block=block)),
        ("compressed_psum", POD_MESH, dict(grads=grads, errs=errs)),
        ("pod_step", POD_MESH, dict(cfg=llama3_8b.SMOKE,
                                    params=case["lm_params"],
                                    batch=case["batch"], lr=LR)),
    ]


TASK_NAMES = ["column", "row", "dp_tp", "dp", "row_linear",
              "compressed_psum", "pod_step"]


def _pod_reference(case):
    """The reference's functions composed on one device for one pod step:
    each pod's loss and gradients of its half of the batch, their
    ``compress_leaf`` (zero residuals), the payloads summed in rank order
    and halved, its AdamW.  Returns (the pods' mean loss, the new
    parameters, each pod's residuals and its payloads' scale), the trees
    as the port's leaves."""
    jm, jst, pm, batch = case["jlm"], case["jst"], case["pm"], case["batch"]
    grad_fn = _ref_jit(jax.value_and_grad(
        lambda p, b: jm.loss(p, b).astype(jnp.float32)))
    losses, payloads, residuals, scales = [], [], [], []
    for p in range(2):
        half = {k: v[2 * p:2 * p + 2] for k, v in batch.items()}
        loss, g = grad_fn(jst.params, half)
        losses.append(float(loss))
        leaves, treedef = jax.tree_util.tree_flatten(g)
        deq, res = [], []
        for x in leaves:
            _, d, r, _ = jgc.compress_leaf(x)
            deq.append(d[:x.size].reshape(x.shape))
            res.append(r[:x.size].reshape(x.shape))
        payloads.append(deq)
        scales.append(max(float(jnp.abs(d).max()) for d in deq))
        residuals.append(jax.tree_util.tree_unflatten(treedef, res))
    grads = jax.tree_util.tree_unflatten(treedef, [
        (a + b) / 2 for a, b in zip(*payloads)])
    new_params, _, _ = jadamw.adamw_update(
        grads, jst.opt, jst.params, jnp.asarray(LR, jnp.float32),
        jadamw.AdamWConfig())

    def port_leaves(tree):
        return [p.value.numpy() for p in tree_leaves(convert.lm_params(
            pm, jax.tree_util.tree_map(np.asarray, unwrap(tree)),
            device="cpu"))]

    return ((losses[0] + losses[1]) / 2, port_leaves(new_params),
            [port_leaves(r) for r in residuals], scales)


@pytest.fixture(scope="module")
def results(case):
    """The one spawn of 4 ranks (every rank's task results, by task name),
    and meanwhile, in this process, the oracles."""
    box = {}

    def run():
        try:
            box["ranks"] = spawn(SC.run_tasks, 4, (_tasks(case),),
                                 device="cpu")
        except BaseException as e:          # re-raised below
            box["error"] = e

    thread = threading.Thread(target=run)
    thread.start()
    try:
        sim = _ref_jit(case["jm"].logits)
        imgs, cfg, pp = case["images"], case["cfg"], case["params"]
        row_planes = pack_params_mxint(pp, MXINT6_WEIGHT, tp_shards=2)
        oracles = {
            "ref_sim": np.asarray(sim(case["jp"], jnp.asarray(imgs))),
            "ref_sim_row": np.asarray(sim(j_pack(case["jp"], J6, tp_shards=2),
                                          jnp.asarray(imgs))),
            "single": SC.single_device_logits(cfg, pp, imgs, BATCH, "cpu"),
            "single_row": SC.single_device_logits(cfg, row_planes, imgs,
                                                  BATCH, "cpu"),
            "pod": _pod_reference(case)}
        port_sim = ViT(dataclasses.replace(cfg, quant=SC.SIM))

        def sim_logits(params):
            return port_sim.logits(params, torch.from_numpy(imgs)).detach() \
                .numpy()

        oracles["port_sim"] = sim_logits(pp)
        oracles["port_sim_row"] = sim_logits(row_planes)
        with pytest.MonkeyPatch.context() as mp:
            _ref_sim_attention(mp)
            oracles["port_sim_ref_attention"] = sim_logits(pp)
            oracles["port_sim_row_ref_attention"] = sim_logits(row_planes)
    finally:
        thread.join()
    if "error" in box:
        raise box["error"]
    out = box["ranks"]
    return {**{n: [r[i] for r in out] for i, n in enumerate(TASK_NAMES)},
            **oracles}


def _gap(got, want):
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
def test_column_sharded_bit_for_bit(results):
    """Column sharding over 2 ranks (on both tensor-parallel meshes)
    equals the port's single-device engine bit for bit, and holds the
    reference's sim oracle to ``SIM_TOL`` with argmax equal.  The
    witness that the gap is the attention core's float products: the
    single-device engine equals the port's "sim" mode bit for bit, and
    that mode with the reference's attention core equals the oracle bit
    for bit."""
    for r in results["column"]:
        assert r["tp"] == 2 and r["dp"] == 1
        np.testing.assert_array_equal(r["logits"], results["single"])
    want = results["ref_sim"]
    got = results["column"][0]["logits"]
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    assert _gap(got, want) <= SIM_TOL
    np.testing.assert_array_equal(results["port_sim"], results["single"])
    np.testing.assert_array_equal(results["port_sim_ref_attention"], want)


def test_data_axis_bit_for_bit(results):
    """dp 2 x tp 2 on 4 ranks, and the data-only mesh (planes whole),
    equal the single-device engine bit for bit on every rank."""
    for name, dp, tp in (("dp_tp", 2, 2), ("dp", 2, 1)):
        for r in results[name]:
            assert (r["dp"], r["tp"]) == (dp, tp)
            np.testing.assert_array_equal(r["logits"], results["single"])


def test_row_sharded_within_tolerance(results):
    """The row strategy (out-projection and FFN ``wo`` K-sharded, packed
    with their blocks clamped to the per-rank K) against the
    single-device engine on the same planes, within ``ROW_TOL``, and the
    reference's sim logits on its own row-packed planes, within
    ``SIM_TOL``, argmax equal to both, with the column strategy's
    witness on the row-packed planes.  Its planes are another
    quantization than the default ones, so it is not held to those."""
    got = results["row"][0]["logits"]
    np.testing.assert_array_equal(results["row"][1]["logits"], got)
    for want, tol in ((results["single_row"], ROW_TOL),
                      (results["ref_sim_row"], SIM_TOL)):
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
        assert _gap(got, want) <= tol
    np.testing.assert_array_equal(results["port_sim_row"],
                                  results["single_row"])
    np.testing.assert_array_equal(results["port_sim_row_ref_attention"],
                                  results["ref_sim_row"])


def test_row_linear_is_the_sum_of_the_two_k_slices(results, case):
    """One row-sharded linear (DeiT-Tiny's out-projection, K 192 at block
    96) equals, bit for bit, the reference's plain matmul of each rank's K
    slice, the two added in rank order."""
    x, mant, exp, block = _row_linear_inputs(case["params"])
    k, kb = mant.shape[0] // 2, exp.shape[0] // 2
    parts = [np.asarray(jref.mxint_matmul_ref(
        jnp.asarray(x[:, r * k:(r + 1) * k]),
        jnp.asarray(mant[r * k:(r + 1) * k]),
        jnp.asarray(exp[r * kb:(r + 1) * kb]), w_block=block, act_block=16,
        act_mant_bits=8, quantize_act=True)) for r in range(2)]
    want = parts[0] + parts[1]
    for r in results["row_linear"]:
        np.testing.assert_array_equal(r, want)


def test_scheduler_stream_and_launches_per_rank(results, case):
    """A mixed stream of 3 requests (6 images, batch 4) through
    ``ClassifyScheduler`` on the column engine: every request classified,
    every step's kernel calls on each rank equal to ``vit_launches``, and
    its launches by the kernels' counters 0 (on the CPU nothing
    launches); one forward's calls under each strategy too.  A column
    forward gathers after
    each of its 2 + 6 L linears; a row forward all-reduces after the 2 L
    K-sharded ones and gathers nothing."""
    cfg = case["cfg"]
    for name in ("column", "row"):
        want = vit_launches(cfg, name, 2)
        for r in results[name]:
            assert r["calls_per_forward"] == want
    L = cfg.n_layers
    assert results["column"][0]["collectives_per_forward"] == {
        "all_gather": 2 + 6 * L, "all_reduce": 0}
    assert results["row"][0]["collectives_per_forward"] == {
        "all_gather": 0, "all_reduce": 2 * L}
    for r in results["column"]:
        s = r["stream"]
        assert s["all_classified"] and s["requests"] == len(STREAM)
        assert s["images"] == sum(STREAM)
        assert len(s["calls_per_step"]) == -(-sum(STREAM) // BATCH)
        assert all(c == vit_launches(cfg) for c in s["calls_per_step"])
        # the kernels' counters move only where a kernel launches
        assert len(s["launches_per_step"]) == len(s["calls_per_step"])
        assert not any(any(c.values()) for c in s["launches_per_step"])


# ---------------------------------------------------------------------------
# the pod-axis gradient path
# ---------------------------------------------------------------------------
def test_compressed_psum_equals_reference(results):
    """``compressed_psum`` on 2 ranks: the reference's ``compress_leaf`` of
    each rank's gradient plus residual, the dequantized payloads summed in
    rank order, bit for bit; each rank's new residual equal to the
    reference's."""
    grads, errs = _grad_inputs()
    out = results["compressed_psum"]
    pod_ranks = (out[0], out[2])        # ranks 0 and 2 form a "pod" group
    for leaf in range(len(grads[0])):
        deqs, residuals = [], []
        for p in range(2):
            g = jnp.asarray(grads[p][leaf]) + jnp.asarray(errs[p][leaf])
            _, deq, res, _ = jgc.compress_leaf(g)
            deqs.append(np.asarray(deq)[:g.size].reshape(g.shape))
            residuals.append(np.asarray(res)[:g.size].reshape(g.shape))
        want = deqs[0] + deqs[1]
        for p, (red, new) in enumerate(pod_ranks):
            np.testing.assert_array_equal(red[leaf], want)
            np.testing.assert_array_equal(new[leaf], residuals[p])


def test_pod_step_equals_reference_composition(results):
    """One "off" step of the SMOKE Llama-3 over a ("pod",) mesh of 2 with
    ``grad_compression=True`` against ``_pod_reference``: the loss (the
    pods' mean) within 1e-6 relative; both pods' new parameters identical
    and within ``POD_PARAM_TOL`` of the reference's scale; each pod's
    residuals within ``GRAD_GAP`` of its payloads' scale but where
    ``compress_leaf`` rounded a gradient to the other side of a grid
    point, there by at most one grid step (2^-6 of the scale) and at no
    more than ``POD_FLIP_SHARE`` of the elements; the residuals nonzero."""
    want_loss, want_params, want_err, scales = results["pod"]
    out = results["pod_step"]
    pods = (out[0], out[2])             # pod 0 (rank 0), pod 1 (rank 2)
    for r in pods:
        assert abs(r["metrics"][0]["loss"] - want_loss) <= 1e-6 * want_loss
    for a, b in zip(pods[0]["params"], pods[1]["params"]):
        np.testing.assert_array_equal(a, b)
    assert max(_gap(g, w) for g, w in zip(pods[0]["params"], want_params)) \
        <= POD_PARAM_TOL
    for r, want, scale in zip(pods, want_err, scales):
        gaps = [np.abs(g - w) / scale for g, w in zip(r["err"], want)]
        assert max(float(d.max()) for d in gaps) <= 2.0 ** -6
        flips = sum(int((d > GRAD_GAP).sum()) for d in gaps)
        assert flips <= POD_FLIP_SHARE * sum(d.size for d in gaps)
        assert any(np.abs(e).max() > 0 for e in r["err"])


# the port's gradients are within 1.5e-6 of the reference's scale
# (test_torch_train_step.py); after compress_leaf the residuals carry that
# gap, and where it moves a value across a rounding boundary of the MXInt
# grid, one grid step.  Measured: the parameters 7.1e-7 of their scale;
# the residuals 1.6e-6 (pod 1) and one step, 2.6e-3 (pod 0).
GRAD_GAP = 1e-5
POD_PARAM_TOL = 1e-5
POD_FLIP_SHARE = 1e-3
