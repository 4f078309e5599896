"""The port's sharding rules and tensor-parallel packing against
``repro.parallel.sharding`` and ``repro.serving.engine``, in one process.

``logical_to_pspec`` gives the reference's ``PartitionSpec`` entries for
every leaf of every SMOKE config's axes tree, on the (data 2, model 2)
and (pod 2, data 2, model 2) mesh shapes, with and without ``shape=``:
the rules read only axis names and sizes, so no JAX devices are needed.
``_tp_decision`` and ``pack_params_mxint(tp_shards=)`` give the
reference's decisions and planes bit for bit on DeiT-Tiny weights.  The
sharded engines themselves run on gloo ranks in ``test_torch_tp.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.configs import deit as jdeit  # noqa: E402
from repro.core.mx_types import MXINT6_WEIGHT as J6  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models.model_api import Param as JParam  # noqa: E402
from repro.models.model_api import unwrap  # noqa: E402
from repro.parallel import sharding as JS  # noqa: E402
from repro.serving import engine as JE  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import deit  # noqa: E402
from repro_torch.core.mx_types import MXINT6_WEIGHT, QuantConfig  # noqa: E402
from repro_torch.core.quantize import MXTensor  # noqa: E402
from repro_torch.datapath.hopper_kernel import (  # noqa: E402
    HopperKernelDatapath)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.models.launches import vit_launches  # noqa: E402
from repro_torch.models.model_api import (Param, axes_tree,  # noqa: E402
                                          tree_leaves)
from repro_torch.models.vit import ViT  # noqa: E402
from repro_torch.parallel import sharding as S  # noqa: E402
from repro_torch.serving import engine as E  # noqa: E402

MESHES = {"data2_model2": {"data": 2, "model": 2},
          "pod2_data2_model2": {"pod": 2, "data": 2, "model": 2}}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)       # as in test_torch_lm.py
    yield
    torch.set_num_threads(threads)


def _ref_leaves(cfg):
    """(axes, shape) of every leaf of the reference model's parameters,
    from ``eval_shape`` (nothing is allocated)."""
    tree = jax.eval_shape(jbuild(cfg).init, jax.random.key(0))
    leaves = jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, JParam))
    return [(tuple(p.axes), tuple(p.value.shape)) for p in leaves]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", JC.ARCH_IDS + ["deit_micro"])
def test_logical_to_pspec_equals_reference(arch, mesh):
    cfg = jdeit.DEIT_MICRO if arch == "deit_micro" else JC.smoke_config(arch)
    sizes = MESHES[mesh]
    names = tuple(sizes)
    leaves = _ref_leaves(cfg)
    # the rules' extra logical axes: batch, pods, the MoE capacity
    leaves += [(("batch", "seq", "embed"), (8, 16, 64)),
               (("pods", "layers", "embed", "mlp"), (2, 2, 64, 128)),
               (("cap", "expert"), (6, 4))]
    for axes, shape in leaves:
        for kw in ({}, {"shape": shape, "mesh_shape": sizes}):
            want = JS.logical_to_pspec(axes, JS.LOGICAL_RULES, names, **kw)
            got = S.logical_to_pspec(axes, S.LOGICAL_RULES, names, **kw)
            assert got == tuple(want), (axes, shape, kw)


def test_params_pspecs_maps_an_axes_tree():
    pm = ViT(deit.DEIT_MICRO)
    params = pm.init(0, device="cpu")
    specs = S.params_pspecs(axes_tree(params), S.LOGICAL_RULES,
                            ("data", "model"))
    assert specs["blocks"]["ffn"]["wi"] == (None, None, "model")
    assert specs["blocks"]["attn"]["wo"] == (None, "model", None)
    assert specs["head"] == (None, None)
    assert axes_tree(params) == E.packed_param_axes(
        E.pack_params_mxint(params, MXINT6_WEIGHT))


def _deit_tiny_pair():
    jcfg = dataclasses.replace(jdeit.DEIT_TINY, n_layers=2, n_classes=100)
    jp = jbuild(jcfg).init(jax.random.key(0))
    pm = ViT(dataclasses.replace(deit.DEIT_TINY, n_layers=2, n_classes=100))
    pp = convert.vit_params(pm, jax.tree_util.tree_map(np.asarray,
                                                       unwrap(jp)),
                            device="cpu")
    return jp, pp


@pytest.fixture(scope="module")
def deit_tiny():
    return _deit_tiny_pair()


def _leaves(tree, jax_tree=False):
    if jax_tree:
        return jax.tree_util.tree_leaves(
            tree, is_leaf=lambda x: isinstance(x, JParam))
    return tree_leaves(tree)


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_tp_packing_equals_reference(deit_tiny, tp):
    """``pack_params_mxint(tp_shards=tp)`` on DeiT-Tiny weights: every
    leaf packed or not as the reference's, its block (the out-projection
    and FFN ``wo`` clamped to the per-rank contraction length: DeiT-Tiny's
    out-projection K 96 at 2 ranks takes block 96, 48 at 4) and both
    planes bit for bit."""
    jp, pp = deit_tiny
    want = _leaves(JE.pack_params_mxint(jp, J6, tp_shards=tp), True)
    got = _leaves(E.pack_params_mxint(pp, MXINT6_WEIGHT, tp_shards=tp))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert isinstance(g.value, MXTensor) == hasattr(w.value, "mantissa")
        if not isinstance(g.value, MXTensor):
            continue
        assert g.value.block_size == w.value.block_size
        assert g.value.scale_axis == w.value.scale_axis
        np.testing.assert_array_equal(g.value.mantissa.numpy(),
                                      np.asarray(w.value.mantissa))
        np.testing.assert_array_equal(g.value.exponent.numpy(),
                                      np.asarray(w.value.exponent))
    blocks = {2: 96, 4: 48}
    if tp in blocks:
        packed = E.pack_params_mxint(pp, MXINT6_WEIGHT, tp_shards=tp)
        assert packed["blocks"]["attn"]["wo"].value.block_size == blocks[tp]


@pytest.mark.parametrize("strategy", ["column", "row"])
@pytest.mark.parametrize("tp", [2, 4])
def test_tp_decisions_and_marks_equal_reference(deit_tiny, strategy, tp):
    """Per leaf, ``_tp_decision``, the marked ``tp_axis``/``tp_mode`` and
    the spec of ``tp_shard_packed_params`` as the reference's, on the
    planes each strategy packs (row: ``tp_shards=tp``)."""
    jp, pp = deit_tiny
    shards = tp if strategy == "row" else 1
    jpk = JE.pack_params_mxint(jp, J6, tp_shards=shards)
    ppk = E.pack_params_mxint(pp, MXINT6_WEIGHT, tp_shards=shards)
    jmarked, jspecs = JS.tp_shard_packed_params(jpk, tp, "model", strategy)
    marked, specs = S.tp_shard_packed_params(ppk, tp, "model", strategy)
    for w, g in zip(_leaves(jpk, True), _leaves(ppk)):
        assert S._tp_decision(g.value, tp, strategy) == \
            JS._tp_decision(w.value, tp, strategy)
    for w, g in zip(_leaves(jmarked, True), _leaves(marked)):
        if isinstance(g.value, MXTensor):
            assert (g.value.tp_axis, g.value.tp_mode) == \
                (w.value.tp_axis, w.value.tp_mode)
    jspec_leaves = jax.tree_util.tree_leaves(
        jspecs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert [tuple(s) for s in jspec_leaves] == tree_leaves(specs)


def test_deit_planes_each_strategy_shards():
    """DeiT-Base at 2 ranks: column shards every packed plane's columns;
    row shards only the out-projection (K 768 -> 384, block 192) and FFN
    ``wo`` (K 3072 -> 1536, block 256); q/k/v, ``wi``, the patch linear
    and the head (3 blocks of 256 over 2 ranks) stay whole."""
    pm = ViT(dataclasses.replace(deit.DEIT_BASE, n_layers=1))
    params = pm.param_spec()
    meta = _meta_params(params)
    row = E.pack_params_mxint(meta, MXINT6_WEIGHT, tp_shards=2)
    marked, _ = S.tp_shard_packed_params(row, 2, "model", "row")
    modes = {k: v.value.tp_mode for k, v in _named(marked)
             if isinstance(v.value, MXTensor)}
    assert modes == {"patch_proj": None, "head": None, "attn/wq": None,
                     "attn/wk": None, "attn/wv": None, "attn/wo": "psum",
                     "ffn/wi": None, "ffn/wo": "psum"}
    assert row["blocks"]["attn"]["wo"].value.block_size == 192
    assert row["blocks"]["ffn"]["wo"].value.block_size == 256
    col = E.pack_params_mxint(meta, MXINT6_WEIGHT)
    marked, _ = S.tp_shard_packed_params(col, 2, "model", "column")
    assert {k for k, v in _named(marked) if isinstance(v.value, MXTensor)
            and v.value.tp_mode == "gather"} == set(modes)


def _meta_params(spec):
    """Zero parameters of a spec tree (small enough here to allocate)."""
    if isinstance(spec, dict):
        return {k: _meta_params(v) for k, v in spec.items()}
    shape, axes, _ = spec
    return Param(torch.zeros(shape), axes)


def _named(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named(v, "" if k == "blocks" else f"{prefix}{k}/")
        else:
            yield prefix + k, v


class _StubMesh:
    mesh_dim_names = ("data", "model")

    def __init__(self, dp, tp):
        self.shape = (dp, tp)

    def size(self, i):
        return self.shape[i]


def test_engine_refuses_what_it_cannot_shard():
    pm = ViT(dataclasses.replace(deit.DEIT_MICRO, quant=QuantConfig(
        mode="kernel", quantize_nonlinear=True)))
    params = pm.init(0, device="cpu")
    with pytest.raises(ValueError, match="pack_weights"):
        E.ViTServingEngine(pm, params, E.ServeConfig(batch=4), device="cpu",
                           mesh=_StubMesh(1, 2))
    with pytest.raises(ValueError, match="batch % dp"):
        E.ViTServingEngine(pm, params, E.ServeConfig(batch=3,
                                                     pack_weights=True),
                           device="cpu", mesh=_StubMesh(2, 1))
    sim = ViT(dataclasses.replace(deit.DEIT_MICRO, quant=QuantConfig(
        mode="sim", quantize_nonlinear=True)))
    with pytest.raises(ValueError, match="kernel"):
        E.ViTServingEngine(sim, params, E.ServeConfig(batch=4,
                                                      pack_weights=True),
                           device="cpu", mesh=_StubMesh(1, 2))
    with pytest.raises(ValueError, match="tp_strategy"):
        E.ServeConfig(tp_strategy="diagonal")
    from repro_torch.configs import llama3_8b
    from repro_torch.models import build_model
    lm = build_model(llama3_8b.SMOKE)
    with pytest.raises(ValueError, match="one device"):
        E.make_engine(lm, lm.init(0, device="cpu"), E.ServeConfig(),
                      mesh=_StubMesh(1, 2), device="cpu")
    eng = E.make_engine(pm, params, E.ServeConfig(batch=2), device="cpu")
    assert isinstance(eng, E.ViTServingEngine) and eng.tp == eng.dp == 1


def test_meshes_need_an_initialized_world_of_their_size(tmp_path):
    import torch.distributed as dist
    with pytest.raises(RuntimeError, match="init_process_group"):
        M.make_tp_mesh(2, "cpu")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        with pytest.raises(ValueError, match="needs 2 ranks"):
            M.make_tp_mesh(2, "cpu")
        with pytest.raises(ValueError, match="needs 4 ranks"):
            M.make_serving_mesh(2, 2, "cpu")
        host = M.make_host_mesh("cpu")
        assert tuple(host.mesh_dim_names) == ("data", "model")
        assert M.axis_size(host, "model") == 1 == M.axis_size(None, "data")
    finally:
        dist.destroy_process_group()
    from repro_torch.parallel.spawn import spawn
    with pytest.raises(ValueError, match="at least 2 ranks"):
        spawn(print, 1)


def test_sharded_planes_route_as_the_reference():
    """A 'psum' plane is never fused with the norm (the datapath hoists
    the norm, ``fuses_norm_linear`` is False), the fused op refuses it,
    and a marked plane with no ambient mesh raises; at the launch level
    DeiT-Small's row strategy hoists both fused norms (its q/k/v and
    ``wi`` K of 384 is 2 blocks of 192, which 2 ranks split)."""
    dp = HopperKernelDatapath()
    q = QuantConfig(mode="kernel", quantize_nonlinear=True)
    w = torch.randn(64, 32)
    from repro_torch.core.quantize import pack_weight
    mx = pack_weight(w, MXINT6_WEIGHT, axis=0)
    psum = Param(mx._replace(tp_axis="model", tp_mode="psum"), ("a", "b"))
    gather = Param(mx._replace(tp_axis="model", tp_mode="gather"),
                   ("a", "b"))
    assert not dp.fuses_norm_linear(q, torch.zeros(2, 64), psum)
    assert dp.fuses_norm_linear(q, torch.zeros(2, 64), gather)
    with pytest.raises(ValueError, match="gather"):
        ops.mxint_ln_linear_op(torch.zeros(2, 64), torch.ones(64), None,
                               mx.mantissa, mx.exponent, w_block=64,
                               tp_group=object(), tp_mode="psum")
    with pytest.raises(RuntimeError, match="mesh"):
        dp.linear(torch.zeros(2, 64), gather, q=q)
    small = vit_launches(deit.DEIT_SMALL, "row", 2)
    assert small["mxint_ln_matmul"] == 0
    assert small["mxint_layernorm"] == 1 + 2 * 12
    assert small["mxint_matmul"] == 2 + 12 * 6
    for cfg in (deit.DEIT_TINY, deit.DEIT_BASE):
        assert vit_launches(cfg, "row", 2) == vit_launches(cfg)
        assert sum(vit_launches(cfg).values()) == 3 + 8 * 12
