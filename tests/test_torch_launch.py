"""The port's launch dry run (``repro_torch.launch``) against
``repro.launch``, on the CPU.

* ``param_counts`` and ``model_flops_estimate`` equal the reference's for
  every architecture and shape;
* the input and cache stand-ins (``launch.specs``) have the reference's
  shapes and dtypes for every supported cell, Seamless's cross K/V
  included;
* on both production meshes' names and sizes, every leaf of the params
  (bf16 and packed), the train state, the cache and the batch gets the
  reference's ``PartitionSpec`` (a per-layer leaf against its stacked
  counterpart without the leading "layers" entry), and each cell's
  per-device resident bytes equal the sum over the reference's leaves;
* the resident bytes of a SMOKE cell equal a hand sum; ``StepCost``
  counts FLOPs as ``FlopCounterMode`` does and its bytes and live peak
  on a hand-worked function; each collective rule and the roofline's
  assembly on hand-worked cases;
* the CLI, in one subprocess on the 2x2x2 mesh, for Llama-3-8B
  ``decode_32k``, Mixtral-8x7B ``long_500k`` and RecurrentGemma-2B
  ``train_4k`` (xLSTM-350M's ``train_4k`` is left to the sweep: its sLSTM
  token loop runs 4096 steps forward and back, minutes on one thread).
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
from functools import lru_cache
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.core.mx_types import MXINT6_WEIGHT as J6  # noqa: E402
from repro.launch import hlo_analysis as JH  # noqa: E402
from repro.launch import specs as JSp  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models.model_api import Param as JParam  # noqa: E402
from repro.parallel import sharding as JS  # noqa: E402
from repro.serving.engine import pack_params_mxint as jpack  # noqa: E402
from repro.train.state import abstract_train_state as jstate  # noqa: E402
from repro_torch import configs as C  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import roofline as R  # noqa: E402
from repro_torch.launch import specs as S  # noqa: E402
from repro_torch.launch.mesh import production_mesh_shape  # noqa: E402
from repro_torch.launch.step_cost import StepCost, tag_tree  # noqa: E402
from repro_torch.models.model_api import (ALL_SHAPES, ShapeConfig,  # noqa: E402
                                          shape_by_name)
from repro_torch.parallel.sharding import ShardingRules  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"single": production_mesh_shape(False),
          "multi": production_mesh_shape(True)}
CELLS = [(a, s.name) for a in C.ARCH_IDS for s in ALL_SHAPES
         if C.shape_supported(a, s.name)]
# the per-layer lists of the port, by key, and the reference's stacked
# counterparts
LAYER_LISTS = ("layers", "enc_blocks", "dec_blocks", "self", "enc_kv")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)       # as in test_torch_lm.py
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# the reference's counts and specs
# ---------------------------------------------------------------------------
def test_registry_cells_match_reference():
    assert C.ARCH_IDS == JC.ARCH_IDS
    assert len(CELLS) == 33
    for a in C.ARCH_IDS:
        for s in ALL_SHAPES:
            assert C.shape_supported(a, s.name) == JC.shape_supported(
                a, s.name)


def test_production_meshes():
    """The reference's mesh shapes and names (``repro.launch.mesh:33-37``),
    as plain sizes; building the mesh itself needs a process group of
    exactly that world."""
    from repro_torch.launch import mesh as M
    assert MESHES["single"] == {"data": 16, "model": 16}
    assert MESHES["multi"] == {"pod": 2, "data": 16, "model": 16}
    assert M.mesh_shape("tiny_2x2x2") == {"pod": 2, "data": 2, "model": 2}
    assert M.mesh_shape("tiny_2x2") == {"data": 2, "model": 2}
    for multi in (False, True):
        with pytest.raises(RuntimeError, match="process group"):
            M.make_production_mesh(multi_pod=multi, device_type="cpu")


@pytest.mark.parametrize("arch", C.ARCH_IDS)
def test_param_counts_and_model_flops_equal_reference(arch):
    cfg, jcfg = C.full_config(arch), JC.full_config(arch)
    assert R.param_counts(cfg) == JH.param_counts(jcfg)
    from repro.models import shape_by_name as jshape
    for s in ALL_SHAPES:
        for n in (1, 8, 256, 512):
            assert R.model_flops_estimate(cfg, s, n) == \
                JH.model_flops_estimate(jcfg, jshape(s.name), n)


def _keystr(path) -> str:
    parts = []
    for k in path:
        for attr in ("key", "idx", "name"):
            if hasattr(k, attr):
                parts.append(str(getattr(k, attr)))
                break
    return "/".join(parts)


def _jdtype(x) -> str:
    return {"bfloat16": "bf16", "float32": "f32", "float64": "f64",
            "int8": "int8", "int32": "int32"}[str(x.dtype)]


def _ref_entries(tree, axes_tree, group, prefix=""):
    """The reference's leaves of one group: path -> (shape, dtype, axes,
    planes' shapes and dtypes).  Params carry their axes; a packed
    leaf's planes share its mantissa plane's spec."""
    out = {}
    if axes_tree is None:
        flat = jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, JParam))[0]
        for path, p in flat:
            v = p.value
            planes = ([v.mantissa, v.exponent] if hasattr(v, "mantissa")
                      else [v])
            out[prefix + _keystr(path)] = (tuple(planes[0].shape),
                                           _jdtype(planes[0]),
                                           tuple(p.axes), planes)
        return out
    vals = jax.tree_util.tree_flatten_with_path(tree)[0]
    axes = jax.tree_util.tree_leaves(
        axes_tree, is_leaf=lambda x: isinstance(x, tuple) and all(
            y is None or isinstance(y, str) for y in x))
    assert len(vals) == len(axes), group
    for (path, v), a in zip(vals, axes):
        out[prefix + _keystr(path)] = (tuple(v.shape), _jdtype(v), tuple(a),
                                       [v])
    return out


@lru_cache(maxsize=None)
def _jmodel(arch):
    return jbuild(JC.full_config(arch))


@lru_cache(maxsize=None)
def _jparams(arch, variant):
    model = _jmodel(arch)
    params = jax.eval_shape(lambda: model.init(jax.random.key(0)))
    if variant == "mxint":
        params = jpack(params, J6, abstract=True, tp_shards=16)
    return params


def _ref_cell(arch, shape_name, variant):
    """The reference's leaves of a cell, by group."""
    model = _jmodel(arch)
    from repro.models import shape_by_name as jshape
    shape = jshape(shape_name)
    if shape.kind == "train":
        st = jstate(model)
        batch, b_axes = JSp.batch_specs(model.cfg, shape, "train")
        opt = {"mu": st.opt.mu, "nu": st.opt.nu}
        groups = {"params": _ref_entries(st.params, None, "params"),
                  "opt_state": {
                      **_ref_entries(opt, None, "opt_state"),
                      "opt_step": ((), "int32", (), [st.opt.step]),
                      "step": ((), "int32", (), [st.step])},
                  "batch": _ref_entries(batch, b_axes, "batch")}
        return groups
    batch, b_axes = JSp.batch_specs(model.cfg, shape, shape.kind)
    cache = JSp.decode_cache_specs(model, shape)
    return {"params": _ref_entries(_jparams(arch, variant), None, "params"),
            "cache": _ref_entries(cache, JSp.decode_cache_axes(model),
                                  "cache"),
            "batch": _ref_entries(batch, b_axes, "batch")}


def _stacked_path(cfg, path):
    """A port leaf's path -> (the reference's path, stacked or not)."""
    parts = path.split("/")
    for i, p in enumerate(parts[:-1]):
        if p in LAYER_LISTS and parts[i + 1].isdigit():
            idx = int(parts[i + 1])
            if p == "layers":
                n_unit = cfg.resolved_n_units * len(cfg.unit)
                if idx < n_unit:
                    j = idx % len(cfg.unit)
                    head = ["units", f"u{j}_{cfg.unit[j]}"]
                    stacked = True
                else:
                    j = idx - n_unit
                    head = ["tail", f"t{j}_{cfg.tail[j]}"]
                    stacked = False
                return "/".join(parts[:i] + head + parts[i + 2:]), stacked
            return "/".join(parts[:i + 1] + parts[i + 2:]), True
    return path, False


def _pspec(spec):
    return tuple(None if e is None else e if isinstance(e, str)
                 else tuple(e) for e in spec)


@pytest.mark.parametrize("arch", C.ARCH_IDS)
def test_specs_shapes_and_dtypes_equal_reference(arch):
    """``batch_specs`` and ``decode_cache_specs`` of every supported cell
    against the reference's ``ShapeDtypeStruct``s."""
    from repro.models import shape_by_name as jshape
    cfg = C.full_config(arch)
    model = D.build_model(cfg)
    for s in ALL_SHAPES:
        if not C.shape_supported(arch, s.name):
            continue
        kind = s.kind
        batch, b_axes = S.batch_specs(cfg, s, kind)
        jb, jb_axes = JSp.batch_specs(_jmodel(arch).cfg, jshape(s.name), kind)
        assert b_axes == jb_axes
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in batch.items()} == {
            k: (tuple(v.shape), str(v.dtype)) for k, v in jb.items()}
        assert all(v.device.type == "meta" for v in batch.values())
        if kind == "train":
            continue
        cache = S.decode_cache_specs(model, s)
        layout = R.build_layout({"cache": (cache,
                                           S.decode_cache_axes(model))},
                                {"data": 1}, ShardingRules(), kind, 2)
        ref = _ref_entries(JSp.decode_cache_specs(_jmodel(arch),
                                                  jshape(s.name)),
                           JSp.decode_cache_axes(_jmodel(arch)), "cache")
        seen = {}
        for leaf in layout.leaves:
            path, stacked = _stacked_path(cfg, leaf.path)
            shape, dtype, axes, _ = ref[path]
            assert dtype == leaf.dtype, path
            assert (shape[1:] if stacked else shape) == leaf.shape, path
            assert (axes[1:] if stacked else axes) == leaf.axes, path
            n, _ = seen.get(path, (0, stacked))
            seen[path] = (n + 1, stacked)
        assert set(seen) == set(ref)
        for path, (n, stacked) in seen.items():
            assert n == (ref[path][0][0] if stacked else 1), path
        if cfg.is_encoder_decoder:
            assert len(cache["enc_kv"]) == cfg.n_layers
            assert any(p.startswith("enc_kv") for p in seen)


def _variants(shape_name):
    return ["bf16"] if shape_by_name(shape_name).kind == "train" \
        else ["bf16", "mxint"]


@lru_cache(maxsize=None)
def _cell(arch, shape_name, variant):
    """The port's cell on ``meta``; both production meshes give it the
    same "model" size (16) and the same decode switch."""
    return D.build_cell(C.full_config(arch), shape_by_name(shape_name),
                        MESHES["multi"], ShardingRules(), variant)


@lru_cache(maxsize=None)
def _ref_cell_cached(arch, shape_name, variant):
    return _ref_cell(arch, shape_name, variant)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", C.ARCH_IDS)
def test_layout_pspecs_and_resident_bytes_equal_reference(arch, mesh_name):
    """Every leaf's spec on the production mesh, and each cell's
    per-device resident bytes, against the reference's leaves."""
    mesh = MESHES[mesh_name]
    cfg = C.full_config(arch)
    names = tuple(mesh)
    for a, shape_name in CELLS:
        if a != arch:
            continue
        shape = shape_by_name(shape_name)
        for variant in _variants(shape_name):
            cell = _cell(arch, shape_name, variant)
            switched = shape.kind == "decode" and shape.global_batch < (
                mesh.get("pod", 1) * mesh["data"])
            assert (cell.rules.kv_seq == "data") == switched
            layout = D.cell_layout(cell, mesh)
            jrules = JS.ShardingRules()
            if switched:
                jrules = dataclasses.replace(jrules, batch=None,
                                             kv_seq="data")
            ref = _ref_cell_cached(arch, shape_name, variant)
            want_bytes = 0
            for group, entries in ref.items():
                for path, (shp, dt, axes, planes) in entries.items():
                    spec = _pspec(JS.logical_to_pspec(
                        axes, jrules, names, shape=shp, mesh_shape=mesh))
                    want_bytes += sum(R.shard_bytes(
                        tuple(p.shape), p.dtype.itemsize, spec, mesh)
                        for p in planes)
            seen = {}
            for leaf in layout.leaves:
                path, stacked = _stacked_path(cfg, leaf.path)
                shp, dt, axes, planes = ref[leaf.group][path]
                spec = _pspec(JS.logical_to_pspec(
                    axes, jrules, names, shape=shp, mesh_shape=mesh))
                tag = f"{arch} {shape_name} {variant} {leaf.group} {path}"
                assert dt == leaf.dtype, tag
                assert (shp[1:] if stacked else shp) == leaf.shape, tag
                assert (spec[1:] if stacked else spec) == leaf.pspec, tag
                if stacked:
                    assert spec[0] is None, tag
                seen[(leaf.group, path)] = seen.get((leaf.group, path), 0) + 1
            assert set(seen) == {(g, p) for g, e in ref.items() for p in e}
            assert layout.resident_bytes()["total"] == want_bytes, \
                (arch, shape_name, variant)


def test_resident_bytes_equal_a_hand_sum():
    """SMOKE Llama-3, a decode cell at batch 4 over 16 positions on
    (data 2, model 2), float32: the per-device bytes leaf by leaf."""
    cfg = C.smoke_config("llama3_8b")
    d, V, L = cfg.d_model, cfg.vocab, cfg.n_layers
    hq, hkv, hd, ff = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff
    shape = ShapeConfig("d16", 16, 4, "decode")
    mesh = {"data": 2, "model": 2}
    cell = D.build_cell(cfg, shape, mesh, ShardingRules(), "bf16")
    got = D.cell_layout(cell, mesh).resident_bytes()
    f = 4
    # embed / unembed: vocab over model; norms whole; q, k, v: heads over
    # model; wo: q_heads over model; wi, wg, wo: mlp over model
    params = (2 * V * d // 2 + d + L * (
        2 * d + d * hq * hd // 2 + 2 * d * hkv * hd // 2 + hq * hd * d // 2
        + 3 * d * ff // 2)) * f
    # per layer a K and a V ring (batch over data, kv heads over model),
    # and the int32 index vector (batch over data)
    cache = L * 2 * (4 // 2) * 16 * (hkv // 2) * hd * f + (4 // 2) * 4
    batch = (4 // 2) * 1 * 4
    assert got == {"params": params, "opt_state": 0, "cache": cache,
                   "batch": batch, "total": params + cache + batch}


# ---------------------------------------------------------------------------
# the step's counts
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind,variant", [("train", "bf16"),
                                          ("prefill", "bf16"),
                                          ("prefill", "mxint"),
                                          ("decode", "bf16"),
                                          ("decode", "mxint")])
@pytest.mark.parametrize("arch", ["llama3_8b", "mixtral_8x7b",
                                  "seamless_m4t_medium"])
def test_step_cost_flops_equal_flop_counter(arch, kind, variant):
    from torch.utils.flop_counter import FlopCounterMode
    cfg = C.smoke_config(arch)
    shape = ShapeConfig("s", 32 if kind != "decode" else 64, 2, kind)
    cell = D.build_cell(cfg, shape, {"data": 1, "model": 1}, variant=variant)
    with FlopCounterMode(display=False) as fc:
        cell.step(*cell.args)
    counts = D.count_step(cell)
    assert counts["flops"] == fc.get_total_flops() > 0
    # the float products outside the kernels run in float64
    assert counts["flops_by_dtype"].get("f64", 0) > 0
    assert counts["bytes"] > 0 and counts["transient_peak_bytes"] > 0


@pytest.mark.parametrize("shape,axis", [((96, 64), 0), ((3, 40, 24), 1),
                                        ((512, 197), 1), ((100, 30), 0)])
def test_meta_packing_gives_the_planes_shapes(shape, axis):
    """``pack_weight`` on ``meta`` (no values) gives what packing values
    gives, plane by plane."""
    from repro_torch.core.mx_types import MXINT6_WEIGHT
    from repro_torch.core.quantize import pack_weight
    got = pack_weight(torch.empty(shape, device="meta"), MXINT6_WEIGHT, axis)
    want = pack_weight(torch.randn(shape), MXINT6_WEIGHT, axis)
    for g, w in ((got.mantissa, want.mantissa), (got.exponent, want.exponent)):
        assert g.device.type == "meta"
        assert (g.shape, g.dtype) == (w.shape, w.dtype)
    assert tuple(got[2:]) == tuple(want[2:])


def test_step_cost_bytes_and_live_peak_by_hand():
    def step(x):
        y = x * 2            # reads 400, writes 400: a new storage
        z = y + 1            # reads 400, writes 400: a second one
        del y                # freed: 400 live
        w = z.view(10, 10)   # a view: no traffic, no storage
        return w.sum()       # reads 400, writes 4

    x = torch.empty(100, device="meta")
    with StepCost() as c:
        out = step(x)
    got = c.counts()
    assert got["bytes"] == 800 + 800 + 404
    assert got["transient_peak_bytes"] == 800
    assert got["flops"] == 0 and out.shape == ()
    del out


def test_step_cost_tags_follow_casts_and_dequantize():
    """A weight reached through a cast, a view and a packed leaf's
    dequantize is still its leaf in a product event; an op that mixes in
    an activation is not."""
    from repro_torch.core.mx_types import MXFormat
    from repro_torch.core.quantize import dequantize, pack_weight
    from repro_torch.models.model_api import Param
    w = torch.randn(64, 32)
    packed = pack_weight(w, MXFormat(8, 32), axis=0)
    tree = {"a": Param(w, ("embed", "mlp")),
            "b": Param(packed, ("mlp", "embed"))}
    x = torch.randn(4, 64)
    with StepCost(tag_tree(tree)) as c:
        h = x.double() @ w.double().t().t()
        (h.float() @ dequantize(packed).t()).sum()
        (x * w[:, 0]) @ w       # an activation scaled by a weight's row
        w.t() @ w               # two tagged operands: no event
    ev = c.counts()["events"]
    assert [e["leaf"] for e in ev] == ["a", "b", "a"]
    assert ev[0]["out_shape"] == (4, 32)


# ---------------------------------------------------------------------------
# the collective rules and the roofline, by hand
# ---------------------------------------------------------------------------
def _leaf(path, group, shape, axes, pspec, contraction=None, itemsize=2,
          mesh=None):
    n = itemsize * math.prod(shape)
    dev = R.shard_bytes(shape, itemsize, pspec, mesh or {})
    return R.Leaf(path, group, tuple(shape), itemsize, "bf16", tuple(axes),
                  tuple(pspec), n, dev, contraction)


def test_rule_1_sharded_contraction_all_reduces_the_output():
    mesh = {"data": 2, "model": 4}
    wo = _leaf("layers/0/ffn/wo", "params", (512, 64), ("mlp", "embed"),
               ("model", None), 0, mesh=mesh)
    wi = _leaf("layers/0/ffn/wi", "params", (64, 512), ("embed", "mlp"),
               (None, "model"), 0, mesh=mesh)
    ev = [{"op": "mm", "leaf": "layers/0/ffn/wo", "operand": 1,
           "shapes": [(8, 512), (512, 64)], "out_shape": (8, 64)},
          {"op": "mm", "leaf": "layers/0/ffn/wi", "operand": 1,
           "shapes": [(8, 64), (64, 512)], "out_shape": (8, 512)}]
    for kind, passes in (("decode", 1), ("train", 2)):
        lay = R.Layout(mesh, ShardingRules(), kind, [wo, wi], batch_factor=2,
                       act_itemsize=2)
        got = [c for c in R.collective_terms({"events": ev}, lay)
               if c["rule"] == 1]
        # 8 rows x 64 columns x 2 bytes over the 2 batch shards: 512
        assert got == [{"rule": 1, "kind": "all-reduce", "bytes": 512 *
                        passes, "count": passes, "over": ["model"]}]


def test_rule_2_vocab_sharded_lookup_all_reduces_once():
    mesh = {"data": 2, "model": 4}
    emb = _leaf("embed", "params", (1024, 64), ("vocab", "embed"),
                ("model", None), 1, mesh=mesh)
    ev = [{"op": "embedding", "leaf": "embed", "operand": 0,
           "shapes": [(1024, 64), (8, 16)], "out_shape": (8, 16, 64)},
          {"op": "index", "leaf": "embed#exponent", "operand": 0,
           "shapes": [(1024, 2), (8, 16)], "out_shape": (8, 16, 2)}]
    lay = R.Layout(mesh, ShardingRules(), "train", [emb], batch_factor=2,
                   act_itemsize=2)
    got = [c for c in R.collective_terms({"events": ev}, lay)
           if c["rule"] == 2]
    # 8 x 16 rows x 64 x 2 bytes over 2 batch shards, forward only
    assert got == [{"rule": 2, "kind": "all-reduce", "bytes": 8192,
                    "count": 1, "over": ["model"]}]


def test_rule_3_gradients_all_reduce_over_the_batch_axes():
    mesh = {"pod": 2, "data": 2, "model": 4}
    norm = _leaf("final_norm", "params", (64,), ("embed",), (None,), 0,
                 itemsize=4, mesh=mesh)                       # 256 bytes
    wq = _leaf("wq", "params", (64, 256), ("embed", "q_heads"),
               (None, "model"), 0, itemsize=4, mesh=mesh)     # 16384 bytes
    lay = R.Layout(mesh, ShardingRules(), "train", [norm, wq],
                   batch_factor=4, act_itemsize=4)
    got = R.collective_terms({"events": []}, lay)
    assert got == [{"rule": 3, "kind": "all-reduce", "bytes": 256 + 16384,
                    "count": 2, "over": ["data", "pod"]}]
    lay.grad_compression = True
    got = R.collective_terms({"events": []}, lay)
    # the pod axis: one int8 an element and one a block of 32: 64 + 2 and
    # 4096 + 128; the data axis at the leaves' bytes
    assert got == [{"rule": 3, "kind": "all-reduce",
                    "bytes": 66 + 4224 + 256 + 16384, "count": 4,
                    "over": ["data", "pod"]}]


def test_rule_4_expert_sharded_moe_all_to_alls_twice():
    mesh = {"data": 2, "model": 4}
    wi = _leaf("layers/0/ffn/wi", "params", (8, 64, 256),
               ("expert", "embed", "mlp"), ("model", None, None), 1,
               mesh=mesh)
    wo = _leaf("layers/0/ffn/wo", "params", (8, 256, 64),
               ("expert", "mlp", "embed"), ("model", None, None), 1,
               mesh=mesh)
    ev = [{"op": "bmm", "leaf": "layers/0/ffn/wi", "operand": 1,
           "shapes": [(8, 10, 64), (8, 64, 256)], "out_shape": (8, 10, 256)},
          {"op": "bmm", "leaf": "layers/0/ffn/wo", "operand": 1,
           "shapes": [(8, 10, 256), (8, 256, 64)], "out_shape": (8, 10, 64)}]
    lay = R.Layout(mesh, ShardingRules(), "decode", [wi, wo],
                   batch_factor=2, act_itemsize=2)
    got = R.collective_terms({"events": ev}, lay)
    # the (8 experts, 10 slots, 64) buffer: experts over model, the 10
    # slots over data -> 2 x 5 x 64 x 2 bytes a device, twice
    assert got == [{"rule": 4, "kind": "all-to-all", "bytes": 2 * 1280,
                    "count": 2, "over": ["model"]}]


def test_rule_5_kv_seq_decode_all_reduces_the_partials():
    cfg = C.smoke_config("llama3_8b")
    mesh = {"data": 2, "model": 2}
    k = _leaf("layers/0/k", "cache", (1, 64, cfg.n_kv_heads, cfg.hd),
              ("batch", "kv_seq", "kv_heads", None),
              (None, "data", "model", None), mesh=mesh)
    v = _leaf("layers/0/v", "cache", (1, 64, cfg.n_kv_heads, cfg.hd),
              ("batch", "kv_seq", "kv_heads", None),
              (None, "data", "model", None), mesh=mesh)
    lay = R.Layout(mesh, ShardingRules(batch=None, kv_seq="data"), "decode",
                   [k, v], batch_factor=1, act_itemsize=2)
    got = R.collective_terms({"events": []}, lay, cfg)
    # one row; the heads over model; hd bf16 values and two float32 each
    want = 1 * (cfg.n_heads // 2) * (cfg.hd * 2 + 8)
    assert got == [{"rule": 5, "kind": "all-reduce", "bytes": want,
                    "count": 1, "over": ["data"]}]


def test_roofline_terms_and_binding_term():
    """Counts on two devices: bf16 at its peak and f64 at its own."""
    lay = R.Layout({"data": 2}, ShardingRules(), "decode",
                   [_leaf("w", "params", (1024,), ("embed",), (None,),
                          mesh={"data": 2})])
    counts = {"flops_by_dtype": {"bf16": 2 * 989e12, "f64": 67e12},
              "bytes": 2 * 3.35e12 * 3, "transient_peak_bytes": 1000}
    colls = [{"rule": 1, "kind": "all-reduce", "bytes": 450e9 * 0.5,
              "count": 3}]
    r = R.roofline_from_counts(counts, lay, 2, collectives=colls,
                               model_flops=989e12)
    assert r.compute_s == pytest.approx(1.5)
    assert r.memory_s == pytest.approx(3.0)
    assert r.collective_s == pytest.approx(0.5)
    assert r.bottleneck == "memory"
    assert r.flops_by_dtype == {"bf16": 989e12, "f64": 33.5e12}
    assert r.useful_flops_ratio == pytest.approx(989e12 / 1022.5e12)
    assert r.collective_counts["all-reduce"] == 3
    assert r.per_device_hbm_bytes == 2048 + 500
    # the same record on a card with four times the bandwidth and twice
    # the float64 rate: compute binds
    again = R.reanalyze({"roofline": r.as_dict()},
                        R.Peaks.parse("hbm=13.4e12,f64=134e12"))
    assert again["bottleneck"] == "compute"
    assert again["memory_s"] == pytest.approx(0.75)
    assert again["compute_s"] == pytest.approx(1.25)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
CLI_CELLS = [("llama3_8b", "decode_32k"),       # dense, GQA, KV cache
             ("mixtral_8x7b", "long_500k"),     # MoE, window ring, kv_seq
             ("recurrentgemma_2b", "train_4k")]  # recurrent, train step


def test_tiny_multi_cli_cells(tmp_path):
    out = tmp_path / "dryrun"
    script = "\n".join(
        ["import sys", "from repro_torch.launch import dryrun"] +
        [f"rc = dryrun.main(['--arch', '{a}', '--shape', '{s}', '--mesh', "
         f"'tiny_multi', '--out', r'{out}', '--tag', 'ci'])\n"
         f"if rc: sys.exit(rc)" for a, s in CLI_CELLS])
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", script],
                          capture_output=True, text=True, timeout=600,
                          env=env, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    recs = [json.loads(f.read_text()) for f in out.glob("*.ci.json")
            if not f.name.startswith("summary")]
    assert sorted((r["arch"], r["variant"]) for r in recs) == [
        ("llama3_8b", "bf16"), ("llama3_8b", "mxint"),
        ("mixtral_8x7b", "bf16"), ("mixtral_8x7b", "mxint"),
        ("recurrentgemma_2b", "bf16")]
    for rec in recs:
        assert rec["ok"], rec.get("error", "")[:500]
        assert rec["mesh"] == "tiny_2x2x2" and rec["n_devices"] == 8
        roof = rec["roofline"]
        assert roof["compute_s"] > 0 and roof["memory_s"] > 0
        assert roof["bottleneck"] in ("compute", "memory", "collective")
        assert roof["device_flops"] == pytest.approx(
            sum(roof["flops_by_dtype"].values()))
        assert roof["flops_by_dtype"]["f64"] > 0
        mem = rec["memory"]
        assert mem["peak_device_bytes"] == (
            mem["resident_bytes"] + mem["transient_bytes_ideal"])
        assert mem["resident_bytes"] == rec["resident_bytes"]["total"] > 0
        assert rec["split"]["flops_ideal"] == pytest.approx(
            rec["counts"]["flops"] / 8)
    by = {(r["arch"], r["variant"]): r for r in recs}
    # Mixtral's batch 1 takes the kv_seq switch: the partials all-reduce
    assert by[("mixtral_8x7b", "bf16")]["rules"] == {"batch": None,
                                                     "kv_seq": "data"}
    assert {c["rule"] for c in by[("mixtral_8x7b", "bf16")][
        "collectives"]} >= {1, 4, 5}
    train = by[("recurrentgemma_2b", "bf16")]
    assert train["resident_bytes"]["opt_state"] > 0
    assert 3 in {c["rule"] for c in train["collectives"]}
    # the packed planes' resident bytes are below bf16's
    assert by[("llama3_8b", "mxint")]["resident_bytes"]["params"] < \
        by[("llama3_8b", "bf16")]["resident_bytes"]["params"]
    # the table renders the records, and re-derives them under other peaks
    rows = R.run(out, "ci")
    names = [r[0] for r in rows]
    assert "roofline/llama3_8b/decode_32k/tiny_2x2x2/mxint" in names
    assert any(n.startswith("roofline/static/") for n in names)
    table = R.markdown(out, "ci")
    assert len(table) == 2 + 3
    assert table[2].startswith("| llama3_8b decode_32k (bf16/mxint) | ok |")
    slow = R.run(out, "ci", R.Peaks.parse("hbm=1e9"))
    assert all("bound=memory" in r[2] for r in slow
               if r[0].startswith("roofline/llama3_8b"))
