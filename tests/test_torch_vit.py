"""The port's DeiT slice end to end against the reference ViT.

The reference's parameters go through ``repro_torch.convert`` so both
packages compute the same function on the same numpy inputs.  The
reference runs under two scoped fixes for the installed jax (the
``TPUCompilerParams`` alias and an exact ``exp2`` on integer inputs).
"""
import dataclasses
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from repro.configs import deit as jdeit  # noqa: E402
from repro.core.mx_types import QuantConfig as JQuantConfig  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.models.model_api import unwrap  # noqa: E402
from repro.serving.engine import pack_params_mxint as j_pack  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import deit  # noqa: E402
from repro_torch.core.mx_types import MXINT6_WEIGHT, QuantConfig  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.model_api import tree_map  # noqa: E402
from repro_torch.models.vit import ViT  # noqa: E402
from repro_torch.serving.engine import (ServeConfig,  # noqa: E402
                                        ViTServingEngine, pack_params_mxint)
from repro_torch.serving.scheduler import (ClassifyRequest,  # noqa: E402
                                           ClassifyScheduler)

KERNEL = QuantConfig(mode="kernel", quantize_nonlinear=True)


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


def _pair(name, jax_mode, n_layers, n_classes):
    """(reference model, its params, port model, converted params)."""
    jcfg = dataclasses.replace(
        jdeit.BY_NAME[name], n_layers=n_layers, n_classes=n_classes,
        quant=JQuantConfig(mode=jax_mode, quantize_nonlinear=True))
    jm = build_model(jcfg)
    jp = jm.init(jax.random.key(0))
    pm = ViT(dataclasses.replace(deit.BY_NAME[name], n_layers=n_layers,
                                 n_classes=n_classes, quant=KERNEL))
    arrays = jax.tree_util.tree_map(np.asarray, unwrap(jp))
    return jm, jp, pm, convert.vit_params(pm, arrays, device="cpu")


def _images(n, size, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, size, size, 3)).astype(np.float32)


def test_converted_planes_equal_reference_planes():
    jm, jp, pm, pp = _pair("deit_micro", "kernel", 4, 10)
    jpk = unwrap(j_pack(jp, JQuantConfig().weight_fmt))
    ppk = pack_params_mxint(pp, MXINT6_WEIGHT)
    n_packed = 0

    def check(p, ref):
        nonlocal n_packed
        if hasattr(ref, "mantissa"):
            n_packed += 1
            np.testing.assert_array_equal(p.value.mantissa.numpy(),
                                          np.asarray(ref.mantissa))
            np.testing.assert_array_equal(p.value.exponent.numpy(),
                                          np.asarray(ref.exponent))
            assert p.value.block_size == ref.block_size
        else:
            np.testing.assert_array_equal(p.value.numpy(), np.asarray(ref))

    def walk(a, b):
        if isinstance(a, dict):
            for k in a:
                walk(a[k], b[k])
        else:
            check(a, b)

    walk(ppk, jpk)
    assert n_packed == 6          # the block linears; 4 layers reach 16384
    with pytest.raises(ValueError, match="shape"):
        bad = jax.tree_util.tree_map(np.asarray, unwrap(jp))
        bad["head"] = bad["head"][:, :3]
        convert.vit_params(pm, bad, device="cpu")


def test_deit_micro_logits_vs_reference_kernel_mode():
    jm, jp, pm, pp = _pair("deit_micro", "kernel", 4, 10)
    imgs = _images(3, 32, seed=7)
    want = np.asarray(jax.jit(jm.logits)(
        j_pack(jp, JQuantConfig().weight_fmt), jnp.asarray(imgs)))
    eng = ViTServingEngine(pm, pp, ServeConfig(batch=4, pack_weights=True),
                           device="cpu")
    labels, got = eng.classify(imgs)
    got = got.numpy()
    np.testing.assert_array_equal(labels.numpy(), want.argmax(-1))
    # the f32 sums of the matmul blocks run in another order than the
    # reference's, and the whole-row attention's products in float64
    # rounded once; measured gap: 0 (the logits are bit-identical, before
    # and after the products moved to float64)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))


def test_deit_tiny_logits_vs_reference_sim_mode():
    """Two DeiT-Tiny layers at full width (d 192, 197 tokens, 100 classes)
    against the reference's bit-accurate sim path.  Besides the sum order,
    the GELU differs where sim clips a requantized mantissa at -128 and
    the kernels at -127, so the test allows 1e-3 of the logit scale and
    requires argmax equal on every row.  Measured gap at this seed: 0 (the
    logits are bit-identical; no block hit the -128 clip)."""
    jm, jp, pm, pp = _pair("deit_tiny", "sim", 2, 100)
    imgs = _images(2, 224, seed=0)
    want = np.asarray(jax.jit(jm.logits)(jp, jnp.asarray(imgs)))
    eng = ViTServingEngine(pm, pp, ServeConfig(batch=2, pack_weights=True),
                           device="cpu")
    labels, got = eng.classify(imgs)
    np.testing.assert_array_equal(labels.numpy(), want.argmax(-1))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-3 * float(np.abs(want).max()))


def test_forward_calls_each_kernel_3_plus_8_per_layer(monkeypatch):
    """The kernel path of one forward: patch linear, 8 calls per block,
    final LN and head, as the reference's trace lint pins it."""
    calls = {}
    for name in ("mxint_matmul", "mxint_ln_matmul", "mxint_softmax",
                 "mxint_gelu", "mxint_layernorm"):
        fn = getattr(ops, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(ops, name, counted)
    L = 3
    pm = ViT(dataclasses.replace(deit.DEIT_MICRO, n_layers=L, quant=KERNEL))
    pp = pack_params_mxint(pm.init(1, device="cpu"), MXINT6_WEIGHT)
    pm.logits(pp, torch.from_numpy(_images(2, 32, seed=1)))
    assert calls == {"mxint_matmul": 2 * L + 2, "mxint_ln_matmul": 4 * L,
                     "mxint_softmax": L, "mxint_gelu": L,
                     "mxint_layernorm": 1}
    assert sum(calls.values()) == 3 + 8 * L


class _StubEngine:
    """Records the chunks it is given; logit j of a row is row.sum() + j."""

    def __init__(self, batch):
        self.cfg = ServeConfig(batch=batch)
        self.model = ViT(dataclasses.replace(deit.DEIT_MICRO, n_classes=3))
        self.chunks = []

    def logits_batch(self, chunk):
        self.chunks.append(np.array(chunk))
        s = chunk.reshape(chunk.shape[0], -1).sum(-1)
        return torch.from_numpy(s[:, None] + np.arange(3, dtype=np.float32))


def test_scheduler_pads_and_keeps_fifo_order():
    eng = _StubEngine(batch=4)
    sched = ClassifyScheduler(eng)
    sizes = [3, 0, 2, 4]
    reqs = [ClassifyRequest(uid, np.full((n, 2, 2, 3), uid + 1.0, np.float32))
            for uid, n in enumerate(sizes)]
    for r in reqs:
        sched.submit(r)
    done = sched.run()
    assert [r.uid for r in done] == [0, 1, 2, 3]
    assert all(r.done for r in done)
    assert [len(c) for c in eng.chunks] == [4, 4, 4]    # 9 images, padded
    np.testing.assert_array_equal(eng.chunks[-1][1:], 0.0)  # zero padding
    # the first step packs across request boundaries: 3 of uid 0, 1 of uid 2
    np.testing.assert_array_equal(eng.chunks[0][:, 0, 0, 0], [1, 1, 1, 3])
    assert done[1].logits.shape == (0, 3) and done[1].labels.shape == (0,)
    for r, n in zip(done, sizes):
        assert r.logits.shape == (n, 3)
        np.testing.assert_array_equal(r.labels, np.full(n, 2))


def test_entry_points_default_to_cuda():
    for fn in (ViTServingEngine.__init__, ViT.init, convert.vit_params):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-device error is moot")
    pm = ViT(dataclasses.replace(deit.DEIT_MICRO, quant=KERNEL))
    pp = pm.init(0, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        ViTServingEngine(pm, pp, ServeConfig(batch=2))
    moved = tree_map(lambda p: p, pp)
    assert moved["head"].value.device.type == "cpu"
