"""The port's core (formats, LUTs, quantizer) against ``repro.core``.

Inputs come from numpy with a seed and go through both packages.  The
reference runs with two scoped fixes for the installed jax (the
``TPUCompilerParams`` alias and an exact ``exp2`` on integer inputs), so
its quantizer scales are the exact powers of two the port builds.
"""
import importlib
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from repro.core import luts as jluts  # noqa: E402
from repro.core.mx_types import MXFormat as JMXFormat  # noqa: E402
from repro.core.mx_types import NonlinearConfig as JNonlinearConfig  # noqa: E402
from repro_torch.core import luts, quantize as tq  # noqa: E402
from repro_torch.core.mx_types import (MXFormat, NonlinearConfig,  # noqa: E402
                                       QuantConfig)

ROOT = Path(__file__).resolve().parents[1]
# the module, not the ``quantize`` function that ``repro.core`` re-exports
jq = importlib.import_module("repro.core.quantize")


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


def _x(shape, seed=0, scale=3.0):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return x * np.float32(scale)


# ---------------------------------------------------------------------------
# LUTs and formats
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bits", [3, 4, 5, 6])
def test_tables_equal_reference(bits):
    assert luts.rsqrt_table(bits) == jluts.rsqrt_table(bits)
    assert luts.pow2_table(bits) == jluts.pow2_table(bits)
    assert luts.gelu_table(bits, 3.0) == jluts.gelu_table(bits, 3.0)


def test_gelu_index_bits_match():
    for lb in (3, 4, 5, 6):
        for dom in (2.0, 3.0, 4.0):
            assert NonlinearConfig(gelu_lut_bits=lb, gelu_domain=dom) \
                .gelu_index_bits == JNonlinearConfig(
                    gelu_lut_bits=lb, gelu_domain=dom).gelu_index_bits


def test_resolve_block_matches():
    for dim in list(range(1, 300)) + [768, 1000, 3072]:
        for blk in (1, 8, 16, 32, 256):
            assert tq._resolve_block(dim, blk) == jq._resolve_block(dim, blk)


def test_format_fields_match():
    for mb, bs in ((8, 16), (6, 256), (4, 32)):
        a, b = MXFormat(mb, bs), JMXFormat(mb, bs)
        assert (a.mant_max, a.mant_min, a.bits_per_element) == \
            (b.mant_max, b.mant_min, b.bits_per_element)
    with pytest.raises(ValueError):
        MXFormat(mant_bits=1)


def test_pow2i_is_exact():
    n = np.arange(-160, 128)
    got = tq.pow2i(torch.from_numpy(n)).numpy()
    want = np.ldexp(np.float32(1.0), n).astype(np.float32)
    assert np.isinf(tq.pow2i(torch.tensor([128, 254])).numpy()).all()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the quantizer, bit for bit
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,axis,fmt", [
    ((6, 64), -1, (8, 16)),
    ((4, 197), -1, (8, 16)),          # block resolves to 1
    ((192, 40), 0, (6, 256)),         # weight plane, block clamps to 192
    ((3, 768, 8), 1, (6, 256)),       # layer-stacked weight
])
def test_quantize_dequantize_bit_exact(shape, axis, fmt):
    x = _x(shape, seed=len(shape) + shape[-1])
    x.flat[::7] = 0.0
    x.flat[3::11] *= np.float32(1e-30)          # tiny blocks and values
    got = tq.quantize(torch.from_numpy(x), MXFormat(*fmt), axis=axis)
    want = jq.quantize(jnp.asarray(x), JMXFormat(*fmt), axis=axis)
    np.testing.assert_array_equal(got.mantissa.numpy(),
                                  np.asarray(want.mantissa))
    np.testing.assert_array_equal(got.exponent.numpy(),
                                  np.asarray(want.exponent))
    assert (got.scale_axis, got.block_size) == \
        (want.scale_axis, want.block_size)
    np.testing.assert_array_equal(tq.dequantize(got).numpy(),
                                  np.asarray(jq.dequantize(want)))
    m, e = tq.requantize_to_max_exponent(got, axis=axis)
    jm, je = jq.requantize_to_max_exponent(want, axis=axis)
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))


def test_pack_weight_matches():
    w = _x((192, 96), seed=5, scale=0.05)
    got = tq.pack_weight(torch.from_numpy(w), MXFormat(6, 256))
    want = jq.pack_weight(jnp.asarray(w), JMXFormat(6, 256))
    np.testing.assert_array_equal(got.mantissa.numpy(),
                                  np.asarray(want.mantissa))
    np.testing.assert_array_equal(got.exponent.numpy(),
                                  np.asarray(want.exponent))
    assert got.mantissa.dtype == torch.int8


# ---------------------------------------------------------------------------
# config and dispatch
# ---------------------------------------------------------------------------
def test_quant_config_resolves_each_mode_to_the_reference_counterpart():
    """Each of the five modes resolves to the port's counterpart of the
    reference's backend, with the same capability flags."""
    from repro.core.mx_types import QuantConfig as JQuantConfig
    names = {"torch_float": "xla_float", "mxint_sim": "mxint_sim",
             "hopper_kernel": "pallas_kernel"}
    for mode in ("off", "fake", "sim", "packed", "kernel"):
        dp = QuantConfig(mode=mode, quantize_nonlinear=True).datapath
        ref = JQuantConfig(mode=mode, quantize_nonlinear=True).datapath
        assert names[dp.name] == ref.name, mode
        assert (dp.qdq_linears, dp.quantized_nonlinear) == \
            (ref.qdq_linears, ref.quantized_nonlinear), mode
    q = QuantConfig(mode="kernel", quantize_nonlinear=True)
    assert q.nonlinear == NonlinearConfig()
    assert q.scoped("block/0/attn") is q
    with pytest.raises(ValueError):
        QuantConfig(mode="bogus")


def test_port_imports_neither_jax_nor_reference():
    """The ``port-imports`` source rule over ``src/repro_torch/`` and
    ``chip_smoke.py``."""
    from repro_torch.analysis import source_rules
    files = [f for f in source_rules.scanned_files(ROOT)
             if f.name == "chip_smoke.py" or "repro_torch" in f.parts]
    assert len(files) > 20 and ROOT / "chip_smoke.py" in files
    bad = source_rules.check_tree(ROOT, only="port-imports")
    assert not bad, [str(v) for v in bad]
    # the rule takes no waiver, and none is written
    assert "port-imports" in source_rules.UNWAIVABLE
    waived = [f.name for f in files
              if "allow[port-imports]" in f.read_text()]
    assert not waived, waived
