"""The cases of ``test_torch_lm.py`` for the recurrent families, here
RecurrentGemma-2B (SMOKE: one (rec, rec, attn) unit and a (rec, rec)
tail, RG-LRU blocks, local attention over a 16-slot ring, head dim 32
over one KV head, GeGLU, tied embeddings); ``test_torch_lm_xlstm.py``
runs the same cases for xLSTM-350M (SMOKE: two units of 3 mLSTM + 1
sLSTM blocks, no FFN, tied embeddings), so that the test runner can give
the two configs two workers.

The per-config cases of that file that these configs run (``CASES``),
with its reference fixes and tolerances: the reference's SMOKE
parameters through ``convert.lm_params``, both packages packing them to
MXInt8 planes, in kernel mode: the packed planes, a slot prefill's
logits and the launch structure.  ``test_serve_and_score_vs_reference``
then serves 3 requests through ``BatchScheduler`` at batch 2 (slot
prefills, 3-4 decode steps each, a row refilled while the other decodes)
and scores 256 tokens in "off", "sim" (float weights; the MXInt
non-linears, the mLSTM exp gate through the pow2 LUT) and kernel mode.
Left out, to keep the suite inside its time: the 512- and 640-token
scores (the same whole-row path as the 256-token one, and the flash
path, whose plain versions ``test_torch_flash.py`` holds at head dims up
to 256; xLSTM has no attention), the 8-step ``generate`` and the mixed-
bucket scheduler case (their decode steps are the scheduler's above),
the window ring (these configs' rings are their own), wave admission
and sampling (the engine's, the same for every config).  The recurrent
gates run their transcendentals in float64 rounded once, the
reference's in float32, so values may differ in their last bits
(``test_torch_recurrent.py``); measured here: identical tokens in every
mode, the slot-prefill logits bit-identical for both configs, the
losses as ``MODE_LOSS_TOL`` states.
"""
import dataclasses
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import test_torch_lm as base  # noqa: E402
from repro.core.mx_types import QuantConfig as JQuantConfig  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.models.model_api import unwrap  # noqa: E402
from repro.serving.scheduler import BatchScheduler as JBatchScheduler  # noqa: E402
from repro.serving.scheduler import Request as JRequest  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.mx_types import QuantConfig  # noqa: E402
from repro_torch.models.transformer import DecoderLM  # noqa: E402
from repro_torch.serving.engine import ServeConfig, ServingEngine  # noqa: E402
from repro_torch.serving.scheduler import BatchScheduler, Request  # noqa: E402
from test_torch_lm import jax_reference, lm  # noqa: E402,F401  (fixtures)

MODES = {"off": dict(mode="off"),
         "sim": dict(mode="sim", quantize_nonlinear=True),
         "kernel": base.KERNEL}
# the 256-token losses, relative: "off" to float32 rounding; "sim" and
# kernel mode run the MXInt non-linears on values whose last bits may
# differ (the float64 products and transcendentals against XLA's
# float32), so one act-grid step may move, about 1% of a value, and the
# loss with it (measured: xLSTM 1.3e-5 in "sim" (its 37-token prefill
# logits 9.6e-3 of their scale, argmax equal), 1.0e-5 in kernel mode, 0
# in "off"; RecurrentGemma 0 in all three)
MODE_LOSS_TOL = {"off": 1e-6, "sim": 1e-4, "kernel": 1e-4}


CONFIG = "recurrentgemma_2b"
# the per-config cases these configs run (see the module note)
LEFT_OUT = ("test_loss_at_640_tokens_vs_reference",
            "test_loss_at_512_tokens_vs_reference",
            "test_eight_decode_steps_identical_tokens",
            "test_batch_scheduler_tokens_equal_reference",
            "test_window_ring_decode_vs_reference",
            "test_wave_admission_and_eos",
            "test_temperature_samples_with_the_engine_seed")
CASES = {name: fn for name, fn in vars(base).items()
         if name.startswith("test_")
         and {"config", "lm"} & set(inspect.signature(fn).parameters)
         and name not in LEFT_OUT}
assert set(LEFT_OUT) <= set(vars(base))
assert set(base.RECURRENT) == {CONFIG, "xlstm_350m"}


@pytest.fixture(scope="module")
def config():
    return CONFIG


globals().update(CASES)


@pytest.mark.parametrize("mode", list(MODES))
def test_serve_and_score_vs_reference(config, mode, request):
    """3 requests through ``BatchScheduler`` at batch 2 (slot prefills in
    the 64-token bucket, then 3-4 decode steps each, a row refilled while
    the other decodes) and a 256-token loss (the whole-row attention),
    against the reference in the same mode: tokens identical, the loss
    within ``MODE_LOSS_TOL``.  "off" and "sim" on float weights; kernel
    mode on the ``lm`` fixture's MXInt8 planes and engines."""
    jcfg, pcfg = base.CONFIGS[config]
    if mode == "kernel":
        jm, jeng, pm, peng = request.getfixturevalue("lm")
        jp, pp = jeng.params, peng.params
    else:
        jm = build_model(dataclasses.replace(
            jcfg.SMOKE, quant=JQuantConfig(**MODES[mode])))
        pm = DecoderLM(dataclasses.replace(pcfg.SMOKE,
                                           quant=QuantConfig(**MODES[mode])))
        jp = jax.jit(jm.init)(jax.random.key(0))
        pp = convert.lm_params(pm, jax.tree_util.tree_map(np.asarray,
                                                          unwrap(jp)), "cpu")
        jeng = base._ref_engine(jm, jp, batch=2, pack=False)
        peng = ServingEngine(pm, pp, ServeConfig(max_len=base.MAX_LEN,
                                                 batch=2), device="cpu")
    prompts = [base._tokens((n,), 41 + i) for i, n in enumerate((37, 50, 60))]
    new = [5, 4, 5]
    got = base._serve(BatchScheduler, Request, peng, prompts, new)
    assert got == base._serve(JBatchScheduler, JRequest, jeng, prompts, new)
    assert [len(got[i]) for i in range(3)] == new
    toks = base._tokens((1, 256), 44)
    wloss = float(base._ref_jit(jm.loss)(jp, {"tokens": jnp.asarray(toks)}))
    gloss = float(pm.loss(pp, {"tokens": torch.from_numpy(toks)}))
    assert abs(gloss - wloss) <= MODE_LOSS_TOL[mode] * abs(wloss), \
        (gloss, wloss)
