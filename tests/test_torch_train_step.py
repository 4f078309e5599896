"""One train step of the port against ``repro.train.step.make_train_step``.

DeiT-Micro in "off", "fake" and "sim", and the SMOKE Llama-3 and Mixtral
(the load-balancing loss in the loss): the loss, every gradient leaf,
the grad norm and the updated params from the same parameters and numpy
batches; 20 steps of DeiT-Micro in "off"; the train state's axes and
``ViT.accuracy``.  The reference's fixes, jit and helpers are those of
``tests/test_torch_train.py``; this file stands apart so that the test
runner can give the two files to two workers.  Each test states its
tolerance and the gap it measured.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import deit as jdeit  # noqa: E402
from repro.configs import smoke_config  # noqa: E402
from repro.core.mx_types import QuantConfig as JQuantConfig  # noqa: E402
from repro.data import pipeline as jdata  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.models.model_api import unwrap  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train.state import make_train_state as j_train_state  # noqa: E402
from repro.train.state import train_state_axes as j_state_axes  # noqa: E402
from repro.train.step import make_train_step as j_train_step  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import deit, llama3_8b, mixtral_8x7b  # noqa: E402
from repro_torch.core.mx_types import QuantConfig  # noqa: E402
from repro_torch.models.model_api import tree_leaves  # noqa: E402
from repro_torch.models.transformer import DecoderLM  # noqa: E402
from repro_torch.models.vit import ViT  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import (abstract_train_state,  # noqa: E402
                               make_train_step, train_state_axes,
                               train_state_from_params)
from repro_torch.train.step import value_and_grad  # noqa: E402

from test_torch_train import LR, _ref_jit, _rel_gap  # noqa: E402
from test_torch_train import jax_reference  # noqa: E402,F401  (fixture)


VIT_MODES = {"off": {}, "fake": {}, "sim": {"quantize_nonlinear": True}}
# gradients, relative to each leaf's scale: the port's products and
# norms run in float64 (rounded once), the reference's in float32.
# Measured: off 1.5e-6, fake 7.3e-7, sim 1.1e-7 (in sim only the head's
# leaves get a gradient: the MXInt final LayerNorm's integer stages stop
# it, in both packages).  Held to 5e-6.
GRAD_TOL = 5e-6


def _vit_pair(mode, n_classes=10, batch=8):
    kw = VIT_MODES[mode]
    jm = build_model(dataclasses.replace(
        jdeit.DEIT_MICRO, n_classes=n_classes,
        quant=JQuantConfig(mode=mode, **kw)))
    pm = ViT(dataclasses.replace(deit.DEIT_MICRO, n_classes=n_classes,
                                 quant=QuantConfig(mode=mode, **kw)))
    jst = j_train_state(jm, jax.random.key(0))
    st = train_state_from_params(convert.vit_params(
        pm, jax.tree_util.tree_map(np.asarray, unwrap(jst.params)),
        device="cpu"))
    jdata_ = jdata.SyntheticImageData(n_classes=n_classes, batch=batch,
                                      image_size=32, seed=0)
    return jm, jst, pm, st, jdata_


def _torch_batch(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def _check_step(jm, jst, pm, st, jb, conv, loss_tol):
    """One step of both packages on one batch: loss, every gradient
    leaf, the grad norm and the updated params."""
    tb = _torch_batch(jb)
    jloss, jgrads = _ref_jit(jax.value_and_grad(
        lambda p, b: jm.loss(p, b)))(jst.params, jb)
    loss, grads = value_and_grad(lambda p, b: pm.loss(p, b), st.params, tb)
    assert abs(float(loss) - float(jloss)) <= loss_tol * abs(float(jloss))
    want = [p.value for p in tree_leaves(conv(
        pm, jax.tree_util.tree_map(np.asarray, unwrap(jgrads)),
        device="cpu"))]
    assert len(want) == len(grads)
    worst = max(_rel_gap(g, w) for g, w in zip(grads, want))
    assert worst <= GRAD_TOL, worst
    for g, w in zip(grads, want):              # zero exactly where the
        assert bool((w == 0).all()) == bool((g == 0).all())   # ref is
    jstep = _ref_jit(j_train_step(
        jm, lr_fn=lambda s: jnp.asarray(LR, jnp.float32)))
    jst2, jmet = jstep(jst, jb)
    st2, met = make_train_step(pm, lr_fn=lambda s: torch.tensor(LR))(st, tb)
    assert _rel_gap(met["grad_norm"], jmet["grad_norm"]) <= GRAD_TOL
    assert int(st2.step) == int(jst2.step) == 1
    # AdamW's first step moves each element by lr * (g / (|g| + eps) +
    # wd p): about lr * sign(g).  Where |g| is within the gradient gap of
    # 0 the sign may differ, so the params are held to 2.2 lr everywhere
    # and to two float32 ulps of max(1, |p|) where the reference's |g| >=
    # 1e-5 (measured: 2.0e-4, and one ulp of the unit LayerNorm gains)
    new = tree_leaves(conv(pm, jax.tree_util.tree_map(
        np.asarray, unwrap(jst2.params)), device="cpu"))
    for got, ref, g in zip(tree_leaves(st2.params), new, want):
        gap = (got.value.detach() - ref.value).abs()
        assert float(gap.max()) <= 2.2 * LR
        firm = g.abs() >= 1e-5
        if bool(firm.any()):
            ulps = gap[firm] / ref.value[firm].abs().clamp(min=1.0)
            assert float(ulps.max()) <= 2.4e-7
    return met


@pytest.mark.parametrize("mode", list(VIT_MODES))
def test_deit_micro_train_step_against_reference(mode):
    """Loss tolerance 1e-6 relative; measured 0 in all three modes (the
    losses are bit-identical)."""
    jm, jst, pm, st, jd = _vit_pair(mode)
    _check_step(jm, jst, pm, st, jd.next_batch(), convert.vit_params, 1e-6)


@pytest.mark.parametrize("name", ["llama3_8b", "mixtral_8x7b"])
def test_smoke_lm_train_step_against_reference(name):
    """SMOKE Llama-3 and Mixtral (4 experts top-2, the load-balancing
    loss in the loss), "off", 4 x 32 tokens.  Loss tolerance 1e-6
    relative; measured 3.0e-7 (Llama) and 1.5e-7 (Mixtral); gradients
    within 1.2e-6 and 1.5e-6 of their scale."""
    pcfg = {"llama3_8b": llama3_8b, "mixtral_8x7b": mixtral_8x7b}[name]
    jm, pm = build_model(smoke_config(name)), DecoderLM(pcfg.SMOKE)
    jst = j_train_state(jm, jax.random.key(0))
    st = train_state_from_params(convert.lm_params(
        pm, jax.tree_util.tree_map(np.asarray, unwrap(jst.params)),
        device="cpu"))
    jb = jdata.SyntheticLMData(vocab=512, batch=4, seq_len=32,
                               seed=5).next_batch()
    _check_step(jm, jst, pm, st, jb, convert.lm_params, 1e-6)


def test_train_state_axes_match_reference():
    jm = build_model(jdeit.DEIT_MICRO)
    want = j_state_axes(j_train_state(jm, jax.random.key(0)))
    pm = ViT(deit.DEIT_MICRO)
    got = train_state_axes(abstract_train_state(pm))
    assert got.params == want.params
    assert got.opt.mu == want.opt.mu and got.step == want.step == ()
    got = train_state_axes(abstract_train_state(pm, grad_compression=True,
                                                n_pods=2))
    assert got.err_fb["head"] == ("pods", "embed", "classes")


def test_deit_micro_20_steps_off_loss_curve():
    """20 steps at batch 16, constant lr 1e-3, weight decay 0.01 (the
    accuracy recipe's optimizer): the port's loss at every step within
    1e-4 relative of the reference's; measured 4.3e-7 (the runs diverge
    only by the roundings of the products and the AdamW moments)."""
    jm, jst, pm, st, jd = _vit_pair("off", n_classes=100, batch=16)
    jstep = _ref_jit(j_train_step(
        jm, lr_fn=lambda s: jnp.asarray(LR, jnp.float32),
        opt_cfg=jadamw.AdamWConfig(weight_decay=0.01)))
    step = make_train_step(pm, lr_fn=lambda s: torch.tensor(LR),
                           opt_cfg=adamw.AdamWConfig(weight_decay=0.01))
    worst = 0.0
    losses = []
    for _ in range(20):
        jb = jd.next_batch()
        jst, jmet = jstep(jst, jb)
        st, met = step(st, _torch_batch(jb))
        want = float(jmet["loss"])
        losses.append(float(met["loss"]))
        worst = max(worst, abs(losses[-1] - want) / abs(want))
    assert worst <= 1e-4, worst
    assert losses[-1] < losses[0]



def test_vit_accuracy_against_reference():
    jm, jst, pm, st, jd = _vit_pair("off")
    jb = jd.next_batch()
    want = float(_ref_jit(jm.accuracy)(jst.params, jb))
    with torch.no_grad():
        got = float(pm.accuracy(st.params, _torch_batch(jb)))
    assert got == want


