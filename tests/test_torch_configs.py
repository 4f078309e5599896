"""The port's config registry, shape cells and ``remat`` against the
reference, and AdamW's correctly rounded square roots.

``repro_torch.configs`` answers as ``repro.configs`` does: the ids, the
(architecture x shape) matrix with its skip reasons, the four shape
cells, each FULL config's ``remat`` and ``max_cache_len``.  ``remat``
recomputes blocks in the backward pass and must leave every gradient
bit for bit as it was.  The pure-Python registry needs no jax fixes; the
module still runs torch on one intra-op thread, as every port test file
does.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as JC  # noqa: E402
from repro.configs import deit as jdeit  # noqa: E402
from repro.models import model_api as jmodel_api  # noqa: E402
from repro_torch import configs as C  # noqa: E402
from repro_torch.configs import (deit, llama3_8b,  # noqa: E402
                                  recurrentgemma_2b)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import model_api  # noqa: E402
from repro_torch.models.model_api import tree_leaves  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train.step import value_and_grad  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)       # as in test_torch_lm.py
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# the registry and the cells
# ---------------------------------------------------------------------------
def test_ids_equal_reference():
    assert C.ARCH_IDS == JC.ARCH_IDS
    assert C.VIT_IDS == JC.VIT_IDS
    assert set(C.all_configs()) == set(JC.all_configs())


@pytest.mark.parametrize("arch", JC.ARCH_IDS)
def test_shape_matrix_equal_reference(arch):
    """The arch's 4 cells of the 40-cell matrix: supported and the skip
    reason, as the reference answers them."""
    for shape in jmodel_api.ALL_SHAPES:
        assert C.shape_supported(arch, shape.name) == \
            JC.shape_supported(arch, shape.name)
        assert C.skip_reason(arch, shape.name) == \
            JC.skip_reason(arch, shape.name)


def test_long_500k_is_for_the_subquadratic_three():
    assert {a for a in C.ARCH_IDS if C.shape_supported(a, "long_500k")} == \
        {"mixtral_8x7b", "recurrentgemma_2b", "xlstm_350m"}


def test_shape_cells_equal_reference():
    got = [dataclasses.astuple(s) for s in model_api.ALL_SHAPES]
    want = [dataclasses.astuple(s) for s in jmodel_api.ALL_SHAPES]
    assert got == want
    for s in jmodel_api.ALL_SHAPES:
        assert dataclasses.astuple(model_api.shape_by_name(s.name)) == \
            dataclasses.astuple(s)
    with pytest.raises(KeyError):
        model_api.shape_by_name("train_8k")


@pytest.mark.parametrize("arch", JC.ARCH_IDS + JC.VIT_IDS)
def test_full_config_remat_and_cache_len(arch):
    """Every FULL config's ``remat`` ("block" for the LMs, "none" for the
    DeiTs) and ``max_cache_len``, and the SMOKE ones', as the
    reference's."""
    if arch in JC.VIT_IDS:
        pairs = [(deit.BY_NAME[arch], jdeit.BY_NAME[arch])]
    else:
        pairs = [(C.full_config(arch), JC.full_config(arch)),
                 (C.smoke_config(arch), JC.smoke_config(arch))]
    for got, want in pairs:
        assert got.name == want.name
        assert (got.remat, got.max_cache_len) == \
            (want.remat, want.max_cache_len)
        got.validate()


def test_remat_is_validated():
    with pytest.raises(ValueError):
        dataclasses.replace(deit.DEIT_MICRO, remat="layer").validate()


# ---------------------------------------------------------------------------
# remat: the same gradients, bit for bit
# ---------------------------------------------------------------------------
def _vit_batch():
    rng = np.random.default_rng(3)
    return {"images": rng.normal(size=(4, 32, 32, 3)).astype(np.float32),
            "labels": rng.integers(0, 10, size=(4,)).astype(np.int32)}


def _lm_batch(vocab):
    rng = np.random.default_rng(4)
    return {"tokens": rng.integers(0, vocab, size=(2, 24)).astype(np.int32)}


REMAT_CASES = {
    "deit_micro": (deit.DEIT_MICRO, _vit_batch),
    "llama3_8b_smoke": (llama3_8b.SMOKE, lambda: _lm_batch(512)),
    "recurrentgemma_2b_smoke": (recurrentgemma_2b.SMOKE,
                                lambda: _lm_batch(512)),
}


@pytest.mark.parametrize("name", sorted(REMAT_CASES))
def test_remat_gradients_bit_for_bit(name, monkeypatch):
    """The loss and every gradient leaf with ``remat="block"`` equal those
    without it bit for bit, and the blocks really ran again in the
    backward pass (each attention runs twice per layer with remat)."""
    cfg, batch = REMAT_CASES[name]
    runs = {}
    calls = {"n": 0}
    attention = A.attention

    def counted(*a, **k):
        calls["n"] += 1
        return attention(*a, **k)

    monkeypatch.setattr(A, "attention", counted)
    for remat in ("none", "block"):
        model = build_model(dataclasses.replace(cfg, remat=remat))
        params = model.init(0, device="cpu")
        for p in tree_leaves(params):
            p.value.requires_grad_(True)
        calls["n"] = 0
        b = batch()
        runs[remat] = (*value_and_grad(model.loss, params, b), calls["n"])
    (l0, g0, n0), (l1, g1, n1) = runs["none"], runs["block"]
    assert torch.equal(l0, l1)
    assert len(g0) == len(g1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)
    assert n0 > 0 and n1 == 2 * n0


def test_remat_leaves_inference_alone(monkeypatch):
    """Without a gradient, a remat config's forward runs each block once
    and gives the same logits."""
    calls = {"n": 0}
    attention = A.attention

    def counted(*a, **k):
        calls["n"] += 1
        return attention(*a, **k)

    monkeypatch.setattr(A, "attention", counted)
    out = []
    for remat in ("none", "block"):
        model = build_model(dataclasses.replace(llama3_8b.SMOKE, remat=remat))
        params = model.init(0, device="cpu")
        calls["n"] = 0
        with torch.no_grad():
            out.append(model.forward(params, _lm_batch(512)["tokens"]))
        assert calls["n"] == llama3_8b.SMOKE.n_layers
    assert torch.equal(out[0], out[1])


# ---------------------------------------------------------------------------
# AdamW's square roots
# ---------------------------------------------------------------------------
def _sqrt_witness():
    """float32 values where torch's CPU float32 sqrt is off by an ulp from
    the IEEE (numpy) root."""
    rng = np.random.default_rng(0)
    x = rng.random(1 << 16).astype(np.float32) * np.float32(1e-4)
    off = torch.sqrt(torch.from_numpy(x)).numpy() != np.sqrt(x)
    assert off.any()
    return x


def test_adamw_takes_the_ieee_square_root():
    """``global_norm``'s root and the update's sqrt(vhat) are the
    correctly rounded float32 roots, as XLA's and the card's are: on
    inputs where torch's CPU float32 sqrt is off by an ulp, the port's
    root, its global norm and its updated parameters equal what numpy's
    IEEE root gives, bit for bit."""
    x = _sqrt_witness()
    np.testing.assert_array_equal(adamw._sqrt(torch.from_numpy(x)).numpy(),
                                  np.sqrt(x))
    tree = {"a": torch.from_numpy(x[:1000].copy()),
            "b": torch.from_numpy(x[1000:1500].reshape(20, 25).copy())}
    total = sum(torch.sum(torch.square(v)) for v in (tree["a"], tree["b"]))
    assert float(adamw.global_norm(tree)) == float(np.sqrt(
        np.float32(total.item())))

    # a state past its first step, with random moments, and parameters at
    # 0, so that every bit of sqrt(vhat) reaches the new parameters
    cfg = adamw.AdamWConfig(clip_norm=0.0, weight_decay=0.0)
    rng = np.random.default_rng(1)

    def rand(v, lo):
        return torch.from_numpy((lo + rng.random(v.shape)).astype(np.float32)
                                * np.float32(1e-4))

    grads = {k: rand(v, -0.5) for k, v in tree.items()}
    params = {k: torch.zeros_like(v) for k, v in tree.items()}
    state = adamw.AdamWState(step=torch.tensor(4, dtype=torch.int32),
                             mu={k: rand(v, -0.5) for k, v in tree.items()},
                             nu={k: rand(v, 0.0) * np.float32(1e-4)
                                 for k, v in tree.items()})
    lr = torch.tensor(1e-3)

    def update(root):
        ieee = adamw._sqrt
        try:
            adamw._sqrt = root
            return adamw.adamw_update(grads, state, params, lr, cfg)[0]
        finally:
            adamw._sqrt = ieee

    got = adamw.adamw_update(grads, state, params, lr, cfg)[0]
    want = update(lambda t: torch.from_numpy(np.asarray(np.sqrt(t.numpy()))))
    plain = update(torch.sqrt)
    for k in got:
        assert torch.equal(got[k], want[k])
    # the witness: torch's own float32 root moves some parameters
    assert any(not torch.equal(got[k], plain[k]) for k in got)
