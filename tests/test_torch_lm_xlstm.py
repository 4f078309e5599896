"""The cases of ``test_torch_lm_recurrent.py`` (the per-config cases of
``test_torch_lm.py`` it keeps, and its serve-and-score case in "off",
"sim" and kernel mode) for xLSTM-350M: SMOKE, two units of 3 mLSTM + 1 sLSTM blocks, no FFN,
tied embeddings.  A file of its own so that the test runner can give the
two recurrent configs two workers; the tolerances and measured gaps are
those files'.
"""
import pytest

torch = pytest.importorskip("torch")

import test_torch_lm_recurrent as rec  # noqa: E402
from test_torch_lm import jax_reference, lm  # noqa: E402,F401  (fixtures)

CONFIG = "xlstm_350m"
assert {CONFIG, rec.CONFIG} == set(rec.base.RECURRENT)


@pytest.fixture(scope="module")
def config():
    return CONFIG


globals().update(rec.CASES)
test_serve_and_score_vs_reference = rec.test_serve_and_score_vs_reference
