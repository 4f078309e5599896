"""The per-config cases of ``test_torch_lm.py`` for Phi-4-mini (SMOKE: tied embeddings, one packed table serving the
row gather and the unembedding; 3 query heads per KV head, head dim 8).

Every case there that takes the ``config`` or the ``lm`` fixture is
collected here on this file's ``config``, with that file's reference
fixes, tolerances and measured gaps.  Each config has a file of its own
so that the test runner can share the configs out over its workers.
"""
import pytest

torch = pytest.importorskip("torch")

import test_torch_lm as base  # noqa: E402
from test_torch_lm import jax_reference, lm  # noqa: E402,F401  (fixtures)

CONFIG = "phi4_mini_3_8b"


@pytest.fixture(scope="module")
def config():
    return CONFIG


globals().update(base.per_config_cases(CONFIG, __file__))
