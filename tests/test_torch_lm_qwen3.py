"""The per-config cases of ``test_torch_lm.py`` for Qwen3-14B (SMOKE: per-head q/k RMSNorm, 2 query heads per KV head,
head dim 16).

Every case there that takes the ``config`` or the ``lm`` fixture is
collected here on this file's ``config``, with that file's reference
fixes, tolerances and measured gaps.  Each config has a file of its own
so that the test runner can share the configs out over its workers.
"""
import pytest

torch = pytest.importorskip("torch")

import test_torch_lm as base  # noqa: E402
from test_torch_lm import jax_reference, lm  # noqa: E402,F401  (fixtures)

CONFIG = "qwen3_14b"


@pytest.fixture(scope="module")
def config():
    return CONFIG


globals().update(base.per_config_cases(CONFIG, __file__))
