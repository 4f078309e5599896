"""The per-config cases of ``test_torch_lm.py`` for DeepSeek-67B (SMOKE: 3 layers, one KV head for 8 query heads).

Every case there that takes the ``config`` or the ``lm`` fixture is
collected here on this file's ``config``, with that file's reference
fixes, tolerances and measured gaps.  Each config has a file of its own
so that the test runner can share the configs out over its workers.
"""
import pytest

torch = pytest.importorskip("torch")

import test_torch_lm as base  # noqa: E402
from test_torch_lm import jax_reference, lm  # noqa: E402,F401  (fixtures)

CONFIG = "deepseek_67b"


@pytest.fixture(scope="module")
def config():
    return CONFIG


globals().update(base.per_config_cases(CONFIG, __file__))
