"""The per-config cases of ``test_torch_lm.py`` for Mixtral-8x7B (SMOKE: 4 experts top-2, a 16-slot sliding-window
ring; ``loss`` adds the layers' load-balancing loss).

Every case there that takes the ``config`` or the ``lm`` fixture is
collected here on this file's ``config``, with that file's reference
fixes, tolerances and measured gaps.  Each config has a file of its own
so that the test runner can share the configs out over its workers.
"""
import pytest

torch = pytest.importorskip("torch")

import test_torch_lm as base  # noqa: E402
from test_torch_lm import jax_reference, lm  # noqa: E402,F401  (fixtures)

CONFIG = "mixtral_8x7b"


@pytest.fixture(scope="module")
def config():
    return CONFIG


globals().update(base.per_config_cases(CONFIG, __file__))
