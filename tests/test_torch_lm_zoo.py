"""The cases of ``test_torch_lm.py`` for three more configs: DeepSeek-67B
(3 layers, one KV head for 8 query heads) and the mixture-of-experts
decoders Mixtral-8x7B (4 experts top-2, a 16-slot sliding-window ring)
and Granite-MoE-3B (8 experts top-4, tied embeddings), whose ``loss``
adds the layers' load-balancing loss.

Every case there that runs per config (it takes the ``config`` or the
``lm`` fixture) is collected here as well, on this file's ``config``,
with that file's reference fixes, tolerances and measured gaps.  The
configs live in a file of their own so that the test runner can give the
two files to two workers.
"""
import inspect

import pytest

torch = pytest.importorskip("torch")

import test_torch_lm as base  # noqa: E402
from test_torch_lm import jax_reference, lm  # noqa: E402,F401  (fixtures)

ZOO = ("deepseek_67b", "mixtral_8x7b", "granite_moe_3b_a800m")
assert not set(ZOO) & (set(base.HERE) | set(base.RECURRENT)) and \
    set(ZOO) | set(base.HERE) | set(base.RECURRENT) == set(base.CONFIGS)


@pytest.fixture(scope="module", params=ZOO)
def config(request):
    return request.param


globals().update(
    (name, fn) for name, fn in vars(base).items()
    if name.startswith("test_")
    and {"config", "lm"} & set(inspect.signature(fn).parameters))
