"""Runnable kernel probes keyed by the reference's cost-table labels.

Counterpart of ``repro.telemetry.probes``, with the same four labels, so
that a label still names the same workload.  Each probe runs the port's op
(``repro_torch.kernels.ops``) at the workload's own shape, without the
TPU's padding of lanes to 256 or head dims to 128 (not the Hopper kernels'
geometry), and records its time as a ``span/kernel:<label>/ms`` histogram,
the join key of :func:`repro_torch.telemetry.export.predicted_vs_measured`.

On the card each probe is timed by a device-true span (CUDA events, a sync
at exit).  On the CPU the ops run their plain versions, so probe times
there measure PyTorch's CPU kernels, not the datapath: the plumbing
(spans, join, report) is the same, the numbers mean nothing.

This is the one telemetry module that imports the kernel stack, and only
inside the probe bodies, so ``metrics``/``tracing``/``export`` import
without it.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

from repro_torch.telemetry import metrics
from repro_torch.telemetry.tracing import span


def _data(seed: int, device):
    """(f32 normal tensor maker, int8 plane maker) on ``device``."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(device)

    def ints(lo, hi, *shape):
        return torch.from_numpy(rng.integers(lo, hi, shape).astype(
            np.int8)).to(device)

    return normal, ints


def _probe_matmul_deit(device) -> Callable[[], object]:
    """DeiT-Tiny model-path linear: 2 x 197 tokens, d 192 -> 192, OCP-32
    weight blocks (the reference pads the rows to 400 and the lanes to
    256; sweep twin: ``matmul-deit``)."""
    from repro_torch.kernels import ops
    normal, ints = _data(0, device)
    x, mant, exp = normal(394, 192), ints(-127, 128, 192, 192), \
        ints(-8, 2, 6, 192)
    return lambda: ops.mxint_linear(x, mant, exp, w_block=32,
                                    quantize_act=True, act_block=16,
                                    act_mant_bits=8)


def _probe_flash_deit(device) -> Callable[[], object]:
    """DeiT attention: batch * heads 6, 197 positions, head dim 64, no
    mask, float softmax (the reference pads to 200 x 128 with 256 keys;
    sweep twin: ``flash-deit``)."""
    from repro_torch.kernels import ops
    normal, _ = _data(1, device)
    q, k, v = (normal(1, 6, 197, 64) * 0.1 for _ in range(3))
    return lambda: ops.attention_op(q, k, v, causal=False)


def _probe_matmul_bench(device) -> Callable[[], object]:
    """kernel_bench matmul shape: 128 x 1024 @ 1024 x 512, the paper's
    weight block 256 (sweep twin: ``matmul-bench``)."""
    from repro_torch.kernels import ops
    normal, ints = _data(2, device)
    x, mant, exp = normal(128, 1024), ints(-127, 128, 1024, 512), \
        ints(-8, 2, 4, 512)
    return lambda: ops.mxint_linear(x, mant, exp, w_block=256,
                                    quantize_act=True, act_block=16,
                                    act_mant_bits=8)


def _probe_ln_matmul_bench(device) -> Callable[[], object]:
    """Fused LN -> linear bench shape: 256 x 768 @ 768 x 768, OCP-32
    (sweep twin: ``ln-matmul-bench``)."""
    from repro_torch.kernels import ops
    normal, ints = _data(3, device)
    x, g, b = normal(256, 768), normal(768), normal(768)
    mant, exp = ints(-127, 128, 768, 768), ints(-8, 2, 24, 768)
    return lambda: ops.mxint_ln_linear_op(x, g, b, mant, exp, w_block=32,
                                          act_block=16, mant_bits=8,
                                          lut_bits=5)


PROBES: Dict[str, Callable[..., Callable[[], object]]] = {
    "matmul-deit": _probe_matmul_deit,
    "flash-deit": _probe_flash_deit,
    "matmul-bench": _probe_matmul_bench,
    "ln-matmul-bench": _probe_ln_matmul_bench,
}

# the default pair: the paper's DeiT deployment kernels (matmul and
# attention)
DEFAULT_PROBES: Tuple[str, ...] = ("matmul-deit", "flash-deit")


def run_probes(labels: Sequence[str] = DEFAULT_PROBES, repeats: int = 2,
               registry: Optional[metrics.Registry] = None,
               device="cuda") -> dict:
    """Build each probe's inputs on ``device``, run it once (the first
    call builds the CUDA kernels), then time it ``repeats`` times under a
    ``kernel:<label>`` span.  Returns ``{label: mean_ms}``."""
    import torch
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_probes runs on cuda by default and no CUDA "
                           "device is available; pass device='cpu' to run "
                           "the plain versions")
    reg = registry or metrics.default_registry()
    out = {}
    for label in labels:
        fn = PROBES[label](device)
        fn()
        for _ in range(repeats):
            with span(f"kernel:{label}", registry=reg, device=device):
                fn()
        out[label] = reg.histogram(f"span/kernel:{label}/ms").mean
    return out
