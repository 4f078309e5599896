"""``torch_float`` backend: the "off" and "fake" execution modes.

Counterpart of ``repro.datapath.xla_float``: plain float ops end to end.
"off" is the full-precision reference; "fake" adds quantize-dequantize
with straight-through gradients on the linears' weights and activations,
while the non-linear ops stay float (``quantized_nonlinear`` is False, so
``nl_on`` never fires here).
"""
from __future__ import annotations

from repro_torch.datapath.base import Datapath


class TorchFloatDatapath(Datapath):
    name = "torch_float"
    quantized_nonlinear = False

    def __init__(self, qdq_linears: bool):
        self.qdq_linears = qdq_linears
