"""The port's example drivers, counterparts of the reference's
``examples/``: run each as ``python -m repro_torch.examples.<name>``.
Every one runs on the card unless given ``--device cpu``, and stops when
it finds no card rather than carry on on the CPU."""
from __future__ import annotations

import torch


def device_arg(name: str) -> torch.device:
    """``--device`` as a device; a card that is not there raises."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("this driver runs on cuda by default and no CUDA "
                         "device is available; pass --device cpu")
    return device
