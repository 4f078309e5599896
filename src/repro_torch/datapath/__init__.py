"""Execution backends for the quantized-op protocol.

One ``Datapath`` instance per execution mode:

  "off" / "fake"    -> ``torch_float``   (float; "fake" adds QDQ)
  "sim" / "packed"  -> ``mxint_sim``     (bit-accurate MXInt emulation,
                                          the Tables II-V baselines)
  "kernel"          -> ``hopper_kernel`` (the hand-written Hopper kernels
                                          and the fused LN -> linear)

``resolve(q, scope)`` maps a config to its backend; models reach it
through the cached ``QuantConfig.datapath`` and never branch on the mode
themselves.  ``register_backend`` lets another backend claim a mode.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.datapath.base import Datapath
from repro_torch.datapath.hopper_kernel import HopperKernelDatapath
from repro_torch.datapath.mxint_sim import MXIntSimDatapath
from repro_torch.datapath.torch_float import TorchFloatDatapath

__all__ = ["Datapath", "resolve", "register_backend", "backends",
           "TorchFloatDatapath", "MXIntSimDatapath", "HopperKernelDatapath"]

_BACKENDS: Dict[str, Datapath] = {}


def register_backend(mode: str, backend: Datapath,
                     override: bool = False) -> Datapath:
    """Register ``backend`` for the execution mode ``mode``; registering a
    mode twice raises unless ``override``."""
    if not override and mode in _BACKENDS:
        raise ValueError(f"mode {mode!r} already has backend "
                         f"{_BACKENDS[mode].name!r}")
    _BACKENDS[mode] = backend
    return backend


def backends() -> Dict[str, Datapath]:
    """Copy of the mode -> backend registry."""
    return dict(_BACKENDS)


def resolve(q, scope=None) -> Datapath:
    """Backend for the config's mode, after the overrides of ``scope``
    (a scope whose override swaps the mode resolves to another backend)."""
    mode = getattr(q.scoped(scope), "mode")
    try:
        return _BACKENDS[mode]
    except KeyError:
        raise ValueError(f"no datapath backend registered for mode "
                         f"{mode!r}; known: {sorted(_BACKENDS)}") from None


register_backend("off", TorchFloatDatapath(qdq_linears=False))
register_backend("fake", TorchFloatDatapath(qdq_linears=True))
register_backend("sim", MXIntSimDatapath(qdq_linears=True))
register_backend("packed", MXIntSimDatapath(qdq_linears=False))
register_backend("kernel", HopperKernelDatapath())
