"""Execution backends for the quantized-op protocol.

One ``Datapath`` instance per execution mode.  ``resolve(q)`` maps a
config to its backend; models reach it through the cached
``QuantConfig.datapath`` and never branch on the mode themselves.

Only "kernel" has a backend in this port so far; every other mode raises
``NotImplementedError`` naming the work queue in ROADMAP.md that brings it.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.datapath.base import Datapath
from repro_torch.datapath.hopper_kernel import HopperKernelDatapath

__all__ = ["Datapath", "HopperKernelDatapath", "resolve", "backends"]

_BACKENDS: Dict[str, Datapath] = {"kernel": HopperKernelDatapath()}

def backends() -> Dict[str, Datapath]:
    """Copy of the mode -> backend registry."""
    return dict(_BACKENDS)


def resolve(q, scope=None) -> Datapath:
    """Backend for the config's execution mode (``scope`` is accepted for
    the reference's signature; the port has no per-scope patches)."""
    mode = getattr(q.scoped(scope), "mode")
    backend = _BACKENDS.get(mode)
    if backend is None:
        raise NotImplementedError(
            f"mode {mode!r} is not ported yet: the sim, packed, off and fake "
            f"backends and nonlinear.py are queued in ROADMAP.md "
            f"('Other backends')")
    return backend
