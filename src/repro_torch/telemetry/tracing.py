"""Spans over the metrics registry.

Counterpart of ``repro.telemetry.tracing``.  ``span(name, **attrs)`` is a
nestable context manager:

* on exit it records the elapsed time into the histogram
  ``span/<name>/ms`` (and each numeric ``attr`` into ``span/<name>/<attr>``
  with size buckets) in the target registry;
* while open it forwards to ``torch.profiler.record_function(name)``, so a
  span shows in a ``torch.profiler`` trace beside the kernels it launched;
* nesting is tracked per thread (``current_span()``), and the elapsed time
  is ``.elapsed_s``/``.elapsed_ms`` after exit.

Host clock or device events.  A host clock around CUDA work measures the
launches, not the device: PyTorch returns before the card has finished.
So ``span(..., device=d)`` with a CUDA device records a
``torch.cuda.Event`` pair on that device's current stream, synchronizes
the end event at exit and takes the events' elapsed time: the span is
device-true, and it is the one telemetry call that syncs the device.
Without a CUDA device the span reads the host clock, which is device-true
only where the work inside ends in a host readback (the scheduler steps
do).

This module holds the port's only clock reads, in one function
(``_clock``), marked for the ``no-adhoc-timing`` source rule that flags
``time.*`` calls elsewhere under ``src/``.  For plain wall-clock
*timestamps* (request submit stamps) use :func:`walltime`.
"""
from __future__ import annotations

import threading
import time
from typing import Optional

from repro_torch.telemetry import metrics
from repro_torch.telemetry.metrics import (DEFAULT_MS_BUCKETS,
                                           DEFAULT_SIZE_BUCKETS, Registry)

_local = threading.local()

_RECORD_FUNCTION = None
_RECORD_TRIED = False


def _clock(epoch: bool = False) -> float:
    """The port's one clock: epoch seconds, or the monotonic counter that
    host spans subtract."""
    # repro-lint: allow[no-adhoc-timing] the port's single clock read
    return time.time() if epoch else time.perf_counter()


def _record_function_cls():
    """torch.profiler.record_function, resolved once, None without torch."""
    global _RECORD_FUNCTION, _RECORD_TRIED
    if not _RECORD_TRIED:
        _RECORD_TRIED = True
        try:
            from torch.profiler import record_function
            _RECORD_FUNCTION = record_function
        except ImportError:        # pragma: no cover - no-torch processes
            _RECORD_FUNCTION = None
    return _RECORD_FUNCTION


def walltime() -> float:
    """Epoch-seconds timestamp, for metadata such as request submit
    stamps.  Durations of work go through :class:`span`."""
    return _clock(epoch=True)


def _is_cuda(device) -> bool:
    return device is not None and str(device).startswith("cuda")


class span:
    """``with span("serving/classify", images=n): ...``

    Records ``span/serving/classify/ms`` (latency histogram) and
    ``span/serving/classify/images`` (size histogram) on exit.  Attrs must
    be host scalars (a CUDA tensor raises, as the registry says).
    ``device``: a CUDA device makes the span device-true (CUDA events on
    its current stream, a sync at exit); anything else reads the host
    clock.
    """

    __slots__ = ("name", "attrs", "registry", "device", "elapsed_s", "_t0",
                 "_rf", "_events")

    def __init__(self, name: str, registry: Optional[Registry] = None,
                 device=None, **attrs):
        self.name = name
        self.attrs = attrs
        self.registry = registry or metrics.default_registry()
        self.device = device if _is_cuda(device) else None
        self.elapsed_s: Optional[float] = None
        self._t0 = None
        self._rf = None
        self._events = None

    @property
    def elapsed_ms(self) -> Optional[float]:
        return None if self.elapsed_s is None else self.elapsed_s * 1e3

    def _stream(self):
        import torch
        return torch.cuda.current_stream(torch.device(self.device))

    def __enter__(self) -> "span":
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        stack.append(self)
        cls = _record_function_cls()
        if cls is not None:
            try:
                self._rf = cls(self.name)
                self._rf.__enter__()
            except RuntimeError:   # profiler unavailable mid-run: fine
                self._rf = None
        if self.device is not None:
            import torch
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record(self._stream())
        else:
            self._t0 = _clock()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._events is not None:
            start, end = self._events
            end.record(self._stream())
            end.synchronize()
            self.elapsed_s = start.elapsed_time(end) / 1e3
        else:
            self.elapsed_s = _clock() - self._t0
        if self._rf is not None:
            self._rf.__exit__(exc_type, exc, tb)
        _local.stack.pop()
        reg = self.registry
        reg.histogram(f"span/{self.name}/ms",
                      DEFAULT_MS_BUCKETS).record(self.elapsed_ms)
        for key, val in self.attrs.items():
            reg.histogram(f"span/{self.name}/{key}",
                          DEFAULT_SIZE_BUCKETS).record(val)
        return False


def current_span() -> Optional[span]:
    """Innermost open span on this thread, or None."""
    stack = getattr(_local, "stack", None)
    return stack[-1] if stack else None


def span_stats(name: str, registry: Optional[Registry] = None):
    """(count, mean_ms) of a recorded span."""
    reg = registry or metrics.default_registry()
    h = reg.histogram(f"span/{name}/ms", DEFAULT_MS_BUCKETS)
    return h.count, h.mean
