"""Process-local metrics registry: counters, gauges, histograms.

Counterpart of ``repro.telemetry.metrics``, with the same names, buckets
and ``snapshot()`` shape, so that one record sequence gives the same
snapshot in both packages.  The serving stack records what it did here
(request latency, batch and prefill sizes, queue and slot gauges, kernel
launches per step); ``repro_torch.telemetry.export`` writes it out.

Design constraints:

* **Dependency-free**: stdlib only; this module imports no torch.
  ``tracing``/``export``/``probes`` layer the profiler forwarding, the
  CUDA-event spans and the kernel probes on top.
* **No hidden device sync**: every recording method coerces its argument
  to a host float.  ``float()`` on a CUDA tensor would wait for the device
  without a word, and a hidden sync in the step loop is this port's
  counterpart of a silent recompile.  So a CUDA tensor is refused with
  ``TypeError`` (checked by duck typing: an argument whose
  ``device.type`` is ``"cuda"``).  Record host values at step edges, after
  the readback the step already does.
* **Thread-safe**: one registry lock serializes every mutation, so host
  serving threads can share the default registry.

The module-level default registry is what the serving stack and the
``repro_torch.telemetry`` convenience functions use; construct a private
``Registry`` for isolation (tests, side-by-side experiments).
``Registry.reset()`` *removes* metrics: re-fetch handles through
``counter()``/``gauge()``/``histogram()`` rather than caching them across
resets.
"""
from __future__ import annotations

import bisect
import threading
from typing import Dict, Optional, Sequence, Tuple

# span times in milliseconds: sub-0.1 ms host noise up to 30 s jobs
DEFAULT_MS_BUCKETS: Tuple[float, ...] = (
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
    250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0, 30000.0)
# batch sizes / prompt lengths / image counts / launches: powers of two
# to 64k
DEFAULT_SIZE_BUCKETS: Tuple[float, ...] = tuple(
    float(1 << i) for i in range(17))


def _host_scalar(value) -> float:
    """Coerce to a host float.  A CUDA tensor raises: reading it would
    sync the device."""
    device = getattr(value, "device", None)
    if getattr(device, "type", None) == "cuda":
        raise TypeError(
            "telemetry records host scalars only; a CUDA tensor would sync "
            "the device (read it back where the step already does, then "
            "record the host value)")
    try:
        return float(value)
    except Exception as exc:
        raise TypeError(
            f"telemetry records host scalars only; cannot coerce "
            f"{type(value).__name__}: {exc}") from exc


class Counter:
    """Monotonically increasing named integer."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str, lock: threading.RLock):
        self.name = name
        self._value = 0
        self._lock = lock

    def inc(self, n: int = 1) -> None:
        n = int(_host_scalar(n))
        if n < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease")
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value


class Gauge:
    """Last-write-wins named float (queue depth, slot occupancy)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str, lock: threading.RLock):
        self.name = name
        self._value = 0.0
        self._lock = lock

    def set(self, value) -> None:
        v = _host_scalar(value)
        with self._lock:
            self._value = v

    def add(self, delta) -> None:
        d = _host_scalar(delta)
        with self._lock:
            self._value += d

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Fixed-bucket histogram with sum/count/min/max.

    ``buckets`` are strictly increasing upper bounds; an implicit +inf
    bucket catches overflow, so ``len(counts) == len(buckets) + 1``.
    Bucket boundaries are fixed at creation (Prometheus semantics) — a
    later ``histogram()`` call with different buckets is an error.
    """

    __slots__ = ("name", "buckets", "counts", "_sum", "_count",
                 "_min", "_max", "_lock")

    def __init__(self, name: str, buckets: Sequence[float],
                 lock: threading.RLock):
        b = tuple(float(x) for x in buckets)
        if not b or any(b[i] >= b[i + 1] for i in range(len(b) - 1)):
            raise ValueError(
                f"histogram {name!r} buckets must be strictly "
                f"increasing and non-empty: {b}")
        self.name = name
        self.buckets = b
        self.counts = [0] * (len(b) + 1)
        self._sum = 0.0
        self._count = 0
        self._min: Optional[float] = None
        self._max: Optional[float] = None
        self._lock = lock

    def record(self, value) -> None:
        v = _host_scalar(value)
        idx = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self.counts[idx] += 1
            self._sum += v
            self._count += 1
            self._min = v if self._min is None else min(self._min, v)
            self._max = v if self._max is None else max(self._max, v)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    @property
    def mean(self) -> float:
        with self._lock:
            return self._sum / self._count if self._count else 0.0

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            return {
                "buckets": list(self.buckets),
                "counts": list(self.counts),
                "count": self._count,
                "sum": self._sum,
                "mean": self._sum / self._count if self._count else 0.0,
                "min": self._min,
                "max": self._max,
            }


class Registry:
    """Named metric store.  get-or-create accessors, one lock."""

    def __init__(self):
        self._lock = threading.RLock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    # -- accessors ----------------------------------------------------------
    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name, self._lock)
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name, self._lock)
            return g

    def histogram(self, name: str,
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(
                    name, buckets or DEFAULT_MS_BUCKETS, self._lock)
            elif buckets is not None and tuple(
                    float(b) for b in buckets) != h.buckets:
                raise ValueError(
                    f"histogram {name!r} already exists with buckets "
                    f"{h.buckets}; boundaries are fixed at creation")
            return h

    # -- snapshot / reset ---------------------------------------------------
    def snapshot(self) -> Dict[str, object]:
        """One coherent copy of every metric: ``{"counters": {name:
        int}, "gauges": {name: float}, "histograms": {name: {...}}}``.
        Safe to mutate; json-serializable."""
        with self._lock:
            return {
                "counters": {n: c.value
                             for n, c in sorted(self._counters.items())},
                "gauges": {n: g.value
                           for n, g in sorted(self._gauges.items())},
                "histograms": {n: h.snapshot()
                               for n, h in sorted(
                                   self._histograms.items())},
            }

    def counters_with_prefix(self, prefix: str) -> Dict[str, int]:
        """Non-zero counters under ``prefix``, keyed by the suffix."""
        with self._lock:
            return {n[len(prefix):]: c.value
                    for n, c in self._counters.items()
                    if n.startswith(prefix) and c.value}

    def reset(self, prefix: Optional[str] = None) -> None:
        """Remove metrics (all, or those whose name starts with
        ``prefix``).  Handles obtained before a reset are detached —
        always re-fetch through the accessors."""
        with self._lock:
            for store in (self._counters, self._gauges, self._histograms):
                if prefix is None:
                    store.clear()
                else:
                    for name in [n for n in store if n.startswith(prefix)]:
                        del store[name]


_DEFAULT = Registry()


def default_registry() -> Registry:
    return _DEFAULT
