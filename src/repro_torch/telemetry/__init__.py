"""repro_torch.telemetry: runtime metrics, spans, and the
predicted-vs-measured roofline for the port's serving stack.

Counterpart of ``repro.telemetry``, with the same names and snapshot
shape.  It records what the engines, schedulers and kernels did (request
latency, batch and prefill sizes, queue and slot gauges, kernel launches
per step) in one process-local registry, and exports it as JSON,
Prometheus text, or the predicted-vs-measured join.

Convenience surface (all over the default registry)::

    from repro_torch import telemetry as T

    T.counter("serving/requests").inc()
    T.gauge("scheduler/queue_depth").set(len(queue))
    with T.span("serving/classify", device=dev, images=n):
        ...                          # -> span/serving/classify/ms + /images
    snap = T.snapshot()              # coherent dict copy
    T.reset()                        # drop everything (tests)

No hidden device sync: recording a CUDA tensor raises; only a span given a
CUDA ``device`` waits for the card (to read its events).
"""
from repro_torch.telemetry.metrics import (DEFAULT_MS_BUCKETS,  # noqa: F401
                                           DEFAULT_SIZE_BUCKETS, Counter,
                                           Gauge, Histogram, Registry,
                                           default_registry)
from repro_torch.telemetry.tracing import (current_span, span,  # noqa: F401
                                           span_stats, walltime)


def counter(name: str) -> Counter:
    return default_registry().counter(name)


def gauge(name: str) -> Gauge:
    return default_registry().gauge(name)


def histogram(name: str, buckets=None) -> Histogram:
    return default_registry().histogram(name, buckets)


def snapshot() -> dict:
    return default_registry().snapshot()


def reset(prefix: str | None = None) -> None:
    default_registry().reset(prefix)
