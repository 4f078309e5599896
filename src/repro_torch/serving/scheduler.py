"""Continuous-batching request schedulers (host side).

``BatchScheduler`` (token engines) keeps a fixed-width decode batch with
slot-level admission: the KV cache carries a per-row ``cache['index']``,
so a finished row is evicted and the next queued request prefilled into
that row (one batch-1 slot prefill) while the other rows keep decoding.
``admission='wave'`` keeps the whole-batch-drain policy as a baseline.

``ClassifyScheduler`` (ViT engines) packs up to ``batch`` images per step
from the front of the queue, across request boundaries, zero-padding only
the final partial chunk; a request completes when its last image is
classified.  Every step runs the same (batch, H, W, 3) shape.

Both publish to ``repro_torch.telemetry`` under the reference's names:
``scheduler/submitted``/``completed``/``admissions`` counters,
``queue_depth``/``slots_active``/``in_flight`` gauges (conserving
``submitted == completed + in_flight`` at step boundaries),
``request_latency_ms`` histograms, throughput gauges and the step spans.
The port runs eagerly, so the reference's ``serving/recompiles`` has no
counterpart; in its place every engine call folds the kernels' launches
into ``kernel/launches/<kernel>`` and one ``scheduler/kernel_launches``
sample (a launch count that moves from step to step is what a recompile
was on the TPU).
"""
from __future__ import annotations

import contextlib
import dataclasses
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from repro_torch import telemetry as T
from repro_torch.kernels import ops


@contextlib.contextmanager
def _count_launches():
    """Fold the kernel launches of the engine call inside into the
    ``kernel/launches/<kernel>`` counters (created at 0, so a run on the
    CPU, whose plain versions launch nothing, exports them at 0) and one
    sample of ``scheduler/kernel_launches``."""
    before = ops.launch_counts()
    yield
    total = 0
    after = ops.launch_counts()
    for name in ops.SERVED_KERNELS:
        n = after[name] - before[name]
        T.counter(f"kernel/launches/{name}").inc(n)
        total += n
    T.histogram("scheduler/kernel_launches",
                T.DEFAULT_SIZE_BUCKETS).record(total)


@dataclasses.dataclass
class Request:
    """One token-generation request.

    prompt: (s,) int32 token ids; generated: filled by the scheduler;
    done: set on EOS or when ``max_new_tokens`` is reached."""
    uid: int
    prompt: np.ndarray
    max_new_tokens: int = 16
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    _submit_ts: Optional[float] = None  # set by the scheduler at submit


class BatchScheduler:
    """Slot-level continuous batching around a ``ServingEngine``.

    batch_size: the fixed decode width.  eos_id: optional stop token.
    prefill_len: fixed (1, P) slot-prefill shape, prompts right-padded to
    it (a longer prompt raises at ``submit``); ``None`` pads each prompt to
    the next power of two, at least 8.  admission: 'slot' fills every
    freed row at each step; 'wave' waits until the whole batch has
    drained.

    A request's first token comes from its prefill logits, the rest from
    decode steps, the same tokens as serving that request alone.
    """

    def __init__(self, engine, batch_size: int, eos_id: Optional[int] = None,
                 prefill_len: Optional[int] = None, admission: str = "slot"):
        if admission not in ("slot", "wave"):
            raise ValueError(admission)
        self.engine = engine
        self.batch = batch_size
        self.eos = eos_id
        self.prefill_len = prefill_len
        self.admission = admission
        self.queue: deque = deque()
        self.active: List[Optional[Request]] = [None] * batch_size
        self.finished: List[Request] = []
        self._tok = None               # (batch, 1) int32 numpy
        self._cache = None

    def submit(self, req: Request):
        """Enqueue; admitted into the next freed row (FIFO)."""
        if self.prefill_len is not None and \
                len(req.prompt) > self.prefill_len:
            raise ValueError(
                f"prompt length {len(req.prompt)} > prefill_len "
                f"{self.prefill_len}")
        req._submit_ts = T.walltime()
        self.queue.append(req)
        T.counter("scheduler/submitted").inc()
        self._update_gauges()

    def _bucket(self, n: int) -> int:
        """Slot-prefill pad length of an ``n``-token prompt."""
        if self.prefill_len is not None:
            return self.prefill_len
        p = 8
        while p < n:
            p *= 2
        return p

    def _record(self, req: Request, tok: int):
        req.generated.append(tok)
        if (self.eos is not None and tok == self.eos) or \
                len(req.generated) >= req.max_new_tokens:
            req.done = True

    def _update_gauges(self):
        """Publish the queue and slot gauges.  The invariant:
        ``scheduler/submitted == scheduler/completed +
        scheduler/in_flight`` at every step boundary (a done row counts as
        in flight until it is evicted)."""
        slots = sum(1 for r in self.active if r is not None)
        T.gauge("scheduler/queue_depth").set(len(self.queue))
        T.gauge("scheduler/slots_active").set(slots)
        T.gauge("scheduler/in_flight").set(len(self.queue) + slots)

    def _evict(self):
        """Move done requests out of their rows; in wave mode only once
        the whole batch is done."""
        if self.admission == "wave" and \
                any(r is not None and not r.done for r in self.active):
            return
        for i, r in enumerate(self.active):
            if r is not None and r.done:
                self.finished.append(r)
                self.active[i] = None
                T.counter("scheduler/completed").inc()
                T.histogram("scheduler/request_latency_ms",
                            T.DEFAULT_MS_BUCKETS).record(
                    (T.walltime() - r._submit_ts) * 1e3)
        self._update_gauges()

    def _admit(self):
        """Fill free rows from the queue front, one slot prefill each."""
        if not self.queue:
            return
        if self.admission == "wave" and \
                any(r is not None for r in self.active):
            return
        eng = self.engine
        for i in range(self.batch):
            if not self.queue or self.active[i] is not None:
                continue
            req = self.queue.popleft()
            if self._cache is None:
                self._cache = eng.model.cache_init(self.batch,
                                                   eng.cfg.max_len,
                                                   eng.device)
                self._tok = np.zeros((self.batch, 1), np.int32)
            n = len(req.prompt)
            P = self._bucket(n)
            tokens = np.zeros((1, P), np.int32)
            tokens[0, :n] = req.prompt
            T.histogram("serving/prefill_len",
                        T.DEFAULT_SIZE_BUCKETS).record(P)
            # a host span: the step ends in the token's readback, so it
            # holds the device's time too
            with T.span("scheduler/slot_prefill"), _count_launches():
                tok, self._cache = eng._prefill_slot(
                    eng.params, torch.as_tensor(tokens, device=eng.device),
                    n, i, self._cache)
                t = int(tok[0])
            T.counter("scheduler/admissions").inc()
            self.active[i] = req
            self._record(req, t)
            self._tok[i, 0] = t

    def step(self) -> int:
        """Evict, admit, then one decode step across the batch; returns the
        number of live requests.  Empty rows and done-but-not-evicted rows
        decode as padding; their output is discarded."""
        self._evict()
        self._admit()
        live = [r for r in self.active if r is not None and not r.done]
        if not live:
            self._update_gauges()
            return 0
        eng = self.engine
        # a host span: the step ends in the tokens' readback
        with T.span("scheduler/decode_step", live=len(live)) as sp, \
                _count_launches():
            tok, self._cache = eng._decode(
                eng.params, torch.as_tensor(self._tok, device=eng.device),
                self._cache)
            self._tok = tok.cpu().numpy()
        for i, r in enumerate(self.active):
            if r is not None and not r.done:
                self._record(r, int(self._tok[i, 0]))
        T.counter("scheduler/tokens_generated").inc(len(live))
        if sp.elapsed_s:
            T.gauge("scheduler/tokens_per_s").set(len(live) / sp.elapsed_s)
        self._update_gauges()
        return sum(1 for r in self.active if r is not None and not r.done)

    def run(self, max_steps: int = 1024) -> List[Request]:
        """Drain queue and batch; returns every request seen (finished
        first, then any still in a row)."""
        for _ in range(max_steps):
            if self.step() == 0 and not self.queue:
                break
        self._evict()
        return self.finished + [r for r in self.active if r is not None]


@dataclasses.dataclass
class ClassifyRequest:
    """One request of ``images.shape[0]`` images (n, H, W, 3).

    logits / labels: (n, classes) / (n,) numpy, filled as the scheduler
    classifies this request's images; done: set when all n are classified.
    """
    uid: int
    images: np.ndarray
    logits: Optional[np.ndarray] = None
    labels: Optional[np.ndarray] = None
    done: bool = False
    _next: int = 0                     # images admitted so far
    _submit_ts: Optional[float] = None  # set by the scheduler at submit


class ClassifyScheduler:
    """FIFO continuous batching around a ``ViTServingEngine``.

    batch_size defaults to the engine's ``ServeConfig.batch``.
    """

    def __init__(self, engine, batch_size: Optional[int] = None):
        self.engine = engine
        self.batch = batch_size or engine.cfg.batch
        self.n_classes = int(engine.model.cfg.n_classes)
        self.queue: deque = deque()
        self.finished: List[ClassifyRequest] = []

    def submit(self, req: ClassifyRequest):
        """Enqueue; its images are admitted, possibly over several steps,
        in FIFO order.  A zero-image request completes in queue order with
        empty results."""
        req._submit_ts = T.walltime()
        self.queue.append(req)
        T.counter("scheduler/submitted").inc()
        self._update_gauges()

    def _update_gauges(self):
        """A classifier holds no rows: in flight is the queue (the same
        invariant as ``BatchScheduler``'s)."""
        T.gauge("scheduler/queue_depth").set(len(self.queue))
        T.gauge("scheduler/in_flight").set(len(self.queue))

    def _evict_completed(self):
        while self.queue and \
                self.queue[0]._next >= self.queue[0].images.shape[0]:
            req = self.queue.popleft()
            if req.logits is None:             # zero-image request
                req.logits = np.zeros((0, self.n_classes), np.float32)
                req.labels = np.zeros((0,), np.int64)
            req.done = True
            self.finished.append(req)
            T.counter("scheduler/completed").inc()
            T.histogram("scheduler/request_latency_ms",
                        T.DEFAULT_MS_BUCKETS).record(
                (T.walltime() - req._submit_ts) * 1e3)
        self._update_gauges()

    def step(self) -> int:
        """Classify up to ``batch`` images off the queue front; returns the
        number classified (0 when the queue is empty)."""
        self._evict_completed()
        take = []                              # (request, image index)
        for req in self.queue:
            while len(take) < self.batch and \
                    req._next < req.images.shape[0]:
                take.append((req, req._next))
                req._next += 1
            if len(take) >= self.batch:
                break
        if not take:
            return 0
        img = take[0][0].images
        chunk = np.zeros((self.batch,) + img.shape[1:], np.float32)
        for j, (req, i) in enumerate(take):
            chunk[j] = req.images[i]
        # a host span: the step ends in the logits' readback
        with T.span("scheduler/classify_step", images=len(take)) as sp, \
                _count_launches():
            logits = self.engine.logits_batch(chunk).float().cpu().numpy()
        # the rows filled this step (the rest of the batch is padding)
        T.gauge("scheduler/slots_active").set(len(take))
        T.counter("scheduler/images_classified").inc(len(take))
        if sp.elapsed_s:
            T.gauge("scheduler/images_per_s").set(len(take) / sp.elapsed_s)
        for j, (req, i) in enumerate(take):
            if req.logits is None:
                n = req.images.shape[0]
                req.logits = np.zeros((n, logits.shape[-1]), logits.dtype)
                req.labels = np.zeros((n,), np.int64)
            req.logits[i] = logits[j]
            req.labels[i] = int(np.argmax(logits[j]))
        self._evict_completed()
        return len(take)

    def run(self, max_steps: int = 4096) -> List[ClassifyRequest]:
        """Drain the queue; returns the finished requests in completion
        order."""
        for _ in range(max_steps):
            if self.step() == 0:
                break
        return self.finished
