"""Continuous batching for stateless classification.

``ClassifyScheduler`` packs up to ``batch`` images per step from the
front of the queue, across request boundaries, zero-padding only the
final partial chunk; a request completes when its last image is
classified.  Every step runs the same (batch, H, W, 3) shape.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import List, Optional

import numpy as np


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
        self.queue.append(req)

    def _evict_completed(self):
        while self.queue and \
                self.queue[0]._next >= self.queue[0].images.shape[0]:
            req = self.queue.popleft()
            if req.logits is None:             # zero-image request
                req.logits = np.zeros((0, self.n_classes), np.float32)
                req.labels = np.zeros((0,), np.int64)
            req.done = True
            self.finished.append(req)

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
        logits = self.engine.logits_batch(chunk).float().cpu().numpy()
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
