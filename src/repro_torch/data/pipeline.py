"""Deterministic synthetic image data.

Counterpart of ``repro.data.pipeline`` for the image stream the DeiT
design-space exploration calibrates on (the LM and seq2seq streams wait
for the training slice).  Production properties kept even though the data
is synthetic:

  * deterministic and seekable: batch i is a pure function of (seed, i),
    so resuming from a checkpoint replays the exact stream (the
    ``DataState`` is part of the checkpoint);
  * host-shardable: each data-parallel host builds only its slice
    (shard_index / num_shards);
  * learnable structure: class-conditional Gaussian blobs, so PTQ
    experiments have a real signal to lose.

The generator is numpy's, seeded exactly as the reference seeds it, so
both packages yield the same batches bit for bit; the port hands them to
torch on an explicit ``device`` (the card unless the caller passes the
CPU).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch


@dataclasses.dataclass
class DataState:
    seed: int
    next_index: int

    def to_dict(self):
        return {"seed": self.seed, "next_index": self.next_index}

    @classmethod
    def from_dict(cls, d):
        return cls(seed=int(d["seed"]), next_index=int(d["next_index"]))


class _Seekable:
    def __init__(self, seed: int, shard_index: int = 0, num_shards: int = 1,
                 device="cuda"):
        self.state = DataState(seed=seed, next_index=0)
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.device = torch.device(device)

    def _rng_for(self, index: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence(
                entropy=self.state.seed,
                spawn_key=(index, self.shard_index)))

    def batch_at(self, index: int) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def next_batch(self) -> Dict[str, torch.Tensor]:
        b = self.batch_at(self.state.next_index)
        self.state.next_index += 1
        return b

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        while True:
            yield self.next_batch()


class SyntheticImageData(_Seekable):
    """Class-conditional Gaussian-blob images (learnable 10..1000-way),
    NHWC float32, on ``device``."""

    def __init__(self, *, n_classes: int, batch: int, image_size: int,
                 seed: int = 0, shard_index: int = 0, num_shards: int = 1,
                 structure_seed: int = 1234, noise: float = 0.35,
                 outlier_channels: bool = False, class_sep: float = 1.0,
                 device="cuda"):
        super().__init__(seed, shard_index, num_shards, device)
        self.n_classes = n_classes
        self.batch = batch // num_shards
        self.hw = image_size
        self.noise = noise
        # class prototypes are the TASK: fixed by structure_seed, shared by
        # train and eval streams whatever their sample seed.  class_sep < 1
        # makes classes share a base pattern with small per-class deltas:
        # thin decision margins, so quantization error shows in accuracy
        # (the paper's Table V regime).
        g = np.random.default_rng(structure_seed)
        base = g.normal(size=(1, 8, 8, 3)).astype(np.float32)
        delta = g.normal(size=(n_classes, 8, 8, 3)).astype(np.float32)
        if outlier_channels:
            # the outlier channel carries no class information, like the
            # high-magnitude, class-uninformative activation dims of real
            # ViTs
            delta[..., 2] = 0.0
        self._proto = base + class_sep * delta
        # heavy-tailed channel scales emulate the activation outliers of
        # real ViTs that break per-tensor int quantization
        self._scale = (np.asarray([1.0, 1.0, 24.0], np.float32)
                       if outlier_channels else np.ones(3, np.float32))

    def batch_at(self, index: int) -> Dict[str, torch.Tensor]:
        rng = self._rng_for(index)
        labels = rng.integers(0, self.n_classes, self.batch).astype(np.int32)
        base = self._proto[labels]                      # (b, 8, 8, 3)
        reps = self.hw // 8
        img = np.repeat(np.repeat(base, reps, axis=1), reps, axis=2)
        img = img + self.noise * rng.normal(size=img.shape).astype(np.float32)
        img = img * self._scale
        return {"images": torch.from_numpy(img).to(self.device),
                "labels": torch.from_numpy(labels).to(self.device)}
