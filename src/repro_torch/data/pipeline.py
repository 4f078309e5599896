"""Deterministic synthetic data pipelines.

Counterpart of ``repro.data.pipeline``: the Markov-chain token stream
the LMs train on (with optional vision embeddings), the frame-to-token
seq2seq stream, and the class-conditional image stream DeiT trains and
the design-space exploration calibrates on.  Production properties kept
even though the data is synthetic:

  * deterministic and seekable: batch i is a pure function of (seed, i),
    so resuming from a checkpoint replays the exact stream (the
    ``DataState`` is part of the checkpoint);
  * host-shardable: each data-parallel host builds only its slice
    (shard_index / num_shards);
  * learnable structure: LM streams are Markov-chain token sequences (so
    a training run shows the loss going down), image streams are
    class-conditional Gaussian blobs (so PTQ experiments have a real
    signal to lose).

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


class SyntheticLMData(_Seekable):
    """Markov-chain token stream with vocab bucketing (learnable
    bigrams): int32 ``tokens`` (b, seq) and, with ``vision_tokens``,
    float32 ``vision_embeds`` (b, vision_tokens, vision_dim)."""

    def __init__(self, *, vocab: int, batch: int, seq_len: int, seed: int = 0,
                 shard_index: int = 0, num_shards: int = 1,
                 vision_tokens: int = 0, vision_dim: int = 0,
                 structure_seed: int = 1234, device="cuda"):
        super().__init__(seed, shard_index, num_shards, device)
        self.vocab = vocab
        self.batch = batch // num_shards
        self.seq = seq_len
        self.vision_tokens = vision_tokens
        self.vision_dim = vision_dim
        # the task (transition structure) is fixed by structure_seed, so
        # train and eval streams with different sample seeds share it
        g = np.random.default_rng(structure_seed)
        self._succ = g.integers(0, vocab, size=(vocab, 4))

    def batch_at(self, index: int) -> Dict[str, torch.Tensor]:
        rng = self._rng_for(index)
        toks = np.empty((self.batch, self.seq), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, self.batch)
        choices = rng.integers(0, 4, size=(self.batch, self.seq))
        noise = rng.random((self.batch, self.seq)) < 0.05
        rand_tok = rng.integers(0, self.vocab, size=(self.batch, self.seq))
        for t in range(1, self.seq):
            nxt = self._succ[toks[:, t - 1], choices[:, t]]
            toks[:, t] = np.where(noise[:, t], rand_tok[:, t], nxt)
        out = {"tokens": torch.from_numpy(toks).to(self.device)}
        if self.vision_tokens:
            emb = rng.normal(size=(self.batch, self.vision_tokens,
                                   self.vision_dim)).astype(np.float32)
            out["vision_embeds"] = torch.from_numpy(emb).to(self.device)
        return out


class SyntheticSeq2SeqData(_Seekable):
    """Frame embeddings -> token targets for the encoder-decoder: int32
    ``tokens`` (b, seq) and float32 ``frames`` (b, seq, d_model)."""

    def __init__(self, *, vocab: int, batch: int, seq_len: int, d_model: int,
                 seed: int = 0, shard_index: int = 0, num_shards: int = 1,
                 device="cuda"):
        super().__init__(seed, shard_index, num_shards, device)
        self.vocab = vocab
        self.batch = batch // num_shards
        self.seq = seq_len
        self.d = d_model

    def batch_at(self, index: int) -> Dict[str, torch.Tensor]:
        rng = self._rng_for(index)
        toks = rng.integers(0, self.vocab,
                            size=(self.batch, self.seq)).astype(np.int32)
        # frames correlate with the tokens (projected one-hot + noise)
        proj = np.random.default_rng(self.state.seed).normal(
            size=(64, self.d)).astype(np.float32)
        frames = proj[toks % 64] + 0.1 * rng.normal(
            size=(self.batch, self.seq, self.d)).astype(np.float32)
        return {"tokens": torch.from_numpy(toks).to(self.device),
                "frames": torch.from_numpy(frames).to(self.device)}


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
