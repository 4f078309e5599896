"""LUT builders for the three non-linear datapaths (paper §III-B).

Host numpy tables, identical entry for entry to the reference's.

* ``rsqrt`` table: 1/sqrt(u) over u in [0.5, 2), bucket midpoints.  Even
  shared exponents index with the variance mantissa in [1, 2), odd ones
  with half of it (paper Eq. 9), so one table serves both.
* ``pow2`` table: 2^r over r in [0, 1), truncation indexing, so r = 0 maps
  to exactly 1.0.
* ``gelu`` table: gelu(x) at bin centres over x in [-a, a).
"""
from __future__ import annotations

import functools
from math import erf

import numpy as np


def gelu_exact(x: np.ndarray) -> np.ndarray:
    """Exact erf-based GELU (paper Eq. 10/11), float64."""
    xs = np.asarray(x, dtype=np.float64)
    return xs * 0.5 * (1.0 + np.vectorize(erf)(xs / np.sqrt(2.0)))


@functools.lru_cache(maxsize=None)
def rsqrt_table(bits: int) -> tuple:
    """2^bits entries of 1/sqrt(u) over u in [0.5, 2), bucket midpoints."""
    n = 2 ** bits
    edges = 0.5 + 1.5 * np.arange(n, dtype=np.float64) / n
    centers = edges + 0.75 / n
    return tuple((1.0 / np.sqrt(centers)).astype(np.float32).tolist())


@functools.lru_cache(maxsize=None)
def pow2_table(bits: int) -> tuple:
    """2^bits entries of 2^r over r in [0, 1), truncation indexing."""
    n = 2 ** bits
    r = np.arange(n, dtype=np.float64) / n
    return tuple(np.exp2(r).astype(np.float32).tolist())


@functools.lru_cache(maxsize=None)
def gelu_table(bits: int, domain: float) -> tuple:
    """2^bits entries of gelu(x) over x in [-domain, domain), midpoints."""
    n = 2 ** bits
    step = 2.0 * domain / n
    centers = -domain + step * (np.arange(n, dtype=np.float64) + 0.5)
    return tuple(gelu_exact(centers).astype(np.float32).tolist())


@functools.lru_cache(maxsize=None)
def silu_table(bits: int, domain: float) -> tuple:
    """2^bits entries of silu(x) over x in [-domain, domain), midpoints
    (the table the reference GELU kernel builds inline for fn='silu')."""
    n = 2 ** bits
    centers = -domain + (2.0 * domain / n) * (np.arange(n) + 0.5)
    return tuple((centers / (1.0 + np.exp(-centers))).astype(np.float32).tolist())


def table_bytes(entries: int, value_bits: int = 16) -> int:
    """Area proxy for DSE tables (the paper counts LUT entries; this counts
    bytes)."""
    return entries * value_bits // 8
