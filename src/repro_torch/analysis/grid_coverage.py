"""Grid coverage: every output element of a launch is written by exactly
one CTA.  Counterpart of ``repro.analysis.grid_semantics``.

On the TPU the race to rule out is two grid steps accumulating into one
output block under a "parallel" axis; CUDA CTAs run in no order, so here
it is two CTAs writing the same output element, and the gap to rule out
is an element that no CTA writes (``torch.empty`` outputs hold garbage).
The rule reads each ``LaunchRecord``'s tiles, the output rectangle every
CTA writes as the kernel indexes it: rows by column tiles for the GEMM
core (``n_per`` consecutive tiles a CTA), rows for the row kernels, a
(problem, row block, column slice) for decode, (KV head, position block)
for the bf16 flash kernels, and the passes of the grid-stride loop where
``gelu_geometry`` caps the grid; on the generic routes, rows by 128
columns for the GEMMs, 8 rows for the row kernels, and a warp's query row
for the flash kernels (positions of a head, or rows of (B, Hkv, G)).  Every element must be covered exactly
once: K is never split, and one thread owns each output's whole ordered
sum (``kernels/mxint_matmul.py``).

The count runs on the rectangles' compressed coordinates (a difference
array over the distinct row and column bounds), so a sweep record of
tens of millions of elements costs its tile count, not its size.
"""
from __future__ import annotations

from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.analysis.registry import Violation, register_rule
from repro_torch.kernels.launch_record import LaunchRecord


def coverage(rec: LaunchRecord) -> Tuple[np.ndarray, np.ndarray,
                                        np.ndarray]:
    """(row bounds, column bounds, counts): how many tiles write each cell
    of the grid the distinct bounds cut the output into; rectangles are
    clipped to the output."""
    rows, cols = rec.out_shape
    t = rec.tiles()
    t = np.stack([np.clip(t[:, 0], 0, rows), np.clip(t[:, 1], 0, rows),
                  np.clip(t[:, 2], 0, cols), np.clip(t[:, 3], 0, cols)],
                 axis=1) if len(t) else np.zeros((0, 4), np.int64)
    rb = np.unique(np.concatenate([[0, rows], t[:, 0], t[:, 1]]))
    cb = np.unique(np.concatenate([[0, cols], t[:, 2], t[:, 3]]))
    diff = np.zeros((len(rb), len(cb)), np.int64)
    r0, r1 = np.searchsorted(rb, t[:, 0]), np.searchsorted(rb, t[:, 1])
    c0, c1 = np.searchsorted(cb, t[:, 2]), np.searchsorted(cb, t[:, 3])
    np.add.at(diff, (r0, c0), 1)
    np.add.at(diff, (r0, c1), -1)
    np.add.at(diff, (r1, c0), -1)
    np.add.at(diff, (r1, c1), 1)
    counts = diff.cumsum(0).cumsum(1)[:-1, :-1]
    return rb, cb, counts


def dense_mask(rec: LaunchRecord) -> np.ndarray:
    """Writes per output element, element by element (small outputs)."""
    rows, cols = rec.out_shape
    mask = np.zeros((rows, cols), np.int64)
    for r0, r1, c0, c1 in rec.tiles():
        mask[r0:r1, c0:c1] += 1
    return mask


def check_coverage(rec: LaunchRecord) -> List[Violation]:
    rb, cb, counts = coverage(rec)
    area = np.outer(np.diff(rb), np.diff(cb))
    out = []
    where = f"{rec.label or '?'}/{rec.kernel}"
    gap = int(area[counts == 0].sum())
    if gap:
        i, j = np.argwhere(counts == 0)[0]
        out.append(Violation(
            "grid-coverage", where,
            f"{gap} of {rec.out_shape[0] * rec.out_shape[1]} output "
            f"elements are written by no CTA (first: row {rb[i]}, column "
            f"{cb[j]}; grid {rec.grid}): they keep garbage"))
    dup = int(area[counts > 1].sum())
    if dup:
        i, j = np.argwhere(counts > 1)[0]
        out.append(Violation(
            "grid-coverage", where,
            f"{dup} output elements are written by {int(counts.max())} "
            f"CTAs at most (first: row {rb[i]}, column {cb[j]}; grid "
            f"{rec.grid}): a race between CTAs"))
    return out


def check_records(recs: Sequence[LaunchRecord]) -> List[Violation]:
    out: List[Violation] = []
    for rec in recs:
        out.extend(check_coverage(rec))
    return out


@register_rule(
    "grid-coverage",
    "every output element of every launch record of the sweep is written "
    "by exactly one CTA (no gap, no race between CTAs)")
def run(root: Path, device: str = "cuda") -> List[Violation]:
    from repro_torch.analysis.launch_contracts import sweep_records
    return check_records(sweep_records())
