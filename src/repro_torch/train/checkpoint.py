"""Fault-tolerant checkpointing: atomic, resumable, elastic in dtype.

Counterpart of ``repro.train.checkpoint``, with its on-disk contract
(one directory per step)::

    <root>/step_000420.tmp/      # written first
        manifest.json            # the tree's leaf paths, dtypes, shapes,
                                 # logical axes, and ``extra`` (the data
                                 # pipeline's state)
        shard_00000.npz          # the leaves as numpy arrays, no pickle
    <root>/step_000420/          # an atomic rename commits the checkpoint
    <root>/LATEST                # the newest committed step, written last

  * atomicity: a crash mid-write leaves only a .tmp directory, never a
    corrupt committed checkpoint; ``restore`` ignores .tmp directories;
  * resumable data: the ``DataState`` rides in the manifest, so the
    stream resumes exactly;
  * elastic restore: leaves are saved whole, with their logical axes,
    and restored into whatever dtype and device the ``like`` tree asks
    for (bf16 leaves are stored as their exact float32 values);
  * retention: ``keep_last`` bounds disk use.

The tree is the port's own (``TrainState`` of ``Param`` trees; the LM's
layers a per-layer list); reading a checkpoint the reference wrote is
not supported.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import telemetry as T
from repro_torch.models.model_api import Param

_STEP_RE = re.compile(r"^step_(\d+)$")


def _flatten(tree, path: str = "") -> List[Tuple[str, Any, Any]]:
    """(path, tensor leaf, logical axes or None) in a fixed order: named
    tuples by field, dicts by sorted key, lists by index; None holds no
    leaf."""
    if isinstance(tree, Param):
        return [(path, tree.value, list(tree.axes))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [l for f in tree._fields
                for l in _flatten(getattr(tree, f), f"{path}.{f}")]
    if isinstance(tree, dict):
        return [l for k in sorted(tree)
                for l in _flatten(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [l for i, v in enumerate(tree)
                for l in _flatten(v, f"{path}[{i}]")]
    if tree is None:
        return []
    return [(path, tree, None)]


def _rebuild(like, leaves: Dict[str, torch.Tensor], path: str = ""):
    if isinstance(like, Param):
        return Param(leaves[path], like.axes)
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(getattr(like, f), leaves,
                                     f"{path}.{f}") for f in like._fields))
    if isinstance(like, dict):
        return {k: _rebuild(v, leaves, f"{path}[{k!r}]")
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, leaves, f"{path}[{i}]")
                          for i, v in enumerate(like))
    if like is None:
        return None
    return leaves[path]


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)              # exact
    return t.cpu().numpy()


@dataclasses.dataclass
class CheckpointManager:
    root: str
    keep_last: int = 3

    def __post_init__(self):
        Path(self.root).mkdir(parents=True, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def save(self, step: int, state, *, extra: Optional[Dict] = None) -> str:
        root = Path(self.root)
        tmp = root / f"step_{step:06d}.tmp"
        final = root / f"step_{step:06d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)

        arrays = {}
        manifest_leaves = []
        for i, (path, leaf, axes) in enumerate(_flatten(state)):
            key = f"leaf_{i:05d}"
            arrays[key] = _to_numpy(leaf)
            manifest_leaves.append({
                "key": key, "path": path,
                "dtype": str(leaf.dtype).replace("torch.", ""),
                "shape": list(leaf.shape), "axes": axes})
        np.savez(tmp / "shard_00000.npz", **arrays)
        manifest = {"step": step, "time": T.walltime(),
                    "leaves": manifest_leaves, "extra": extra or {}}
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)                     # atomic commit
        (root / "LATEST").write_text(str(step))
        self._gc()
        return str(final)

    # -- restore --------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        root = Path(self.root)
        steps = []
        for d in root.iterdir() if root.exists() else []:
            m = _STEP_RE.match(d.name)
            if m and d.is_dir():
                steps.append(int(m.group(1)))
        return max(steps) if steps else None

    def restore(self, like, step: Optional[int] = None,
                device=None) -> Tuple[Any, Dict]:
        """Restore into the structure of ``like`` (a state, or its
        ``abstract_train_state`` on the meta device): each leaf in the
        dtype of ``like``'s leaf, on ``device`` (default: that leaf's
        device; "cuda" for a meta leaf), requiring a gradient where
        ``like``'s leaf does.  Returns (state, extra)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.root}")
        d = Path(self.root) / f"step_{step:06d}"
        manifest = json.loads((d / "manifest.json").read_text())
        by_path = {l["path"]: l for l in manifest["leaves"]}
        leaves = {}
        with np.load(d / "shard_00000.npz", allow_pickle=False) as data:
            for path, leaf, _ in _flatten(like):
                if path not in by_path:
                    raise KeyError(f"checkpoint missing leaf {path}")
                arr = data[by_path[path]["key"]]
                dev = device or (leaf.device if leaf.device.type != "meta"
                                 else "cuda")
                t = torch.from_numpy(arr).to(device=dev, dtype=leaf.dtype)
                if leaf.requires_grad:
                    t.requires_grad_(True)
                leaves[path] = t
        return _rebuild(like, leaves), manifest.get("extra", {})

    # -- retention -----------------------------------------------------------
    def _gc(self):
        root = Path(self.root)
        steps = sorted(
            int(_STEP_RE.match(d.name).group(1))
            for d in root.iterdir()
            if d.is_dir() and _STEP_RE.match(d.name))
        for s in steps[:-self.keep_last] if self.keep_last > 0 else []:
            shutil.rmtree(root / f"step_{s:06d}", ignore_errors=True)
        # clean stale tmp dirs (crashed writers)
        for d in root.glob("step_*.tmp"):
            shutil.rmtree(d, ignore_errors=True)
