"""Declarative per-layer-group search spaces.

Counterpart of ``repro.dse.space``, knob for knob and point for point, on
the port's ``QuantConfig``.

A :class:`SearchSpace` is a base :class:`QuantConfig` plus a tuple of
:class:`GroupSpace` entries — one per layer group, each naming a scope
glob (matched against the tags models pass at their call sites:
``"block/3/ffn"``, ``"head"``, ``"block/*"``...) and the candidate
values for each knob it sweeps.  A *point* assigns one value to every
knob; ``to_config(point)`` turns it into a plain ``QuantConfig`` whose
``overrides`` carry only the assignments that DIFFER from the base —
so the uniform point (every knob at its base value) resolves to the
base config itself, keeping the model's path and its logits bit for bit.

Knobs cover the paper's Fig. 1b / Table V axes: weight/act mantissa
widths and block sizes (``MXFormat``), the execution backend per group
(``mode``, from the ``repro_torch.datapath`` registry — e.g. kernel attention
with sim FFN), and the ``NonlinearConfig`` LUT index widths.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

from repro_torch.core.mx_types import (NonlinearConfig, QuantConfig,
                                       QuantOverride)

# knob name -> (override field it patches, MXFormat/NonlinearConfig
# sub-field or None for a direct QuantOverride field)
KNOBS: Dict[str, Tuple[str, Optional[str]]] = {
    "weight_mant_bits": ("weight_fmt", "mant_bits"),
    "weight_block_size": ("weight_fmt", "block_size"),
    "act_mant_bits": ("act_fmt", "mant_bits"),
    "act_block_size": ("act_fmt", "block_size"),
    "mode": ("mode", None),
    "ln_lut_bits": ("nonlinear", "ln_lut_bits"),
    "gelu_lut_bits": ("nonlinear", "gelu_lut_bits"),
    "softmax_r_bits": ("nonlinear", "softmax_r_bits"),
}


class Knob(NamedTuple):
    scope: str          # the group's scope glob
    name: str           # a KNOBS key
    values: Tuple       # candidate values, in sweep order


# a point assigns one value per knob, keyed by (scope, knob name)
Point = Dict[Tuple[str, str], object]


@dataclasses.dataclass(frozen=True)
class GroupSpace:
    """Candidate values for one layer group's knobs.

    Empty tuples mean "not swept — inherit the base config".  ``scope``
    is an fnmatch glob over the model's scope tags; groups apply in
    declaration order with later groups winning per field, mirroring
    the override resolution of ``QuantConfig.scoped``.
    """

    scope: str
    weight_mant_bits: Tuple[int, ...] = ()
    weight_block_size: Tuple[int, ...] = ()
    act_mant_bits: Tuple[int, ...] = ()
    act_block_size: Tuple[int, ...] = ()
    mode: Tuple[str, ...] = ()
    ln_lut_bits: Tuple[int, ...] = ()
    gelu_lut_bits: Tuple[int, ...] = ()
    softmax_r_bits: Tuple[int, ...] = ()

    def __post_init__(self):
        if not isinstance(self.scope, str) or not self.scope:
            raise ValueError(f"scope must be a non-empty glob string, "
                             f"got {self.scope!r}")
        for name in KNOBS:
            vals = tuple(getattr(self, name))
            if len(set(vals)) != len(vals):
                raise ValueError(f"duplicate candidates for "
                                 f"{self.scope}/{name}: {vals}")
            object.__setattr__(self, name, vals)

    def knobs(self) -> Iterator[Knob]:
        for name in KNOBS:
            vals = getattr(self, name)
            if vals:
                yield Knob(self.scope, name, vals)


@dataclasses.dataclass(frozen=True)
class SearchSpace:
    base: QuantConfig
    groups: Tuple[GroupSpace, ...]

    def __post_init__(self):
        if self.base.has_overrides:
            raise ValueError("the base config of a SearchSpace must be "
                             "override-free; overrides are what the "
                             "space generates")
        object.__setattr__(self, "groups", tuple(self.groups))
        seen = set()
        for g in self.groups:
            for k in g.knobs():
                key = (k.scope, k.name)
                if key in seen:
                    raise ValueError(f"knob {key} declared twice")
                seen.add(key)

    # -- enumeration --------------------------------------------------------
    def knobs(self) -> List[Knob]:
        return [k for g in self.groups for k in g.knobs()]

    def size(self) -> int:
        n = 1
        for k in self.knobs():
            n *= len(k.values)
        return n

    def points(self) -> Iterator[Point]:
        knobs = self.knobs()
        for combo in itertools.product(*[k.values for k in knobs]):
            yield {(k.scope, k.name): v for k, v in zip(knobs, combo)}

    def baseline_point(self) -> Point:
        """The per-knob values matching the base config where available
        (else the first candidate) — the uniform no-override point."""
        out: Point = {}
        for k in self.knobs():
            bv = self._base_value(k.name)
            out[(k.scope, k.name)] = bv if bv in k.values else k.values[0]
        return out

    def random_point(self, rng) -> Point:
        return {(k.scope, k.name): k.values[int(rng.integers(len(k.values)))]
                for k in self.knobs()}

    def mutate(self, point: Point, rng) -> Point:
        """Resample one knob to a different value (identity on a space
        with no multi-valued knob)."""
        knobs = [k for k in self.knobs() if len(k.values) > 1]
        out = dict(point)
        if not knobs:
            return out
        k = knobs[int(rng.integers(len(knobs)))]
        others = [v for v in k.values if v != point[(k.scope, k.name)]]
        out[(k.scope, k.name)] = others[int(rng.integers(len(others)))]
        return out

    # -- materialization ----------------------------------------------------
    def _base_value(self, name: str):
        field, sub = KNOBS[name]
        if sub is None:
            return getattr(self.base, field)
        if field == "nonlinear":
            nl = self.base.nonlinear or NonlinearConfig()
            return getattr(nl, sub)
        return getattr(getattr(self.base, field), sub)

    def to_config(self, point: Point) -> QuantConfig:
        """Materialize a point as a QuantConfig.

        Assignments equal to the base value are dropped; a point with no
        effective assignment returns ``base`` itself (no overrides, same
        path, the same logits bit for bit).
        """
        overrides = []
        base = self.base
        for g in self.groups:
            fmt_patch: Dict[str, Dict[str, object]] = {}
            ov_patch: Dict[str, object] = {}
            for k in g.knobs():
                val = point[(k.scope, k.name)]
                if val not in k.values:
                    raise ValueError(f"value {val!r} not a candidate for "
                                     f"{(k.scope, k.name)}")
                if val == self._base_value(k.name):
                    continue
                field, sub = KNOBS[k.name]
                if sub is None:
                    ov_patch[field] = val
                else:
                    fmt_patch.setdefault(field, {})[sub] = val
            for field, kw in fmt_patch.items():
                if field == "nonlinear":
                    nl = base.nonlinear or NonlinearConfig()
                    ov_patch[field] = dataclasses.replace(nl, **kw)
                else:
                    ov_patch[field] = dataclasses.replace(
                        getattr(base, field), **kw)
            if ov_patch:
                overrides.append((g.scope, QuantOverride(**ov_patch)))
        if not overrides:
            return base
        return dataclasses.replace(base, overrides=tuple(overrides))

    # -- reporting ----------------------------------------------------------
    def describe(self) -> dict:
        """JSON summary for the report header."""
        return {
            "base": self.base.describe(),
            "size": self.size(),
            "groups": [{"scope": g.scope,
                        "knobs": {k.name: list(k.values)
                                  for k in g.knobs()}}
                       for g in self.groups],
        }


def point_key(point: Point) -> tuple:
    """Canonical hashable form of a point (the evaluator cache key and
    the report's candidate id)."""
    return tuple(sorted(((s, n), v) for (s, n), v in point.items()))
