"""Cached candidate evaluator: accuracy proxy plus static hardware cost.

Counterpart of ``repro.dse.evaluate`` on the port's ``ViT``, run on an
explicit device (the card unless the caller passes the CPU).

Accuracy side: the ``core/search.py`` proxies, unchanged: top-1 argmax
*agreement* with the float (mode "off") model on a calibration batch (the
paper's 1%-budget stand-in without ImageNet in the repository) and cosine
fidelity of the logits.

Cost side, static only, no execution:

* ``weight_bits`` / ``act_bits``: element-count-weighted mean
  ``MXFormat.bits_per_element`` over the model's weight groups, each group
  priced under its scoped config (``q.scoped(scope)``), so a per-layer
  override shows up in proportion to the parameters it covers (the
  paper's Fig. 1b x-axis).  Groups whose scoped mode is "off" are priced
  at float32.
* kernel operations / device-memory bytes / shared memory: the rows of
  the Hopper cost table (``repro_torch.analysis.cost_model``) for the
  deployment kernels (default: the DeiT pair ``matmul-deit`` and
  ``flash-deit``), each row weighted by its ``calls`` (one where the row
  has none: the probe labels) and priced at the act format of each of
  its call sites (``q.scoped(scope).act_fmt``; the candidate's un-scoped
  format for rows without a ``scope``), so the act knobs move the
  matmul kernels' operations and shared memory.  Each int8
  mantissa-plane operand's bytes are scaled by the site's weight bits /
  8 (the mean ``weight_bits`` for rows without a scope), as the
  reference scales them: the table prices planes at one byte an
  element, the paper's hardware stores packed mantissas.  On the H100
  the int8 planes do not shrink, so the scaled bytes are the format's,
  not the card's traffic.  With the ``deit-base-*`` labels the sums are
  one DeiT-Base forward at batch 16.  The reference's
  ``kernel_vmem_bytes`` (a TPU kernel's VMEM residency) is
  ``kernel_smem_bytes`` here: a CTA's shared memory on the card, the
  largest over a label's call sites, summed over the labels.
* ``lut_entries``: total LUT provisioning, the per-table max across
  scopes (shared hardware must fit the widest requested table), summed
  over the three §III-B tables.

Optionally, measured time: ``measure_kernels`` runs the
``telemetry.probes`` twins of the same labels (device-true spans on the
card) and the report carries ``{label: mean_ms}`` beside the predictions.

A candidate whose groups run in kernel mode has its weight planes packed
once per evaluation, each group in its own scoped format (``_params_for``),
so the kernels' wrappers never pack per call.  Every evaluation is cached
on the canonical point key and counted in telemetry (``dse/evaluations``,
``dse/cache_hits``, ``span/dse/eval``; the span is device-true on the
card).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.mx_types import QuantConfig
from repro_torch.core.quantize import MXTensor, pack_weight
from repro_torch.core.search import argmax_agreement, cosine_fidelity
from repro_torch.dse.space import Point, SearchSpace, point_key
from repro_torch.models.model_api import Param
from repro_torch.telemetry import metrics
from repro_torch.telemetry.tracing import span

# the paper's DeiT deployment kernels (same labels as telemetry.probes)
DEFAULT_KERNEL_ROWS: Tuple[str, ...] = ("matmul-deit", "flash-deit")

FLOAT_BITS = 32.0

# the ViT's quantized weights: (param path, scope kind)
_VIT_BLOCK_WEIGHTS = (("attn", "wq"), ("attn", "wk"), ("attn", "wv"),
                      ("attn", "wo"), ("ffn", "wi"), ("ffn", "wo"))


@dataclasses.dataclass(frozen=True)
class CandidateCost:
    """Static hardware-cost vector of one candidate."""

    weight_bits: float          # weighted mean bits/element, weights
    act_bits: float             # weighted mean bits/element, activations
    weight_bytes: int           # total packed weight footprint
    kernel_flops: int           # a forward's, each row times its calls
    kernel_hbm_bytes: int       # traffic, mantissa planes scaled to width
    kernel_smem_bytes: int      # a CTA's shared memory, summed over labels
    lut_entries: int

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class EvalResult:
    key: tuple                  # canonical point key (space.point_key)
    point: Dict[Tuple[str, str], object]
    accuracy: float             # argmax agreement vs float model
    fidelity: float             # cosine fidelity of logits
    cost: CandidateCost

    def as_dict(self) -> dict:
        return {
            "point": [{"scope": s, "knob": n, "value": v}
                      for (s, n), v in sorted(self.point.items())],
            "accuracy": self.accuracy,
            "fidelity": self.fidelity,
            "cost": self.cost.as_dict(),
        }


# ---------------------------------------------------------------------------
# weight groups: (scope tag, element count) per quantizable weight
# ---------------------------------------------------------------------------
def _is_vit(params) -> bool:
    return isinstance(params, dict) and "patch_proj" in params


def weight_groups(cfg, params) -> List[Tuple[str, int]]:
    """(scope, n_elements) for every quantized weight tensor, under the
    same scope tags the model's forward passes to ``q.scoped``."""
    if _is_vit(params):
        return _vit_weight_groups(cfg, params)
    # generic fallback: every large matrix under the un-scoped tag
    total = sum(_leaf_size(p) for p in _matmul_leaves(params))
    return [("*", total)]


def _leaf_size(p) -> int:
    v = getattr(p, "value", p)
    if isinstance(v, MXTensor):
        return int(v.mantissa.numel())
    return int(v.numel())


def _matmul_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _matmul_leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _matmul_leaves(v)
    else:
        v = tree.value
        nd = (v.mantissa if isinstance(v, MXTensor) else v).ndim
        if nd >= 2 and _leaf_size(tree) > 256:
            yield tree


def _vit_weight_groups(cfg, params) -> List[Tuple[str, int]]:
    n = cfg.n_layers
    blocks = params["blocks"]
    attn = sum(_leaf_size(blocks["attn"][k])
               for k in ("wq", "wk", "wv", "wo")) // n
    ffn = sum(_leaf_size(blocks["ffn"][k]) for k in ("wi", "wo")) // n
    out = [("patch", _leaf_size(params["patch_proj"]))]
    for i in range(n):
        out.append((f"block/{i}/attn", attn))
        out.append((f"block/{i}/ffn", ffn))
    out.append(("head", _leaf_size(params["head"])))
    return out


# ---------------------------------------------------------------------------
# static cost
# ---------------------------------------------------------------------------
def _fmt_bits(q: QuantConfig, which: str) -> float:
    if not q.enabled:
        return FLOAT_BITS
    return getattr(q, which).bits_per_element


def _scaled_bytes(row: dict, weight_scale: float) -> int:
    """A row's bytes with its largest int8 operand (the weight mantissa
    plane the table prices at 8 bits) rescaled by ``weight_scale``."""
    int8_ops = [o for o in row["operands"] if o["dtype"] == "int8"]
    mant = max(int8_ops, key=lambda o: o["bytes_traffic"], default=None)
    return sum(int(round(o["bytes_traffic"] * weight_scale)) if o is mant
               else int(o["bytes_traffic"]) for o in row["operands"])


def _call_sites(row: dict) -> List[Tuple[Optional[str], int]]:
    """(scope, calls) of a row's call sites: each of its ``layers`` blocks
    for a ``block/{i}/...`` scope, else its one scope (None: un-scoped)."""
    calls = int(row.get("calls", 1))
    scope = row.get("scope")
    if scope is None or "{i}" not in scope:
        return [(scope, calls)]
    n = int(row["layers"])
    return [(scope.format(i=i), calls // n) for i in range(n)]


def kernel_cost(labels: Sequence[str], q: QuantConfig,
                weight_bits: float) -> Tuple[int, int, int]:
    """(operations, bytes, shared memory) of ``labels``' kernels under
    ``q``: every call site's row at the site's act format, times its
    calls, its mantissa plane scaled to the site's weight bits (rows
    without a scope: ``weight_bits``, the candidate's mean)."""
    from repro_torch.analysis.cost_model import query
    flops = hbm = smem = 0
    for label, base in query(labels).items():
        label_smem = 0
        for scope, calls in _call_sites(base):
            qs = q if scope is None else q.scoped(scope)
            fmt = qs.act_fmt
            row = query([label], act_block=fmt.block_size,
                        act_mant_bits=fmt.mant_bits)[label]
            bits = (weight_bits if scope is None
                    else _fmt_bits(qs, "weight_fmt"))
            flops += calls * int(row["flops"])
            hbm += calls * _scaled_bytes(row, bits / 8.0)
            label_smem = max(label_smem, int(row["smem_bytes"]))
        smem += label_smem
    return flops, hbm, smem


def static_cost(space: SearchSpace, point: Point, groups: Sequence[tuple],
                kernel_rows: Sequence[str] = ()) -> CandidateCost:
    q = space.to_config(point)
    scopes = [s for s, _ in groups]
    total = sum(n for _, n in groups) or 1
    w_bits = sum(n * _fmt_bits(q.scoped(s), "weight_fmt")
                 for s, n in groups) / total
    a_bits = sum(n * _fmt_bits(q.scoped(s), "act_fmt")
                 for s, n in groups) / total

    lut = 0
    for entries in ("ln_lut_entries", "gelu_lut_entries",
                    "softmax_lut_entries"):
        per_scope = []
        for s in scopes:
            qs = q.scoped(s)
            if qs.quantize_nonlinear and qs.nonlinear is not None:
                per_scope.append(getattr(qs.nonlinear, entries))
        lut += max(per_scope, default=0)

    flops = hbm = smem = 0
    if kernel_rows:
        flops, hbm, smem = kernel_cost(kernel_rows, q, w_bits)
    return CandidateCost(
        weight_bits=round(float(w_bits), 4),
        act_bits=round(float(a_bits), 4),
        weight_bytes=int(round(sum(n for _, n in groups) * w_bits / 8.0)),
        kernel_flops=flops,
        kernel_hbm_bytes=hbm,
        kernel_smem_bytes=smem,
        lut_entries=lut,
    )


def measure_kernels(labels: Sequence[str] = DEFAULT_KERNEL_ROWS,
                    repeats: int = 2, device="cuda") -> Dict[str, float]:
    """Measured time of the cost-table labels: the telemetry probe twins,
    device-true spans on the card (on the CPU: the plain versions, the
    plumbing and not the datapath's speed)."""
    from repro_torch.telemetry.probes import run_probes
    return run_probes(labels, repeats=repeats, device=device)


# ---------------------------------------------------------------------------
# the evaluator
# ---------------------------------------------------------------------------
def _runs_kernels(q: QuantConfig, scope: str) -> bool:
    """True where ``scope`` resolves to the Hopper-kernel backend."""
    from repro_torch.datapath import HopperKernelDatapath, resolve
    return isinstance(resolve(q, scope), HopperKernelDatapath)


def _pack(p: Param, q: QuantConfig, scope: str) -> object:
    """The weight of ``p`` (one layer's (K, N)) as the kernel backend of
    ``scope`` takes it: planes in the scope's weight format along K, as
    its wrappers would pack it per call; else as it is."""
    if not _runs_kernels(q, scope):
        return p.value
    return pack_weight(p.value.to(torch.float32),
                       q.scoped(scope).weight_fmt, axis=0)


class Evaluator:
    """Score SearchSpace points, memoized on the canonical point key.

    cfg/params: the ViT (DeiT) model and its float parameters; ``images``
    the calibration batch (NHWC).  Both go to ``device`` (the card unless
    the caller passes the CPU).  The float reference (mode "off") is
    computed once, lazily.
    """

    def __init__(self, space: SearchSpace, cfg, params, images, *,
                 kernel_rows: Sequence[str] = DEFAULT_KERNEL_ROWS,
                 registry: Optional[metrics.Registry] = None,
                 device="cuda"):
        from repro_torch.serving.engine import _device, params_to
        self.device = _device(device, "Evaluator")
        self.space = space
        self.cfg = cfg
        self.params = params_to(params, self.device)
        self.images = torch.as_tensor(images).to(self.device)
        self.groups = weight_groups(cfg, params)
        self.registry = registry or metrics.default_registry()
        self._cache: Dict[tuple, EvalResult] = {}
        self._logits_cache: Dict[tuple, torch.Tensor] = {}
        self._ref = None
        self._rows = tuple(kernel_rows)
        if self._rows:          # unknown labels raise here, not per point
            from repro_torch.analysis.cost_model import query
            query(self._rows)

    def _params_for(self, q: QuantConfig):
        """The parameters a forward under ``q`` runs on: every weight whose
        scope runs in kernel mode packed once, in its scope's format (the
        blocks' stacked weights become per-layer lists)."""
        p = self.params
        if not _is_vit(p):
            return p
        n = self.cfg.n_layers
        blocks = {k: v for k, v in p["blocks"].items()}
        for kind, name in _VIT_BLOCK_WEIGHTS:
            leaf = blocks[kind][name]
            layers = [_pack(Param(leaf.value[i], leaf.axes[1:]), q,
                            f"block/{i}/{kind}") for i in range(n)]
            blocks[kind] = dict(blocks[kind], **{name: Param(layers,
                                                             leaf.axes)})
        out = dict(p, blocks=blocks)
        out["patch_proj"] = Param(_pack(p["patch_proj"], q, "patch"),
                                  p["patch_proj"].axes)
        out["head"] = Param(_pack(p["head"], q, "head"), p["head"].axes)
        return out

    def _logits(self, q: QuantConfig) -> torch.Tensor:
        from repro_torch.models.vit import ViT
        model = ViT(dataclasses.replace(self.cfg, quant=q))
        with torch.no_grad():
            return model.logits(self._params_for(q), self.images)

    @property
    def reference(self) -> torch.Tensor:
        if self._ref is None:
            self._ref = self._logits(QuantConfig(mode="off"))
        return self._ref

    def logits_for(self, point: Point) -> torch.Tensor:
        """Candidate logits on the calibration batch, memoized: the greedy
        driver compares candidates against each other with these (the
        ``core.search`` accept rule), not only against float."""
        key = point_key(point)
        got = self._logits_cache.get(key)
        if got is None:
            self.registry.counter("dse/evaluations").inc()
            with span("dse/eval", registry=self.registry,
                      device=self.device):
                got = self._logits(self.space.to_config(point))
            self._logits_cache[key] = got
        return got

    def __call__(self, point: Point) -> EvalResult:
        key = point_key(point)
        hit = self._cache.get(key)
        if hit is not None:
            self.registry.counter("dse/cache_hits").inc()
            return hit
        out = self.logits_for(point)
        result = EvalResult(
            key=key,
            point=dict(point),
            accuracy=argmax_agreement(out, self.reference),
            fidelity=cosine_fidelity(out, self.reference),
            cost=static_cost(self.space, point, self.groups, self._rows),
        )
        self._cache[key] = result
        return result

    @property
    def n_evaluated(self) -> int:
        return len(self._cache)
