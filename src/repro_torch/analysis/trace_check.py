"""The kernel-mode trace check: what runs outside the kernels.

Counterpart of ``repro.analysis.trace_lint``.  The reference walks a
jaxpr and never enters a ``pallas_call``; here a ``TorchDispatchMode``
records every aten op a target runs, and each kernel op of
``ops.LAUNCH_COUNTERS`` is wrapped (as ``models.launches.count_calls``
wraps them) so that the ops inside its extent are the kernel's (on the
CPU its plain version) and are not checked.  What runs outside them is
the float path leaking back in.

Per target (``TraceRules``):

* ``deny_outside_kernels``: {op: least operand rank}.  In kernel mode:
  ``exp`` at rank 2 or more (RoPE's frequency ladder is a rank-1 ``exp``
  in every mode), ``erf``, ``erfinv``, ``sigmoid`` at any rank, and the
  composite ops that would hide them (``_softmax``, ``_log_softmax``,
  ``gelu``, ``silu``, ``native_layer_norm``).
* ``forbid_softmax_chain``: an ``exp`` whose input comes, within a few
  ops, from an ``amax`` or ``max`` and whose output feeds a ``sum`` is a
  softmax whatever its name.
* ``forbid_f64``: no float64 tensor outside the extents of
  ``F64_ALLOWED`` (each with its reason).  The non-kernel backends'
  float64 products are their stated deviation; their targets allow them.
* ``kernel_calls``: the kernel calls by name, which must equal the
  reference's ``pallas_call`` count of the same target, kernel by kernel.
* ``allowed_dtypes``: the closed dtype set of the target; each dtype
  beyond the reference's {bool, float32, int32, int8} is listed in
  ``EXTRA_DTYPES`` with the op that needs it.

The four targets are the reference's: DeiT-Micro at 1 layer in kernel
mode on packed planes (11 kernel calls), the decode step with per-row
indices [7, 4] (5), the slot prefill plus a decode step (17), and the
softmax, GELU and LayerNorm ops through each of the five modes (1 in
kernel mode, 0 in the others).  Every entry runs on the card by default
(``device="cuda"``; it raises without one): the targets launch the
kernels, and the kernels' launch counters must agree with the calls.
With ``device="cpu"`` the plain versions run inside the extents.
"""
from __future__ import annotations

import contextlib
import dataclasses
from pathlib import Path
from typing import Callable, Dict, FrozenSet, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.analysis.registry import (Violation, register_rule,
                                           require_device)

# kernel-mode nonlinear rules: the Eq. 14-20 softmax, the LUT GELU and the
# LN rsqrt all run inside the kernels
KERNEL_NL_DENY: Tuple[Tuple[str, int], ...] = (
    ("exp", 2), ("erf", 0), ("erfinv", 0), ("sigmoid", 0),
    ("_softmax", 0), ("_log_softmax", 0), ("gelu", 0), ("silu", 0),
    ("native_layer_norm", 0))

# the ops an exp's input may pass through after the max that stabilizes
# it, and its output before the sum that normalizes it
_CHAIN_THROUGH = frozenset({
    "sub", "add", "mul", "div", "maximum", "minimum", "clamp", "where",
    "neg", "_to_copy", "to", "expand", "view", "reshape", "unsqueeze",
    "squeeze", "transpose", "permute", "clone", "contiguous", "select",
    "slice", "index"})
_MAXES = frozenset({"amax", "max"})

# the functions ("module:name") whose extent may hold float64 tensors in
# kernel mode, with the reason
F64_ALLOWED: Dict[str, str] = {
    "repro_torch.kernels.ops:_paper_softmax_attention":
        "the whole-row attention's score and P.V products run in float64 "
        "and round once to float32, so that they do not depend on the "
        "device's summation order (ROADMAP §3)",
    "repro_torch.models.attention:_q_chunked_attention":
        "the cache prefill's q-chunked online softmax (the float body the "
        "reference also runs there) takes its score and P.V products in "
        "float64 and rounds once to float32, the same float64 products as "
        "the whole-row attention's (ROADMAP §3)",
    "repro_torch.models.layers:rope":
        "cos and sin of the float32 RoPE angles run in float64 and round "
        "once: the correctly rounded values, the same on every device (a "
        "CPU and a GPU float32 cos differ in the last bit)",
}

# dtypes beyond the reference's {bool, float32, int32, int8}, by the op
# that needs them
EXTRA_DTYPES: Dict[str, str] = {
    "int64": "torch's indices: arange, argmax, nonzero and index_put take "
             "or give int64 (the reference's jnp takes int32)",
}
BASE_DTYPES = frozenset({"bool", "float32", "int32", "int8"})


@dataclasses.dataclass(frozen=True)
class TraceRules:
    deny_outside_kernels: Tuple[Tuple[str, int], ...] = ()
    forbid_softmax_chain: bool = False
    forbid_f64: bool = True
    kernel_calls: Optional[Dict[str, int]] = None
    allowed_dtypes: Optional[FrozenSet[str]] = None


@dataclasses.dataclass
class Event:
    op: str
    ins: List[int]               # ids of the input tensors
    outs: List[int]
    rank: int                    # the largest operand rank
    dtypes: Tuple[str, ...]
    f64_ok: bool


def _name(func) -> str:
    """The aten op's name, in-place variants as their op (exp_ as exp)."""
    return func.overloadpacket.__name__.rstrip("_")


class _Recorder(TorchDispatchMode):
    """Records the aten ops run outside every kernel op's extent."""

    def __init__(self, state):
        super().__init__()
        self.state = state
        self.events: List[Event] = []
        self.keep: list = []           # keeps ids unique while recording

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.state["kernel"] == 0:
            ins = [a for a in tree_flatten((args, kwargs or {}))[0]
                   if isinstance(a, torch.Tensor)]
            outs = [a for a in tree_flatten(out)[0]
                    if isinstance(a, torch.Tensor)]
            self.keep.extend(ins + outs)
            self.events.append(Event(
                _name(func), [id(t) for t in ins], [id(t) for t in outs],
                max([t.dim() for t in ins] or [0]),
                tuple(sorted({str(t.dtype).replace("torch.", "")
                              for t in ins + outs})),
                self.state["f64"] > 0))
        return out


@contextlib.contextmanager
def trace():
    """(events, calls): the aten ops outside the kernel ops' extents, and
    the kernel ops' calls by name, of the code run inside."""
    import importlib

    from repro_torch.kernels import ops
    state = {"kernel": 0, "f64": 0}
    calls = dict.fromkeys(ops.LAUNCH_COUNTERS, 0)
    sites = [(ops, n, "kernel") for n in calls] + [
        (importlib.import_module(site.split(":")[0]), site.split(":")[1],
         "f64") for site in F64_ALLOWED]
    saved = [(mod, n, key, getattr(mod, n)) for mod, n, key in sites]

    def extent(name, fn, key):
        def wrapper(*a, **k):
            if key == "kernel":
                calls[name] += 1
            state[key] += 1
            try:
                return fn(*a, **k)
            finally:
                state[key] -= 1
        return wrapper

    for mod, n, key, fn in saved:
        setattr(mod, n, extent(n, fn, key))
    rec = _Recorder(state)
    try:
        with rec:
            yield rec.events, calls
    finally:
        for mod, n, _, fn in saved:
            setattr(mod, n, fn)


def _softmax_chains(events: List[Event]) -> List[str]:
    producer: Dict[int, Event] = {}
    consumers: Dict[int, List[Event]] = {}
    for e in events:
        for t in e.outs:
            producer[t] = e
        for t in e.ins:
            consumers.setdefault(t, []).append(e)
    found = []
    for e in events:
        if e.op != "exp":
            continue
        saw_max, frontier = False, list(e.ins)
        for _ in range(4):
            nxt = []
            for t in frontier:
                p = producer.get(t)
                if p is None:
                    continue
                if p.op in _MAXES:
                    saw_max = True
                elif p.op in _CHAIN_THROUGH:
                    nxt.extend(p.ins)
            frontier = nxt
            if saw_max or not frontier:
                break
        if not saw_max:
            continue
        frontier, hit = list(e.outs), False
        for _ in range(4):
            nxt = []
            for t in frontier:
                for c in consumers.get(t, ()):
                    if c.op == "sum":
                        hit = True
                    elif c.op in _CHAIN_THROUGH:
                        nxt.extend(c.outs)
            if hit or not nxt:
                break
            frontier = nxt
        if hit:
            found.append("exp(x - max) ... sum: a float softmax outside the "
                         "kernels")
    return found


def check_events(events: List[Event], calls: Dict[str, int],
                 rules: TraceRules, label: str) -> List[Violation]:
    out: List[Violation] = []

    def bad(msg):
        out.append(Violation("trace-invariants", label, msg))

    deny = dict(rules.deny_outside_kernels)
    seen = set()
    f64_seen = bad_dtypes = False
    for e in events:
        if e.op in deny and e.rank >= deny[e.op] and e.op not in seen:
            seen.add(e.op)
            bad(f"denied op '{e.op}' (operand rank {e.rank}) outside the "
                f"kernels")
        if rules.forbid_f64 and "float64" in e.dtypes and not e.f64_ok \
                and not f64_seen:
            f64_seen = True
            bad(f"float64 leak: {e.op} touches a float64 tensor outside "
                f"the allowed extents ({', '.join(F64_ALLOWED)})")
        if rules.allowed_dtypes is not None and not bad_dtypes:
            extra = set(e.dtypes) - rules.allowed_dtypes
            if extra:
                bad_dtypes = True
                bad(f"unexpected dtype {sorted(extra)} at {e.op} (allowed: "
                    f"{sorted(rules.allowed_dtypes)})")
    if rules.forbid_softmax_chain:
        for msg in _softmax_chains(events):
            bad(msg)
            break
    if rules.kernel_calls is not None:
        got = {n: c for n, c in calls.items() if c}
        want = {n: c for n, c in rules.kernel_calls.items() if c}
        if got != want:
            bad(f"kernel calls {got} != {want}: a kernel was dropped from "
                f"or duplicated in the structure")
    return out


def check_fn(fn: Callable[[], object], rules: TraceRules, label: str,
             device: str = "cuda") -> List[Violation]:
    """Trace ``fn()`` and check it; on the card the kernels' launch
    counters must also equal the calls."""
    from repro_torch.kernels import ops
    require_device(device)
    before = ops.launch_counts()
    with trace() as (events, calls):
        fn()
    out = check_events(events, calls, rules, label)
    if device != "cpu":
        torch.cuda.synchronize()
        launched = {n: c - before[n] for n, c in ops.launch_counts().items()}
        if launched != calls:
            out.append(Violation(
                "trace-invariants", label,
                f"launch counters {launched} != kernel calls {calls}"))
    return out


# ---------------------------------------------------------------------------
# the targets
# ---------------------------------------------------------------------------
def _kernel_q():
    from repro_torch.core.mx_types import QuantConfig
    return QuantConfig(mode="kernel", quantize_nonlinear=True)


def _calls(**c) -> Dict[str, int]:
    from repro_torch.kernels import ops
    out = dict.fromkeys(ops.LAUNCH_COUNTERS, 0)
    out.update(c)
    return out


# every target's closed set: float64 within the allowed extents (kernel
# mode) or as the float backends' stated deviation
KERNEL_DTYPES = BASE_DTYPES | frozenset(EXTRA_DTYPES) | {"float64"}

# DeiT-Micro in kernel mode, 1 layer: the patch linear, 3 fused LN -> q, k,
# v, the whole-row softmax, the out-projection, the fused LN -> wi, the
# GELU, wo, the final LN and the head (11, by kernel)
DEIT_CALLS = dict(mxint_matmul=4, mxint_ln_matmul=4, mxint_softmax=1,
                  mxint_gelu=1, mxint_layernorm=1)
# q, k, v projections, the decode kernel, wo
DECODE_CALLS = dict(mxint_matmul=4, flash_attention_decode=1)
# a slot prefill (3 fused LN -> q, k, v, wo, LN -> wi, GELU, wo2, the final
# norm: 8; its attention is float by design) and a decode step (the same
# with the decode kernel: 9)
SLOT_STEP_CALLS = dict(mxint_ln_matmul=8, mxint_matmul=4, mxint_gelu=2,
                       mxint_layernorm=2, flash_attention_decode=1)


def _small_lm_cfg():
    from repro_torch.models.model_api import ModelConfig
    return ModelConfig(n_layers=1, d_model=64, n_heads=4, n_kv_heads=2,
                       d_ff=128, vocab=100, ffn_kind="gelu",
                       dtype=torch.float32)


def deit_target(device: str = "cuda"):
    from repro_torch.configs import deit
    from repro_torch.core.mx_types import MXINT6_WEIGHT
    from repro_torch.models.vit import ViT
    from repro_torch.serving.engine import pack_params_mxint
    cfg = dataclasses.replace(deit.DEIT_MICRO, n_layers=1, n_classes=10,
                              quant=_kernel_q())
    m = ViT(cfg)
    params = pack_params_mxint(m.init(0, device=device), MXINT6_WEIGHT)
    imgs = torch.zeros((1, cfg.image_size, cfg.image_size, 3),
                       device=device)
    rules = TraceRules(deny_outside_kernels=KERNEL_NL_DENY,
                       forbid_softmax_chain=True,
                       kernel_calls=_calls(**DEIT_CALLS),
                       allowed_dtypes=KERNEL_DTYPES)
    return [("deit-micro-forward[kernel]",
             lambda: m.logits(params, imgs), rules)]


def decode_target(device: str = "cuda"):
    from repro_torch.models import attention as A
    from repro_torch.models.transformer import init_params
    cfg = _small_lm_cfg()
    p = init_params(A.attn_param_spec(cfg), {}, torch.float32,
                    device=device)
    x = torch.zeros((2, 1, 64), device=device)
    cache = A.init_kv_cache(cfg, 2, 32, 0, torch.float32, device)
    idx = torch.tensor([7, 4], dtype=torch.int32, device=device)
    rules = TraceRules(deny_outside_kernels=KERNEL_NL_DENY,
                       forbid_softmax_chain=True,
                       kernel_calls=_calls(**DECODE_CALLS),
                       allowed_dtypes=KERNEL_DTYPES)
    return [("decode-step[kernel]",
             lambda: A.attention(p, x, cfg, quant=_kernel_q(), cache=cache,
                                 cache_index=idx), rules)]


def slot_step_target(device: str = "cuda"):
    """The slot scheduler's mixed step: a batch-1 slot prefill scattered
    into the live cache, then a decode step of the whole batch.  As in the
    reference: the kernel calls and the float64 check, no denied ops,
    because the prefill's attention is the float q-chunked softmax by
    design (the decode phase's rules are ``decode_target``'s)."""
    from repro_torch.models.transformer import DecoderLM
    from repro_torch.serving.engine import (make_decode_step,
                                            make_slot_prefill_step)
    kq = _kernel_q()
    model = DecoderLM(dataclasses.replace(_small_lm_cfg(), quant=kq))
    packed = model.init(0, device=device, pack_fmt=kq.weight_fmt)
    slot_prefill = make_slot_prefill_step(model, 32, device)
    decode = make_decode_step(model)
    cache = model.cache_init(2, 32, device)
    tokens = torch.zeros((1, 8), dtype=torch.int32, device=device)
    tok = torch.zeros((2, 1), dtype=torch.int32, device=device)

    def mixed():
        _, c = slot_prefill(packed, tokens, 5, 1, cache)
        return decode(packed, tok, c)

    rules = TraceRules(kernel_calls=_calls(**SLOT_STEP_CALLS),
                       allowed_dtypes=KERNEL_DTYPES)
    return [("slot-prefill+decode-step[kernel]", mixed, rules)]


def backend_op_targets(device: str = "cuda"):
    """softmax, GELU and LayerNorm through every mode: exactly one kernel
    call each in kernel mode with the float nonlinears kept out of the
    trace around it; no kernel call in the others (whose float64 products
    are their stated deviation)."""
    from repro_torch.core.mx_types import MODES, QuantConfig
    from repro_torch.models.model_api import Param
    out = []
    x = torch.zeros((32, 64), device=device)
    gamma = Param(torch.ones(64, device=device), (None,))
    beta = Param(torch.zeros(64, device=device), (None,))
    for mode in MODES:
        q = QuantConfig(mode=mode, quantize_nonlinear=True)
        dp = q.datapath
        for op, name, fn in (
                ("softmax", "mxint_softmax",
                 lambda dp=dp, q=q: dp.softmax(x, q=q)),
                ("gelu", "mxint_gelu",
                 lambda dp=dp, q=q: dp.act(x, "gelu", q=q)),
                ("layernorm", "mxint_layernorm",
                 lambda dp=dp, q=q: dp.layernorm(x, gamma, beta, q=q))):
            if mode == "kernel":
                rules = TraceRules(deny_outside_kernels=KERNEL_NL_DENY,
                                   forbid_softmax_chain=True,
                                   kernel_calls=_calls(**{name: 1}),
                                   allowed_dtypes=KERNEL_DTYPES)
            else:
                rules = TraceRules(forbid_f64=False, kernel_calls=_calls(),
                                   allowed_dtypes=KERNEL_DTYPES)
            out.append((f"{op}[{mode}]", fn, rules))
    return out


# each builds its (label, fn, rules) targets on a device
TARGETS: Tuple[Callable[..., list], ...] = (
    deit_target, decode_target, slot_step_target, backend_op_targets)


def targets(device: str = "cuda"):
    require_device(device)
    return [t for build in TARGETS for t in build(device)]


def target_calls(device: str = "cuda") -> Dict[str, Dict[str, int]]:
    """label -> the kernel calls of that target, by kernel name."""
    out = {}
    for label, fn, _ in targets(device):
        with torch.no_grad(), trace() as (_, calls):
            fn()
        out[label] = {n: c for n, c in calls.items() if c}
    return out


@register_rule(
    "trace-invariants",
    "kernel-mode aten traces: no float softmax, GELU, LayerNorm or "
    "float64 outside the kernels, the kernel calls of each target equal "
    "to the reference's pallas_call counts (DeiT-Micro 11, decode 5, slot "
    "prefill + decode 17, each backend op 1 or 0)")
def run(root: Path, device: str = "cuda") -> List[Violation]:
    out: List[Violation] = []
    for label, fn, rules in targets(device):
        with torch.no_grad():
            out.extend(check_fn(fn, rules, label, device))
    return out
