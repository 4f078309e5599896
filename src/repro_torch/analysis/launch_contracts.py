"""Launch contracts: every launch the kernel wrappers make fits the card.

Counterpart of ``repro.analysis.kernel_contracts``, whose capture of each
``pallas_call`` and VMEM, tile and index-map contracts become, on the
H100, the wrappers' ``LaunchRecord``s (``kernels/launch_record.py``) and
the limits of a CUDA launch.  Each kernel module's ``launch_config(...)``
builds the record its wrapper launches from; on the CPU this rule calls
those functions over the sweep, and on the card ``record_launches()``
collects the records of real launches (``chip_smoke.py``'s analysis
phase also holds each record against the C host code's own values,
``kernels/launch_fixture.query``).

Contracts, per record (the limits are the H100's; ``chip_smoke.py``
reads the card's attributes and fails unless they equal these):

1. dynamic plus static shared memory at most ``SMEM_PER_BLOCK_OPTIN``;
2. where the geometry assumes ``per_sm`` CTAs on an SM, that many fit the
   SM's shared memory (each with the runtime's reserved kilobyte) and its
   threads;
3. threads a CTA at most 1024 and a whole number of warps;
4. grid x at most 2^31 - 1, y and z at most 65,535;
5. every operand a route reads or writes with 16- or 8-byte vector
   accesses starts on that many bytes;
6. a format outside every route of a kernel raises in the wrapper's own
   check (``matmul_route``, ``resolve_act_block``, ``flash_route``,
   ``generic_warps``, ``flash_attention._check``: ``ValueError``) and
   produces no record.

The output coverage of each record is ``grid_coverage``'s rule, over the
same sweep.  The sweep (``sweep_records``): every (kernel, logical shape)
the reference's ``sweep_captures()`` captures, without the TPU's
padding; every kernel shape of each full config's serving path at the
smoke's batch and lengths, from the config's dims (``serving_cases``);
the widened act formats; the formats outside the fast routes before the
generic routes (``generic_cases``, ``wide_format_cases``); the GEMM core's
segment walk (``segment_cases``); and the out-of-domain formats of
ROADMAP §3, item 1 (``domain_cases``).
"""
from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict, List, Sequence, Tuple

import torch

from repro_torch.analysis.registry import Violation, register_rule
from repro_torch.core.quantize import _resolve_block
from repro_torch.kernels import (flash_attention, launch_fixture, mxint_gelu,
                                 mxint_layernorm, mxint_ln_matmul,
                                 mxint_matmul, mxint_softmax)
from repro_torch.kernels.launch_record import (LaunchRecord, emit,
                                               record_launches)

# the H100 SXM's launch limits (the hopper-kernels guide's table; the
# card's cudaDeviceGetAttribute values, which chip_smoke.py checks)
SMEM_PER_BLOCK_OPTIN = 232448      # 227 KB a CTA may opt in to
SMEM_PER_SM = 233472               # 228 KB an SM holds
SMEM_RESERVED_PER_BLOCK = 1024     # the runtime's share of each CTA
MAX_THREADS_PER_BLOCK = 1024
MAX_THREADS_PER_SM = 2048
MAX_BLOCKS_PER_SM = 32
MAX_GRID = (2 ** 31 - 1, 65535, 65535)
WARP = 32
H100_SMS = 132
# the card attributes (kernels/launch_fixture.DEVICE_ATTRS) these stand for
DEVICE_LIMITS = {"smem_per_block_optin": SMEM_PER_BLOCK_OPTIN,
                 "smem_per_sm": SMEM_PER_SM,
                 "smem_reserved_per_block": SMEM_RESERVED_PER_BLOCK,
                 "max_threads_per_block": MAX_THREADS_PER_BLOCK,
                 "max_threads_per_sm": MAX_THREADS_PER_SM,
                 "max_blocks_per_sm": MAX_BLOCKS_PER_SM,
                 "max_grid_x": MAX_GRID[0], "max_grid_y": MAX_GRID[1],
                 "max_grid_z": MAX_GRID[2], "sm_count": H100_SMS}

# kernel name (ops.LAUNCH_COUNTERS) -> its launch_config
LAUNCH_CONFIGS: Dict[str, Callable[..., LaunchRecord]] = {
    "mxint_matmul": mxint_matmul.launch_config,
    "mxint_ln_matmul": mxint_ln_matmul.launch_config,
    "mxint_softmax": mxint_softmax.launch_config,
    "mxint_gelu": mxint_gelu.launch_config,
    "mxint_layernorm": mxint_layernorm.launch_config,
    "flash_attention": flash_attention.launch_config,
    "flash_attention_decode": flash_attention.decode_launch_config,
    "launch_fixture": launch_fixture.launch_config,
}
# the kernels whose config takes the card's SM count
_TAKES_SMS = frozenset({"mxint_matmul", "mxint_ln_matmul", "mxint_gelu",
                        "mxint_layernorm", "flash_attention_decode"})
DOMAIN_ERRORS = (ValueError, NotImplementedError)

Case = Tuple[str, str, dict]        # (label, kernel, launch_config kwargs)


def launch(kernel: str, kw: dict, label: str = "") -> LaunchRecord:
    """The record of one sweep case (the H100's SM count filled in)."""
    kw = dict(kw)
    if kernel in _TAKES_SMS:
        kw.setdefault("n_sm", H100_SMS)
    return LAUNCH_CONFIGS[kernel](label=label, **kw)


# ---------------------------------------------------------------------------
# contracts
# ---------------------------------------------------------------------------
def _where(rec: LaunchRecord) -> str:
    return f"{rec.label or '?'}/{rec.kernel}"


def check_record(rec: LaunchRecord, limits: Dict[str, int] = None,
                 smem_static: int = None) -> List[Violation]:
    """Contracts 1-5 for one record, against ``limits`` (default: the
    H100's); ``smem_static``: the static shared memory the card reports
    for the record's function, where it is known."""
    lim = dict(DEVICE_LIMITS, **(limits or {}))
    out: List[Violation] = []

    def bad(msg):
        out.append(Violation("launch-contracts", _where(rec), msg))

    static = rec.smem_static if smem_static is None else smem_static
    smem = rec.smem_dynamic + static
    if smem > lim["smem_per_block_optin"]:
        bad(f"shared memory {rec.smem_dynamic} + {static} = {smem} bytes a "
            f"CTA exceeds the {lim['smem_per_block_optin']} a CTA may use")
    per_sm = rec.per_sm
    need = per_sm * (smem + lim["smem_reserved_per_block"])
    if per_sm > 1 and need > lim["smem_per_sm"]:
        bad(f"the geometry assumes {per_sm} CTAs an SM, whose shared "
            f"memory ({per_sm} x ({smem} + "
            f"{lim['smem_reserved_per_block']}) = {need} bytes) exceeds "
            f"the SM's {lim['smem_per_sm']}")
    if per_sm * rec.threads > lim["max_threads_per_sm"] or \
            per_sm > lim["max_blocks_per_sm"]:
        bad(f"the geometry assumes {per_sm} CTAs of {rec.threads} threads "
            f"an SM, past its {lim['max_threads_per_sm']} threads or "
            f"{lim['max_blocks_per_sm']} CTAs")
    if not 1 <= rec.threads <= lim["max_threads_per_block"] or \
            rec.threads % WARP:
        bad(f"{rec.threads} threads a CTA: not a whole number of warps up "
            f"to {lim['max_threads_per_block']}")
    caps = (lim["max_grid_x"], lim["max_grid_y"], lim["max_grid_z"])
    for axis, n, cap in zip("xyz", rec.grid, caps):
        if not 1 <= n <= cap:
            bad(f"grid {axis} of {n} CTAs is outside 1..{cap} (grid "
                f"{rec.grid})")
    for op in rec.operands:
        if op.vector_bytes and op.offset % op.vector_bytes:
            bad(f"operand {op.name} starts {op.offset} bytes past a 16-byte "
                f"boundary, but the route ({rec.function}) reads it in "
                f"{op.vector_bytes}-byte vectors")
    return out


def check_records(recs: Sequence[LaunchRecord], **kw) -> List[Violation]:
    out: List[Violation] = []
    for rec in recs:
        out.extend(check_record(rec, **kw))
    return out


def check_domain(label: str, kernel: str, make: Callable[[], object]
                 ) -> List[Violation]:
    """Contract 6: ``make()`` (a launch of an out-of-domain format) must
    raise the wrapper's domain error before any record exists."""
    with record_launches() as recs:
        try:
            make()
        except DOMAIN_ERRORS:
            if not recs:
                return []
            return [Violation("launch-contracts", f"{label}/{kernel}",
                              "raised, but only after a launch record "
                              "existed")]
    return [Violation("launch-contracts", f"{label}/{kernel}",
                      "a format outside the kernel's domain reached a "
                      "launch record instead of raising in the wrapper's "
                      "check")]


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------
def _mm(M, K, N, w_block=256, act_block=16, bits=8):
    """mxint_matmul kwargs at the model path's resolved blocks."""
    return dict(M=M, N=N, K=K, w_block=_resolve_block(K, w_block),
                act_block=_resolve_block(K, act_block), act_mant_bits=bits)


def _lnmm(M, d, N, w_block=256, act_block=16, bits=8, x=torch.float32,
          p=torch.float32):
    return dict(M=M, N=N, d=d, w_block=_resolve_block(d, w_block),
                act_block=_resolve_block(d, act_block), mant_bits=bits,
                lut_bits=5, x_dtype=x, params_dtype=p)


def _ln(rows, d, act_block=16, x=torch.float32, p=torch.float32):
    return dict(rows=rows, d=d, act_block=_resolve_block(d, act_block),
                lut_bits=5, x_dtype=x, params_dtype=p)


def _sm(rows, n, act_block=16):
    return dict(rows=rows, n=n, act_block=_resolve_block(n, act_block),
                r_bits=2)


def _gelu(rows, d, fn="gelu", act_block=16):
    return dict(rows=rows, d=d, act_block=_resolve_block(d, act_block),
                lut_bits=5, domain=3.0, fn=fn)


def _flash(bh, sq, sk, d, groups=1, dtype=torch.bfloat16):
    """flash_attention kwargs (the masks do not change the launch)."""
    return dict(bh=bh, sq=sq, sk=sk, d=d, kv_groups=groups, dtype=dtype,
                exp_mode="mxint", quantize_scores=True,
                act_block=_resolve_block(128, 16))


def _decode(b, hkv, g, W, d, dtype=torch.bfloat16):
    return dict(b=b, hkv=hkv, g=g, W=W, d=d, dtype=dtype, exp_mode="mxint",
                quantize_scores=True, act_block=16)


def reference_cases() -> List[Case]:
    """The (kernel, logical shape) of every capture of the reference's
    ``sweep_captures()`` (``src/repro/analysis/kernel_contracts.py:374-
    490``), under its labels, without the TPU's padding (DeiT-Tiny's 394
    rows, its 197 keys and its 64-wide heads as they are); the flash
    captures in the f32 they are captured at (the ordered kernel) and in
    bf16 (the tensor-core kernel)."""
    f32 = torch.float32
    return [
        ("matmul-bench", "mxint_matmul", _mm(128, 1024, 512, 256)),
        ("matmul-compiled", "mxint_matmul", _mm(128, 1024, 768, 32)),
        ("matmul-deit", "mxint_matmul", _mm(394, 192, 192, 32)),
        ("layernorm-bench", "mxint_layernorm", _ln(256, 768)),
        ("softmax-bench", "mxint_softmax", _sm(256, 768)),
        ("gelu-bench", "mxint_gelu", _gelu(256, 768)),
        ("layernorm-deit", "mxint_layernorm", _ln(394, 192)),
        ("ln-matmul-bench", "mxint_ln_matmul", _lnmm(256, 768, 768, 32)),
        ("flash-bench", "flash_attention",
         _flash(4, 256, 256, 128, dtype=f32)),
        ("flash-bench-bf16", "flash_attention", _flash(4, 256, 256, 128)),
        ("flash-deit", "flash_attention", _flash(6, 197, 197, 64, dtype=f32)),
        ("flash-deit-bf16", "flash_attention", _flash(6, 197, 197, 64)),
        ("flash-decode", "flash_attention_decode",
         _decode(2, 2, 8, 128, 128, dtype=f32)),
        ("flash-decode-bf16", "flash_attention_decode",
         _decode(2, 2, 8, 128, 128)),
    ]


# the smoke's serving shapes (chip_smoke.py: BATCH, LM_BATCH, LM_MAX_LEN,
# the longest prompt bucket, the score lengths)
DEIT_BATCH = 16
LM_BATCH = 4
LM_MAX_LEN = 2048
PREFILL_BUCKET = 1024
SCORE_TOKENS = 1024
VLM_MAX_LEN = 4096
VLM_SCORE = 3072
ENCDEC_FRAMES = 1024
ENCDEC_MAX_LEN = 512


def _deit_cases(cfg, batch: int) -> List[Tuple[str, dict]]:
    d, ff, H = cfg.d_model, cfg.d_ff, cfg.n_heads
    T = (cfg.image_size // cfg.patch_size) ** 2
    M = batch * (T + 1)
    K_patch = cfg.patch_size ** 2 * 3
    return [("mxint_matmul", _mm(batch * T, K_patch, d)),
            ("mxint_ln_matmul", _lnmm(M, d, H * cfg.hd)),
            ("mxint_softmax", _sm(batch * H * (T + 1), T + 1)),
            ("mxint_matmul", _mm(M, H * cfg.hd, d)),
            ("mxint_ln_matmul", _lnmm(M, d, ff)),
            ("mxint_gelu", _gelu(M, ff)),
            ("mxint_matmul", _mm(M, ff, d)),
            ("mxint_layernorm", _ln(M, d)),
            ("mxint_matmul", _mm(batch, d, cfg.n_classes))]


def _layer_cases(cfg, kind: str, M: int, decode: bool, W: int, x, p,
                 fused: bool = True) -> List[Tuple[str, dict]]:
    """The kernels of one layer of ``kind`` over M rows (a decode step:
    M = the batch, with the decode kernel over a ring of W)."""
    d, H, kvh, hd, ff = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                         cfg.d_ff)
    out: List[Tuple[str, dict]] = []
    act = "silu" if cfg.ffn_kind in ("swiglu", "moe") else "gelu"
    if kind == "attn":
        if fused:
            out += [("mxint_ln_matmul", _lnmm(M, d, H * hd, x=x, p=p)),
                    ("mxint_ln_matmul", _lnmm(M, d, kvh * hd, x=x, p=p))]
        else:
            out += [("mxint_layernorm", _ln(M, d, x=x, p=p)),
                    ("mxint_matmul", _mm(M, d, H * hd)),
                    ("mxint_matmul", _mm(M, d, kvh * hd))]
        if cfg.qk_norm:
            out += [("mxint_layernorm", _ln(M * H, hd, x=x, p=p)),
                    ("mxint_layernorm", _ln(M * kvh, hd, x=x, p=p))]
        if decode:
            out.append(("flash_attention_decode",
                        _decode(M, kvh, H // kvh, W, hd, dtype=x)))
        out.append(("mxint_matmul", _mm(M, H * hd, d)))
    elif kind == "rec":
        w = cfg.lru_width or d
        out += [("mxint_layernorm", _ln(M, d, x=x, p=p)),
                ("mxint_matmul", _mm(M, d, w)),
                ("mxint_matmul", _mm(M, w, w)),
                ("mxint_matmul", _mm(M, w, d)),
                ("mxint_gelu", _gelu(M, w))]
    elif kind == "mlstm":
        out += [("mxint_layernorm", _ln(M, d, x=x, p=p)),
                ("mxint_matmul", _mm(M, d, H * hd)),
                ("mxint_matmul", _mm(M, d, H)),
                ("mxint_matmul", _mm(M, H * hd, d)),
                ("mxint_matmul", _mm(M, d, 2 * d)),
                ("mxint_matmul", _mm(M, d, d))]
    elif kind == "slstm":
        rows = LM_BATCH if not decode else M      # a token's rows
        out += [("mxint_layernorm", _ln(M, d, x=x, p=p)),
                ("mxint_matmul", _mm(rows, d, 4 * d)),
                ("mxint_matmul", _mm(M, d, d))]
    if kind in ("attn", "rec") and cfg.ffn_kind != "none":
        if cfg.ffn_kind == "moe":
            from repro_torch.models.moe import capacity
            E, k = cfg.moe.num_experts, cfg.moe.top_k
            out += [("mxint_layernorm", _ln(M, d, x=x, p=p)),
                    ("mxint_matmul", _mm(M, d, E)),
                    ("mxint_softmax", _sm(M, k)),
                    ("mxint_gelu", _gelu(E * capacity(M, cfg), ff, "silu"))]
        elif fused:
            out += [("mxint_ln_matmul", _lnmm(M, d, ff, x=x, p=p)),
                    ("mxint_gelu", _gelu(M, ff, act)),
                    ("mxint_matmul", _mm(M, ff, d))]
        else:
            out += [("mxint_layernorm", _ln(M, d, x=x, p=p)),
                    ("mxint_matmul", _mm(M, d, ff)),
                    ("mxint_gelu", _gelu(M, ff, act)),
                    ("mxint_matmul", _mm(M, ff, d))]
    return out


def _lm_cases(cfg) -> List[Tuple[str, dict]]:
    x = p = cfg.dtype
    vlm = cfg.vision_tokens > 0
    W = VLM_MAX_LEN if vlm else LM_MAX_LEN
    window = cfg.window or cfg.local_attn_window
    W_attn = min(W, window) if window else W
    out: List[Tuple[str, dict]] = []
    kinds = sorted(set(cfg.layer_kinds))
    for M, decode in ((LM_BATCH, True), (PREFILL_BUCKET, False)):
        for kind in kinds:
            out += _layer_cases(cfg, kind, M, decode, W_attn, x, p)
        out.append(("mxint_layernorm", _ln(M, cfg.d_model, x=x, p=p)))
    if "attn" in kinds:                        # a score's flash kernel
        S = VLM_SCORE if vlm else SCORE_TOKENS
        out.append(("flash_attention",
                    _flash(cfg.n_heads, S, S, cfg.hd,
                           cfg.n_heads // cfg.n_kv_heads, dtype=x)))
    if vlm:
        out.append(("mxint_matmul", _mm(LM_BATCH * cfg.vision_tokens,
                                        cfg.vision_dim, cfg.d_model)))
    return out


def _encdec_cases(cfg) -> List[Tuple[str, dict]]:
    x = p = cfg.dtype
    d, H, hd = cfg.d_model, cfg.n_heads, cfg.hd
    F = LM_BATCH * ENCDEC_FRAMES
    out = _layer_cases(cfg, "attn", F, False, 0, x, p, fused=False)
    out += [("flash_attention", _flash(LM_BATCH * H, ENCDEC_FRAMES,
                                       ENCDEC_FRAMES, hd, dtype=x)),
            ("mxint_matmul", _mm(F, d, d))]                 # encode_kv
    for M, decode in ((LM_BATCH, True), (LM_BATCH * 16, False)):
        out += _layer_cases(cfg, "attn", M, decode, ENCDEC_MAX_LEN, x, p,
                            fused=False)
        out.append(("mxint_softmax", _sm(M * H, ENCDEC_FRAMES)))  # cross
    return out


def serving_cases() -> List[Case]:
    """Every kernel shape of each full config's serving path at the
    smoke's batch and lengths, from the config's dims
    (``repro_torch.configs.full_config``): DeiT-Base's batch of 16; each
    LM's decode step at batch 4 over its ring, a slot prefill of the
    longest bucket and a score's flash kernel; the VLM's projector; the
    encoder-decoder's encoder over 1024 frames and its decoder."""
    from repro_torch.configs import ARCH_IDS, deit, full_config
    seen, out, n = set(), [], {}

    def add(label, kernel, kw):
        key = (kernel, tuple(sorted((k, str(v)) for k, v in kw.items())))
        if key not in seen:
            seen.add(key)
            n[label] = n.get(label, 0) + 1
            out.append((f"{label}-{n[label]}", kernel, kw))

    for kernel, kw in _deit_cases(deit.DEIT_BASE, DEIT_BATCH):
        add("deit_base", kernel, kw)
    for arch in ARCH_IDS:
        cfg = full_config(arch)
        cases = _encdec_cases(cfg) if cfg.is_encoder_decoder \
            else _lm_cases(cfg)
        for kernel, kw in cases:
            add(arch, kernel, kw)
    return out


def widened_cases() -> List[Case]:
    """The widened act formats at DeiT-Base's FFN shapes: both
    matmul kernels at act blocks 4, 8, 32, 64, 256 and at 10-, 12- and
    16-bit mantissas (blocks 16 and 32); the row kernels at blocks 32, 64
    and 128."""
    M, d, ff = DEIT_BATCH * 197, 768, 3072
    out: List[Case] = []
    for b in (4, 8, 32, 64, 256):
        out += [(f"wide-mm-b{b}", "mxint_matmul", _mm(M, ff, d, act_block=b)),
                (f"wide-lnmm-b{b}", "mxint_ln_matmul",
                 _lnmm(M, d, ff, act_block=b))]
    for bits in (10, 12, 16):
        for b in (16, 32):
            out += [(f"wide-mm-{bits}b-b{b}", "mxint_matmul",
                     _mm(M, ff, d, act_block=b, bits=bits)),
                    (f"wide-lnmm-{bits}b-b{b}", "mxint_ln_matmul",
                     _lnmm(M, d, ff, act_block=b, bits=bits))]
    for b in (32, 64, 128):
        out += [(f"wide-ln-b{b}", "mxint_layernorm", _ln(M, d, act_block=b)),
                (f"wide-gelu-b{b}", "mxint_gelu", _gelu(M, ff, act_block=b)),
                (f"wide-softmax-b{b}", "mxint_softmax",
                 _sm(DEIT_BATCH * 12 * 256, 256, act_block=b))]
    return out


# the labels of ``generic_cases`` and ``wide_format_cases`` whose formats
# the GEMM core takes by segment (int16 planes, act blocks that do not nest
# in the weight block); the others stay on the generic routes
CORE_SEGMENT_LABELS = frozenset({
    "odd-act-block-12", "odd-act-block-24", "act-block-512", "int16-planes",
    "w12-a12-ffn-wo", "w12-a12-ln2-wi"})


def generic_cases() -> List[Case]:
    """The formats outside the fast routes before the generic routes (the
    out-of-domain formats of ROADMAP §3, item 1): act blocks that do not
    nest in the weight block, K not a multiple of 16, 17-bit act
    mantissas, int16 planes, LN blocks past the fast routes' or on
    unaligned rows, whole-row softmax and GELU blocks, flash act blocks
    past 32 (and 12, which resolves to 8 on the fast decode kernel), head
    dims past 256, a bf16 head dim off the mma depth, G past the mma
    kernel's rows.  The GEMM core takes those of ``CORE_SEGMENT_LABELS``
    by segment; the generic routes the rest."""
    M, d, ff = 64, 768, 3072
    return [
        ("odd-act-block-12", "mxint_matmul",
         dict(M=M, N=d, K=ff, w_block=256, act_block=12, act_mant_bits=8)),
        ("odd-act-block-24", "mxint_matmul",
         dict(M=M, N=d, K=ff, w_block=96, act_block=24, act_mant_bits=8)),
        ("odd-act-block-48", "mxint_ln_matmul",
         dict(M=M, N=ff, d=d, w_block=96, act_block=48, mant_bits=8,
              lut_bits=5)),
        ("act-block-512", "mxint_matmul",
         dict(M=M, N=d, K=ff, w_block=512, act_block=512, act_mant_bits=8)),
        ("k-not-16", "mxint_matmul",
         dict(M=M, N=d, K=200, w_block=8, act_block=8, act_mant_bits=8)),
        ("act-mant-17", "mxint_matmul",
         dict(M=M, N=d, K=ff, w_block=256, act_block=16, act_mant_bits=17)),
        ("int16-planes", "mxint_matmul",
         dict(M=M, N=d, K=ff, w_block=256, act_block=16, act_mant_bits=8,
              w_dtype=torch.int16)),
        ("ln-block-24", "mxint_layernorm",
         dict(rows=M, d=d, act_block=24, lut_bits=5)),
        ("ln-block-256", "mxint_layernorm",
         dict(rows=M, d=d, act_block=256, lut_bits=5)),
        ("ln-unaligned-block-32", "mxint_layernorm",
         dict(rows=M, d=d, act_block=32, lut_bits=5, aligned=False)),
        ("lnmm-unaligned-block-32", "mxint_ln_matmul",
         dict(M=M, N=ff, d=d, w_block=256, act_block=32, mant_bits=8,
              lut_bits=5, aligned=False)),
        ("softmax-block-256", "mxint_softmax",
         dict(rows=M, n=256, act_block=256, r_bits=2)),
        ("gelu-block-256", "mxint_gelu",
         dict(rows=M, d=ff, act_block=256, lut_bits=5, domain=3.0,
              fn="gelu")),
        ("flash-act-block-64", "flash_attention",
         dict(bh=8, sq=256, sk=256, d=128, act_block=64)),
        ("flash-head-dim-272", "flash_attention",
         dict(bh=8, sq=256, sk=256, d=272, act_block=16)),
        ("flash-bf16-head-dim-100", "flash_attention",
         dict(bh=8, sq=256, sk=256, d=100, act_block=16)),
        ("flash-groups-129", "flash_attention",
         dict(bh=129, sq=16, sk=256, d=128, kv_groups=129, act_block=16)),
        ("decode-act-block-12", "flash_attention_decode",
         dict(b=4, hkv=8, g=4, W=2048, d=128, act_block=12)),
        ("decode-head-dim-272", "flash_attention_decode",
         dict(b=4, hkv=8, g=4, W=2048, d=272, act_block=16)),
    ]


def wide_format_cases() -> List[Case]:
    """The formats of the reference's own sweeps past the fast routes
    before the generic routes: the paper's W9-W14 and W16-W24 planes
    (int16, int32), 24-bit act mantissas, Table VI's vanilla LUTs (LN 13
    bits, GELU 14, softmax r 16) at DeiT-Base's shapes,
    ``quantize_act=False`` at its FFN ``wo``, and the flash kernels' r 10
    LUT.  The W12 GEMMs (``CORE_SEGMENT_LABELS``) now run on the GEMM
    core."""
    M, d, ff = DEIT_BATCH * 197, 768, 3072
    return [
        ("w12-a12-ffn-wo", "mxint_matmul",
         dict(M=M, N=d, K=ff, w_block=256, act_block=12, act_mant_bits=8,
              w_dtype=torch.int16)),
        ("w12-a12-ln2-wi", "mxint_ln_matmul",
         dict(M=M, N=ff, d=d, w_block=256, act_block=12, mant_bits=8,
              lut_bits=13, w_dtype=torch.int16)),
        ("w24-a24-int32", "mxint_matmul",
         dict(M=64, N=d, K=ff, w_block=256, act_block=256,
              act_mant_bits=24, w_dtype=torch.int32)),
        ("float-act-ffn-wo", "mxint_matmul",
         dict(M=M, N=d, K=ff, w_block=256, act_block=16, act_mant_bits=8,
              quantize_act=False)),
        ("ln-lut-13", "mxint_layernorm",
         dict(rows=M, d=d, act_block=12, lut_bits=13)),
        ("softmax-r-16", "mxint_softmax",
         dict(rows=DEIT_BATCH * 12 * 197, n=197, act_block=1, r_bits=16)),
        ("gelu-lut-14", "mxint_gelu",
         dict(rows=M, d=ff, act_block=12, lut_bits=14, domain=3.0,
              fn="gelu")),
        ("flash-r-10", "flash_attention",
         dict(bh=8, sq=256, sk=256, d=128, act_block=16, r_bits=10)),
    ]


def segment_cases() -> List[Case]:
    """The GEMM core's segment walk (V 3-4) at the smoke's segment cases:
    W12 planes (int16) at act blocks 12 and 16 with 8- and 12-bit acts and
    W8 at act block 24 on 96-blocks through ``mxint_matmul``, the fused
    LN2 -> ``wi`` at W12 with the 13-bit LUT, each at DeiT-Base batch 16
    and at 4 rows."""
    d, ff = 768, 3072
    out: List[Case] = []
    for M, tag in ((DEIT_BATCH * 197, "deit"), (4, "decode4")):
        for label, (wbits, w_block), (bits, block) in (
                ("w12-a8-b12", (12, 256), (8, 12)),
                ("w12-a8-b16", (12, 256), (8, 16)),
                ("w12-a12-b16", (12, 256), (12, 16)),
                ("w8-a8-b24-w96", (8, 96), (8, 24))):
            out.append((f"seg-{tag}-mm-{label}", "mxint_matmul", dict(
                M=M, N=d, K=ff, w_block=w_block, act_block=block,
                act_mant_bits=bits,
                w_dtype=torch.int16 if wbits > 8 else torch.int8)))
        for label, (bits, block) in (("w12-a8-b12-lut13", (8, 12)),
                                     ("w12-a12-b16-lut13", (12, 16))):
            out.append((f"seg-{tag}-lnmm-{label}", "mxint_ln_matmul", dict(
                M=M, N=ff, d=d, w_block=256, act_block=block,
                mant_bits=bits, lut_bits=13, w_dtype=torch.int16)))
    return out


def domain_cases() -> List[Case]:
    """Formats outside every route, each refused by the reference's
    kernels too: each must raise in the wrapper's check before a record
    exists."""
    M, d, ff = 64, 768, 3072
    return [
        ("act-mant-25", "mxint_matmul",
         dict(M=M, N=d, K=ff, w_block=256, act_block=16, act_mant_bits=25)),
        ("act-block-not-dividing-k", "mxint_matmul",
         dict(M=M, N=d, K=ff, w_block=256, act_block=7, act_mant_bits=8)),
        ("w-block-not-dividing-k", "mxint_matmul",
         dict(M=M, N=d, K=ff, w_block=5, act_block=16, act_mant_bits=8)),
        ("int64-planes", "mxint_matmul",
         dict(M=M, N=d, K=ff, w_block=256, act_block=16, act_mant_bits=8,
              w_dtype=torch.int64)),
        ("lnmm-mant-25", "mxint_ln_matmul",
         dict(M=M, N=ff, d=d, w_block=256, act_block=16, mant_bits=25,
              lut_bits=5)),
        ("ln-block-not-dividing-d", "mxint_layernorm",
         dict(rows=M, d=d, act_block=7, lut_bits=5)),
        ("softmax-block-not-dividing-n", "mxint_softmax",
         dict(rows=M, n=256, act_block=7, r_bits=2)),
        ("gelu-block-not-dividing-d", "mxint_gelu",
         dict(rows=M, d=ff, act_block=7, lut_bits=5, domain=3.0, fn="gelu")),
        ("flash-float16", "flash_attention",
         dict(bh=8, sq=256, sk=256, d=128, dtype=torch.float16)),
        ("flash-quantized-float-exp", "flash_attention",
         dict(bh=8, sq=256, sk=256, d=128, exp_mode="float",
              quantize_scores=True)),
        ("flash-head-dim-past-smem", "flash_attention",
         dict(bh=2, sq=16, sk=256, d=40000)),
        ("decode-float16", "flash_attention_decode",
         dict(b=4, hkv=8, g=4, W=2048, d=128, dtype=torch.float16)),
    ]


def sweep_cases() -> List[Case]:
    return reference_cases() + serving_cases() + widened_cases() + \
        generic_cases() + wide_format_cases() + segment_cases()


_SWEEP_MEMO: List[LaunchRecord] = []


def sweep_records(refresh: bool = False) -> List[LaunchRecord]:
    """The records of every in-domain sweep case (memoized: the contract,
    coverage and cost-model rules read the same records)."""
    if refresh or not _SWEEP_MEMO:
        _SWEEP_MEMO[:] = [launch(k, kw, label)
                          for label, k, kw in sweep_cases()]
    return list(_SWEEP_MEMO)


def check_domain_cases() -> List[Violation]:
    out: List[Violation] = []
    for label, kernel, kw in domain_cases():
        out.extend(check_domain(label, kernel,
                                lambda k=kernel, a=kw, lb=label:
                                record_launch(k, a, lb)))
    return out


def record_launch(kernel: str, kw: dict, label: str = "") -> LaunchRecord:
    """``launch`` through the recorder, as a wrapper hands its record on
    before it launches."""
    rec = launch(kernel, kw, label)
    emit(rec)
    return rec


def query_record(kernel: str, kw: dict, rec: LaunchRecord) -> dict:
    """The C host code's own launch values for a sweep case: its launch
    entry, called with null pointers and the record's geometry arguments
    under the library's query (``kernels/launch_fixture.query``), on the
    card.  Returns its grid, threads, dynamic and static shared memory,
    registers and CTAs an SM."""
    import ctypes

    from repro_torch.kernels import _build
    from repro_torch.kernels.launch_fixture import query
    from repro_torch.kernels.mxint_layernorm import f32
    from repro_torch.kernels.mxint_softmax import LOG2E
    i, f = ctypes.c_int, ctypes.c_float
    bf16 = lambda name: int(kw.get(name, torch.float32)  # noqa: E731
                            == torch.bfloat16)
    gen = "generic" in rec.function or "_float_" in rec.function
    if kernel == "mxint_matmul" and gen:
        return query("mxint_matmul", mxint_matmul.generic_entry(),
                     *[None] * 4, kw["M"], kw["K"], kw["N"],
                     *mxint_matmul.generic_args(
                         kw["K"], kw["w_block"], kw["act_block"],
                         kw["act_mant_bits"], kw.get("w_dtype", torch.int8),
                         kw.get("quantize_act", True), rec.args[0]), None)
    if kernel == "mxint_ln_matmul" and gen:
        d = kw["d"]
        n = 2 ** kw["lut_bits"]
        return query("mxint_ln_matmul",
                     mxint_ln_matmul.ln_matmul_generic_entry(), *[None] * 7,
                     kw["M"], d, kw["N"], *mxint_matmul.generic_args(
                         d, kw["w_block"], min(kw["act_block"], d),
                         kw["mant_bits"], kw.get("w_dtype", torch.int8),
                         True, rec.args[0]), f32(1.0 / d), n, f32(n / 1.5),
                     0, bf16("x_dtype"), bf16("params_dtype"), None)
    if kernel == "mxint_layernorm" and gen:
        d, n = kw["d"], 2 ** kw["lut_bits"]
        return query("mxint_layernorm", mxint_layernorm.generic_entry(),
                     *[None] * 5, kw["rows"], d, kw["act_block"], 8,
                     f32(1.0 / d), n, f32(n / 1.5), 0, 1, bf16("x_dtype"),
                     bf16("params_dtype"), *rec.args, None)
    if kernel == "mxint_softmax" and gen:
        return query("mxint_softmax", mxint_softmax.generic_entry(),
                     *[None] * 3, kw["rows"], kw["n"], kw["act_block"], 8,
                     2 ** kw["r_bits"], LOG2E, 1, *rec.args, None)
    if kernel == "mxint_matmul":
        return query("mxint_matmul", mxint_matmul.matmul_entry(),
                     *[None] * 4, kw["M"], kw["K"], kw["N"], kw["w_block"],
                     kw["act_mant_bits"], kw["act_block"], *rec.args, None)
    if kernel == "mxint_ln_matmul":
        d = kw["d"]
        n = 2 ** kw["lut_bits"]
        return query("mxint_ln_matmul", mxint_ln_matmul.ln_matmul_entry(),
                     *[None] * 7, kw["M"], d, kw["N"], kw["w_block"],
                     kw["mant_bits"], min(kw["act_block"], d), f32(1.0 / d),
                     n, f32(n / 1.5), 0, bf16("x_dtype"),
                     bf16("params_dtype"), *rec.args, None)
    if kernel == "mxint_layernorm":
        d, n = kw["d"], 2 ** kw["lut_bits"]
        gs = rec.operands[-1].name == "scratch"
        fn = _build.entry("mxint_layernorm", [ctypes.c_void_p] * 6 + [i] * 4
                          + [f, i, f] + [i] * 6 + [ctypes.c_void_p])
        return query("mxint_layernorm", fn, *[None] * 5, 256 if gs else None,
                     kw["rows"], d, kw["act_block"], 8, f32(1.0 / d), n,
                     f32(n / 1.5), 0, 1, bf16("x_dtype"),
                     bf16("params_dtype"), *rec.args, None)
    if kernel == "mxint_softmax":
        fn = _build.entry("mxint_softmax", [ctypes.c_void_p] * 3 + [i] * 5
                          + [f] + [i] * 4 + [ctypes.c_void_p])
        return query("mxint_softmax", fn, *[None] * 3, kw["rows"], kw["n"],
                     kw["act_block"], 8, 2 ** kw["r_bits"], LOG2E, 1,
                     *rec.args, None)
    if kernel == "mxint_gelu":
        table, dom = mxint_gelu.gelu_table(kw["fn"], kw["lut_bits"],
                                           kw["domain"])
        return query("mxint_gelu", mxint_gelu.entry(), *[None] * 3,
                     kw["rows"] * kw["d"], kw["act_block"], 8, len(table),
                     f32(dom), f32(len(table) / (2.0 * dom)), *rec.args,
                     None)
    tail = [2 ** kw.get("r_bits", 2), f32(kw["d"] ** -0.5), LOG2E,
            int(kw.get("dtype", torch.bfloat16) == torch.bfloat16), None]
    fmt = [1, 1, flash_attention.resolve_act_block(kw.get("act_block", 16)),
           8]
    if gen and kernel == "flash_attention":
        return query("flash_attention", flash_attention.generic_entry(),
                     *[None] * 5, kw["bh"], kw["sq"], kw["sk"], kw["d"],
                     kw.get("kv_groups", 1), 1, 0, *fmt, *tail[:-1],
                     *rec.args, None)
    if gen:
        return query("flash_attention",
                     flash_attention.generic_decode_entry(), *[None] * 6,
                     kw["b"], kw["hkv"], kw["g"], kw["W"], kw["d"], *fmt,
                     *tail[:-1], *rec.args, None)
    if kernel == "flash_attention":
        fn = _build.entry("flash_attention", [ctypes.c_void_p] * 5 + [i] * 7
                          + flash_attention._TAIL)
        return query("flash_attention", fn, *[None] * 5, kw["bh"], kw["sq"],
                     kw["sk"], kw["d"], kw.get("kv_groups", 1), 1, 0, *fmt,
                     *tail)
    if kernel == "flash_attention_decode":
        fn = _build.entry("flash_attention_decode", [ctypes.c_void_p] * 6 +
                          [i] * 7 + flash_attention._TAIL,
                          lib="flash_attention")
        return query("flash_attention", fn, *[None] * 6, kw["b"], kw["hkv"],
                     kw["g"], kw["W"], kw["d"], *rec.args, *fmt, *tail)
    raise KeyError(kernel)


@register_rule(
    "launch-contracts",
    "every launch record of the sweep fits the H100 (shared memory a CTA "
    "and an SM, threads, grid, vector alignment) and every out-of-domain "
    "format raises before a record exists")
def run(root: Path, device: str = "cuda") -> List[Violation]:
    recs = sweep_records()
    out = check_records(recs) + check_domain_cases()
    if not recs:
        out.append(Violation("launch-contracts", "sweep",
                             "the sweep recorded no launch"))
    return out

