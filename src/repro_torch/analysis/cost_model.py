"""Hopper cost table: closed-form operations, device-memory bytes and
shared memory per kernel label.

Counterpart of ``repro.analysis.cost_model`` in its role (the static
table the design-space exploration prices candidates with and the probes'
predicted-vs-measured join reads), with the H100's contents.  Nothing is
captured or executed: each row is a closed form of its shape.

* **Operations**, split by the unit that runs them: ``int8_ops`` (the
  matmul kernels' products on the int8 tensor cores, ``int8_splits`` x 2
  M N K: a product per pair of bytes, 2 M N K for 2-8-bit acts on int8
  planes, twice that for 9-16-bit acts or int16 planes, four times for
  both), ``bf16_ops`` (the bf16 flash kernel's q.k and P.V products) and
  ``f32_ops`` (the ordered f32 sum of the matmul kernels, a multiply and
  an add per output element and segment, the intersection of an act
  block with a weight block; the row datapaths' stages, ``ROW_OPS`` per
  element; the float32 flash kernel's products).  ``flops`` is their
  sum.
* **Bytes**: every operand read once and every output written once
  (``operands``, ``bytes_traffic`` each, ``hbm_bytes`` their sum), what the
  function must move whatever the kernel re-reads.  Weight planes are
  priced at one byte an element, as the reference's table prices them;
  ``repro_torch.dse.evaluate`` scales the mantissa operand by
  ``weight_bits / 8``, as the reference does, since the paper's hardware
  stores packed mantissas.  The H100's int8 planes do not shrink with the
  mantissa width: on this card the scaled bytes are the format's, not
  the kernel's traffic.
* **Shared memory** (``smem_bytes``): a CTA's, from the kernels' own
  geometry (``gemm_geometry``, ``ln_geometry``, the flash kernels'
  layouts).

``bound`` turns a row into the least time the card could take: the larger
of its bytes over the H100's 3.35 TB/s and its operations over the
published dense peaks of their units (``repro_torch.telemetry.export``).
``chip_smoke.py`` computes every kernel case's bound with it.

Labels: the reference's four probe labels (``matmul-deit``,
``flash-deit``, ``matmul-bench``, ``ln-matmul-bench``) at the shapes the
port's probes run (``repro_torch.telemetry.probes``: without the TPU's
padding), and DeiT-Base's deployment kernels at batch 16 (``deit-base-*``,
with ``calls`` a forward and the ``scope`` of their call sites, the tag
the model's forward passes to ``QuantConfig.scoped``; ``{i}`` stands for
each of the ``layers`` blocks).  The table is built at one act format
(``act_block``, ``act_mant_bits``; default the paper's 16-element blocks
of 8 bits): the act format moves the matmul kernels' ordered sum, their
int8 products and their shared memory, and the LN stage's geometry.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.telemetry.export import (DEFAULT_PEAKS, F32_OPS_PER_S,
                                          F64_OPS_PER_S, INT8_OPS_PER_S)

H100_SMS = 132
DEIT_BASE_LAYERS = 12
# f32 operations per element of the row datapaths, counted from their
# stages (quantize, align, LUT, scale, requantize); for the flash kernels
# per score of a (query, key) pair that the masks keep
ROW_OPS = {"mxint_layernorm": 30, "mxint_softmax": 30, "mxint_gelu": 16,
           "flash": 36}


def bound(nbytes: float, int8_ops: float = 0.0, f32_ops: float = 0.0,
          bf16_ops: float = 0.0, f64_ops: float = 0.0) -> Tuple[float, str]:
    """(least time in ms, what bounds it: "bytes" or "operations") on the
    H100's published dense peaks: HBM, int8 and bf16 tensor cores, float32
    and float64 outside them."""
    t_mem = nbytes / DEFAULT_PEAKS.hbm_bytes_per_s
    t_ops = (int8_ops / INT8_OPS_PER_S + bf16_ops / DEFAULT_PEAKS.flops_per_s
             + f32_ops / F32_OPS_PER_S + f64_ops / F64_OPS_PER_S)
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops
                                     else "operations")


def gemm_f32_ops(M: int, N: int, K: int, act_block: int = 16) -> float:
    """The ordered f32 sum of the matmul kernels: a multiply and an add per
    output element and act block, K / act_block blocks in all."""
    return 2.0 * M * N * (K // act_block)


def _operand(name: str, dtype: str, numel: int, elem_bytes: int) -> dict:
    return {"name": name, "dtype": dtype, "numel": int(numel),
            "bytes_traffic": int(numel) * elem_bytes}


def _row(label: str, kernel: str, shape: dict, operands: List[dict], *,
         int8_ops: float = 0.0, bf16_ops: float = 0.0, f32_ops: float = 0.0,
         f64_ops: float = 0.0, smem_bytes: int = 0,
         calls: Optional[int] = None, scope: Optional[str] = None) -> dict:
    hbm = sum(o["bytes_traffic"] for o in operands)
    flops = int8_ops + bf16_ops + f32_ops + f64_ops
    ms, by = bound(hbm, int8_ops=int8_ops, f32_ops=f32_ops, bf16_ops=bf16_ops,
                   f64_ops=f64_ops)
    row = {"label": label, "kernel": kernel, "shape": shape,
           "flops": int(flops), "int8_ops": int(int8_ops),
           "bf16_ops": int(bf16_ops), "f32_ops": int(f32_ops),
           "hbm_bytes": int(hbm), "smem_bytes": int(smem_bytes),
           "intensity": round(flops / hbm, 3) if hbm else 0.0,
           "bound_ms": ms, "bound_by": by, "operands": operands}
    if f64_ops:
        row["f64_ops"] = int(f64_ops)
    if calls is not None:
        row["calls"] = calls
    if scope is not None:
        row["scope"] = scope
        if "{i}" in scope:
            row["layers"] = DEIT_BASE_LAYERS
    return row


def _dtype(nbytes: int) -> str:
    return {2: "bfloat16", 4: "float32"}[nbytes]


_WD = {1: "int8", 2: "int16", 4: "int32"}


def matmul_row(label: str, M: int, K: int, N: int, *, w_block: int,
               act_block: int = 16, act_mant_bits: int = 8,
               fused_ln: bool = False, x_bytes: int = 4,
               param_bytes: int = 4, beta: bool = True, w_bytes: int = 1,
               lut_bits: Optional[int] = None,
               calls: Optional[int] = None,
               scope: Optional[str] = None) -> dict:
    """``mxint_matmul`` (or, ``fused_ln``, ``mxint_ln_matmul``) on the GEMM
    core: x (M, K), int8 or (``w_bytes`` 2) int16 planes (K, N) and int8
    exponents (K / w_block, N), f32 out (M, N); the fused kernel also
    reads gamma (and beta; with ``lut_bits`` its rsqrt LUT, counted once)
    and runs the LN stage.  The geometry is the core's for the format: by
    segment (V 3-4) for int16 planes or an act block that does not nest."""
    from repro_torch.kernels.mxint_layernorm import ln_piece
    from repro_torch.kernels.mxint_matmul import (act_variant,
                                                  gemm_geometry,
                                                  gemm_smem_bytes,
                                                  gemm_static_smem, segmented,
                                                  segments)
    ops = [_operand("x", _dtype(x_bytes), M * K, x_bytes)]
    if fused_ln:
        ops.append(_operand("gamma", _dtype(param_bytes), K, param_bytes))
        if beta:
            ops.append(_operand("beta", _dtype(param_bytes), K, param_bytes))
        if lut_bits is not None:
            ops.append(_operand("lut", "float32", 2 ** lut_bits, 4))
    ops += [_operand("w_mant", _WD[w_bytes], K * N, w_bytes),
            _operand("w_exp", "int8", (K // w_block) * N, 1),
            _operand("out", "float32", M * N, 4)]
    act_block = min(act_block, K)
    wide = act_mant_bits > 8
    seg = segmented(act_block, w_block, w_bytes)
    g = gemm_geometry(M, N, K, H100_SMS, fused_ln=fused_ln,
                      act_block=act_block, wide=wide, w_bytes=w_bytes,
                      seg=seg)
    smem = gemm_smem_bytes(g.bm, g.bn, g.bk, g.ns, K if fused_ln else g.kc,
                           act_block, 2 if wide else 1, w_bytes) + \
        gemm_static_smem(fused_ln, act_variant(act_block, act_mant_bits, seg),
                         ln_piece(act_block, True) if fused_ln else 0)
    f32 = 2.0 * M * N * len(segments(K, w_block, act_block)[0])
    if fused_ln:
        f32 += ROW_OPS["mxint_layernorm"] * M * K
    shape = {"M": M, "K": K, "N": N, "w_block": w_block,
             "act_block": act_block, "act_mant_bits": act_mant_bits,
             "w_bytes": w_bytes}
    if lut_bits is not None:
        shape["lut_bits"] = lut_bits
    return _row(label, "mxint_ln_matmul" if fused_ln else "mxint_matmul",
                shape, ops, int8_ops=int8_splits(act_mant_bits, w_bytes)
                * 2.0 * M * N * K, f32_ops=f32, smem_bytes=smem, calls=calls,
                scope=scope)


def softmax_row(label: str, rows: int, n: int,
                calls: Optional[int] = None,
                scope: Optional[str] = None) -> dict:
    """``mxint_softmax`` on (rows, n) f32."""
    from repro_torch.kernels.mxint_softmax import SMEM_BYTES
    return _row(label, "mxint_softmax", {"rows": rows, "n": n},
                [_operand("x", "float32", rows * n, 4),
                 _operand("out", "float32", rows * n, 4)],
                f32_ops=ROW_OPS["mxint_softmax"] * rows * n,
                smem_bytes=SMEM_BYTES, calls=calls, scope=scope)


def gelu_row(label: str, rows: int, d: int,
             calls: Optional[int] = None,
             scope: Optional[str] = None) -> dict:
    """``mxint_gelu`` on (rows, d) f32."""
    from repro_torch.kernels.mxint_gelu import SMEM_BYTES
    return _row(label, "mxint_gelu", {"rows": rows, "d": d},
                [_operand("x", "float32", rows * d, 4),
                 _operand("out", "float32", rows * d, 4)],
                f32_ops=ROW_OPS["mxint_gelu"] * rows * d,
                smem_bytes=SMEM_BYTES, calls=calls, scope=scope)


def layernorm_row(label: str, rows: int, d: int, act_block: int = 16,
                  calls: Optional[int] = None,
                  scope: Optional[str] = None) -> dict:
    """``mxint_layernorm`` on (rows, d) f32 with f32 gamma and beta."""
    from repro_torch.kernels.mxint_layernorm import (LN_STATIC_SMEM,
                                                     ln_geometry)
    g = ln_geometry(rows, d, act_block, H100_SMS)
    return _row(label, "mxint_layernorm", {"rows": rows, "d": d,
                                           "act_block": act_block},
                [_operand("x", "float32", rows * d, 4),
                 _operand("gamma", "float32", d, 4),
                 _operand("beta", "float32", d, 4),
                 _operand("out", "float32", rows * d, 4)],
                f32_ops=ROW_OPS["mxint_layernorm"] * rows * d,
                smem_bytes=g.smem + LN_STATIC_SMEM, calls=calls,
                scope=scope)


def flash_row(label: str, heads: int, kv_heads: int, S: int, d: int, *,
              causal: bool, elem_bytes: int,
              calls: Optional[int] = None) -> dict:
    """``flash_attention`` over ``heads`` query heads of S positions (one
    batch row), K/V of ``kv_heads`` heads: q, k, v read once, o written
    once; q.k and P.V products (4 d a kept pair) on the bf16 tensor cores
    for bf16 operands, in f32 on the ordered kernel for float32 ones."""
    pairs = heads * (S * (S + 1) // 2 if causal else S * S)
    prod = 4.0 * pairs * d
    dt = _dtype(elem_bytes)
    if elem_bytes == 4:    # the ordered kernel: q rows, K/V tile, scores,
        smem = 4 * (32 * 128 + 128 * 129 + 32 * 128 + 32 * 128 + 5 * 32
                    + 256)         # acc, row state, LUT (smem_floats(32))
    else:                  # K, V tiles (2 each), the CTA's q rows, LUT
        smem = 4 * 128 * (d + 8) * 2 + 128 * (d + 8) * 2 + 256 * 4
    return _row(label, "flash_attention",
                {"heads": heads, "kv_heads": kv_heads, "S": S, "d": d,
                 "causal": causal},
                [_operand("q", dt, heads * S * d, elem_bytes),
                 _operand("k", dt, kv_heads * S * d, elem_bytes),
                 _operand("v", dt, kv_heads * S * d, elem_bytes),
                 _operand("out", dt, heads * S * d, elem_bytes)],
                bf16_ops=prod if elem_bytes == 2 else 0.0,
                f32_ops=ROW_OPS["flash"] * pairs
                + (prod if elem_bytes == 4 else 0.0),
                smem_bytes=smem, calls=calls)


# ---------------------------------------------------------------------------
# the generic routes
# ---------------------------------------------------------------------------
def int8_splits(act_mant_bits: int, w_bytes: int) -> int:
    """The int8 products one integer product splits into: a signed high
    byte and unsigned lower bytes of each operand (acts of 9-16 bits two
    bytes, as the core's V 2 and 4 split them, 17-24 bits three; int16
    planes two bytes, as V 3 and 4 split them, int32 planes at most the 24
    bits a mantissa takes, three)."""
    return -(-act_mant_bits // 8) * min(w_bytes, 3)


def generic_matmul_row(label: str, M: int, K: int, N: int, *, w_block: int,
                       act_block: int, act_mant_bits: int, w_bytes: int,
                       fused_ln: bool = False, quantize_act: bool = True,
                       lut_bits: int = 5) -> dict:
    """The generic route of ``mxint_matmul`` (or, ``fused_ln``,
    ``mxint_ln_matmul``): x (M, K) f32, planes of ``w_bytes`` bytes an
    element (int8, int16, int32) and int8 exponents, f32 out; the fused
    kernel also reads gamma, beta and its rsqrt LUT.  The bound counts the
    integer products as the core's wide rows do: split into int8 pieces
    (``int8_splits``) on the int8 tensor cores, exact in any order, though
    this route runs them on the CUDA cores; each output adds every
    segment's dot in two rounded f32 steps.  Float activations take float64
    products and sums in a fixed order, counted at the float64 rate."""
    from repro_torch.kernels.mxint_matmul import (generic_rows,
                                                  generic_smem_bytes,
                                                  segments)
    wd = _WD[w_bytes]
    ops = [_operand("x", "float32", M * K, 4)]
    if fused_ln:
        ops += [_operand("gamma", "float32", K, 4),
                _operand("beta", "float32", K, 4),
                _operand("lut", "float32", 2 ** lut_bits, 4)]
    ops += [_operand("w_mant", wd, K * N, w_bytes),
            _operand("w_exp", "int8", (K // w_block) * N, 1),
            _operand("out", "float32", M * N, 4)]
    ln_d = K if fused_ln else 0
    bm = generic_rows(M, K, act_block, quantize_act, ln_d)
    smem = generic_smem_bytes(bm, K, act_block, quantize_act, ln_d)
    i8 = f32 = f64 = 0.0
    if quantize_act:
        i8 = int8_splits(act_mant_bits, w_bytes) * 2.0 * M * N * K
        f32 = 2.0 * M * N * len(segments(K, w_block, act_block)[0])
    else:
        f64 = 2.0 * M * N * K
    if fused_ln:
        f32 += ROW_OPS["mxint_layernorm"] * M * K
    return _row(label, "mxint_ln_matmul" if fused_ln else "mxint_matmul",
                {"M": M, "K": K, "N": N, "w_block": w_block,
                 "act_block": act_block, "act_mant_bits": act_mant_bits,
                 "w_bytes": w_bytes, "quantize_act": quantize_act,
                 "lut_bits": lut_bits},
                ops, int8_ops=i8, f32_ops=f32, f64_ops=f64, smem_bytes=smem)


def generic_row_row(label: str, kernel: str, rows: int, d: int, *,
                    act_block: int, lut_n: int, lut_bits: int) -> dict:
    """The generic route of a row kernel: (rows, d) f32 read and written
    once, its LUT read from device memory (counted once), the datapath's
    ``ROW_OPS`` an element; no shared memory."""
    ops = [_operand("x", "float32", rows * d, 4),
           _operand("lut", "float32", lut_n, 4)]
    if kernel == "mxint_layernorm":
        ops += [_operand("gamma", "float32", d, 4),
                _operand("beta", "float32", d, 4)]
    ops.append(_operand("out", "float32", rows * d, 4))
    return _row(label, kernel, {"rows": rows, "d": d, "act_block": act_block,
                                "route": "generic", "lut_bits": lut_bits},
                ops, f32_ops=ROW_OPS[kernel] * rows * d)


def _widened_rows(batch: int = 16) -> List[dict]:
    """DeiT-Base's kernels at batch 16 at the widened format its serve
    runs (W12 planes, act block 12, Table VI's vanilla LUTs: LN 13 bits,
    GELU 14, softmax r 16): the two GEMMs on the GEMM core by segment, the
    row kernels on their generic routes; and the FFN ``wo`` with float
    activations, on the generic route."""
    from repro_torch.kernels.mxint_gelu import gelu_table
    M, d, ff = batch * 197, 768, 3072
    w12 = dict(w_block=256, act_block=12, act_mant_bits=8, w_bytes=2)
    return [
        matmul_row("deit-base-ffn-wo-w12-a12", M, ff, d, **w12),
        matmul_row("deit-base-ln2-wi-w12-a12", M, d, ff, fused_ln=True,
                   lut_bits=13, **w12),
        generic_matmul_row("deit-base-ffn-wo-float-act", M, ff, d,
                           w_block=256, act_block=16, act_mant_bits=8,
                           w_bytes=1, quantize_act=False),
        generic_row_row("deit-base-softmax-r16", "mxint_softmax",
                        batch * 12 * 197, 197, act_block=1, lut_n=2 ** 16,
                        lut_bits=16),
        generic_row_row("deit-base-gelu-lut14", "mxint_gelu", M, ff,
                        act_block=12, lut_n=len(gelu_table("gelu", 14,
                                                           3.0)[0]),
                        lut_bits=14),
        generic_row_row("deit-base-final-ln-lut13", "mxint_layernorm", M, d,
                        act_block=12, lut_n=2 ** 13, lut_bits=13),
    ]


def _deit_base_rows(batch: int = 16, act_block: int = 16,
                    act_mant_bits: int = 8) -> List[dict]:
    """DeiT-Base's kernels in kernel mode at ``batch`` images (197 tokens,
    d 768, 12 heads, d_ff 3072, MXInt6 planes of 256-blocks; the
    softmax's 197 resolves its act block to 1), with their calls a
    forward (3 + 8 x 12 in all) and their scopes."""
    L, d, ff, M = DEIT_BASE_LAYERS, 768, 3072, batch * 197
    act = dict(act_block=act_block, act_mant_bits=act_mant_bits)
    attn, ffn = "block/{i}/attn", "block/{i}/ffn"
    return [
        matmul_row("deit-base-patch", batch * 196, d, d, w_block=256,
                   calls=1, scope="patch", **act),
        matmul_row("deit-base-ln1-qkv", M, d, d, w_block=256, fused_ln=True,
                   calls=3 * L, scope=attn, **act),
        softmax_row("deit-base-softmax", batch * 12 * 197, 197, calls=L,
                    scope=attn),
        matmul_row("deit-base-attn-wo", M, d, d, w_block=256, calls=L,
                   scope=attn, **act),
        matmul_row("deit-base-ln2-wi", M, d, ff, w_block=256, fused_ln=True,
                   calls=L, scope=ffn, **act),
        gelu_row("deit-base-gelu", M, ff, calls=L, scope=ffn),
        matmul_row("deit-base-ffn-wo", M, ff, d, w_block=256, calls=L,
                   scope=ffn, **act),
        layernorm_row("deit-base-final-ln", M, d, act_block=act_block,
                      calls=1, scope="final_ln"),
        matmul_row("deit-base-head", batch, d, 1000, w_block=256, calls=1,
                   scope="head", **act),
    ]


def build_table(act_block: int = 16, act_mant_bits: int = 8) -> List[dict]:
    """Every row at one act format: the four probe labels, then DeiT-Base's
    deployment."""
    act = dict(act_block=act_block, act_mant_bits=act_mant_bits)
    return [
        matmul_row("matmul-deit", 394, 192, 192, w_block=32, **act),
        flash_row("flash-deit", 6, 6, 197, 64, causal=False, elem_bytes=4),
        matmul_row("matmul-bench", 128, 1024, 512, w_block=256, **act),
        matmul_row("ln-matmul-bench", 256, 768, 768, w_block=32,
                   fused_ln=True, **act),
    ] + _deit_base_rows(**act) + _widened_rows()


_TABLE_MEMO: Dict[Tuple[int, int], List[dict]] = {}


def table(refresh: bool = False, *, act_block: int = 16,
          act_mant_bits: int = 8) -> List[dict]:
    """The cost table at one act format, memoized per format.  Rows are
    shallow copies; treat operand entries as read-only."""
    key = (act_block, act_mant_bits)
    if refresh or key not in _TABLE_MEMO:
        _TABLE_MEMO[key] = build_table(*key)
    return [dict(r) for r in _TABLE_MEMO[key]]


def query(labels: Optional[Sequence[str]] = None, *, act_block: int = 16,
          act_mant_bits: int = 8) -> Dict[str, dict]:
    """Label-keyed cost rows at one act format; with ``labels`` given,
    KeyError on any unknown label, naming the known ones."""
    rows = {r["label"]: r for r in table(act_block=act_block,
                                         act_mant_bits=act_mant_bits)}
    if labels is None:
        return rows
    missing = sorted(set(labels) - set(rows))
    if missing:
        raise KeyError(f"unknown cost-model labels {missing}; known: "
                       f"{sorted(rows)}")
    return {label: rows[label] for label in labels}


# the widened format's rows (``_widened_rows``)
WIDENED_LABELS = ("deit-base-ffn-wo-w12-a12", "deit-base-ln2-wi-w12-a12",
                  "deit-base-ffn-wo-float-act", "deit-base-softmax-r16",
                  "deit-base-gelu-lut14", "deit-base-final-ln-lut13")
DEIT_BASE_LABELS = ("deit-base-patch", "deit-base-ln1-qkv",
                    "deit-base-softmax", "deit-base-attn-wo",
                    "deit-base-ln2-wi", "deit-base-gelu", "deit-base-ffn-wo",
                    "deit-base-final-ln", "deit-base-head")


# ---------------------------------------------------------------------------
# the cost-model rule: a committed baseline, and the launch records
# ---------------------------------------------------------------------------
# the committed bytes of every row, beside this module
BASELINE = Path(__file__).resolve().parent / "cost_model_baseline.json"
REGRESSION_THRESHOLD = 0.02     # the reference's 2%


def baseline_payload() -> Dict[str, object]:
    return {"version": 1, "threshold_pct": 100 * REGRESSION_THRESHOLD,
            "rows": {r["label"]: {k: r[k] for k in
                                  ("hbm_bytes", "flops", "smem_bytes")}
                     for r in build_table()}}


def write_baseline(path: Path = BASELINE) -> Path:
    path.write_text(json.dumps(baseline_payload(), indent=1, sort_keys=True)
                    + "\n")
    return path


def compare_to_baseline(rows: Sequence[dict], baseline: Dict[str, object],
                        threshold: float = REGRESSION_THRESHOLD):
    """Rows whose bytes grew past ``threshold`` of the baseline's fail;
    those that shrank past it, and rows the baseline lacks, warn (refresh
    the baseline to keep the gain)."""
    from repro_torch.analysis.registry import WARN, Violation
    out = []
    current = {r["label"]: r for r in rows}
    base_rows = baseline.get("rows", {})
    for label, base in sorted(base_rows.items()):
        cur = current.get(label)
        if cur is None:
            out.append(Violation("cost-model", label,
                                 "baseline row has no current counterpart: "
                                 "the table shrank"))
            continue
        b, c = int(base["hbm_bytes"]), int(cur["hbm_bytes"])
        if c > b * (1 + threshold):
            out.append(Violation(
                "cost-model", label,
                f"device-memory traffic regression: {c} bytes against the "
                f"baseline's {b} (+{100.0 * (c - b) / b:.1f}% > "
                f"{100 * threshold:.0f}%); fix it or refresh the baseline "
                f"(python -m repro_torch.analysis --update-cost-baseline)"))
        elif c < b * (1 - threshold):
            out.append(Violation(
                "cost-model", label,
                f"device-memory traffic fell {100.0 * (b - c) / b:.1f}% "
                f"({c} against {b}): refresh the baseline to keep the gain",
                severity=WARN))
    for label in sorted(set(current) - set(base_rows)):
        out.append(Violation("cost-model", label,
                             "row missing from the committed baseline",
                             severity=WARN))
    return out


def row_launch(row: dict):
    """The ``LaunchRecord`` of the launch a table row prices."""
    from repro_torch.analysis.launch_contracts import launch
    from repro_torch.core.quantize import _resolve_block
    sh, k = row["shape"], row["kernel"]
    if k in ("mxint_matmul", "mxint_ln_matmul"):
        import torch
        from repro_torch.kernels.mxint_ln_matmul import LUT_BITS
        kw = dict(M=sh["M"], N=sh["N"], w_block=sh["w_block"],
                  act_block=sh["act_block"],
                  w_dtype={1: torch.int8, 2: torch.int16,
                           4: torch.int32}[sh["w_bytes"]])
        if k == "mxint_matmul":
            kw.update(K=sh["K"], act_mant_bits=sh["act_mant_bits"],
                      quantize_act=sh.get("quantize_act", True))
        else:
            kw.update(d=sh["K"], mant_bits=sh["act_mant_bits"],
                      lut_bits=sh.get("lut_bits", LUT_BITS))
        return launch(k, kw, row["label"])
    if sh.get("route") == "generic":  # a row kernel's generic route
        if k == "mxint_softmax":
            kw = dict(n=sh["d"], r_bits=sh["lut_bits"])
        elif k == "mxint_gelu":
            kw = dict(d=sh["d"], lut_bits=sh["lut_bits"], domain=3.0,
                      fn="gelu")
        else:
            kw = dict(d=sh["d"], lut_bits=sh["lut_bits"])
        return launch(k, dict(kw, rows=sh["rows"],
                              act_block=sh["act_block"]), row["label"])
    if k == "mxint_softmax":
        return launch(k, dict(rows=sh["rows"], n=sh["n"],
                              act_block=_resolve_block(sh["n"], 16), r_bits=2),
                      row["label"])
    if k == "mxint_gelu":
        return launch(k, dict(rows=sh["rows"], d=sh["d"],
                              act_block=_resolve_block(sh["d"], 16), lut_bits=5,
                              domain=3.0, fn="gelu"), row["label"])
    if k == "mxint_layernorm":
        return launch(k, dict(rows=sh["rows"], d=sh["d"],
                              act_block=sh["act_block"], lut_bits=5),
                      row["label"])
    import torch
    dtype = torch.float32 if row["operands"][0]["dtype"] == "float32" \
        else torch.bfloat16
    return launch(k, dict(bh=sh["heads"], sq=sh["S"], sk=sh["S"], d=sh["d"],
                          kv_groups=sh["heads"] // sh["kv_heads"],
                          dtype=dtype), row["label"])


def cross_check(rows: Sequence[dict]):
    """Each row's ``smem_bytes`` against the shared memory (dynamic plus
    static) of the launch record of the same label and shape."""
    from repro_torch.analysis.registry import Violation
    out = []
    for row in rows:
        rec = row_launch(row)
        if row["smem_bytes"] != rec.smem:
            out.append(Violation(
                "cost-model", row["label"],
                f"the table's shared memory {row['smem_bytes']} bytes != the "
                f"launch record's {rec.smem_dynamic} + {rec.smem_static} "
                f"({rec.function})"))
    return out


def _register():
    from repro_torch.analysis.registry import Violation, register_rule

    @register_rule(
        "cost-model",
        "the Hopper cost table's bytes against the committed baseline "
        "(over 2% more fails) and its shared memory against the launch "
        "records'")
    def run(root: Path, device: str = "cuda"):
        rows = build_table()
        out = cross_check(rows)
        if not BASELINE.exists():
            return out + [Violation(
                "cost-model", BASELINE.name, "the committed baseline is "
                "missing: python -m repro_torch.analysis "
                "--update-cost-baseline")]
        return out + compare_to_baseline(rows, json.loads(
            BASELINE.read_text()))
