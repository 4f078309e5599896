"""Core type definitions for the MXInt (Microscaling Integer) format.

A block of values shares one 8-bit exponent while each value keeps a small
signed-integer mantissa; a value is reconstructed as ``x = 2**e_block * m``
(paper Eq. 2).  Counterpart of ``repro.core.mx_types``: the formats, the
non-linear datapath knobs, and ``QuantConfig`` with its per-layer-group
overrides.
"""
from __future__ import annotations

import dataclasses
import fnmatch
import functools
import math
from typing import Optional

import torch

# The five execution-mode names (see ``QuantConfig``).
MODES = ("off", "fake", "sim", "packed", "kernel")

# Masking sentinel shared by the attention models, ops and kernels (the
# reference's value, -2e38, built here so that no module spells it out).
# The Eq. 2-3 score quantization runs on the masked tile, so every fill
# of a masked score must use this one value.
NEG_INF = -2.0 * 10.0 ** 38


@dataclasses.dataclass(frozen=True)
class MXFormat:
    """An MXInt element format.

    mant_bits: signed mantissa width in bits, sign included (MXInt8 = 8).
    block_size: number of elements sharing one exponent (paper: 16 for
      activations, 256 for weights).
    exp_bits: stored width of the shared exponent; always 8.
    """

    mant_bits: int = 8
    block_size: int = 32
    exp_bits: int = 8

    def __post_init__(self):
        if isinstance(self.mant_bits, bool) or \
                not isinstance(self.mant_bits, int):
            raise TypeError(f"mant_bits must be an int, "
                            f"got {type(self.mant_bits).__name__}")
        if not (2 <= self.mant_bits <= 24):
            raise ValueError(f"mant_bits must be in [2, 24], got {self.mant_bits}")
        if isinstance(self.block_size, bool) or \
                not isinstance(self.block_size, int):
            raise TypeError(f"block_size must be an int, "
                            f"got {type(self.block_size).__name__}")
        if self.block_size < 1:
            raise ValueError("block_size must be >= 1")
        if self.exp_bits != 8:
            raise ValueError("MXInt exponent is always 8 bits in this work")

    @property
    def bits_per_element(self) -> float:
        """Amortized bits per element (the paper's W6.03 / A8.5 notation)."""
        return self.mant_bits + self.exp_bits / self.block_size

    @property
    def mant_dtype(self) -> torch.dtype:
        if self.mant_bits <= 8:
            return torch.int8
        if self.mant_bits <= 16:
            return torch.int16
        return torch.int32

    @property
    def mant_max(self) -> int:
        return 2 ** (self.mant_bits - 1) - 1

    @property
    def mant_min(self) -> int:
        # symmetric clip keeps quantization idempotent and sign-symmetric
        return -(2 ** (self.mant_bits - 1) - 1)

    def density_vs(self, baseline_bits: float = 32.0) -> float:
        """Memory density multiplier against a scalar format (Fig. 1b)."""
        return baseline_bits / self.bits_per_element


MXINT8_ACT = MXFormat(mant_bits=8, block_size=16)      # A8.5
MXINT8_WEIGHT = MXFormat(mant_bits=8, block_size=256)
MXINT6_WEIGHT = MXFormat(mant_bits=6, block_size=256)  # W6.03
MXINT6_ACT = MXFormat(mant_bits=6, block_size=16)
MXINT4_WEIGHT = MXFormat(mant_bits=4, block_size=256)
# the OCP Microscaling MXINT8 layout: int8 mantissas, block 32
MXINT8_OCP = MXFormat(mant_bits=8, block_size=32)


@dataclasses.dataclass(frozen=True)
class NonlinearConfig:
    """Datapath knobs of the three non-linear operators (paper §III-B).

    Defaults are the paper's final design points: rsqrt LUT index bits 5,
    GELU domain a = 3 with 5 LUT bits, softmax r bits 2.
    """

    ln_lut_bits: int = 5
    gelu_domain: float = 3.0
    gelu_lut_bits: int = 5
    softmax_r_bits: int = 2
    softmax_out_bits: int = 8
    acc_frac_bits: int = 12

    @property
    def ln_lut_entries(self) -> int:
        return 2 ** self.ln_lut_bits

    @property
    def gelu_index_bits(self) -> int:
        """Fig. 6: LUT bitwidth + log2(LUT domain) - 1 (ceil)."""
        return self.gelu_lut_bits + max(math.ceil(math.log2(self.gelu_domain)), 0) - 1

    @property
    def gelu_lut_entries(self) -> int:
        return 2 ** self.gelu_index_bits

    @property
    def softmax_lut_entries(self) -> int:
        return 2 ** self.softmax_r_bits


@dataclasses.dataclass(frozen=True)
class QuantOverride:
    """A per-layer-group patch on a ``QuantConfig``.

    Every field is optional; None inherits from the base config.  A config
    carries overrides as ``(pattern, override)`` pairs, ``pattern`` an
    ``fnmatch`` glob matched against the scope tag a model passes at its
    call sites ("block/3/ffn", "head", ...): per-layer-group backends,
    formats and LUT widths without forking the model code.
    """

    mode: Optional[str] = None
    weight_fmt: Optional[MXFormat] = None
    act_fmt: Optional[MXFormat] = None
    nonlinear: Optional[NonlinearConfig] = None
    quantize_nonlinear: Optional[bool] = None

    _FIELDS = ("mode", "weight_fmt", "act_fmt", "nonlinear",
               "quantize_nonlinear")

    def patch(self) -> dict:
        """The fields that are not None, as ``dataclasses.replace`` kwargs."""
        return {f: getattr(self, f) for f in self._FIELDS
                if getattr(self, f) is not None}


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Quantization policy for a model.

    ``mode`` names the execution backend (one of ``MODES``):

      "off"    -- the float reference path;
      "fake"   -- quantize-dequantize of the linears' weights and
                  activations in float, straight-through gradients;
      "sim"    -- the bit-accurate MXInt emulation (``core/nonlinear.py``
                  for LayerNorm, GELU/SiLU and softmax), the oracle the
                  kernels are held against;
      "packed" -- packed int8 weight planes dequantized into float
                  linears, the non-linear datapaths as in "sim";
      "kernel" -- packed planes fed straight into the hand-written Hopper
                  kernels, LayerNorm, GELU and softmax on the in-kernel
                  MXInt datapaths when ``quantize_nonlinear`` is set.

    ``emulate`` swaps the linears' MXInt grid for the Table V baselines
    ("int": per-tensor integers, "fp8": e4m3); ``nl_emulate`` swaps the
    non-linear datapaths for the Tables II-IV baselines ("fixedpoint",
    "relu6").  Both are float emulations with no kernel counterpart.
    ``overrides``: ``(glob, QuantOverride)`` pairs resolved by ``scoped``.
    """

    mode: str = "off"
    weight_fmt: MXFormat = MXINT6_WEIGHT
    act_fmt: MXFormat = MXINT8_ACT
    nonlinear: Optional[NonlinearConfig] = None
    quantize_nonlinear: bool = False
    nl_ops: tuple = ("layernorm", "gelu", "softmax")
    emulate: Optional[str] = None
    nl_emulate: Optional[str] = None
    overrides: tuple = ()

    def __post_init__(self):
        mode = getattr(self, "mode")
        if mode not in MODES:
            raise ValueError(f"unknown quant mode {mode!r}")
        if self.emulate not in (None, "int", "fp8"):
            raise ValueError(f"unknown emulate {self.emulate!r}")
        if mode == "kernel" and (self.emulate is not None or
                                 self.nl_emulate is not None):
            raise ValueError("mode='kernel' runs the MXInt kernel datapaths; "
                             "emulate/nl_emulate baselines are float "
                             "emulations only")
        if self.quantize_nonlinear and self.nonlinear is None:
            object.__setattr__(self, "nonlinear", NonlinearConfig())
        entries = getattr(self, "overrides")
        if entries:
            norm = []
            for entry in entries:
                try:
                    pattern, ov = entry
                except (TypeError, ValueError):
                    raise ValueError(
                        f"overrides entries must be (pattern, QuantOverride) "
                        f"pairs, got {entry!r}") from None
                if not isinstance(pattern, str) or not pattern:
                    raise ValueError(f"override pattern must be a non-empty "
                                     f"glob string, got {pattern!r}")
                if not isinstance(ov, QuantOverride):
                    raise TypeError(f"override for {pattern!r} must be a "
                                    f"QuantOverride, got "
                                    f"{type(ov).__name__}")
                norm.append((pattern, ov))
            object.__setattr__(self, "overrides", tuple(norm))

    @property
    def enabled(self) -> bool:
        return getattr(self, "mode") != "off"

    def modes(self) -> frozenset:
        """Every execution mode this config resolves to in some layer
        group: its own and each override's (an override without a mode
        inherits this one).  The one answer to "which backends can run?"
        that callers outside the seam may ask."""
        own = getattr(self, "mode")
        return frozenset({own} | {getattr(ov, "mode") or own
                                  for _, ov in getattr(self, "overrides")})

    @property
    def has_overrides(self) -> bool:
        """True when per-layer-group patches are attached."""
        return bool(getattr(self, "overrides"))

    def scoped(self, scope: Optional[str]) -> "QuantConfig":
        """The effective config for layer group ``scope``.

        Matching patterns apply in declaration order, later entries
        winning field by field; the result has no overrides (so scoping is
        idempotent) and is cached per scope on this instance.  With no
        overrides, or ``scope`` None, this is ``self``.
        """
        if scope is None or not self.has_overrides:
            return self
        cache = self.__dict__.setdefault("_scoped_cache", {})
        got = cache.get(scope)
        if got is None:
            patch: dict = {}
            for pattern, ov in getattr(self, "overrides"):
                if fnmatch.fnmatchcase(scope, pattern):
                    patch.update(ov.patch())
            got = cache[scope] = dataclasses.replace(self, overrides=(),
                                                     **patch)
        return got

    def describe(self) -> dict:
        """JSON-serializable summary of the config."""
        nl = self.nonlinear
        return {
            "mode": getattr(self, "mode"),
            "weight_fmt": {"mant_bits": self.weight_fmt.mant_bits,
                           "block_size": self.weight_fmt.block_size},
            "act_fmt": {"mant_bits": self.act_fmt.mant_bits,
                        "block_size": self.act_fmt.block_size},
            "quantize_nonlinear": self.quantize_nonlinear,
            "nonlinear": None if nl is None else {
                "ln_lut_bits": nl.ln_lut_bits,
                "gelu_lut_bits": nl.gelu_lut_bits,
                "softmax_r_bits": nl.softmax_r_bits},
        }

    @functools.cached_property
    def datapath(self):
        """The execution backend this config resolves to, cached on the
        instance."""
        from repro_torch.datapath import resolve
        return resolve(self)
