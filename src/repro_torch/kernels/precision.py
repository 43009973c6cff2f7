"""The kernel layer's precision policy: f32 or bf16 tiles, f32 accumulation.

The *tile* dtype (``Precision.tile``) is the dtype the feature and landmark
operands have when they enter a kernel; bf16 halves their bytes and runs the
products on the tensor cores. The *accumulator* is not a knob: every kernel
sums in f32, and ``Precision(accum=...)`` rejects anything else, so a
low-precision accumulator cannot be configured.

The plain versions (``kernels/ref.py``) round their operands to the tile
dtype first and then run all math in f32 — the same contract as the kernels —
so kernel-vs-plain comparisons stay tight at either precision. The
count-sketch sign table is stored as int8 under bf16 (``sign_dtype``).
"""
from __future__ import annotations

import dataclasses

import torch

PRECISIONS = ("f32", "bf16")

_TILE_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class Precision:
    """tile: "f32" | "bf16"; accum: always "f32" (anything else raises)."""
    tile: str = "f32"
    accum: str = "f32"

    def __post_init__(self):
        if self.tile not in PRECISIONS:
            raise ValueError(
                f"tile precision must be one of {PRECISIONS}, "
                f"got {self.tile!r}")
        if self.accum != "f32":
            raise ValueError(
                "accumulation is always f32 in this kernel layer "
                f"(got accum={self.accum!r}); bf16 applies to tiles only")

    @property
    def tile_dtype(self) -> torch.dtype:
        return _TILE_DTYPES[self.tile]

    @property
    def tile_itemsize(self) -> int:
        return 4 if self.tile == "f32" else 2

    @property
    def sign_dtype(self) -> torch.dtype:
        """Storage dtype of the count-sketch sign table: int8 under bf16
        (±1 is exact in both), f32 at full precision."""
        return torch.int8 if self.tile == "bf16" else torch.float32

    def cast_tiles(self, a: torch.Tensor) -> torch.Tensor:
        """Round a tile operand to the tile dtype, once (round to nearest
        even under bf16; exact for bf16 input under f32). A tensor already
        in the tile dtype comes back as it is, without the cost of a
        ``Tensor.to`` call (several microseconds a launch)."""
        dtype = _TILE_DTYPES[self.tile]
        return a if a.dtype == dtype else a.to(dtype)


F32 = Precision()
BF16 = Precision(tile="bf16")


def resolve_precision(precision) -> Precision:
    """Accept a Precision or a name ("f32" | "bf16") and return the policy."""
    if isinstance(precision, Precision):
        return precision
    if isinstance(precision, str) and precision in PRECISIONS:
        return BF16 if precision == "bf16" else F32
    raise ValueError(
        f"precision must be a Precision or one of {PRECISIONS}, "
        f"got {precision!r}")
