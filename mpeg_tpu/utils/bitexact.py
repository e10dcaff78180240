"""Bit-exactness environment helpers.

The decode pipelines are bit-exact against the reference decoder on an
NVIDIA H100 as compiled by XLA:GPU (its PTX rounds every f32 mul and add
on its own — `mul.rn.f32` / `add.rn.f32`, which ptxas never fuses — and
the video path is int32).  On x86 CPU hosts, XLA:CPU's LLVM backend
contracts f32 mul+add chains into FMA instructions inside fused loops,
which perturbs the MP2 filterbank by a few ulps and breaks the no-FMA
golden hashes.

The video path is all-integer and immune.

`enable_cpu_bitexact()` caps the CPU codegen ISA below FMA support, which
removes the contraction entirely.  It must run before JAX initializes its
CPU backend (i.e. before the first computation).
"""

from __future__ import annotations

import os

_ISA_FLAG = "--xla_cpu_max_isa=SSE4_2"


def enable_cpu_bitexact() -> None:
    """Make XLA:CPU compilation bit-exact (no FMA contraction).

    Appends the ISA cap to XLA_FLAGS if not present.  No effect on GPU
    compilation.  Call before the first JAX computation.
    """
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_cpu_max_isa" not in flags:
        os.environ["XLA_FLAGS"] = (flags + " " + _ISA_FLAG).strip()
