"""Round-half-to-even ("banker's rounding") on f64, bit-exact with the
reference (misc.rs:204-215).

The consensus thresholds are ``bankers_rounding(depth * fraction)`` and a
one-count difference flips polishing decisions, so this must reproduce the
reference's exact f64 semantics:

    rounded_down = float as u32        (truncation toward zero)
    fract < 0.5  -> rounded_down
    fract > 0.5  -> rounded_down + 1
    fract == 0.5 -> rounded_down + (rounded_down & 1)

Inputs are always >= 0 in this tool (depth * fraction).
"""

from __future__ import annotations

import numpy as np


def bankers_rounding(x: float) -> int:
    """Scalar round-half-to-even for non-negative f64 (misc.rs:208-215)."""
    rounded_down = int(x)  # truncation toward zero, same as Rust `as u32`
    fract = x - rounded_down
    if fract < 0.5:
        return rounded_down
    if fract > 0.5:
        return rounded_down + 1
    return rounded_down + (rounded_down & 1)


def bankers_rounding_vec(x: np.ndarray) -> np.ndarray:
    """Vectorised round-half-to-even over a non-negative f64 array.

    Every elementwise operation here is a single IEEE-754 f64 op, so the
    result is bit-identical to applying the scalar rule per element.
    Returns int64 (the reference's u32 values always fit).
    """
    x = np.asarray(x, dtype=np.float64)
    rounded_down = np.trunc(x)
    fract = x - rounded_down
    out = rounded_down.astype(np.int64)
    out[fract > 0.5] += 1
    ties = fract == 0.5
    if ties.any():
        out[ties] += out[ties] & 1
    return out
