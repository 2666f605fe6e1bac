"""Per-contig quality metrics + Q-score (reference: polish.rs:206-227,290-300)."""

from __future__ import annotations

import math


def qscore(identity: float) -> str:
    """Estimated Q-score string (polish.rs:290-300): Q∞ at >=100, Q0 at <=0."""
    if identity >= 100.0:
        return "Q∞"
    if identity <= 0.0:
        return "Q0"
    errors = 1.0 - (identity / 100.0)
    q = -10.0 * math.log10(errors)
    return f"Q{q:.2f}"
