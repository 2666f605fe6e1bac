"""Reverse complement with the full IUPAC table (counterpart of
polypolish_tpu/utils/revcomp.py; reference: misc.rs:170-191).

Implemented as a 256-entry bytes translation table so whole reads reverse-
complement in one C-level pass (the reference loops per char).
Any byte not in the table maps to 'N', matching the reference's fallback.
"""

from __future__ import annotations

_PAIRS = {
    "A": "T", "T": "A", "G": "C", "C": "G",
    "a": "t", "t": "a", "g": "c", "c": "g",
    "N": "N", "n": "n",
    "R": "Y", "Y": "R", "S": "S", "W": "W", "K": "M", "M": "K",
    "B": "V", "V": "B", "D": "H", "H": "D",
    "r": "y", "y": "r", "s": "s", "w": "w", "k": "m", "m": "k",
    "b": "v", "v": "b", "d": "h", "h": "d",
    ".": ".", "-": "-", "?": "?",
}

_TABLE = bytes(
    ord(_PAIRS[chr(b)]) if chr(b) in _PAIRS else ord("N") for b in range(256)
)


def reverse_complement(seq: str) -> str:
    """Reverse-complement a sequence string (misc.rs:185-191)."""
    return seq.encode("latin-1")[::-1].translate(_TABLE).decode("latin-1")


def reverse_complement_bytes(seq: bytes) -> bytes:
    return seq[::-1].translate(_TABLE)
