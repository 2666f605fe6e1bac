"""Pileup vocabulary: interned sequence strings -> integer ids.

The reference (pileup.rs:29-41) splits counters into fast u32 fields for
A/C/G/T and a HashMap for everything else (deletions ``-``, N, IUPAC
codes, multi-base insertion strings like ``AG``).  The TPU-native design
needs fixed-width integer ids instead of strings, so every pileup "vote"
is a (position, vocab_id) pair:

- **Dense tier** (ids 0..7): ``-``, A, C, G, T, N + two reserved slots.
  These are counted on-device in the (8, P) count tensor.  8 sublanes x
  P lanes matches the TPU (8, 128) f32/i32 tile exactly.
- **Sparse tier** (ids >= 8): rare strings (multi-base insertions, odd
  characters), interned on the host and counted host-side.  This mirrors
  the reference's u32-fast-path + HashMap split.

Consensus parity note: the reference always buckets A/C/G/T (even at
count 0 they can land in the "intermediate" set when invalid_threshold is
0), but HashMap entries exist only with count >= 1.  Ids 1..4 therefore
always participate in consensus; all other ids require count >= 1.
"""

from __future__ import annotations

from typing import Dict, List

VOCAB_DEL = 0  # "-" : deletion vote (zero-length read range)
VOCAB_A = 1
VOCAB_C = 2
VOCAB_G = 3
VOCAB_T = 4
VOCAB_N = 5
DENSE_V = 8  # dense-tier width (device count tensor sublane dim)

# Reserved placeholder strings for unused dense slots 6 and 7.  They start
# with NUL, which cannot occur in a tab-separated SAM field, so they can
# never collide with a real pileup sequence.
_RESERVED_6 = "\x00r6"
_RESERVED_7 = "\x00r7"

_FIXED_STRINGS = ["-", "A", "C", "G", "T", "N", _RESERVED_6, _RESERVED_7]


class Vocab:
    """Grow-only intern table shared across all contigs and SAM files."""

    __slots__ = ("strings", "index", "_char_ids")

    def __init__(self) -> None:
        self.strings: List[str] = list(_FIXED_STRINGS)
        self.index: Dict[str, int] = {
            s: i for i, s in enumerate(_FIXED_STRINGS) if not s.startswith("\x00")
        }
        # Fast path: single-character sequence -> id, by code point.
        self._char_ids: List[int] = [-1] * 256
        for ch, vid in (("-", 0), ("A", 1), ("C", 2), ("G", 3), ("T", 4), ("N", 5)):
            self._char_ids[ord(ch)] = vid

    def intern(self, seq: str) -> int:
        """Return the id for `seq`, creating a sparse-tier id if new."""
        if len(seq) == 1:
            code = ord(seq)
            if code < 256:
                vid = self._char_ids[code]
                if vid >= 0:
                    return vid
        vid = self.index.get(seq)
        if vid is None:
            vid = len(self.strings)
            self.strings.append(seq)
            self.index[seq] = vid
            if len(seq) == 1 and ord(seq) < 256:
                self._char_ids[ord(seq)] = vid
        return vid

    def string(self, vid: int) -> str:
        return self.strings[vid]

    def __len__(self) -> int:
        return len(self.strings)
