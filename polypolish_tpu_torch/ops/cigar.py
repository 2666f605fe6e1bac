"""CIGAR engine: expansion, target-base mapping, homopolymer trimming
(counterpart of polypolish_tpu/ops/cigar.py; reference: alignment.rs:27-29,
138-201, 325-378).

- A CIGAR is a sequence of ``<count><op>`` tokens with op in MIDNSHP=X.
  Validation: the regex-matched tokens must cover the whole string;
  ``*`` expands to the empty string.
- The *target-base mapping* walks the expanded CIGAR and yields, for each
  reference position covered, a (start, end) index range into the read:
  M/=/X -> (i, i+1); I extends the previous range's end; D -> (i, i);
  any other op (S/H/N/P) is fatal at this stage because only end-to-end
  alignments reach it.  Sanity check: the walk must consume exactly the
  whole read.
- *Homopolymer trim*: alignments ending in a homopolymer can align
  cleanly even when an indel is needed, so the trailing run of ranges
  whose read substring equals the final range's substring is dropped,
  plus one more range.

These are per-alignment sequential rules of the pure-Python reader
(``--pure-python``); the native engine has its own C++ copy.
"""

from __future__ import annotations

import re
from typing import List, Tuple

from polypolish_tpu_torch.errors import quit_with_error

_CIGAR_TOKEN = re.compile(r"(\d+)([MIDNSHP=X])")

# Ops that consume reference bases (used for ref_end; alignment.rs:138-149).
_REF_CONSUMING = frozenset("MDN=X")


class InvalidCigar(ValueError):
    pass


def expand_cigar(cigar: str) -> str:
    """Run-length expand a CIGAR to one char per op (alignment.rs:325-346).

    ``*`` -> "".  Raises InvalidCigar if the token stream does not cover
    the entire string (bad op letter, doubled letters, trailing digits).
    """
    if cigar == "*":
        return ""
    parts: List[str] = []
    total_len = 0
    for m in _CIGAR_TOKEN.finditer(cigar):
        parts.append(m.group(2) * int(m.group(1)))
        total_len += m.end() - m.start()
    if total_len != len(cigar):
        raise InvalidCigar(cigar)
    return "".join(parts)


def ref_end_from_cigar(cigar: str, ref_start: int) -> int:
    """ref_start + total reference-consuming length (alignment.rs:138-149).
    Invalid tokens are skipped, as the reference's token regex skips
    them."""
    ref_end = ref_start
    for m in _CIGAR_TOKEN.finditer(cigar):
        if m.group(2) in _REF_CONSUMING:
            ref_end += int(m.group(1))
    return ref_end


def read_ranges_for_target_bases(
    expanded_cigar: str, read_seq_len: int, read_name: str, cigar: str
) -> List[Tuple[int, int]]:
    """Map each covered reference position to a read index range
    (alignment.rs:175-198, fatal errors included).  The first op is M
    or = after the end-to-end filter, so I always has a range to
    extend."""
    i = 0
    ranges: List[Tuple[int, int]] = []
    for c in expanded_cigar:
        if c == "M" or c == "=" or c == "X":
            ranges.append((i, i + 1))
            i += 1
        elif c == "I":
            s, _ = ranges[-1]
            ranges[-1] = (s, i + 1)
            i += 1
        elif c == "D":
            ranges.append((i, i))
        else:
            quit_with_error(
                f"unexpected character (other than M, =, X, I or D) in CIGAR "
                f'string for read {read_name}: "{cigar}" - did you use BWA MEM '
                f"to generate your alignments?"
            )
    if i != read_seq_len:
        quit_with_error(
            f"CIGAR string for read {read_name} does not match read sequence"
        )
    return ranges


def trim_for_homopolymers(
    ranges: List[Tuple[int, int]], read_seq: str
) -> List[Tuple[int, int]]:
    """Drop the trailing homopolymer run plus one extra range, in place
    (alignment.rs:349-378).  Returns the (mutated) list."""
    last_start, last_end = ranges[-1]
    last_base = read_seq[last_start:last_end]
    while ranges:
        cur_start, cur_end = ranges[-1]
        if read_seq[cur_start:cur_end] != last_base:
            break
        ranges.pop()
    if ranges:
        ranges.pop()
    return ranges
