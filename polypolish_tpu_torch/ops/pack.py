"""Read grouping, QC filtering and vote-event packing of the pure-Python
reader (counterpart of polypolish_tpu/ops/pack.py; reference:
alignment.rs:214-322).

It turns a stream of SAM lines into a flat *event stream* per contig:
(position, vocab_id, weight) triples in stream order.

- SAM lines are grouped by consecutive read name.
- ``--careful``: a read with >1 alignments contributes nothing.
- The read sequence comes from the first alignment in the group whose
  seq is not ``*`` (fatal if none); secondaries with ``*`` get it filled
  in, reverse-complemented when the strands differ.
- "Good" alignments: end-to-end (expanded CIGAR starts/ends with M/=),
  mismatches (NM) <= max_errors, and pass_qc (no ZP:Z:fail tag).
- depth_contribution = 1 / len(good alignments)  (alignment.rs:288).
- Each good alignment votes once per covered reference position with the
  read base(s) there ('-' for deletions), after homopolymer trimming.

Events are appended in exactly the order of the reference's
``PileupBase::add_seq`` calls, so the per-position f64 depth sums
(order-sensitive) come out bit-for-bit with a stable-by-position pass.
The native engine (native/runs.py) parses the same files into runs and
never fills a ``ContigVotes``.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional, TextIO, Tuple

import numpy as np

from polypolish_tpu_torch.errors import quit_with_error
from polypolish_tpu_torch.io.sam import (
    Alignment,
    error_label,
    parse_alignment_full,
)
from polypolish_tpu_torch.ops.cigar import (
    read_ranges_for_target_bases,
    trim_for_homopolymers,
)
from polypolish_tpu_torch.utils.revcomp import reverse_complement
from polypolish_tpu_torch.vocab import Vocab


class ContigVotes:
    """One assembly contig (the reference's ``Pileup``): name, FASTA
    description, sequence, and the vote events of the pure-Python
    reader, stored as growable lists while streaming and finalised into
    numpy arrays (pos int32, vocab int32, weight f64) in stream order."""

    __slots__ = ("name", "description", "seq", "length", "_pos", "_vocab",
                 "_weight", "_final")

    def __init__(self, name: str, description: str, seq: str) -> None:
        self.name = name
        self.description = description
        self.seq = seq
        self.length = len(seq)
        self._pos: List = []
        self._vocab: List = []
        self._weight: List = []
        self._final: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None

    def add_event(self, pos: int, vocab_id: int, weight: float) -> None:
        self._pos.append(pos)
        self._vocab.append(vocab_id)
        self._weight.append(weight)

    def extend_events(
        self, pos: np.ndarray, vocab: np.ndarray, weight: np.ndarray
    ) -> None:
        """Bulk append of event arrays, in stream order."""
        self._pos.append(pos)
        self._vocab.append(vocab)
        self._weight.append(weight)

    def finalize(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Return (pos, vocab, weight) arrays in stream order."""
        if self._final is None:
            self._final = (
                _concat(self._pos, np.int32),
                _concat(self._vocab, np.int32),
                _concat(self._weight, np.float64),
            )
            self._pos, self._vocab, self._weight = [], [], []
        return self._final

    @property
    def num_events(self) -> int:
        if self._final is not None:
            return int(self._final[0].shape[0])
        return sum(
            x.shape[0] if isinstance(x, np.ndarray) else 1 for x in self._pos
        )


def _concat(chunks: List, dtype) -> np.ndarray:
    """Scalars and arrays, in order, as one array of ``dtype``."""
    arrays = []
    scalars: List = []
    for c in chunks:
        if isinstance(c, np.ndarray):
            if scalars:
                arrays.append(np.asarray(scalars, dtype=dtype))
                scalars = []
            arrays.append(c.astype(dtype, copy=False))
        else:
            scalars.append(c)
    if scalars:
        arrays.append(np.asarray(scalars, dtype=dtype))
    if not arrays:
        return np.empty((0,), dtype=dtype)
    if len(arrays) == 1:
        return arrays[0]
    return np.concatenate(arrays)


def new_votes_from_fasta(
    fasta: List[Tuple[str, str, str]]
) -> Dict[str, ContigVotes]:
    return {name: ContigVotes(name, desc, seq) for name, desc, seq in fasta}


def process_sam(
    filename,
    votes: Dict[str, ContigVotes],
    vocab: Vocab,
    max_errors: int,
    careful: bool,
) -> Tuple[int, int, int]:
    """Stream one SAM file (plain, gzip or BAM) into the vote
    accumulators.  Returns (alignment_count, used_count, read_count);
    fatal errors match the reference (alignment.rs:214-272)."""
    from polypolish_tpu_torch.io.bam import open_sam_text

    try:
        f = open_sam_text(filename)
    except OSError:
        quit_with_error(f'unable to load alignments from "{filename}"')
    with f:
        return _process_sam_stream(f, filename, votes, vocab, max_errors,
                                   careful)


def _process_sam_stream(
    reader: TextIO,
    filename,
    votes: Dict[str, ContigVotes],
    vocab: Vocab,
    max_errors: int,
    careful: bool,
) -> Tuple[int, int, int]:
    current_read_name = ""
    current_group: List[Alignment] = []
    alignment_count = 0
    used_count = 0
    read_count = 0
    line_count = 0

    for line in reader:
        line_count += 1
        sam_line = line.rstrip("\n").rstrip("\r")
        if len(sam_line) == 0:
            continue
        if sam_line.startswith("@"):
            continue
        try:
            alignment = parse_alignment_full(sam_line)
        except ValueError as e:
            label = error_label(e)
            if label is None:
                raise
            quit_with_error(f'{label} in "{filename}" (line {line_count})')
        if not alignment.is_aligned():
            continue
        alignment_count += 1
        read_name = alignment.read_name
        if current_read_name == "" or current_read_name == read_name:
            current_group.append(alignment)
        else:
            used_count += process_one_read(
                current_group, votes, vocab, max_errors, careful
            )
            read_count += 1
            current_group = [alignment]
        current_read_name = read_name
    if current_group:
        used_count += process_one_read(
            current_group, votes, vocab, max_errors, careful
        )
        read_count += 1

    if alignment_count == 0:
        quit_with_error(f'no alignments in "{filename}"')
    return alignment_count, used_count, read_count


def process_one_read(
    group: List[Alignment],
    votes: Dict[str, ContigVotes],
    vocab: Vocab,
    max_errors: int,
    careful: bool,
) -> int:
    """Apply per-read QC and emit vote events (alignment.rs:275-305)."""
    if careful and len(group) > 1:
        return 0
    read_seq, strand = _get_read_seq_from_alignments(group)

    good = [
        a
        for a in group
        if a.starts_and_ends_with_match()
        and a.mismatches <= max_errors
        and a.pass_qc
    ]
    if not good:
        return 0
    depth_contribution = 1.0 / len(good)

    for a in good:
        if a.read_seq == "*":
            if a.get_strand() == strand:
                a.read_seq = read_seq
            else:
                a.read_seq = reverse_complement(read_seq)

    for a in good:
        contig = votes.get(a.ref_name)
        if contig is None:
            quit_with_error(
                f"query name {a.ref_name} in SAM but not in assembly"
            )
        _add_alignment_events(contig, a, depth_contribution, vocab)
    return len(good)


def _get_read_seq_from_alignments(group: List[Alignment]) -> Tuple[str, int]:
    """First non-'*' sequence in the group and its strand
    (alignment.rs:311-322)."""
    for a in group:
        if a.read_seq != "*":
            return a.read_seq, a.get_strand()
    quit_with_error(
        f"no alignments for read {group[0].read_name} contain sequence"
    )
    raise AssertionError("unreachable")


def _add_alignment_events(
    contig: ContigVotes, a: Alignment, weight: float, vocab: Vocab
) -> None:
    """Reference: pileup.rs:189-200 (the per-alignment hot loop)."""
    ranges = read_ranges_for_target_bases(
        a.expanded_cigar, len(a.read_seq), a.read_name, a.cigar
    )
    trim_for_homopolymers(ranges, a.read_seq)
    if not ranges:
        return
    pos = a.ref_start
    end_pos = pos + len(ranges)
    if end_pos > contig.length:
        quit_with_error(
            f"alignment for read {a.read_name} extends past the end of "
            f"contig {contig.name}"
        )
    seq = a.read_seq
    intern = vocab.intern
    add = contig.add_event
    char_ids = vocab._char_ids
    for p, (s, e) in zip(itertools.count(pos), ranges):
        if e == s:
            add(p, 0, weight)  # VOCAB_DEL
        elif e - s == 1:
            code = ord(seq[s])
            vid = char_ids[code] if code < 256 else -1
            if vid < 0:
                vid = intern(seq[s])
            add(p, vid, weight)
        else:
            add(p, intern(seq[s:e]), weight)
