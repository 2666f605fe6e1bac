"""FASTA reading/writing (reference: misc.rs:38-167, polish.rs:196-203).

Gzip is auto-detected from the two magic bytes (31, 139).  Sequences are
ASCII-uppercased.  Checks (all fatal, matching the reference): file has
>= 2 bytes, contains >= 1 sequence, no unnamed sequences, no empty
sequences, no duplicate names, first record line starts with '>'.

Header parsing splits on the *first single whitespace char*: name is
everything before it, description everything after it (misc.rs:118-120
uses splitn(2, char::is_whitespace), which keeps any further whitespace
inside the description).
"""

from __future__ import annotations

import gzip
import os
import re
from typing import IO, List, Tuple

from polypolish_tpu_torch.errors import quit_with_error

_WS_SPLIT = re.compile(r"\s")


def _is_file_gzipped(filename: str | os.PathLike) -> bool:
    """Sniff the gzip magic bytes (misc.rs:81-99)."""
    try:
        f = open(filename, "rb")
    except OSError:
        quit_with_error(f'unable to open "{filename}"')
    with f:
        buf = f.read(2)
    if len(buf) < 2:
        quit_with_error(f'"{filename}" is too small')
    return buf[0] == 31 and buf[1] == 139


def _parse_fasta_stream(
    reader: IO[str], filename: str | os.PathLike
) -> List[Tuple[str, str, str]]:
    fasta_seqs: List[Tuple[str, str, str]] = []
    name = ""
    description = ""
    sequence_parts: List[str] = []
    for line in reader:
        text = line.rstrip("\n").rstrip("\r")
        if len(text) == 0:
            continue
        if text.startswith(">"):
            if len(name) > 0:
                seq = "".join(sequence_parts)
                fasta_seqs.append((name, description, _ascii_upper(seq)))
                sequence_parts = []
            split = _WS_SPLIT.split(text[1:], maxsplit=1)
            name = split[0] if split else ""
            description = split[1] if len(split) > 1 else ""
        else:
            if len(name) == 0:
                quit_with_error(f'"{filename}" is not correctly formatted')
            sequence_parts.append(text)
    if len(name) > 0:
        seq = "".join(sequence_parts)
        fasta_seqs.append((name, description, _ascii_upper(seq)))
    return fasta_seqs


def _ascii_upper(s: str) -> str:
    """ASCII-only uppercase (the reference uses make_ascii_uppercase)."""
    return s.encode("latin-1", errors="replace").upper().decode("latin-1")


def load_fasta(filename: str | os.PathLike) -> List[Tuple[str, str, str]]:
    """Load a (possibly gzipped) FASTA file -> [(name, description, seq)].

    Reference: misc.rs:38-51 plus the checks in misc.rs:56-75.
    """
    gzipped = _is_file_gzipped(filename)
    try:
        if gzipped:
            with gzip.open(filename, "rt", encoding="latin-1") as reader:
                fasta_seqs = _parse_fasta_stream(reader, filename)
        else:
            with open(filename, "rt", encoding="latin-1") as reader:
                fasta_seqs = _parse_fasta_stream(reader, filename)
    except (OSError, EOFError, gzip.BadGzipFile):
        quit_with_error(f'unable to load "{filename}"')
    _check_load_fasta(fasta_seqs, filename)
    return fasta_seqs


def _check_load_fasta(
    fasta_seqs: List[Tuple[str, str, str]], filename: str | os.PathLike
) -> None:
    """Reference: misc.rs:56-75."""
    if len(fasta_seqs) == 0:
        quit_with_error(f'"{filename}" contains no sequences')
    for name, _, sequence in fasta_seqs:
        if len(name) == 0:
            quit_with_error(f'"{filename}" has an unnamed sequence')
        if len(sequence) == 0:
            quit_with_error(f'"{filename}" has an empty sequence')
    names = {name for name, _, _ in fasta_seqs}
    if len(names) < len(fasta_seqs):
        quit_with_error(f'"{filename}" has a duplicated name')


def open_text_auto(filename: str | os.PathLike, mode: str = "rt") -> IO[str]:
    """Open a text file, transparently decompressing gzip (sniffed from
    the magic bytes for reads; chosen by a .gz suffix for writes).

    Extension over the reference, which supports gzip only for FASTA.
    """
    if "r" in mode:
        # tolerant sniff: short files are simply not gzipped (unlike the
        # FASTA loader, which treats <2 bytes as fatal per the reference)
        with open(filename, "rb") as f:
            head = f.read(2)
        if len(head) == 2 and head[0] == 31 and head[1] == 139:
            return gzip.open(filename, mode, encoding="latin-1")
        return open(filename, mode, encoding="latin-1")
    if str(filename).endswith(".gz"):
        return gzip.open(filename, mode, encoding="latin-1")
    return open(filename, mode, encoding="latin-1")


def write_fasta_record(out: IO[str], name: str, description: str, seq: str) -> None:
    """Emit one polished record to stdout (polish.rs:196-203).

    The header is ``>{name}[ {description}] polypolish`` — a literal
    " polypolish" token is appended so downstream tools can tell the
    sequence was polished.
    """
    header = f">{name}"
    if len(description) > 0:
        header += f" {description}"
    header += " polypolish"
    out.write(header + "\n")
    out.write(seq + "\n")
