"""BAM input of the pure-Python reader (counterpart of
polypolish_tpu/io/bam.py; an extension over the reference, which reads
plain SAM only; SAM spec section 4): sniffing, and BAM -> SAM text
conversion for ``--pure-python``.  The native twin in sam_packer.cc
(LoadedInput / bam_to_sam_text) renders byte-identical text, so every
downstream parity property holds for BAM inputs too.
"""

from __future__ import annotations

import gzip
import struct
import zlib
from typing import IO, Iterator, Union

CIGAR_OPS = "MIDNSHP=X"
SEQ16 = "=ACMGRSVTWYHKDBN"
_INT_TAGS = {
    "c": ("b", 1), "C": ("B", 1), "s": ("<h", 2), "S": ("<H", 2),
    "i": ("<i", 4), "I": ("<I", 4),
}


def _read_head(filename) -> bytes:
    with open(filename, "rb") as f:
        head = f.read(18)
    if len(head) >= 2 and head[0] == 0x1F and head[1] == 0x8B:
        # peek through the gzip wrapper (BGZF is plain gzip members)
        try:
            with gzip.open(filename, "rb") as g:
                return g.read(4)
        except OSError:
            return b""
    return head[:4]


def is_bam(filename) -> bool:
    """True when the (possibly gzip/BGZF-wrapped) payload is BAM."""
    return _read_head(filename) == b"BAM\x01"


def _inflate_all(filename) -> bytes:
    with open(filename, "rb") as f:
        raw = f.read()
    if len(raw) >= 2 and raw[0] == 0x1F and raw[1] == 0x8B:
        out = []
        pos = 0
        while pos < len(raw):
            d = zlib.decompressobj(15 + 32)
            out.append(d.decompress(raw[pos:]))
            if not d.eof:
                # Input exhausted mid-member: a truncated prefix would
                # otherwise decode "cleanly" and silently drop records.
                raise ValueError("truncated gzip stream")
            pos = len(raw) - len(d.unused_data)
            if not d.unused_data:
                break
        return b"".join(out)
    return raw


def _render_tags(buf: memoryview, out: list) -> None:
    # Bounds-checked like the native twin (sam_packer.cc
    # bam_tags_to_sam): malformed payloads raise the same clean
    # "truncated BAM tag" / "unterminated BAM string tag" errors
    # instead of escaping as IndexError/struct.error.
    p = 0
    n = len(buf)
    while p < n:
        if n - p < 3:
            raise ValueError("truncated BAM tag")
        tag = bytes(buf[p:p + 2]).decode("latin-1")
        typ = chr(buf[p + 2])
        p += 3
        if typ == "A":
            if n - p < 1:
                raise ValueError("truncated BAM tag")
            out.append(f"\t{tag}:A:{chr(buf[p])}")
            p += 1
        elif typ in _INT_TAGS:
            fmt, w = _INT_TAGS[typ]
            if n - p < w:
                raise ValueError("truncated BAM tag")
            (v,) = struct.unpack_from(fmt, buf, p)
            p += w
            out.append(f"\t{tag}:i:{v}")
        elif typ == "f":
            if n - p < 4:
                raise ValueError("truncated BAM tag")
            (v,) = struct.unpack_from("<f", buf, p)
            p += 4
            out.append(f"\t{tag}:f:{v:g}")
        elif typ in ("Z", "H"):
            end = p
            while end < n and buf[end]:
                end += 1
            if end >= n:
                raise ValueError("unterminated BAM string tag")
            out.append(f"\t{tag}:{typ}:"
                       + bytes(buf[p:end]).decode("latin-1"))
            p = end + 1
        elif typ == "B":
            if n - p < 5:
                raise ValueError("truncated BAM tag")
            sub = chr(buf[p])
            (cnt,) = struct.unpack_from("<I", buf, p + 1)
            p += 5
            if sub != "f" and sub not in _INT_TAGS:
                raise ValueError("bad BAM B subtype")
            w = 4 if sub == "f" else _INT_TAGS[sub][1]
            if n - p < cnt * w:
                raise ValueError("truncated BAM tag")
            vals = []
            if sub == "f":
                for _ in range(cnt):
                    (v,) = struct.unpack_from("<f", buf, p)
                    vals.append(f"{v:g}")
                    p += 4
            else:
                fmt, w = _INT_TAGS[sub]
                for _ in range(cnt):
                    (v,) = struct.unpack_from(fmt, buf, p)
                    vals.append(str(v))
                    p += w
            out.append(f"\t{tag}:B:{sub}," + ",".join(vals)
                       if vals else f"\t{tag}:B:{sub}")
        else:
            raise ValueError(f"unsupported BAM tag type '{typ}'")


def bam_to_sam_lines(filename) -> Iterator[str]:
    """Yield SAM text lines (no trailing newline) for a BAM file,
    byte-identical to the native converter's output."""
    data = _inflate_all(filename)
    if data[:4] != b"BAM\x01":
        raise ValueError(f'"{filename}" is not a BAM file')
    mv = memoryview(data)
    if len(data) < 12:
        raise ValueError("truncated BAM header")
    (l_text,) = struct.unpack_from("<I", mv, 4)
    if len(data) < 12 + l_text:
        raise ValueError("truncated BAM header")
    text = bytes(mv[8:8 + l_text]).split(b"\x00", 1)[0].decode("latin-1")
    for ln in text.splitlines():
        yield ln
    p = 8 + l_text
    (n_ref,) = struct.unpack_from("<i", mv, p)
    p += 4
    refs = []
    for _ in range(max(0, n_ref)):
        if len(data) - p < 4:
            raise ValueError("truncated BAM reference entry")
        (l_name,) = struct.unpack_from("<I", mv, p)
        p += 4
        if len(data) - p < l_name + 4:
            raise ValueError("truncated BAM reference entry")
        refs.append(bytes(mv[p:p + l_name - 1]).decode("latin-1")
                    if l_name else "")
        p += l_name + 4
    n = len(data)
    while p < n:
        if n - p < 4:
            raise ValueError("truncated BAM record")
        (block,) = struct.unpack_from("<I", mv, p)
        p += 4
        if block < 32 or n - p < block:
            raise ValueError("truncated BAM record")
        r = mv[p:p + block]
        p += block
        (ref_id, pos, l_read_name, mapq, _bin, n_cigar, flag,
         l_seq, next_ref, next_pos, tlen) = struct.unpack_from(
            "<iiBBHHHIiii", r, 0)
        if 32 + l_read_name + 4 * n_cigar + (l_seq + 1) // 2 + l_seq \
                > block:
            raise ValueError("truncated BAM record body")
        q = 32
        qname = bytes(r[q:q + l_read_name - 1]).decode("latin-1")
        q += l_read_name
        parts = [qname, str(flag),
                 refs[ref_id] if 0 <= ref_id < len(refs) else "*",
                 str(pos + 1), str(mapq)]
        if n_cigar == 0:
            parts.append("*")
        else:
            cig = []
            for i in range(n_cigar):
                (cv,) = struct.unpack_from("<I", r, q + 4 * i)
                op = cv & 0xF
                # reserved op codes 9-15 render as '?' (matching the
                # native converter) and fail cleanly in the SAM parser
                cig.append(f"{cv >> 4}{CIGAR_OPS[op] if op < 9 else '?'}")
            parts.append("".join(cig))
        q += 4 * n_cigar
        if next_ref < 0:
            parts.append("*")
        elif next_ref == ref_id:
            parts.append("=")
        elif next_ref < len(refs):
            parts.append(refs[next_ref])
        else:
            parts.append("*")
        parts.append(str(next_pos + 1))
        parts.append(str(tlen))
        if l_seq == 0:
            parts.append("*")
        else:
            sq = []
            for i in range(l_seq):
                b = r[q + i // 2]
                sq.append(SEQ16[(b >> 4) if i % 2 == 0 else (b & 0xF)])
            parts.append("".join(sq))
        q += (l_seq + 1) // 2
        if l_seq == 0 or r[q] == 0xFF:
            parts.append("*")
        else:
            parts.append("".join(chr(r[q + i] + 33) for i in range(l_seq)))
        q += l_seq
        line = ["\t".join(parts)]
        _render_tags(r[q:], line)
        yield "".join(line)


class _LineStream:
    """Minimal text-file-like wrapper over an iterator of lines (enough
    for the SAM consumers: iteration + context manager + close)."""

    def __init__(self, lines: Iterator[str]):
        self._lines = lines

    def __iter__(self):
        return (ln + "\n" for ln in self._lines)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def close(self) -> None:
        pass


def open_sam_text(filename) -> Union[IO[str], _LineStream]:
    """Open any supported alignment input (.sam / .sam.gz / .bam /
    .bam over BGZF) as a SAM text line stream."""
    from polypolish_tpu_torch.io.fasta import open_text_auto

    if is_bam(filename):
        return _LineStream(bam_to_sam_lines(filename))
    return open_text_auto(filename)
