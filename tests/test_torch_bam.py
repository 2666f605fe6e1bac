"""The port's BAM reader (io/bam.py) against polypolish_tpu's: the same
SAM lines from BGZF and raw BAM (unaligned records, '*' fields, integer,
float, string and B-array tags, the reserved CIGAR op '?'), the same
errors on truncated gzip and malformed tags (cases of tests/test_bam.py),
and open_sam_text / open_text_auto on plain, gzipped and BAM input."""

import gzip

import pytest

import polypolish_tpu.io.bam as jbam
import polypolish_tpu.io.fasta as jfasta
import polypolish_tpu_torch.io.bam as tbam
import polypolish_tpu_torch.io.fasta as tfasta
import tests.bam_util as bam_util
import tests.synth as synth
from tests.test_bam import _manual_bam

CORNERS = "\n".join([
    "@HD\tVN:1.6",
    "@SQ\tSN:c\tLN:40",
    "@SQ\tSN:d\tLN:30",
    "r1\t0\tc\t1\t60\t20M\t*\t0\t0\tACGTACGTACGTACGTACGT\t*\tNM:i:0",
    "r1\t256\tc\t21\t0\t20M\t*\t0\t0\t*\t*\tNM:i:1",
    "r2\t4\t*\t0\t0\t*\t*\t0\t0\tACGT\tIIII",
    "r3\t16\tc\t11\t60\t5M1I4M2D10M\td\t7\t-30\tACGTRYACGTNACGTACGTA\t"
    "IIIIIIIIIIIIIIIIIIII\tNM:i:2\tAS:i:37\tXX:Z:note\tXF:f:1.5\t"
    "XB:B:c,-1,2,3\tXS:B:S,1,65535\tXI:B:i,-7\tXG:B:f,0.25,2\tXA:A:q\t"
    "XH:H:1AE3\tXc:i:-100\tXC:i:200\tXs:i:-30000",
    "r4\t0\tc\t3\t60\t4=1X3=\t=\t9\t10\tACGTACGT\tKKKKKKKK\tNM:i:1",
]) + "\n"


def _lines(mod, path):
    return list(mod.bam_to_sam_lines(path))


@pytest.mark.parametrize("compress", [True, False])
@pytest.mark.parametrize("kind", ["corners", "synth"])
def test_bam_to_sam_lines_matches_jax(tmp_path, kind, compress):
    if kind == "synth":
        _, text = synth.make_polish_case(seed=21, genome_len=2500,
                                         n_reads=800, read_len=60,
                                         multi_frac=0.4)
    else:
        text = CORNERS
    bam = tmp_path / "a.bam"
    bam_util.write_bam(bam, text, compress=compress)
    got = _lines(tbam, bam)
    assert got == _lines(jbam, bam)
    assert tbam.is_bam(bam) and jbam.is_bam(bam)
    if kind == "synth":
        assert "\n".join(got) + "\n" == text


def test_reserved_cigar_op_renders_question_mark(tmp_path):
    bad = _manual_bam(tmp_path, tag_bytes=b"NMi\x00\x00\x00\x00",
                      cigar_ops=((4, 11), (3, 0)))
    got = _lines(tbam, bad)
    assert got == _lines(jbam, bad)
    assert [ln for ln in got if not ln.startswith("@")][0].split("\t")[5] \
        == "4?3M"


def test_integer_tag_widths_match_jax(tmp_path):
    """Tags of every integer width (c, C, s, S, i, I) and a char."""
    tags = (b"Xcc\xff" + b"XCC\xff" + b"Xss\x00\x80" + b"XSS\xff\xff"
            + b"Xii\x00\x00\x00\x80" + b"XII\xff\xff\xff\xff"
            + b"XAA!" + b"XFf\x00\x00\xc0\x7f")
    path = _manual_bam(tmp_path, tag_bytes=tags)
    got = _lines(tbam, path)
    assert got == _lines(jbam, path)
    assert "XI:i:4294967295" in got[-1] and "XC:i:255" in got[-1]


def _error(mod, fn, *args):
    try:
        fn(mod)(*args)
    except ValueError as e:
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("tag_bytes", [
    b"XXZabc", b"XXi\x01", b"XXf\x00\x00", b"XXA",
    b"XXBc\x10\x00\x00\x00\x01", b"XXBq\x01\x00\x00\x00\x00", b"XX",
    b"XXq\x00",
])
def test_malformed_tags_fail_like_jax(tmp_path, tag_bytes):
    bad = _manual_bam(tmp_path, tag_bytes=tag_bytes)
    got = _error(tbam, lambda m: lambda p: list(m.bam_to_sam_lines(p)), bad)
    want = _error(jbam, lambda m: lambda p: list(m.bam_to_sam_lines(p)), bad)
    assert got is not None and got == want


def test_truncated_inputs_fail_like_jax(tmp_path):
    _, text = synth.make_polish_case(seed=31, genome_len=900, n_reads=300)
    bam = tmp_path / "t.bam"
    bam_util.write_bam(bam, text, compress=True)
    raw = bam.read_bytes()
    cut = tmp_path / "cut.bam"
    cut.write_bytes(raw[: len(raw) - 40])  # mid-member: no EOF block
    gz = tmp_path / "t.sam.gz"
    body = gzip.compress(text.encode())
    gz.write_bytes(body[: int(len(body) * 0.6)])
    plain = tmp_path / "p.bam"
    bam_util.write_bam(plain, text, compress=False)
    plain_raw = plain.read_bytes()
    short = tmp_path / "short.bam"
    short.write_bytes(plain_raw[: len(plain_raw) // 2 + 7])
    header_only = tmp_path / "hdr.bam"
    header_only.write_bytes(plain_raw[:10])
    for path in (cut, gz, short, header_only):
        got = _error(tbam, lambda m: lambda p: list(m.bam_to_sam_lines(p)),
                     path)
        want = _error(jbam, lambda m: lambda p: list(m.bam_to_sam_lines(p)),
                      path)
        assert got is not None and got == want, path
    assert _error(tbam, lambda m: m._inflate_all, cut) == \
        ("ValueError", "truncated gzip stream")


@pytest.mark.parametrize("form", ["sam", "gz", "bam", "raw_bam", "tiny"])
def test_open_sam_text_matches_jax(tmp_path, form):
    _, text = synth.make_polish_case(seed=8, genome_len=700, n_reads=200)
    path = tmp_path / f"x.{form}"
    if form == "sam":
        path.write_text(text)
    elif form == "gz":
        path.write_bytes(gzip.compress(text.encode()))
    elif form == "tiny":
        path.write_text("@")  # shorter than the gzip magic
    else:
        bam_util.write_bam(path, text, compress=form == "bam")
    with tbam.open_sam_text(path) as f:
        got = list(f)
    with jbam.open_sam_text(path) as f:
        want = list(f)
    assert got == want
    with tfasta.open_text_auto(path) as f, jfasta.open_text_auto(path) as g:
        assert f.read() == g.read()
