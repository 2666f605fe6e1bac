"""The port's pure-Python reader against polypolish_tpu's, exactly: the
CIGAR engine (ops/cigar.py) on generated and malformed CIGARs, SAM line
parsing (io/sam.py) on the fatal lines of tests/test_fatal_parity.py,
reverse complement on IUPAC, the event packer (ops/pack.py process_sam)
down to the (pos, vid, weight) arrays, and consensus_one_position."""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import polypolish_tpu.io.sam as jsam
import polypolish_tpu.ops.cigar as jcigar
import polypolish_tpu.ops.consensus as jcons
import polypolish_tpu.ops.pack as jpack
import polypolish_tpu.utils.revcomp as jrev
import polypolish_tpu_torch.io.sam as tsam
import polypolish_tpu_torch.ops.cigar as tcigar
import polypolish_tpu_torch.ops.consensus as tcons
import polypolish_tpu_torch.ops.pack as tpack
import polypolish_tpu_torch.utils.revcomp as trev
import tests.synth as synth
from polypolish_tpu.errors import PolypolishError as JaxError
from polypolish_tpu.vocab import Vocab as JaxVocab
from polypolish_tpu_torch.errors import PolypolishError
from polypolish_tpu_torch.vocab import Vocab
from tests.test_fatal_parity import POLISH_FATALS, SURVIVORS

MALFORMED = ["10Q", "10MM1I10M", "100M5", "M3M", "3M3", "", "*", "4?",
             "2M2S2M", "2M2N2M", "2M1H2M", "2M1P2M", "1I3M", "0M", "3M-1D",
             "12", "MIDNSHP=X"]


def _outcome(fn, *args):
    """('ok', result) or (exception class name, message) of a call."""
    try:
        return "ok", fn(*args)
    except (JaxError, PolypolishError) as e:
        return "fatal", str(e)
    except (ValueError, IndexError) as e:
        # e.g. InvalidCigar, or an I with no range before it
        return type(e).__name__, str(e)


def _both(name, *args):
    return (_outcome(getattr(jcigar, name), *args),
            _outcome(getattr(tcigar, name), *args))


_cigars = st.lists(
    st.tuples(st.integers(0, 30), st.sampled_from("MIDNSHP=XQ?")),
    min_size=0, max_size=8,
).map(lambda ops: "".join(f"{n}{o}" for n, o in ops))


@settings(max_examples=300, deadline=None)
@given(_cigars, st.integers(0, 1000), st.integers(0, 60))
def test_cigar_engine_matches_jax_on_generated(cigar, ref_start, read_len):
    want, got = _both("expand_cigar", cigar)
    assert got == want
    want_e, got_e = _both("ref_end_from_cigar", cigar, ref_start)
    assert got_e == want_e
    if want[0] != "ok":
        return
    expanded = want[1]
    want_r, got_r = _both("read_ranges_for_target_bases", expanded,
                          read_len, "r1", cigar)
    assert got_r == want_r
    if want_r[0] == "ok" and want_r[1]:
        seq = "".join("ACGT"[i % 4 // 2] for i in range(read_len))
        assert (tcigar.trim_for_homopolymers(list(want_r[1]), seq)
                == jcigar.trim_for_homopolymers(list(want_r[1]), seq))


@pytest.mark.parametrize("cigar", MALFORMED)
def test_cigar_engine_matches_jax_on_malformed(cigar):
    want, got = _both("expand_cigar", cigar)
    assert got == want
    want_e, got_e = _both("ref_end_from_cigar", cigar, 7)
    assert got_e == want_e
    if want[0] == "ok":
        for n in (0, 4, 6):
            a, b = _both("read_ranges_for_target_bases", want[1], n, "r9",
                         cigar)
            assert b == a


def _fields(a):
    return tuple(getattr(a, k) for k in jsam.Alignment.__slots__)


def _parse(mod, fn, line):
    try:
        a = getattr(mod, fn)(line)
        return "ok", _fields(a), repr(a), a.starts_and_ends_with_match()
    except (JaxError, PolypolishError) as e:
        return "fatal", str(e)
    except ValueError as e:
        label = mod.error_label(e)
        return type(e).__name__, label


_LINES = sorted({line for _, text, *_ in POLISH_FATALS + SURVIVORS
                 for line in text.splitlines() if line
                 and not line.startswith("@")})


@pytest.mark.parametrize("fn", ["parse_alignment_full",
                                "parse_alignment_quick"])
def test_sam_line_parse_matches_jax(fn):
    for line in _LINES:
        assert _parse(tsam, fn, line) == _parse(jsam, fn, line), line


def test_reverse_complement_matches_jax_on_iupac():
    every = "".join(chr(i) for i in range(256))
    rng = np.random.default_rng(0)
    iupac = "ACGTNRYSWKMBDHVacgtnryswkmbdhv.-?"
    rand = "".join(rng.choice(list(iupac), 500))
    for seq in (every, rand, "", "ACGT"):
        assert trev.reverse_complement(seq) == jrev.reverse_complement(seq)
        b = seq.encode("latin-1")
        assert (trev.reverse_complement_bytes(b)
                == jrev.reverse_complement_bytes(b))


def _process(pack_mod, vocab_cls, fasta, sam_path, careful, max_errors):
    votes = pack_mod.new_votes_from_fasta(fasta)
    vocab = vocab_cls()
    stats = pack_mod.process_sam(str(sam_path), votes, vocab, max_errors,
                                 careful)
    events = {n: v.finalize() for n, v in votes.items()}
    return stats, events, list(vocab.strings)


@pytest.mark.parametrize("careful", [False, True])
@pytest.mark.parametrize("kind", ["single", "multi_contig", "deep"])
def test_process_sam_events_bitwise_equal(tmp_path, kind, careful):
    """'*' secondaries on both strands, shuffled groups, ZP:Z:fail,
    unaligned records, sparse-tier insertions."""
    if kind == "multi_contig":
        fasta, text = synth.make_multi_contig_case(
            seed=3, n_contigs=3, genome_len=700, n_reads=300, read_len=40,
            multi_frac=0.5)
    elif kind == "deep":
        fasta, text = synth.make_polish_case(
            seed=12, genome_len=1500, n_reads=2000, read_len=60, err=0.15,
            multi_frac=0.5, n_draft_errors=15, shuffle_groups=True)
    else:
        fasta, text = synth.make_polish_case(seed=5, genome_len=900,
                                             n_reads=500, multi_frac=0.6,
                                             shuffle_groups=True)
    sam = tmp_path / "a.sam"
    sam.write_text(text)
    got = _process(tpack, Vocab, fasta, sam, careful, 10)
    want = _process(jpack, JaxVocab, fasta, sam, careful, 10)
    assert got[0] == want[0] and got[2] == want[2]
    assert got[1].keys() == want[1].keys()
    for name in want[1]:
        for g, w in zip(got[1][name], want[1][name]):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    if kind == "deep" and not careful:
        assert len(got[2]) > 8  # sparse-tier strings were interned


def test_contig_votes_extend_and_scalars_match_jax():
    t = tpack.ContigVotes("c", "", "ACGT" * 10)
    j = jpack.ContigVotes("c", "", "ACGT" * 10)
    for cv in (t, j):
        cv.add_event(1, 2, 0.5)
        cv.extend_events(np.arange(5, dtype=np.int64),
                         np.full(5, 3, np.int32), np.full(5, 0.25))
        cv.add_event(7, 9, 1.0)
    assert t.num_events == j.num_events == 7
    for g, w in zip(t.finalize(), j.finalize()):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_consensus_one_position_matches_jax():
    rng = np.random.default_rng(7)
    for _ in range(2000):
        depth = float(rng.integers(0, 60)) + rng.choice([0.0, 0.5, 1 / 3])
        cands = [(v, int(rng.integers(0, 40))) for v in (1, 2, 3, 4)]
        cands += [(int(v), int(rng.integers(1, 40)))
                  for v in rng.choice([0, 5, 9, 12], rng.integers(0, 3),
                                      replace=False)]
        args = (cands, int(rng.integers(0, 13)), depth,
                int(rng.integers(0, 8)), 0.5, float(rng.choice([0.2, 0.0])))
        assert (tcons.consensus_one_position(*args)
                == jcons.consensus_one_position(*args))
