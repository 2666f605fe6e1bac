"""The port's ``--pod-shards`` (pipeline/pod.py polish_pod) against
polypolish_tpu's polish_pod on the cases of tests/test_pod.py, byte for
byte (FASTA, --debug TSV, stderr with the clock masked): one to four
shards, two files, several contigs, more shards than read groups, and
BAM input.  Also the pieces: the shards' parse (parse_runs with
proc_idx/n_procs), the merged vocab and the gathered run headers."""

import numpy as np
import pytest

import tests.bam_util as bam_util
import tests.synth as synth
from polypolish_tpu.pipeline import pod as jax_pod
from polypolish_tpu.pipeline.pod import polish_pod as jax_polish_pod
from polypolish_tpu_torch.pipeline import pod as port_pod
from polypolish_tpu_torch.pipeline.polish import polish as port_polish
from tests.torch_helpers import run_polish


def _write(tmp_path, fasta, texts):
    asm = tmp_path / "asm.fasta"
    asm.write_text(synth.fasta_text(fasta))
    sams = []
    for i, text in enumerate(texts):
        sams.append(tmp_path / f"aln{i}.sam")
        sams[-1].write_text(text)
    return asm, sams


def _case(tmp_path, kind):
    if kind == "single":
        fasta, text = synth.make_polish_case(
            seed=31, genome_len=900, n_reads=700, read_len=45, err=0.06,
            multi_frac=0.35)
        return _write(tmp_path, fasta, [text])
    if kind == "two_files_multi_contig":
        fasta, t1 = synth.make_multi_contig_case(
            seed=7, n_contigs=3, genome_len=400, n_reads=400, read_len=40)
        _, t2 = synth.make_multi_contig_case(
            seed=8, n_contigs=3, genome_len=400, n_reads=300, read_len=40,
            n_draft_errors=0)
        return _write(tmp_path, fasta, [t1, t2])
    fasta, text = synth.make_polish_case(seed=3, genome_len=200, n_reads=12,
                                         read_len=30)
    return _write(tmp_path, fasta, [text])


def _pod(fn, n_procs):
    def run(debug, fi, fv, me, md, careful, asm, sams, out):
        return fn(debug, fi, fv, me, md, careful, asm, sams, n_procs, out=out)
    return run


@pytest.mark.parametrize("kind,n_procs", [
    ("single", 1), ("single", 2), ("single", 3), ("single", 4),
    ("two_files_multi_contig", 3), ("tiny", 8),
])
def test_pod_matches_jax(tmp_path, kind, n_procs):
    asm, sams = _case(tmp_path, kind)
    got = run_polish(_pod(port_pod.polish_pod, n_procs), tmp_path, "port",
                     asm, sams)
    want = run_polish(_pod(jax_polish_pod, n_procs), tmp_path, "jax", asm,
                      sams)
    assert got == want
    # and the unsharded host backend gives the same FASTA and TSV
    host = run_polish(port_polish, tmp_path, "host", asm, sams,
                      backend="host")
    assert got[:2] == host[:2]


def test_pod_shards_bam_matches_jax(tmp_path):
    fasta, text = synth.make_polish_case(
        seed=17, genome_len=2500, n_reads=1500, read_len=60, err=0.08,
        multi_frac=0.4)
    asm = tmp_path / "asm.fasta"
    asm.write_text(synth.fasta_text(fasta))
    bam = tmp_path / "a.bam"
    bam_util.write_bam(bam, text)
    got = run_polish(_pod(port_pod.polish_pod, 2), tmp_path, "port", asm,
                     [bam])
    want = run_polish(_pod(jax_polish_pod, 2), tmp_path, "jax", asm, [bam])
    assert got == want


def test_pod_pieces_match_jax(tmp_path):
    """Per shard: the same file stats, run headers and vocab; then the
    same merged vocab remaps and gathered headers."""
    from polypolish_tpu.io.fasta import load_fasta
    from polypolish_tpu_torch.native import binding

    fasta, text = synth.make_polish_case(
        seed=12, genome_len=1500, n_reads=2000, read_len=60, err=0.15,
        multi_frac=0.5, n_draft_errors=15)
    asm, sams = _write(tmp_path, fasta, [text, text])
    fa = load_fasta(asm)
    names = [n for n, _, _ in fa]
    lens = {n: len(s) for n, _, s in fa}
    files = [str(s) for s in sams]
    got = port_pod.parse_pod_shards(files, names, lens, 10, False, 3)
    want = jax_pod.parse_pod_shards(files, names, lens, 10, False, 3)
    try:
        for g, w in zip(got[0], want[0]):
            assert g.file_stats == w.file_stats
            assert g.file_runs == w.file_runs
            for a, b in zip(g.raw()[:4], w.raw()[:4]):
                np.testing.assert_array_equal(a, b)
        assert [v.strings for v in got[1]] == [v.strings for v in want[1]]
        vg, rg = port_pod.merge_vocabs(got[1])
        vw, rw = jax_pod.merge_vocabs(want[1])
        assert vg.strings == vw.strings
        for a, b in zip(rg, rw):
            np.testing.assert_array_equal(a, b)
        headers = port_pod.gather_headers([g.raw()[:4] for g in got[0]],
                                          [g.file_runs for g in got[0]], 2)
        jax_headers = jax_pod.gather_headers(want[0], 2)
        for a, b in zip(headers, jax_headers):
            np.testing.assert_array_equal(a, b)
        # the merge the multi-process pod shares: per contig, the summed
        # counts and the sparse tier from per-shard arrays, and the depth
        for name in names:
            counts = np.zeros((8, lens[name]), dtype=np.int32)
            keys, cnts = [], []
            for g, remap in zip(got[0], rg):
                c, _d, sparse = g.fold(name)
                counts += c
                k, n = port_pod.sparse_keys(sparse, g.base_vocab_len, remap)
                keys.append(k)
                cnts.append(n)
            sparse = port_pod.merge_sparse(keys, cnts)
            w_counts, w_depth, w_sparse = jax_pod.merge_contig(
                want[0], rw, jax_headers, name, names, lens[name])
            np.testing.assert_array_equal(counts, w_counts)
            assert sparse[0].size > 0
            for a, b in zip(sparse, w_sparse):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
            depth = binding.depth_fold(*headers, names.index(name),
                                       lens[name])
            np.testing.assert_array_equal(depth, w_depth)
    finally:
        for sh in got[0] + want[0]:
            sh.close()
