"""The port's ``batch`` (pipeline/batch.py) against polypolish_tpu's
polish_batch on the cases of tests/test_batch.py (backend host, one and
three workers, failures reported, resume, manifest errors); the device
backend on the CPU gives the same outputs; and the kernels' launch
counters stay exact under worker threads."""

import os
import sys
import threading

import pytest

import tests.synth as synth
from polypolish_tpu.errors import PolypolishError as JaxError
from polypolish_tpu.pipeline.batch import parse_manifest as jax_manifest
from polypolish_tpu.pipeline.batch import polish_batch as jax_batch
from polypolish_tpu_torch.errors import PolypolishError
from polypolish_tpu_torch.pipeline.batch import parse_manifest, polish_batch
from tests.torch_helpers import count_polisher_calls, mask_clock, synth_case


def _jobs(tmp_path, n, tag, seed0=100):
    jobs = []
    for i in range(n):
        fasta, sam_text = synth.make_polish_case(
            seed=seed0 + i, genome_len=400, n_reads=200,
            contig_name=f"g{tag}{i}")
        asm = tmp_path / f"asm_{tag}{i}.fasta"
        asm.write_text(synth.fasta_text(fasta))
        sam = tmp_path / f"aln_{tag}{i}.sam"
        sam.write_text(sam_text)
        jobs.append((str(asm), str(tmp_path / f"out_{tag}{i}.fasta"),
                     [str(sam)]))
    return jobs


def _run(fn, jobs, capsys, **kwargs):
    """(results without paths, outputs, masked stderr) of one batch."""
    results = fn(jobs, **kwargs)
    err = mask_clock(capsys.readouterr().err)
    outs = []
    for _, out, _ in jobs:
        outs.append(open(out).read() if os.path.exists(out) else None)
    return results, outs, err


def _retarget(jobs, tag):
    return [(a, o.replace(".fasta", f"_{tag}.fasta"), s) for a, o, s in jobs]


@pytest.mark.parametrize("workers", [1, 3])
def test_batch_matches_jax(tmp_path, capsys, workers):
    jobs = _jobs(tmp_path, 6, "w")
    got = _run(polish_batch, _retarget(jobs, "port"), capsys,
               backend="host", workers=workers)
    want = _run(jax_batch, _retarget(jobs, "jax"), capsys, backend="host",
                workers=workers)
    assert [r["lengths"] for r in got[0]] == [r["lengths"] for r in want[0]]
    assert got[1:] == want[1:]
    dev = _run(polish_batch, _retarget(jobs, "dev"), capsys,
               backend="device", device="cpu", workers=workers)
    assert dev[1] == want[1]


def test_batch_device_folds_overflow_once_per_job(tmp_path, capsys,
                                                   monkeypatch):
    """batch --backend device (on the CPU, one worker) over two jobs
    whose lane packs have cap-overflow events: kernel A and the overflow
    wrapper once per job, the chunk kernel's never; outputs equal the
    host backend's."""
    calls = count_polisher_calls(monkeypatch)
    asm, sams = synth_case(tmp_path, "deep")
    jobs = [(str(asm), str(tmp_path / f"deep_{k}.fasta"),
             [str(s) for s in sams]) for k in range(2)]
    dev = _run(polish_batch, jobs, capsys, backend="device", device="cpu",
               workers=1)
    assert dict(calls) == {"lanes_counts": 2, "overflow_counts": 2}
    host = _run(polish_batch, _retarget(jobs, "host"), capsys,
                backend="host", workers=1)
    assert dev[1] == host[1]


def test_batch_reports_failures_like_jax(tmp_path, capsys):
    job, = _jobs(tmp_path, 1, "ok")
    bad = (str(tmp_path / "missing.fasta"), str(tmp_path / "o.fasta"), job[2])
    got = _run(polish_batch, [job, bad], capsys, backend="host", workers=2)
    want = _run(jax_batch, [job, bad], capsys, backend="host", workers=2)
    assert "error" not in got[0][0] and "error" in got[0][1]
    assert got[0][1] == want[0][1]
    assert got[2] == want[2]


def test_batch_resume_like_jax(tmp_path, capsys):
    job, = _jobs(tmp_path, 1, "r")
    asm_mtime = os.path.getmtime(job[0])
    for fn in (polish_batch, jax_batch):
        if os.path.exists(job[1]):
            os.remove(job[1])
        os.utime(job[0], (asm_mtime, asm_mtime))
        r1 = fn([job], backend="host", workers=1)
        assert "error" not in r1[0] and not r1[0].get("skipped")
        r2 = fn([job], backend="host", workers=1, resume=True)
        assert r2[0].get("skipped") is True
        # the assembly one second newer than the output: a file clock's
        # coarse ticks cannot hide the change
        out_mtime = os.path.getmtime(job[1])
        os.utime(job[0], (out_mtime + 1, out_mtime + 1))
        r3 = fn([job], backend="host", workers=1, resume=True)
        assert not r3[0].get("skipped")
    capsys.readouterr()


@pytest.mark.parametrize("text,match", [
    ("# comment\na.fasta\tout.fasta\tx.sam,y.sam\nb.fasta\tout2.fasta\t"
     "z.sam\n", None),
    ("bad line\n", "3 tab-separated"),
    ("", "no jobs"),
    ("# only a comment\n\n", "no jobs"),
])
def test_parse_manifest_like_jax(tmp_path, text, match):
    m = tmp_path / "manifest.tsv"
    m.write_text(text)
    if match is None:
        assert parse_manifest(str(m)) == jax_manifest(str(m))
        return
    with pytest.raises(PolypolishError, match=match) as got:
        parse_manifest(str(m))
    with pytest.raises(JaxError) as want:
        jax_manifest(str(m))
    assert str(got.value) == str(want.value)


def test_launch_counters_exact_under_threads(monkeypatch):
    """ops/launch_count.bump, the one place the wrappers count a launch,
    loses nothing when 8 threads count at once (a switch interval of
    1 us makes the threads interleave inside the read-modify-write)."""
    from polypolish_tpu_torch.ops import launch_count, vote_chunks, vote_lanes

    monkeypatch.setattr(vote_chunks.chunk_counts, "launches", 0)
    monkeypatch.setattr(vote_lanes.lanes_counts, "launches",
                        type(vote_lanes.lanes_counts.launches)())
    n_threads, per_thread = 8, 20_000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for _ in range(per_thread):
                launch_count.bump(vote_chunks.chunk_counts)
                launch_count.bump(vote_lanes.lanes_counts,
                                  f"entry{k % 3}")

        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        sys.setswitchinterval(old)
    assert vote_chunks.chunk_counts.launches == n_threads * per_thread
    assert sum(vote_lanes.lanes_counts.launches.values()) == \
        n_threads * per_thread
    assert vote_lanes.lanes_counts.launches["entry0"] == 3 * per_thread


def test_launch_count_waits_for_the_lock(monkeypatch):
    """A launch counted while another thread holds the lock lands only
    after that thread lets go: every count goes through the lock."""
    from polypolish_tpu_torch.ops import launch_count, vote_chunks

    monkeypatch.setattr(vote_chunks.chunk_counts, "launches", 0)
    with launch_count.LOCK:
        t = threading.Thread(
            target=launch_count.bump, args=(vote_chunks.chunk_counts,))
        t.start()
        t.join(0.2)
        assert t.is_alive() and vote_chunks.chunk_counts.launches == 0
    t.join()
    assert vote_chunks.chunk_counts.launches == 1
