"""The port's multi-process pod (``polish --distributed``,
pipeline/pod_distributed.py) and ``batch --shard-across-hosts`` with
real ranks over a localhost gloo process group, each rank a
``python -m polypolish_tpu_torch`` process on the CPU.

Rank 0's stdout must be exactly the FASTA of single-process
``polish(backend="host")`` of polypolish_tpu (and of the port) and its
--debug TSV byte-identical; the other ranks' stdout is empty; rank 0's
stderr is that single-process narrative but for the ``Pod mode:`` line
and gloo's own ``[c10d]`` lines.  Every
subprocess is waited for with a timeout and killed on it, so a hung
rendezvous fails one test and stalls nothing."""

import json
import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest

import tests.synth as synth
from polypolish_tpu.pipeline.polish import polish as jax_polish
from polypolish_tpu_torch.pipeline.polish import polish as port_polish
from tests.torch_helpers import (
    REPO,
    cli_env,
    count_polisher_calls,
    mask_clock,
    run_polish,
)

TIMEOUT = 150
_GLOO = re.compile(r"^\[[WIE]\d{4} [^\]]*\] \[c10d\].*$\n?", re.M)
_POD = re.compile(r"^Pod mode: [^\n]*\n\n", re.M)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _launch(argvs, envs):
    """Start one process per argv at once; (exit code, stdout, stderr)
    of each, every one killed when any outlives TIMEOUT."""
    procs = [subprocess.Popen([sys.executable, *argv], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env,
                              cwd=REPO)
             for argv, env in zip(argvs, envs)]
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT)
            results.append((p.returncode, out, err))
    except subprocess.TimeoutExpired:
        for q in procs:
            q.kill()
        for q in procs:
            q.communicate()
        pytest.fail(f"a rank outlived {TIMEOUT} s")
    return results


def _polish_ranks(n_procs, asm, sams, debug, **env):
    port = _free_port()
    argvs = [["-m", "polypolish_tpu_torch", "polish", "--distributed",
              "--coordinator", f"127.0.0.1:{port}", "--num-processes",
              str(n_procs), "--process-id", str(r), "--device", "cpu",
              "--debug", str(debug), str(asm), *map(str, sams)]
             for r in range(n_procs)]
    results = _launch(argvs, [cli_env(**env)] * n_procs)
    for rc, _, err in results:
        assert rc == 0, err[-3000:]
    return results


def _single_host(tmp_path, tag, asm, sams):
    """(FASTA, TSV, masked stderr) of single-process host polish by
    polypolish_tpu, checked equal to the port's own host run."""
    want = run_polish(jax_polish, tmp_path, f"{tag}_jax", asm, sams,
                      backend="host")
    assert run_polish(port_polish, tmp_path, f"{tag}_port", asm, sams,
                      backend="host") == want
    return want


def _check_against_single(tmp_path, asm, sams, n_procs, **env):
    want = _single_host(tmp_path, "single", asm, sams)
    debug = tmp_path / "debug.tsv"  # run_polish's path: same narrative
    results = _polish_ranks(n_procs, asm, sams, debug, **env)
    (_, out0, err0), rest = results[0], results[1:]
    assert out0 == want[0]
    assert debug.read_text() == want[1]
    assert f"Pod mode: SAM ingest sharded over {n_procs} processes " \
           f"({n_procs} devices)\n" in err0
    assert _POD.sub("", mask_clock(_GLOO.sub("", err0))) == want[2]
    for _, out, err in rest:
        assert out == ""
        assert _GLOO.sub("", err) == ""


def _polish_case(tmp_path, seed, **kwargs):
    fasta, sam_text = synth.make_polish_case(seed=seed, **kwargs)
    asm = tmp_path / "asm.fasta"
    asm.write_text(synth.fasta_text(fasta))
    sam = tmp_path / "aln.sam"
    sam.write_text(sam_text)
    return asm, [sam]


@pytest.mark.parametrize("n_procs", [2, 3])
def test_ranks_match_single_process(tmp_path, n_procs):
    asm, sams = _polish_case(tmp_path, 41, genome_len=700, n_reads=500,
                             read_len=45, err=0.06, multi_frac=0.35)
    _check_against_single(tmp_path, asm, sams, n_procs)


def test_two_files_two_contigs(tmp_path):
    fasta, text1 = synth.make_multi_contig_case(
        seed=9, n_contigs=2, genome_len=400, n_reads=300, read_len=40)
    _, text2 = synth.make_multi_contig_case(
        seed=10, n_contigs=2, genome_len=400, n_reads=200, read_len=40,
        n_draft_errors=0)
    asm = tmp_path / "asm.fasta"
    asm.write_text(synth.fasta_text(fasta))
    sams = [tmp_path / "a1.sam", tmp_path / "a2.sam"]
    sams[0].write_text(text1)
    sams[1].write_text(text2)
    _check_against_single(tmp_path, asm, sams, 2)


@pytest.mark.parametrize("ov_mode", [None, "scatter"])
def test_device_votes(tmp_path, monkeypatch, ov_mode):
    """POLYPOLISH_TPU_POD_DEVICE_VOTES=1: each rank counts its shard
    with kernel A and the overflow kernel over its cap overflow (plain
    versions on the CPU) before the sum, whatever POLYPOLISH_TPU_OV_MODE
    says; the output stays byte-identical to the JAX package's
    single-process host run.  Both shards of the case hold
    overflow events, and each shard's device votes (in process, the
    wrapper calls counted) equal its host fold."""
    from polypolish_tpu_torch.io.fasta import load_fasta
    from polypolish_tpu_torch.native import runs
    from polypolish_tpu_torch.pipeline.pod_distributed import _device_counts
    from polypolish_tpu_torch.vocab import Vocab

    asm, sams = _polish_case(tmp_path, 53, genome_len=600, n_reads=1500,
                             read_len=45, err=0.07, multi_frac=0.4)
    monkeypatch.delenv("POLYPOLISH_TPU_OV_MODE", raising=False)
    env = {"POLYPOLISH_TPU_POD_DEVICE_VOTES": "1"}
    if ov_mode is not None:
        monkeypatch.setenv("POLYPOLISH_TPU_OV_MODE", ov_mode)
        env["POLYPOLISH_TPU_OV_MODE"] = ov_mode
    calls = count_polisher_calls(monkeypatch)
    (name, _, seq), = load_fasta(asm)
    for rank in range(2):
        shard = runs.parse_runs([str(s) for s in sams], [name],
                                {name: len(seq)}, Vocab(), 10, False,
                                proc_idx=rank, n_procs=2)
        try:
            pack = shard.lanes(name, 32, 2048, num_positions=4096,
                               packed4=True, cap=True)
            assert pack.n_overflow > 0
            pack.close()
            calls.clear()
            got = _device_counts(shard, name, len(seq), "cpu")
            np.testing.assert_array_equal(got, shard.fold(name)[0])
        finally:
            shard.close()
        assert dict(calls) == {"lanes_counts": 1, "overflow_counts": 1}
    _check_against_single(tmp_path, asm, sams, 2, **env)


def _lopsided_case(tmp_path):
    """Two contigs, the SAM in contig order with ctg_1's few reads at the
    end: rank 0 of two parses none of ctg_1's alignments."""
    texts, fasta = [], []
    for c, n_reads in ((0, 700), (1, 60)):
        f, text = synth.make_polish_case(seed=30 + c, genome_len=800,
                                         n_reads=n_reads, read_len=45,
                                         contig_name=f"ctg_{c}")
        fasta += f
        texts.append([ln if ln.startswith("@") else f"c{c}_{ln}"
                      for ln in text.splitlines()])
    head = [ln for t in texts for ln in t if ln.startswith("@SQ")]
    body = [ln for t in texts for ln in t if not ln.startswith("@")]
    asm = tmp_path / "asm.fasta"
    asm.write_text(synth.fasta_text(fasta))
    sam = tmp_path / "aln.sam"
    sam.write_text("\n".join(["@HD\tVN:1.6", *head, *body]) + "\n")
    return asm, [sam], [n for n, _, _ in fasta], {
        n: len(s) for n, _, s in fasta}


def test_rank_with_no_alignment_on_a_contig(tmp_path):
    """A rank whose byte range holds no alignment of a contig still gets
    a lane pack (all pad, zero events), so it votes zeros through the
    kernels; the pod's output stays byte-identical."""
    from polypolish_tpu_torch.native import runs
    from polypolish_tpu_torch.vocab import Vocab

    asm, sams, names, lens = _lopsided_case(tmp_path)
    shard = runs.parse_runs([str(s) for s in sams], names, lens, Vocab(),
                            10, False, proc_idx=0, n_procs=2)
    try:
        rc = shard.raw()[0]
        assert (rc == 0).any() and not (rc == 1).any()
        pack = shard.lanes("ctg_1", 32, 2048, num_positions=4096,
                           packed4=True, cap=True)
        assert pack is not None and pack.n_events == 0
        assert (pack.vb == -1).all()  # every slot the pad byte
        pack.close()
    finally:
        shard.close()
    _check_against_single(tmp_path, asm, sams, 2,
                          POLYPOLISH_TPU_POD_DEVICE_VOTES="1")


def test_device_votes_without_a_pack_raise(tmp_path, monkeypatch):
    """Where the JAX package falls back to the host fold (no lane pack),
    the port raises (one process, no group)."""
    import io

    from polypolish_tpu_torch.native import runs
    from polypolish_tpu_torch.pipeline.pod_distributed import (
        polish_pod_distributed,
    )

    asm, sams = _polish_case(tmp_path, 41, genome_len=500, n_reads=200)
    monkeypatch.setenv("POLYPOLISH_TPU_POD_DEVICE_VOTES", "1")
    monkeypatch.setattr(runs.ParsedRuns, "lanes", lambda self, *a, **k: None)
    with pytest.raises(RuntimeError, match="returned no pack"):
        polish_pod_distributed(None, 0.2, 0.5, 10, 5, False, str(asm),
                               [str(s) for s in sams], out=io.StringIO(),
                               device="cpu")


def test_no_coordinator_refused_like_jax_cli(tmp_path):
    asm, sams = _polish_case(tmp_path, 41, genome_len=500, n_reads=200)
    env = {k: v for k, v in cli_env().items()
           if not k.startswith("JAX_COORDINATOR")}
    argv = ["polish", "--distributed", str(asm), str(sams[0])]
    got, want = _launch(
        [["-m", "polypolish_tpu_torch", *argv[:2], "--device", "cpu",
          *argv[2:]], ["-m", "polypolish_tpu", *argv]], [env, env])
    assert got[0] == 1 and "--distributed requires a coordinator" in got[2]
    assert got == want


_GATHER = r"""
import json, sys
import numpy as np
from polypolish_tpu_torch.parallel import multihost
from polypolish_tpu_torch.pipeline import pod_distributed as pd
rank, world, port = map(int, sys.argv[1:4])
assert multihost.initialize_distributed(f"127.0.0.1:{port}", world, rank)
arrays = [np.arange(rank + 2, dtype=np.int64) + (1 << 40) - rank,
          np.full(3 * rank, 200 + rank, dtype=np.uint8),
          np.linspace(0, 1, 2 + rank) / 3,
          np.arange(rank, dtype=np.int32) - 7]
out = {"gathered": [[a.dtype.str, a.tolist()] for arr in arrays
                    for a in pd._allgather_var(arr)],
       "psum": pd._psum_i32(np.arange(6, dtype=np.int32).reshape(2, 3)
                            * (rank + 1) - (1 << 30)).tolist()}
multihost.shutdown_distributed()
print(json.dumps(out))
"""


def test_collectives_round_trip_every_dtype():
    """_allgather_var gives every rank the same list, in rank order,
    exact for int64 past 2^32, uint8 (empty on rank 0), f64 and int32;
    _psum_i32 is the exact int32 sum."""
    world, port = 3, _free_port()
    results = _launch([["-c", _GATHER, str(r), str(world), str(port)]
                       for r in range(world)], [cli_env()] * world)
    outs = []
    for rc, out, err in results:
        assert rc == 0, err[-3000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))
    assert all(o == outs[0] for o in outs)
    want = []
    for make in (lambda r: np.arange(r + 2, dtype=np.int64) + (1 << 40) - r,
                 lambda r: np.full(3 * r, 200 + r, dtype=np.uint8),
                 lambda r: np.linspace(0, 1, 2 + r) / 3,
                 lambda r: np.arange(r, dtype=np.int32) - 7):
        want += [[make(r).dtype.str, make(r).tolist()] for r in range(world)]
    assert outs[0]["gathered"] == want
    base = np.arange(6, dtype=np.int64).reshape(2, 3)
    psum = sum(base * (r + 1) - (1 << 30) for r in range(world))
    assert outs[0]["psum"] == psum.astype(np.int32).tolist()


def test_batch_takes_its_slice(monkeypatch):
    """polish_batch(shard_across_hosts=True) polishes jobs[rank::world]
    and says so."""
    import contextlib
    import importlib
    import io

    from polypolish_tpu_torch.parallel import multihost
    from polypolish_tpu_torch.pipeline.batch import polish_batch

    # the pipeline package exports polish(), which hides the module
    pp = importlib.import_module("polypolish_tpu_torch.pipeline.polish")
    done = []

    def fake_polish(debug, fi, fv, me, md, careful, assembly, sams, **kw):
        done.append(assembly)
        return [("c", 1)]

    monkeypatch.setattr(pp, "polish", fake_polish)
    monkeypatch.setattr(multihost, "process_count", lambda: 3)
    jobs = [(f"a{i}", os.devnull, []) for i in range(7)]
    for rank in range(3):
        monkeypatch.setattr(multihost, "process_index", lambda r=rank: r)
        done.clear()
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            polish_batch(jobs, shard_across_hosts=True, workers=1,
                         device="cpu")
        assert done == [j[0] for j in jobs[rank::3]]
        assert f"host {rank}/3: polishing {len(done)} of 7 genomes" in \
            err.getvalue()


def test_batch_shard_across_hosts(tmp_path):
    """Two ranks over a four-job manifest: each polishes two genomes,
    every output equal to its genome's host FASTA (polypolish_tpu's and
    the port's)."""
    jobs, want = [], []
    for i in range(4):
        fasta, text = synth.make_polish_case(seed=80 + i, genome_len=500,
                                             n_reads=250,
                                             contig_name=f"g{i}")
        asm = tmp_path / f"g{i}.fasta"
        asm.write_text(synth.fasta_text(fasta))
        sam = tmp_path / f"g{i}.sam"
        sam.write_text(text)
        out = tmp_path / f"out{i}.fasta"
        jobs.append(f"{asm}\t{out}\t{sam}\n")
        want.append(_single_host(tmp_path, f"h{i}", asm, [sam])[0])
    manifest = tmp_path / "m.tsv"
    manifest.write_text("".join(jobs))
    port = _free_port()
    argv = ["-m", "polypolish_tpu_torch", "batch", "--shard-across-hosts",
            "--backend", "device", "--device", "cpu", str(manifest)]
    envs = [cli_env(JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                    JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(r))
            for r in range(2)]
    results = _launch([argv, argv], envs)
    for rank, (rc, out, err) in enumerate(results):
        assert rc == 0, err[-3000:]
        assert f"host {rank}/2: polishing 2 of 4 genomes" in err
        assert "Genomes polished: 2/2" in err
    for i in range(4):
        assert (tmp_path / f"out{i}.fasta").read_text() == want[i]
