"""``polish(backend="sharded")`` of the port end to end against
polypolish_tpu's ``backend="sharded"`` and against the port's host
backend: FASTA, --debug TSV and stderr (clock masked) byte-identical,
on grids of "cpu" cells (kernel A's plain version per cell; JAX on the
8 virtual devices of tests/conftest.py).  Native SAM, .sam.gz and
--pure-python input, two contigs, a contig with no alignment, both
kernel variants (POLYPOLISH_TPU_KERNEL), the number of kernel A calls,
the raise where the JAX package falls back, and the CLI's
``--backend sharded`` on polish, full and batch."""

import gzip
import os
import subprocess
import sys

import pytest

import tests.synth as synth
from polypolish_tpu.pipeline.polish import polish as jax_polish
from polypolish_tpu_torch.models import polisher
from polypolish_tpu_torch.native import runs as port_runs
from polypolish_tpu_torch.parallel import make_mesh
from polypolish_tpu_torch.parallel import shard as port_shard
from polypolish_tpu_torch.pipeline.polish import polish as port_polish
from tests.torch_helpers import REPO, cli_env, mask_clock, run_polish


def _grid(n_data, n_pos):
    return make_mesh(n_data, n_pos, devices=["cpu"] * (n_data * n_pos))


def _write_case(tmp_path, gz=False, empty_contig=False):
    """Two contigs (the JAX package's tests/test_sharded_backend.py
    case); with empty_contig a third contig that no read aligns to."""
    fasta, sam_text = synth.make_multi_contig_case(
        seed=11, n_contigs=2, genome_len=800, n_reads=900, read_len=40,
    )
    if empty_contig:
        import numpy as np

        fasta = fasta + [("ctg_empty", "", synth.rand_seq(
            np.random.default_rng(7), 900))]
        head, body = sam_text.split("\n", 1)
        sam_text = f"{head}\n@SQ\tSN:ctg_empty\tLN:900\n{body}"
    asm = tmp_path / "asm.fasta"
    asm.write_text(synth.fasta_text(fasta))
    if gz:
        sam = tmp_path / "aln.sam.gz"
        sam.write_bytes(gzip.compress(sam_text.encode()))
    else:
        sam = tmp_path / "aln.sam"
        sam.write_text(sam_text)
    return str(asm), [str(sam)]


@pytest.fixture
def kernel_a_calls(monkeypatch):
    """Calls of kernel A's wrapper by the grid step, and of the kernel
    wrappers of the one-device polishers (which sharded must not use)."""
    calls = {"grid": 0, "polisher": 0}

    def counting(fn, key):
        def call(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return call

    monkeypatch.setattr(port_shard, "lanes_counts",
                        counting(port_shard.lanes_counts, "grid"))
    for name in ("lanes_counts", "overflow_counts", "chunk_counts"):
        monkeypatch.setattr(polisher, name,
                            counting(getattr(polisher, name), "polisher"))
    return calls


@pytest.mark.parametrize("variant", ["lanes", "mxu"])
@pytest.mark.parametrize("form", ["native", "gzip", "pure_python"])
def test_sharded_matches_jax_sharded_and_host(tmp_path, monkeypatch,
                                              kernel_a_calls, form, variant):
    asm, sams = _write_case(tmp_path, gz=form == "gzip")
    use_native = form != "pure_python"
    monkeypatch.setenv("POLYPOLISH_TPU_KERNEL", variant)
    got = run_polish(port_polish, tmp_path, "port", asm, sams,
                     backend="sharded", device="cpu", mesh=_grid(2, 4),
                     use_native=use_native)
    # the JAX package reads POLYPOLISH_TPU_KERNEL for its sharded step
    want = run_polish(jax_polish, tmp_path, "jax", asm, sams,
                      backend="sharded", use_native=use_native)
    host = run_polish(port_polish, tmp_path, "host", asm, sams,
                      backend="host", use_native=use_native)
    assert got == want
    assert got == host
    # kernel A once per grid cell and contig on lanes, never on mxu
    assert kernel_a_calls == {"grid": 8 * 2 if variant == "lanes" else 0,
                              "polisher": 0}


@pytest.mark.parametrize("grid", [(1, 1), (2, 1), (1, 2), (2, 2), (8, 1),
                                  (1, 8)])
def test_sharded_grids_match_host(tmp_path, kernel_a_calls, grid):
    asm, sams = _write_case(tmp_path)
    got = run_polish(port_polish, tmp_path, "port", asm, sams,
                     backend="sharded", device="cpu", mesh=_grid(*grid),
                     kernel_variant="lanes")
    host = run_polish(port_polish, tmp_path, "host", asm, sams,
                      backend="host")
    assert got == host
    assert kernel_a_calls["grid"] == 2 * grid[0] * grid[1]


@pytest.mark.parametrize("variant", ["lanes", "mxu"])
def test_contig_with_no_alignment(tmp_path, variant):
    asm, sams = _write_case(tmp_path, empty_contig=True)
    got = run_polish(port_polish, tmp_path, "port", asm, sams,
                     backend="sharded", device="cpu", mesh=_grid(2, 2),
                     kernel_variant=variant)
    host = run_polish(port_polish, tmp_path, "host", asm, sams,
                      backend="host")
    assert got == host
    assert "ctg_empty_polypolish (900 bp)" in got[2]


def test_default_grid_is_one_cpu_cell(tmp_path, kernel_a_calls):
    asm, sams = _write_case(tmp_path)
    got = run_polish(port_polish, tmp_path, "port", asm, sams,
                     backend="sharded", device="cpu", kernel_variant="lanes")
    assert got == run_polish(port_polish, tmp_path, "host", asm, sams,
                             backend="host")
    assert kernel_a_calls["grid"] == 2  # one cell, two contigs


def test_no_mesh_pack_raises(tmp_path, monkeypatch):
    """Where the JAX package falls back from the native mesh pack to the
    scatter step (no pack), the port raises."""
    asm, sams = _write_case(tmp_path)
    monkeypatch.setattr(port_runs.ParsedRuns, "lanes_mesh",
                        lambda self, *a, **k: None)
    with pytest.raises(RuntimeError, match="mesh packer returned no pack"):
        run_polish(port_polish, tmp_path, "port", asm, sams,
                   backend="sharded", device="cpu", mesh=_grid(2, 2),
                   kernel_variant="lanes")


def _cli(pkg, args):
    proc = subprocess.run([sys.executable, "-m", pkg, *args],
                          capture_output=True, text=True, env=cli_env(),
                          cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr
    # full's temporary directory has a random name
    err = [ln for ln in proc.stderr.splitlines()
           if "polypolish_tpu_" not in ln]
    return proc.stdout, mask_clock("\n".join(err))


@pytest.mark.parametrize("command", ["polish", "full", "batch"])
def test_cli_backend_sharded_matches_jax_cli(tmp_path, command):
    """--backend sharded at the CLI (the port's grid: one "cpu" cell)
    against the JAX CLI's --backend sharded: stdout, --debug TSV,
    output files and stderr."""
    if command == "polish":
        asm, sams = _write_case(tmp_path)
        dbg = str(tmp_path / "d.tsv")
        args = ["polish", "--backend", "sharded", "--debug", dbg, asm, *sams]
        outs = [dbg]
    elif command == "full":
        import numpy as np

        paired = []
        for i, text in enumerate(synth.make_filter_case(seed=3), 1):
            paired.append(str(tmp_path / f"p{i}.sam"))
            with open(paired[-1], "w") as f:
                f.write(text)
        rng = np.random.default_rng(3)  # the filter case's genomes
        asm = str(tmp_path / "paired.fasta")
        with open(asm, "w") as f:
            f.write(synth.fasta_text(
                [(c, "", synth.rand_seq(rng, 5000)) for c in ("c1", "c2")]))
        args = ["full", "--in1", paired[0], "--in2", paired[1], "--backend",
                "sharded", asm]
        outs = []
    else:
        manifest = tmp_path / "m.tsv"
        outs = [str(tmp_path / f"o{i}.fasta") for i in range(2)]
        lines = []
        for i, o in enumerate(outs):
            fasta, text = synth.make_polish_case(seed=70 + i, genome_len=600,
                                                 n_reads=300)
            a = tmp_path / f"b{i}.fasta"
            a.write_text(synth.fasta_text(fasta))
            s = tmp_path / f"b{i}.sam"
            s.write_text(text)
            lines.append(f"{a}\t{o}\t{s}\n")
        manifest.write_text("".join(lines))
        args = ["batch", "--backend", "sharded", "--workers", "2",
                str(manifest)]

    def run(pkg, extra):
        result = _cli(pkg, [args[0], *extra, *args[1:]])
        texts = []
        for o in outs:
            with open(o) as f:
                texts.append(f.read())
            os.remove(o)
        return result, texts

    got = run("polypolish_tpu_torch", ["--device", "cpu"])
    assert got == run("polypolish_tpu", [])
    assert got[0][0].startswith(">") or command == "batch"
