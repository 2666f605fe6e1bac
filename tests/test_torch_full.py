"""The port's ``full`` (filter, then polish) and its ``filter`` and
``full`` CLI against polypolish_tpu's.

On the CPU, ``polypolish_tpu_torch.pipeline.full.polish_paired`` with
backends "host" and "device" (device="cpu") must give the FASTA and the
stderr narrative (clock masked) of ``polypolish_tpu``'s polish_paired,
keep the filtered SAMs on request, and ``python -m
polypolish_tpu_torch filter|full --device cpu`` must print, write and
exit as ``python -m polypolish_tpu filter|full`` does.
"""

import contextlib
import io
import os
import re
import subprocess
import sys

import numpy as np
import pytest

import tests.synth as synth
from polypolish_tpu.pipeline.full import polish_paired as jax_full
from polypolish_tpu_torch.pipeline.full import polish_paired as port_full
from tests.torch_helpers import cli_env, mask_clock

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the temporary directory of the filtered SAMs (tempfile.mkdtemp)
_TMPDIR = re.compile(r"polypolish_tpu_\w{8}")


def _mask(stderr: str) -> str:
    return _TMPDIR.sub("<tmpdir>", mask_clock(stderr))


def _case(tmp_path, seed):
    """A paired case whose draft differs from the reads' genomes at a
    few sites: (assembly, sam1, sam2) paths."""
    genome_len, contigs = 3000, ("cA", "cB")
    sam1, sam2 = synth.make_filter_case(
        seed=seed, genome_len=genome_len, n_pairs=400, contig_names=contigs,
        multi_frac=0.4)
    # the generator's genomes: the same rng stream
    rng = np.random.default_rng(seed)
    genomes = {c: synth.rand_seq(rng, genome_len) for c in contigs}
    fasta = []
    for c in contigs:
        draft = list(genomes[c])
        for site in rng.choice(genome_len, size=8, replace=False):
            draft[site] = "ACGT"[("ACGT".index(draft[site]) + 1) % 4]
        fasta.append((c, "", "".join(draft)))
    asm = tmp_path / "asm.fasta"
    asm.write_text(synth.fasta_text(fasta))
    p1, p2 = tmp_path / "r1.sam", tmp_path / "r2.sam"
    p1.write_text(sam1)
    p2.write_text(sam2)
    return str(asm), str(p1), str(p2)


def _full(fn, asm, in1, in2, **kwargs):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stderr(err):
        lengths = fn(asm, in1, in2, out=out, **kwargs)
    return lengths, out.getvalue(), _mask(err.getvalue())


@pytest.mark.parametrize("port_kwargs", [
    dict(backend="host", device="cpu"),
    dict(backend="device", device="cpu"),
    dict(backend="device", device="cpu", kernel_variant="mxu"),
    dict(backend="xla", device="cpu"),
], ids=["host", "device", "device-mxu", "xla"])
@pytest.mark.parametrize("seed", [60, 61])
def test_polish_paired_matches_jax(tmp_path, seed, port_kwargs):
    asm, in1, in2 = _case(tmp_path, seed)
    got = _full(port_full, asm, in1, in2, **port_kwargs)
    want = _full(jax_full, asm, in1, in2, backend="host")
    assert got == want
    assert "changed" in got[2] and "ZP:Z:fail" not in got[1]


def test_polish_paired_options_match_jax(tmp_path):
    """Filter options and polish options pass through (explicit
    orientation, percentiles, --careful and the polish thresholds)."""
    asm, in1, in2 = _case(tmp_path, 62)
    opts = dict(orientation="fr", low=1.0, high=99.0, careful=True,
                min_depth=3, fraction_valid=0.6, fraction_invalid=0.25)
    got = _full(port_full, asm, in1, in2, device="cpu", **opts)
    want = _full(jax_full, asm, in1, in2, backend="pallas", **opts)
    assert got == want


def test_keep_filtered(tmp_path):
    asm, in1, in2 = _case(tmp_path, 63)
    keep_port = tmp_path / "kept_port"
    keep_jax = tmp_path / "kept_jax"
    got = _full(port_full, asm, in1, in2, device="cpu",
                keep_filtered=str(keep_port))
    want = _full(jax_full, asm, in1, in2, backend="host",
                 keep_filtered=str(keep_jax))
    assert got[:2] == want[:2]
    for name in ("filtered_1.sam", "filtered_2.sam"):
        assert (keep_port / name).read_text() == (keep_jax / name).read_text()
    assert "ZP:Z:fail" in (keep_port / "filtered_1.sam").read_text()
    # without keep_filtered the temporary directory goes
    before = set(os.listdir(tmp_path))
    _full(port_full, asm, in1, in2, device="cpu")
    assert set(os.listdir(tmp_path)) == before


def _env():
    return cli_env()


def _cli(pkg, *args):
    proc = subprocess.run([sys.executable, "-m", pkg, *args],
                          capture_output=True, text=True, env=_env(),
                          cwd=REPO, timeout=300)
    return proc.returncode, proc.stdout, _mask(proc.stderr)


def test_filter_cli_matches_jax_cli(tmp_path):
    _, in1, in2 = _case(tmp_path, 64)
    outs = [str(tmp_path / f"o{i}.sam") for i in (1, 2)]
    args = ["filter", "--in1", in1, "--in2", in2, "--out1", outs[0],
            "--out2", outs[1], "--low", "2", "--high", "98"]

    def run(pkg, *extra):
        result = _cli(pkg, *args, *extra)
        texts = []
        for p in outs:
            with open(p) as f:
                texts.append(f.read())
            os.remove(p)
        return result, texts

    got = run("polypolish_tpu_torch", "--device", "cpu")
    assert got[0][0] == 0, got[0][2]
    assert got == run("polypolish_tpu")


def test_full_cli_matches_jax_cli(tmp_path):
    asm, in1, in2 = _case(tmp_path, 65)
    args = ["full", "--in1", in1, "--in2", in2, asm]
    got = _cli("polypolish_tpu_torch", *args, "--backend", "device",
               "--device", "cpu")
    assert got[0] == 0, got[2]
    assert got == _cli("polypolish_tpu", *args, "--backend", "host")
    assert got == _cli("polypolish_tpu_torch", *args, "--backend", "host",
                       "--device", "cpu")


def test_cli_fatal_filter_error(tmp_path):
    _, in1, _ = _case(tmp_path, 66)
    args = ["filter", "--in1", in1, "--in2", in1, "--out1", "a", "--out2",
            "b"]
    got = _cli("polypolish_tpu_torch", *args, "--device", "cpu")
    assert got[0] == 1 and "unique values" in got[2]
    assert got == _cli("polypolish_tpu", *args)
