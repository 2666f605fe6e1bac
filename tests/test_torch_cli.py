"""The port's CLI flags of this slice against ``python -m polypolish_tpu``
with the same flags (its ``--backend pallas`` is the port's ``device``):
``batch``, ``--pure-python`` (SAM and BAM), ``--pod-shards`` on
``polish`` and ``full``, the default ``--backend auto`` (the host
backend on a machine without a GPU) and POLYPOLISH_TPU_KERNEL; the
JAX CLI under POLYPOLISH_TPU_OV_MODE and POLYPOLISH_TPU_PLATFORM, which
the port does not read.  stdout, --debug TSV, output files and stderr
with the clock masked are compared."""

import os
import subprocess
import sys

import pytest

import tests.bam_util as bam_util
import tests.synth as synth
from tests.torch_helpers import (
    GOLDEN,
    cli_env,
    count_polisher_calls,
    mask_clock,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cli(pkg, *args, debug=None, **env):
    """(exit code, stdout, --debug TSV or None, masked stderr) under the
    environment variables given."""
    if pkg == "polypolish_tpu_torch" and args[0] != "filter":
        args = (args[0], "--device", "cpu", *args[1:])
    proc = subprocess.run([sys.executable, "-m", pkg, *args],
                          capture_output=True, text=True, env=cli_env(**env),
                          cwd=REPO, timeout=300)
    tsv = None
    if debug is not None and os.path.exists(debug):
        with open(debug) as f:
            tsv = f.read()
        os.remove(debug)
    return proc.returncode, proc.stdout, tsv, mask_clock(proc.stderr)


@pytest.fixture
def case(tmp_path):
    fasta, text = synth.make_multi_contig_case(
        seed=4, n_contigs=2, genome_len=1500, n_reads=600, read_len=50,
        multi_frac=0.4)
    asm = tmp_path / "asm.fasta"
    asm.write_text(synth.fasta_text(fasta))
    sam = tmp_path / "a.sam"
    sam.write_text(text)
    bam = tmp_path / "a.bam"
    bam_util.write_bam(bam, text)
    return str(asm), str(sam), str(bam), str(tmp_path / "d.tsv")


@pytest.mark.parametrize("backend", ["host", "device", "xla"])
def test_pure_python_polish_matches_jax_cli(case, backend):
    asm, sam, bam, dbg = case
    jax_backend = "pallas" if backend == "device" else backend
    for inputs in ([sam], [bam, sam]):
        flags = ["polish", "--pure-python", "--debug", dbg]
        got = _cli("polypolish_tpu_torch", *flags, "--backend", backend, asm,
                   *inputs, debug=dbg)
        assert got[0] == 0, got[3]
        assert got == _cli("polypolish_tpu", *flags, "--backend",
                           jax_backend, asm, *inputs, debug=dbg)


def test_default_auto_and_pod_shards_match_jax_cli(case):
    asm, sam, bam, dbg = case
    got = _cli("polypolish_tpu_torch", "polish", "--debug", dbg, asm, sam,
               debug=dbg)
    assert got[0] == 0, got[3]
    assert got == _cli("polypolish_tpu", "polish", "--debug", dbg, asm, sam,
                       debug=dbg)
    for inputs in ([sam], [bam, sam]):
        args = ["polish", "--pod-shards", "3", "--debug", dbg, asm, *inputs]
        pod = _cli("polypolish_tpu_torch", *args, debug=dbg)
        assert pod[0] == 0, pod[3]
        assert pod == _cli("polypolish_tpu", *args, debug=dbg)
        if inputs == [sam]:  # and the unsharded FASTA and TSV
            assert pod[1:3] == got[1:3]
    # the refusal and the note of the JAX CLI
    args = ["polish", "--pod-shards", "2", "--pure-python", asm, sam]
    refused = _cli("polypolish_tpu_torch", *args)
    assert refused[0] == 1 and "incompatible with --pure-python" in refused[3]
    assert refused == _cli("polypolish_tpu", *args)
    noted = _cli("polypolish_tpu_torch", "polish", "--pod-shards", "2",
                 "--backend", "xla", asm, sam)
    assert noted == _cli("polypolish_tpu", "polish", "--pod-shards", "2",
                         "--backend", "xla", asm, sam)
    assert "ignoring --backend xla" in noted[3]


def test_batch_matches_jax_cli(tmp_path):
    jobs = []
    for i in range(3):
        fasta, text = synth.make_polish_case(seed=60 + i, genome_len=500,
                                             n_reads=250,
                                             contig_name=f"b{i}")
        asm = tmp_path / f"b{i}.fasta"
        asm.write_text(synth.fasta_text(fasta))
        sam = tmp_path / f"b{i}.sam"
        sam.write_text(text)
        jobs.append((str(asm), str(sam)))

    def run(pkg, tag, *flags):
        manifest = tmp_path / f"{tag}.tsv"
        outs = [str(tmp_path / f"{tag}_{i}.fasta") for i in range(len(jobs))]
        manifest.write_text("".join(f"{a}\t{o}\t{s}\n"
                                    for (a, s), o in zip(jobs, outs)))
        result = _cli(pkg, "batch", *flags, str(manifest))
        texts = []
        for o in outs:
            with open(o) as f:
                texts.append(f.read())
        return result, texts

    got = run("polypolish_tpu_torch", "port", "--workers", "2")
    assert got[0][0] == 0, got[0][3]
    assert got == run("polypolish_tpu", "jax", "--workers", "2")
    dev = run("polypolish_tpu_torch", "dev", "--backend", "device",
              "--pure-python", "--workers", "3")
    assert dev[0][0] == 0 and dev[1] == got[1]
    resumed = run("polypolish_tpu_torch", "dev", "--backend", "device",
                  "--resume")
    assert "3 resumed/skipped" in resumed[0][3]
    assert resumed[1] == got[1]


@pytest.mark.parametrize("flag", ["--pure-python", "--pod-shards"])
def test_full_matches_jax_cli(tmp_path, flag):
    in1, in2 = synth.make_filter_case(seed=3)
    p1, p2 = tmp_path / "i1.sam", tmp_path / "i2.sam"
    p1.write_text(in1)
    p2.write_text(in2)
    import numpy as np

    rng = np.random.default_rng(3)  # the filter case's genomes
    asm = tmp_path / "paired.fasta"
    asm.write_text(synth.fasta_text(
        [(c, "", synth.rand_seq(rng, 5000)) for c in ("c1", "c2")]))
    flags = [flag] if flag == "--pure-python" else [flag, "3"]
    args = ["full", "--in1", str(p1), "--in2", str(p2), *flags, str(asm)]
    got = _cli("polypolish_tpu_torch", *args)
    assert got[0] == 0, got[3]
    want = _cli("polypolish_tpu", *args)
    # the temporary directory of the filtered SAMs has a random name
    assert got[:2] == want[:2]
    strip = [ln for ln in got[3].splitlines() if "polypolish_tpu_" not in ln]
    assert strip == [ln for ln in want[3].splitlines()
                     if "polypolish_tpu_" not in ln]


@pytest.fixture
def kernel_calls(monkeypatch):
    return count_polisher_calls(monkeypatch)


def _in_process(argv):
    import contextlib
    import io

    from polypolish_tpu_torch import cli

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    assert rc == 0, err.getvalue()
    return out.getvalue()


@pytest.mark.parametrize("command", ["polish", "batch", "full"])
def test_kernel_variable_picks_the_chunk_path(tmp_path, monkeypatch,
                                              kernel_calls, command):
    """POLYPOLISH_TPU_KERNEL=mxu with no --kernel-variant takes the chunk
    kernel's path (no lanes entry point), as the JAX CLI's --backend
    pallas does under the same variable, with the same bytes out; an
    explicit --kernel-variant still wins."""
    tiny = [os.path.join(GOLDEN, "tiny.fasta"),
            os.path.join(GOLDEN, "tiny.sam")]
    outs = [str(tmp_path / f"o{i}.fasta") for i in range(2)]
    if command == "polish":
        args, n_contigs = ["polish", *tiny], 1
    elif command == "batch":
        manifest = tmp_path / "m.tsv"
        manifest.write_text("".join(f"{tiny[0]}\t{o}\t{tiny[1]}\n"
                                    for o in outs))
        args, n_contigs = ["batch", "--workers", "1", str(manifest)], 2
    else:
        import numpy as np

        paired = []
        for i, text in enumerate(synth.make_filter_case(seed=3), 1):
            paired.append(tmp_path / f"p{i}.sam")
            paired[-1].write_text(text)
        rng = np.random.default_rng(3)  # the filter case's genomes
        asm = tmp_path / "paired.fasta"
        asm.write_text(synth.fasta_text(
            [(c, "", synth.rand_seq(rng, 5000)) for c in ("c1", "c2")]))
        args = ["full", "--in1", str(paired[0]), "--in2", str(paired[1]),
                str(asm)]
        n_contigs = 2

    def flags(backend):
        return [args[0], "--backend", backend, *args[1:]]

    def outputs(result):
        if command != "batch":
            return result
        texts = []
        for o in outs:
            with open(o) as f:
                texts.append(f.read())
            os.remove(o)
        return result, texts

    monkeypatch.setenv("POLYPOLISH_TPU_KERNEL", "mxu")
    port = ["--device", "cpu", *flags("device")[1:]]
    got = _in_process([args[0], *port])
    assert dict(kernel_calls) == {"chunk_counts": n_contigs}
    got = outputs(got)
    kernel_calls.clear()
    _in_process([args[0], "--kernel-variant", "lanes", *port])
    assert kernel_calls["lanes_counts"] == n_contigs
    outputs(None)

    env = cli_env(POLYPOLISH_TPU_KERNEL="mxu")

    def cli(pkg, argv):
        proc = subprocess.run([sys.executable, "-m", pkg, *argv],
                              capture_output=True, text=True, env=env,
                              cwd=REPO, timeout=300)
        assert proc.returncode == 0, proc.stderr
        strip = [ln for ln in proc.stderr.splitlines()
                 if "polypolish_tpu_" not in ln]  # full's temporary dir
        # batch names the backend: the JAX package's pallas is device
        err = "\n".join(strip).replace("backend=pallas", "backend=device")
        return outputs((proc.stdout, mask_clock(err)))

    want = cli("polypolish_tpu", flags("pallas"))
    assert cli("polypolish_tpu_torch", [args[0], *port]) == want
    if command != "batch":
        assert got == want[0]
    else:
        assert got[1] == want[1]


@pytest.mark.parametrize("ov_mode", ["scatter", "mxu"])
def test_ov_mode_variable_matches_jax_cli(tmp_path, monkeypatch,
                                          kernel_calls, ov_mode):
    """The lanes polish of a case with cap-overflow events under
    POLYPOLISH_TPU_OV_MODE: the port folds the overflow with the
    overflow kernel whatever the value, and its stdout, --debug TSV and stderr
    equal the JAX CLI's --backend pallas under the same value (its
    scatter or its chunk kernel)."""
    from tests.torch_helpers import synth_case

    asm, sams = synth_case(tmp_path, "deep")
    dbg = str(tmp_path / "d.tsv")
    args = ["polish", "--debug", dbg, str(asm), *map(str, sams)]
    monkeypatch.setenv("POLYPOLISH_TPU_OV_MODE", ov_mode)
    fasta = _in_process([args[0], "--backend", "device", "--device", "cpu",
                         *args[1:]])
    assert dict(kernel_calls) == {"lanes_counts": 1, "overflow_counts": 1}
    got = _cli("polypolish_tpu_torch", args[0], "--backend", "device",
               *args[1:], debug=dbg, POLYPOLISH_TPU_OV_MODE=ov_mode)
    want = _cli("polypolish_tpu", args[0], "--backend", "pallas", *args[1:],
                debug=dbg, POLYPOLISH_TPU_OV_MODE=ov_mode)
    assert got[0] == 0, got[3]
    assert got == want
    assert got[1] == fasta


def test_platform_variable_matches_jax_cli(tmp_path):
    """The JAX CLI forces its platform with POLYPOLISH_TPU_PLATFORM; the
    port's only switch is --device, and it reads no such variable.  With
    --device cpu the port is byte-equal to the JAX CLI under
    POLYPOLISH_TPU_PLATFORM=cpu (the default backend and the device
    one), whatever the variable holds."""
    fasta = os.path.join(GOLDEN, "indel_adopted.fasta")
    sam = os.path.join(GOLDEN, "indel_adopted.sam")
    dbg = str(tmp_path / "d.tsv")
    for port_flags, jax_flags in (([], []),
                                  (["--backend", "device"],
                                   ["--backend", "pallas"])):
        args = ["--debug", dbg, fasta, sam]
        want = _cli("polypolish_tpu", "polish", *jax_flags, *args,
                    debug=dbg, POLYPOLISH_TPU_PLATFORM="cpu")
        assert want[0] == 0, want[3]
        for platform in ("cpu", "tpu"):
            got = _cli("polypolish_tpu_torch", "polish", *port_flags, *args,
                       debug=dbg, POLYPOLISH_TPU_PLATFORM=platform)
            assert got == want, platform
