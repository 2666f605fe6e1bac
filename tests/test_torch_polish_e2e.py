"""The port's ``polish`` end to end against polypolish_tpu's (its mxu
and xla paths: tests/test_torch_polish_paths.py).

On the CPU, ``polypolish_tpu_torch.pipeline.polish.polish`` (backend
"device" with device="cpu", which runs the kernels' plain PyTorch
versions, and backend "host") must give a FASTA and --debug TSV
byte-identical to ``polypolish_tpu.pipeline.polish.polish`` (backends
"host" and "pallas") and to tests/golden/*.expected.*, and a stderr
narrative identical once the clock lines are masked.  Also: the port
imports neither jax nor polypolish_tpu (a subprocess run of every
path and a static scan), its entry points default to CUDA, and its CLI
matches the JAX package's.
"""

import ast
import contextlib
import io
import os
import subprocess
import sys

import pytest
import torch

from polypolish_tpu.errors import PolypolishError as JaxError
from polypolish_tpu.pipeline.polish import polish as jax_polish
from polypolish_tpu_torch.errors import PolypolishError
from polypolish_tpu_torch.pipeline.polish import polish as port_polish
from tests.torch_helpers import (
    GOLDEN,
    GOLDEN_CASES,
    cli_env,
    golden_careful,
    mask_clock,
)
from tests.torch_helpers import run_polish as run
from tests.torch_helpers import synth_case as _synth_case

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


PORT_RUNS = {
    "device": dict(backend="device", device="cpu"),
    "host": dict(backend="host"),
}


@pytest.mark.parametrize("port_backend", sorted(PORT_RUNS))
@pytest.mark.parametrize("name", GOLDEN_CASES)
def test_golden_matches_jax_host_and_files(tmp_path, name, port_backend):
    careful = golden_careful(name)
    fasta = os.path.join(GOLDEN, f"{name}.fasta")
    sams = [os.path.join(GOLDEN, f"{name}.sam")]
    got = run(port_polish, tmp_path, "port", fasta, sams, careful,
              **PORT_RUNS[port_backend])
    want = run(jax_polish, tmp_path, "jax", fasta, sams, careful,
               backend="host")
    assert got == want
    with open(os.path.join(GOLDEN, f"{name}.expected.fasta")) as f:
        assert got[0] == f.read()
    with open(os.path.join(GOLDEN, f"{name}.expected.tsv")) as f:
        assert got[1] == f.read()


@pytest.mark.parametrize("name", ["tiny", "indel_adopted", "multi_contig",
                                  "careful_mode", "third_weights"])
def test_golden_matches_jax_pallas(tmp_path, name):
    careful = golden_careful(name)
    fasta = os.path.join(GOLDEN, f"{name}.fasta")
    sams = [os.path.join(GOLDEN, f"{name}.sam")]
    got = run(port_polish, tmp_path, "port", fasta, sams, careful,
              backend="device", device="cpu")
    want = run(jax_polish, tmp_path, "jax", fasta, sams, careful,
               backend="pallas")
    assert got == want


@pytest.mark.parametrize("careful", [False, True])
@pytest.mark.parametrize("kind", ["multi_contig", "two_files", "deep"])
def test_synth_matches_jax(tmp_path, kind, careful):
    asm, sams = _synth_case(tmp_path, kind)
    device = run(port_polish, tmp_path, "dev", asm, sams, careful,
                 backend="device", device="cpu")
    host = run(port_polish, tmp_path, "host", asm, sams, careful,
               backend="host")
    jax_host = run(jax_polish, tmp_path, "jh", asm, sams, careful,
                   backend="host")
    jax_pallas = run(jax_polish, tmp_path, "jp", asm, sams, careful,
                     backend="pallas")
    assert device == jax_host
    assert host == jax_host
    assert jax_pallas == jax_host


def test_python_debug_writer_matches_native(tmp_path, monkeypatch):
    """The Python --debug loop (taken for non-ASCII content) writes the
    same bytes as the native writer."""
    port_module = sys.modules["polypolish_tpu_torch.pipeline.polish"]
    asm, sams = _synth_case(tmp_path, "deep")
    native = run(port_polish, tmp_path, "native", asm, sams,
                 backend="device", device="cpu")
    monkeypatch.setattr(port_module, "_write_debug_lines_native",
                        lambda *a, **k: False)
    python = run(port_polish, tmp_path, "python", asm, sams,
                 backend="device", device="cpu")
    assert python == native


def test_deep_case_exercises_sparse_tier_and_overflow(tmp_path):
    """The 'deep' synth case really reaches the sparse tier and the
    cap-overflow list (so the chunk vote path runs end to end)."""
    from polypolish_tpu_torch.io.fasta import load_fasta
    from polypolish_tpu_torch.native import runs
    from polypolish_tpu_torch.vocab import Vocab

    asm, sams = _synth_case(tmp_path, "deep")
    fa = load_fasta(asm)
    names = [n for n, _, _ in fa]
    lens = {n: len(s) for n, _, s in fa}
    pr = runs.parse_runs([str(s) for s in sams], names, lens, Vocab(), 10,
                         False)
    try:
        assert pr.sparse(names[0])[0].size > 0
        pack = pr.lanes(names[0], 32, 2048, num_positions=4096,
                        packed4=True, cap=True)
        assert (pack.ov_vid < 8).sum() > 0
        pack.close()
    finally:
        pr.close()


def test_parsed_runs_and_lanes_pack_are_context_managers(tmp_path):
    """``with`` frees the native handle of a ParsedRuns and of a
    LanesPack on the way out, as the JAX package's classes do, and a
    second close() is harmless."""
    from polypolish_tpu_torch.io.fasta import load_fasta
    from polypolish_tpu_torch.native import runs
    from polypolish_tpu_torch.vocab import Vocab

    asm, sams = _synth_case(tmp_path, "deep")
    (name, _, seq), = load_fasta(asm)
    with runs.parse_runs([str(s) for s in sams], [name], {name: len(seq)},
                         Vocab(), 10, False) as pr:
        assert pr._view is not None
        with pr.lanes(name, 32, 2048, num_positions=4096, packed4=True,
                      cap=True) as pack:
            assert pack._view is not None and pack.n_overflow > 0
            ov = pack.ov_pos.copy()
        assert pack._view is None and pack.vb is None and pack.ov_pos is None
        pack.close()
        assert pr._view is not None
    assert pr._view is None
    pr.close()
    assert ov.size > 0


@pytest.mark.parametrize("args,match", [
    (dict(fraction_invalid=0.6), "less than --fraction_valid"),
    (dict(fraction_valid=1.0), "between 0 and 1"),
    (dict(assembly="missing.fasta"), "does not exist"),
    (dict(sam=["missing.sam"]), "does not exist"),
])
def test_fatal_errors_match_jax(tmp_path, args, match):
    params = dict(debug=None, fraction_invalid=0.2, fraction_valid=0.5,
                  max_errors=10, min_depth=5, careful=False,
                  assembly=os.path.join(GOLDEN, "tiny.fasta"),
                  sam=[os.path.join(GOLDEN, "tiny.sam")])
    params.update(args)
    with contextlib.redirect_stderr(io.StringIO()):
        with pytest.raises(PolypolishError, match=match) as got:
            port_polish(**params, out=io.StringIO(), device="cpu")
        with pytest.raises(JaxError) as want:
            jax_polish(**params, out=io.StringIO(), backend="host")
    assert str(got.value) == str(want.value)


def test_cuda_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        port_polish(None, 0.2, 0.5, 10, 5, False,
                    os.path.join(GOLDEN, "tiny.fasta"),
                    [os.path.join(GOLDEN, "tiny.sam")], out=io.StringIO())


def test_unknown_backend_raises():
    with pytest.raises(ValueError, match="backend"):
        port_polish(None, 0.2, 0.5, 10, 5, False,
                    os.path.join(GOLDEN, "tiny.fasta"),
                    [os.path.join(GOLDEN, "tiny.sam")], out=io.StringIO(),
                    backend="pallas")


def _env():
    return cli_env()


def test_cli_matches_jax_cli(tmp_path):
    fasta = os.path.join(GOLDEN, "multi_contig.fasta")
    sam = os.path.join(GOLDEN, "multi_contig.sam")
    dbg = str(tmp_path / "d.tsv")

    def cli(pkg, *extra):
        proc = subprocess.run(
            [sys.executable, "-m", pkg, "polish", "--debug", dbg, *extra,
             fasta, sam],
            capture_output=True, text=True, env=_env(), cwd=REPO,
            timeout=300,
        )
        assert proc.returncode == 0, proc.stderr
        with open(dbg) as f:
            tsv = f.read()
        return proc.stdout, tsv, mask_clock(proc.stderr)

    got = cli("polypolish_tpu_torch", "--backend", "device", "--device",
              "cpu")
    assert got == cli("polypolish_tpu_torch", "--backend", "host")
    assert got == cli("polypolish_tpu", "--backend", "host")


def test_cli_backend_flags_match_jax_cli(tmp_path):
    """--backend xla and --kernel-variant mxu against the JAX CLI with
    the same flags (its --backend pallas is the port's device)."""
    fasta = os.path.join(GOLDEN, "indel_adopted.fasta")
    sam = os.path.join(GOLDEN, "indel_adopted.sam")
    dbg = str(tmp_path / "d.tsv")

    def cli(pkg, *flags):
        proc = subprocess.run(
            [sys.executable, "-m", pkg, "polish", "--debug", dbg, *flags,
             fasta, sam],
            capture_output=True, text=True, env=_env(), cwd=REPO,
            timeout=300,
        )
        assert proc.returncode == 0, proc.stderr
        with open(dbg) as f:
            return proc.stdout, f.read(), mask_clock(proc.stderr)

    assert (cli("polypolish_tpu_torch", "--backend", "xla", "--device",
                "cpu")
            == cli("polypolish_tpu", "--backend", "xla"))
    assert (cli("polypolish_tpu_torch", "--backend", "device",
                "--kernel-variant", "mxu", "--device", "cpu")
            == cli("polypolish_tpu", "--backend", "pallas",
                   "--kernel-variant", "mxu"))


def test_entry_points_default_to_cuda(monkeypatch):
    """Every entry point of the port runs on the card unless the caller
    asks for the CPU."""
    import inspect

    from polypolish_tpu_torch import cli
    from polypolish_tpu_torch.models import polisher
    from polypolish_tpu_torch.ops import vote, vote_chunks, vote_lanes
    from polypolish_tpu_torch.parallel import make_mesh
    from polypolish_tpu_torch.parallel.multihost import global_mesh
    from polypolish_tpu_torch.pipeline.batch import polish_batch
    from polypolish_tpu_torch.pipeline.pod_distributed import (
        polish_pod_distributed,
    )
    from polypolish_tpu_torch.utils import transport

    for fn in (port_polish, vote.count_votes, vote_lanes.dense_counts_lanes,
               vote_chunks.dense_counts_chunks, polisher.PolisherModel,
               polisher.example_inputs, polish_batch,
               transport.predict_backend, transport.measure_link,
               polish_pod_distributed, global_mesh):
        default = inspect.signature(fn).parameters["device"].default
        assert default == "cuda", fn
    # the CLI's default backend is auto, as in the JAX CLI, and its
    # kernel variant None (POLYPOLISH_TPU_KERNEL, else lanes); the
    # library default of polish() stays device
    args = cli.build_parser().parse_args(["polish", "a.fasta", "a.sam"])
    assert (args.device, args.backend, args.kernel_variant) == (
        "cuda", "auto", None)
    # a grid with no devices given spans the visible cards, and the
    # sharded polish and the pod refuse to start without one
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    for grid in (make_mesh(), global_mesh()):
        assert [str(d) for d in grid.devices.reshape(-1)] == [
            "cuda:0", "cuda:1"]
    assert str(global_mesh(device="cpu")) == "Mesh(1x1: cpu)"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        make_mesh()
    tiny = (os.path.join(GOLDEN, "tiny.fasta"),
            [os.path.join(GOLDEN, "tiny.sam")])
    with pytest.raises(RuntimeError, match="is_available"):
        port_polish(None, 0.2, 0.5, 10, 5, False, *tiny, out=io.StringIO(),
                    backend="sharded")
    with pytest.raises(RuntimeError, match="is_available"):
        polish_pod_distributed(None, 0.2, 0.5, 10, 5, False, *tiny,
                               out=io.StringIO())
    args = cli.build_parser().parse_args(["batch", "m.tsv"])
    assert (args.device, args.backend) == ("cuda", "auto")
    assert inspect.signature(port_polish).parameters["backend"].default == \
        "device"


def test_cli_fatal_error_exit_code(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "polypolish_tpu_torch", "polish", "--device",
         "cpu", str(tmp_path / "nope.fasta"), str(tmp_path / "nope.sam")],
        capture_output=True, text=True, env=_env(), cwd=REPO, timeout=300,
    )
    assert proc.returncode == 1
    assert "does not exist" in proc.stderr


_NO_JAX_SCRIPT = r"""
import io, os, sys
from polypolish_tpu_torch import cli
from polypolish_tpu_torch.io import bam
from polypolish_tpu_torch.pipeline import filtering
from polypolish_tpu_torch.pipeline.batch import polish_batch
from polypolish_tpu_torch.pipeline.full import polish_paired
from polypolish_tpu_torch.pipeline.pod import polish_pod
from polypolish_tpu_torch.pipeline.polish import polish
from polypolish_tpu_torch.utils import transport
from polypolish_tpu_torch.parallel import make_mesh, multihost
from polypolish_tpu_torch.pipeline.pod_distributed import (
    polish_pod_distributed)
grid = make_mesh(2, 2, devices=["cpu"] * 4)
for kwargs in (dict(), dict(kernel_variant="mxu"), dict(backend="xla"),
               dict(use_native=False), dict(use_native=False, backend="xla"),
               dict(use_native=False, backend="host"),
               dict(backend="sharded"), dict(backend="sharded", mesh=grid),
               dict(backend="sharded", mesh=grid, kernel_variant="mxu"),
               dict(backend="sharded", mesh=grid, use_native=False),
               dict(backend="sharded", mesh=grid, use_native=False,
                    kernel_variant="mxu")):
    polish(None, 0.2, 0.5, 10, 5, False, sys.argv[1], [sys.argv[2]],
           out=io.StringIO(), device="cpu", **kwargs)
import socket
s = socket.socket()
s.bind(("127.0.0.1", 0))
port = s.getsockname()[1]
s.close()
assert multihost.initialize_distributed(f"127.0.0.1:{port}", 1, 0)
os.environ["POLYPOLISH_TPU_POD_DEVICE_VOTES"] = "1"
polish_pod_distributed(None, 0.2, 0.5, 10, 5, False, sys.argv[1],
                       [sys.argv[2]], out=io.StringIO(), device="cpu")
polish_batch([(sys.argv[1], os.path.join(sys.argv[5], "b.fasta"),
               [sys.argv[2]])], device="cpu", shard_across_hosts=True)
multihost.shutdown_distributed()
polish_pod(None, 0.2, 0.5, 10, 5, False, sys.argv[1], [sys.argv[2]], 2,
           out=io.StringIO())
out = os.path.join(sys.argv[5], "batch.fasta")
polish_batch([(sys.argv[1], out, [sys.argv[2]])] * 2, device="cpu",
             workers=2)
assert cli._resolve_backend("auto", [sys.argv[2]], device="cpu") == "host"
transport.measure_link(device="cpu")
os.environ["POLYPOLISH_TPU_WINDOW_MIN"] = "1"
os.environ["POLYPOLISH_TPU_WINDOW"] = "100"
for backend in ("device", "host"):
    polish(None, 0.2, 0.5, 10, 5, False, sys.argv[1], [sys.argv[2]],
           out=io.StringIO(), device="cpu", backend=backend)
filtering._DEVICE_GRID_THRESHOLD = 0
work = sys.argv[5]
filtering.filter_pairs(sys.argv[3], sys.argv[4], os.path.join(work, "1.sam"),
                       os.path.join(work, "2.sam.gz"), device="cpu")
polish_paired(sys.argv[6], sys.argv[3], sys.argv[4], out=io.StringIO(),
              device="cpu")
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "polypolish_tpu" or m.startswith("polypolish_tpu."))
print("BAD:" + ",".join(bad))
"""


def test_port_imports_no_jax_at_run_time(tmp_path):
    """Every path the port has (polish on each backend, windowed or not,
    sharded on a grid; the pod over a one-process gloo group with device
    votes; batch sharded across hosts; filter through the device grid
    step and a .gz output; full) runs without loading jax or
    polypolish_tpu."""
    import numpy as np

    import tests.synth as synth

    paired = []
    for i, text in enumerate(synth.make_filter_case(seed=3), 1):
        paired.append(tmp_path / f"p{i}.sam")
        paired[-1].write_text(text)
    rng = np.random.default_rng(3)  # the filter case's genomes
    asm = tmp_path / "paired.fasta"
    asm.write_text(synth.fasta_text(
        [(c, "", synth.rand_seq(rng, 5000)) for c in ("c1", "c2")]))
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX_SCRIPT,
         os.path.join(GOLDEN, "indel_adopted.fasta"),
         os.path.join(GOLDEN, "indel_adopted.sam"),
         *map(str, paired), str(tmp_path), str(asm)],
        capture_output=True, text=True, env=_env(), cwd=REPO, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "BAD:"


def _port_sources():
    root = os.path.join(REPO, "polypolish_tpu_torch")
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(REPO, "chip_smoke.py")


def _forbidden(name: str) -> bool:
    return (name == "jax" or name.startswith("jax.")
            or name == "polypolish_tpu" or name.startswith("polypolish_tpu."))


def test_port_sources_import_no_jax():
    offenders = []
    scanned = set()
    for path in _port_sources():
        scanned.add(os.path.relpath(path, REPO))
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{path}: {n}" for n in names if _forbidden(n)]
    assert len(scanned) > 20
    for module in ("ops/vote.py", "ops/vote_lanes.py", "ops/vote_chunks.py",
                   "ops/pairfilter.py", "models/polisher.py",
                   "models/pairscreen.py", "pipeline/polish.py",
                   "pipeline/filtering.py", "pipeline/full.py",
                   "native/runs.py", "cli.py", "ops/cigar.py",
                   "ops/pack.py", "ops/launch_count.py", "io/sam.py",
                   "io/bam.py", "utils/revcomp.py", "utils/transport.py",
                   "utils/malloc_tuning.py", "pipeline/batch.py",
                   "pipeline/pod.py", "parallel/__init__.py",
                   "parallel/mesh.py", "parallel/shard.py",
                   "parallel/multihost.py", "pipeline/pod_distributed.py"):
        assert os.path.join("polypolish_tpu_torch", module) in scanned
    assert "chip_smoke.py" in scanned
    assert offenders == []
