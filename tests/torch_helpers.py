"""Shared helpers of the port's tests (tests/test_torch_*.py): seeded
numpy workloads that go through both polypolish_tpu and
polypolish_tpu_torch.  Importing it also makes sure polypolish_tpu's
native library and replica binary are built and loadable (race-safe
builds of tests/torch_builds.py)."""

from __future__ import annotations

import contextlib
import importlib.util
import io
import os
import re

import numpy as np

import tests.synth as synth
from tests.torch_builds import ensure_jax_native, ensure_jax_replica

DENSE_V = 8
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")

_spec = importlib.util.spec_from_file_location(
    "make_goldens", os.path.join(GOLDEN, "make_goldens.py")
)
_mg = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_mg)
GOLDEN_CASES = ["tiny"] + sorted(_mg.CASES)

_CLOCK = re.compile(r"\(\d{4}-\d\d-\d\d \d\d:\d\d:\d\d\)|"
                    r"Time to run: \d+:\d\d:\d\d\.\d{6}")


ensure_jax_native()
ensure_jax_replica()


# (n events, positions, seed, sparse_frac, skew, r_sub, tile_w): sparse,
# skewed, position-padded and narrow-tile lane packs
LANES_WORKLOADS = [
    (0, 100, 0, 0.1, False, 32, 2048),
    (1, 1, 1, 0.1, False, 32, 2048),
    (1000, 257, 2, 0.1, False, 32, 2048),
    (20000, 4096, 3, 0.1, False, 32, 2048),
    (50000, 1000, 4, 0.1, False, 32, 2048),
    (30000, 2000, 7, 0.05, True, 8, 128),
    (30000, 2000, 7, 0.05, True, 16, 256),
    (30000, 2000, 7, 0.05, True, 32, 1024),
    (120000, 4000, 1, 0.0, True, 8, 128),
]


def rand_events(n, num_positions, seed, sparse_frac=0.0, skew=False):
    """(pos int64, vocab int32) events; ``skew`` puts half of them in 1%
    of the positions (repeat-pileup shape), ``sparse_frac`` of them get
    sparse-tier ids >= 8."""
    rng = np.random.default_rng(seed)
    if skew:
        hot = rng.integers(0, max(1, num_positions // 100), size=n // 2)
        cold = rng.integers(0, num_positions, size=n - n // 2)
        pos = np.concatenate([hot, cold])
    else:
        pos = rng.integers(0, num_positions, size=n)
    vocab = rng.integers(0, DENSE_V, size=n)
    if sparse_frac:
        m = rng.random(n) < sparse_frac
        vocab = np.where(m, rng.integers(DENSE_V, DENSE_V + 40, size=n), vocab)
    return pos.astype(np.int64), vocab.astype(np.int32)


def write_polish_case(tmp_path, seed=5, genome_len=3000, n_reads=1500,
                      **kwargs):
    """A tests/synth.py polish case on disk: (assembly path, sam path)."""
    fasta, sam_text = synth.make_polish_case(
        seed=seed, genome_len=genome_len, n_reads=n_reads,
        **{"read_len": 60, "err": 0.08, "multi_frac": 0.4, **kwargs},
    )
    asm = tmp_path / f"a{seed}.fasta"
    asm.write_text(synth.fasta_text(fasta))
    sam = tmp_path / f"a{seed}.sam"
    sam.write_text(sam_text)
    return asm, sam


def parse_both(asm, sams):
    """The same SAM files parsed by both packages' native engines:
    ((jax ParsedRuns, port ParsedRuns), names, lens)."""
    from polypolish_tpu.io.fasta import load_fasta
    from polypolish_tpu.native import runs as jax_runs
    from polypolish_tpu.vocab import Vocab as JaxVocab
    from polypolish_tpu_torch.native import runs as torch_runs
    from polypolish_tpu_torch.vocab import Vocab

    assert ensure_jax_native() is not None, (
        "polypolish_tpu's native library did not load: its unlocked "
        "build (polypolish_tpu/native/binding.py _build) lost a race "
        "with another process and the locked rebuild failed too")
    fa = load_fasta(asm)
    names = [n for n, _, _ in fa]
    lens = {n: len(s) for n, _, s in fa}
    files = [str(s) for s in sams]
    jr = jax_runs.parse_runs(files, names, lens, JaxVocab(), 10, False)
    tr = torch_runs.parse_runs(files, names, lens, Vocab(), 10, False)
    return (jr, tr), names, lens


def golden_careful(name):
    """Whether golden case ``name`` runs with --careful."""
    return name != "tiny" and _mg.CASES[name]["params"].get("careful", False)


def mask_clock(text: str) -> str:
    return _CLOCK.sub("<clock>", text)


REPO = os.path.dirname(os.path.dirname(GOLDEN))


def cli_env(**extra):
    """Environment of a ``python -m polypolish_tpu[_torch]`` subprocess
    whose output is compared: the repository on PYTHONPATH, plain log
    lines, JAX on the CPU, and the JAX CLI's persistent XLA cache off.
    With the cache on, a warm cache makes JAX's XLA:CPU loader write
    ``cpu_aot_loader`` lines into stderr, which no longer matches the
    port's narrative."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["POLYPOLISH_TPU_PLAIN_LOG"] = "1"
    env["JAX_PLATFORMS"] = "cpu"
    env["POLYPOLISH_TPU_CACHE_DIR"] = "off"
    env.update(extra)
    return env


POLISHER_WRAPPERS = ("lanes_counts", "overflow_counts", "chunk_counts")


def count_polisher_calls(monkeypatch):
    """Counter of the calls models/polisher.py makes to the kernel
    wrappers while the test runs (on the CPU the wrappers run the plain
    versions, which the launch counters do not count)."""
    import collections

    from polypolish_tpu_torch.models import polisher

    calls = collections.Counter()
    for name in POLISHER_WRAPPERS:
        def wrap(*args, _fn=getattr(polisher, name), _name=name, **kwargs):
            calls[_name] += 1
            return _fn(*args, **kwargs)

        monkeypatch.setattr(polisher, name, wrap)
    return calls


def run_polish(fn, tmp_path, tag, fasta, sams, careful=False, **kwargs):
    """(FASTA, debug TSV, masked stderr) of one polish run.  The debug
    path is the same for every run so the stderr narratives compare."""
    debug = tmp_path / "debug.tsv"
    out = io.StringIO()
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        fn(str(debug), 0.2, 0.5, 10, 5, careful, str(fasta),
           [str(s) for s in sams], out=out, **kwargs)
    tsv = debug.read_text()
    os.replace(debug, tmp_path / f"debug_{tag}.tsv")
    return out.getvalue(), tsv, mask_clock(err.getvalue())


def synth_case(tmp_path, kind):
    """(fasta path, [sam paths]) of a tests/synth.py case."""
    if kind == "multi_contig":
        fasta, sam_text = synth.make_multi_contig_case(
            seed=4, n_contigs=3, genome_len=2500, n_reads=700,
            read_len=50)
        sams = [sam_text]
    elif kind == "two_files":
        fasta, s1 = synth.make_polish_case(seed=11, genome_len=5000,
                                           n_reads=1500, read_len=70)
        _, s2 = synth.make_polish_case(seed=11, genome_len=5000,
                                       n_reads=1500, read_len=70,
                                       shuffle_groups=True)
        sams = [s1, s2]
    else:  # deep, insertion-rich pileup: sparse tier + overflow list
        fasta, sam_text = synth.make_polish_case(
            seed=12, genome_len=3000, n_reads=6000, read_len=60,
            err=0.15, multi_frac=0.5, n_draft_errors=25)
        sams = [sam_text]
    asm = tmp_path / f"{kind}.fasta"
    asm.write_text(synth.fasta_text(fasta))
    paths = []
    for i, text in enumerate(sams):
        p = tmp_path / f"{kind}_{i}.sam"
        p.write_text(text)
        paths.append(p)
    return asm, paths
