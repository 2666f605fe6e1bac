"""The port's mxu and xla polish paths end to end against
polypolish_tpu's.

``polish(backend="device", kernel_variant="mxu")`` (the chunk vote
kernel over the whole pileup; its plain PyTorch version on the CPU)
must be byte-identical to ``polypolish_tpu``'s ``backend="pallas"``
with POLYPOLISH_TPU_KERNEL=mxu, and ``polish(backend="xla")`` to its
``backend="xla"``: FASTA, --debug TSV and the stderr narrative with the
clock masked, on the golden cases (also against their expected files)
and on synthetic multi-contig, two-file and deep cases.
"""

import os

import pytest

from polypolish_tpu.pipeline.polish import polish as jax_polish
from polypolish_tpu_torch.native import runs as port_runs
from polypolish_tpu_torch.pipeline.polish import polish as port_polish
from tests.torch_helpers import GOLDEN, GOLDEN_CASES, golden_careful
from tests.torch_helpers import run_polish as run
from tests.torch_helpers import synth_case

PATHS = {
    # path: (port polish arguments, JAX polish backend, JAX kernel)
    "mxu": (dict(backend="device", kernel_variant="mxu", device="cpu"),
            "pallas", "mxu"),
    "xla": (dict(backend="xla", device="cpu"), "xla", "lanes"),
}


def run_both(monkeypatch, tmp_path, path, fasta, sams, careful):
    port_kwargs, jax_backend, jax_kernel = PATHS[path]
    monkeypatch.setenv("POLYPOLISH_TPU_KERNEL", jax_kernel)
    got = run(port_polish, tmp_path, "port", fasta, sams, careful,
              **port_kwargs)
    want = run(jax_polish, tmp_path, "jax", fasta, sams, careful,
               backend=jax_backend)
    return got, want


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("name", GOLDEN_CASES)
def test_golden_matches_jax_and_files(monkeypatch, tmp_path, name, path):
    fasta = os.path.join(GOLDEN, f"{name}.fasta")
    sams = [os.path.join(GOLDEN, f"{name}.sam")]
    got, want = run_both(monkeypatch, tmp_path, path, fasta, sams,
                         golden_careful(name))
    assert got == want
    with open(os.path.join(GOLDEN, f"{name}.expected.fasta")) as f:
        assert got[0] == f.read()
    with open(os.path.join(GOLDEN, f"{name}.expected.tsv")) as f:
        assert got[1] == f.read()


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("kind", ["multi_contig", "two_files", "deep"])
def test_synth_matches_jax(monkeypatch, tmp_path, kind, path):
    asm, sams = synth_case(tmp_path, kind)
    got, want = run_both(monkeypatch, tmp_path, path, asm, sams, False)
    assert got == want


@pytest.mark.parametrize("path", sorted(PATHS))
def test_events_fallback_matches(monkeypatch, tmp_path, path):
    """Where the native chunk layout has no pack (tile_p > 256 in the
    JAX package), the paths expand the runs to events and pack them with
    PolisherModel.pack: the same bytes out."""
    asm, sams = synth_case(tmp_path, "deep")
    kwargs = PATHS[path][0]
    want = run(port_polish, tmp_path, "chunks", asm, sams, **kwargs)
    monkeypatch.setattr(port_runs.ParsedRuns, "chunks",
                        lambda self, *a, **k: None)
    got = run(port_polish, tmp_path, "events", asm, sams, **kwargs)
    assert got == want


def test_kernel_variant_is_checked():
    with pytest.raises(ValueError, match="kernel_variant"):
        port_polish(None, 0.2, 0.5, 10, 5, False,
                    os.path.join(GOLDEN, "tiny.fasta"),
                    [os.path.join(GOLDEN, "tiny.sam")], device="cpu",
                    kernel_variant="packed8")
