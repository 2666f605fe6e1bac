"""The event-stream path (``polish(use_native=False)``, the pure-Python
reader) of the port against polypolish_tpu's, byte for byte: FASTA,
--debug TSV and stderr with the clock masked, on backends host, device
(device="cpu": the chunk vote kernel's plain version) and xla against
the JAX package's host, pallas (interpret mode on the CPU) and xla;
multi-contig and sparse-tier (vid >= 8) cases; SAM, .sam.gz and BAM
inputs.  Also _polish_device's counts, new_id and status against the
JAX package's on the same events."""

import gzip

import numpy as np
import pytest

import tests.bam_util as bam_util
from polypolish_tpu.pipeline.polish import polish as jax_polish
from polypolish_tpu_torch.pipeline.polish import polish as port_polish
from tests.torch_helpers import run_polish, synth_case

# the port's backend -> the JAX package's
BACKENDS = {"host": "host", "device": "pallas", "xla": "xla"}


def _inputs(tmp_path, sams, form):
    """The case's SAM files as plain SAM, gzipped SAM or BGZF BAM."""
    if form == "sam":
        return sams
    out = []
    for p in sams:
        if form == "gz":
            q = p.with_suffix(".sam.gz")
            q.write_bytes(gzip.compress(p.read_bytes()))
        else:
            q = p.with_suffix(".bam")
            bam_util.write_bam(q, p.read_text())
        out.append(q)
    return out


@pytest.mark.parametrize("backend", sorted(BACKENDS))
@pytest.mark.parametrize("kind,form", [("multi_contig", "sam"),
                                       ("deep", "sam"), ("two_files", "gz"),
                                       ("deep", "bam")])
def test_event_path_matches_jax(tmp_path, kind, form, backend):
    asm, sams = synth_case(tmp_path, kind)
    sams = _inputs(tmp_path, sams, form)
    got = run_polish(port_polish, tmp_path, "port", asm, sams,
                     backend=backend, device="cpu", use_native=False,
                     kernel_variant="lanes")
    want = run_polish(jax_polish, tmp_path, "jax", asm, sams,
                      backend=BACKENDS[backend], use_native=False)
    assert got == want
    if backend == "host":
        # and the native reader of the same files gives the same bytes
        assert got[:2] == run_polish(port_polish, tmp_path, "native", asm,
                                     sams, backend="host")[:2]


@pytest.mark.parametrize("careful", [False, True])
def test_event_path_careful_matches_jax(tmp_path, careful):
    asm, sams = synth_case(tmp_path, "two_files")
    got = run_polish(port_polish, tmp_path, "port", asm, sams, careful,
                     backend="device", device="cpu", use_native=False)
    want = run_polish(jax_polish, tmp_path, "jax", asm, sams, careful,
                      backend="pallas", use_native=False)
    assert got == want


@pytest.mark.parametrize("backend", ["device", "xla"])
def test_polish_device_matches_jax(tmp_path, backend):
    """_polish_device alone on the deep case's events (sparse tier
    included): counts, new_id, status, depth, sparse tier and
    thresholds."""
    import importlib

    from polypolish_tpu.ops import pack as jpack
    from polypolish_tpu.vocab import Vocab as JaxVocab
    from polypolish_tpu_torch.io.fasta import load_fasta
    from polypolish_tpu_torch.utils.profiling import StageTimer

    # the pipeline packages export polish(), which hides the module
    jp = importlib.import_module("polypolish_tpu.pipeline.polish")
    tp = importlib.import_module("polypolish_tpu_torch.pipeline.polish")
    asm, sams = synth_case(tmp_path, "deep")
    (name, _, seq), = load_fasta(asm)
    votes = jpack.new_votes_from_fasta([(name, "", seq)])
    vocab = JaxVocab()
    jpack.process_sam(str(sams[0]), votes, vocab, 10, False)
    pos, vid, weight = votes[name].finalize()
    assert (vid >= 8).any()
    orig_id = jp._orig_ids_for_seq(seq, vocab)
    got = tp._polish_device(pos, vid, weight, len(seq), orig_id,
                            (5, 0.5, 0.2), "cpu", StageTimer(), backend)
    want = jp._polish_device(pos, vid, weight, len(seq), orig_id, 5, 0.5,
                             0.2, BACKENDS[backend])
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1:3], want[1:3]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[3], want[3])
    for g, w in zip(got[4], want[4]):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got[5:], want[5:]):
        np.testing.assert_array_equal(g, w)


def test_phase_timings_and_profile_trace(tmp_path, monkeypatch):
    """utils/profiling: phase() adds up load_assembly, load_alignments
    and polish_sequences (the JAX package's phases), and
    POLYPOLISH_TPU_PROFILE=<dir> writes a torch.profiler trace there."""
    import json
    import os

    from polypolish_tpu_torch.utils import profiling

    asm, sams = synth_case(tmp_path, "multi_contig")
    trace_dir = tmp_path / "trace"
    monkeypatch.setenv("POLYPOLISH_TPU_PROFILE", str(trace_dir))
    monkeypatch.setattr(profiling, "_ENABLED", True)
    profiling.reset_timings()
    err = run_polish(port_polish, tmp_path, "port", asm, sams,
                     backend="xla", device="cpu", use_native=False)[2]
    assert set(profiling.timings()) == {"load_assembly", "load_alignments",
                                       "polish_sequences"}
    assert err.count("[timing] ") == 3 and "[profile] torch trace" in err
    traces = os.listdir(trace_dir)
    assert len(traces) == 1
    with open(trace_dir / traces[0]) as f:
        assert json.load(f)["traceEvents"]
