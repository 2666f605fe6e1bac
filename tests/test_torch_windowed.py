"""The port's windowed huge-contig paths against polypolish_tpu's.

With POLYPOLISH_TPU_WINDOW_MIN=1 and a small POLYPOLISH_TPU_WINDOW, any
contig streams through position windows.  On the CPU the port's
windowed host twin (backend "host") and device twin (backend "device",
device="cpu": kernels A and B run their plain PyTorch versions) must
give a FASTA and a stderr narrative (clock masked) byte-identical to the
JAX package's windowed host and pallas paths (pallas in interpret mode),
across window sizes, sparse-tier votes that cross window boundaries, a
multi-contig case, the JAX package's window depths 1, 2 and 3 (the
port runs one window after another at every depth) and both values of
POLYPOLISH_TPU_OV_MODE on the JAX side (the port reads no such
variable).  Also:
``fold_window`` equals the JAX package's, a window-origin pack counted
by the plain version of kernel A equals the host fold restricted to the
window, and every pack is closed when a window's count or finish
raises.
"""

import contextlib
import io
import sys

import numpy as np
import pytest
import torch

import tests.synth as synth
from polypolish_tpu.pipeline.polish import polish as jax_polish
from polypolish_tpu_torch.pipeline.polish import polish as port_polish
from tests.torch_helpers import POLISHER_WRAPPERS, mask_clock, parse_both

PORT_OF = {"host": "host", "pallas": "device"}


def _write(tmp_path, fasta, sams, tag):
    asm = tmp_path / f"asm_{tag}.fasta"
    asm.write_text(synth.fasta_text(fasta))
    paths = []
    for i, text in enumerate(sams):
        p = tmp_path / f"aln_{tag}_{i}.sam"
        p.write_text(text)
        paths.append(str(p))
    return str(asm), paths


def _polish(fn, asm, sams, **kwargs):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stderr(err):
        fn(None, 0.2, 0.5, 10, 5, False, asm, sams, out=out, **kwargs)
    return out.getvalue(), mask_clock(err.getvalue())


def _windowed(monkeypatch, window, depth=None):
    monkeypatch.setenv("POLYPOLISH_TPU_WINDOW_MIN", "1")
    monkeypatch.setenv("POLYPOLISH_TPU_WINDOW", str(window))
    if depth is not None:
        monkeypatch.setenv("POLYPOLISH_TPU_WINDOW_DEPTH", str(depth))


def _both(asm, sams, jax_backend):
    """(port, jax) outputs of one windowed run on the same backend."""
    port_backend = PORT_OF[jax_backend]
    kwargs = dict(backend=port_backend)
    if port_backend == "device":
        kwargs["device"] = "cpu"
    return (_polish(port_polish, asm, sams, **kwargs),
            _polish(jax_polish, asm, sams, backend=jax_backend))


def _case(kind):
    if kind == "multi_contig":
        fasta, sam = synth.make_multi_contig_case(
            seed=9, n_contigs=3, genome_len=1200, n_reads=900, read_len=40)
    elif kind == "sparse":
        # heavy error rate: sparse-tier (multi-base insertion) votes
        # crossing window boundaries
        fasta, sam = synth.make_polish_case(
            seed=77, genome_len=3000, n_reads=4000, read_len=50, err=0.15,
            multi_frac=0.5)
    else:
        fasta, sam = synth.make_polish_case(
            seed=42, genome_len=5000, n_reads=3000, read_len=60, err=0.08,
            multi_frac=0.4)
    return fasta, [sam]


@pytest.mark.parametrize("jax_backend", ["host", "pallas"])
@pytest.mark.parametrize("window", [256, 1000, 4096])
def test_window_sizes_match_jax(tmp_path, monkeypatch, window, jax_backend):
    asm, sams = _write(tmp_path, *_case("plain"), "w")
    unwindowed = _polish(port_polish, asm, sams, backend="host")
    _windowed(monkeypatch, window)
    port, jax = _both(asm, sams, jax_backend)
    assert port == jax
    assert port == unwindowed


@pytest.mark.parametrize("jax_backend", ["host", "pallas"])
def test_sparse_votes_across_window_boundaries(tmp_path, monkeypatch,
                                               jax_backend):
    asm, sams = _write(tmp_path, *_case("sparse"), "s")
    from polypolish_tpu_torch.native import runs
    from polypolish_tpu_torch.vocab import Vocab

    pr = runs.parse_runs(sams, ["contig_1"], {"contig_1": 3000}, Vocab(),
                         10, False)
    sp_pos = pr.sparse("contig_1")[0]
    pr.close()
    # sparse positions fall in several 512-wide windows, next to edges
    assert np.unique(sp_pos // 512).size >= 4
    assert (sp_pos % 512 < 40).any() and (sp_pos % 512 > 472).any()
    _windowed(monkeypatch, 512)
    port, jax = _both(asm, sams, jax_backend)
    assert port == jax


@pytest.mark.parametrize("jax_backend", ["host", "pallas"])
def test_multi_contig_matches_jax(tmp_path, monkeypatch, jax_backend):
    asm, sams = _write(tmp_path, *_case("multi_contig"), "m")
    _windowed(monkeypatch, 700)
    port, jax = _both(asm, sams, jax_backend)
    assert port == jax
    assert port[0].count(">") == 3


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_window_depths_match_jax(tmp_path, monkeypatch, depth):
    asm, sams = _write(tmp_path, *_case("plain"), f"d{depth}")
    _windowed(monkeypatch, 777, depth)
    port, jax = _both(asm, sams, "pallas")
    assert port == jax


@pytest.mark.parametrize("ov_mode", ["scatter", "mxu"])
def test_overflow_routes_match_jax(tmp_path, monkeypatch, ov_mode):
    """The device twin against the JAX package's windowed pallas path
    under each POLYPOLISH_TPU_OV_MODE route of its overflow fold, on a
    case whose two 2,048-position windows both hold cap-overflow events:
    the port folds each window's overflow with the overflow kernel into
    the window's counts (the window's width, not the contig's) whatever
    the value, and the output equals the unwindowed host run."""
    from polypolish_tpu_torch.models import polisher

    asm, sams = _write(tmp_path, *_case("sparse"), "v")
    unwindowed = _polish(port_polish, asm, sams, backend="host")
    calls = []
    for name in POLISHER_WRAPPERS:
        def wrap(*args, _fn=getattr(polisher, name), _name=name, **kwargs):
            calls.append((_name, args[0].shape[1]
                          if _name == "overflow_counts" else None))
            return _fn(*args, **kwargs)

        monkeypatch.setattr(polisher, name, wrap)
    monkeypatch.setenv("POLYPOLISH_TPU_OV_MODE", ov_mode)
    _windowed(monkeypatch, 1000)  # the device twin rounds up to 2,048
    port, jax = _both(asm, sams, "pallas")
    assert port == jax
    assert port == unwindowed
    assert [c[0] for c in calls] == ["lanes_counts", "overflow_counts"] * 2
    # each window's overflow goes into that window's counts alone
    for _, width in calls[1::2]:
        assert width == 2048


def test_two_files_and_defaults_leave_small_contigs_unwindowed(
        tmp_path, monkeypatch):
    """At the default POLYPOLISH_TPU_WINDOW_MIN a small contig is not
    windowed (no window fold runs), and with windowing on, two SAM files
    still give the JAX package's output."""
    fasta, s1 = synth.make_polish_case(seed=11, genome_len=5000,
                                       n_reads=1500, read_len=70)
    _, s2 = synth.make_polish_case(seed=11, genome_len=5000, n_reads=1500,
                                   read_len=70, shuffle_groups=True)
    asm, sams = _write(tmp_path, fasta, [s1, s2], "t")
    from polypolish_tpu_torch.native.runs import ParsedRuns

    calls = []
    real = ParsedRuns.fold_window

    def spy(self, *a, **k):
        calls.append(a[1:3])
        return real(self, *a, **k)

    monkeypatch.setattr(ParsedRuns, "fold_window", spy)
    monkeypatch.delenv("POLYPOLISH_TPU_WINDOW_MIN", raising=False)
    default = _polish(port_polish, asm, sams, backend="device", device="cpu")
    assert calls == []
    _windowed(monkeypatch, 2048)
    port, jax = _both(asm, sams, "pallas")
    assert calls == [(0, 2048), (2048, 4096), (4096, 5000)]
    assert port == jax == default


@pytest.mark.parametrize("window", [700, 1024])
def test_fold_window_matches_jax(tmp_path, window):
    asm, sams = _write(tmp_path, *_case("sparse"), f"f{window}")
    (jr, tr), names, lens = parse_both(asm, sams)
    name = names[0]
    thresholds = (5, 0.5, 0.2)
    try:
        full = tr.fold(name, thresholds=thresholds)
        full_counts, full_depth = full[0].copy(), full[1].copy()
        full_thr = [a.copy() for a in full[3]]
        for w_lo in range(0, lens[name], window):
            w_hi = min(lens[name], w_lo + window)
            got = tr.fold_window(name, w_lo, w_hi, thresholds)
            want = jr.fold_window(name, w_lo, w_hi, thresholds)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
            for g, w, f in zip(got[2], want[2], full_thr):
                np.testing.assert_array_equal(g, w)
                np.testing.assert_array_equal(g, f[w_lo:w_hi])
            np.testing.assert_array_equal(got[0], full_counts[:, w_lo:w_hi])
            np.testing.assert_array_equal(got[1], full_depth[w_lo:w_hi])
            no_counts = tr.fold_window(name, w_lo, w_hi, thresholds,
                                       want_counts=False)
            assert no_counts[0] is None
            np.testing.assert_array_equal(no_counts[1], want[1])
    finally:
        jr.close()
        tr.close()


def test_window_origin_pack_counted_by_plain_kernel_a(tmp_path):
    """A packed4 pack from window origin w_lo, counted by the plain
    version of kernel A, equals the host fold restricted to the window
    plus nothing past its end (the pad positions of the last window)."""
    from polypolish_tpu_torch.models.polisher import LanesPolisher
    from polypolish_tpu_torch.ops import vote_lanes

    asm, sams = _write(tmp_path, *_case("plain"), "o")
    (jr, tr), names, lens = parse_both(asm, sams)
    name, P = names[0], lens[names[0]]
    jr.close()
    counts_ref = tr.fold(name)[0].copy()
    W = 2048
    model = LanesPolisher(W, "cpu")
    vote_lanes.lanes_counts.launches.clear()
    try:
        for w_lo in range(0, P, W):
            w_real = min(P, w_lo + W) - w_lo
            pack = tr.lanes(name, model.r_sub, model.tile_w, num_positions=W,
                            packed4=True, cap=True, w_lo=w_lo)
            try:
                counts = model.vote_counts(pack.vb, pack.block_tile,
                                           pack.ov_pos, pack.ov_vid).numpy()
            finally:
                pack.close()
            np.testing.assert_array_equal(
                counts[:, :w_real], counts_ref[:, w_lo:w_lo + w_real],
                err_msg=f"window at {w_lo}")
            assert counts[:, w_real:].sum() == 0
    finally:
        tr.close()
    # the CPU runs the plain versions: no kernel launch is counted
    assert sum(vote_lanes.lanes_counts.launches.values()) == 0


@pytest.mark.parametrize("where", ["finish", "count"])
def test_finish_window_raise_closes_every_pack(tmp_path, monkeypatch, where):
    """If a window's finish (the sparse override) or its counting raises,
    every pack made so far is closed, and no later window is packed."""
    from polypolish_tpu_torch.models.polisher import LanesPolisher
    from polypolish_tpu_torch.native.runs import LanesPack, ParsedRuns

    port_module = sys.modules["polypolish_tpu_torch.pipeline.polish"]
    # four device windows (the device twin pads a window to a multiple
    # of 2048 positions); sparse votes in the first one
    fasta, sam = synth.make_polish_case(
        seed=77, genome_len=7000, n_reads=9000, read_len=50, err=0.15,
        multi_frac=0.5)
    asm, sams = _write(tmp_path, fasta, [sam], "x")
    packs = []
    real_lanes = ParsedRuns.lanes
    real_forward = LanesPolisher.forward_pack

    def spy(self, *a, **k):
        pack = real_lanes(self, *a, **k)
        packs.append(pack)
        return pack

    def boom(*a, **k):
        raise RuntimeError("override failed")

    def count_boom(self, *a, **k):
        if len(packs) == 2:
            raise RuntimeError("count failed")
        return real_forward(self, *a, **k)

    monkeypatch.setattr(ParsedRuns, "lanes", spy)
    if where == "finish":
        monkeypatch.setattr(port_module, "consensus_sparse_override", boom)
    else:
        monkeypatch.setattr(LanesPolisher, "forward_pack", count_boom)
    _windowed(monkeypatch, 2048, depth=2)
    with pytest.raises(RuntimeError, match=("override" if where == "finish"
                                            else "count") + " failed"):
        _polish(port_polish, asm, sams, backend="device", device="cpu")
    # the first window's finish raised, or the second window's count
    assert len(packs) == (1 if where == "finish" else 2)
    assert all(isinstance(p, LanesPack) and p._view is None for p in packs)


def test_no_pack_raises_instead_of_falling_back(tmp_path, monkeypatch):
    from polypolish_tpu_torch.native.runs import ParsedRuns

    asm, sams = _write(tmp_path, *_case("plain"), "n")
    monkeypatch.setattr(ParsedRuns, "lanes", lambda self, *a, **k: None)
    _windowed(monkeypatch, 1000)
    with pytest.raises(RuntimeError, match="returned no pack"):
        _polish(port_polish, asm, sams, backend="device", device="cpu")


def test_windowed_device_keeps_only_sparse_columns(tmp_path, monkeypatch):
    """The device twin queues the (8, n_unique) sparse columns of each
    window, never its (8, w_pad) counts."""
    port_module = sys.modules["polypolish_tpu_torch.pipeline.polish"]
    asm, sams = _write(tmp_path, *_case("sparse"), "c")
    shapes = []
    real = port_module.consensus_sparse_override

    def spy(counts, sp_pos, *a, pregathered=False, **k):
        shapes.append((counts.shape, np.unique(sp_pos).size, pregathered))
        return real(counts, sp_pos, *a, pregathered=pregathered, **k)

    monkeypatch.setattr(port_module, "consensus_sparse_override", spy)
    _windowed(monkeypatch, 512)
    _polish(port_polish, asm, sams, backend="device", device="cpu")
    assert shapes and all(shape == (8, n) and pre
                          for shape, n, pre in shapes)
    shapes.clear()
    _polish(port_polish, asm, sams, backend="host")
    assert shapes and all(shape in ((8, 512), (8, 3000 % 512)) and not pre
                          for shape, _, pre in shapes)


def test_windowed_runs_on_cuda_by_default(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    asm, sams = _write(tmp_path, *_case("plain"), "g")
    _windowed(monkeypatch, 1000)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        _polish(port_polish, asm, sams)
