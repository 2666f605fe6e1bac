"""The port's ``filter`` against polypolish_tpu's.

On the CPU, ``polypolish_tpu_torch.pipeline.filtering.filter_pairs``
(device="cpu") must write output SAMs byte-identical to
``polypolish_tpu.pipeline.filtering.filter_pairs`` on the same inputs,
return the same counts and print the same stderr narrative (clock
masked): through the numpy grid path and, with the grid threshold forced
to 0, through the torch ``pair_screen_step`` against the JAX step; for
``.gz`` outputs (compared decompressed; the JAX package re-streams them
in Python, the port compresses its native re-stream), BAM inputs and
every fatal input check.  ``pair_screen_step`` and ``good_pair_mask`` are also held
bitwise against the JAX package's on random grids.
"""

import contextlib
import gzip
import io
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.synth as synth
from polypolish_tpu.errors import PolypolishError as JaxError
from polypolish_tpu.models.pairscreen import pair_screen_step as jax_step
from polypolish_tpu.ops import pairfilter as jax_pf
from polypolish_tpu.pipeline import filtering as jax_filtering
from polypolish_tpu_torch.errors import PolypolishError
from polypolish_tpu_torch.models.pairscreen import pair_screen_step
from polypolish_tpu_torch.ops import pairfilter
from polypolish_tpu_torch.pipeline import filtering
from tests.bam_util import write_bam
from tests.torch_helpers import mask_clock


def _inputs(tmp_path, sam1, sam2, tag="", bam=False):
    ext = "bam" if bam else "sam"
    in1 = tmp_path / f"in1{tag}.{ext}"
    in2 = tmp_path / f"in2{tag}.{ext}"
    for path, text in ((in1, sam1), (in2, sam2)):
        if bam:
            write_bam(str(path), text)
        else:
            path.write_text(text)
    return str(in1), str(in2)


def _read(path):
    if path.endswith(".gz"):
        with gzip.open(path, "rt") as f:
            return f.read()
    with open(path) as f:
        return f.read()


def _filter(fn, in1, in2, out1, out2, **kwargs):
    """(counts, output texts, masked stderr) of one filter run; the
    output paths are the same for both packages so the narratives
    compare."""
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        counts = fn(in1, in2, out1, out2, **kwargs)
    return counts, (_read(out1), _read(out2)), mask_clock(err.getvalue())


def _both(tmp_path, in1, in2, suffix=".sam", **kwargs):
    out1 = str(tmp_path / f"out1{suffix}")
    out2 = str(tmp_path / f"out2{suffix}")
    port = _filter(filtering.filter_pairs, in1, in2, out1, out2,
                   device="cpu", **kwargs)
    jax = _filter(jax_filtering.filter_pairs, in1, in2, out1, out2,
                  **kwargs)
    return port, jax


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_filter_matches_jax(tmp_path, seed):
    in1, in2 = _inputs(tmp_path, *synth.make_filter_case(seed=seed))
    port, jax = _both(tmp_path, in1, in2)
    assert port == jax
    assert "ZP:Z:fail" in port[1][0] + port[1][1]


def test_explicit_orientation(tmp_path):
    in1, in2 = _inputs(tmp_path, *synth.make_filter_case(seed=3))
    port, jax = _both(tmp_path, in1, in2, orientation="fr")
    assert port == jax
    assert "User-specified correct orientation: fr" in port[2]


def test_nondefault_percentiles(tmp_path):
    in1, in2 = _inputs(tmp_path, *synth.make_filter_case(seed=4))
    port, jax = _both(tmp_path, in1, in2, low=5.0, high=95.0)
    assert port == jax
    assert "(5th percentile)" in port[2] and "(95th percentile)" in port[2]


@pytest.mark.parametrize("seed", [9, 10])
def test_device_grid_step_matches_jax(tmp_path, monkeypatch, seed):
    """Grid threshold 0 on both sides: the port's torch pair_screen_step
    (on the CPU) against the JAX step, and both against the numpy
    path."""
    in1, in2 = _inputs(tmp_path, *synth.make_filter_case(
        seed=seed, n_pairs=200, multi_frac=0.8))
    numpy_run = _both(tmp_path, in1, in2)[0]
    monkeypatch.setattr(filtering, "_DEVICE_GRID_THRESHOLD", 0)
    monkeypatch.setattr(jax_filtering, "_JAX_GRID_THRESHOLD", 0)
    pair_screen_step.launches = 0
    port, jax = _both(tmp_path, in1, in2)
    assert pair_screen_step.launches == 2  # one grid per file
    assert port == jax == numpy_run


def _random_grid(rng, n_align, n_entries, pad):
    """A flat grid over n_align alignments with sorted segment ids,
    some alignments with no entry, ``pad`` trailing pad entries
    (seg_id = n_align) and coordinates near the int32 limit."""
    seg = np.sort(rng.choice(n_align, size=n_entries))
    seg = np.concatenate([seg, np.full(pad, n_align)]).astype(np.int32)
    m = seg.size
    cols = [
        rng.integers(0, 3, m),                        # ref_a
        rng.choice([0, 16, 256, 272], m),             # flags_a
        rng.integers(0, 5000, m),                     # start_a
        None,
        rng.integers(0, 3, m),                        # ref_p
        rng.choice([0, 16, 256, 272], m),             # flags_p
        rng.integers(0, 5000, m),                     # start_p
        None,
    ]
    cols[3] = cols[2] + rng.integers(20, 200, m)
    cols[7] = cols[6] + rng.integers(20, 200, m)
    far = rng.random(m) < 0.05  # large coordinates
    for k in (2, 3, 6, 7):
        cols[k] = np.where(far, cols[k] + (2**31 - 10_000), cols[k])
    return seg, [c.astype(np.int32) for c in cols]


@pytest.mark.parametrize("seed,n_align,n_entries,pad", [
    (0, 1, 0, 0), (1, 5, 3, 2), (2, 50, 400, 0), (3, 200, 3000, 17),
    (4, 1000, 20000, 5),
])
def test_pair_screen_step_matches_jax(seed, n_align, n_entries, pad):
    rng = np.random.default_rng(seed)
    seg, cols = _random_grid(rng, n_align, n_entries, pad)
    no_pair = rng.random(n_align) < 0.1
    unique = rng.random(n_align) < 0.1
    for low, high, orient in ((100, 400, 0), (0, 2**31 - 1, 1),
                              (50, 150, 3)):
        want = np.asarray(jax_step(
            jnp.asarray(seg), *(jnp.asarray(c) for c in cols),
            jnp.int32(low), jnp.int32(high), jnp.int32(orient),
            jnp.asarray(no_pair), jnp.asarray(unique),
            num_alignments=n_align))
        got = pair_screen_step(
            torch.from_numpy(seg), *(torch.from_numpy(c) for c in cols),
            low, high, orient, torch.from_numpy(no_pair),
            torch.from_numpy(unique), num_alignments=n_align)
        assert got.dtype == torch.bool and got.shape == (n_align,)
        np.testing.assert_array_equal(got.numpy(), want)
    # an alignment with no grid entry and no shortcut comes out False
    empty = np.setdiff1d(np.arange(n_align), seg)
    empty = empty[~(no_pair | unique)[empty]]
    assert not got.numpy()[empty].any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_good_pair_mask_matches_jax_and_numpy(seed):
    rng = np.random.default_rng(seed)
    _, cols = _random_grid(rng, 100, 5000, 0)
    for low, high, orient in ((100, 400, 0), (0, 300, 2), (30, 60, 1)):
        want = jax_pf.good_pair_mask_jax(*cols, low, high, orient)
        got = pairfilter.good_pair_mask(
            *(torch.from_numpy(c) for c in cols), low, high, orient)
        np.testing.assert_array_equal(got.numpy(), want)
        # rows far from the int32 limit, where int32 and int64 agree
        near = np.all([c < 2**30 for c in cols], axis=0)
        ref = pairfilter.good_pair_mask_numpy(
            *(c.astype(np.int64) for c in cols), low, high, orient)
        np.testing.assert_array_equal(got.numpy()[near], ref[near])
    with pytest.raises(TypeError, match="int32"):
        pairfilter.good_pair_mask(
            *(torch.from_numpy(c.astype(np.int64)) for c in cols), 0, 1, 0)


def test_pairfilter_helpers_match_jax():
    rng = np.random.default_rng(5)
    sizes = np.sort(rng.integers(0, 1000, 777))
    for p in (0.1, 1.0, 2.0, 3.0, 11.0, 12.0, 13.0, 21.5, 50.0, 99.9):
        assert pairfilter.get_percentile(sizes, p) == \
            jax_pf.get_percentile(sizes, p)
        assert pairfilter.get_percentile_name(p) == \
            jax_pf.get_percentile_name(p)
    assert pairfilter.get_percentile(np.empty(0), 50.0) == 0
    for counts in ([5, 1, 0, 0], [0, 0, 3, 9]):
        assert pairfilter.auto_determine_orientation(counts) == \
            jax_pf.auto_determine_orientation(counts)
    with pytest.raises(PolypolishError, match="could not automatically"):
        pairfilter.auto_determine_orientation([4, 4, 0, 0])
    f1, s1, f2, s2 = (rng.choice([0, 16], 500), rng.integers(0, 900, 500),
                      rng.choice([0, 16], 500), rng.integers(0, 900, 500))
    e1, e2 = s1 + 100, s2 + 100
    np.testing.assert_array_equal(
        pairfilter.orientation_vec(f1, s1, e1, f2, s2, e2),
        jax_pf.orientation_vec(f1, s1, e1, f2, s2, e2))
    for i in range(0, 500, 37):
        args = (int(f1[i]), int(s1[i]), int(e1[i]), int(f2[i]), int(s2[i]),
                int(e2[i]))
        assert pairfilter.orientation_scalar(*args) == \
            jax_pf.orientation_scalar(*args)
        assert pairfilter.insert_size_scalar(*args[1:3], *args[4:]) == \
            jax_pf.insert_size_scalar(*args[1:3], *args[4:])
    mask = rng.random(500) < 0.3
    segs = np.sort(rng.integers(0, 40, 500))
    np.testing.assert_array_equal(pairfilter.segment_any(mask, segs, 41),
                                  jax_pf.segment_any(mask, segs, 41))


def test_gz_output_matches_jax_decompressed(tmp_path):
    in1, in2 = _inputs(tmp_path, *synth.make_filter_case(seed=6))
    before = set(os.listdir(tmp_path))
    port, jax = _both(tmp_path, in1, in2, suffix=".sam.gz")
    assert port == jax
    # the native re-stream's temporary text is gone
    assert set(os.listdir(tmp_path)) - before == {"out1.sam.gz",
                                                  "out2.sam.gz"}
    plain = _both(tmp_path, in1, in2)[0]
    assert port[:2] == plain[:2]


@pytest.mark.parametrize("suffix", [".sam", ".sam.gz"])
def test_bam_input_matches_jax(tmp_path, suffix):
    """BAM inputs through the native quick-parse and the native
    re-stream, to a plain and to a gzip-compressed output."""
    sam1, sam2 = synth.make_filter_case(seed=7, multi_frac=0.5)
    in1, in2 = _inputs(tmp_path, sam1, sam2, bam=True)
    port, jax = _both(tmp_path, in1, in2, suffix=suffix)
    assert port == jax
    s1, s2 = _inputs(tmp_path, sam1, sam2, tag="_sam")
    from_sam = _both(tmp_path, s1, s2, suffix=suffix)[0]
    assert port[:2] == from_sam[:2]


def _fatal(fn, *args, **kwargs):
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        try:
            fn(*args, **kwargs)
        except (PolypolishError, JaxError) as e:
            return str(e), mask_clock(err.getvalue())
    raise AssertionError("no fatal error")


@pytest.mark.parametrize("case,match", [
    ("same_paths", "unique values"),
    ("low", "--low"),
    ("high", "--high"),
    ("bad_orientation", "no read pairs available"),
    ("absent_orientation", "no read pairs available"),
    ("no_alignments", "no alignments found"),
    ("missing_input", "unable to"),
    ("missing_out_dir", "unable to write"),
    ("missing_out_dir_gz", "unable to write"),
])
def test_fatal_errors_match_jax(tmp_path, case, match):
    in1, in2 = _inputs(tmp_path, *synth.make_filter_case(seed=6,
                                                         n_pairs=20))
    out1, out2 = str(tmp_path / "o1.sam"), str(tmp_path / "o2.sam")
    args = [in1, in2, out1, out2]
    kwargs = {}
    if case == "same_paths":
        args[1] = in1
    elif case == "low":
        kwargs["low"] = 60.0
    elif case == "high":
        kwargs["high"] = 40.0
    elif case == "bad_orientation":
        kwargs["orientation"] = "xx"
    elif case == "absent_orientation":
        kwargs["orientation"] = "rr"
    elif case == "no_alignments":
        args[0] = str(tmp_path / "empty.sam")
        with open(args[0], "w") as f:
            f.write("@HD\tVN:1.6\n")
    elif case.startswith("missing_out_dir"):
        suffix = ".sam.gz" if case.endswith("gz") else ".sam"
        args[2] = str(tmp_path / "absent" / f"o1{suffix}")
    else:
        args[0] = str(tmp_path / "nope.sam")
    got = _fatal(filtering.filter_pairs, *args, device="cpu", **kwargs)
    want = _fatal(jax_filtering.filter_pairs, *args, **kwargs)
    assert got == want
    assert match in got[0]


def test_filter_runs_on_cuda_by_default(tmp_path, monkeypatch):
    import inspect

    from polypolish_tpu_torch.pipeline.full import polish_paired

    for fn in (filtering.filter_pairs, polish_paired):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    in1, in2 = _inputs(tmp_path, *synth.make_filter_case(seed=6,
                                                         n_pairs=20))
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        filtering.filter_pairs(in1, in2, str(tmp_path / "o1"),
                               str(tmp_path / "o2"))

