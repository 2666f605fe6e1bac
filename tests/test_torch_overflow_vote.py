"""The port's cap-overflow fold against the JAX package's.

``LanesPolisher.vote_counts`` on the CPU (kernel A's plain version,
then ``ops/vote_lanes.py:overflow_counts``, which runs its plain version
``add_overflow_counts`` on CPU tensors) and the plain version on its
own, over kernel A's counts, equal the JAX ``LanesPolisher.vote_counts``
(interpret mode) bitwise under both of its POLYPOLISH_TPU_OV_MODE
routes: ``scatter`` (an XLA scatter-add) and ``mxu`` (the list laid out
as chunks, through the Pallas chunk kernel).  Tolerance: none, the
counts are integers.  Lists: seeded ones from the numpy packer, real
capped packs of tests/golden and of a window with w_lo > 0 from the
native packer, lists with vid >= 8 and pos >= the width (dropped), an
empty list, a list out of order, and one position holding thousands of
events of all eight ids.  Each vote_counts call makes one call to the
overflow wrapper when the list is not empty, and none to the chunk
kernel's.
"""

import os

import numpy as np
import pytest
import torch

from polypolish_tpu.models.polisher import LanesPolisher as JaxPolisher
from polypolish_tpu_torch.models.polisher import LanesPolisher
from polypolish_tpu_torch.ops import vote_lanes as tvl
from tests.torch_helpers import (
    GOLDEN,
    count_polisher_calls,
    parse_both,
    rand_events,
    write_polish_case,
)

OV_MODES = ["scatter", "mxu"]


@pytest.fixture
def wrapper_calls(monkeypatch):
    return count_polisher_calls(monkeypatch)


def both_folds(monkeypatch, calls, vb, bt, p_pad, r_sub, tile_w, ov_pos,
               ov_vid):
    """The port's counts (vote_counts, and kernel A's plain version plus
    add_overflow_counts), held bitwise against the JAX vote_counts under
    each overflow route; returns the port's counts."""
    jm = JaxPolisher(p_pad, r_sub=r_sub, tile_w=tile_w, interpret=True,
                     body="packed4")
    tm = LanesPolisher(p_pad, "cpu", r_sub=r_sub, tile_w=tile_w)
    calls.clear()
    got = tm.vote_counts(vb, bt, ov_pos, ov_vid).numpy()
    want_calls = {"lanes_counts": 1}
    if len(ov_pos):
        want_calls["overflow_counts"] = 1
    assert dict(calls) == want_calls
    assert set(tm.timer.seconds) == ({"upload", "kernel_a", "kernel_b"}
                                     if len(ov_pos) else
                                     {"upload", "kernel_a"})
    lanes = tvl.lanes_counts_plain(torch.from_numpy(vb), torch.from_numpy(bt),
                                   tm.n_tiles, r_sub, tile_w)
    plain = tvl.add_overflow_counts(lanes, ov_pos, ov_vid).numpy()
    np.testing.assert_array_equal(got, plain)
    for mode in OV_MODES:
        monkeypatch.setenv("POLYPOLISH_TPU_OV_MODE", mode)
        want = np.asarray(jm.vote_counts(vb, bt, ov_pos, ov_vid))
        assert want.dtype == got.dtype
        np.testing.assert_array_equal(got, want, err_msg=mode)
    return got


def numpy_pack(n, P, seed, r_sub=8, tile_w=128):
    """A numpy lane pack (packed4) with its sorted overflow list: even
    coverage plus 40 spikes a few hundred events deep, whose excess
    over each tile's row cap goes to the list."""
    pos, vocab = rand_events(n, P, seed, sparse_frac=0.02)
    rng = np.random.default_rng(seed)
    spikes = np.repeat(rng.integers(0, P, 40), rng.integers(100, 600, 40))
    pos = np.concatenate([pos, spikes])
    vocab = np.concatenate([vocab, rng.integers(0, 8, spikes.size)])
    vb, bt, n_tiles, ov_pos, ov_vid = tvl.prepare_lanes(
        pos, vocab, P, r_sub, tile_w, cap=True)
    return tvl.to_packed4(vb, r_sub), bt, n_tiles * tile_w, ov_pos, ov_vid


def sort_list(ov_pos, ov_vid):
    o = np.lexsort((ov_vid, ov_pos))
    return ov_pos[o], ov_vid[o]


def adversarial_list(kind, ov_pos, ov_vid, p_pad, rng):
    """The packer's list changed into one of the cases to hold."""
    if kind == "seeded":
        return ov_pos, ov_vid
    if kind == "dropped":  # vid >= 8 and pos >= the width, kept sorted
        extra_pos = np.concatenate([rng.integers(0, p_pad, 300),
                                    rng.integers(p_pad, 2 * p_pad, 300),
                                    [p_pad, p_pad, 2**31 - 1]])
        extra_vid = np.concatenate([rng.integers(8, 256, 300),
                                    rng.integers(0, 8, 300), [0, 7, 3]])
        return sort_list(np.concatenate([ov_pos, extra_pos]).astype(np.int32),
                         np.concatenate([ov_vid, extra_vid]).astype(np.uint8))
    if kind == "empty":
        return ov_pos[:0], ov_vid[:0]
    if kind == "unsorted":
        o = rng.permutation(ov_pos.size)
        return ov_pos[o], ov_vid[o]
    assert kind == "deep"  # thousands of events of all eight ids at one
    hot = np.full(8 * 2500, p_pad // 3, np.int32)
    hot_vid = np.repeat(np.arange(8, dtype=np.uint8), 2500)
    return sort_list(np.concatenate([ov_pos, hot]),
                     np.concatenate([ov_vid, hot_vid]))


@pytest.mark.parametrize("kind", ["seeded", "dropped", "empty", "unsorted",
                                  "deep"])
@pytest.mark.parametrize("seed", [3, 11])
def test_lists_match_jax(monkeypatch, wrapper_calls, kind, seed):
    vb, bt, p_pad, ov_pos, ov_vid = numpy_pack(40_000, 3000, seed)
    assert ov_pos.size > 1000 and (np.diff(ov_pos) >= 0).all()
    rng = np.random.default_rng(seed)
    ov_pos, ov_vid = adversarial_list(kind, ov_pos, ov_vid, p_pad, rng)
    got = both_folds(monkeypatch, wrapper_calls, vb, bt, p_pad, 8, 128,
                     ov_pos, ov_vid)
    keep = (ov_vid < 8) & (ov_pos < p_pad)
    lanes = tvl.lanes_counts_plain(torch.from_numpy(vb),
                                   torch.from_numpy(bt), p_pad // 128, 8,
                                   128).numpy()
    assert int(got.sum() - lanes.sum()) == int(keep.sum())
    if kind == "deep":
        assert (got[:, p_pad // 3] - lanes[:, p_pad // 3] >= 2500).all()


@pytest.mark.parametrize("case", ["bankers_ties", "third_weights",
                                  "valid_tie"])
def test_golden_capped_packs_match_jax(monkeypatch, wrapper_calls, case):
    """The native capped pack of a golden case at r_sub 8, tile 128 (the
    geometry that gives these small pileups an overflow list): its
    counts equal the JAX fold's and the host fold's."""
    asm = os.path.join(GOLDEN, case + ".fasta")
    sam = os.path.join(GOLDEN, case + ".sam")
    (jr, tr), names, lens = parse_both(asm, [sam])
    name = names[0]
    with jr, tr:
        pack = tr.lanes(name, 8, 128, num_positions=128, packed4=True,
                        cap=True)
        with pack:
            assert (pack.ov_vid < 8).any()
            got = both_folds(monkeypatch, wrapper_calls, pack.vb,
                             pack.block_tile, 128, 8, 128, pack.ov_pos,
                             pack.ov_vid)
        np.testing.assert_array_equal(got[:, :lens[name]], tr.fold(name)[0])


@pytest.mark.parametrize("w_lo", [2048, 4096])
def test_window_pack_matches_jax(tmp_path, monkeypatch, wrapper_calls, w_lo):
    """A window's native capped pack (positions from its origin w_lo):
    the fold equals the JAX fold's and the host fold of the window."""
    asm, sam = write_polish_case(tmp_path, seed=31, genome_len=6000,
                                 n_reads=6000)
    (jr, tr), names, lens = parse_both(asm, [sam])
    name = names[0]
    w_pad, r_sub, tile_w = 2048, 8, 256
    with jr, tr:
        pack = tr.lanes(name, r_sub, tile_w, num_positions=w_pad,
                        packed4=True, cap=True, w_lo=w_lo)
        with pack:
            assert (pack.ov_vid < 8).any()
            assert pack.ov_pos.max() < w_pad
            got = both_folds(monkeypatch, wrapper_calls, pack.vb,
                             pack.block_tile, w_pad, r_sub, tile_w,
                             pack.ov_pos, pack.ov_vid)
        w_hi = min(lens[name], w_lo + w_pad)
        host = tr.fold_window(name, w_lo, w_hi, (5, 0.5, 0.2))[0]
        np.testing.assert_array_equal(got[:, :w_hi - w_lo], host)
        assert not got[:, w_hi - w_lo:].any()


def test_negative_positions_wrap_like_jax_scatter(monkeypatch):
    """A pos in [-width, 0) wraps and one below drops, as the JAX
    package's scatter route (mode='drop') does; its mxu route drops
    every negative pos.  The packers emit none, so this holds the plain
    version and the kernel's contract to the scatter."""
    vb, bt, p_pad, ov_pos, ov_vid = numpy_pack(20_000, 1000, 5)
    ov_pos = np.concatenate([ov_pos, [-1, -1, -p_pad, -p_pad - 1, -2**31]]
                            ).astype(np.int32)
    ov_vid = np.concatenate([ov_vid, [4, 4, 2, 1, 0]]).astype(np.uint8)
    monkeypatch.setenv("POLYPOLISH_TPU_OV_MODE", "scatter")
    jm = JaxPolisher(p_pad, r_sub=8, tile_w=128, interpret=True,
                     body="packed4")
    want = np.asarray(jm.vote_counts(vb, bt, ov_pos, ov_vid))
    got = LanesPolisher(p_pad, "cpu", r_sub=8, tile_w=128).vote_counts(
        vb, bt, ov_pos, ov_vid).numpy()
    np.testing.assert_array_equal(got, want)
    lanes = tvl.lanes_counts_plain(torch.from_numpy(vb),
                                   torch.from_numpy(bt), p_pad // 128, 8,
                                   128).numpy()
    assert got[4, p_pad - 1] - lanes[4, p_pad - 1] >= 2
    assert got[2, 0] - lanes[2, 0] >= 1


def test_wrapper_runs_plain_on_cpu_and_checks_arguments():
    """overflow_counts on CPU tensors adds in place and returns its
    counts (the plain version, no launch counted); it refuses other
    types, lengths, layouts and devices."""
    counts = torch.arange(8 * 64, dtype=torch.int32).view(8, 64)
    pos = torch.tensor([0, 0, 63, 64, 5], dtype=torch.int32)
    vid = torch.tensor([1, 1, 7, 0, 9], dtype=torch.uint8)
    want = counts.clone()
    want[1, 0] += 2
    want[7, 63] += 1
    before = tvl.overflow_counts.launches
    assert tvl.overflow_counts(counts, pos, vid) is counts
    assert torch.equal(counts, want)
    assert tvl.overflow_counts.launches == before
    assert tvl.overflow_counts(counts, pos[:0], vid[:0]) is counts
    assert torch.equal(counts, want)
    with pytest.raises(ValueError, match="int32 and uint8"):
        tvl.overflow_counts(counts, pos.long(), vid)
    with pytest.raises(ValueError, match="int32 and uint8"):
        tvl.overflow_counts(counts, pos, vid[:4])
    with pytest.raises(ValueError, match="contiguous int32"):
        tvl.overflow_counts(counts[:, ::2], pos, vid)
    with pytest.raises(ValueError, match="contiguous int32"):
        tvl.overflow_counts(counts[:4], pos, vid)
    with pytest.raises(ValueError, match="contiguous"):
        tvl.overflow_counts(counts, torch.zeros(10, dtype=torch.int32)[::2],
                            vid)
    with pytest.raises(ValueError, match="unsupported device"):
        tvl.overflow_counts(counts.to("meta"), pos.to("meta"),
                            vid.to("meta"))


def test_dense_counts_lanes_folds_through_the_wrapper(monkeypatch):
    """dense_counts_lanes(cap=True) adds its overflow through
    overflow_counts (the kernel on a card, the plain version here):
    counts equal the uncapped pack's."""
    calls = []
    real = tvl.overflow_counts

    def counted(*args):
        calls.append(args[1].shape[0])
        return real(*args)

    monkeypatch.setattr(tvl, "overflow_counts", counted)
    pos, vocab = rand_events(30_000, 2000, 9, sparse_frac=0.05, skew=True)
    got = tvl.dense_counts_lanes(pos, vocab, 2000, 8, 128, "packed4",
                                 cap=True, device="cpu")
    want = tvl.dense_counts_lanes(pos, vocab, 2000, 8, 128, "packed4",
                                  device="cpu")
    assert len(calls) == 1 and calls[0] > 0
    assert torch.equal(got, want)
