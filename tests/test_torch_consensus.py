"""Port ops/consensus.py against polypolish_tpu/ops/consensus.py: the
torch ``consensus_dense_core`` equals the JAX core bitwise on seeded
random (8, P) counts — invalid_thr 0, ties between valid rows, pad
positions, zero-count A/C/G/T rows — and the numpy helpers equal
theirs.  Tolerance: none (integer decisions)."""

import numpy as np
import pytest
import torch

from polypolish_tpu.ops import consensus as jc
from polypolish_tpu_torch.ops import consensus as tc


def make_inputs(seed, P, low_max=40, invalid_zero=False, pad=0):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, low_max, size=(8, P)).astype(np.int32)
    counts[:, rng.random(P) < 0.2] = 0          # empty columns
    counts[5:, rng.random(P) < 0.5] = 0         # rows that do not exist
    tie = rng.random(P) < 0.1                   # two equal valid rows
    counts[2, tie] = counts[3, tie]
    depth = counts.sum(axis=0).astype(np.float64) + rng.random(P)
    valid, invalid, low = tc.compute_thresholds(depth, 5, 0.5, 0.2)
    if invalid_zero:
        invalid[:] = 0
    orig = rng.integers(0, 8, size=P).astype(np.int32)
    if pad:  # pad positions as the device path pads them
        valid[-pad:] = np.int32(2**31 - 1)
        invalid[-pad:] = np.int32(2**31 - 1)
        low[-pad:] = True
        orig[-pad:] = 0
        counts[:, -pad:] = 0
    return counts, valid, invalid, low, orig


def jax_core(counts, valid, invalid, low, orig):
    import jax.numpy as jnp

    nid, st = jc.consensus_dense_jax(
        jnp.asarray(counts), jnp.asarray(valid), jnp.asarray(invalid),
        jnp.asarray(low), jnp.asarray(orig),
    )
    return np.asarray(nid), np.asarray(st)


def torch_core(counts, valid, invalid, low, orig, device="cpu"):
    args = [torch.from_numpy(a).to(device)
            for a in (counts, valid, invalid, low, orig)]
    nid, st = tc.consensus_dense_core(*args)
    assert nid.dtype == torch.int32 and st.dtype == torch.int32
    return nid.cpu().numpy(), st.cpu().numpy()


@pytest.mark.parametrize("seed,P,invalid_zero,pad", [
    (0, 1, False, 0),
    (1, 257, False, 0),
    (2, 5000, False, 0),
    (3, 5000, True, 0),
    (4, 4096, False, 1000),
    (5, 3000, True, 17),
])
def test_core_matches_jax(seed, P, invalid_zero, pad):
    inputs = make_inputs(seed, P, invalid_zero=invalid_zero, pad=pad)
    nid, st = torch_core(*inputs)
    want_nid, want_st = jax_core(*inputs)
    np.testing.assert_array_equal(nid, want_nid)
    np.testing.assert_array_equal(st, want_st)
    np.testing.assert_array_equal(
        (nid, st), tc.consensus_dense_numpy(*inputs))


def test_core_covers_every_status():
    inputs = make_inputs(6, 20000, low_max=12)
    _, st = torch_core(*inputs)
    assert set(np.unique(st).tolist()) == set(range(6))


def test_first_valid_row_wins():
    """Two valid rows -> MULTIPLE; the adopted id of a lone valid row is
    that row; A/C/G/T take part at count 0 (invalid_thr 0 makes them
    intermediate)."""
    counts = np.zeros((8, 3), np.int32)
    counts[2, 0] = counts[4, 0] = 10
    counts[6, 1] = 10
    counts[1, 2] = 10
    valid = np.full(3, 6, np.int32)
    invalid = np.array([1, 1, 0], np.int32)
    low = np.zeros(3, bool)
    orig = np.array([1, 1, 3], np.int32)
    nid, st = torch_core(counts, valid, invalid, low, orig)
    np.testing.assert_array_equal(st, [tc.ST_MULTIPLE, tc.ST_CHANGED,
                                       tc.ST_TOO_CLOSE])
    np.testing.assert_array_equal(nid, [1, 6, 3])
    np.testing.assert_array_equal(
        (nid, st), jax_core(counts, valid, invalid, low, orig))


@pytest.mark.parametrize("seed", [0, 1])
def test_compute_thresholds_match(seed):
    rng = np.random.default_rng(seed)
    depth = np.round(rng.random(4000) * 60, 1)
    depth[::7] += 0.5  # banker's-rounding ties
    for got, want in zip(tc.compute_thresholds(depth, 5, 0.5, 0.2),
                         jc.compute_thresholds(depth, 5, 0.5, 0.2)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_constants_match():
    assert tc.STATUS_STRINGS == jc.STATUS_STRINGS
    for name in ("ST_KEPT", "ST_CHANGED", "ST_LOW_DEPTH", "ST_NONE",
                 "ST_MULTIPLE", "ST_TOO_CLOSE"):
        assert getattr(tc, name) == getattr(jc, name)


@pytest.mark.parametrize("pregathered", [False, True])
def test_sparse_override_matches_jax(pregathered):
    counts, valid, invalid, low, orig = make_inputs(7, 3000, low_max=15)
    depth = counts.sum(axis=0).astype(np.float64)
    rng = np.random.default_rng(8)
    sp_pos = np.sort(rng.choice(3000, size=400)).astype(np.int64)
    sp_vid = rng.integers(8, 20, size=400).astype(np.int64)
    sp_cnt = rng.integers(1, 30, size=400).astype(np.int64)
    nid0, st0 = tc.consensus_dense_numpy(counts, valid, invalid, low, orig)
    want_nid, want_st = nid0.copy(), st0.copy()
    jc.consensus_sparse_override(
        counts, sp_pos, sp_vid, sp_cnt, valid, invalid, depth, 5, orig,
        want_nid, want_st,
    )
    cols = counts[:, np.unique(sp_pos)] if pregathered else counts
    nid, st = nid0.copy(), st0.copy()
    tc.consensus_sparse_override(
        cols, sp_pos, sp_vid, sp_cnt, valid, invalid, depth, 5, orig,
        nid, st, pregathered=pregathered,
    )
    np.testing.assert_array_equal(nid, want_nid)
    np.testing.assert_array_equal(st, want_st)
    assert (st != st0).any()


def test_sparse_override_rejects_wrong_block():
    counts = np.zeros((8, 10), np.int32)
    sp = np.array([2, 5], np.int64)
    with pytest.raises(ValueError, match="columns"):
        tc.consensus_sparse_override(
            counts, sp, sp + 8, sp, np.zeros(10, np.int32),
            np.zeros(10, np.int32), np.zeros(10), 5,
            np.zeros(10, np.int32), np.zeros(10, np.int32),
            np.zeros(10, np.int32), pregathered=True,
        )
