"""The port's (data, pos) grid (parallel/mesh.py, parallel/shard.py)
against polypolish_tpu.parallel on the CPU: JAX runs on the 8 virtual
devices of tests/conftest.py, the port on grids of "cpu" cells (kernel
A's plain version per cell).  Tolerance 0: routed arrays equal, counts,
new ids and statuses bitwise equal, and equal to the single-device host
fold and consensus."""

import jax
import numpy as np
import pytest

from polypolish_tpu import parallel as jax_parallel
from polypolish_tpu.ops.consensus import (
    compute_thresholds,
    consensus_dense_numpy,
)
from polypolish_tpu.ops.vote import dense_counts_host, depth_host
from polypolish_tpu_torch.parallel import mesh as port_mesh
from polypolish_tpu_torch.parallel import shard as port_shard

DENSE_V = 8
GRIDS = [(1, 1), (8, 1), (1, 8), (2, 4), (4, 2)]


def _case(seed, n_events=20000, num_positions=3000):
    rng = np.random.default_rng(seed)
    pos = rng.integers(0, num_positions, size=n_events).astype(np.int64)
    vocab = rng.integers(0, 10, size=n_events).astype(np.int32)
    weight = rng.choice([1.0, 0.5, 1 / 3], size=n_events)
    orig_id = rng.integers(1, 5, size=num_positions).astype(np.int32)
    return pos, vocab, weight, orig_id


def _thresholds(pos, weight, num_positions):
    depth = depth_host(pos, weight, num_positions)
    return compute_thresholds(depth, 5, 0.5, 0.2)


def _meshes(n_data, n_pos):
    n = n_data * n_pos
    return (jax_parallel.make_mesh(n_data, n_pos, devices=jax.devices()[:n]),
            port_mesh.make_mesh(n_data, n_pos, devices=["cpu"] * n))


@pytest.mark.parametrize("n,prefer_pos", [(1, None), (2, None), (3, None),
                                          (4, None), (6, None), (8, None),
                                          (8, 8), (8, 2), (8, 3), (5, 5)])
def test_mesh_shape_for_matches_jax(n, prefer_pos):
    try:
        want = jax_parallel.mesh_shape_for(n, prefer_pos=prefer_pos)
    except ValueError as e:
        with pytest.raises(ValueError, match="does not divide") as got:
            port_mesh.mesh_shape_for(n, prefer_pos=prefer_pos)
        assert str(got.value) == str(e)
        return
    assert port_mesh.mesh_shape_for(n, prefer_pos=prefer_pos) == want


def test_make_mesh_grid():
    m = port_mesh.make_mesh(devices=["cpu"] * 8)
    assert m.shape == (2, 4) and m.axis_names == ("data", "pos")
    assert all(str(d) == "cpu" for d in m.devices.reshape(-1))
    assert port_mesh.make_mesh(n_pos=8, devices=["cpu"] * 8).shape == (1, 8)
    with pytest.raises(ValueError, match="mesh 3x3 != 8 devices"):
        port_mesh.make_mesh(3, 3, devices=["cpu"] * 8)


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("seed", [0, 1])
def test_bucket_events_matches_jax(grid, seed):
    pos, vocab, _, _ = _case(seed)
    got = port_shard.bucket_events_for_mesh(pos, vocab, 3000, *grid)
    want = jax_parallel.bucket_events_for_mesh(pos, vocab, 3000, *grid)
    assert got[2] == want[2]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    n_dense = int((vocab < DENSE_V).sum())
    assert int((got[0] < got[2]).sum()) == n_dense


@pytest.mark.parametrize("body,r_sub,tile_w", [("packed4", None, None),
                                               ("packed", 8, 128),
                                               ("packed4", 8, 256)])
@pytest.mark.parametrize("grid", [(1, 1), (2, 4), (4, 2), (1, 8)])
def test_bucket_lanes_matches_jax(grid, body, r_sub, tile_w):
    pos, vocab, _, _ = _case(3, n_events=30000, num_positions=5000)
    kw = dict(r_sub=r_sub, tile_w=tile_w, body=body)
    got = port_shard.bucket_lanes_for_mesh(pos, vocab, 5000, *grid, **kw)
    want = jax_parallel.bucket_lanes_for_mesh(pos, vocab, 5000, *grid, **kw)
    assert got[2:] == want[2:]
    assert got[0].dtype == want[0].dtype
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("seed", [0, 1])
def test_sharded_vote_consensus_matches_jax(grid, seed):
    num_positions = 3000
    pos, vocab, weight, orig_id = _case(seed, num_positions=num_positions)
    thr = _thresholds(pos, weight, num_positions)
    jax_mesh, mesh = _meshes(*grid)
    got = port_shard.sharded_vote_consensus(mesh, pos, vocab, num_positions,
                                            *thr, orig_id)
    want = jax_parallel.sharded_vote_consensus(jax_mesh, pos, vocab,
                                               num_positions, *thr, orig_id)
    counts_ref = dense_counts_host(pos, vocab, num_positions)
    ref = (counts_ref,) + consensus_dense_numpy(counts_ref, *thr, orig_id)
    for g, w, r in zip(got, want, ref):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("seed", [0, 1])
def test_sharded_vote_consensus_lanes_matches_jax(grid, seed):
    rng = np.random.default_rng(23 + seed)
    P, n_ev = 5000, 60_000
    pos = rng.integers(0, P, n_ev).astype(np.int64)
    vocab = rng.integers(0, DENSE_V + 3, n_ev).astype(np.int32)
    thr = _thresholds(pos, np.ones(n_ev), P)
    orig_id = rng.integers(1, 5, P).astype(np.int32)
    jax_mesh, mesh = _meshes(*grid)
    got = port_shard.sharded_vote_consensus_lanes(mesh, pos, vocab, P,
                                                  *thr, orig_id)
    want = jax_parallel.sharded_vote_consensus_lanes(jax_mesh, pos, vocab,
                                                     P, *thr, orig_id)
    for g, w in zip(got, want):
        assert g.dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0], dense_counts_host(pos, vocab, P))


def test_lanes_step_calls_kernel_a_once_per_cell(monkeypatch):
    """One lanes_counts call per grid cell, on that cell's share of the
    mesh pack, whatever the grid."""
    calls = []
    real = port_shard.lanes_counts

    def counted(vb, bt, *args):
        calls.append((tuple(vb.shape), tuple(bt.shape)))
        return real(vb, bt, *args)

    monkeypatch.setattr(port_shard, "lanes_counts", counted)
    pos, vocab, weight, orig_id = _case(2, num_positions=5000)
    thr = _thresholds(pos, weight, 5000)
    for grid in GRIDS:
        calls.clear()
        mesh = port_mesh.make_mesh(*grid, devices=["cpu"] * (grid[0] *
                                                             grid[1]))
        port_shard.sharded_vote_consensus_lanes(mesh, pos, vocab, 5000,
                                                *thr, orig_id)
        assert len(calls) == grid[0] * grid[1]
        assert len(set(calls)) == 1  # one padded block count per grid


@pytest.mark.parametrize("lanes", [False, True])
def test_sharded_empty_events(lanes):
    mesh = port_mesh.make_mesh(2, 4, devices=["cpu"] * 8)
    num_positions = 100
    pos = np.empty(0, dtype=np.int64)
    vocab = np.empty(0, dtype=np.int32)
    valid_thr = np.full(num_positions, 5, dtype=np.int32)
    invalid_thr = np.full(num_positions, 1, dtype=np.int32)
    low_depth = np.ones(num_positions, dtype=bool)
    orig_id = np.full(num_positions, 1, dtype=np.int32)
    step = (port_shard.sharded_vote_consensus_lanes if lanes
            else port_shard.sharded_vote_consensus)
    counts, new_id, status = step(mesh, pos, vocab, num_positions,
                                  valid_thr, invalid_thr, low_depth, orig_id)
    assert counts.shape == (DENSE_V, num_positions) and counts.sum() == 0
    np.testing.assert_array_equal(new_id, orig_id)
    want = jax_parallel.sharded_vote_consensus(
        _meshes(2, 4)[0], pos, vocab, num_positions, valid_thr, invalid_thr,
        low_depth, orig_id)
    np.testing.assert_array_equal(status, want[2])


def test_numpy_mesh_packer_uint8_branch():
    """The numpy mesh packer's byte-row layout (body packed) through
    sharded_step_lanes gives the host fold's counts."""
    rng = np.random.default_rng(5)
    P = 3000
    pos = rng.integers(0, P, 40_000).astype(np.int64)
    vocab = rng.integers(0, DENSE_V, 40_000).astype(np.int32)
    vb, bt, p_shard, n_tiles = port_shard.bucket_lanes_for_mesh(
        pos, vocab, P, 2, 4, r_sub=8, tile_w=128, body="packed")
    assert vb.dtype == np.uint8
    mesh = port_mesh.make_mesh(2, 4, devices=["cpu"] * 8)
    empty = np.empty(0)
    counts, _, status = port_shard.sharded_step_lanes(
        mesh, vb, bt, p_shard, n_tiles, empty.astype(np.int32),
        empty.astype(np.int32), empty.astype(bool), empty.astype(np.int32),
        r_sub=8, tile_w=128, body="packed")
    np.testing.assert_array_equal(counts[:, :P].numpy(),
                                  dense_counts_host(pos, vocab, P))
    from polypolish_tpu_torch.ops.consensus import ST_LOW_DEPTH

    assert (status == ST_LOW_DEPTH).all()  # every position a pad


def test_lanes_step_rejects_a_pack_of_another_grid():
    vb, bt, p_shard, n_tiles = port_shard.bucket_lanes_for_mesh(
        np.zeros(1, np.int64), np.zeros(1, np.int32), 100, 2, 2)
    mesh = port_mesh.make_mesh(1, 4, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="does not match"):
        port_shard.sharded_step_lanes(mesh, vb, bt, p_shard, n_tiles,
                                      *([np.zeros(0)] * 4))
