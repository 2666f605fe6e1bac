"""Port ops/vote_lanes.py against polypolish_tpu/ops/vote_lanes.py.

The packers must be byte-equal, and ``lanes_counts`` (the plain PyTorch
version on the CPU; the CUDA kernel on a GPU) must equal the JAX lanes
kernel (body packed4, Pallas interpret mode) bitwise on the workloads of
test_vote_lanes.py, test_lanes_cap.py and test_lanes_native.py: sparse,
skewed, deep-tile, position-padded and slab-rounded streams.  Tolerance:
none — counts are integers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polypolish_tpu.ops import vote_lanes as jvl
from polypolish_tpu_torch.ops import vote_lanes as tvl
from tests.torch_helpers import (
    LANES_WORKLOADS as WORKLOADS,
    parse_both,
    rand_events,
    write_polish_case,
)


def jax_counts(vb_u8, block_tile, n_tiles, r_sub, tile_w):
    """The JAX packed4 lanes kernel in interpret mode."""
    arr = jvl.to_packed4(vb_u8, r_sub) if vb_u8.dtype == np.uint8 else vb_u8
    return np.asarray(jvl._lanes_jit(
        jnp.asarray(arr), jnp.asarray(block_tile), n_tiles=n_tiles,
        interpret=True, r_sub=r_sub, tile_w=tile_w, body="packed4",
    ))


def port_counts(vb, block_tile, n_tiles, r_sub, tile_w, device="cpu"):
    arr = tvl.to_packed4(vb, r_sub) if vb.dtype == np.uint8 else vb
    out = tvl.lanes_counts(
        torch.from_numpy(np.ascontiguousarray(arr)).to(device),
        torch.from_numpy(np.ascontiguousarray(block_tile)).to(device),
        n_tiles, r_sub, tile_w,
    )
    return out.cpu().numpy()


@pytest.mark.parametrize("cap", [False, True])
@pytest.mark.parametrize("wl", WORKLOADS[2:6])
def test_prepare_lanes_byte_equal(wl, cap):
    n, p, seed, sparse_frac, skew, r_sub, tile_w = wl
    pos, vocab = rand_events(n, p, seed, sparse_frac, skew)
    want = jvl.prepare_lanes(pos, vocab, p, r_sub, tile_w, cap=cap)
    got = tvl.prepare_lanes(pos, vocab, p, r_sub, tile_w, cap=cap)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(tvl.to_packed4(got[0], r_sub),
                                  jvl.to_packed4(want[0], r_sub))


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 100, 4607, 32768, 32769, 70000])
def test_geom_pad_matches(n):
    assert tvl.geom_pad(n) == jvl.geom_pad(n)
    assert (tvl.geom_pad(n, slab=tvl.MAX_BLOCKS_PER_CALL)
            == jvl.geom_pad(n, slab=jvl.MAX_BLOCKS_PER_CALL))


def test_constants_match():
    for name in ("TILE_W", "R_SUB", "PAD_BYTE", "MAX_BLOCKS_PER_CALL",
                 "OVERFLOW_WEIGHT"):
        assert getattr(tvl, name) == getattr(jvl, name), name


@pytest.mark.parametrize("cap", [False, True])
@pytest.mark.parametrize("wl", WORKLOADS)
def test_lanes_counts_match_jax(wl, cap):
    n, p, seed, sparse_frac, skew, r_sub, tile_w = wl
    pos, vocab = rand_events(n, p, seed, sparse_frac, skew)
    packed = tvl.prepare_lanes(pos, vocab, p, r_sub, tile_w, cap=cap)
    vb, bt, n_tiles = packed[:3]
    want = jax_counts(vb, bt, n_tiles, r_sub, tile_w)
    got = port_counts(vb, bt, n_tiles, r_sub, tile_w)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_deep_tile_past_255_rows():
    """One position 5,000 events deep: the tile holds far more than 255
    byte-rows (the kernel's packed-plane flush boundary)."""
    pos = np.concatenate([np.full(5000, 17, dtype=np.int64),
                          np.arange(300, dtype=np.int64)])
    vocab = (np.arange(pos.size) % 8).astype(np.int32)
    vb, bt, n_tiles = tvl.prepare_lanes(pos, vocab, 300)
    assert (bt == 0).sum() * tvl.R_SUB > 255
    want = jax_counts(vb, bt, n_tiles, tvl.R_SUB, tvl.TILE_W)
    got = port_counts(vb, bt, n_tiles, tvl.R_SUB, tvl.TILE_W)
    np.testing.assert_array_equal(got, want)
    assert got[:, 17].sum() == 5001


def test_slab_rounded_stream(monkeypatch):
    """A stream rounded to a multiple of a (tiny) slab: the JAX side
    runs its multi-slab split, the port one launch."""
    monkeypatch.setattr(jvl, "MAX_BLOCKS_PER_CALL", 8)
    monkeypatch.setattr(tvl, "MAX_BLOCKS_PER_CALL", 8)
    pos, vocab = rand_events(20000, 3000, 11, skew=True)
    vb, bt, n_tiles = tvl.prepare_lanes(pos, vocab, 3000, r_sub=8,
                                        tile_w=128)
    assert bt.shape[0] % 8 == 0 and bt.shape[0] > 8
    want = jax_counts(vb, bt, n_tiles, 8, 128)
    got = port_counts(vb, bt, n_tiles, 8, 128)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cap", [False, True])
@pytest.mark.parametrize("r_sub,tile_w", [(8, 128), (32, 256), (32, 2048)])
def test_native_pack_byte_equal_and_counts(tmp_path, r_sub, tile_w, cap):
    """The port's copy of pp_lanes_from_runs gives the JAX package's
    packs byte for byte, and the port's counts equal the JAX kernel's
    (plus the overflow list) and the C++ fold."""
    asm, sam = write_polish_case(tmp_path, seed=31, genome_len=4000,
                                 n_reads=4000)
    (jr, tr), names, lens = parse_both(asm, [sam])
    name = names[0]
    P = lens[name]
    P_pad = 4096
    jp = jr.lanes(name, r_sub, tile_w, num_positions=P_pad, packed4=True,
                  cap=cap)
    tp = tr.lanes(name, r_sub, tile_w, num_positions=P_pad, packed4=True,
                  cap=cap)
    try:
        for a in ("vb", "block_tile", "ov_pos", "ov_vid"):
            np.testing.assert_array_equal(getattr(tp, a), getattr(jp, a))
        assert tp.n_tiles == jp.n_tiles
        want = jax_counts(jp.vb, jp.block_tile, jp.n_tiles, r_sub, tile_w)
        got = port_counts(tp.vb, tp.block_tile, tp.n_tiles, r_sub, tile_w)
        np.testing.assert_array_equal(got, want)
        dense = tp.ov_vid < 8  # sparse-tier overflow entries hold 255
        np.add.at(got, (tp.ov_vid[dense].astype(np.int64),
                        tp.ov_pos[dense].astype(np.int64)), 1)
        np.testing.assert_array_equal(got[:, :P], tr.fold(name)[0])
        assert int(got[:, P:].sum()) == 0
    finally:
        jp.close()
        tp.close()
        jr.close()
        tr.close()


def test_tile_row_start():
    bt = np.array([0, 0, 1, 3, 3, 3], dtype=np.int32)
    np.testing.assert_array_equal(
        tvl.tile_row_start(bt, 5, 8), [0, 16, 24, 24, 48, 48])
    with pytest.raises(ValueError, match="non-decreasing"):
        tvl.tile_row_start(np.array([1, 0], np.int32), 2, 8)
    with pytest.raises(ValueError, match=r"\[0, n_tiles\)"):
        tvl.tile_row_start(np.array([0, 2], np.int32), 2, 8)


def test_lanes_counts_checks_arguments():
    vb = torch.zeros((8, 128), dtype=torch.int32)
    bt = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="rows"):
        tvl.lanes_counts(vb, bt, 1, r_sub=8, tile_w=128)
    with pytest.raises(ValueError, match="int32"):
        tvl.lanes_counts(vb.to(torch.int64), bt, 1, r_sub=32, tile_w=128)
    with pytest.raises(ValueError, match="n_tiles"):
        tvl.lanes_counts(vb, torch.full((1,), 3, dtype=torch.int32), 2,
                         r_sub=32, tile_w=128)
