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
from tests.lanes_split import emulate_split, kernel_seg_rows, lane_segments
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


# -- the kernel's work split (csrc/lanes_vote.cu, packed4 and bytes) ----
# These tests hold the plain model of the split (tests/lanes_split.py),
# not the kernel, which makes the split on the card: test_torch_cuda.py
# holds the kernel itself to lanes_counts_plain across the split.

def _split_pack(kind):
    """(byte rows uint8, block_tile, n_tiles, r_sub, tile_w) of a pack
    whose rows exercise the split: short tiles only, one deep tile, tiles
    with no rows, and a slab-rounded stream with its pad on the last
    tile."""
    rng = np.random.default_rng(5)
    if kind == "flat":
        pos, vocab = rand_events(6000, 2000, 3, 0.1)
        return (*tvl.prepare_lanes(pos, vocab, 2000, 8, 128), 8, 128)
    if kind == "deep tile":
        pos = np.concatenate([np.full(5000, 17, dtype=np.int64),
                              np.arange(300, dtype=np.int64)])
        vocab = (np.arange(pos.size) % 8).astype(np.int32)
        return (*tvl.prepare_lanes(pos, vocab, 300, 32, 128), 32, 128)
    if kind == "empty tiles":
        per_tile = rng.integers(0, 40, 60)
        per_tile[::3] = 0
        per_tile[-1] = 0
        n_tiles, r_sub = per_tile.size, 8
    else:  # "slab pad": 33 real blocks rounded to two slabs of 32
        per_tile = rng.integers(1, 3, 13)
        per_tile[-1] += 33 - per_tile.sum()
        n_tiles, r_sub = per_tile.size, 8
    bt = np.repeat(np.arange(n_tiles, dtype=np.int32), per_tile)
    vb = rng.integers(0, 12, (bt.size * r_sub, 128), dtype=np.uint8)
    if kind == "slab pad":
        n_blocks = tvl.geom_pad(bt.size, slab=32)
        assert n_blocks == 64
        bt = np.concatenate([bt, np.full(n_blocks - bt.size, n_tiles - 1,
                                         np.int32)])
        vb = np.concatenate([vb, np.full(((n_blocks - 33) * r_sub, 128),
                                         tvl.PAD_BYTE, np.uint8)])
    return vb, bt, n_tiles, r_sub, 128


SPLIT_PACKS = ["flat", "deep tile", "empty tiles", "slab pad"]
SPLIT_SEG_ROWS = [1, 2, 5, 32, 64, 128, 255]


def _layout(vb_u8, r_sub, body):
    return tvl.to_packed4(vb_u8, r_sub) if body == "packed4" else vb_u8


@pytest.mark.parametrize("seg_rows", SPLIT_SEG_ROWS)
@pytest.mark.parametrize("body", ["packed4", "packed"])
@pytest.mark.parametrize("kind", SPLIT_PACKS)
def test_lane_segments_cover_every_row_once(kind, body, seg_rows):
    vb, bt, n_tiles, r_sub, _ = _split_pack(kind)
    rpb = tvl._rows_per_block(r_sub, body)
    starts = tvl.tile_row_start(bt, n_tiles, rpb)
    seg = lane_segments(starts, seg_rows)
    assert seg.dtype == np.int64 and seg.shape[1] == 3
    tile, b, e = seg.T
    # one first segment per tile, empty tiles included, in tile order
    np.testing.assert_array_equal(tile[:n_tiles], np.arange(n_tiles))
    np.testing.assert_array_equal(b[:n_tiles], starts[:-1])
    # deep segments are non-empty, in row order
    assert np.all(e[n_tiles:] > b[n_tiles:])
    assert np.all(np.diff(b[n_tiles:]) > 0)
    assert np.all(e - b <= seg_rows) and np.all(e >= b)
    # every row of every tile lies in exactly one segment of its tile
    owner = np.full(int(starts[-1]), -1, np.int64)
    for t, lo, hi in seg:
        assert np.all(owner[lo:hi] == -1)
        owner[lo:hi] = t
    row_tile = np.repeat(np.arange(n_tiles), np.diff(starts))
    np.testing.assert_array_equal(owner, row_tile)
    if kind in ("deep tile", "slab pad") and seg_rows < 64:
        assert seg.shape[0] > n_tiles  # the split has deep segments


@pytest.mark.parametrize("seg_rows", SPLIT_SEG_ROWS)
@pytest.mark.parametrize("body", ["packed4", "packed"])
@pytest.mark.parametrize("kind", SPLIT_PACKS)
def test_split_emulation_equals_plain(kind, body, seg_rows):
    vb_u8, bt, n_tiles, r_sub, tile_w = _split_pack(kind)
    vb = torch.from_numpy(_layout(vb_u8, r_sub, body))
    starts = tvl.tile_row_start(bt, n_tiles, tvl._rows_per_block(r_sub,
                                                                 body))
    got = emulate_split(vb, starts, n_tiles, tile_w, body, seg_rows)
    want = tvl.lanes_counts_plain(vb, torch.from_numpy(bt), n_tiles, r_sub,
                                  tile_w, body)
    assert torch.equal(got, want)


@pytest.mark.parametrize("kind", ["deep tile", "slab pad"])
def test_split_emulation_equals_jax(kind):
    """The emulated split of the kernel's own segment length against the
    JAX packed4 kernel (interpret mode)."""
    vb_u8, bt, n_tiles, r_sub, tile_w = _split_pack(kind)
    p4 = tvl.to_packed4(vb_u8, r_sub)
    starts = tvl.tile_row_start(bt, n_tiles, r_sub // 4)
    got = emulate_split(torch.from_numpy(p4), starts, n_tiles, tile_w,
                        "packed4", kernel_seg_rows("packed4"))
    want = np.asarray(jvl._lanes_call(jnp.asarray(p4), jnp.asarray(bt),
                                      n_tiles, True, r_sub, tile_w,
                                      "packed4"))
    np.testing.assert_array_equal(got.numpy(), want)


def test_seg_rows_match_the_kernel_source():
    """The kernel's segment length per layout, read from its source, is
    at most the 255 rows a byte field holds, and the two byte bodies
    share one decoder."""
    seg = {body: kernel_seg_rows(body) for body in ("packed4", "packed",
                                                     "cmp")}
    assert seg["cmp"] == seg["packed"]
    assert all(0 < n <= 255 for n in seg.values())
    # the split's model at the kernel's own lengths is among the cases
    assert {seg["packed4"], seg["packed"]} <= set(SPLIT_SEG_ROWS)
