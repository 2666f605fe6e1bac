"""The lanes vote kernel's other row layouts against
polypolish_tpu/ops/vote_lanes.py's bodies.

``lanes_counts(body=...)`` (the plain PyTorch version on the CPU; the
CUDA kernel's entry points on a GPU) must equal the JAX lanes kernel
with the same body (``_lanes_jit(body=..., interpret=True)``) bitwise:
byte rows for bodies packed and cmp, nibble rows for packed8.  Also
``to_packed8`` byte-equal, ``dense_counts_lanes`` for every body with
and without the row cap, and tiles deeper than 255 byte-rows.
Tolerance: none — counts are integers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polypolish_tpu.ops import vote_lanes as jvl
from polypolish_tpu_torch.ops import vote_lanes as tvl
from tests.torch_helpers import LANES_WORKLOADS as WORKLOADS
from tests.torch_helpers import rand_events

BODIES = ["packed", "cmp", "packed8"]


def layouts(vb_u8, r_sub, body):
    """(JAX array, port array) of one body's layout from byte rows."""
    if body == "packed8":
        return jvl.to_packed8(vb_u8, r_sub), tvl.to_packed8(vb_u8, r_sub)
    if body == "packed4":
        return jvl.to_packed4(vb_u8, r_sub), tvl.to_packed4(vb_u8, r_sub)
    return vb_u8.view(np.int8), vb_u8


def both(vb_u8, bt, n_tiles, r_sub, tile_w, body):
    jarr, tarr = layouts(vb_u8, r_sub, body)
    want = np.asarray(jvl._lanes_jit(
        jnp.asarray(jarr), jnp.asarray(bt), n_tiles=n_tiles,
        interpret=True, r_sub=r_sub, tile_w=tile_w, body=body,
    ))
    got = tvl.lanes_counts(torch.from_numpy(tarr), torch.from_numpy(bt),
                           n_tiles, r_sub, tile_w, body).numpy()
    assert got.dtype == np.int32
    return got, want


@pytest.mark.parametrize("body", BODIES)
@pytest.mark.parametrize("wl", WORKLOADS)
def test_lanes_counts_bodies_match_jax(wl, body):
    n, p, seed, sparse_frac, skew, r_sub, tile_w = wl
    pos, vocab = rand_events(n, p, seed, sparse_frac, skew)
    vb, bt, n_tiles = tvl.prepare_lanes(pos, vocab, p, r_sub, tile_w)
    got, want = both(vb, bt, n_tiles, r_sub, tile_w, body)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cap", [False, True])
@pytest.mark.parametrize("body", ["packed4"] + BODIES)
def test_dense_counts_lanes_match_jax(body, cap):
    P = 3000
    pos, vocab = rand_events(80_000, P, 5, sparse_frac=0.05, skew=True)
    want = np.asarray(jvl.dense_counts_lanes(
        pos, vocab, P, interpret=True, r_sub=8, tile_w=128, body=body,
        cap=cap))
    got = tvl.dense_counts_lanes(pos, vocab, P, r_sub=8, tile_w=128,
                                 body=body, cap=cap, device="cpu")
    assert tuple(got.shape) == (8, P)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("wl", WORKLOADS[2:6])
def test_to_packed8_byte_equal(wl):
    n, p, seed, sparse_frac, skew, r_sub, tile_w = wl
    pos, vocab = rand_events(n, p, seed, sparse_frac, skew)
    vb = tvl.prepare_lanes(pos, vocab, p, r_sub, tile_w)[0]
    got, want = tvl.to_packed8(vb, r_sub), jvl.to_packed8(vb, r_sub)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("body", BODIES)
def test_deep_tile_past_255_rows(body):
    """One position 5,000 events deep: far more than 255 byte-rows and
    31 nibble-packed rows in one tile (the kernel's flush periods)."""
    pos = np.concatenate([np.full(5000, 17, dtype=np.int64),
                          np.arange(300, dtype=np.int64)])
    vocab = (np.arange(pos.size) % 8).astype(np.int32)
    vb, bt, n_tiles = tvl.prepare_lanes(pos, vocab, 300)
    assert (bt == 0).sum() * tvl.R_SUB > 255
    got, want = both(vb, bt, n_tiles, tvl.R_SUB, tvl.TILE_W, body)
    np.testing.assert_array_equal(got, want)
    assert got[:, 17].sum() == 5001


@pytest.mark.parametrize("body,r_sub,rows", [
    ("packed4", 32, 8), ("packed", 32, 32), ("cmp", 6, 6),
    ("packed8", 32, 4), ("packed8", 8, 1)])
def test_rows_per_block_matches(body, r_sub, rows):
    assert tvl._rows_per_block(r_sub, body) == rows
    assert jvl._rows_per_block(r_sub, body) == rows


def test_bodies_check_arguments():
    bt = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown lanes body"):
        tvl.lanes_counts(torch.zeros((32, 128), dtype=torch.uint8), bt, 1,
                         32, 128, body="nibbles")
    with pytest.raises(ValueError, match="r_sub % 8"):
        tvl.lanes_counts(torch.zeros((1, 128), dtype=torch.int32), bt, 1,
                         12, 128, body="packed8")
    with pytest.raises(ValueError, match="uint8"):
        tvl.lanes_counts(torch.zeros((32, 128), dtype=torch.int32), bt, 1,
                         32, 128, body="cmp")
    with pytest.raises(ValueError, match="rows"):
        tvl.lanes_counts(torch.zeros((32, 128), dtype=torch.int32), bt, 1,
                         32, 128, body="packed8")
    with pytest.raises(ValueError, match="multiples of 8"):
        tvl.to_packed8(np.zeros((12, 128), np.uint8), 12)


def test_add_overflow_counts_drops_like_jax():
    """Overflow entries with vid >= 8 or pos past the counts drop, as
    with JAX's mode='drop'."""
    counts = np.arange(8 * 256, dtype=np.int32).reshape(8, 256)
    ov_pos = np.array([0, 5, 5, 255, 256, 300, 7], np.int32)
    ov_vid = np.array([1, 7, 7, 0, 2, 3, 255], np.uint8)
    want = np.asarray(jvl.add_overflow_counts(jnp.asarray(counts), ov_pos,
                                              ov_vid))
    got = tvl.add_overflow_counts(torch.from_numpy(counts.copy()), ov_pos,
                                  ov_vid).numpy()
    np.testing.assert_array_equal(got, want)
