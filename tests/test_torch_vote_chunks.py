"""Port ops/vote_chunks.py against polypolish_tpu/ops/vote_pallas.py.

``prepare_chunks`` must be byte-equal (numpy and native), and
``chunk_counts`` (plain PyTorch on the CPU; the CUDA kernel on a GPU)
must equal the JAX split kernel (``_vote_pallas_call(...,
fused="split")``, Pallas interpret mode) bitwise, in both pad layouts:
int32 with pos -1 and uint8 with vocab 255.  Tolerance: none.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polypolish_tpu.ops import vote_pallas as jvp
from polypolish_tpu_torch.ops import vote_chunks as tvc
from tests.torch_helpers import (
    parse_both,
    rand_events,
    write_polish_case,
)


def jax_counts(cp, cv, ct, n_tiles):
    """The JAX split kernel in interpret mode (uint8 chunks widened to
    int32 on the way in, as PolisherModel.forward does)."""
    return np.asarray(jvp._vote_pallas_call(
        jnp.asarray(cp.astype(np.int32)), jnp.asarray(cv.astype(np.int32)),
        jnp.asarray(ct), n_tiles=n_tiles, interpret=True, fused="split",
    ))


def port_counts(cp, cv, ct, n_tiles, device="cpu"):
    return tvc.chunk_counts(
        torch.from_numpy(cp).to(device), torch.from_numpy(cv).to(device),
        torch.from_numpy(ct).to(device), n_tiles,
    ).cpu().numpy()


CASES = [
    # (seed, n events, positions, sparse_frac) — test_pallas.py shapes
    (0, 5000, 700, 0.3),
    (1, 20000, 2048, 0.3),
    (2, 100, 3000, 0.3),    # sparse coverage: many empty tiles
    (3, 0, 600, 0.0),       # no events at all
    (4, 4096, 512, 0.0),    # exactly one tile
]


@pytest.mark.parametrize("use_native", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_prepare_chunks_byte_equal(case, use_native):
    seed, n, p, sparse_frac = case
    pos, vocab = rand_events(n, p, seed, sparse_frac)
    want = jvp.prepare_chunks(pos, vocab, p, use_native=use_native)
    got = tvc.prepare_chunks(pos, vocab, p, use_native=use_native)
    assert got[3] == want[3]
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_constants_match():
    for name in ("TILE_P", "E_SUB", "E_LANE", "E_B", "MAX_CHUNKS_PER_CALL"):
        assert getattr(tvc, name) == getattr(jvp, name), name


@pytest.mark.parametrize("case", CASES)
def test_chunk_counts_int32_match_jax(case):
    seed, n, p, sparse_frac = case
    pos, vocab = rand_events(n, p, seed, sparse_frac)
    cp, cv, ct, n_tiles = tvc.prepare_chunks(pos, vocab, p)
    assert cp.dtype == np.int32
    got = port_counts(cp, cv, ct, n_tiles)
    np.testing.assert_array_equal(got, jax_counts(cp, cv, ct, n_tiles))


def test_chunk_counts_slab_rounded(monkeypatch):
    """A chunk stream rounded to a (tiny) slab multiple: the JAX side
    runs its slab split, the port one launch."""
    monkeypatch.setattr(jvp, "MAX_CHUNKS_PER_CALL", 16)
    monkeypatch.setattr(tvc, "MAX_CHUNKS_PER_CALL", 16)
    pos, vocab = rand_events(60_000, 6000, 21)
    cp, cv, ct, n_tiles = tvc.prepare_chunks(pos, vocab, 6000,
                                             use_native=False)
    assert ct.shape[0] % 16 == 0 and ct.shape[0] > 16
    got = port_counts(cp, cv, ct, n_tiles)
    np.testing.assert_array_equal(got, jax_counts(cp, cv, ct, n_tiles))


@pytest.mark.parametrize("seed", [5, 9])
def test_chunk_counts_uint8_layout_match_jax(tmp_path, seed):
    """The uint8 layout (pad vocab 255) of the port's native
    pp_chunks_from_runs: byte-equal to the JAX package's, counts equal
    to its kernel and to the C++ fold."""
    asm, sam = write_polish_case(tmp_path, seed=seed)
    (jr, tr), names, lens = parse_both(asm, [sam])
    try:
        name = names[0]
        P = lens[name]
        want_ch = jr.chunks(name, tvc.TILE_P, tvc.E_SUB)
        cp, cv, ct, n_tiles = tr.chunks(name, tvc.TILE_P, tvc.E_SUB)
        for g, w in zip((cp, cv, ct, n_tiles), want_ch):
            np.testing.assert_array_equal(g, w)
        assert cp.dtype == np.uint8 and (cv == 255).any()
        got = port_counts(cp, cv, ct, n_tiles)
        np.testing.assert_array_equal(got, jax_counts(cp, cv, ct, n_tiles))
        np.testing.assert_array_equal(got[:, :P], tr.fold(name)[0])
    finally:
        jr.close()
        tr.close()


def test_chunk_counts_drop_rules():
    """vocab >= 8, pos outside [0, 256) and tiles outside [0, n_tiles)
    count nothing."""
    cp = np.full((8, 128), -1, np.int32)
    cv = np.zeros((8, 128), np.int32)
    cp[0, :4] = [0, 5, 255, 300]
    cv[0, :4] = [1, 9, 7, 2]
    got = port_counts(cp, cv, np.array([0], np.int32), 1)
    want = np.zeros((8, 256), np.int32)
    want[1, 0] = 1
    want[7, 255] = 1
    np.testing.assert_array_equal(got, want)
    got = port_counts(cp, cv, np.array([3], np.int32), 2)
    assert got.sum() == 0


def test_chunk_counts_checks_arguments():
    cp = torch.zeros((8, 128), dtype=torch.int32)
    ct = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="both"):
        tvc.chunk_counts(cp, cp.to(torch.uint8), ct, 1)
    with pytest.raises(ValueError, match="chunk arrays"):
        tvc.chunk_counts(cp[:4], cp[:4], ct, 1)


def _tile_prefix_case(seed, tile_p):
    """Seeded chunks over 3,000 positions with a hot spot (a tile many
    chunks deep) and a gap of tiles with no events: (cp, cv, ct,
    n_tiles) as prepare_chunks packs them (every tile at least one
    chunk), and the same stream with the gap tiles' pad chunks taken
    out (tiles with no chunk) and stray chunks of tiles below 0 and past
    the last added at its ends."""
    rng = np.random.default_rng(seed)
    P = 3000
    pos = np.concatenate([rng.integers(0, P, 6000),
                          rng.integers(700, 720, 20000)])
    gap = (pos >= 1024) & (pos < 1024 + 3 * tile_p)
    pos = pos[~gap]
    vocab = rng.integers(0, 10, pos.size).astype(np.int32)
    cp, cv, ct, n_tiles = tvc.prepare_chunks(pos, vocab, P, tile_p,
                                             use_native=False)
    e = cp.shape[0] // ct.size
    empty = (ct >= 1024 // tile_p) & (ct < 1024 // tile_p + 3)
    rows = np.repeat(~empty, e)
    stray = rng.integers(0, 8, (2, 2 * e, 128)).astype(np.int32)
    sparse = (np.concatenate([stray[0] % tile_p, cp[rows], stray[1]]),
              np.concatenate([stray[1], cv[rows], stray[0]]),
              np.concatenate([[-2, -1], ct[~empty], [n_tiles, n_tiles + 5]])
              .astype(np.int32))
    return (cp, cv, ct), sparse, n_tiles


def port_counts_tp(cp, cv, ct, n_tiles, tile_p):
    return tvc.chunk_counts(torch.from_numpy(cp), torch.from_numpy(cv),
                            torch.from_numpy(ct), n_tiles,
                            tile_p).numpy()


@pytest.mark.parametrize("tile_p", [128, 256, 512])
@pytest.mark.parametrize("seed", [0, 1])
def test_tile_chunk_start_ranges_match_jax(seed, tile_p):
    """The tile prefix the CUDA wrapper builds: tile t's chunks
    [start[t], start[t + 1]), counted alone, give the JAX split kernel's
    columns of tile t; chunks of tiles outside [0, n_tiles) fall outside
    every range; a tile with no chunk gets an empty range and zeros."""
    dense, (cp, cv, ct), n_tiles = _tile_prefix_case(seed, tile_p)
    want = np.asarray(jvp._vote_pallas_call(
        *(jnp.asarray(a) for a in dense), n_tiles=n_tiles, interpret=True,
        tile_p=tile_p, fused="split"))
    starts = tvc.tile_chunk_start(torch.from_numpy(ct), n_tiles).numpy()
    assert starts.dtype == np.int64 and starts.shape == (n_tiles + 1,)
    np.testing.assert_array_equal(
        starts, np.searchsorted(ct, np.arange(n_tiles + 1), side="left"))
    assert starts[0] == 2 and starts[-1] == ct.size - 2
    assert (np.diff(starts) == 0).sum() == 3  # the gap's tiles
    assert (np.diff(starts) > 10).any()  # the hot spot's tile
    e = cp.shape[0] // ct.size
    for t in range(n_tiles):
        c0, c1 = starts[t], starts[t + 1]
        got = tvc.chunk_counts_plain(
            torch.from_numpy(cp[c0 * e:c1 * e]),
            torch.from_numpy(cv[c0 * e:c1 * e]),
            torch.zeros(c1 - c0, dtype=torch.int32), 1, tile_p).numpy()
        np.testing.assert_array_equal(
            got, want[:, t * tile_p:(t + 1) * tile_p])
    np.testing.assert_array_equal(
        port_counts_tp(cp, cv, ct, n_tiles, tile_p), want)


def test_chunk_counts_rejects_unordered_tiles():
    """Tiles out of order break the contract that both the JAX kernels
    (a tile is zeroed on its first chunk, so a revisit loses counts) and
    the chunk vote kernel (one range of chunks per tile) rely on: the
    wrapper raises, naming it, on any device."""
    pos, vocab = rand_events(20000, 2048, 1, 0.3)
    cp, cv, ct, n_tiles = tvc.prepare_chunks(pos, vocab, 2048)
    perm = np.random.default_rng(0).permutation(ct.size)
    e = cp.shape[0] // ct.size
    cp = cp.reshape(ct.size, e, 128)[perm].reshape(cp.shape)
    cv = cv.reshape(ct.size, e, 128)[perm].reshape(cv.shape)
    ct = ct[perm]
    with pytest.raises(ValueError, match="non-decreasing"):
        port_counts(cp, cv, ct, n_tiles)
    with pytest.raises(ValueError, match="tiles in order"):
        tvc.tile_chunk_start(torch.from_numpy(ct), n_tiles)
    jax_total = int(jax_counts(cp, cv, ct, n_tiles).sum())
    plain = tvc.chunk_counts_plain(
        *(torch.from_numpy(a) for a in (cp, cv, ct)), n_tiles)
    assert jax_total < int(plain.sum())  # JAX drops the revisited counts
