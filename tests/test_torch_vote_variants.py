"""The chunk vote kernel against every kernel variant of
polypolish_tpu/ops/vote_pallas.py.

The JAX package lays one function onto the TPU's matrix unit in three
ways (variants split, fused and unfused, the last with
chunks_per_step); the port's ``chunk_counts`` (the plain PyTorch
version on the CPU; csrc/chunk_vote.cu on a GPU) must equal each of
them bitwise (``_vote_pallas_call(..., interpret=True)``) over tile_p
128, 256 and 512 and e_sub 4 and 8.  Also ``prepare_chunks`` with
``chunk_multiple`` byte-equal, ``dense_counts_chunks`` against
``dense_counts_pallas``, and the refusal of a step that straddles a
tile.  Tolerance: none — counts are integers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polypolish_tpu.ops import vote_pallas as jvp
from polypolish_tpu_torch.ops import vote_chunks as tvc
from tests.torch_helpers import rand_events

CASES = [
    # (seed, n events, positions, sparse_frac) — test_pallas.py shapes
    (0, 5000, 700, 0.3),
    (2, 100, 3000, 0.3),    # sparse coverage: many empty tiles
    (3, 0, 600, 0.0),       # no events at all
]


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("case", CASES)
def test_prepare_chunks_multiple_byte_equal(case, k):
    seed, n, p, sparse_frac = case
    pos, vocab = rand_events(n, p, seed, sparse_frac, skew=True)
    want = jvp.prepare_chunks(pos, vocab, p, chunk_multiple=k)
    got = tvc.prepare_chunks(pos, vocab, p, chunk_multiple=k)
    assert got[3] == want[3]
    assert got[2].shape[0] % k == 0
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("e_sub", [4, 8])
@pytest.mark.parametrize("tile_p", [128, 256, 512])
@pytest.mark.parametrize("variant", ["split", "fused", "unfused", True,
                                     False])
def test_chunk_counts_match_jax(variant, tile_p, e_sub):
    """Every variant name and legacy bool; e_sub 4 runs two chunks per
    step (chunk_multiple=2)."""
    k = 2 if e_sub == 4 else 1
    P = 1500
    pos, vocab = rand_events(6000, P, 8, sparse_frac=0.1, skew=True)
    cp, cv, ct, n_tiles = tvc.prepare_chunks(
        pos, vocab, P, tile_p, e_sub, use_native=False, chunk_multiple=k)
    want = np.asarray(jvp._vote_pallas_call(
        jnp.asarray(cp), jnp.asarray(cv), jnp.asarray(ct), n_tiles=n_tiles,
        interpret=True, tile_p=tile_p, e_sub=e_sub, chunks_per_step=k,
        fused=variant,
    ))
    got = tvc.chunk_counts(torch.from_numpy(cp), torch.from_numpy(cv),
                           torch.from_numpy(ct), n_tiles, tile_p, e_sub,
                           chunks_per_step=k, variant=variant).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("use_int8", [True, False])
@pytest.mark.parametrize("fused", ["split", "fused", "unfused"])
def test_dense_counts_chunks_match_jax(fused, use_int8):
    P = 2000
    pos, vocab = rand_events(20_000, P, 4, sparse_frac=0.2)
    want = np.asarray(jvp.dense_counts_pallas(
        pos, vocab, P, interpret=True, use_int8=use_int8, fused=fused))
    got = tvc.dense_counts_chunks(pos, vocab, P, use_int8=use_int8,
                                  fused=fused, device="cpu")
    assert tuple(got.shape) == (8, P)
    np.testing.assert_array_equal(got.numpy(), want)


def test_dense_counts_chunks_steps_match_host():
    """chunks_per_step=2 packs with chunk_multiple=2 and counts the same
    pileup."""
    P = 3000
    pos, vocab = rand_events(30_000, P, 6, sparse_frac=0.1, skew=True)
    got = tvc.dense_counts_chunks(pos, vocab, P, tile_p=512, e_sub=4,
                                  fused="unfused", chunks_per_step=2,
                                  device="cpu").numpy()
    dense = vocab < 8
    want = np.zeros((8, P), np.int32)
    np.add.at(want, (vocab[dense], pos[dense]), 1)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("legacy,name", [
    (True, "fused"), (False, "unfused"), ("split", "split"),
    ("fused", "fused"), ("unfused", "unfused")])
def test_variant_name_matches(legacy, name):
    assert tvc._variant_name(legacy) == jvp._variant_name(legacy) == name


def test_chunks_per_step_straddle_refused():
    cp = torch.full((4 * 8, 128), -1, dtype=torch.int32)
    cv = torch.zeros((4 * 8, 128), dtype=torch.int32)

    def tiles(*t):
        return torch.tensor(t, dtype=torch.int32)

    with pytest.raises(ValueError, match="straddles"):
        tvc.chunk_counts(cp, cv, tiles(0, 0, 0, 1), 2, chunks_per_step=2)
    with pytest.raises(ValueError, match="multiple"):
        tvc.chunk_counts(cp[:24], cv[:24], tiles(0, 0, 1), 2,
                         chunks_per_step=2)
    got = tvc.chunk_counts(cp, cv, tiles(0, 0, 1, 1), 2, chunks_per_step=2)
    assert int(got.sum()) == 0


def test_chunk_geometry_checked():
    cp = torch.zeros((8, 128), dtype=torch.uint8)
    ct = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="tile_p <= 256"):
        tvc.chunk_counts(cp, cp, ct, 1, tile_p=512)
    with pytest.raises(ValueError, match="multiple of 128"):
        tvc.chunk_counts(cp.int(), cp.int(), ct, 1, tile_p=2176)
    with pytest.raises(ValueError, match="unknown kernel variant"):
        tvc.chunk_counts(cp, cp, ct, 1, variant="dense")
    with pytest.raises(ValueError, match="chunk arrays"):
        tvc.chunk_counts(cp, cp, ct, 1, e_sub=4)
