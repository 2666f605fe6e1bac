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
