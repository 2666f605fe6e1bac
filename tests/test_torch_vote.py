"""Port ops/vote.py against polypolish_tpu/ops/vote.py: depth, the
three dense-count backends of ``count_votes`` (host; xla, a torch
scatter-add; device, the chunk vote kernel's plain version on the CPU)
and the sparse tier, bitwise, including dropped events: negative
positions, positions past P, negative vocab ids and vocab ids >= 8.
Tolerance: none (integer counts; the f64 depth is the same sequential
sum)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polypolish_tpu.ops import vote as jv
from polypolish_tpu_torch.ops import vote as tv
from tests.torch_helpers import parse_both, rand_events, write_polish_case


def events(seed, n=20_000, P=3000):
    pos, vocab = rand_events(n, P, seed, sparse_frac=0.1, skew=True)
    weight = np.random.default_rng(seed).choice([1.0, 0.5, 1 / 3], n)
    return pos, vocab, weight, P


@pytest.mark.parametrize("backend,jax_backend", [
    ("host", "host"), ("xla", "xla"), ("device", "pallas")])
@pytest.mark.parametrize("seed", [0, 1])
def test_count_votes_matches_jax(seed, backend, jax_backend):
    pos, vocab, weight, P = events(seed)
    want = jv.count_votes(pos, vocab, weight, P, backend=jax_backend)
    got = tv.count_votes(pos, vocab, weight, P, backend=backend,
                         device="cpu")
    assert got[0].dtype == np.int32
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    assert got[1].tobytes() == want[1].tobytes()
    for g, w in zip(got[2], want[2]):
        np.testing.assert_array_equal(g, w)


def test_dense_counts_xla_drops_like_jax():
    """Negative positions (which would wrap), positions >= P, negative
    vocab ids and vocab ids >= 8 all drop."""
    P = 500
    rng = np.random.default_rng(3)
    pos = rng.integers(-600, 700, 50_000)
    vocab = rng.integers(-9, 20, 50_000)
    want = np.asarray(jv.dense_counts_xla(
        jnp.asarray(pos, jnp.int32), jnp.asarray(vocab, jnp.int32), P))
    got = tv.dense_counts_xla(torch.from_numpy(pos), torch.from_numpy(vocab),
                              P).numpy()
    np.testing.assert_array_equal(got, want)
    ok = (pos >= 0) & (pos < P) & (vocab >= 0) & (vocab < 8)
    assert got.sum() == ok.sum()


def test_scatter_add_drop_wraps_like_jax():
    """JAX's mode='drop' wraps an index in [-n, 0) and drops the rest."""
    counts = np.zeros((8, 16), np.int32)
    rows = np.array([-1, -8, -9, 0, 8, 3, 3])
    cols = np.array([0, -16, 1, -17, 2, 15, 16])
    want = np.asarray(jnp.asarray(counts).at[
        jnp.asarray(rows), jnp.asarray(cols)].add(1, mode="drop"))
    got = tv.scatter_add_drop(torch.from_numpy(counts.copy()),
                              torch.from_numpy(rows),
                              torch.from_numpy(cols)).numpy()
    np.testing.assert_array_equal(got, want)


def test_depth_and_sparse_match_jax():
    pos, vocab, weight, P = events(5)
    assert (tv.depth_host(pos, weight, P).tobytes()
            == jv.depth_host(pos, weight, P).tobytes())
    empty = np.empty(0, np.int64)
    np.testing.assert_array_equal(tv.depth_host(empty, empty, 7),
                                  jv.depth_host(empty, empty, 7))
    for g, w in zip(tv.sparse_counts_host(pos, vocab),
                    jv.sparse_counts_host(pos, vocab)):
        np.testing.assert_array_equal(g, w)
    for g in tv.sparse_counts_host(pos, vocab % 8):
        assert g.size == 0


def test_parsed_runs_events_match_jax(tmp_path):
    """ParsedRuns.raw and .events (all contigs and one) equal the JAX
    package's, and the events' counts equal the C++ fold."""
    asm, sam = write_polish_case(tmp_path, seed=21, genome_len=4000,
                                 n_reads=3000)
    (jr, tr), names, lens = parse_both(asm, [sam])
    try:
        for g, w in zip(tr.raw(), jr.raw()):
            np.testing.assert_array_equal(g, w)
        for contig in (None, names[0]):
            for g, w in zip(tr.events(contig), jr.events(contig)):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)
        pos, vid, weight = tr.events(names[0])
        counts, depth, sparse = tv.count_votes(pos, vid, weight,
                                               lens[names[0]])
        fold = tr.fold(names[0])
        np.testing.assert_array_equal(counts, fold[0])
        np.testing.assert_array_equal(depth, fold[1])
    finally:
        jr.close()
        tr.close()


def test_unknown_backend_raises():
    pos, vocab, weight, P = events(6, n=10)
    with pytest.raises(ValueError, match="unknown vote backend"):
        tv.count_votes(pos, vocab, weight, P, backend="pallas")
