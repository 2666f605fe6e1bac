"""GPU-only tests of polypolish_tpu_torch: each CUDA kernel against its
plain PyTorch version on the card, bitwise, and the device polish
against the host backend.  They skip when torch.cuda.is_available() is
false.  This file imports no jax, so it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import contextlib
import importlib.util
import io
import os

import numpy as np
import pytest
import torch

from polypolish_tpu_torch.models.polisher import LanesPolisher
from polypolish_tpu_torch.ops import consensus as tc
from polypolish_tpu_torch.ops import vote_chunks as tvc
from polypolish_tpu_torch.ops import vote_lanes as tvl
from polypolish_tpu_torch.pipeline.polish import polish

pytestmark = pytest.mark.cuda


def _load(name):
    # by path: run with --noconftest, ``tests`` need not be importable
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        name + ".py")
    spec = importlib.util.spec_from_file_location(f"_cuda_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


synth = _load("synth")


@pytest.fixture
def cuda_device():
    """The CUDA device, or a skip: decided inside the fixture, never at
    import, so every pytest-xdist worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def rand_events(n, num_positions, seed, sparse_frac=0.0, skew=False):
    rng = np.random.default_rng(seed)
    if skew:  # half of the events in 1% of the positions
        hot = rng.integers(0, max(1, num_positions // 100), size=n // 2)
        cold = rng.integers(0, num_positions, size=n - n // 2)
        pos = np.concatenate([hot, cold])
    else:
        pos = rng.integers(0, num_positions, size=n)
    vocab = rng.integers(0, 8, size=n)
    if sparse_frac:
        m = rng.random(n) < sparse_frac
        vocab = np.where(m, rng.integers(8, 48, size=n), vocab)
    return pos.astype(np.int64), vocab.astype(np.int32)


def on(device, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in arrays]


def lanes_both(cuda_device, vb, bt, n_tiles, r_sub, tile_w):
    if vb.dtype == np.uint8:
        vb = tvl.to_packed4(vb, r_sub)
    before = tvl.lanes_counts.launches
    got = tvl.lanes_counts(*on(cuda_device, vb, bt), n_tiles, r_sub, tile_w)
    torch.cuda.synchronize()
    assert tvl.lanes_counts.launches == before + 1
    want = tvl.lanes_counts_plain(*on(cuda_device, vb, bt), n_tiles, r_sub,
                                  tile_w)
    return got.cpu().numpy(), want.cpu().numpy()


@pytest.mark.parametrize("n,p,skew,r_sub,tile_w", [
    (50_000, 1000, False, 32, 2048),
    (400_000, 40_000, True, 8, 128),
    (2_000_000, 100_000, True, 32, 2048),
])
def test_lanes_kernel_matches_plain(cuda_device, n, p, skew, r_sub, tile_w):
    pos, vocab = rand_events(n, p, 1, sparse_frac=0.05, skew=skew)
    vb, bt, n_tiles = tvl.prepare_lanes(pos, vocab, p, r_sub, tile_w)
    got, want = lanes_both(cuda_device, vb, bt, n_tiles, r_sub, tile_w)
    np.testing.assert_array_equal(got, want)


def test_lanes_kernel_deep_tile(cuda_device):
    """5,000 events on one position: the tile holds 5,024 byte-rows,
    far past the 255 a packed byte field can hold."""
    pos = np.concatenate([np.full(5000, 17, dtype=np.int64),
                          np.arange(3000, dtype=np.int64)])
    vocab = (np.arange(pos.size) % 8).astype(np.int32)
    vb, bt, n_tiles = tvl.prepare_lanes(pos, vocab, 3000)
    got, want = lanes_both(cuda_device, vb, bt, n_tiles, 32, 2048)
    np.testing.assert_array_equal(got, want)
    assert got[:, 17].sum() == 5001


def test_lanes_kernel_slab_rounded_and_empty_tiles(cuda_device):
    """A stream rounded to two 32,768-block slabs, pad blocks on the last
    tile, and tiles that own no block at all (their counts are 0)."""
    rng = np.random.default_rng(2)
    n_tiles, tile_w, r_sub = 3000, 128, 32
    per_tile = rng.integers(0, 20, n_tiles)
    per_tile[::7] = 0
    bt = np.repeat(np.arange(n_tiles, dtype=np.int32), per_tile)
    n_blocks = tvl.geom_pad(max(bt.size, 32769),
                            slab=tvl.MAX_BLOCKS_PER_CALL)
    assert n_blocks % tvl.MAX_BLOCKS_PER_CALL == 0
    bt = np.concatenate([bt, np.full(n_blocks - bt.size, n_tiles - 1,
                                     np.int32)])
    vb = rng.integers(0, 11, (n_blocks * r_sub, tile_w), dtype=np.uint8)
    vb[vb >= 8] = 255
    got, want = lanes_both(cuda_device, vb, bt, n_tiles, r_sub, tile_w)
    np.testing.assert_array_equal(got, want)
    assert got.reshape(8, n_tiles, tile_w)[:, per_tile == 0].sum() == 0


def test_lanes_kernel_rejects_unsorted_tiles(cuda_device):
    vb = torch.zeros((16, 128), dtype=torch.int32, device=cuda_device)
    bt = torch.tensor([1, 0], dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="non-decreasing"):
        tvl.lanes_counts(vb, bt, 2, 32, 128)


@pytest.mark.parametrize("layout", ["int32", "uint8"])
def test_chunk_kernel_matches_plain(cuda_device, layout):
    pos, vocab = rand_events(500_000, 90_000, 3, sparse_frac=0.2, skew=True)
    cp, cv, ct, n_tiles = tvc.prepare_chunks(pos, vocab, 90_000)
    if layout == "uint8":
        cv = np.where(cp < 0, 255, cv).astype(np.uint8)
        cp = np.maximum(cp, 0).astype(np.uint8)
    before = tvc.chunk_counts.launches
    got = tvc.chunk_counts(*on(cuda_device, cp, cv, ct), n_tiles)
    torch.cuda.synchronize()
    assert tvc.chunk_counts.launches == before + 1
    want = tvc.chunk_counts_plain(*on(cuda_device, cp, cv, ct), n_tiles)
    assert torch.equal(got, want)
    assert int(got.sum()) == int(((vocab >= 0) & (vocab < 8)).sum())


def test_consensus_core_gpu_matches_cpu(cuda_device):
    rng = np.random.default_rng(4)
    P = 200_000
    counts = rng.integers(0, 30, size=(8, P)).astype(np.int32)
    counts[5:, rng.random(P) < 0.5] = 0
    depth = counts.sum(axis=0).astype(np.float64)
    valid, invalid, low = tc.compute_thresholds(depth, 5, 0.5, 0.2)
    invalid[::3] = 0
    orig = rng.integers(0, 8, size=P).astype(np.int32)
    args = (counts, valid, invalid, low, orig)
    got = [t.cpu().numpy()
           for t in tc.consensus_dense_core(*on(cuda_device, *args))]
    want = tc.consensus_dense_numpy(*args)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_polisher_gpu_matches_cpu(cuda_device):
    P, r_sub, tile_w = 40_000, 32, 2048
    pos, vocab = rand_events(2_000_000, P, 5, sparse_frac=0.01, skew=True)
    vb, bt, n_tiles, ov_pos, ov_vid = tvl.prepare_lanes(
        pos, vocab, P, r_sub, tile_w, cap=True)
    assert ov_pos.size > 0
    P_pad = n_tiles * tile_w
    depth = np.zeros(P_pad)
    depth[:P] = np.bincount(pos, minlength=P)
    thr = [*tc.compute_thresholds(depth, 5, 0.5, 0.2),
           np.random.default_rng(5).integers(0, 8, P_pad).astype(np.int32)]
    outs = []
    for dev in (cuda_device, torch.device("cpu")):
        m = LanesPolisher(P_pad, dev, r_sub=r_sub, tile_w=tile_w)
        outs.append([x.cpu().numpy() for x in m.forward_pack(
            vb, bt, *on(dev, *thr), ov_pos=ov_pos, ov_vid=ov_vid)])
    for g, w in zip(*outs):
        np.testing.assert_array_equal(g, w)


def test_polish_on_gpu_matches_host(cuda_device, tmp_path):
    fasta, sam_text = synth.make_polish_case(
        seed=12, genome_len=20_000, n_reads=20_000, read_len=60, err=0.15,
        multi_frac=0.5, n_draft_errors=40)
    asm, sam = tmp_path / "a.fasta", tmp_path / "a.sam"
    asm.write_text(synth.fasta_text(fasta))
    sam.write_text(sam_text)
    results = {}
    for backend in ("device", "host"):
        out, err = io.StringIO(), io.StringIO()
        dbg = tmp_path / f"{backend}.tsv"
        tvl.lanes_counts.launches = tvc.chunk_counts.launches = 0
        with contextlib.redirect_stderr(err):
            polish(str(dbg), 0.2, 0.5, 10, 5, False, str(asm), [str(sam)],
                   out=out, backend=backend, device=cuda_device)
        results[backend] = (out.getvalue(), dbg.read_text())
        if backend == "device":
            assert tvl.lanes_counts.launches == 1
            assert tvc.chunk_counts.launches == 1
    assert results["device"] == results["host"]
