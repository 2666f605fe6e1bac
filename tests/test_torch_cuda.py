"""GPU-only tests of polypolish_tpu_torch: each CUDA kernel entry point
against its plain PyTorch version on the card, bitwise (the lanes
kernel's three row layouts across their plane-flush periods, the chunk
kernel across tile_p, e_sub and chunks_per_step, the overflow kernel on
sorted, unsorted, out-of-range and grid-long lists), and every device
polish path against the host backend.  They skip when torch.cuda.is_available() is
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
lanes_split = _load("lanes_split")


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


def zero_launches():
    tvl.lanes_counts.launches.clear()
    tvl.overflow_counts.launches = 0
    tvc.chunk_counts.launches = 0


def lanes_both(cuda_device, vb, bt, n_tiles, r_sub, tile_w,
               body="packed4"):
    """(kernel counts, plain counts) of one pack; uint8 byte rows are
    converted to the packed4 layout for body packed4."""
    if vb.dtype == np.uint8 and body == "packed4":
        vb = tvl.to_packed4(vb, r_sub)
    entry = tvl.BODIES[body][1]
    before = tvl.lanes_counts.launches[entry]
    got = tvl.lanes_counts(*on(cuda_device, vb, bt), n_tiles, r_sub, tile_w,
                           body)
    torch.cuda.synchronize()
    assert tvl.lanes_counts.launches[entry] == before + 1
    want = tvl.lanes_counts_plain(*on(cuda_device, vb, bt), n_tiles, r_sub,
                                  tile_w, body)
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


def split_case(kind, body, tile_w):
    """(rows in the body's layout, block_tile of one row per block,
    n_tiles) around the lanes kernel's work split: short tiles then
    4,096 all-pad rows on the last tile; tiles of exactly S, S + 1 and
    3S + 5 rows (S, the kernel's rows per segment); every tile but the
    last empty.  Slots are mostly votes 0-7, with pad 255 and other bytes
    >= 8."""
    rng = np.random.default_rng(len(kind) + tile_w)
    seg = lanes_split.kernel_seg_rows(body)
    pad_rows = 0
    if kind == "pad tail":
        per_tile = rng.integers(0, 21, 300)
        pad_rows = 4096
        per_tile[-1] += pad_rows
    elif kind == "segment edges":
        per_tile = np.array([seg, seg + 1, 3 * seg + 5, 0, seg - 1, 1,
                             2 * seg, 2 * seg + 1])
    else:  # "only the last tile"
        per_tile = np.zeros(50, np.int64)
        per_tile[-1] = 3 * seg + 7
    width = tile_w * (4 if body == "packed4" else 1)
    n_rows = int(per_tile.sum())
    vb = rng.integers(0, 8, (n_rows, width), dtype=np.uint8)
    r = rng.random(vb.shape)
    vb[r < 0.2] = 255
    vb[r > 0.95] = rng.integers(8, 255, int((r > 0.95).sum()))
    if pad_rows:
        vb[n_rows - pad_rows:] = 255
    if body == "packed4":
        vb = vb.view(np.int32)
    elif body == "cmp":
        vb = vb.view(np.int8)
    bt = np.repeat(np.arange(per_tile.size, dtype=np.int32), per_tile)
    return vb, bt, per_tile.size


@pytest.mark.parametrize("tile_w", [128, 2048])
@pytest.mark.parametrize("body", ["packed4", "packed", "cmp"])
@pytest.mark.parametrize("kind", ["pad tail", "segment edges",
                                  "only the last tile"])
def test_lanes_kernel_split_matches_plain(cuda_device, kind, body, tile_w):
    """The packed4 and byte-row kernels split a tile's rows into
    segments of S rows (the first stored, the rest added); each
    case crosses those boundaries."""
    vb, bt, n_tiles = split_case(kind, body, tile_w)
    r_sub = tvl.BODIES[body][0]  # one array row per block
    got, want = lanes_both(cuda_device, vb, bt, n_tiles, r_sub, tile_w,
                           body)
    np.testing.assert_array_equal(got, want)
    if kind == "only the last tile":
        assert got.reshape(8, n_tiles, tile_w)[:, :-1].sum() == 0


@pytest.mark.parametrize("body", ["packed", "cmp"])
def test_lanes_kernel_unaligned_rows_match_plain(cuda_device, body):
    """The byte kernels read rows in 16-byte pieces: a view that starts
    off a 16-byte boundary is copied first and still counts right."""
    rng = np.random.default_rng(9)
    flat = torch.from_numpy(rng.integers(0, 12, 4 * 32 * 128 + 1,
                                         dtype=np.uint8)).to(cuda_device)
    vb = flat[1:].view(4 * 32, 128)
    if body == "cmp":
        vb = vb.view(torch.int8)
    assert vb.data_ptr() % 16
    bt = torch.tensor([0, 0, 1, 2], dtype=torch.int32, device=cuda_device)
    got = tvl.lanes_counts(vb, bt, 3, 32, 128, body)
    want = tvl.lanes_counts_plain(vb, bt, 3, 32, 128, body)
    assert torch.equal(got, want)


def test_lanes_kernel_takes_the_host_block_tile(cuda_device):
    """lanes_counts given block_tile's host array builds its tile prefix
    from it, with the same counts as from block_tile read back, and
    refuses one of another length."""
    pos, vocab = rand_events(200_000, 30_000, 4, skew=True)
    vb, bt, n_tiles = tvl.prepare_lanes(pos, vocab, 30_000)
    vb = tvl.to_packed4(vb, tvl.R_SUB)
    d_vb, d_bt = on(cuda_device, vb, bt)
    got = tvl.lanes_counts(d_vb, d_bt, n_tiles, block_tile_host=bt)
    want = tvl.lanes_counts(d_vb, d_bt, n_tiles)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="block_tile_host"):
        tvl.lanes_counts(d_vb, d_bt, n_tiles, block_tile_host=bt[1:])


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
        zero_launches()
        with contextlib.redirect_stderr(err):
            polish(str(dbg), 0.2, 0.5, 10, 5, False, str(asm), [str(sam)],
                   out=out, backend=backend, device=cuda_device)
        results[backend] = (out.getvalue(), dbg.read_text())
        if backend == "device":
            assert tvl.lanes_counts.launches == {"lanes_vote_packed4": 1}
            assert tvl.overflow_counts.launches == 1
            assert tvc.chunk_counts.launches == 0
    assert results["device"] == results["host"]


def test_overflow_scatter_matches_chunk_kernel(cuda_device):
    """add_overflow_counts on the card (numpy arrays uploaded, or device
    tensors) equals the chunk kernel's overflow counts and the CPU
    scatter, bitwise; out-of-range events drop."""
    rng = np.random.default_rng(9)
    width = 64 * 2048
    pos = np.sort(rng.integers(0, width, 300_000)).astype(np.int32)
    vid = rng.integers(0, 8, pos.size).astype(np.uint8)
    cp, cv, ct, nt = tvc.prepare_chunks(pos.astype(np.int64),
                                        vid.astype(np.int32), width)
    want = tvc.chunk_counts(*(torch.from_numpy(a).to(cuda_device)
                              for a in (cp, cv, ct)), nt)[:, :width]
    cpu = tvl.add_overflow_counts(torch.zeros((8, width), dtype=torch.int32),
                                  pos, vid)
    bad_pos = np.concatenate([pos, [width, 5]]).astype(np.int32)
    bad_vid = np.concatenate([vid, [1, 9]]).astype(np.uint8)
    for args in ((bad_pos, bad_vid),
                 (torch.from_numpy(bad_pos).to(cuda_device),
                  torch.from_numpy(bad_vid).to(cuda_device))):
        got = tvl.add_overflow_counts(
            torch.zeros((8, width), dtype=torch.int32, device=cuda_device),
            *args)
        assert torch.equal(got, want)
        assert torch.equal(got.cpu(), cpu)


def overflow_both(cuda_device, width, pos, vid, base=None):
    """(kernel counts, plain counts) of one overflow list added onto
    ``base`` (zeros by default), the kernel's launch counted once."""
    base = (np.zeros((8, width), np.int32) if base is None
            else np.asarray(base, np.int32))
    before = tvl.overflow_counts.launches
    got = tvl.overflow_counts(*on(cuda_device, base, pos, vid))
    torch.cuda.synchronize()
    assert tvl.overflow_counts.launches == before + (len(pos) > 0)
    want = tvl.add_overflow_counts(*on(cuda_device, base, pos, vid))
    return got.cpu().numpy(), want.cpu().numpy()


def overflow_list(rng, n, width, sort=True):
    """A list as the packer leaves it (sorted by (pos, vid), runs of
    equal keys) or shuffled."""
    pos = rng.integers(0, width, n).astype(np.int32)
    vid = rng.integers(0, 8, n).astype(np.uint8)
    pos[: n // 4] = pos[0]  # one deep position: runs across threads
    vid[: n // 8] = vid[0]
    o = np.lexsort((vid, pos)) if sort else rng.permutation(n)
    return pos[o], vid[o]


@pytest.mark.parametrize("n,width,sort", [
    (1, 256, True), (15, 256, True), (16, 256, True), (17, 256, True),
    (511, 2048, True), (513, 2048, True), (300_000, 64 * 2048, True),
    (300_000, 64 * 2048, False), (1_000_000, 4096, True),
])
def test_overflow_kernel_matches_plain(cuda_device, n, width, sort):
    rng = np.random.default_rng(n + width)
    pos, vid = overflow_list(rng, n, width, sort)
    base = rng.integers(0, 100, (8, width))
    got, want = overflow_both(cuda_device, width, pos, vid, base)
    np.testing.assert_array_equal(got, want)
    assert int(got.sum() - base.sum()) == n


def test_overflow_kernel_drops_and_wraps(cuda_device):
    """vid >= 8 and pos outside [-width, width) drop; a pos in
    [-width, 0) wraps, as the plain version (JAX's mode='drop')
    does; an empty list launches nothing."""
    width = 1024
    pos = np.array([0, 0, 5, 5, 5, 1023, 1024, 5000, -1, -1024, -1025,
                    2**31 - 1, -2**31, 7, 7], np.int32)
    vid = np.array([1, 1, 7, 7, 8, 0, 2, 3, 4, 4, 4, 1, 1, 255, 9],
                   np.uint8)
    got, want = overflow_both(cuda_device, width, pos, vid)
    np.testing.assert_array_equal(got, want)
    assert got[4, width - 1] == 1 and got[4, 0] == 1 and got.sum() == 7
    got, want = overflow_both(cuda_device, width, pos[:0], vid[:0])
    assert not got.any() and not want.any()


def test_overflow_kernel_one_deep_position(cuda_device):
    """Thousands of events of all eight ids at one position, between
    sparse neighbours: runs spanning many threads and warps."""
    width = 2048
    pos = np.concatenate([np.arange(0, 100), np.full(40_000, 777),
                          np.arange(1000, 1100)]).astype(np.int32)
    vid = np.concatenate([np.zeros(100), np.repeat(np.arange(8), 5000),
                          np.full(100, 7)]).astype(np.uint8)
    got, want = overflow_both(cuda_device, width, pos, vid)
    np.testing.assert_array_equal(got, want)
    assert (got[:, 777] == 5000).all()


def test_overflow_kernel_longer_than_its_grid(cuda_device):
    """A list longer than one pass of the kernel's grid, each warp
    looping over several spans; also from views that start off a
    16-byte boundary (copied by the wrapper)."""
    per_pass = tvl._overflow_kernel().overflow_vote_grid_events()
    n = 2 * per_pass + 12_345
    rng = np.random.default_rng(3)
    width = 1 << 20
    pos, vid = overflow_list(rng, n, width)
    got, want = overflow_both(cuda_device, width, pos, vid)
    np.testing.assert_array_equal(got, want)
    d_pos, d_vid = on(cuda_device, pos, vid)
    counts = torch.zeros((8, width), dtype=torch.int32, device=cuda_device)
    tvl.overflow_counts(counts, d_pos[3:], d_vid[3:])
    plain = tvl.add_overflow_counts(
        torch.zeros_like(counts), d_pos[3:], d_vid[3:])
    assert torch.equal(counts, plain)


def test_overflow_kernel_rejects_bad_arguments(cuda_device):
    counts = torch.zeros((8, 64), dtype=torch.int32, device=cuda_device)
    pos = torch.zeros(4, dtype=torch.int32, device=cuda_device)
    vid = torch.zeros(4, dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError, match="int32 and uint8"):
        tvl.overflow_counts(counts, pos.long(), vid)
    with pytest.raises(ValueError, match="one device"):
        tvl.overflow_counts(counts, pos.cpu(), vid)
    with pytest.raises(ValueError, match="contiguous int32"):
        tvl.overflow_counts(counts[:, ::2], pos, vid)


def _deep_rows(rng, per_tile, row_values, tile_w):
    """Rows of random slot values with the given array-row count per
    tile (one row per block): (vb, block_tile)."""
    bt = np.repeat(np.arange(len(per_tile), dtype=np.int32), per_tile)
    return rng.integers(0, row_values, (bt.size, tile_w)), bt


@pytest.mark.parametrize("body,dtype", [("packed", np.uint8),
                                        ("cmp", np.int8)])
def test_lanes_bytes_entry_flush_boundaries(cuda_device, body, dtype):
    """Byte rows (bodies packed and cmp, uint8 and int8) with tiles of
    0, 254, 255, 256, 510 and 3,000 rows around the 255-row flush."""
    rng = np.random.default_rng(6)
    per_tile = [0, 254, 255, 256, 510, 3000, 1]
    vb, bt = _deep_rows(rng, per_tile, 12, 256)
    vb = np.where(vb >= 8, 255, vb).astype(np.uint8).view(dtype)
    got, want = lanes_both(cuda_device, vb, bt, len(per_tile), 1, 256, body)
    np.testing.assert_array_equal(got, want)
    assert got.reshape(8, -1, 256).sum(axis=0)[5].min() > 255


def test_lanes_packed8_entry_flush_boundaries(cuda_device):
    """Nibble rows with tiles of 0, 14, 15, 16, 30, 31, 32, 62 and 400
    int32 rows around the bit-sliced kernel's 15-row flush and its
    multiples; nibbles 8-15 count nothing."""
    rng = np.random.default_rng(7)
    per_tile = [0, 14, 15, 16, 30, 31, 32, 62, 400, 1]
    nib, bt = _deep_rows(rng, per_tile, 16, 128)
    words = np.zeros(nib.shape, np.uint32)
    for k in range(8):
        words |= rng.integers(0, 16, nib.shape).astype(np.uint32) << (4 * k)
    got, want = lanes_both(cuda_device, words.view(np.int32), bt,
                           len(per_tile), 8, 128, "packed8")
    np.testing.assert_array_equal(got, want)


def test_lanes_packed8_all_pad_and_single_value_words(cuda_device):
    """All-pad words (nibble 15 everywhere) count nothing; words of one
    value v in all eight nibbles, 15 and 16 rows deep, count 8 per row
    in row v alone — every nibble field of one accumulator full at the
    flush."""
    rows = []
    bt = []
    for t, (value, depth) in enumerate([(15, 16), (0, 15), (7, 16),
                                        (3, 30), (8, 15), (4, 1)]):
        word = np.uint32(int(f"{value:x}" * 8, 16))
        rows.append(np.full((depth, 256), word, np.uint32))
        bt += [t] * depth
    vb = np.concatenate(rows).view(np.int32)
    bt = np.asarray(bt, np.int32)
    got, want = lanes_both(cuda_device, vb, bt, 6, 8, 256, "packed8")
    np.testing.assert_array_equal(got, want)
    got = got.reshape(8, 6, 256)
    assert got[:, 0].sum() == 0 and got[:, 4].sum() == 0
    for t, value, depth in ((1, 0, 15), (2, 7, 16), (3, 3, 30), (5, 4, 1)):
        assert (got[value, t] == 8 * depth).all()
        assert got[:, t].sum() == 8 * depth * 256


@pytest.mark.parametrize("body", ["packed4", "packed", "cmp", "packed8"])
def test_dense_counts_lanes_gpu_matches_cpu(cuda_device, body):
    pos, vocab = rand_events(1_000_000, 60_000, 8, sparse_frac=0.05,
                             skew=True)
    got = tvl.dense_counts_lanes(pos, vocab, 60_000, body=body, cap=True,
                                 device=cuda_device)
    want = tvl.dense_counts_lanes(pos, vocab, 60_000, body=body, cap=True,
                                  device="cpu")
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("tile_p,e_sub,k,layout", [
    (128, 1, 1, "int32"), (128, 4, 2, "uint8"), (256, 8, 1, "int32"),
    (256, 8, 1, "uint8"), (256, 4, 2, "int32"), (512, 8, 1, "int32"),
    (1024, 4, 1, "int32"), (2048, 8, 1, "int32"), (2048, 2, 4, "int32")])
def test_chunk_kernel_geometry_matches_plain(cuda_device, tile_p, e_sub, k,
                                             layout):
    """tile_p up to 2048 (64 KB of shared memory, past the 48 KB
    default), any e_sub, chunks_per_step k; the uint8 layout holds
    tile_p <= 256."""
    P = 50_000
    pos, vocab = rand_events(400_000, P, 9, sparse_frac=0.1, skew=True)
    cp, cv, ct, n_tiles = tvc.prepare_chunks(
        pos, vocab, P, tile_p, e_sub, use_native=False, chunk_multiple=k)
    if layout == "uint8":
        cv = np.where(cp < 0, 255, cv).astype(np.uint8)
        cp = np.maximum(cp, 0).astype(np.uint8)
    before = tvc.chunk_counts.launches
    got = tvc.chunk_counts(*on(cuda_device, cp, cv, ct), n_tiles, tile_p,
                           e_sub, chunks_per_step=k)
    torch.cuda.synchronize()
    assert tvc.chunk_counts.launches == before + 1
    want = tvc.chunk_counts_plain(*on(cuda_device, cp, cv, ct), n_tiles,
                                  tile_p, e_sub)
    assert torch.equal(got, want)
    assert int(got.sum()) == int((vocab < 8).sum())


@pytest.mark.parametrize("fused", ["split", "fused", "unfused"])
def test_dense_counts_chunks_gpu_matches_cpu(cuda_device, fused):
    pos, vocab = rand_events(1_000_000, 60_000, 10, sparse_frac=0.05)
    k = 2 if fused == "unfused" else 1
    got = tvc.dense_counts_chunks(pos, vocab, 60_000, fused=fused,
                                  chunks_per_step=k, device=cuda_device)
    want = tvc.dense_counts_chunks(pos, vocab, 60_000, fused=fused,
                                   chunks_per_step=k, device="cpu")
    assert torch.equal(got.cpu(), want)


def test_polish_mxu_and_xla_on_gpu_match_host(cuda_device, tmp_path):
    """The mxu path launches the chunk kernel once per contig and no
    lanes kernel; the xla path launches no hand kernel."""
    fasta, sam_text = synth.make_polish_case(
        seed=13, genome_len=20_000, n_reads=20_000, read_len=60, err=0.15,
        multi_frac=0.5, n_draft_errors=40)
    asm, sam = tmp_path / "a.fasta", tmp_path / "a.sam"
    asm.write_text(synth.fasta_text(fasta))
    sam.write_text(sam_text)
    results = {}
    for name, kwargs, chunk_launches in (
            ("host", dict(backend="host"), 0),
            ("mxu", dict(backend="device", kernel_variant="mxu"), 1),
            ("xla", dict(backend="xla"), 0)):
        out, err = io.StringIO(), io.StringIO()
        dbg = tmp_path / f"{name}.tsv"
        zero_launches()
        with contextlib.redirect_stderr(err):
            polish(str(dbg), 0.2, 0.5, 10, 5, False, str(asm), [str(sam)],
                   out=out, device=cuda_device, **kwargs)
        results[name] = (out.getvalue(), dbg.read_text())
        assert sum(tvl.lanes_counts.launches.values()) == 0
        assert tvl.overflow_counts.launches == 0
        assert tvc.chunk_counts.launches == chunk_launches
    assert results["mxu"] == results["host"]
    assert results["xla"] == results["host"]


def _skewed_chunks(rng, n_tiles, tile_p, e_sub, k, layout):
    """A chunk stream by hand: tile 3 hundreds of chunks deep, tiles
    10-14 with only pad chunks, tiles 20-21 with no chunk, the rest 1-4
    chunks; each tile's chunk count a multiple of k."""
    per_tile = rng.integers(1, 5, n_tiles) * k
    per_tile[3] = 300 * k
    per_tile[20:22] = 0
    ct = np.repeat(np.arange(n_tiles, dtype=np.int32), per_tile)
    e = e_sub * 128
    cp = rng.integers(0, tile_p, (ct.size, e))
    cv = rng.integers(0, 10, (ct.size, e))
    pad = (rng.random(cp.shape) < 0.1) | ((ct >= 10) & (ct < 15))[:, None]
    if layout == "uint8":
        cp, cv = cp.astype(np.uint8), np.where(pad, 255, cv).astype(np.uint8)
    else:
        cp, cv = np.where(pad, -1, cp).astype(np.int32), cv.astype(np.int32)
    return (cp.reshape(-1, 128), cv.reshape(-1, 128), ct)


@pytest.mark.parametrize("tile_p,e_sub,k,layout", [
    (128, 8, 1, "int32"), (128, 4, 2, "uint8"), (256, 8, 1, "uint8"),
    (256, 8, 2, "int32"), (512, 2, 1, "int32"), (2048, 8, 1, "int32")])
def test_chunk_kernel_deep_skewed_tiles(cuda_device, tile_p, e_sub, k,
                                        layout):
    """One CTA per tile: a tile 300 chunks deep (per k), tiles holding
    only pad chunks and tiles holding no chunk (their columns are
    written as zeros: the output is never zero-filled)."""
    rng = np.random.default_rng(tile_p + e_sub + k)
    n_tiles = 40
    cp, cv, ct = _skewed_chunks(rng, n_tiles, tile_p, e_sub, k, layout)
    before = tvc.chunk_counts.launches
    got = tvc.chunk_counts(*on(cuda_device, cp, cv, ct), n_tiles, tile_p,
                           e_sub, chunks_per_step=k)
    torch.cuda.synchronize()
    assert tvc.chunk_counts.launches == before + 1
    want = tvc.chunk_counts_plain(*on(cuda_device, cp, cv, ct), n_tiles,
                                  tile_p, e_sub)
    assert torch.equal(got, want)
    _, plan = tvc.chunk_vote_launch(*on(cuda_device, cp, cv, ct), n_tiles,
                                    tile_p, e_sub)
    d_ct = on(cuda_device, ct)[0]
    assert torch.equal(plan[:n_tiles + 1], tvc.tile_chunk_start(d_ct,
                                                                n_tiles))
    assert int(plan[n_tiles + 1]) == 0
    by_tile = got.view(8, n_tiles, tile_p).sum(dim=(0, 2)).cpu().numpy()
    assert (by_tile[10:15] == 0).all() and (by_tile[20:22] == 0).all()
    assert by_tile[3] > 200 * k * e_sub * 128 * 0.5


def test_chunk_kernel_rejects_unordered_tiles(cuda_device):
    """The launch sets the order flag and counts nothing; the wrapper
    reads the flag and raises."""
    cp = torch.full((3 * 8, 128), -1, dtype=torch.int32, device=cuda_device)
    ct = torch.tensor([0, 2, 1], dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="non-decreasing"):
        tvc.chunk_counts(cp, cp, ct, 3)
    _, plan = tvc.chunk_vote_launch(cp, cp, ct, 3)
    assert int(plan[3 + 1]) == 1


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_windowed_polish_on_gpu_matches_host(cuda_device, tmp_path,
                                             monkeypatch, depth):
    """The windowed device twin on the card (kernel A once per window,
    the overflow kernel once per window with overflow events, no chunk
    kernel) against the unwindowed host backend."""
    fasta, sam_text = synth.make_polish_case(
        seed=12, genome_len=20_000, n_reads=20_000, read_len=60, err=0.15,
        multi_frac=0.5, n_draft_errors=40)
    asm, sam = tmp_path / "a.fasta", tmp_path / "a.sam"
    asm.write_text(synth.fasta_text(fasta))
    sam.write_text(sam_text)

    def run(backend):
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stderr(err):
            polish(None, 0.2, 0.5, 10, 5, False, str(asm), [str(sam)],
                   out=out, backend=backend, device=cuda_device)
        return out.getvalue()

    host = run("host")
    monkeypatch.setenv("POLYPOLISH_TPU_WINDOW_MIN", "1")
    monkeypatch.setenv("POLYPOLISH_TPU_WINDOW", "4096")
    monkeypatch.setenv("POLYPOLISH_TPU_WINDOW_DEPTH", str(depth))
    zero_launches()
    assert run("device") == host
    assert tvl.lanes_counts.launches == {"lanes_vote_packed4": 5}
    assert 1 <= tvl.overflow_counts.launches <= 5
    assert tvc.chunk_counts.launches == 0
    assert run("host") == host


def test_pair_screen_step_gpu_matches_cpu(cuda_device):
    from polypolish_tpu_torch.models.pairscreen import pair_screen_step

    rng = np.random.default_rng(3)
    n_align, m = 5000, 2_000_000
    seg = np.sort(rng.integers(0, n_align + 1, m)).astype(np.int32)
    starts = rng.integers(0, 2**31 - 1000, (2, m))
    cols = [rng.integers(0, 3, m), rng.choice([0, 16, 256, 272], m),
            starts[0], starts[0] + rng.integers(20, 500, m),
            rng.integers(0, 3, m), rng.choice([0, 16, 256, 272], m),
            starts[1], starts[1] + rng.integers(20, 500, m)]
    cols = [c.astype(np.int32) for c in cols]
    no_pair = rng.random(n_align) < 0.1
    unique = rng.random(n_align) < 0.1
    got = [pair_screen_step(*on(dev, seg, *cols), 100, 2**30, 0,
                            *on(dev, no_pair, unique),
                            num_alignments=n_align).cpu()
           for dev in (cuda_device, "cpu")]
    assert torch.equal(got[0], got[1])


def _event_case(tmp_path):
    fasta, sam_text = synth.make_polish_case(
        seed=12, genome_len=8_000, n_reads=6_000, read_len=60, err=0.15,
        multi_frac=0.5, n_draft_errors=25)
    asm, sam = tmp_path / "e.fasta", tmp_path / "e.sam"
    asm.write_text(synth.fasta_text(fasta))
    sam.write_text(sam_text)
    return asm, sam


@pytest.mark.parametrize("backend", ["device", "xla"])
def test_event_path_on_gpu_matches_cpu(cuda_device, tmp_path, backend):
    """The pure-Python reader's event stream on the card (backend device:
    PolisherModel.pack, then one chunk-kernel launch and no lanes
    launch, whatever the kernel variant) against the same run on the
    CPU (the kernel's plain version), FASTA and --debug TSV."""
    asm, sam = _event_case(tmp_path)
    results = {}
    for dev in (cuda_device, torch.device("cpu")):
        out, err = io.StringIO(), io.StringIO()
        dbg = tmp_path / f"{dev.type}.tsv"
        zero_launches()
        with contextlib.redirect_stderr(err):
            polish(str(dbg), 0.2, 0.5, 10, 5, False, str(asm), [str(sam)],
                   out=out, backend=backend, device=dev, use_native=False,
                   kernel_variant="lanes")
        results[dev.type] = (out.getvalue(), dbg.read_text())
        if dev.type == "cuda":
            assert sum(tvl.lanes_counts.launches.values()) == 0
            assert tvl.overflow_counts.launches == 0
            assert tvc.chunk_counts.launches == (backend == "device")
    assert results["cuda"] == results["cpu"]


def _has_overflow(asm, sams):
    """Whether the lanes path's pack of a one-contig genome has
    cap-overflow events (then the overflow kernel folds them)."""
    from polypolish_tpu_torch.io.fasta import load_fasta
    from polypolish_tpu_torch.native.runs import parse_runs
    from polypolish_tpu_torch.pipeline.polish import _pad_bucket
    from polypolish_tpu_torch.vocab import Vocab

    (name, _, seq), = load_fasta(asm)
    pr = parse_runs(sams, [name], {name: len(seq)}, Vocab(), 10, False)
    try:
        pack = pr.lanes(name, tvl.R_SUB, tvl.TILE_W, packed4=True, cap=True,
                        num_positions=_pad_bucket(len(seq)))
        try:
            return pack.n_overflow > 0
        finally:
            pack.close()
    finally:
        pr.close()


def test_batch_on_gpu_counts_every_launch(cuda_device, tmp_path):
    """polish_batch with three workers on the card: every output equals
    the host backend's, and the launch counters, shared by the worker
    threads under one lock, count exactly one kernel-A launch and one
    overflow fold per genome."""
    from polypolish_tpu_torch.pipeline.batch import polish_batch

    jobs = []
    for i in range(6):
        fasta, sam_text = synth.make_polish_case(
            seed=40 + i, genome_len=20_000, n_reads=20_000, read_len=60,
            err=0.15, multi_frac=0.5, n_draft_errors=40)
        asm, sam = tmp_path / f"b{i}.fasta", tmp_path / f"b{i}.sam"
        asm.write_text(synth.fasta_text(fasta))
        sam.write_text(sam_text)
        jobs.append((str(asm), str(tmp_path / f"o{i}.fasta"), [str(sam)]))
    host = [(a, str(tmp_path / f"h{i}.fasta"), s)
            for i, (a, _, s) in enumerate(jobs)]
    with contextlib.redirect_stderr(io.StringIO()):
        polish_batch(host, backend="host", workers=1)
        zero_launches()
        results = polish_batch(jobs, backend="device", workers=3,
                               device=cuda_device)
    assert all("error" not in r for r in results)
    assert tvl.lanes_counts.launches == {"lanes_vote_packed4": 6}
    assert tvl.overflow_counts.launches == sum(_has_overflow(*j[::2])
                                               for j in jobs)
    assert tvc.chunk_counts.launches == 0
    for (_, got, _), (_, want, _) in zip(jobs, host):
        with open(got) as g, open(want) as w:
            assert g.read() == w.read()


@pytest.mark.parametrize("grid", [(1, 1), (2, 2), (1, 3)])
def test_sharded_grid_on_gpu(cuda_device, tmp_path, grid):
    """polish(backend="sharded") on a grid of the card: FASTA equal to
    the host backend's, kernel A launched once per grid cell and contig,
    no overflow or chunk kernel (the mesh pack has no cap)."""
    from polypolish_tpu_torch.parallel import make_mesh

    fasta, sam_text = synth.make_multi_contig_case(
        seed=21, n_contigs=2, genome_len=30_000, n_reads=15_000,
        read_len=60)
    asm, sam = tmp_path / "s.fasta", tmp_path / "s.sam"
    asm.write_text(synth.fasta_text(fasta))
    sam.write_text(sam_text)
    args = (None, 0.2, 0.5, 10, 5, False, str(asm), [str(sam)])
    with contextlib.redirect_stderr(io.StringIO()):
        host = io.StringIO()
        polish(*args, out=host, backend="host")
        zero_launches()
        got = io.StringIO()
        n = grid[0] * grid[1]
        polish(*args, out=got, backend="sharded", device=cuda_device,
               mesh=make_mesh(*grid, devices=[cuda_device] * n),
               kernel_variant="lanes")
    assert got.getvalue() == host.getvalue()
    assert tvl.lanes_counts.launches == {"lanes_vote_packed4": 2 * n}
    assert tvl.overflow_counts.launches == tvc.chunk_counts.launches == 0


def test_pod_device_votes_on_gpu(cuda_device, tmp_path, monkeypatch):
    """The pod's device votes in one process (no group): kernel A once,
    the overflow kernel once when the pack has cap overflow, no chunk
    kernel, FASTA equal to the host backend's."""
    from polypolish_tpu_torch.pipeline.pod_distributed import (
        polish_pod_distributed,
    )

    fasta, sam_text = synth.make_polish_case(
        seed=44, genome_len=20_000, n_reads=20_000, read_len=60, err=0.15,
        multi_frac=0.5, n_draft_errors=40)
    asm, sam = tmp_path / "p.fasta", tmp_path / "p.sam"
    asm.write_text(synth.fasta_text(fasta))
    sam.write_text(sam_text)
    args = (None, 0.2, 0.5, 10, 5, False, str(asm), [str(sam)])
    monkeypatch.setenv("POLYPOLISH_TPU_POD_DEVICE_VOTES", "1")
    with contextlib.redirect_stderr(io.StringIO()):
        host = io.StringIO()
        polish(*args, out=host, backend="host")
        zero_launches()
        got = io.StringIO()
        polish_pod_distributed(*args, out=got, device=cuda_device)
    assert got.getvalue() == host.getvalue()
    assert tvl.lanes_counts.launches == {"lanes_vote_packed4": 1}
    assert tvl.overflow_counts.launches == _has_overflow(str(asm),
                                                         [str(sam)])
    assert tvc.chunk_counts.launches == 0
