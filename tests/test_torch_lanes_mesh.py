"""``ParsedRuns.lanes_mesh`` (the one-call native mesh packer,
pp_lanes_mesh) of the port against polypolish_tpu's, and its counts
through the port's ``sharded_step_lanes`` (kernel A's plain version per
cell) against the host fold: packed4 and uint8 layouts, four grid
shapes, the deep-shard slab rounding and thread invariance."""

import numpy as np
import pytest

import tests.synth as synth
from polypolish_tpu_torch.ops.vote_lanes import (
    MAX_BLOCKS_PER_CALL,
    lanes_counts,
    to_packed4,
)
from polypolish_tpu_torch.parallel import make_mesh
from polypolish_tpu_torch.parallel.shard import sharded_step_lanes
from tests.torch_helpers import parse_both

R_SUB, TILE_W = 8, 256
GRIDS = [(1, 8), (2, 4), (4, 2), (8, 1)]


@pytest.fixture
def parsed(tmp_path):
    """Parse a synth case with both packages: ((jax, port), names, lens);
    closes both on exit."""
    made = []

    def make(seed=21, genome_len=6000, n_reads=3000):
        fasta, sam_text = synth.make_polish_case(
            seed=seed, genome_len=genome_len, n_reads=n_reads, read_len=60,
            err=0.08, multi_frac=0.4,
        )
        asm = tmp_path / f"a{seed}.fasta"
        asm.write_text(synth.fasta_text(fasta))
        sam = tmp_path / f"a{seed}.sam"
        sam.write_text(sam_text)
        out = parse_both(asm, [sam])
        made.append(out[0])
        return out

    yield make
    for pair in made:
        for pr in pair:
            pr.close()


def _assert_packs_equal(got, want):
    assert got[2:] == want[2:]
    assert got[0].dtype == want[0].dtype and got[1].dtype == want[1].dtype
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("packed4", [False, True])
def test_mesh_pack_matches_jax_and_counts_bitwise(parsed, grid, packed4):
    (jr, tr), names, lens = parsed()
    name, P = names[0], lens[names[0]]
    got = tr.lanes_mesh(name, *grid, R_SUB, TILE_W, packed4=packed4)
    want = jr.lanes_mesh(name, *grid, R_SUB, TILE_W, packed4=packed4)
    assert got is not None
    _assert_packs_equal(got, want)
    vb, bt, p_shard, n_tiles = got
    assert vb.shape[:2] == grid
    assert p_shard % TILE_W == 0 and p_shard * grid[1] >= P

    mesh = make_mesh(*grid, devices=["cpu"] * (grid[0] * grid[1]))
    empty = np.zeros(0)
    counts, _, _ = sharded_step_lanes(
        mesh, vb if packed4 else vb.view(np.int8), bt, p_shard, n_tiles,
        empty.astype(np.int32), empty.astype(np.int32), empty.astype(bool),
        empty.astype(np.int32), r_sub=R_SUB, tile_w=TILE_W,
        body="packed4" if packed4 else "cmp")
    np.testing.assert_array_equal(counts[:, :P].numpy(), tr.fold(name)[0])
    assert int(counts[:, P:].abs().sum()) == 0


def test_mesh_pack_padded_positions_match_jax(parsed):
    """num_positions past the contig (the sharded backend's geometric
    position bucket) pads every shard the same in both packages."""
    (jr, tr), names, lens = parsed(seed=5)
    name = names[0]
    for grid in ((1, 1), (2, 2)):
        got = tr.lanes_mesh(name, *grid, 32, 2048, num_positions=8192,
                            packed4=True)
        want = jr.lanes_mesh(name, *grid, 32, 2048, num_positions=8192,
                             packed4=True)
        _assert_packs_equal(got, want)


def test_mesh_pack_native_packed4_layout(parsed):
    """The native packed4 mesh buffers equal to_packed4() of the native
    uint8 ones."""
    (_, tr), names, _ = parsed(seed=13)
    name = names[0]
    vb_u8, bt_u8, p_shard, n_tiles = tr.lanes_mesh(name, 2, 4, R_SUB,
                                                   TILE_W, packed4=False)
    vb_p4, bt_p4, p_shard2, n_tiles2 = tr.lanes_mesh(name, 2, 4, R_SUB,
                                                     TILE_W, packed4=True)
    assert (p_shard, n_tiles) == (p_shard2, n_tiles2)
    np.testing.assert_array_equal(bt_u8, bt_p4)
    assert vb_p4.dtype == np.int32
    for d in range(2):
        for s in range(4):
            np.testing.assert_array_equal(vb_p4[d, s],
                                          to_packed4(vb_u8[d, s], R_SUB))


def test_mesh_pack_deep_shard_slab_rounding(tmp_path):
    """A shard deeper than MAX_BLOCKS_PER_CALL blocks comes back
    slab-rounded in both packages, and lanes_counts counts it in one
    call (the port's kernel takes any block count; the JAX package's
    _lanes_call splits it into slabs): the host fold's counts."""
    from polypolish_tpu.native import runs as jax_runs
    from polypolish_tpu.vocab import Vocab as JaxVocab
    from polypolish_tpu_torch.native import runs as port_runs
    from polypolish_tpu_torch.vocab import Vocab

    import torch

    r_sub = 4
    seq = "ACGT" * 32  # 128 bp contig -> one 128-wide tile
    n_reads = r_sub * MAX_BLOCKS_PER_CALL + 40  # rows > 131072
    lines = ["@SQ\tSN:c\tLN:128"]
    for i in range(n_reads):
        lines.append(f"r{i}\t0\tc\t1\t60\t128M\t*\t0\t0\t{seq}\t*\tNM:i:0")
    sam = tmp_path / "deep.sam"
    sam.write_text("\n".join(lines) + "\n")
    tr = port_runs.parse_runs([str(sam)], ["c"], {"c": 128}, Vocab(), 10,
                              False)
    jr = jax_runs.parse_runs([str(sam)], ["c"], {"c": 128}, JaxVocab(), 10,
                             False)
    try:
        got = tr.lanes_mesh("c", 1, 1, r_sub, 128, packed4=True)
        _assert_packs_equal(got, jr.lanes_mesh("c", 1, 1, r_sub, 128,
                                               packed4=True))
        vb, bt, _, n_tiles = got
        B = bt.shape[2]
        assert B > MAX_BLOCKS_PER_CALL and B % MAX_BLOCKS_PER_CALL == 0
        counts = lanes_counts(torch.from_numpy(vb[0, 0]),
                              torch.from_numpy(bt[0, 0]), n_tiles, r_sub,
                              128)
        np.testing.assert_array_equal(counts.numpy(), tr.fold("c")[0])
    finally:
        tr.close()
        jr.close()


def test_mesh_pack_thread_invariant(parsed):
    (_, tr), names, _ = parsed(seed=8)
    name = names[0]
    ref = None
    for n_threads in (1, 2, 4):
        vb, bt, _, _ = tr.lanes_mesh(name, 4, 2, R_SUB, TILE_W,
                                     n_threads=n_threads)
        if ref is None:
            ref = (vb, bt)
        else:
            np.testing.assert_array_equal(vb, ref[0])
            np.testing.assert_array_equal(bt, ref[1])


def test_mesh_pack_bad_arguments_give_none(parsed):
    (_, tr), names, _ = parsed(seed=9)
    assert tr.lanes_mesh(names[0], 2, 2, 6, TILE_W, packed4=True) is None
    assert tr.lanes_mesh(names[0], 0, 2, R_SUB, TILE_W) is None
