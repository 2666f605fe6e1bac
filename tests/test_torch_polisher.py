"""Port models/polisher.py against polypolish_tpu/models/polisher.py:
``LanesPolisher.forward_pack`` on the CPU equals the JAX
``LanesPolisher(interpret=True)`` bitwise — counts, adopted ids and
statuses — on native packed4 packs with and without the cap-overflow
list, under both POLYPOLISH_TPU_OV_MODE values of the JAX side.
Tolerance: none."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polypolish_tpu.models.polisher import LanesPolisher as JaxPolisher
from polypolish_tpu_torch.models.polisher import LanesPolisher
from polypolish_tpu_torch.ops import consensus as tc
from polypolish_tpu_torch.ops.vote_lanes import prepare_lanes
from tests.torch_helpers import (
    parse_both,
    rand_events,
    write_polish_case,
)


def thresholds(depth, P_pad, seed):
    valid, invalid, low = tc.compute_thresholds(depth, 5, 0.5, 0.2)
    orig = np.random.default_rng(seed).integers(0, 8, size=depth.size)

    def pad(a, fill, dtype):
        out = np.full(P_pad, fill, dtype=dtype)
        out[:a.size] = a
        return out

    i32max = np.int32(2**31 - 1)
    return (pad(valid, i32max, np.int32), pad(invalid, i32max, np.int32),
            pad(low, True, bool), pad(orig, 0, np.int32))


def run_both(vb, bt, thr, P_pad, r_sub, tile_w, ov_pos, ov_vid,
             device="cpu"):
    jm = JaxPolisher(P_pad, r_sub=r_sub, tile_w=tile_w, interpret=True,
                     body="packed4")
    want = [np.asarray(x) for x in jm.forward_pack(
        vb, bt, *[jnp.asarray(t) for t in thr], ov_pos=ov_pos,
        ov_vid=ov_vid,
    )]
    tm = LanesPolisher(P_pad, device, r_sub=r_sub, tile_w=tile_w)
    got = [x.cpu().numpy() for x in tm.forward_pack(
        vb, bt, *[torch.from_numpy(t).to(device) for t in thr],
        ov_pos=ov_pos, ov_vid=ov_vid,
    )]
    return got, want


@pytest.mark.parametrize("ov_mode", ["scatter", "mxu"])
@pytest.mark.parametrize("cap", [False, True])
@pytest.mark.parametrize("seed", [31, 67])
def test_forward_pack_native_matches_jax(tmp_path, monkeypatch, seed, cap,
                                         ov_mode):
    monkeypatch.setenv("POLYPOLISH_TPU_OV_MODE", ov_mode)
    r_sub, tile_w, P_pad = 8, 256, 4096
    asm, sam = write_polish_case(tmp_path, seed=seed, genome_len=4000,
                                 n_reads=4000)
    (jr, tr), names, lens = parse_both(asm, [sam])
    name = names[0]
    pack = tr.lanes(name, r_sub, tile_w, num_positions=P_pad, packed4=True,
                    cap=cap)
    try:
        depth = tr.fold(name, want_counts=False)[1].copy()
        thr = thresholds(depth, P_pad, seed)
        if cap:
            assert (pack.ov_vid < 8).any(), "needs dense overflow events"
        got, want = run_both(pack.vb, pack.block_tile, thr, P_pad, r_sub,
                             tile_w, pack.ov_pos, pack.ov_vid)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(got[0][:, :lens[name]],
                                      tr.fold(name)[0])
    finally:
        pack.close()
        jr.close()
        tr.close()


@pytest.mark.parametrize("ov_mode", ["scatter", "mxu"])
def test_forward_pack_numpy_pack_matches_jax(monkeypatch, ov_mode):
    """A numpy-packed skewed pileup (uint8 rows, converted to packed4
    inside vote_counts) with a large overflow list."""
    monkeypatch.setenv("POLYPOLISH_TPU_OV_MODE", ov_mode)
    P, r_sub, tile_w = 4000, 8, 128
    pos, vocab = rand_events(120_000, P, 7, skew=True)
    vb, bt, n_tiles, ov_pos, ov_vid = prepare_lanes(
        pos, vocab, P, r_sub, tile_w, cap=True)
    assert ov_pos.size > 0
    depth = np.bincount(pos, minlength=P).astype(np.float64)
    P_pad = n_tiles * tile_w
    thr = thresholds(depth, P_pad, 7)
    got, want = run_both(vb, bt, thr, P_pad, r_sub, tile_w, ov_pos, ov_vid)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_rejects_unpacked_layouts():
    with pytest.raises(ValueError, match="r_sub"):
        LanesPolisher(4096, "cpu", r_sub=6)
    m = LanesPolisher(4096, "cpu", r_sub=8, tile_w=256)
    with pytest.raises(ValueError, match="packed4"):
        m.vote_counts(np.zeros((8, 256), np.int64), np.zeros(1, np.int32))
