"""Port models/polisher.py against polypolish_tpu/models/polisher.py:
``LanesPolisher.forward_pack`` on the CPU equals the JAX
``LanesPolisher(interpret=True)`` bitwise — counts, adopted ids and
statuses — on native packed4 and byte-row packs with and without the
cap-overflow list, with the JAX side under each value of
POLYPOLISH_TPU_OV_MODE (scatter, mxu, unset) and the port on its one
route, checked by the calls it makes to its kernel wrappers;
``PolisherModel`` equals the JAX ``PolisherModel(interpret=True)`` with
and without the kernel, on numpy-packed and native uint8 chunks.
Tolerance: none."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polypolish_tpu.models.polisher import LanesPolisher as JaxPolisher
from polypolish_tpu.models.polisher import PolisherModel as JaxModel
from polypolish_tpu.models.polisher import (
    example_inputs as jax_example_inputs,
)
from polypolish_tpu_torch.models.polisher import (
    LanesPolisher,
    PolisherModel,
    example_inputs,
)
from polypolish_tpu_torch.ops import consensus as tc
from polypolish_tpu_torch.ops.vote_lanes import prepare_lanes
from tests.torch_helpers import (
    count_polisher_calls,
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


@pytest.fixture
def wrapper_calls(monkeypatch):
    return count_polisher_calls(monkeypatch)


def set_ov_mode(monkeypatch, ov_mode):
    if ov_mode is None:
        monkeypatch.delenv("POLYPOLISH_TPU_OV_MODE", raising=False)
    else:
        monkeypatch.setenv("POLYPOLISH_TPU_OV_MODE", ov_mode)


def route_calls(has_overflow):
    """The wrapper calls of one vote_counts, whatever
    POLYPOLISH_TPU_OV_MODE says: kernel A once, then the overflow kernel
    when there are overflow events; never the chunk kernel."""
    want = {"lanes_counts": 1}
    if has_overflow:
        want["overflow_counts"] = 1
    return want


OV_MODES = ["scatter", "mxu", None]


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


@pytest.mark.parametrize("ov_mode", OV_MODES)
@pytest.mark.parametrize("cap", [False, True])
@pytest.mark.parametrize("seed", [31, 67])
def test_forward_pack_native_matches_jax(tmp_path, monkeypatch,
                                         wrapper_calls, seed, cap,
                                         ov_mode):
    set_ov_mode(monkeypatch, ov_mode)
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
        assert dict(wrapper_calls) == route_calls(pack.n_overflow > 0)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(got[0][:, :lens[name]],
                                      tr.fold(name)[0])
    finally:
        pack.close()
        jr.close()
        tr.close()


@pytest.mark.parametrize("ov_mode", OV_MODES)
def test_forward_pack_numpy_pack_matches_jax(monkeypatch, wrapper_calls,
                                             ov_mode):
    """A numpy-packed skewed pileup (uint8 rows, converted to packed4
    inside vote_counts) with a large overflow list."""
    set_ov_mode(monkeypatch, ov_mode)
    P, r_sub, tile_w = 4000, 8, 128
    pos, vocab = rand_events(120_000, P, 7, skew=True)
    vb, bt, n_tiles, ov_pos, ov_vid = prepare_lanes(
        pos, vocab, P, r_sub, tile_w, cap=True)
    assert ov_pos.size > 0
    depth = np.bincount(pos, minlength=P).astype(np.float64)
    P_pad = n_tiles * tile_w
    thr = thresholds(depth, P_pad, 7)
    got, want = run_both(vb, bt, thr, P_pad, r_sub, tile_w, ov_pos, ov_vid)
    assert dict(wrapper_calls) == route_calls(True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_ov_mode_is_read_at_every_call(monkeypatch, wrapper_calls):
    """One LanesPolisher under POLYPOLISH_TPU_OV_MODE changed between
    calls (mxu, scatter, an unknown value, unset) keeps the overflow
    kernel for the overflow and gives bitwise the JAX LanesPolisher's counts
    under the same value; the JAX package takes an unknown value for its
    default."""
    P, r_sub, tile_w = 3000, 8, 128
    pos, vocab = rand_events(60_000, P, 5, skew=True)
    vb, bt, n_tiles, ov_pos, ov_vid = prepare_lanes(
        pos, vocab, P, r_sub, tile_w, cap=True)
    assert ov_pos.size > 0
    model = LanesPolisher(n_tiles * tile_w, "cpu", r_sub=r_sub,
                          tile_w=tile_w)
    jm = JaxPolisher(n_tiles * tile_w, r_sub=r_sub, tile_w=tile_w,
                     interpret=True, body="packed4")
    for mode in ("mxu", "scatter", "unknown", None):
        set_ov_mode(monkeypatch, mode)
        wrapper_calls.clear()
        got = model.vote_counts(vb, bt, ov_pos, ov_vid)
        assert dict(wrapper_calls) == route_calls(True)
        assert set(model.timer.seconds) == {"upload", "kernel_a",
                                            "kernel_b"}
        want = np.asarray(jm.vote_counts(vb, bt, ov_pos, ov_vid))
        np.testing.assert_array_equal(got.numpy(), want)


def test_rejects_unpacked_layouts(tmp_path, monkeypatch):
    """r_sub % 4 != 0 falls to the byte-row body 'packed' (the lanes
    vote kernel's byte entry point), as the JAX LanesPolisher does:
    bitwise equal to JaxPolisher(r_sub=6) on a native byte pack with an
    overflow list.  The packed8 body and rows of the wrong type are
    refused."""
    monkeypatch.setenv("POLYPOLISH_TPU_OV_MODE", "scatter")
    r_sub, tile_w, P_pad = 6, 256, 4096
    assert LanesPolisher(P_pad, "cpu", r_sub=r_sub).body == "packed"
    asm, sam = write_polish_case(tmp_path, seed=31, genome_len=4000,
                                 n_reads=4000)
    (jr, tr), names, lens = parse_both(asm, [sam])
    name = names[0]
    pack = tr.lanes(name, r_sub, tile_w, num_positions=P_pad, cap=True)
    try:
        assert pack.vb.dtype == np.uint8 and (pack.ov_vid < 8).any()
        depth = tr.fold(name, want_counts=False)[1].copy()
        thr = thresholds(depth, P_pad, 31)
        jm = JaxPolisher(P_pad, r_sub=r_sub, tile_w=tile_w, interpret=True)
        assert jm.body == "packed"
        want = [np.asarray(x) for x in jm.forward_pack(
            pack.vb, pack.block_tile, *[jnp.asarray(t) for t in thr],
            ov_pos=pack.ov_pos, ov_vid=pack.ov_vid)]
        tm = LanesPolisher(P_pad, "cpu", r_sub=r_sub, tile_w=tile_w)
        got = [x.numpy() for x in tm.forward_pack(
            pack.vb, pack.block_tile, *[torch.from_numpy(t) for t in thr],
            ov_pos=pack.ov_pos, ov_vid=pack.ov_vid)]
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(got[0][:, :lens[name]],
                                      tr.fold(name)[0])
    finally:
        pack.close()
        jr.close()
        tr.close()
    with pytest.raises(ValueError, match="dense_counts_lanes"):
        LanesPolisher(4096, "cpu", body="packed8")
    m = LanesPolisher(4096, "cpu", r_sub=8, tile_w=256)
    with pytest.raises(ValueError, match="packed4"):
        m.vote_counts(np.zeros((8, 256), np.int64), np.zeros(1, np.int32))
    m = LanesPolisher(4096, "cpu", r_sub=8, tile_w=256, body="cmp")
    with pytest.raises(ValueError, match="byte rows"):
        m.vote_counts(np.zeros((2, 256), np.int32), np.zeros(1, np.int32))


@pytest.mark.parametrize("body", ["packed", "cmp"])
def test_byte_bodies_match_jax(monkeypatch, body):
    """LanesPolisher on byte rows (bodies packed and cmp) against the
    JAX LanesPolisher with the same body."""
    monkeypatch.setenv("POLYPOLISH_TPU_OV_MODE", "scatter")
    P, r_sub, tile_w = 3000, 8, 128
    pos, vocab = rand_events(60_000, P, 3, sparse_frac=0.05, skew=True)
    vb, bt, n_tiles, ov_pos, ov_vid = prepare_lanes(
        pos, vocab, P, r_sub, tile_w, cap=True)
    P_pad = n_tiles * tile_w
    depth = np.bincount(pos, minlength=P_pad).astype(np.float64)
    thr = thresholds(depth, P_pad, 3)
    jm = JaxPolisher(P_pad, r_sub=r_sub, tile_w=tile_w, interpret=True,
                     body=body)
    want = [np.asarray(x) for x in jm.forward_pack(
        vb, bt, *[jnp.asarray(t) for t in thr], ov_pos=ov_pos,
        ov_vid=ov_vid)]
    tm = LanesPolisher(P_pad, "cpu", r_sub=r_sub, tile_w=tile_w, body=body)
    got = [x.numpy() for x in tm.forward_pack(
        vb.view(np.int8), bt, *[torch.from_numpy(t) for t in thr],
        ov_pos=ov_pos, ov_vid=ov_vid)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _model_inputs(P, n, seed):
    pos, vocab = rand_events(n, P, seed, sparse_frac=0.05)
    depth = np.bincount(pos, minlength=P).astype(np.float64)
    return pos, vocab, thresholds(depth, P, seed)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_polisher_model_numpy_pack_matches_jax(use_kernel):
    """PolisherModel.pack (int16 positions, int8 vocab, widened in
    forward) and forward, with the chunk vote kernel's plain version or
    the scatter twin, against the JAX PolisherModel(interpret=True)."""
    P = 4096
    pos, vocab, thr = _model_inputs(P, 30_000, 13)
    jm = JaxModel(P, use_pallas=use_kernel, interpret=True)
    jargs = jm.pack(pos, vocab)
    want = [np.asarray(x) for x in jm.forward_jit(
        *jargs, *[jnp.asarray(t) for t in thr])]
    tm = PolisherModel(P, "cpu", use_kernel=use_kernel)
    targs = tm.pack(pos, vocab)
    assert [a.dtype for a in targs] == [torch.int16, torch.int8,
                                        torch.int32]
    for a, b in zip(targs, jargs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    got = [x.numpy() for x in tm(*targs,
                                 *[torch.from_numpy(t) for t in thr])]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_polisher_model_native_chunks_match_jax(tmp_path, use_kernel):
    """PolisherModel on the native uint8 chunk layout (pad vocab 255),
    as the mxu and xla polish paths feed it: equal to the JAX model and
    to the C++ fold."""
    P_pad = 4096
    asm, sam = write_polish_case(tmp_path, seed=67, genome_len=4000,
                                 n_reads=4000)
    (jr, tr), names, lens = parse_both(asm, [sam])
    name = names[0]
    try:
        ch = tr.chunks(name, 256, 8, num_positions=P_pad)
        depth = tr.fold(name, want_counts=False)[1].copy()
        thr = thresholds(depth, P_pad, 67)
        jm = JaxModel(P_pad, use_pallas=use_kernel, interpret=True)
        want = [np.asarray(x) for x in jm.forward_jit(
            *[jnp.asarray(a) for a in ch[:3]],
            *[jnp.asarray(t) for t in thr])]
        tm = PolisherModel(P_pad, "cpu", use_kernel=use_kernel)
        got = [x.numpy() for x in tm(
            *[torch.from_numpy(a) for a in ch[:3]],
            *[torch.from_numpy(t) for t in thr])]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(got[0][:, :lens[name]],
                                      tr.fold(name)[0])
    finally:
        jr.close()
        tr.close()


def test_example_inputs_match_jax():
    jm, jargs = jax_example_inputs(num_positions=4096, n_events=20_000,
                                   seed=2)
    tm, targs = example_inputs(num_positions=4096, n_events=20_000,
                               seed=2, device="cpu")
    assert tm.num_positions == jm.num_positions and tm.n_tiles == jm.n_tiles
    for a, b in zip(targs, jargs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    want = [np.asarray(x) for x in jm.forward_jit(*jargs)]
    got = [x.numpy() for x in tm(*targs)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
