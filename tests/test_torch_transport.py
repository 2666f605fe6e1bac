"""The port's ``--backend auto`` (utils/transport.py and the CLI's
_resolve_backend) against polypolish_tpu's, on the cost-model cases of
tests/test_transport.py: with the same calibration constants patched
into both modules and the same link, both pick the same backend (the
JAX package's "pallas" is the port's "device") and predict the same
seconds.  Without a GPU ``auto`` resolves to host."""

import sys

import pytest
import torch

import polypolish_tpu.utils.transport as jt
import polypolish_tpu_torch.utils.transport as tt
from polypolish_tpu.cli import _resolve_backend as jax_resolve
from polypolish_tpu_torch.cli import _resolve_backend as port_resolve

CONSTANTS = ("HOST_ENGINE_BYTES_PER_S", "PARSE_SPEEDUP", "UPLOAD_FRACTION",
             "N_DISPATCH", "KERNEL_EPS_S")
JAX_CONSTANTS = {k: getattr(jt, k) for k in CONSTANTS}
PORT_CONSTANTS = {k: getattr(tt, k) for k in CONSTANTS}


@pytest.fixture(autouse=True)
def _reset(monkeypatch):
    for mod in (jt, tt):
        monkeypatch.setattr(mod, "_cached_grade", None)
        monkeypatch.setattr(mod, "_cached_link", None)
    monkeypatch.delenv("POLYPOLISH_TPU_TRANSPORT", raising=False)
    monkeypatch.delenv("POLYPOLISH_TPU_HOST_RATE", raising=False)


def _patch_constants(monkeypatch, constants):
    for mod in (jt, tt):
        for k, v in constants.items():
            monkeypatch.setattr(mod, k, v)


class _FakeDev:
    platform = "tpu"


class _FakeJax:
    @staticmethod
    def devices():
        return [_FakeDev()]


def _fake_link(monkeypatch, bw, lat):
    """The same measured link in both: a TPU for the JAX package, a GPU
    for the port."""
    monkeypatch.setitem(sys.modules, "jax", _FakeJax)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for mod in (jt, tt):
        monkeypatch.setattr(mod, "measure_link",
                            lambda refresh=False, **kw: (bw, lat))
        monkeypatch.setattr(mod, "measure_device_bandwidth",
                            lambda *a, **kw: bw)


def _port_choice(choice):
    return {"pallas": "device"}.get(choice, choice)


def test_explicit_backend_passes_through():
    for b in ("host", "xla", "device"):
        assert port_resolve(b) == b


def test_auto_without_gpu_is_host(capsys):
    assert port_resolve("auto", device="cpu") == "host"
    assert tt.transport_grade(device="cpu") == "none"
    assert tt.predict_backend(1 << 30, device="cpu") == (
        "host", {"reason": "no accelerator"})
    if not torch.cuda.is_available():
        assert port_resolve("auto") == "host"
        assert tt.transport_grade() == "none"
    assert capsys.readouterr().err == ""


def test_auto_link_probe_failure_raises(monkeypatch):
    """With a GPU in use, a failing link probe raises instead of
    resolving to the host backend without a word."""
    def broken(refresh=False, **kw):
        raise RuntimeError("link probe failed")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(tt, "measure_link", broken)
    monkeypatch.setattr(tt, "measure_device_bandwidth", broken)
    with pytest.raises(RuntimeError, match="link probe failed"):
        port_resolve("auto", ["x"])
    with pytest.raises(RuntimeError, match="link probe failed"):
        tt.transport_grade(refresh=True)


LINKS = [
    ("slow", 100e6, 0.25, 760 << 20),
    ("fast", 12e9, 5e-5, 760 << 20),
    ("tunnel band", 1.3e9, 0.15, 760 << 20),
    ("pcie", 8e9, 5e-5, 760 << 20),
    ("ecoli", 9e9, 3e-5, 540 << 20),
    ("boundary low", None, 0.0, 1 << 30),
    ("boundary high", None, 0.0, 1 << 30),
]


@pytest.mark.parametrize("constants", ["jax", "port"])
@pytest.mark.parametrize("label,bw,lat,sam_bytes", LINKS,
                         ids=[x[0] for x in LINKS])
def test_cost_model_matches_jax(monkeypatch, capsys, constants, label, bw,
                                lat, sam_bytes):
    consts = JAX_CONSTANTS if constants == "jax" else PORT_CONSTANTS
    _patch_constants(monkeypatch, consts)
    if bw is None:  # either side of predicted equality at zero latency
        h = consts["HOST_ENGINE_BYTES_PER_S"]
        bw = (1.2 if label == "boundary low" else 4.0) * h
    _fake_link(monkeypatch, bw, lat)
    got = tt.predict_backend(sam_bytes)
    want = jt.predict_backend(sam_bytes)
    assert got[0] == _port_choice(want[0])
    assert got[1] == want[1]
    assert tt.transport_grade(refresh=True) == jt.transport_grade(
        refresh=True)
    assert port_resolve("auto", ["x"]) == _port_choice(jax_resolve("auto"))
    err = capsys.readouterr().err
    # the note names the card: the one stderr difference
    assert ("note: GPU attached" in err) == ("note: TPU attached" in err)


@pytest.mark.parametrize("override", ["fast", "slow"])
@pytest.mark.parametrize("constants", ["jax", "port"])
def test_env_override_matches_jax(monkeypatch, override, constants):
    _patch_constants(monkeypatch,
                     JAX_CONSTANTS if constants == "jax" else PORT_CONSTANTS)
    monkeypatch.setenv("POLYPOLISH_TPU_TRANSPORT", override)
    monkeypatch.setenv("POLYPOLISH_TPU_HOST_RATE", "700e6")
    got, want = tt.predict_backend(540 << 20), jt.predict_backend(540 << 20)
    assert got[0] == _port_choice(want[0]) and got[1] == want[1]
    assert tt.transport_grade() == jt.transport_grade() == override


def test_mean_job_size_matches_jax(monkeypatch, tmp_path):
    """batch: the model runs on the mean job's SAM bytes."""
    _patch_constants(monkeypatch, JAX_CONSTANTS)
    _fake_link(monkeypatch, 2.0e9, 1e-3)
    jobs = []
    for i, size in enumerate((10 << 20, 3000 << 20, 0)):
        p = tmp_path / f"s{i}.sam"
        with open(p, "wb") as f:
            f.truncate(size)
        jobs.append([str(p)])
    for sample in (jobs, jobs[:1], jobs[1:2]):
        assert port_resolve("auto", mean_job_sams=sample) == _port_choice(
            jax_resolve("auto", mean_job_sams=sample))


def test_measure_link_runs_on_cpu():
    bw = tt.measure_device_bandwidth(size_bytes=1 << 16, device="cpu")
    assert bw > 0
    bw, lat = tt.measure_link(refresh=True, device="cpu")
    assert bw > 0 and lat >= 0


def test_measure_link_jitter_guard(monkeypatch):
    """A tiny probe slower than the large one must not make the
    bandwidth absurd: the payload time is at least half the large
    probe's wall time (the JAX package's guard)."""
    times = iter([0.004, 0.003, 0.005, 0.002, 0.002])
    monkeypatch.setattr(tt, "_copy_s", lambda buf, device: next(times))
    bw, lat = tt.measure_link(refresh=True, device="cpu")
    assert lat == 0.003
    assert bw == (4 << 20) / 0.001
