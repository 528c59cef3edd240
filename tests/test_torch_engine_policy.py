"""The port's engine policy (prographmsa_tpu_torch/engine_policy.py): the
routing table of every engine, the calibrated threshold and cost models of
``auto``, and the calibration's persistence, spot check and re-probe.  The
calibration is injected: these tests need no card.  The counterpart of
tests/test_engine_policy.py.
"""

import json
import math

import pytest
import torch

from prographmsa_tpu_torch import engine_policy as EP

DIRECT = {"roundtrip_s": 2e-5, "fetch_mbps": 9000.0, "device": "card"}
SLOW = {"roundtrip_s": 0.025, "fetch_mbps": 15.0, "device": "card"}


@pytest.fixture
def calib(monkeypatch):
    def use(c):
        monkeypatch.setattr(EP, "calibration", lambda: c)
    return use


@pytest.fixture
def card(monkeypatch, tmp_path):
    """A card named "card" and a calibration file of its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "card")
    monkeypatch.setattr(EP, "CALIB_PATH", str(tmp_path / "calib.json"))
    EP.calibration.cache_clear()
    yield tmp_path / "calib.json"
    EP.calibration.cache_clear()


# engine -> (DP batch, NW, prealigned, angle Gram, CS mix) on the card,
# for a workload that auto's models send to the card
ROUTES = {"torch": (True, True, True, False, False),
          "device": (True, True, True, True, True),
          "auto": (True, True, True, False, False),
          "native": (False, False, False, False, False)}


@pytest.mark.parametrize("engine", list(ROUTES))
def test_routing_table(engine, calib):
    calib(DIRECT)
    got = (EP.use_torch_dp(engine, 10 ** 9),
           EP.use_device_nw(engine, 124750, 300, 20),
           EP.use_device_prealigned(engine, 124750, 600, 20),
           EP.use_device_angle(engine), EP.use_device_cs(engine))
    assert got == ROUTES[engine]
    assert EP.needs_card(engine) == (engine != "native")


@pytest.mark.parametrize("engine", ["torch", "device", "native"])
def test_forced_engines_ignore_the_workload(engine, calib):
    calib(SLOW)
    on = engine != "native"
    assert EP.use_torch_dp(engine, 1) == on
    assert EP.use_device_nw(engine, 1, 2, 20) == on
    assert EP.use_device_prealigned(engine, 1, 2, 20) == on


def test_unknown_engine_raises():
    for fn in (EP.use_torch_dp, EP.use_device_nw, EP.use_device_prealigned,
               EP.use_device_angle, EP.use_device_cs, EP.needs_card):
        with pytest.raises(ValueError):
            fn("pallas")


def test_engine_device(monkeypatch):
    assert EP.engine_device("native", "cuda") is None
    assert EP.engine_device("torch", "cpu").type == "cpu"
    assert EP.engine_device("device", "cpu").type == "cpu"
    with pytest.raises(RuntimeError, match="--engine auto"):
        EP.engine_device("auto", "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        EP.engine_device("torch", "cuda")


def test_threshold_scales_with_link_cost(calib):
    calib(SLOW)
    slow = EP.cells_threshold()
    calib(DIRECT)
    fast = EP.cells_threshold()
    assert fast == EP.MIN_LEVEL_CELLS
    assert slow > 20 * fast
    assert slow == pytest.approx(EP.NATIVE_CELLS_PER_SEC * 2 * (
        6 * 0.025 + 1 / 15.0))


def test_use_torch_dp_regimes(calib):
    calib(DIRECT)
    assert EP.use_torch_dp("auto", level_cells=2_000_000)
    assert not EP.use_torch_dp("auto", level_cells=10_000)
    calib(SLOW)
    big = math.ceil(EP.cells_threshold())
    assert not EP.use_torch_dp("auto", level_cells=2_000_000)
    assert EP.use_torch_dp("auto", level_cells=big)


def test_auto_nw_and_prealigned_models(calib):
    calib(DIRECT)
    # all pairs of 500 sequences of 300: the card
    assert EP.use_device_nw("auto", 124750, 300, 20)
    assert EP.use_device_prealigned("auto", 124750, 600, 20)
    # an unknown workload goes to the card
    assert EP.use_device_nw("auto") and EP.use_device_prealigned("auto")
    # a slow link and one short pair: the host
    calib(SLOW)
    assert not EP.use_device_nw("auto", 1, 20, 20)
    assert not EP.use_device_prealigned("auto", 1, 20, 20)


def test_calibration_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    EP.calibration.cache_clear()
    with pytest.raises(RuntimeError, match="is_available"):
        EP.calibration()
    EP.calibration.cache_clear()


def test_calibration_probes_and_persists(card, monkeypatch):
    fresh = {"roundtrip_s": 3e-5, "fetch_mbps": 8000.0}
    monkeypatch.setattr(EP, "_probe_all", lambda: dict(fresh))
    got = EP.calibration()
    assert got == dict(fresh, device="card")
    assert json.loads(card.read_text()) == got


def test_calibration_trusts_a_persisted_probe_that_agrees(card,
                                                          monkeypatch):
    pre = {"roundtrip_s": 3e-5, "fetch_mbps": 8000.0, "device": "card"}
    card.write_text(json.dumps(pre))
    monkeypatch.setattr(EP, "_probe_roundtrip", lambda reps=5: 5e-5)
    monkeypatch.setattr(EP, "_probe_all", lambda: pytest.fail("re-probed"))
    assert EP.calibration() == pre


@pytest.mark.parametrize("bad", [
    {"roundtrip_s": 0.4, "fetch_mbps": 2.0, "device": "card"},  # spot check
    {"roundtrip_s": 3e-5, "fetch_mbps": 8000.0, "device": "other card"},
    {"roundtrip_s": 3e-5, "fetch_mbps": 0.0, "device": "card"},  # range
    "not json"])
def test_calibration_reprobes_a_bad_persist(card, monkeypatch, bad):
    card.write_text(bad if isinstance(bad, str) else json.dumps(bad))
    fresh = {"roundtrip_s": 2e-5, "fetch_mbps": 9000.0}
    monkeypatch.setattr(EP, "_probe_roundtrip", lambda reps=5: 2e-5)
    monkeypatch.setattr(EP, "_probe_all", lambda: dict(fresh))
    assert EP.calibration() == dict(fresh, device="card")
    assert json.loads(card.read_text()) == dict(fresh, device="card")


def test_rates_are_measured():
    """Every rate the models divide by is set (chip_smoke.py, phase
    rates, measures them on the card's host)."""
    for name in ("NW_DEVICE_RATE", "NW_NATIVE_RATE", "PAIR_STATS_DEVICE_RATE",
                 "PAIR_STATS_HOST_RATE", "NATIVE_CELLS_PER_SEC"):
        assert getattr(EP, name) > 0, name
    assert not hasattr(EP, "FETCH_COMPRESS")
