"""chamjax_torch's experiment tooling on the CPU against chamjax's: the
experiment config read from ``configs/*.yaml``, the result store (each
package reads the other's files) and energy accounting (RAPL copied; the
card's board power in place of a TPU's TDP, read from ``nvidia-smi`` or
given)."""

import subprocess
import time
from pathlib import Path

import pytest

from chamjax.config import ExperimentConfig as JExperimentConfig
from chamjax.utils import ResultStore as JResultStore
from chamjax.utils.energy import queries_per_joule as j_queries_per_joule
from chamjax.utils.energy import tpu_efficiency

from chamjax_torch import config as tconfig
from chamjax_torch.utils import ResultStore
from chamjax_torch.utils import device as tdevice
from chamjax_torch.utils.energy import (RaplMeter, card_efficiency,
                                        card_energy_estimate,
                                        queries_per_joule)

REPO = Path(__file__).resolve().parents[1]
YAMLS = sorted(p.name for p in (REPO / "configs").glob("*.yaml"))


# --- config ------------------------------------------------------------------


def test_five_experiment_files():
    assert YAMLS == ["Dec-L.yaml", "Dec-S.yaml", "EncDec-L.yaml",
                     "EncDec-S.yaml", "vector_search.yaml"]


@pytest.mark.parametrize("name", YAMLS)
def test_from_yaml_equals_chamjax(name):
    path = str(REPO / "configs" / name)
    got = tconfig.ExperimentConfig.from_yaml(path)
    assert got.to_dict() == JExperimentConfig.from_yaml(path).to_dict()
    assert isinstance(got.mesh, tconfig.MeshConfig)
    assert isinstance(got.service, tconfig.ServiceConfig)


def test_coerce_drops_unknown_keys():
    m = tconfig._coerce(tconfig.MeshConfig, {"data": 2, "lists": 4,
                                             "pods": 9})
    assert m == tconfig.MeshConfig(data=2, lists=4)
    e = tconfig.ExperimentConfig.from_dict(
        {"service": {"port": 9, "nope": 1}, "seed": 3, "extra": {}})
    assert (e.service.port, e.seed, e.dbname) == (9, 3, "SIFT1M")
    assert e.to_dict() == JExperimentConfig.from_dict(
        {"service": {"port": 9, "nope": 1}, "seed": 3,
         "extra": {}}).to_dict()


def test_default_experiment_equals_chamjax():
    assert (tconfig.ExperimentConfig().to_dict()
            == JExperimentConfig().to_dict())


# --- result store (counterparts of tests/test_utils.py) ------------------------


def test_result_store_roundtrip(tmp_path):
    path = str(tmp_path / "res.pkl")
    s = ResultStore(path)
    key = ("SIFT1M", "IVF1024,PQ16", "1gpu", 100, 32, 8)
    assert s.should_run(key)
    s.put(key, {"QPS": 1000.0, "R@10": 0.9})
    s.save()

    # reload: cached point is skipped unless overwrite
    s2 = ResultStore(path, load=True, overwrite=False)
    assert not s2.should_run(key)
    assert s2.get(key)["QPS"] == 1000.0
    s3 = ResultStore(path, load=True, overwrite=True)
    assert s3.should_run(key)

    # update merges metrics into an existing leaf
    s2.update(key, latency_ms=1.5)
    assert s2.get(key)["latency_ms"] == 1.5
    assert s2.get(key)["R@10"] == 0.9

    # walk yields leaves
    leaves = list(s2.walk())
    assert len(leaves) == 1
    assert leaves[0][0] == tuple(str(k) for k in key)

    # json sidecar written
    s2.save()
    assert (tmp_path / "res.pkl.json").exists()


def test_result_store_no_load(tmp_path):
    path = str(tmp_path / "res.pkl")
    ResultStore(path).put(("a",), {"x": 1})
    s = ResultStore(path, load=False)
    assert s.d == {}


@pytest.mark.parametrize("writer, reader", [(ResultStore, JResultStore),
                                            (JResultStore, ResultStore)],
                         ids=["port_to_chamjax", "chamjax_to_port"])
def test_result_store_read_by_the_other_package(tmp_path, writer, reader):
    path = str(tmp_path / "res.pkl")
    w = writer(path)
    w.put(("nb1000000", "batch", 128), {"full_ms": 0.5, "qps": 256000.0})
    w.put(("nb1000000", "batch", 8), {"full_ms": 0.2})
    w.update(("nb1000000", "batch", 8), qps=40000.0)
    w.save()
    r = reader(path)
    assert list(r.walk()) == list(w.walk())
    assert r.d == w.d and not r.should_run(("nb1000000", "batch", 128))


# --- energy (counterparts of tests/test_energy.py) -----------------------------


def test_rapl_meter_graceful():
    with RaplMeter() as m:
        time.sleep(0.02)
    assert m.seconds >= 0.02
    if m.available and m.joules is not None:
        assert m.joules >= 0
        assert m.watts is not None and m.watts >= 0
    else:
        assert m.joules is None


def test_card_energy_estimate():
    est = card_energy_estimate(seconds=10.0, duty=0.5, n_cards=2,
                               watts=700.0)
    assert est == {"card": None, "n_cards": 2,
                   "seconds": 10.0, "assumed_watts": 700.0, "duty": 0.5,
                   "joules": 700.0 * 0.5 * 10.0 * 2}
    assert queries_per_joule(1000.0, 100.0) == 10.0
    assert queries_per_joule(1000.0, 0.0) != queries_per_joule(1000.0, 0.0)
    for args in ((1000.0, 100.0), (5.0, 3.0)):
        assert queries_per_joule(*args) == j_queries_per_joule(*args)


def test_rapl_meter_skips_subzones(tmp_path, monkeypatch):
    """Only package domains count: intel-rapl:0:0/:0:1 subzone counters
    are subsets of the intel-rapl:0 package counter."""
    for dom, e in (("intel-rapl:0", 1000), ("intel-rapl:0:0", 600),
                   ("intel-rapl:0:1", 300), ("intel-rapl:1", 2000)):
        d = tmp_path / dom
        d.mkdir()
        (d / "energy_uj").write_text(str(e))
    monkeypatch.setattr(RaplMeter, "SYS", str(tmp_path))
    m = RaplMeter()
    assert m.available
    assert [p.split("/")[-2] for p in m.domains] == ["intel-rapl:0",
                                                     "intel-rapl:1"]
    with m:
        for dom, e in (("intel-rapl:0", 4000), ("intel-rapl:0:0", 2600),
                       ("intel-rapl:1", 5000)):
            (tmp_path / dom / "energy_uj").write_text(str(e))
    assert m.joules == (3000 + 3000) / 1e6


def test_card_efficiency_block():
    eff = card_efficiency(85_000.0, watts=170.0)
    assert eff["assumed_watts"] == 170.0
    assert abs(eff["qps_per_watt"] - 500.0) < 0.1
    assert abs(eff["mj_per_query"] - 2.0) < 0.01
    # scales watts with cards, as the reference scales them with chips
    eff8 = card_efficiency(85_000.0, n_cards=8, watts=170.0)
    assert abs(eff8["qps_per_watt"] - 62.5) < 0.1
    # the same arithmetic as chamjax's block at the same board power
    want = tpu_efficiency(85_000.0, chip="v5e", n_chips=8, duty=0.7)
    got = card_efficiency(85_000.0, n_cards=8, duty=0.7, watts=170.0)
    assert ({k: got[k] for k in ("assumed_watts", "qps_per_watt",
                                 "mj_per_query")}
            == {k: want[k] for k in ("assumed_watts", "qps_per_watt",
                                     "mj_per_query")})
    assert set(got) == {"card", "n_cards"} | (set(want) - {"chip",
                                                           "n_chips"})


class FakeSmi:
    """``subprocess.run`` standing in for ``nvidia-smi``: records each call
    and prints ``stdout`` (or raises ``error``)."""

    def __init__(self, stdout="", error=None):
        self.stdout, self.error, self.calls = stdout, error, []

    def __call__(self, cmd, **kw):
        self.calls.append(cmd)
        if self.error is not None:
            raise self.error
        return subprocess.CompletedProcess(cmd, 0, stdout=self.stdout,
                                           stderr="")


def test_card_power_read_from_nvidia_smi(monkeypatch):
    smi = FakeSmi("NVIDIA H100 80GB HBM3, 690.00 W\n")
    monkeypatch.setattr(tdevice.subprocess, "run", smi)
    eff = card_efficiency(69_000.0, n_cards=2)
    assert eff["card"] == "NVIDIA H100 80GB HBM3"
    assert eff["assumed_watts"] == 1380.0
    assert eff["qps_per_watt"] == 50.0
    est = card_energy_estimate(seconds=2.0)
    assert (est["card"], est["assumed_watts"], est["joules"]) == (
        "NVIDIA H100 80GB HBM3", 690.0, 1380.0)
    # one nvidia-smi query a read, the one card_description makes
    assert smi.calls == [["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"]] * 2
    assert tdevice.card_description() == "NVIDIA H100 80GB HBM3, 690.00 W"
    # an explicit watts skips the read
    card_efficiency(1.0, watts=1.0)
    assert len(smi.calls) == 3


@pytest.mark.parametrize("smi, error", [
    (FakeSmi(error=FileNotFoundError("nvidia-smi")), FileNotFoundError),
    (FakeSmi(error=subprocess.CalledProcessError(9, "nvidia-smi")),
     subprocess.CalledProcessError),
    (FakeSmi("NVIDIA H100 80GB HBM3, [N/A]\n"), ValueError),
], ids=["missing", "fails", "no_limit"])
def test_card_power_read_failure_raises(monkeypatch, smi, error):
    monkeypatch.setattr(tdevice.subprocess, "run", smi)
    with pytest.raises(error):
        card_efficiency(1000.0)
    with pytest.raises(error):
        card_energy_estimate(seconds=1.0)
