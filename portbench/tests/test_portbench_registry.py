"""The harness finds each part of a cell by its name, and a new file is
picked up with no edit."""

import json
import shutil

import pytest

from portbench.spec import HERE, ROOT, Registry


def test_every_cell_resolves():
    reg = Registry()
    for w in reg.bench["workloads"]:
        cfg = reg.config(w["config"])
        assert cfg["model"]["embed_dim"] == 512
        assert reg.traffic(w["traffic"])["kind"] in ("ralm", "search")
        assert reg.limits(w["name"])
        assert reg.end_to_end(w["name"])
        for m in reg.per_layer(w["name"]):
            assert callable(reg.reader(m["name"]))
    for c in reg.bench["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert reg.config(c["name"])["reduced"] == c["reduced"]


def test_unknown_names_raise():
    reg = Registry()
    with pytest.raises(KeyError):
        reg.workload("no-such-cell")
    with pytest.raises(FileNotFoundError):
        reg.config("no-such-config")
    with pytest.raises(FileNotFoundError):
        reg.reader("no_such_metric.ralm")


def test_new_files_are_found_without_edits(tmp_path):
    for folder in ("configs", "traffic", "metrics", "limits"):
        shutil.copytree(HERE / folder, tmp_path / folder)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (tmp_path / "configs" / "new-cfg.json").write_text(json.dumps(
        {"name": "new-cfg", "model": {"embed_dim": 64}}))
    (tmp_path / "traffic" / "new-mix.json").write_text(json.dumps(
        {"kind": "search", "batch": 1}))
    (tmp_path / "limits" / "new-cfg.new-mix.json").write_text(
        json.dumps({"miss": 0.5}))
    (tmp_path / "metrics" / "new_metric.search.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    bench["workloads"].append({"name": "new-cfg.new-mix", "config": "new-cfg",
                               "traffic": "new-mix", "chips": 1})
    bench["per_layer"].append({"name": "new_metric.search", "unit": "%",
                               "workloads": ["new-cfg.new-mix"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    reg = Registry(tmp_path / "BENCHMARK.json", tmp_path)
    w = reg.workload("new-cfg.new-mix")
    assert reg.config(w["config"])["model"]["embed_dim"] == 64
    assert reg.traffic(w["traffic"])["batch"] == 1
    assert reg.limits("new-cfg.new-mix") == {"miss": 0.5}
    assert [m["name"] for m in reg.per_layer("new-cfg.new-mix")] == [
        "new_metric.search"]
    assert reg.reader("new_metric.search")(None) == 42.0
    # the new cell takes the end-to-end metrics with no workloads key
    assert [m["name"] for m in reg.end_to_end("new-cfg.new-mix")] == [
        "setup_s"]


def test_runner_is_found_by_traffic_kind():
    from portbench import ralm, run, search
    assert run.runner("ralm") is ralm.Run
    assert run.runner("search") is search.Run
    with pytest.raises(ModuleNotFoundError):
        run.runner("no_such_kind")
