"""BENCHMARK.json and every file it names resolve by name."""
import copy
import json
import shutil

import pytest

from portbench import spec
from portbench.tests.small import cells


def test_benchmark_validates():
    bench = spec.load()
    assert bench["command"][:3] == ["python3", "-m", "portbench.run"]
    assert bench["paths"] == ["portbench"]
    assert {m["name"] for m in bench["end_to_end"]} == {
        "ops_per_s", "device_bytes_per_key", "setup_s"}


@pytest.mark.parametrize("name", cells())
def test_cell_resolves(name):
    c = spec.cell(spec.load(), name)
    assert c.config["engine"] and c.traffic["kind"] == "index_requests"
    e2e = {m["name"] for m in c.end_to_end}
    assert {"device_bytes_per_key", "setup_s"} <= e2e
    assert c.per_layer
    for m in c.per_layer:
        assert callable(spec.reader(m["name"]))
        assert m["moves"] in e2e - {"setup_s"}


def test_every_file_is_named():
    bench = spec.load()
    used = {c["file"].split("/")[-1] for c in bench["configs"]}
    assert used == {p.name for p in (spec.PKG / "configs").glob("*.json")}
    mixes = {w["traffic"] + ".json" for w in bench["workloads"]}
    assert mixes == {p.name for p in (spec.PKG / "traffic").glob("*.json")}
    readers = {m["name"] + ".py" for m in bench["per_layer"]}
    assert readers == {p.name for p in (spec.PKG / "metrics").glob("*.py")
                       if p.name != "__init__.py"}


@pytest.mark.parametrize("bad", [
    lambda b: b["workloads"][0].update(config="no-such-config"),
    lambda b: b["workloads"][0].update(traffic="no-such-mix"),
    lambda b: b["configs"][0].update(file="portbench/configs/none.json"),
    lambda b: b["per_layer"].append(dict(b["per_layer"][0],
                                         name="no_reader")),
    lambda b: b["per_layer"][0]["workloads"].append("no-such-cell"),
])
def test_unresolved_names_are_refused(bad):
    bench = copy.deepcopy(spec.load())
    bad(bench)
    with pytest.raises(ValueError):
        spec.validate(bench)


def test_new_cell_needs_only_new_entries(tmp_path):
    """A cell, a configuration and a mix added as files and entries
    resolve without an edit to any file that is there."""
    bench = copy.deepcopy(spec.load())
    conf = json.loads((spec.PKG / "configs" / "covid-200M.json").read_text())
    shutil.copytree(spec.PKG / "configs", tmp_path / "portbench" / "configs")
    (tmp_path / "portbench" / "configs" / "covid-new.json").write_text(
        json.dumps(dict(conf, engine="ShardedIndexEngine", shards=8)))
    bench["configs"].append({"name": "covid-new", "source": "s",
                             "file": "portbench/configs/covid-new.json",
                             "reduced": [], "why": "w"})
    bench["workloads"].append({"name": "covid-new.w1-lookup",
                               "config": "covid-new",
                               "traffic": "w1-lookup", "chips": 1,
                               "why": "w"})
    bench["per_layer"][0]["workloads"].append("covid-new.w1-lookup")
    spec.validate(bench, root=tmp_path)
    c = spec.cell(bench, "covid-new.w1-lookup", root=tmp_path)
    assert c.config["shards"] == 8 and c.traffic["clients"] == 8192
    assert [m["name"] for m in c.per_layer] == ["p99_ms"]
