"""``BENCHMARK.json`` keeps the benchmark's contract: its keys, names,
units and limits, and every cell's files found by name (configuration,
traffic mix, serving set-up, and a reader for each per-layer metric)."""
import json
import re

import lib

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
B = lib.benchmark()


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_sizes():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= B["run_seconds"] <= 51
    assert len(json.dumps(B)) <= 64 * 1024
    assert all(line(w) for w in B["command"]) and len(B["command"]) <= 32
    assert 1 <= len(B["paths"]) <= 16


def test_configs():
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["why"]) and line(c["source"])
        assert c["file"].startswith(tuple(p + "/" for p in B["paths"]))
        f = lib.read_json(lib.ROOT / c["file"])
        assert f["name"] == c["name"] and set(c["reduced"]) <= set(f)
        assert set(c["reduced"]) == set(f["reduced"])
        assert not any(k.endswith(("_dim", "_rank", "_size")) or
                       "hidden" in k for k in c["reduced"]
                       if k != "num_hidden_layers")


def test_cells_find_their_files():
    names = set()
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and line(w["why"])
        assert w["chips"] == 1 and w["name"] not in names
        names.add(w["name"])
        cell = lib.cell(w["name"])
        assert cell["serve"]["limits"]["served_gap"] > 0
        assert cell["end_to_end"] and cell["per_layer"]
        assert any(m["name"] == "setup_s" for m in cell["end_to_end"])
        assert len(cell["end_to_end"]) >= 2


def test_metrics():
    e2e = {m["name"]: m for m in B["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in B["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers = {}
    for m in B["end_to_end"] + B["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in B["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert line(m["layer"]) and m["moves"] in e2e
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])
        assert callable(lib.reader(m["name"]))
        layers.setdefault(m["layer"], []).append(m["name"])
    # every roofline has a whole-step share beside it, moving the same
    for m in B["per_layer"]:
        if m["name"].split(".")[0].endswith("_roofline_pct"):
            assert any("mfu" in o["name"] and o["moves"] == m["moves"]
                       and set(m["workloads"]) <= set(o["workloads"])
                       for o in B["per_layer"])
