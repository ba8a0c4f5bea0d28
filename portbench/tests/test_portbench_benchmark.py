"""BENCHMARK.json holds to the benchmark's contract, and every name in it
finds its file."""

import json
import math
import os
import re

import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
# the keys of each entry (a metric may add "workloads")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
# widths a configuration may never cut
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "projection", "head", "expansion", "experts_per_tok",
               "wh", "width", "height", "camera", "n_features", "n_levels")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _text(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_and_sizes(bench):
    assert set(bench) == KEYS["top"]
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[kind]:
            extra = set(e) - KEYS[kind]
            assert extra <= ({"workloads"} if kind in ("end_to_end", "per_layer") else set()), (kind, e["name"])
            assert KEYS[kind] <= set(e), (kind, e["name"])
    assert 1 <= len(bench["configs"]) <= 24 and 1 <= len(bench["workloads"]) <= 24
    assert 1 <= len(bench["end_to_end"]) <= 16 and 1 <= len(bench["per_layer"]) <= 128
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51


def test_command_and_paths(bench):
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.rstrip("/").endswith("_torch")
    cmd = bench["command"]
    assert len(cmd) <= 32 and all(_text(w) for w in cmd)
    for w in cmd:
        if os.path.exists(os.path.join(ROOT, w)):
            assert any(w == p or w.startswith(p.rstrip("/") + "/") for p in bench["paths"]), w


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_plain(bench, kind):
    names = [e["name"] for e in bench[kind]]
    assert len(set(names)) == len(names)
    for e in bench[kind]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e and kind in ("configs", "workloads", "per_layer"):
                assert _text(e[key]), (e["name"], key)


def test_configs_are_found_and_cut_only_in_scale(bench):
    used = {w["config"] for w in bench["workloads"]}
    files = [c["file"] for c in bench["configs"]]
    assert len(set(files)) == len(files)
    for c in bench["configs"]:
        assert c["name"] in used, c["name"]
        assert any(c["file"].startswith(p.rstrip("/") + "/") for p in bench["paths"])
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and key in cfg["assumed"], key
            assert not any(w in key for w in WIDTH_WORDS) and not key.endswith(("_dim", "_rank")), key


def test_cells_find_their_files(bench):
    configs = {c["name"] for c in bench["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(set(pairs)) == len(pairs)
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)
    for w in bench["workloads"]:
        assert w["chips"] in (1, 4) and w["config"] in configs and NAME.match(w["traffic"])
        assert os.path.exists(os.path.join(BENCH_DIR, "traffic", f"{w['traffic']}.json")), w["traffic"]
        with open(os.path.join(BENCH_DIR, "workloads", f"{w['name']}.json")) as f:
            spec = json.load(f)
        with open(os.path.join(BENCH_DIR, "configs", f"{w['config']}.json")) as f:
            run = json.load(f)["runs"][w["traffic"]]
        assert os.path.exists(os.path.join(BENCH_DIR, "entries", f"{run['entry']}.py")), run["entry"]
        for check in spec["limits"]:
            assert os.path.exists(os.path.join(BENCH_DIR, "checks", f"{check}.py")), check


def test_metrics_find_their_readers_and_cells(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert os.path.exists(os.path.join(BENCH_DIR, "metrics", f"{m['name'].split('.')[0]}.py")), m["name"]
        assert set(m.get("workloads", cells)) <= cells
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in bench["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        moved = next(e for e in bench["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
        layers.setdefault(m["layer"], []).append(m["name"])
        if m["unit"] == "%" and m["name"].endswith("_roofline"):
            assert m["better"] == "higher"
    for cell in cells:
        assert [m for m in bench["per_layer"] if cell in m.get("workloads", cells)], cell


def test_a_full_check_fits_its_time(bench):
    rs = bench["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert math.isfinite(rs)
