"""BENCHMARK.json against the benchmark's contract: keys, names, units, files."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
METRIC_KEYS = {"name", "unit", "better", "source"}


def one_line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(one_line(w) for w in cmd)
    assert not any(w.startswith("/") or ".." in w for w in cmd)
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


def test_names_and_units():
    names = {"configs": [], "workloads": [], "metrics": []}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names["configs"].append(c["name"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert one_line(c["source"]) and one_line(c["why"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        names["workloads"].append(w["name"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and one_line(w["why"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        names["metrics"].append(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for kind, got in names.items():
        assert len(got) == len(set(got)), f"two {kind} share a name"
        assert all(NAME.match(n) for n in got), got
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_metrics():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    assert "setup_s" in e2e and 2 <= len(e2e) <= 16
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and one_line(m["layer"])
        assert set(m.get("workloads", cells)) <= cells
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for cell in cells:
        per = [m for m in BENCH["per_layer"] if cell in m.get("workloads", cells)]
        assert per, f"{cell} reports no per-layer metric"


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_finds_its_files(w):
    pb = ROOT / "portbench"
    config = {c["name"]: c for c in BENCH["configs"]}[w["config"]]
    assert (ROOT / config["file"]).is_file()
    assert config["file"].startswith("portbench/")
    assert (pb / "configs" / f"{w['config']}.py").is_file()
    assert (pb / "reference" / f"{w['config']}.py").is_file()
    mix = json.loads((pb / "traffic" / f"{w['traffic']}.json").read_text())
    assert {"warm_chunks", "check_chunks", "trace_chunks", "limits"} <= set(mix)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (pb / "metrics" / f"{m['name']}.py").is_file()


def test_file_names_under_paths():
    for p in (ROOT / "portbench").rglob("*"):
        rel = p.relative_to(ROOT).as_posix()
        if "__pycache__" in rel or ".pytest_cache" in rel:
            continue
        assert all(NAME.match(part) for part in rel.split("/")), rel
