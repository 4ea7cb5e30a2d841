"""BENCHMARK.json: every cell's configuration, traffic, kind, metrics and
limits resolve to files under portbench/, and every name, unit and text
keeps to the allowed characters and lengths."""

import importlib
import json
import re
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def text_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and all(text_ok(w) for w in BENCH["command"])
    seconds = BENCH["run_seconds"]
    assert isinstance(seconds, int) and 1 <= seconds <= 51
    assert 2 + 14 * 24 * (seconds + 60) + 24 * 2 * 90 + 1200 <= 43200  # 24 cells fit a check
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_texts():
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [
        m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and text_ok(w["why"])
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
    for name in names:
        assert NAME.match(name), name
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert text_ok(m["layer"])
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"


def test_configs_resolve():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert text_ok(c["source"]) and text_ok(c["why"])
        path = ROOT / c["file"]
        assert path.is_relative_to(HERE) and path.is_file()
        cfg = json.loads(path.read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"] == []
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_and_reports(cell):
    from portbench import harness

    spec = harness.resolve(cell)
    kind = spec.kind
    for fn in ("setup", "window", "traced", "release", "check", "control"):
        assert callable(getattr(kind, fn))
    e2e = {m["name"] for m in spec.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec.per_layer
    for m in spec.per_layer:
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] in e2e
        assert callable(harness.reader(m["name"]))
    assert spec.limits and all(v > 0 for v in spec.limits.values())
    assert importlib.import_module(f"portbench.kinds.{spec.traffic['kind']}") is kind


def test_every_file_is_named_from_name_characters():
    for path in HERE.rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
