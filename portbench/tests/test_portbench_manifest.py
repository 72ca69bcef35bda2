"""The manifest, the layout found by name, the contract's names and keys,
the result line, and the modules the benchmark may load."""

import ast
import hashlib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import run

ROOT = Path(run.__file__).resolve().parent
BENCH = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_manifest_has_the_contracts_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT.parent / c["file"]).is_file()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    assert 1 <= BENCH["run_seconds"] <= 51
    fours = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert fours <= max(1, len(BENCH["workloads"]) // 4)


def test_names_and_units_use_the_allowed_characters():
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [
        m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["config"] for w in BENCH["workloads"]]
    names += [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    assert len(set(CELLS)) == len(CELLS)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for text in [w["why"] for w in BENCH["workloads"]] + [
            m["layer"] for m in BENCH["per_layer"]] + [
            c["source"] for c in BENCH["configs"]] + BENCH["command"]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_finds_its_files_by_name(cell):
    c = run.Cell(cell)
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert (entry["config"], entry["chips"], entry["why"]) == (
        c.spec["config"], c.chips, c.spec["why"])
    assert entry["traffic"] == cell.split(".", 1)[1]
    want = {m["name"] for m in BENCH["per_layer"]
            if cell in m.get("workloads", CELLS)}
    assert set(c.metrics) == want
    assert callable(c.signal.make) and callable(c.reference.run)
    units = {m["name"]: m["unit"] for m in BENCH["per_layer"]}
    for name, mod in c.metrics.items():
        assert callable(mod.read) and mod.UNIT == units[name]


def _digests(tree: Path) -> dict:
    return {p.relative_to(tree): hashlib.sha1(p.read_bytes()).hexdigest()
            for p in tree.rglob("*") if p.is_file()}


def test_a_new_config_cell_and_metric_are_new_files_alone(tmp_path):
    copy = tmp_path / "checkout"
    shutil.copytree(ROOT, copy / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT.parent / "BENCHMARK.json", copy)
    before = _digests(copy)
    cfg = json.loads((ROOT / "configs/fm_broadcast.json").read_text())
    cfg["name"] = "fm_europe"
    cfg["programmes"]["stereo"]["kwargs"]["deemphasis"] = 5e-05
    (copy / "portbench/configs/fm_europe.json").write_text(json.dumps(cfg))
    spec = json.loads((ROOT / "workloads/fm_broadcast.stereo.json")
                      .read_text())
    spec["config"] = "fm_europe"
    spec["metrics"] = ["idle_share", "pilot_lock_ms"]
    (copy / "portbench/workloads/fm_europe.stereo.json").write_text(
        json.dumps(spec))
    (copy / "portbench/metrics/pilot_lock_ms.py").write_text(
        "UNIT = 'ms'\n\n\ndef read(rec):\n    return 1.0\n")
    probe = ("from portbench.run import Cell; c = Cell('fm_europe.stereo'); "
             "print(c.cfg['name'], sorted(c.metrics), "
             "c.programme['kwargs']['deemphasis'])")
    out = subprocess.run([sys.executable, "-c", probe], cwd=copy,
                         capture_output=True, text=True, check=True).stdout
    assert out.split() == ["fm_europe", "['idle_share',", "'pilot_lock_ms']",
                           "5e-05"]
    after = _digests(copy)
    assert {k: v for k, v in after.items() if k in before} == before


def _fake_rank(gaps, trace):
    rec = {"rank": 0, "calls": 4, "t0": 10.0, "t1": 12.0, "t_first": 9.5,
           "spans_ms": [0.4, 0.5, 0.4, 0.6], "peak_bytes": 5e8,
           "first_run": False, "phases": {}, "forbidden": [],
           "kind": "NVIDIA H100 80GB HBM3", "gaps": gaps, "reference_s": 1}
    if trace:
        rec.update({"metrics": {"idle_share": 1.5, "enqueue_ms": None,
                                "call_roofline": 30.0, "glue_ms": 0.01,
                                "kernels_per_call": 14.0,
                                "front_demod_roofline": 50.0},
                    "busy_s": 0.19, "window_s": 0.2,
                    "device_ops": [["k", 0.1]],
                    "idle_gaps": [["wait", 1e-5]]})
    return rec


@pytest.mark.parametrize("trace", [False, True])
def test_the_last_line_has_exactly_the_contracts_keys(trace):
    cell = run.Cell("fm_broadcast.mono")
    limit = cell.spec["limits"]["out_gap"]
    line, checks = run.combine(cell, [_fake_rank({"0": limit / 10,
                                                  "3": limit / 20}, trace)],
                               trace, 0.0)
    keys = {"correct", "attempted", "failed", "metrics", "device"}
    assert set(line) == keys | ({"breakdown"} if trace else set())
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"} | (
        {"busy_s", "window_s"} if trace else set())
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    if trace:
        assert "enqueue_ms" not in line["metrics"]       # read nothing
        assert set(line["metrics"]) < set(cell.metrics)
    else:
        assert set(line["metrics"]) == e2e
        assert line["metrics"]["input_rate"]["value"] == pytest.approx(
            4 * cell.samples_per_call / 2.0 / 1e9)
    assert checks == {"out_gap": {"value": limit / 10, "limit": limit}}
    bad, _ = run.combine(cell, [_fake_rank({"0": 2 * limit}, trace)], trace,
                         0.0)
    assert bad["correct"] is False and bad["failed"] == 1


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    found = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            found.add(node.module.split(".")[0])
    return found


def test_no_module_imports_jax_or_the_jax_package():
    for path in ROOT.rglob("*.py"):
        assert not _imports(path) & {"jax", "jaxlib", "flax", "sdr_tpu"}, \
            path
    for path in (ROOT / "reference").glob("*.py"):
        assert "sdr_tpu_torch" not in _imports(path), path


def test_the_loaded_module_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "sdr_tpu_torch_probe", object())
    assert "sdr_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "sdr_tpu.probe", object())
    assert run.forbidden_modules() == ["sdr_tpu"]
