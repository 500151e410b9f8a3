"""The harness rehearsed on the CPU: BENCHMARK.json's names and units,
cells found by name, a cell added as new files found with no edit, and
no fall-back to the CPU without a card."""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark.lib import check, harness, spec

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SMALL = {"height": 72, "width": 96, "channels": 3}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_names_units_and_keys():
    b = spec.load()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) \
            and _line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert (ROOT / c["file"]).is_file()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
    metrics = b["end_to_end"] + b["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert _line(m["layer"]) and m["moves"] in {
            e["name"] for e in b["end_to_end"]}
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}
    assert len(json.dumps(b)) < 64 * 1024


@pytest.mark.parametrize("workload", [w["name"] for w
                                      in spec.load()["workloads"]])
def test_cell_found_by_name(workload):
    cell = spec.cell(spec.load(), workload)
    assert cell.traffic["driver"] in ("clips", "batches", "stream")
    assert all(cell.limits[k] > 0 for k in check.NUMBERS)
    assert set(cell.config["stages"]) <= {
        p.stem for p in (ROOT / "benchmark" / "roofline").glob("[!_]*.py")}
    assert cell.per_layer and cell.end_to_end
    for m in cell.per_layer:
        assert callable(spec.reader(m["name"]))


def _copy_benchmark(tmp: Path) -> Path:
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp


def test_new_cell_as_new_files(tmp_path):
    """A configuration, a traffic mix, its limits and a per-layer metric
    added as files, and entries added to BENCHMARK.json: the harness runs
    the new cell and reads the new metric with no other edit."""
    root = _copy_benchmark(tmp_path)
    bench = root / "benchmark"
    cfg = json.loads((bench / "configs" / "farneback-1080p.json").read_text())
    cfg["name"] = "farneback-small"
    cfg["run_config"]["tracks"]["reinit_every"] = 1
    (bench / "configs" / "farneback-small.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "clip9.json").read_text())
    mix.update(clip_len=5, clips=2, warmup_calls=1, profile_calls=1)
    (bench / "traffic" / "clip5.json").write_text(json.dumps(mix))
    (bench / "limits" / "farneback-small.clip5.json").write_text(
        (bench / "limits" / "farneback-1080p.clip9.json").read_text())
    (bench / "metrics" / "api.calls.py").write_text(
        "def read(ctx):\n    return float(len(ctx.call_ms))\n")
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "farneback-small", "source": "a test",
                         "file": "benchmark/configs/farneback-small.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "farneback-small.clip5",
                           "config": "farneback-small", "traffic": "clip5",
                           "chips": 1, "why": "a test"})
    b["per_layer"].append({"name": "api.calls", "unit": "calls",
                           "better": "higher", "source": "host_clock",
                           "layer": "API / driver", "moves": "frames_per_s",
                           "workloads": ["farneback-small.clip5"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    res, _log = harness.run("farneback-small.clip5", 3, 0.3, True,
                            root=root, device="cpu", frame=SMALL)
    assert res["correct"], res
    assert res["metrics"]["api.calls"]["value"] >= 1
    assert "api.call_ms_p95" not in res["metrics"]
    res, _log = harness.run("farneback-small.clip5", 3, 0.3, False,
                            root=root, device="cpu", frame=SMALL)
    assert set(res["metrics"]) == {"frames_per_s", "setup_s"}
    assert list(res)[-1] == "check"


def test_no_card_no_result(tmp_path):
    """Without a CUDA device run.py exits non-zero and prints no result;
    it never runs on the CPU instead."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, str(ROOT / "benchmark" / "run.py"),
                          "--workload", "farneback-1080p.clip9", "--seed",
                          "3000000019", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


@pytest.mark.parametrize("workload", [w["name"] for w
                                      in spec.load()["workloads"]])
def test_traced_run_on_the_cpu(workload):
    """A --trace 1 run end to end at a small size: the window, the
    profiled calls, the readers, the breakdown, the check (the readers
    of device events find nothing on the CPU and leave their metrics
    out)."""
    res, log = harness.run(workload, 2 ** 33 + 7, 0.3, True, device="cpu",
                           frame=SMALL)
    assert res["correct"], log
    names = {m["name"] for m in spec.cell(spec.load(), workload).per_layer}
    assert set(res["metrics"]) <= names
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(res)[-1] == "check"
