"""BENCHMARK.json and the files it names, found by name: a cell's
configuration (configs/<config>.json), traffic mix
(traffic/<traffic>.json), output limits (limits/<cell>.json) and
per-layer readers (metrics/<metric>.py)."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import NamedTuple

ROOT = Path(__file__).resolve().parents[2]


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict            # the configuration file
    traffic: dict           # the traffic mix file
    limits: dict            # the output check's limits
    end_to_end: list        # BENCHMARK.json entries this cell reports
    per_layer: list


def load(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _read_json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    return json.loads(path.read_text())


def reports(entry: dict, cell: str) -> bool:
    """Whether a metric entry applies to `cell` by its `workloads` key
    (absent: every cell)."""
    return "workloads" not in entry or cell in entry["workloads"]


def cell(spec: dict, name: str, root: Path = ROOT) -> Cell:
    """The cell `name` with every file it names read."""
    wl = {w["name"]: w for w in spec["workloads"]}
    if name not in wl:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(wl)})")
    w = wl[name]
    cfg = {c["name"]: c for c in spec["configs"]}[w["config"]]
    root = Path(root)
    e2e = [m for m in spec["end_to_end"] if reports(m, name)]
    moved = {m["name"] for m in e2e}
    per = [m for m in spec["per_layer"]
           if (name in m["workloads"] if "workloads" in m
               else m["moves"] in moved)]
    return Cell(name=name, chips=int(w["chips"]),
                config=_read_json(root / cfg["file"]),
                traffic=_read_json(root / "benchmark" / "traffic"
                                   / f"{w['traffic']}.json"),
                limits=_read_json(root / "benchmark" / "limits"
                                  / f"{name}.json"),
                end_to_end=e2e, per_layer=per)


def load_file(path: Path):
    """A Python file as a module (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "bench_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str, root: Path = ROOT):
    """The per-layer metric `name`'s reader, metrics/<name>.py::read."""
    return load_file(Path(root) / "benchmark" / "metrics" / f"{name}.py").read
