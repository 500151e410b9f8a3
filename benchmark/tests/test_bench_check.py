"""The output check fails what it must: the control (the reference with
its flow layer in bfloat16, put in the program's place) and the faults a
cell can have, each driven through a whole run of the harness on the CPU
at a small frame size with the timed path broken underneath. (No cell
spans cards, so no fault of an exchange between chips applies.)"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.lib import drivers, faults, harness, spec, stand_in

ROOT = Path(__file__).resolve().parents[2]
SMALL = {"height": 72, "width": 96, "channels": 3}
CELLS = [w["name"] for w in spec.load()["workloads"]]


def _run(workload, program):
    # the stream's control parts from the reference as its frames add up
    # (at 72 x 96: 0.7 px after 8 frames, 5.6 px after 84): a few seconds
    # of frames, as the cell's window holds thousands
    seconds = 3.0 if "stream" in workload else 0.3
    res, _log = harness.run(workload, 2 ** 31 + 11, seconds, False,
                            device="cpu", program=program, frame=SMALL)
    return res


class Broken(drivers.Program):
    """The program with one fault planted where its answers are made."""

    def __init__(self, run_cfg, fault):
        super().__init__(run_cfg, "cpu")
        self.fault = fault

    def clip(self, clip):
        return faults.plant(self.fault, super().clip(clip))

    def batch(self, clips):
        return faults.plant(self.fault, super().batch(clips))

    def stream(self, frames):
        return faults.plant(self.fault, super().stream(frames))


@pytest.mark.parametrize("workload", CELLS)
def test_sound_program_is_correct(workload):
    cfg = spec.cell(spec.load(), workload).config["run_config"]
    assert _run(workload, drivers.Program(cfg, "cpu"))["correct"]


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    cfg = spec.cell(spec.load(), workload).config["run_config"]
    res = _run(workload, stand_in.Control(cfg, "cpu"))
    assert not res["correct"]
    assert res["check"]["pos_gap_px"]["value"] \
        > res["check"]["pos_gap_px"]["limit"]


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("workload", CELLS)
def test_fault_is_not_correct(workload, fault):
    cfg = spec.cell(spec.load(), workload).config["run_config"]
    res = _run(workload, Broken(cfg, fault))
    assert not res["correct"]
    assert res["failed"] > 0


@pytest.mark.parametrize("fault", ["half_pool_dead", "killed_after_first"])
@pytest.mark.parametrize("workload", CELLS)
def test_lifecycle_fault_fails_track_mismatch(workload, fault):
    """Tracks reported dead go unmatched and leave the positions of the
    rest as they were: `track_mismatch` is the number that fails."""
    cfg = spec.cell(spec.load(), workload).config["run_config"]
    check = _run(workload, Broken(cfg, fault))["check"]
    assert check["track_mismatch"]["value"] \
        > check["track_mismatch"]["limit"]
    assert check["pos_gap_px"]["value"] <= check["pos_gap_px"]["limit"]


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_at_the_cells_size(cuda_card, workload):
    """On the card at the cell's own size, on three seeds: the control
    reads over the cell's limit, and so does each planted fault
    (benchmark/calibrate.py)."""
    out = subprocess.run(
        [sys.executable, str(ROOT / "benchmark" / "calibrate.py"),
         "--workload", workload, "--control-seeds", "101,102,103"],
        capture_output=True, text=True, timeout=1200, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    rows = [json.loads(x) for x in out.stdout.splitlines() if x.strip()]
    assert sum(r["side"] == "control" for r in rows) == 3
    assert len(rows) == 3 * (1 + len(faults.FAULTS))
    for r in rows:
        assert r["failed"] > 0, r


def test_stream_reference_works_each_frame_out_once():
    """The stream's reference with keys (each pool frame's pyramid and
    corner pool and each pair's flow once) gives every row exactly as
    tracking each frame anew does, across the walk's turns."""
    import itertools

    from benchmark.reference import tracker
    from benchmark.traffic import blob
    cell = spec.cell(spec.load(), "farneback-1080p.stream")
    cfg = cell.config["run_config"]
    pool = torch.from_numpy(blob.clip_pool(5, 1, 5, 72, 96, [2.1, -1.4],
                                           96 / 18, "cpu")[0])
    idx = list(itertools.islice(blob.ping_pong(5), 14))
    plain = tracker.track_frames((pool[i] for i in idx), cfg)
    keyed = tracker.track_frames((pool[i] for i in idx), cfg, keys=idx)
    for k in plain:
        assert np.array_equal(plain[k], keyed[k]), k
