"""The roofline's stage counts (roofline/): hand-checked at small shapes,
bytes no more than the data the stage must move, and the share's
reader."""

import json
import shutil
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from benchmark.lib import drivers, roofline, spec
from benchmark.reference import flow as fl

ROOT = Path(__file__).resolve().parents[2]
RUN_CFG = json.loads((ROOT / "benchmark" / "configs"
                      / "farneback-1080p.json").read_text())["run_config"]


def _cfg(**flow):
    cfg = json.loads(json.dumps(RUN_CFG))
    cfg["flow"].update(flow)
    return cfg


def _stage(name):
    return roofline.stage(name)


def test_polyexp_stage_by_hand():
    # 64 x 64, levels 1: level 1 is 32 x 32 (blur ksize 3), level 0 64 x 64
    cfg = _cfg(levels=1, poly_n=5, bf16_poly=True)
    frame = {"height": 64, "width": 64, "channels": 3}
    nbytes, flops = _stage("polyexp")(cfg, frame, {"frames": 1})
    pe = 18 * 11 + 7
    assert flops == 32 * 32 * pe + 2 * 4 * (32 * 64 + 32 * 32) + 64 * 64 * pe
    assert nbytes == 2 * 64 * 64 * 4 + 5 * (32 * 32 + 64 * 64) * 2


def test_farneback_iteration_by_hand():
    # 40 x 40 leaves one level (20 px < 32); one box iteration, winsize 15
    cfg = _cfg(levels=1, iterations=1, winsize=15, gaussian_win=False)
    frame = {"height": 40, "width": 40, "channels": 3}
    nbytes, flops = _stage("farneback")(cfg, frame, {"pairs": 1})
    assert flops == 40 * 40 * (116 + 20)
    assert nbytes == 2 * 5 * 40 * 40 * 2 + 40 * 40 * 2 * 4
    g = _cfg(levels=1, iterations=1, winsize=15, gaussian_win=True)
    assert _stage("farneback")(g, frame, {"pairs": 1})[1] \
        == 40 * 40 * (116 + 20 * 15)


def test_bytes_are_the_data_each_stage_moves():
    """A stage's bytes are its inputs read once and outputs written once,
    as the reference's own tensors measure them, so no count asks for
    more traffic than the work must make."""
    frame = {"height": 96, "width": 128, "channels": 3}
    f = RUN_CFG["flow"]
    rgb = torch.zeros((96, 128, 3), dtype=torch.uint8)
    gray = fl.grayscale_u8(rgb)
    pyr = fl.polyexp_pyramid(gray, f, torch.bfloat16)
    planes = sum(p.numel() * p.element_size() for p in pyr)
    flow = fl.farneback(pyr, pyr, f)
    assert _stage("gray")(RUN_CFG, frame, {"frames": 1})[0] \
        == rgb.numel() + gray.numel() * 4
    assert _stage("polyexp")(RUN_CFG, frame, {"frames": 1})[0] \
        == 2 * gray.numel() * 4 + planes
    assert _stage("farneback")(RUN_CFG, frame, {"pairs": 1})[0] \
        == 2 * planes + flow.numel() * 4


def test_counts_of_a_clip():
    c = drivers.clip_counts(9, 4, RUN_CFG)          # reinit_every 4
    assert c == {"frames": 36, "pairs": 32, "track_steps": 32,
                 "pool_frames": 12}


@pytest.mark.parametrize("workload", ["farneback-1080p.clip9",
                                      "farneback-1080p-pairs.batch4x9",
                                      "farneback-1080p.stream"])
def test_share_reader(workload):
    cell = spec.cell(spec.load(), workload)
    read = spec.reader("kernels.roofline_share")
    frame = cell.config["frame"]
    least = sum(roofline.least_seconds(
        cell.config["stages"], cell.config["run_config"], frame,
        drivers.clip_counts(9, 1, cell.config["run_config"])).values())
    # 8 steps of 1080p need ~0.4 ms at the peaks: far under the ~1 ms a
    # step the card's kernels take, and never over 100% for a kernel time
    # at least the least time
    assert 2e-4 < least < 1e-3
    ctx = SimpleNamespace(kernels=[("k", 0.0, least * 1e6)], least_s=least)
    assert read(ctx) == pytest.approx(100.0)
    assert read(SimpleNamespace(kernels=[], least_s=least)) is None


def test_a_new_stage_leaves_other_cells_alone(tmp_path):
    """A stage file added for another configuration's work changes no
    least time of a cell whose configuration does not name it; one that
    names it gets it."""
    shutil.copytree(ROOT / "benchmark" / "roofline",
                    tmp_path / "benchmark" / "roofline")
    cfg = json.loads((ROOT / "benchmark" / "configs"
                      / "farneback-1080p.json").read_text())
    counts = drivers.clip_counts(9, 1, cfg["run_config"])
    before = roofline.least_seconds(cfg["stages"], cfg["run_config"],
                                    cfg["frame"], counts, tmp_path)
    (tmp_path / "benchmark" / "roofline" / "lk_levels.py").write_text(
        "def work(run_cfg, frame, counts):\n"
        "    return 10 ** 12 * counts[\"pairs\"], 0\n")
    after = roofline.least_seconds(cfg["stages"], cfg["run_config"],
                                   cfg["frame"], counts, tmp_path)
    assert after == before
    lk = roofline.least_seconds(["lk_levels"], cfg["run_config"],
                                cfg["frame"], counts, tmp_path)
    assert lk["lk_levels"] == pytest.approx(8e12 / roofline.HBM_BYTES_PER_S)
    with pytest.raises(FileNotFoundError):
        roofline.least_seconds(["no_such_stage"], cfg["run_config"],
                               cfg["frame"], counts, tmp_path)
