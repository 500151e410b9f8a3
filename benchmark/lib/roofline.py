"""The least time the card could take for some frames' work: the sum
over the stages that the cell's configuration names (its file's
"stages", each roofline/<stage>.py) of max(bytes / HBM bandwidth,
float32 operations / float32 peak). A stage file serves only the
configurations that name it, so a stage added for another kind of
work leaves every other cell's least time as it was. Each stage counts
its own inputs read once and outputs written once, from the
configuration's shapes, so the count reads the same whatever kernel
does the work.

`counts` says how much work there was: frames (grayscale and polyexp
pyramid made), pairs (flows between consecutive frames), track_steps
(filter steps of the whole track pool) and pool_frames (frames whose
corner pool was computed)."""

from __future__ import annotations

from pathlib import Path

from . import spec

# Published peaks of one NVIDIA H100 SXM (data sheet, 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def stage(name: str, root: Path = spec.ROOT):
    """The work count of stage `name`, roofline/<name>.py::work."""
    path = Path(root) / "benchmark" / "roofline" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    return spec.load_file(path).work


def least_seconds(names, run_cfg: dict, frame: dict, counts: dict,
                  root: Path = spec.ROOT) -> dict:
    """{stage: least seconds} of the stages `names` for the work in
    `counts`."""
    out = {}
    for name in names:
        nbytes, flops = stage(name, root)(run_cfg, frame, counts)
        out[name] = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)
    return out
