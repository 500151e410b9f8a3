"""Farneback's levels and iterations for each frame pair: at each level
both frames' planes read once; the flow of the finest level written
once (the flow between levels may stay on chip). Operations: per level
pixel and iteration, 116 for the warp, the damped normal equations, the
scale and the 2x2 solve, and the two window passes over M's 5 planes (a
box: an add and a subtract a plane and pass as a sliding sum, whatever
its width; a Gaussian: a multiply-add a tap)."""

from benchmark.roofline._levels import plan, plane_bytes


def iteration_flops(winsize: int, gaussian: bool) -> int:
    taps = 2 * (winsize // 2) + 1
    return 116 + (20 * taps if gaussian else 20)


def work(run_cfg: dict, frame: dict, counts: dict):
    f = run_cfg["flow"]
    h, w = frame["height"], frame["width"]
    per_px = f["iterations"] * iteration_flops(f["winsize"],
                                               f["gaussian_win"])
    px = sum(lh * lw for (_k, lh, lw, _ks)
             in plan(h, w, f["levels"], f["pyr_scale"]))
    nbytes = 2 * 5 * px * plane_bytes(f) + h * w * 2 * 4
    return counts["pairs"] * nbytes, counts["pairs"] * px * per_px
