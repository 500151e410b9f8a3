"""The polynomial-expansion pyramid of each frame: the coarse level
images (GaussianBlur of the original composed with the linear resize:
ksize + 1 taps a level pixel down the rows over the full width, then
along them) and every level's 5 planes (3 vertical and 6 horizontal
moments of 2n + 1 taps, 2 operations a tap, 7 to combine). Bytes: the
gray image and the level-0 blur read once, the planes of every level
written once in their stored type."""

from benchmark.roofline._levels import plan, plane_bytes


def work(run_cfg: dict, frame: dict, counts: dict):
    f = run_cfg["flow"]
    h, w = frame["height"], frame["width"]
    n = f["poly_n"]
    pe = 18 * (2 * n + 1) + 7
    flops, planes = 0, 0
    for (k, lh, lw, ksize) in plan(h, w, f["levels"], f["pyr_scale"]):
        planes += lh * lw
        flops += lh * lw * pe
        if k > 0:
            flops += 2 * (ksize + 1) * (lh * w + lh * lw)
    nbytes = 2 * h * w * 4 + 5 * planes * plane_bytes(f)
    return counts["frames"] * nbytes, counts["frames"] * flops
