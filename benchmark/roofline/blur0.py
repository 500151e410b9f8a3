"""The level-0 3-tap blur before the fine level's expansion: the gray
image read once and the blurred one written once, float32; a separable
3-tap pass each way, 5 operations a pixel a pass."""


def work(run_cfg: dict, frame: dict, counts: dict):
    px = frame["height"] * frame["width"] * counts["frames"]
    return px * 8, px * 10
