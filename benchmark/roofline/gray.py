"""Grayscale of each frame: the uint8 frame read once, the float32 gray
image written once; 5 operations a pixel (three weights, two adds)."""


def work(run_cfg: dict, frame: dict, counts: dict):
    px = frame["height"] * frame["width"] * counts["frames"]
    return px * (frame["channels"] + 4), px * 5
