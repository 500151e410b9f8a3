"""The corner pool of a frame (Shi-Tomasi response, the best corner a
tile, the top-k), on the frames that refresh it: the gray image read
once (the pool written is a few KB); 45 operations a pixel (two 3-tap
Sobel passes for each gradient, three products, three 3 x 3 box sums,
the smaller eigenvalue)."""


def work(run_cfg: dict, frame: dict, counts: dict):
    px = frame["height"] * frame["width"] * counts["pool_frames"]
    return px * 4, px * 45
