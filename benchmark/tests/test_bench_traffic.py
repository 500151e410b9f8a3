"""The footage generator (traffic/blob.py): seeded, and the blob moves
by the set velocity."""

import numpy as np
import torch

from benchmark.traffic import blob

H, W, SIGMA = 72, 96, 9.0


def test_same_seed_same_frames():
    a = blob.clip_pool(2 ** 40 + 3, 2, 3, H, W, (2.1, -1.4), SIGMA, "cpu")
    b = blob.clip_pool(2 ** 40 + 3, 2, 3, H, W, (2.1, -1.4), SIGMA, "cpu")
    c = blob.clip_pool(2 ** 40 + 4, 2, 3, H, W, (2.1, -1.4), SIGMA, "cpu")
    assert a.shape == (2, 3, H, W, 3) and a.dtype == np.uint8
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)
    assert not np.array_equal(a[0], a[1])          # the pool's clips differ
    assert np.array_equal(a[..., 0], a[..., 2])    # gray in every channel


def test_blob_moves_by_its_velocity():
    v = (3.0, -2.0)                                 # whole pixels: exact shift
    s = blob.Scene(99, H, W, v, SIGMA, "cpu")
    f0 = s.frame(0)[..., 0].to(torch.int32).numpy()
    c0 = s.centre(0)
    yy, xx = np.mgrid[0:H, 0:W]
    inside = np.hypot(xx - c0[0], yy - c0[1]) < 0.3 * SIGMA
    ys, xs = yy[inside], xx[inside]
    for t in (1, 4):
        ft = s.frame(t)[..., 0].to(torch.int32).numpy()
        assert np.allclose(s.centre(t), c0 + t * np.array(v))
        moved = ft[ys + int(v[1]) * t, xs + int(v[0]) * t]
        # the blob's pixels carried along; the background under its rim
        # weighs < 1% inside 0.3 sigma
        assert np.abs(moved - f0[ys, xs]).max() <= 1
        assert np.abs(ft[ys, xs] - f0[ys, xs]).max() > 5


def test_ping_pong_walks_forward_and_back():
    it = blob.ping_pong(4)
    idx = [next(it) for _ in range(12)]
    assert idx == [0, 1, 2, 3, 2, 1, 0, 1, 2, 3, 2, 1]
    assert all(abs(a - b) == 1 for a, b in zip(idx, idx[1:]))


def test_sub_seeds_take_large_seeds():
    seeds = {blob.sub_seed(2 ** 31 + 5, i) for i in range(16)}
    assert len(seeds) == 16 and all(0 <= s < 2 ** 63 for s in seeds)
