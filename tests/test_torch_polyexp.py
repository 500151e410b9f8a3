"""CPU tests of K3/K7a's kernel (csrc/polyexp.cu): its tile and
shared-memory plan for every odd poly_n it builds, a NumPy float32 model
of its tiles (staging with clamped rows and columns, the vertical and
horizontal taps, the ragged edges) against a whole-image model of the
same multiply-adds and the plain version, and its C interface as the
wrapper calls it, an unaligned frame included."""

from __future__ import annotations

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from kalman_hydra_tpu_torch.kernels import _build
from kalman_hydra_tpu_torch.kernels import polyexp as pe

CSRC = Path(pe.__file__).resolve().parents[1] / "csrc"
SIGMA = {1: 0.6, 3: 0.9, 5: 1.1, 7: 1.5}


def _cu_int(name):
    src = (CSRC / "polyexp.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("n", pe.COMPILED_N)
def test_polyexp_plan_is_the_kernels(n, dtype):
    """At every odd poly_n up to 7 the plan is polyexp.cu's 32 x 64 tile:
    one horizontal item (a row, 8 columns) a thread of 256; shared memory
    the input tile ((32 + 2n) rows of 64 + 16 floats) or the five staged
    output planes (row stride 72 bf16 or 68 f32), whichever is larger,
    and three vertical-moment planes at the odd stride (64 + 2n) | 1,
    above the 48 KB a launch gets without a grant from n = 5; three
    blocks fit an SM's 228 KB."""
    plan = pe.polyexp_plan(n, dtype)
    assert (plan.th, plan.tw) == (_cu_int("kTH"), _cu_int("kTW"))
    assert plan.th * plan.tw // _cu_int("kRH") == _cu_int("kThreads")
    assert plan.th % _cu_int("kSeg") == 0
    ob = torch.empty((), dtype=dtype).element_size()
    ip = plan.tw + 2 * _cu_int("kPad")
    stage = 5 * plan.th * (plan.tw + (8 if ob == 2 else 4)) * ob
    vs = 3 * plan.th * ((plan.tw + 2 * n) | 1) * 4
    assert plan.smem == max(4 * (plan.th + 2 * n) * ip, stage) + vs
    assert plan.smem <= pe.SMEM_LIMIT and (n < 5 or plan.smem > 48 * 1024)
    assert 3 * (plan.smem + 1024) <= 228 * 1024


@pytest.mark.parametrize("n", (1, 2, 3, 4, 6, 8))
def test_polyexp_plan_other_n_take_the_first_design(n):
    """The first design (16 x 64 tiles, the taps in shared memory) is
    gone: the odd n it served (1 and 3) take the 32 x 64 tiles of 5 and
    7, built for them (the kernel's dispatch has one case for each n of
    COMPILED_N, all within its pad of 8 columns), and an even n, which
    FlowConfig refuses, is refused."""
    src = (CSRC / "polyexp.cu").read_text()
    built = re.findall(r"case (\d+): return launch_tiled<OutT, (\d+)>", src)
    assert [int(a) for a, b in built if a == b] == list(pe.COMPILED_N)
    assert max(pe.COMPILED_N) == _cu_int("kNMax") <= _cu_int("kPad")
    if n % 2:
        plan = pe.polyexp_plan(n)
        assert (plan.th, plan.tw) == (32, 64)
        assert 0 < plan.smem < pe.polyexp_plan(5).smem
    else:
        with pytest.raises(ValueError):
            pe.polyexp_plan(n)


@pytest.mark.parametrize("n", (0, 2, pe.POLY_N_MAX + 2))
def test_polyexp_plan_refuses_n_out_of_range(n):
    """n must be odd, from 1 to POLY_N_MAX (9 and past were refused until
    the generic build: test_polyexp_plan_takes_the_generic_build)."""
    with pytest.raises(ValueError):
        pe.polyexp_plan(n)


def _fma(a, b, c):
    """float32 fused multiply-add through float64 (exact product; the sum
    rounds twice only on a tie)."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32)


def _combine(m, taps, t):
    ig11, ig03, ig33, ig55 = taps[3 * t:]
    m00, m10, m20, m01, m11, m02 = m
    return np.stack([m10 * ig11, m01 * ig11, _fma(m00, ig03, m20 * ig33),
                     _fma(m00, ig03, m02 * ig33), m11 * ig55])


def _moments(src, taps, n, rows, cols):
    """The vertical, then the horizontal taps over `src` (rows + 2n) x
    (cols + 2n), one multiply-add each in tap order: (6, rows, cols)."""
    t = 2 * n + 1
    g, xg, xxg = (taps[j * t:(j + 1) * t] for j in range(3))
    v = np.zeros((3, rows, cols + 2 * n), np.float32)
    for k in range(t):
        s = src[k:k + rows]
        v = np.stack([_fma(g[k], s, v[0]), _fma(xg[k], s, v[1]),
                      _fma(xxg[k], s, v[2])])
    m = np.zeros((6, rows, cols), np.float32)
    for k in range(t):
        a, b, d = (v[j][:, k:k + cols] for j in range(3))
        m = np.stack([_fma(g[k], a, m[0]), _fma(xg[k], a, m[1]),
                      _fma(xxg[k], a, m[2]), _fma(g[k], b, m[3]),
                      _fma(xg[k], b, m[4]), _fma(g[k], d, m[5])])
    return m


def _tiled_model(img, n):
    """The kernel's blocks on one frame: each stages its (32 + 2n) x 80
    input tile (source rows r0 - n ..., columns c0 - 8 ..., clamped to the
    image), runs the taps on the columns 8 - n ... of it, and stores the
    in-image part of its 32 x 64 outputs; every pixel is written once."""
    h, w = img.shape
    th, tw, pad = _cu_int("kTH"), _cu_int("kTW"), _cu_int("kPad")
    taps = pe.poly_taps(n, SIGMA[n])
    t = 2 * n + 1
    out = np.full((5, h, w), np.nan, np.float32)
    for r0 in range(0, h, th):
        for c0 in range(0, w, tw):
            rr = np.clip(np.arange(r0 - n, r0 + th + n), 0, h - 1)
            cc = np.clip(np.arange(c0 - pad, c0 + tw + pad), 0, w - 1)
            tile = img[rr][:, cc]
            src = tile[:, pad - n:pad - n + tw + 2 * n]
            planes = _combine(_moments(src, taps, n, th, tw), taps, t)
            r1, c1 = min(h, r0 + th), min(w, c0 + tw)
            assert np.isnan(out[:, r0:r1, c0:c1]).all()
            out[:, r0:r1, c0:c1] = planes[:, :r1 - r0, :c1 - c0]
    assert not np.isnan(out).any()
    return out


@pytest.mark.parametrize("n", pe.COMPILED_N)
@pytest.mark.parametrize("shape", ((37, 53), (70, 130), (1, 5), (33, 64),
                                   (64, 129)))
def test_tiled_model_is_the_whole_image_sum(shape, n):
    """The tiles, their clamped staging and ragged edges compute what the
    whole replicate-padded image gives with the same multiply-adds (bit
    for bit), and the plain version's numbers (< 1e-3)."""
    rng = np.random.default_rng(3)
    img = (rng.random(shape) * 255).astype(np.float32)
    got = _tiled_model(img, n)
    taps = pe.poly_taps(n, SIGMA[n])
    padded = np.pad(img, n, mode="edge")
    whole = _combine(_moments(padded, taps, n, *shape), taps, 2 * n + 1)
    assert np.array_equal(got, whole)
    plain = pe.poly_expansion_planar_plain(torch.from_numpy(img), n,
                                           SIGMA[n]).numpy()
    assert np.abs(got - plain).max() < 1e-3


_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
            "int": ctypes.c_int, "float": ctypes.c_float}


def _c_signature(name):
    src = (CSRC / "polyexp.cu").read_text()
    args = re.search(rf"KH_API int {name}\(([^)]*)\)", src).group(1)
    return [_C_TYPES[re.sub(r"\s+\w+$", "", a.strip())]
            for a in args.split(",")]


@pytest.mark.parametrize("n", (5, 7, 3))
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("frames", (1, 3))
def test_polyexp_calls_the_c_interface_as_declared(monkeypatch, frames,
                                                   dtype, n):
    """_launch, run on a CPU stack with the library call recorded, makes
    ONE kh_polyexp call for the stack with the types of the C signature,
    the plan's shared memory and K3's taps in host memory."""
    calls = []

    def function(fname, *argtypes):
        def fn(*args):       # the taps live only during the call
            calls.append((fname, argtypes, args, np.ctypeslib.as_array(
                (ctypes.c_float * (3 * (2 * n + 1) + 4)).from_address(
                    args[4])).copy()))
            return 0
        return fn
    monkeypatch.setattr(_build, "function", function)
    monkeypatch.setattr(_build, "stream", lambda t: 0)
    imgs = torch.zeros(frames, 40, 70)
    out = pe._launch(imgs, n, 1.3, dtype)
    (fname, argtypes, args, taps), = calls
    assert fname == "kh_polyexp"
    assert list(argtypes) == _c_signature(fname)
    assert len(args) == len(argtypes)
    (img, nf, h, w, _taps, taps_dev, nn, bf16, smem, out_ptr,
     _stream) = args
    assert taps_dev is None         # the compiled builds' taps are by value
    assert (img, nf, h, w, nn, bf16, smem, out_ptr) == (
        imgs.data_ptr(), frames, 40, 70, n, int(dtype == torch.bfloat16),
        pe.polyexp_plan(n, dtype).smem, out.data_ptr())
    assert out.shape == (frames, 5, 40, 70) and out.dtype == dtype
    assert np.array_equal(taps, pe.poly_taps(n, 1.3))


def test_polyexp_loads_by_element_from_an_unaligned_frame(monkeypatch):
    """A contiguous view may start anywhere in its storage: _launch hands
    the kernel the view's own address (here 4 bytes past a 16-byte
    boundary), and the kernel takes its 16-byte loads only where the
    frame's address and width keep every row on a 16-byte boundary (its
    output is a fresh tensor of the wrapper's)."""
    seen = []
    monkeypatch.setattr(_build, "function",
                        lambda fname, *argtypes: lambda *a: seen.append(a)
                        or 0)
    monkeypatch.setattr(_build, "stream", lambda t: 0)
    flat = torch.zeros(1 + 3 * 40 * 64)
    view = flat[1:].view(3, 40, 64)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    out = pe._launch(view, 5, 1.1, torch.bfloat16)
    assert seen[0][0] == view.data_ptr() and out.data_ptr() % 16 == 0
    src = (CSRC / "polyexp.cu").read_text()
    cond = re.search(r"const bool vec_in =\s*([^;]*);", src).group(1)
    assert re.sub(r"\s+", " ", cond) == (
        "(w & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0")
    # the pointers are tested after the frame's offset is added
    assert src.index("src += blockIdx.z * plane") < src.index(
        "const bool vec_in")
