"""kalman_hydra_tpu_torch — PyTorch/CUDA port of the kalman_hydra_tpu tracker.

The JAX package (`kalman_hydra_tpu`) is the reference; this package mirrors
its layout (`ops/`, `models/`, `kernels/`, `io/`, `utils/`, `parallel/`,
`pipeline.py`, `api.py`, `cli.py`) and runs the Farneback and
Lucas-Kanade (sparse and dense) + EKF tracking paths (per-frame,
pair-batched, multi-clip, and streamed from video files with
checkpoint/resume), the mesh-render channels (`api.track_mesh`), the
debug and profiling hooks, and clip data parallelism and row-band spatial
sharding over a device mesh (`parallel/`) on NVIDIA Hopper cards. Each
Pallas kernel on those paths has a hand-written
CUDA C++ counterpart in `csrc/`, built with nvcc at first use
(`kernels/_build.py`) and paired with a plain PyTorch version that runs on
CPU tensors.

The port keeps its own copies of the reference's host code (`config.py`,
`io/export.py`, `io/video.py`, `io/synthetic.py`, `utils/checkpoint.py`,
..., held equal by tests) and imports neither jax nor any module of
`kalman_hydra_tpu`. Its entry points run on the card unless the
caller passes `device="cpu"`.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def cuda_device(index: int = 0) -> torch.device:
    """Set up CUDA device `index` for the port and return it.

    TF32 is switched off for matmuls and cuDNN: f32 must mean f32 here
    (TF32 keeps ~3 decimal digits, which costs ~0.5 intensity on u8-scale
    images — the same trap as bf16 MXU operands on the TPU)."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_device: no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", index)
    torch.cuda.set_device(dev)
    return dev


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; a card is set up (`cuda_device`)
    before any work, and asking for one without a card raises."""
    device = torch.device(device)
    if device.type == "cuda":
        return cuda_device(device.index or 0)
    return device


__all__ = ["cuda_device", "resolve_device"]
