"""Device mesh and data-parallel clip sharding (port of
kalman_hydra_tpu/parallel/mesh.py).

One process drives the whole mesh, as the reference's single controller
does: one call takes the whole clip batch (or frame pair, parallel/
spatial.py) and returns the whole answer. A `Mesh` is an ordered list of
torch devices and an axis name. A device may repeat: four `cuda:0` are
four shards on one card, eight `cpu` the CPU tests' mesh (the reference's
tests fake eight CPU devices). Each shard's work runs under its own
device (`on_device`), so that the kernels, which launch on the current
CUDA device's stream, run on the card that holds the shard's tensors.

Clip data parallelism: shard i tracks clips i * B / n ... (i + 1) * B /
n - 1 on its device through `pipeline.track_clips_arrays`, the body of
the single-device batch `track_clips_batch` (= `pipeline.track_clips`):
clip after clip through `track_arrays`, or all of them through
`track_clips_pairflow` with pair_batch. No data crosses between shards in the loop; the only
cross-shard step is the optional metric reduction, on the first shard's
device.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import numpy as np
import torch

from .. import pipeline as _pipeline
from .. import resolve_device
from ..config import RunConfig


class Mesh:
    """A 1-D device mesh: `devices` in shard order and `axis_names` (one
    name), the counterpart of a 1-D jax.sharding.Mesh. `size` is the
    shard count."""

    def __init__(self, devices: Sequence, axis_names=("data",)):
        if isinstance(axis_names, str):
            axis_names = (axis_names,)
        self.devices = tuple(torch.device(d) for d in devices)
        self.axis_names = tuple(axis_names)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        if len(self.axis_names) != 1:
            raise ValueError(f"a 1-D mesh takes one axis name, got "
                             f"{self.axis_names}")

    @property
    def size(self) -> int:
        return len(self.devices)

    def distinct(self) -> tuple:
        """The mesh's devices, each once, in order of first use."""
        return tuple(dict.fromkeys(self.devices))


def make_mesh(n_devices: Optional[int] = None, axis: str = "data", *,
              device="cuda") -> Mesh:
    """1-D mesh over the first n visible devices of `device`'s type
    (default: all): the cards, or the CPU's one device. Without a card,
    "cuda" raises."""
    kind = torch.device(device).type
    if kind == "cuda":
        resolve_device(torch.device("cuda", 0))
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [torch.device(kind)]
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(devs, (axis,))


def on_device(dev: torch.device):
    """Make `dev` the current CUDA device for a shard's work (a no-op for
    the CPU)."""
    dev = torch.device(dev)
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


# the single-device batch: the reference's name for it
track_clips_batch = _pipeline.track_clips


def track_clips_sharded(clips: np.ndarray, cfg: RunConfig,
                        mesh: Optional[Mesh] = None,
                        seeds: Optional[np.ndarray] = None,
                        reduce_metrics: bool = False, render_tmpl=None, *,
                        device="cuda"):
    """Data-parallel tracking: the clip batch split over the mesh's
    shards (`make_mesh(device=device)` by default), B / n consecutive
    clips a shard with their seeds. B must be divisible by the mesh
    size. With `reduce_metrics` also returns the filter-health metrics
    reduced over every shard on the first shard's device: mean NIS over
    the batch, and the live-track fraction per frame, (T,). One
    `render_tmpl` shared by all clips is copied once to each distinct
    device of the mesh."""
    mesh = mesh or make_mesh(device=device)
    axis = mesh.axis_names[0]
    B = clips.shape[0]
    if B % mesh.size != 0:
        raise ValueError(f"batch {B} not divisible by mesh size "
                         f"{mesh.size} (axis {axis!r})")
    tmpls = {d: None if render_tmpl is None else render_tmpl.to(d)
             for d in mesh.distinct()}
    per = B // mesh.size
    seeds = None if seeds is None else np.asarray(seeds, np.float32)
    shards = []
    for i, dev in enumerate(mesh.devices):
        sl = slice(i * per, (i + 1) * per)
        with on_device(dev):
            shards.append(_pipeline.track_clips_arrays(
                _pipeline.upload(clips[sl], dev), cfg,
                None if seeds is None else _pipeline.upload(
                    seeds if seeds.ndim == 2 else seeds[sl], dev),
                tmpls[dev]))
    first = mesh.devices[0]
    outs = {k: torch.cat([s[k].to(first) for s in shards])
            for k in shards[0]}
    trajs = _pipeline.batch_trajectories(outs)
    if not reduce_metrics:
        return trajs
    with on_device(first):
        metrics = {"mean_nis": outs["nis"].mean(),
                   "live_fraction": outs["alive"].to(torch.float32).mean(
                       dim=(0, 2))}
    return trajs, {k: v.cpu().numpy() for k, v in metrics.items()}
