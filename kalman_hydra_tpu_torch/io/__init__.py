"""Host-side IO of the port: video decode and frame streaming, the
optional native loader (`native_loader`), trajectory export (the port's
own copy of the reference's `Trajectories`, `save` and `load`), synthetic
clips, and debug overlays (`overlay`)."""

from .export import Trajectories, load, save
from .synthetic import (SyntheticTruth, circling_blob_clip, moving_blob_clip,
                        rotating_pair, sinusoidal_warp_clip, translating_pair)
from .video import (FrameStream, PrefetchStream, device_prefetch, open_video,
                    write_video)

__all__ = ["Trajectories", "load", "save", "SyntheticTruth",
           "moving_blob_clip", "translating_pair", "rotating_pair",
           "sinusoidal_warp_clip", "circling_blob_clip", "FrameStream",
           "PrefetchStream", "device_prefetch", "open_video", "write_video"]
