"""The output check's control: the plain reference put in the program's
place with its flow layer in bfloat16, one precision below the
configuration's float32 (calibrate.py and the check's tests)."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import tracker


class Control:
    """Answers as drivers.Program gives them, from the reference."""

    def __init__(self, run_cfg: dict, device: str):
        self.cfg, self.device, self.ct = run_cfg, device, torch.bfloat16

    def _frames(self, frames):
        return (torch.from_numpy(np.asarray(f)).to(self.device)
                for f in frames)

    def clip(self, clip) -> list:
        return [tracker.track_frames(self._frames(clip), self.cfg, self.ct)]

    def batch(self, clips) -> list:
        return [self.clip(c)[0] for c in clips]

    def stream(self, frames) -> list:
        return [tracker.track_frames(self._frames(frames), self.cfg,
                                     self.ct)]
