"""Run configuration, shared with the reference.

`kalman_hydra_tpu.config` is plain dataclasses with no jax import, so one
`RunConfig` drives both packages; the port's modules and its callers take
the classes from here.
"""

from kalman_hydra_tpu.config import (EkfConfig, FlowConfig, RunConfig,
                                     SmoothConfig, TrackConfig)

__all__ = ["EkfConfig", "FlowConfig", "RunConfig", "SmoothConfig",
           "TrackConfig"]
