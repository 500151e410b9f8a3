"""Host-side IO of the port: trajectory export (the reference's
`Trajectories`, shared so both packages return one type) and synthetic
clips."""

from kalman_hydra_tpu.io.export import Trajectories, load, save

from .synthetic import SyntheticTruth, moving_blob_clip

__all__ = ["Trajectories", "load", "save", "SyntheticTruth",
           "moving_blob_clip"]
