"""Distribution: a 1-D device mesh, data-parallel clip sharding and
row-band spatial sharding of one frame pair (port of
kalman_hydra_tpu/parallel/)."""
from .mesh import Mesh, make_mesh, track_clips_batch, track_clips_sharded
from .spatial import farneback_sharded, halo_exchange, lk_dense_sharded

__all__ = ["Mesh", "make_mesh", "track_clips_batch", "track_clips_sharded",
           "halo_exchange", "lk_dense_sharded", "farneback_sharded"]
