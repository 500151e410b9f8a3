"""Public API of the port (mirrors kalman_hydra_tpu/api.py).

With no config every entry point runs the reference's default, as the
reference does: `RunConfig()` (exact warp, f32 planes, 4-state CV
filter, 256 tracks, a fresh corner pool every frame), or `FlowConfig()`
for `flow`. Lucas-Kanade configs (`FlowConfig.method` "lk_sparse" or
"lk_dense") and the measurement channels (`EkfConfig.measurement`,
`filter_type`, `adaptive_q`) run through the same entry points;
`track_mesh` tracks the vertices of a body mesh with the mesh-render
channels; `pipeline.track_precomputed_flow` tracks over supplied
flows; `track_videos(sharded=True)` and `flow_sharded` split clips or
frame rows over a device mesh (`parallel/`). `track_video` and `smooth` take an in-memory clip or a
video path, and with streaming=True track frame by frame with O(1) card
memory (`pipeline.track_stream`). Every entry point runs on the card
unless the caller passes device="cpu"; without a card it raises.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

import numpy as np

from . import pipeline as _pipeline
from .config import EkfConfig, FlowConfig, RunConfig, TrackConfig
from .io import FrameStream, PrefetchStream, Trajectories, save as save_tracks
from .models.mesh import BodyMesh, mesh_from_mask
from .models.render import make_template
from .ops.color import grayscale_u8
from .ops.farneback import farneback
from .ops.lk import lk_dense
from .ops.segment import segment_body


def flow(a: np.ndarray, b: np.ndarray, cfg: Optional[FlowConfig] = None,
         initial: Optional[np.ndarray] = None, *,
         device="cuda") -> np.ndarray:
    """Dense flow between two frames, Farneback or dense LK by
    cfg.method, (H, W, 2) float32 on the host. Accepts uint8 or float
    frames, gray or colour; [0, 1]-normalized float frames are rescaled
    to the 0..255 range the solver constants assume. `initial`: optional
    (H, W, 2) warm start of Farneback's coarsest level (cv2's
    OPTFLOW_USE_INITIAL_FLOW); dense LK has none."""
    cfg = cfg or FlowConfig()
    if cfg.method not in ("farneback", "lk_dense"):
        raise ValueError("flow() needs a dense method")
    _pipeline.check_slice(RunConfig(flow=cfg), flow_only=True)
    if cfg.method == "lk_dense" and initial is not None:
        raise ValueError("initial flow is a Farneback feature "
                         "(cv2.OPTFLOW_USE_INITIAL_FLOW)")
    a_np, b_np = np.asarray(a), np.asarray(b)
    if a_np.dtype.kind == "f" and b_np.dtype.kind == "f":
        if max(float(a_np.max()), float(b_np.max())) <= 1.0:
            a_np, b_np = a_np * 255.0, b_np * 255.0
        a_np, b_np = a_np.astype(np.float32), b_np.astype(np.float32)
    a_t = grayscale_u8(_pipeline.upload(a_np, device))
    b_t = grayscale_u8(_pipeline.upload(b_np, device))
    if cfg.method == "lk_dense":
        return lk_dense(a_t, b_t, cfg).cpu().numpy()
    flow0 = (None if initial is None else
             _pipeline.upload(np.asarray(initial, np.float32), device))
    return farneback(a_t, b_t, cfg, flow0).cpu().numpy()


def track_video(source: Union[str, np.ndarray],
                cfg: Optional[RunConfig] = None,
                out_path: Optional[str] = None, streaming: bool = False,
                max_frames: Optional[int] = None, *,
                device="cuda") -> Trajectories:
    """Track a video file (a codec cv2 reads, or a .npz/.npy clip) or a
    (T, H, W[, 3]) uint8 array on `device`; optionally export. With
    streaming, frame by frame with O(1) card memory (a file is decoded
    on a background thread). As in the reference, `max_frames` bounds
    an array and a file read whole, not a streamed file."""
    cfg = cfg or RunConfig()
    if isinstance(source, str):
        stream = FrameStream(source)
        if streaming:
            # the decode thread owns the stream until it has read it out
            tracks = _pipeline.track_stream(PrefetchStream(stream, depth=4),
                                            cfg, device=device)
        else:
            try:
                frames = stream.read_all(limit=max_frames)
            finally:
                stream.close()
            tracks = _pipeline.track_clip(frames, cfg, device=device)
    else:
        frames = source if max_frames is None else source[:max_frames]
        if streaming:
            tracks = _pipeline.track_stream(iter(frames), cfg, device=device)
        else:
            tracks = _pipeline.track_clip(frames, cfg, device=device)
    if out_path:
        save_tracks(tracks, out_path)
    return tracks


def track_mesh(frames: np.ndarray, cfg: Optional[RunConfig] = None,
               mesh: Optional[BodyMesh] = None, n_vertices: int = 64,
               seed: int = 0, streaming: bool = False, *,
               device="cuda") -> Tuple[BodyMesh, Trajectories]:
    """Track a deformable body mesh through a (T, H, W[, 3]) uint8 clip
    with the mesh-render channel, on `device`: segment the body in frame
    0 (`ops.segment.segment_body`), mesh it (`models.mesh`), then track
    every vertex with the deformed-mesh appearance measurement
    (`models.render`). Pass `mesh` (a BodyMesh) to skip the segmentation.
    Returns (mesh, Trajectories); `models.mesh.mesh_strain_sequence` of
    the positions gives the strain.

    With no config: EkfConfig(measurement="render", q=0.5) (process noise
    sized for vertices that a deformation accelerates) and reinit=False.
    cfg.ekf.measurement "flow_render" puts dense flow first and the
    render update second; any other measurement becomes "render".
    tracks.num_tracks is the mesh's vertex count and reinit is off (the
    vertices are fixed). With streaming, frames 1.. go through
    `pipeline.track_stream` after frame 0."""
    if cfg is None:
        cfg = RunConfig(ekf=EkfConfig(measurement="render", q=0.5),
                        tracks=TrackConfig(reinit=False))
    frames = np.asarray(frames)
    gray0 = grayscale_u8(_pipeline.upload(frames[0], device))
    if mesh is None:
        mask = segment_body(gray0).cpu().numpy()
        mesh = mesh_from_mask(mask, n_points=n_vertices, seed=seed)
    tmpl = make_template(gray0, mesh, device=gray0.device)
    meas = (cfg.ekf.measurement
            if cfg.ekf.measurement in ("render", "flow_render")
            else "render")
    # one replace: ekf and tracks together, so the measurement/reinit
    # validation never sees a half-updated config
    cfg = cfg.replace(
        ekf=dataclasses.replace(cfg.ekf, measurement=meas),
        tracks=dataclasses.replace(cfg.tracks,
                                   num_tracks=mesh.vertices.shape[0],
                                   reinit=False))
    if streaming:
        tracks = _pipeline.track_stream(iter(frames[1:]), cfg,
                                        frame0=frames[0], render_tmpl=tmpl,
                                        seeds=mesh.vertices, device=device)
    else:
        tracks = _pipeline.track_clip(frames, cfg, seeds=mesh.vertices,
                                      render_tmpl=tmpl, device=device)
    return mesh, tracks


def flow_sequence(frames: np.ndarray, cfg: Optional[RunConfig] = None,
                  smooth: bool = False, *, device="cuda") -> np.ndarray:
    """Dense flow for each consecutive pair of a (T, H, W[, 3]) uint8
    clip, (T - 1, H, W, 2) on the host, optionally per-pixel-KF smoothed
    (BASELINE.json:8)."""
    cfg = cfg or RunConfig()
    return _pipeline.flow_sequence(_pipeline.upload(frames, device), cfg,
                                   smooth).cpu().numpy()


def smooth(frames_or_tracks: Union[str, np.ndarray],
           cfg: Optional[RunConfig] = None, *,
           device="cuda") -> Trajectories:
    """Track a video path or a (T, H, W[, 3]) uint8 clip with the RTS
    smoother on (BASELINE.json:11); a config whose smoother is off gets
    the default SmoothConfig(enabled=True)."""
    cfg = cfg or RunConfig()
    if not cfg.smooth.enabled:
        cfg = cfg.replace(smooth=cfg.smooth.__class__(enabled=True))
    return track_video(frames_or_tracks, cfg, device=device)


def flow_sharded(a: np.ndarray, b: np.ndarray,
                 cfg: Optional[FlowConfig] = None, method: str = "farneback",
                 impl: str = "xla", interpret: bool = False, *,
                 device="cuda") -> np.ndarray:
    """Dense flow of two (H, W) gray frames with the frame rows split
    over the device mesh (`parallel.make_mesh(device=device)`: every card,
    or the CPU), (H, W, 2) on the host. method="farneback" requires
    cfg.fast_warp > 0 (the warp's clamp bounds the halo) and runs K2's
    band mode on each shard's rows (`parallel.spatial.farneback_sharded`);
    "lk_dense" is `lk_dense_sharded`. `impl` and `interpret` are the
    reference's and are ignored, as the port ignores FlowConfig.impl."""
    cfg = cfg or FlowConfig(fast_warp=8)
    from .parallel import make_mesh
    from .parallel.spatial import farneback_sharded, lk_dense_sharded
    if method not in ("farneback", "lk_dense"):
        raise ValueError(f"unknown sharded method {method!r}")
    mesh = make_mesh(device=device)
    if method == "farneback":
        return farneback_sharded(a, b, cfg, mesh, impl=impl,
                                 interpret=interpret)
    return lk_dense_sharded(a, b, cfg, mesh)


def track_videos(clips: np.ndarray, cfg: Optional[RunConfig] = None,
                 sharded: bool = False, *,
                 device="cuda") -> List[Trajectories]:
    """Track a (B, T, H, W[, 3]) uint8 clip batch (BASELINE.json:10's
    multi-clip batch); returns B Trajectories.

    With cfg.pair_batch every clip's frame pairs share each flow launch
    (`pipeline.track_clips_pairflow`); otherwise the clips run one after
    another. sharded=True splits the clips over the device mesh
    (`parallel.track_clips_sharded` on `parallel.make_mesh(device=
    device)`: every card, each taking B / n of them; B must divide);
    otherwise they run on `device`."""
    cfg = cfg or RunConfig()
    if sharded:
        from .parallel import make_mesh, track_clips_sharded
        return track_clips_sharded(clips, cfg, make_mesh(device=device))
    return _pipeline.track_clips(clips, cfg, device=device)


def export(tracks: Trajectories, path: str) -> None:
    """Write trajectories to .npz (everything) or .csv (long format)."""
    save_tracks(tracks, path)
