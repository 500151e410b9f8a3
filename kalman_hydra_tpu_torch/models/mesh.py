"""Deformable-mesh layer over the tracked body (port of
kalman_hydra_tpu/models/mesh.py).

Mesh generation is host NumPy and scipy, copied from the reference:
Lloyd-relaxed interior points of the segmented body (`sample_mask_points`,
the same `np.random.default_rng` draws), Delaunay triangulation with the
long-edge and sliver filters (`build_mesh`), and the strain-triggered
remeshing (`remesh_topology`, `remesh_resample`). Mesh tracking rides the
EKF track pipeline (the vertices are the tracks, with the mesh-render
measurement of models/render.py). The per-triangle deformation gradient
and its strain metrics (`triangle_deformation`) are torch, vectorised over
the triangles, on the device of their inputs; the strain sequences run it
on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import resolve_device as _device


@dataclass(frozen=True)
class BodyMesh:
    vertices: np.ndarray    # (V, 2) float32 rest positions (x, y)
    triangles: np.ndarray   # (T, 3) int32 vertex indices


def sample_mask_points(mask: np.ndarray, n_points: int,
                       seed: int = 0, relax_iters: int = 3) -> np.ndarray:
    """~Uniform interior points of a {0,1} mask with Lloyd relaxation."""
    rng = np.random.default_rng(seed)
    ys, xs = np.nonzero(mask > 0.5)
    if len(xs) < n_points:
        raise ValueError("mask too small for requested point count")
    sel = rng.choice(len(xs), size=n_points, replace=False)
    pts = np.stack([xs[sel], ys[sel]], axis=-1).astype(np.float64)
    interior = np.stack([xs, ys], axis=-1).astype(np.float64)
    # Lloyd: assign interior pixels to the nearest point, move it to their
    # centroid
    for _ in range(relax_iters):
        sub = interior[rng.choice(len(interior),
                                  size=min(20000, len(interior)),
                                  replace=False)]
        d2 = ((sub[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
        owner = d2.argmin(axis=1)
        for i in range(n_points):
            m = owner == i
            if m.any():
                pts[i] = sub[m].mean(axis=0)
    return pts.astype(np.float32)


def build_mesh(points: np.ndarray,
               max_edge: Optional[float] = None,
               min_quality: float = 0.0) -> BodyMesh:
    """Delaunay triangulation; optionally drop long-edge triangles
    (max_edge) and slivers (min_quality, see triangle_quality)."""
    from scipy.spatial import Delaunay
    tri = Delaunay(points)
    t = tri.simplices.astype(np.int32)
    if max_edge is not None:
        p = points[t]                      # (T, 3, 2)
        e = np.linalg.norm(p - np.roll(p, 1, axis=1), axis=-1)
        t = t[(e <= max_edge).all(axis=1)]
    if min_quality > 0.0:
        t = t[triangle_quality(points, t) >= min_quality]
    return BodyMesh(vertices=points.astype(np.float32), triangles=t)


def mesh_from_mask(mask: np.ndarray, n_points: int = 64,
                   seed: int = 0) -> BodyMesh:
    pts = sample_mask_points(mask, n_points, seed=seed)
    h, w = mask.shape
    return build_mesh(pts, max_edge=0.35 * max(h, w))


def triangle_deformation(rest: torch.Tensor, current: torch.Tensor,
                         triangles: torch.Tensor) -> dict:
    """Per-triangle affine deformation gradient F and strain metrics, on
    the device of the inputs.

    rest/current: (V, 2) vertex positions; triangles: (T, 3) indices.
    Returns {"F": (T, 2, 2), "area_ratio": (T,), "max_shear": (T,)}. A
    rest triangle with |det| < 1e-8 divides by 1e-8, as the reference
    does. The 2 x 2 products are written out (no matmul: TF32 and the
    library's summation order stay out of it)."""
    tri = triangles.to(torch.int64)
    r = rest[tri]                               # (T, 3, 2)
    c = current[tri]
    # D[:, i, j] = component i of edge j (edges v1 - v0, v2 - v0)
    r10, r20 = r[:, 1] - r[:, 0], r[:, 2] - r[:, 0]
    c10, c20 = c[:, 1] - c[:, 0], c[:, 2] - c[:, 0]
    a, b = r10[:, 0], r20[:, 0]                 # Dr = [[a, b], [cc, d]]
    cc, d = r10[:, 1], r20[:, 1]
    det = a * d - b * cc
    det = torch.where(torch.abs(det) < 1e-8, torch.full_like(det, 1e-8), det)
    i00, i01, i10, i11 = d / det, -b / det, -cc / det, a / det
    p, q = c10[:, 0], c20[:, 0]                 # Dc = [[p, q], [s, u]]
    s, u = c10[:, 1], c20[:, 1]
    f00 = p * i00 + q * i10
    f01 = p * i01 + q * i11
    f10 = s * i00 + u * i10
    f11 = s * i01 + u * i11
    F = torch.stack([torch.stack([f00, f01], -1),
                     torch.stack([f10, f11], -1)], -2)
    # right Cauchy-Green C = F^T F
    C00 = f00 * f00 + f10 * f10
    C01 = f00 * f01 + f10 * f11
    C11 = f01 * f01 + f11 * f11
    tr = C00 + C11
    disc = torch.sqrt(torch.clamp((C00 - C11) ** 2 + 4 * C01 ** 2, min=0.0))
    lam1 = torch.sqrt(torch.clamp((tr + disc) * 0.5, min=0.0))
    lam2 = torch.sqrt(torch.clamp((tr - disc) * 0.5, min=0.0))
    detF = f00 * f11 - f01 * f10
    return {"F": F, "area_ratio": detF,
            "max_shear": lam1 / torch.clamp(lam2, min=1e-8)}


def triangle_quality(points: np.ndarray, triangles: np.ndarray) -> np.ndarray:
    """Per-triangle shape quality 4*sqrt(3)*area / sum(edge^2):
    1 for equilateral, -> 0 for slivers (standard FEM quality measure)."""
    p = np.asarray(points, np.float64)[np.asarray(triangles)]
    e0 = p[:, 1] - p[:, 0]
    e1 = p[:, 2] - p[:, 1]
    e2 = p[:, 0] - p[:, 2]
    area = 0.5 * np.abs(e0[:, 0] * (-e2[:, 1]) - e0[:, 1] * (-e2[:, 0]))
    ssq = (e0 ** 2).sum(-1) + (e1 ** 2).sum(-1) + (e2 ** 2).sum(-1)
    return (4.0 * np.sqrt(3.0) * area / np.maximum(ssq, 1e-12)).astype(
        np.float32)


def remesh_topology(positions: np.ndarray,
                    max_edge: Optional[float] = None,
                    min_quality: float = 0.0) -> BodyMesh:
    """Rebuild the topology on the current (deformed) vertex positions.

    The vertex set, and so the track ids, is unchanged; only the
    triangulation is re-run, so triangle quality resets to Delaunay-optimal
    for the deformed configuration and the rest state becomes
    `positions`."""
    return build_mesh(np.asarray(positions, np.float32), max_edge=max_edge,
                      min_quality=min_quality)


def remesh_resample(positions: np.ndarray, n_points: Optional[int] = None,
                    radius: float = 8.0, seed: int = 0):
    """Full Lloyd + Delaunay resample of the deformed body.

    Rasterizes the union of disks around the current vertices (the body's
    footprint as the tracker sees it), samples ~uniform interior points
    with Lloyd relaxation, triangulates, and maps every new vertex to its
    nearest old vertex (argmin: the lowest index on ties), the track-id
    remap that hands filter state to the new seeds. Returns (BodyMesh,
    vertex_map (V',))."""
    pos = np.asarray(positions, np.float64)
    n_points = n_points or len(pos)
    lo = np.floor(pos.min(axis=0) - radius).astype(int)
    hi = np.ceil(pos.max(axis=0) + radius).astype(int) + 1
    w, h = hi[0] - lo[0], hi[1] - lo[1]
    yy, xx = np.mgrid[0:h, 0:w]
    mask = np.zeros((h, w), bool)
    for p in pos:
        mask |= ((xx - (p[0] - lo[0])) ** 2
                 + (yy - (p[1] - lo[1])) ** 2) <= radius * radius
    pts = sample_mask_points(mask.astype(np.float32), n_points, seed=seed)
    pts = pts + lo[None, :].astype(np.float32)
    mesh = build_mesh(pts, max_edge=3.5 * radius)
    d2 = ((pts[:, None, :] - pos[None, :, :].astype(np.float32)) ** 2).sum(-1)
    vertex_map = d2.argmin(axis=1).astype(np.int32)
    return mesh, vertex_map


def _deformation_np(rest: np.ndarray, cur: np.ndarray, tris: np.ndarray,
                    device) -> dict:
    """triangle_deformation of host arrays on `device`, back on the host."""
    def up(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)
    out = triangle_deformation(up(rest, np.float32), up(cur, np.float32),
                               up(tris, np.int64))
    return {k: v.cpu().numpy() for k, v in out.items()}


def mesh_strain_sequence_dynamic(mesh: BodyMesh, positions: np.ndarray,
                                 shear_threshold: float = 1.5,
                                 max_edge: Optional[float] = None,
                                 min_quality: float = 0.0, *,
                                 device="cuda") -> dict:
    """Strain over a tracked sequence with strain-triggered remeshing.

    Walks the (T, V, 2) vertex trajectories; whenever the 95th-percentile
    per-triangle shear (relative to the current rest configuration)
    exceeds `shear_threshold`, the topology is rebuilt on the current
    positions and the rest state resets there. The deformation of each
    frame runs on `device` (the card unless the caller asks for "cpu");
    the percentile and the remesh decision are taken on the host.

    Returns {"max_shear_p95", "quality_min", "quality_mean"} (T,) and
    "events" (the frame indices that remeshed)."""
    dev = _device(device)
    rest = np.asarray(mesh.vertices, np.float32)
    tris = mesh.triangles
    events = []
    shear_p95 = np.empty(len(positions), np.float32)
    q_min = np.empty(len(positions), np.float32)
    q_mean = np.empty(len(positions), np.float32)
    for t, cur in enumerate(np.asarray(positions, np.float32)):
        d = _deformation_np(rest, cur, tris, dev)
        s95 = float(np.percentile(d["max_shear"], 95))
        if s95 > shear_threshold:
            new_mesh = remesh_topology(cur, max_edge=max_edge,
                                       min_quality=min_quality)
            rest, tris = new_mesh.vertices, new_mesh.triangles
            events.append(t)
            d = _deformation_np(rest, cur, tris, dev)
            s95 = float(np.percentile(d["max_shear"], 95))
        q = triangle_quality(cur, tris)
        shear_p95[t] = s95
        q_min[t] = float(q.min()) if len(q) else 0.0
        q_mean[t] = float(q.mean()) if len(q) else 0.0
    return {"max_shear_p95": shear_p95, "quality_min": q_min,
            "quality_mean": q_mean, "events": events}


def mesh_strain_sequence(mesh: BodyMesh, positions: np.ndarray,
                         alive: Optional[np.ndarray] = None, *,
                         device="cuda") -> dict:
    """Strain over a tracked sequence: the per-frame deformation of the
    (T, V, 2) vertex trajectories (the pipeline's output seeded with
    mesh.vertices) against the rest mesh, on `device` (the card unless
    the caller asks for "cpu"), stacked over T on the host. `alive` is
    accepted, and unused, as in the reference."""
    dev = _device(device)
    pos = torch.from_numpy(np.ascontiguousarray(positions, np.float32)).to(dev)
    rest = torch.from_numpy(np.ascontiguousarray(mesh.vertices,
                                                 np.float32)).to(dev)
    tris = torch.from_numpy(np.ascontiguousarray(mesh.triangles,
                                                 np.int64)).to(dev)
    outs = [triangle_deformation(rest, p, tris) for p in pos]
    return {k: torch.stack([o[k] for o in outs]).cpu().numpy()
            for k in outs[0]}
