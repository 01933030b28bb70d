"""Depth-map → view-space triangle mesh (vectorized).

Re-implements the behavior of myutils/mesh_recon.py:41-331
(depth_file_to_mesh → detect_boundary_points) without the O(H·W) Python
triple loops: boundary detection, background-depth propagation and
triangulation are all whole-image numpy array ops (the propagation walk
becomes pointer-jumping, O(log N) passes).

Pipeline role: the reference builds this mesh for Mitsuba; here the
renderer consumes the depth map directly, so the PLY artifact exists for
output-layout parity ({save_name}.ply, SURVEY.md §2.10), for object
insertion, and for external tools.

Conventions match the reference: K = [[f,0,cx],[0,f,cy],[0,0,1]] with
f = 256/tan(17.5°), cx=cy=(512-1)/2 (mesh_recon.py:17-25); camera-space
points P = K⁻¹·(u,v,1)·depth; the caller flips depth (2·max−d) first and
rotates the mesh 180° about x afterwards (inverse_img_w_mi.py:720-727).
"""

from __future__ import annotations

import math

import numpy as np


def default_intrinsics(width: int = 512, height: int = 512,
                       fov_deg: float = 35.0):
    f = (width / 2) / math.tan(math.radians(fov_deg) / 2)
    cx = (width - 1) / 2
    cy = (height - 1) / 2
    return np.array([[f, 0, cx], [0, f, cy], [0, 0, 1]], np.float64)


def _unproject(depth, K):
    h, w = depth.shape
    Kinv = np.linalg.inv(K)
    u, v = np.meshgrid(np.arange(w), np.arange(h))
    pix = np.stack([u, v, np.ones_like(u)], axis=-1).astype(np.float64)
    return (pix @ Kinv.T) * depth[..., None]


def _tri_view_angle(p0, p1, p2):
    """Angle (degrees) between triangle normal and the view ray through its
    center (mesh_recon.py:76-85,126-134). Inputs (..., 3)."""
    n = np.cross(p0 - p1, p0 - p2)
    n_norm = np.linalg.norm(n, axis=-1)
    c = (p0 + p1 + p2) / 3.0
    c_norm = np.linalg.norm(c, axis=-1)
    denom = np.maximum(n_norm * c_norm, 1e-12)
    s = np.abs(np.sum(n * c, axis=-1)) / denom
    return np.degrees(np.arcsin(np.clip(s, 0.0, 1.0)))


def depth_to_mesh_native(depth, K=None, min_angle: float = 6.0,
                         depth_scale: float = 1.0):
    """Native (C++) depth→mesh fast path (native/mesh_recon.cpp).

    Same contract as depth_to_mesh; raises on loader failure — use
    depth_to_mesh(..., impl="auto") for automatic fallback.
    """
    import ctypes

    from materialist_tpu_torch.io import native

    depth = np.ascontiguousarray(np.asarray(depth, np.float32))
    if depth.ndim == 3:
        depth = depth[..., 0]
    depth = depth / depth_scale
    h, w = depth.shape
    if K is None:
        K = default_intrinsics(w, h)
    lib = native.load()
    handle = lib.mesh_build(
        depth.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), h, w,
        float(K[0, 0]), float(K[1, 1]), float(K[0, 2]), float(K[1, 2]),
        float(min_angle))
    try:
        nv = ctypes.c_int64()
        nf = ctypes.c_int64()
        nb = ctypes.c_int64()
        lib.mesh_counts(handle, ctypes.byref(nv), ctypes.byref(nf),
                        ctypes.byref(nb))
        verts = np.empty((nv.value, 3), np.float32)
        faces = np.empty((nf.value, 3), np.int32)
        boundary = np.empty((nb.value, 3), np.float32)
        lib.mesh_copy(handle,
                      verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                      faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                      boundary.ctypes.data_as(
                          ctypes.POINTER(ctypes.c_float)))
    finally:
        lib.mesh_free(handle)
    return verts, faces, boundary


def depth_to_mesh(depth, K=None, min_angle: float = 6.0,
                  depth_scale: float = 1.0, impl: str = "auto"):
    """Build the occlusion-aware heightfield mesh.

    ``impl``: "auto" tries the native C++ builder and falls back to the
    vectorized numpy path; "numpy"/"native" force one.
    Returns (vertices (N,3) float32, faces (M,3) int32,
    boundary_points (B,3) float32).
    """
    if impl in ("auto", "native"):
        try:
            return depth_to_mesh_native(depth, K, min_angle, depth_scale)
        except Exception:
            if impl == "native":
                raise
    depth = np.asarray(depth, np.float32).copy()
    if depth.ndim == 3:
        depth = depth[..., 0]
    depth = depth / depth_scale
    h, w = depth.shape
    if K is None:
        K = default_intrinsics(w, h)

    cam = _unproject(depth, K)  # (h, w, 3)

    # ---- boundary detection (mesh_recon.py:113-156): for each interior
    # pixel, four fan triangles (center, axis-neighbor, axis-neighbor);
    # grazing triangles at a depth step mark the pixel as an occlusion
    # boundary referring to its deepest involved neighbor.
    c = cam[1:-1, 1:-1]
    below = cam[2:, 1:-1]
    right = cam[1:-1, 2:]
    above = cam[:-2, 1:-1]
    left = cam[1:-1, :-2]
    d_c = depth[1:-1, 1:-1]
    d_b, d_r, d_a, d_l = (depth[2:, 1:-1], depth[1:-1, 2:],
                          depth[:-2, 1:-1], depth[1:-1, :-2])

    # fan combinations (0,1,2),(0,2,3),(0,3,4),(0,4,1) over
    # [center, below, right, above, left]; each entry carries the ACTUAL
    # (di, dj) offsets of its two neighbors so the refer chain points at
    # the pixel whose depth was chosen
    tris = [(below, right, d_b, d_r, (1, 0), (0, 1)),
            (right, above, d_r, d_a, (0, 1), (-1, 0)),
            (above, left, d_a, d_l, (-1, 0), (0, -1)),
            (left, below, d_l, d_b, (0, -1), (1, 0))]
    ref_i = np.full((h, w), -1, np.int32)
    ref_j = np.full((h, w), -1, np.int32)
    ref_d = np.full((h, w), -np.inf, np.float32)
    is_boundary = np.zeros((h - 2, w - 2), bool)
    ii, jj = np.meshgrid(np.arange(1, h - 1), np.arange(1, w - 1),
                         indexing="ij")
    for pa, pb, da, db, off_a, off_b in tris:
        ang = _tri_view_angle(c, pa, pb)
        graz = ang < min_angle
        # the reference checks the two *axis* neighbors of this fan quadrant
        step = graz & ((d_c < da) | (d_c < db))
        is_boundary |= step
        # refer to the deeper of the two neighbors
        use_a = da > db
        cand_d = np.where(use_a, da, db)
        cand_ii = np.where(use_a, ii + off_a[0], ii + off_b[0])
        cand_jj = np.where(use_a, jj + off_a[1], jj + off_b[1])
        upd = step & (cand_d > ref_d[1:-1, 1:-1])
        ref_d[1:-1, 1:-1] = np.where(upd, cand_d, ref_d[1:-1, 1:-1])
        ref_i[1:-1, 1:-1] = np.where(upd, cand_ii, ref_i[1:-1, 1:-1])
        ref_j[1:-1, 1:-1] = np.where(upd, cand_jj, ref_j[1:-1, 1:-1])

    boundary_mask = np.zeros((h, w), bool)
    boundary_mask[1:-1, 1:-1] = is_boundary
    boundary_points = cam[boundary_mask].astype(np.float32)

    # ---- background-depth propagation (mesh_recon.py:161-175) via
    # pointer jumping: follow refer chains to their roots in O(log N).
    flat_ref = np.where(ref_i.reshape(-1) >= 0,
                        ref_i.reshape(-1) * w + ref_j.reshape(-1),
                        np.arange(h * w))
    for _ in range(int(np.ceil(np.log2(h * w))) + 1):
        nxt = flat_ref[flat_ref]
        if np.array_equal(nxt, flat_ref):
            break
        flat_ref = nxt
    new_depth = depth.reshape(-1)[flat_ref].reshape(h, w)
    new_cam = _unproject(new_depth, K)

    # ---- triangulation (mesh_recon.py:182-300): 2 triangles per quad;
    # grazing triangles get their nearest vertex duplicated and pushed to
    # the quad's largest depth (single-level fallback).
    base_idx = np.arange(h * w).reshape(h, w)
    quad_i, quad_j = np.meshgrid(np.arange(h - 1), np.arange(w - 1),
                                 indexing="ij")

    verts_list = [new_cam.reshape(-1, 3)]
    faces = []
    extra_coords = {}

    def emit(tri_idx, tri_pts, tri_d, tri_pix):
        """tri_idx (Q,3) flat ids, tri_pts (Q,3,3), tri_d (Q,3) depths,
        tri_pix (Q,3,2) (i,j). Returns faces after fallback."""
        ang = _tri_view_angle(tri_pts[:, 0], tri_pts[:, 1], tri_pts[:, 2])
        ok = ang >= min_angle
        nonzero = (tri_d > 1e-12).all(axis=-1)
        good = ok & nonzero
        faces.append(tri_idx[good])

        bad = (~ok) & nonzero
        if not bad.any():
            return
        b_idx = tri_idx[bad]
        b_pts = tri_pts[bad].copy()
        b_d = tri_d[bad]
        b_pix = tri_pix[bad]
        closest = np.argmin(b_d, axis=-1)
        largest = np.max(b_d, axis=-1)
        rows = np.arange(len(b_idx))
        cpix = b_pix[rows, closest]  # (B,2) (i,j)
        # duplicate vertex at the largest depth, deduplicated per pixel
        Kinv = np.linalg.inv(K)
        dup_pts = (np.stack([cpix[:, 1], cpix[:, 0],
                             np.ones(len(cpix))], axis=-1) @ Kinv.T) \
            * largest[:, None]
        new_ids = np.empty(len(b_idx), np.int64)
        for r in range(len(b_idx)):
            key = (int(cpix[r, 0]), int(cpix[r, 1]))
            if key not in extra_coords:
                extra_coords[key] = (len(extra_coords), dup_pts[r])
            new_ids[r] = h * w + extra_coords[key][0]
        b_idx2 = b_idx.copy()
        b_idx2[rows, closest] = new_ids
        b_pts[rows, closest] = dup_pts
        ang2 = _tri_view_angle(b_pts[:, 0], b_pts[:, 1], b_pts[:, 2])
        faces.append(b_idx2[ang2 >= min_angle])

    def gather(ii, jj):
        return (base_idx[ii, jj].reshape(-1),
                new_cam[ii, jj].reshape(-1, 3),
                new_depth[ii, jj].reshape(-1),
                np.stack([ii.reshape(-1), jj.reshape(-1)], axis=-1))

    i0, j0 = quad_i, quad_j
    # triangle A: (i,j), (i+1,j), (i,j+1)
    parts = [gather(i0, j0), gather(i0 + 1, j0), gather(i0, j0 + 1)]
    emit(np.stack([p[0] for p in parts], -1),
         np.stack([p[1] for p in parts], 1),
         np.stack([p[2] for p in parts], -1),
         np.stack([p[3] for p in parts], 1))
    # triangle B: (i,j+1), (i+1,j), (i+1,j+1)
    parts = [gather(i0, j0 + 1), gather(i0 + 1, j0), gather(i0 + 1, j0 + 1)]
    emit(np.stack([p[0] for p in parts], -1),
         np.stack([p[1] for p in parts], 1),
         np.stack([p[2] for p in parts], -1),
         np.stack([p[3] for p in parts], 1))

    if extra_coords:
        extra = np.zeros((len(extra_coords), 3), np.float64)
        for _, (slot, pt) in extra_coords.items():
            extra[slot] = pt
        verts_list.append(extra)
    vertices = np.concatenate(verts_list, axis=0).astype(np.float32)
    all_faces = np.concatenate([f for f in faces if len(f)], axis=0) \
        if faces else np.zeros((0, 3), np.int64)
    return vertices, all_faces.astype(np.int32), boundary_points


def rotate_mesh_around_x(vertices: np.ndarray, degrees: float = 180.0):
    """Rotate vertices about the x axis (mesh_recon.py:666-685); 180° maps
    (x,y,z) → (x,−y,−z), aligning the o3d camera frame with Mitsuba's."""
    t = math.radians(degrees)
    rot = np.array([[1, 0, 0],
                    [0, math.cos(t), -math.sin(t)],
                    [0, math.sin(t), math.cos(t)]], np.float32)
    return vertices @ rot.T


def depth_file_to_mesh_ply(depth, ply_path: str, min_angle: float = 6.0,
                           rotate_deg: float = 180.0):
    """End-to-end: depth (already flipped by the caller) → rotated PLY.

    Mirrors inverse_img_w_mi.py:725-727. Returns (#verts, #faces)."""
    from materialist_tpu_torch.geometry.ply import write_ply
    verts, faces, _ = depth_to_mesh(depth, min_angle=min_angle)
    verts = rotate_mesh_around_x(verts, rotate_deg)
    write_ply(ply_path, verts, faces)
    return len(verts), len(faces)
