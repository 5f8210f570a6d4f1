"""Scene visualisation: point clouds + camera frusta, sky segmentation
(port of align3r_tpu/eval/viz.py, numpy and scipy).

Behavioural reference: the reference's dust3r/viz.py (SceneViz:119-210,
pts3d_to_trimesh:38-76, segment_sky:345-381).

Export is native, without trimesh: a binary PLY writer for coloured point
clouds / triangle meshes. `SceneViz.show()` saves to disk instead of
opening a window. `segment_sky` needs neither OpenCV nor a native library:
OpenCV's uint8 RGB->HSV saturation and value are computed here, and the
connected components are scipy's.
"""
from __future__ import annotations

import struct
from typing import List

import numpy as np


def write_ply(path, vertices, colors=None, faces=None):
    """Binary little-endian PLY. vertices (N,3) float; colors (N,3) uint8;
    faces (M,3) int."""
    vertices = np.asarray(vertices, np.float32).reshape(-1, 3)
    n = len(vertices)
    has_c = colors is not None
    if has_c:
        colors = np.asarray(colors)
        if colors.dtype != np.uint8:
            colors = np.clip(colors * 255 if colors.max() <= 1.0 + 1e-6
                             else colors, 0, 255).astype(np.uint8)
        colors = colors.reshape(-1, 3)
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if has_c:
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    if faces is not None:
        faces = np.asarray(faces, np.int32).reshape(-1, 3)
        header += [f"element face {len(faces)}",
                   "property list uchar int vertex_indices"]
    header += ["end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        if has_c:
            rec = np.zeros(n, dtype=[("xyz", np.float32, 3), ("rgb", np.uint8, 3)])
            rec["xyz"] = vertices
            rec["rgb"] = colors
            f.write(rec.tobytes())
        else:
            f.write(vertices.tobytes())
        if faces is not None:
            rec = np.zeros(len(faces), dtype=[("n", np.uint8), ("idx", np.int32, 3)])
            rec["n"] = 3
            rec["idx"] = faces
            f.write(rec.tobytes())


def pts3d_to_mesh(pts3d, image_01, valid=None):
    """Pointmap (H, W, 3) -> grid-connected triangle mesh (viz.py:38-76).
    Returns (vertices, colors, faces)."""
    H, W, _ = pts3d.shape
    v = pts3d.reshape(-1, 3)
    c = image_01.reshape(-1, 3)
    idx = np.arange(H * W).reshape(H, W)
    a = idx[:-1, :-1].ravel()
    b = idx[:-1, 1:].ravel()
    cidx = idx[1:, :-1].ravel()
    d = idx[1:, 1:].ravel()
    faces = np.concatenate([np.stack([a, b, cidx], 1), np.stack([b, d, cidx], 1)])
    if valid is not None:
        ok = valid.reshape(-1)
        keep = ok[faces].all(axis=1)
        faces = faces[keep]
    return v, c, faces


def camera_frustum(pose_c2w, focal, imsize=(512, 288), cam_size=0.05):
    """Wireframe frustum vertices+edges for one camera (viz.py:213-246-ish)."""
    W, H = imsize
    z = cam_size
    x = z * W / (2 * focal)
    y = z * H / (2 * focal)
    corners = np.array([[0, 0, 0], [-x, -y, z], [x, -y, z], [x, y, z], [-x, y, z]])
    R, t = pose_c2w[:3, :3], pose_c2w[:3, 3]
    pts = corners @ R.T + t
    edges = [(0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (2, 3), (3, 4), (4, 1)]
    return pts, edges


class SceneViz:
    """Collect point clouds + cameras; save to PLY (reference SceneViz API)."""

    def __init__(self):
        self._pts: List[np.ndarray] = []
        self._cols: List[np.ndarray] = []

    def add_pointcloud(self, pts3d, color=(128, 128, 128), mask=None):
        pts3d = np.asarray(pts3d)
        if pts3d.ndim == 4:  # list-like stacked maps
            pts3d = pts3d.reshape(-1, 3)
        pts = pts3d.reshape(-1, 3)
        if isinstance(color, (tuple, list)) and np.ndim(color) == 1:
            cols = np.broadcast_to(np.asarray(color, np.uint8), pts.shape).copy()
        else:
            cols = np.asarray(color).reshape(-1, 3)
            if cols.dtype != np.uint8:
                # normalise floats to uint8 HERE: save() concatenates
                # pointcloud colors with uint8 camera colors, which would
                # defeat write_ply's max<=1 scaling heuristic and truncate
                # [0,1] floats to black
                if cols.size and cols.max() <= 1.0:
                    cols = cols * 255.0
                cols = np.clip(cols, 0, 255).astype(np.uint8)
        if mask is not None:
            m = np.asarray(mask).reshape(-1)
            pts, cols = pts[m], cols[m]
        self._pts.append(pts)
        self._cols.append(cols)
        return self

    def add_camera(self, pose_c2w, focal=500.0, color=(255, 0, 0),
                   imsize=(512, 288), cam_size=0.05):
        pts, edges = camera_frustum(np.asarray(pose_c2w), float(np.ravel(focal)[0]),
                                    imsize, cam_size)
        # densify edges into points so the frustum survives PLY point export
        seg = []
        for a, b in edges:
            seg.append(np.linspace(pts[a], pts[b], 16))
        seg = np.concatenate(seg)
        self.add_pointcloud(seg, color)
        return self

    def add_cameras(self, poses, focals=None, images=None, imsizes=None,
                    colors=None, cam_size=0.05):
        for i, p in enumerate(np.asarray(poses)):
            f = 500.0 if focals is None else float(np.ravel(focals[i])[0])
            c = (255, 0, 0) if colors is None else tuple(np.asarray(colors[i]).tolist())
            sz = (512, 288) if imsizes is None else tuple(imsizes[i])
            self.add_camera(p, f, c, sz, cam_size)
        return self

    def show(self, path="scene.ply", **kw):
        """No display in this environment: write the scene to a PLY file."""
        self.save(path)
        return path

    def save(self, path):
        pts = np.concatenate(self._pts) if self._pts else np.zeros((0, 3))
        cols = np.concatenate(self._cols) if self._cols else None
        write_ply(path, pts, cols)
        return path


_SDIV = np.concatenate([[0], np.round((255 << 12) / np.arange(1, 256))]).astype(np.int64)


def hsv_sv(img: np.ndarray):
    """Saturation and value of OpenCV's uint8 RGB->HSV: V = max, S =
    (diff T[V] + 2^11) >> 12 with T[i] = round((255 << 12) / i), T[0] = 0."""
    c = np.asarray(img, np.int64)
    v = c.max(-1)
    diff = v - c.min(-1)
    return ((diff * _SDIV[v] + (1 << 11)) >> 12).astype(np.uint8), v.astype(np.uint8)


def connected_components(mask: np.ndarray):
    """8-connected components of a (H, W) mask: (labels int32, n, areas (n+1,))."""
    from scipy import ndimage
    labels, n = ndimage.label(np.asarray(mask, np.uint8), structure=np.ones((3, 3)))
    areas = np.bincount(labels.ravel(), minlength=n + 1)
    return labels.astype(np.int32), int(n), areas.astype(np.int64)


def segment_sky(image_01):
    """HSV-heuristic sky mask (viz.py:345-381): bright, low-saturation upper
    region grown by connected components. image: (H, W, 3) in [0, 1]."""
    img = (np.asarray(image_01) * 255).astype(np.uint8)
    s, v = hsv_sv(img)
    cand = (s < 64) & (v > 128)
    labels, n, areas = connected_components(cand)
    H = img.shape[0]
    # keep components that touch the top third and are big enough
    from scipy import ndimage
    rows = np.broadcast_to(np.arange(H)[:, None], labels.shape)
    top = np.asarray(ndimage.minimum(rows, labels, np.arange(1, n + 1))) if n else []
    keep = np.zeros(n + 1, bool)
    keep[1:] = (np.asarray(top) < H / 3) & (areas[1:] > 0.01 * cand.size)
    return keep[labels]
