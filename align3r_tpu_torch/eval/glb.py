"""Self-contained binary glTF (.glb) scene export (port of
align3r_tpu/eval/glb.py).

Behavioural reference: the reference's dust3r/demo.py:100-130
(_convert_scene_output_to_glb) — the one artifact of the reference's gradio
demo our WebGL HTML viewer did not cover: a single self-contained .glb with
the fused scene geometry (merged grid mesh or point cloud) plus per-camera
frusta (textured image plane + wire edges), oriented to the first camera.

The container is written directly, without trimesh: glTF 2.0 is a JSON
chunk + one binary buffer chunk; meshes are primitives over
accessors/bufferViews into that buffer. Everything below is plain numpy +
struct + zlib. The camera planes' textures are PNG (`utils.png`) where the
JAX export embeds a JPEG through PIL; geometry, JSON layout and buffers are
otherwise the JAX export's.
"""
from __future__ import annotations

import json
import struct
from typing import List, Optional

import numpy as np

from align3r_tpu_torch.eval.viz import pts3d_to_mesh
from align3r_tpu_torch.utils.png import encode_png

# reference dust3r/viz.py CAM_COLORS (same palette, RGB uint8)
CAM_COLORS = [(255, 0, 0), (0, 0, 255), (0, 255, 0), (255, 0, 255),
              (255, 204, 0), (0, 204, 204), (128, 255, 255), (255, 128, 255),
              (255, 255, 128), (0, 0, 0), (128, 128, 128)]

_F32, _U8, _U32 = 5126, 5121, 5125            # glTF componentTypes
_ARRAY, _ELEMENT = 34962, 34963               # bufferView targets
_POINTS, _LINES, _TRIANGLES = 0, 1, 4


class GlbBuilder:
    """Accumulate geometry, then `save(path)` one .glb."""

    def __init__(self):
        self._bin = bytearray()
        self._views: List[dict] = []
        self._accessors: List[dict] = []
        self._meshes: List[dict] = []
        self._nodes: List[dict] = []
        self._materials: List[dict] = []
        self._images: List[dict] = []
        self._textures: List[dict] = []
        self._samplers: List[dict] = []

    # ------------------------------------------------------------ low level
    def _view(self, data: bytes, target: Optional[int]) -> int:
        while len(self._bin) % 4:
            self._bin.append(0)
        v = {"buffer": 0, "byteOffset": len(self._bin),
             "byteLength": len(data)}
        if target is not None:
            v["target"] = target
        self._bin.extend(data)
        self._views.append(v)
        return len(self._views) - 1

    def _accessor(self, arr: np.ndarray, ctype: int, atype: str,
                  target: Optional[int], normalized=False,
                  minmax=False) -> int:
        a = {"bufferView": self._view(arr.tobytes(), target),
             "componentType": ctype,
             "count": int(arr.shape[0]),
             "type": atype}
        if normalized:
            a["normalized"] = True
        if minmax:
            a["min"] = [float(x) for x in arr.min(axis=0)]
            a["max"] = [float(x) for x in arr.max(axis=0)]
        self._accessors.append(a)
        return len(self._accessors) - 1

    def _positions(self, verts) -> int:
        v = np.ascontiguousarray(np.asarray(verts, np.float32).reshape(-1, 3))
        if len(v) == 0:
            raise ValueError("empty vertex array")
        return self._accessor(v, _F32, "VEC3", _ARRAY, minmax=True)

    def _vcolors(self, colors, n) -> int:
        c = np.asarray(colors)
        if c.ndim == 1:
            c = np.broadcast_to(c, (n, 3))
        if c.dtype != np.uint8:
            c = np.clip(c * 255 if c.size and c.max() <= 1.0 + 1e-6 else c,
                        0, 255).astype(np.uint8)
        # VEC4 ubyte: a tightly-packed VEC3 ubyte attribute would need a
        # 3-byte stride, but glTF requires vertex attribute strides to be
        # multiples of 4 — pad with opaque alpha instead
        rgba = np.concatenate(
            [c.reshape(-1, 3), np.full((n, 1), 255, np.uint8)], axis=1)
        return self._accessor(np.ascontiguousarray(rgba), _U8, "VEC4",
                              _ARRAY, normalized=True)

    def _primitive_node(self, prim: dict, name: str):
        self._meshes.append({"primitives": [prim], "name": name})
        self._nodes.append({"mesh": len(self._meshes) - 1, "name": name})

    # ----------------------------------------------------------- geometries
    def add_points(self, verts, colors, name="points"):
        """Point cloud: verts (N, 3), colors (N, 3) uint8 or [0,1] float."""
        pos = self._positions(verts)
        n = self._accessors[pos]["count"]
        self._primitive_node(
            {"mode": _POINTS,
             "attributes": {"POSITION": pos,
                            "COLOR_0": self._vcolors(colors, n)}}, name)
        return self

    def add_mesh(self, verts, colors, faces, name="mesh"):
        """Vertex-colored triangle mesh."""
        pos = self._positions(verts)
        n = self._accessors[pos]["count"]
        idx = np.ascontiguousarray(
            np.asarray(faces, np.uint32).reshape(-1))
        self._primitive_node(
            {"mode": _TRIANGLES,
             "attributes": {"POSITION": pos,
                            "COLOR_0": self._vcolors(colors, n)},
             "indices": self._accessor(idx, _U32, "SCALAR", _ELEMENT)}, name)
        return self

    def add_lines(self, verts, segments, color=(255, 0, 0), name="lines"):
        """Line segments: verts (N, 3), segments (M, 2) index pairs,
        one uniform color."""
        pos = self._positions(verts)
        n = self._accessors[pos]["count"]
        idx = np.ascontiguousarray(
            np.asarray(segments, np.uint32).reshape(-1))
        self._primitive_node(
            {"mode": _LINES,
             "attributes": {"POSITION": pos,
                            "COLOR_0": self._vcolors(color, n)},
             "indices": self._accessor(idx, _U32, "SCALAR", _ELEMENT)}, name)
        return self

    def add_textured_quad(self, corners, image_rgb, name="image"):
        """4 corner vertices (tl, tr, br, bl order) textured with an RGB
        uint8 image (PNG-embedded). glTF UV origin is TOP-left, matching
        image row 0 — the same y-down orientation the HTML viewer needed."""
        v = np.asarray(corners, np.float32).reshape(4, 3)
        pos = self._positions(v)
        uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
        uva = self._accessor(np.ascontiguousarray(uv), _F32, "VEC2", _ARRAY)
        idx = np.array([0, 1, 2, 0, 2, 3, 0, 2, 1, 0, 3, 2], np.uint32)
        img = np.asarray(image_rgb)
        if img.dtype != np.uint8:
            img = np.clip(img * 255 if img.max() <= 1.0 + 1e-6 else img,
                          0, 255).astype(np.uint8)
        self._images.append({"bufferView": self._view(encode_png(img), None),
                             "mimeType": "image/png"})
        if not self._samplers:
            self._samplers.append({"magFilter": 9729, "minFilter": 9729,
                                   "wrapS": 33071, "wrapT": 33071})
        self._textures.append({"sampler": 0,
                               "source": len(self._images) - 1})
        self._materials.append({
            "pbrMetallicRoughness": {
                "baseColorTexture": {"index": len(self._textures) - 1},
                "metallicFactor": 0.0, "roughnessFactor": 1.0},
            "doubleSided": True})
        self._primitive_node(
            {"mode": _TRIANGLES,
             "attributes": {"POSITION": pos, "TEXCOORD_0": uva},
             "indices": self._accessor(idx, _U32, "SCALAR", _ELEMENT),
             "material": len(self._materials) - 1}, name)
        return self

    # ---------------------------------------------------------------- save
    def save(self, path: str) -> str:
        gltf = {
            "asset": {"version": "2.0", "generator": "align3r_tpu"},
            "scene": 0,
            "scenes": [{"nodes": list(range(len(self._nodes)))}],
            "nodes": self._nodes,
            "meshes": self._meshes,
            "accessors": self._accessors,
            "bufferViews": self._views,
            "buffers": [{"byteLength": len(self._bin)}],
        }
        for key, val in (("materials", self._materials),
                         ("images", self._images),
                         ("textures", self._textures),
                         ("samplers", self._samplers)):
            if val:
                gltf[key] = val
        js = json.dumps(gltf, separators=(",", ":")).encode()
        js += b" " * (-len(js) % 4)
        bin_ = bytes(self._bin) + b"\x00" * (-len(self._bin) % 4)
        total = 12 + 8 + len(js) + 8 + len(bin_)
        with open(path, "wb") as f:
            f.write(struct.pack("<4sII", b"glTF", 2, total))
            f.write(struct.pack("<I4s", len(js), b"JSON"))
            f.write(js)
            f.write(struct.pack("<I4s", len(bin_), b"BIN\x00"))
            f.write(bin_)
        return path


# --------------------------------------------------------------- scene glue

def _frustum_geometry(pose_c2w, focal, imsize, cam_size):
    """Apex + image-plane corners in world coords (tl, tr, br, bl) and the
    8 wire edges. OpenCV camera convention (x right, y down, z forward):
    corner (-x, -y, z) is pixel (0, 0) -> uv (0, 0)."""
    W, H = imsize
    z = cam_size
    x = z * W / (2 * float(focal))
    y = z * H / (2 * float(focal))
    local = np.array([[0, 0, 0],
                      [-x, -y, z], [x, -y, z], [x, y, z], [-x, y, z]],
                     np.float32)
    R, t = np.asarray(pose_c2w)[:3, :3], np.asarray(pose_c2w)[:3, 3]
    pts = local @ R.T + t
    edges = [(0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (2, 3), (3, 4), (4, 1)]
    return pts, edges


def _world_transform(cam0_c2w):
    """The reference orients the export to the first camera in OpenGL
    convention: apply_transform(inv(cams2world[0] @ OPENGL @ RotY(180)))
    (demo.py:100-130). OPENGL @ RotY(180) = diag(-1, -1, 1, 1)."""
    M = np.asarray(cam0_c2w, np.float64) @ np.diag([-1.0, -1.0, 1.0, 1.0])
    return np.linalg.inv(M)


def export_scene_glb(path, imgs, pts3d, masks, focals, cams2world,
                     cam_size: float = 0.05, cam_color=None,
                     as_pointcloud: bool = False,
                     transparent_cams: bool = False,
                     orient_to_first_cam: bool = True) -> str:
    """Reference-parity glb export (demo.py:100-130 signature order).

    imgs: (n, H, W, 3) in [0, 1]; pts3d: (n, H, W, 3); masks: (n, H, W)
    bool; focals: (n,); cams2world: (n, 4, 4).
    """
    imgs = np.asarray(imgs)
    pts3d = np.asarray(pts3d, np.float32)
    masks = np.asarray(masks, bool)
    cams2world = np.asarray(cams2world, np.float32)
    n = len(imgs)
    T = (_world_transform(cams2world[0]) if orient_to_first_cam
         else np.eye(4))
    tf = lambda v: (v @ T[:3, :3].T + T[:3, 3]).astype(np.float32)

    g = GlbBuilder()
    if as_pointcloud:
        pts = np.concatenate([p[m] for p, m in zip(pts3d, masks)])
        col = np.concatenate([im[m] for im, m in zip(imgs, masks)])
        g.add_points(tf(pts.reshape(-1, 3)), col.reshape(-1, 3), "scene")
    else:
        vs, cs, fs, off = [], [], [], 0
        for i in range(n):
            v, c, f = pts3d_to_mesh(pts3d[i], imgs[i], masks[i])
            vs.append(v)
            cs.append(c)
            fs.append(f + off)
            off += len(v)
        g.add_mesh(tf(np.concatenate(vs)), np.concatenate(cs),
                   np.concatenate(fs), "scene")

    for i, pose in enumerate(cams2world):
        if isinstance(cam_color, (list, np.ndarray)):
            color = tuple(np.asarray(cam_color[i]).tolist())
        else:
            color = cam_color or CAM_COLORS[i % len(CAM_COLORS)]
        H, W = imgs[i].shape[:2]
        f = float(np.ravel(focals[i])[0]) if focals is not None else \
            1.1 * max(H, W)
        pts, edges = _frustum_geometry(pose, f, (W, H), cam_size)
        g.add_lines(tf(pts), edges, color, f"cam_{i}_edges")
        if not transparent_cams:
            g.add_textured_quad(tf(pts[1:5]), imgs[i], f"cam_{i}_image")
    return g.save(path)


def export_scene_result_glb(scene, path: str, as_pointcloud: bool = False,
                            cam_size: float = 0.05,
                            transparent_cams: bool = False) -> str:
    """Convenience wrapper over the port's pipeline.SceneResult — the .glb twin of
    eval.html_viewer.export_scene_result_html (reference
    get_3D_model_from_scene, demo.py:111-135)."""
    imgs01 = (scene.imgs * 0.5 + 0.5) if scene.imgs is not None else \
        np.zeros(scene.get_pts3d().shape, np.float32)
    return export_scene_glb(path, imgs01, scene.get_pts3d(),
                            scene.get_masks(), scene.get_focals(),
                            scene.get_im_poses(), cam_size=cam_size,
                            as_pointcloud=as_pointcloud,
                            transparent_cams=transparent_cams)
