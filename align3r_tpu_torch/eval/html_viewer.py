"""Self-contained interactive HTML scene viewer (port of
align3r_tpu/eval/html_viewer.py; a gradio-demo substitute).

The reference ships a gradio app (dust3r/demo.py:1-283) that renders the
fused point cloud + camera frusta in the browser via trimesh/gradio. This
exports one standalone .html file instead, with the point cloud embedded as
base64 binary and a small inline WebGL renderer — open it in any browser,
no server, no network, drag to orbit / wheel to zoom.

Exported content mirrors the gradio demo's scene: conf-thresholded fused
points with RGB colours, camera frusta, per-frame toggles. The camera
thumbnails are PIL's default (bicubic) resize of each frame to 128 columns,
as in the JAX viewer, embedded as PNG (written by `utils.png`) where the
JAX viewer embeds a JPEG through PIL.
"""
from __future__ import annotations

import base64
import json
import os

import numpy as np

from align3r_tpu_torch.inference.images import resize_pil
from align3r_tpu_torch.utils.png import encode_png

_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>Align3R scene</title>
<style>
 body {{ margin: 0; background: #111; color: #ddd; font: 13px sans-serif; }}
 #hud {{ position: fixed; top: 8px; left: 8px; z-index: 2; }}
 canvas {{ display: block; }}
</style></head>
<body>
<div id="hud">{title} — {npts} pts, {ncams} cams | drag: orbit, wheel: zoom,
 shift-drag: pan | <label><input type="checkbox" id="frusta" checked> frusta</label>
 <label id="meshlab" style="display:none"><input type="checkbox" id="mesh"
   checked> mesh</label>
 | <label>min conf <input type="range" id="confthr" min="0" max="100"
   value="0" style="width:90px; vertical-align:middle"></label>
 <span id="confval"></span>
 | <label>cam size <input type="range" id="camsize" min="10" max="400"
   value="100" style="width:70px; vertical-align:middle"></label>
 <label><input type="checkbox" id="camimgs" checked> images</label></div>
<canvas id="gl"></canvas>
<script>
const PTS_B64 = "{pts_b64}";
const COL_B64 = "{col_b64}";
const CONF_B64 = "{conf_b64}";
const IDX_B64 = "{idx_b64}";
const CAMS = {cams_json};
function unb64(s) {{
  const raw = atob(s); const a = new Uint8Array(raw.length);
  for (let i = 0; i < raw.length; i++) a[i] = raw.charCodeAt(i);
  return a;
}}
const pts = new Float32Array(unb64(PTS_B64).buffer);
const col = new Uint8Array(unb64(COL_B64).buffer);
const conf = new Float32Array(unb64(CONF_B64).buffer);
const IDX = IDX_B64 ? new Uint32Array(unb64(IDX_B64).buffer) : null;
const N = pts.length / 3;
let confLo = Infinity, confHi = -Infinity;
for (let i = 0; i < conf.length; i++) {{
  if (conf[i] < -1e29) continue;   // invalid-vertex sentinel (mesh grids)
  if (conf[i] < confLo) confLo = conf[i];
  if (conf[i] > confHi) confHi = conf[i];
}}
if (!isFinite(confLo)) {{ confLo = 0; confHi = 1; }}

const canvas = document.getElementById("gl");
const gl = canvas.getContext("webgl");
const vs = `attribute vec3 p; attribute vec3 c; attribute float k;
 uniform mat4 mvp; varying vec3 vc; varying float vk;
 void main() {{ gl_Position = mvp * vec4(p, 1.0);
 gl_PointSize = 2.0; vc = c; vk = k; }}`;
const fs = `precision mediump float; varying vec3 vc; varying float vk;
 uniform float uthr;
 void main() {{ if (vk < uthr) discard; gl_FragColor = vec4(vc, 1.0); }}`;
function shader(type, src) {{ const s = gl.createShader(type);
 gl.shaderSource(s, src); gl.compileShader(s); return s; }}
const prog = gl.createProgram();
gl.attachShader(prog, shader(gl.VERTEX_SHADER, vs));
gl.attachShader(prog, shader(gl.FRAGMENT_SHADER, fs));
gl.linkProgram(prog); gl.useProgram(prog);

const pbuf = gl.createBuffer();
gl.bindBuffer(gl.ARRAY_BUFFER, pbuf);
gl.bufferData(gl.ARRAY_BUFFER, pts, gl.STATIC_DRAW);
const ap = gl.getAttribLocation(prog, "p");
gl.enableVertexAttribArray(ap);
gl.vertexAttribPointer(ap, 3, gl.FLOAT, false, 0, 0);
const colf = new Float32Array(col.length);
for (let i = 0; i < col.length; i++) colf[i] = col[i] / 255.0;
const cbuf = gl.createBuffer();
gl.bindBuffer(gl.ARRAY_BUFFER, cbuf);
gl.bufferData(gl.ARRAY_BUFFER, colf, gl.STATIC_DRAW);
const ac = gl.getAttribLocation(prog, "c");
gl.enableVertexAttribArray(ac);
gl.vertexAttribPointer(ac, 3, gl.FLOAT, false, 0, 0);
const kbuf = gl.createBuffer();
gl.bindBuffer(gl.ARRAY_BUFFER, kbuf);
gl.bufferData(gl.ARRAY_BUFFER, conf, gl.STATIC_DRAW);
const ak = gl.getAttribLocation(prog, "k");
gl.enableVertexAttribArray(ak);
gl.vertexAttribPointer(ak, 1, gl.FLOAT, false, 0, 0);
let ibuf = null;
if (IDX) {{
  gl.getExtension("OES_element_index_uint");  // uint32 indices (WebGL1)
  ibuf = gl.createBuffer();
  gl.bindBuffer(gl.ELEMENT_ARRAY_BUFFER, ibuf);
  gl.bufferData(gl.ELEMENT_ARRAY_BUFFER, IDX, gl.STATIC_DRAW);
}}

// frusta as line segments, rebuilt when the cam-size slider moves
const fbuf = gl.createBuffer();
let fARR = new Float32Array(0);
function camCorners(cam, scaleMul) {{
  const T = cam.pose, s = cam.scale * scaleMul;
  const w = s, h = s * (cam.aspect || 0.66), z = s * 1.2;
  const corners = [[-w,-h,z],[w,-h,z],[w,h,z],[-w,h,z]];
  const tf = (p) => [
    T[0][0]*p[0]+T[0][1]*p[1]+T[0][2]*p[2]+T[0][3],
    T[1][0]*p[0]+T[1][1]*p[1]+T[1][2]*p[2]+T[1][3],
    T[2][0]*p[0]+T[2][1]*p[1]+T[2][2]*p[2]+T[2][3]];
  return {{ o: tf([0,0,0]), cs: corners.map(tf) }};
}}
let planeARR = new Float32Array(0);
function buildFrusta(scaleMul) {{
  let fverts = [], pverts = [];
  for (const cam of CAMS) {{
    const {{ o, cs }} = camCorners(cam, scaleMul);
    for (let i = 0; i < 4; i++) {{
      fverts.push(...o, ...cs[i], ...cs[i], ...cs[(i+1)%4]);
    }}
    // image plane: two triangles over the frustum base. Camera convention
    // is y-down (image row 0 projects to -y), and the uploaded DOM image's
    // texture v=0 is its top row (no UNPACK_FLIP_Y): -h corners get v=0
    pverts.push(...cs[0], 0, 0, ...cs[1], 1, 0, ...cs[2], 1, 1,
                ...cs[0], 0, 0, ...cs[2], 1, 1, ...cs[3], 0, 1);
  }}
  fARR = new Float32Array(fverts);
  gl.bindBuffer(gl.ARRAY_BUFFER, fbuf);
  gl.bufferData(gl.ARRAY_BUFFER, fARR, gl.STATIC_DRAW);
  planeARR = new Float32Array(pverts);
  gl.bindBuffer(gl.ARRAY_BUFFER, planebuf);
  gl.bufferData(gl.ARRAY_BUFFER, planeARR, gl.STATIC_DRAW);
}}

// textured camera-image planes (reference demo textures each frustum,
// dust3r/viz.py add_scene_cam)
const tvs = `attribute vec3 p; attribute vec2 t; uniform mat4 mvp;
 varying vec2 vt; void main() {{ gl_Position = mvp * vec4(p, 1.0); vt = t; }}`;
const tfs = `precision mediump float; varying vec2 vt; uniform sampler2D tex;
 void main() {{ gl_FragColor = texture2D(tex, vt); }}`;
const tprog = gl.createProgram();
gl.attachShader(tprog, shader(gl.VERTEX_SHADER, tvs));
gl.attachShader(tprog, shader(gl.FRAGMENT_SHADER, tfs));
gl.linkProgram(tprog);
const planebuf = gl.createBuffer();
const camTex = [];
CAMS.forEach((cam, i) => {{
  if (!cam.img) return;
  const tex = gl.createTexture();
  const im = new Image();
  im.onload = () => {{
    gl.bindTexture(gl.TEXTURE_2D, tex);
    gl.texImage2D(gl.TEXTURE_2D, 0, gl.RGBA, gl.RGBA, gl.UNSIGNED_BYTE, im);
    gl.texParameteri(gl.TEXTURE_2D, gl.TEXTURE_MIN_FILTER, gl.LINEAR);
    gl.texParameteri(gl.TEXTURE_2D, gl.TEXTURE_WRAP_S, gl.CLAMP_TO_EDGE);
    gl.texParameteri(gl.TEXTURE_2D, gl.TEXTURE_WRAP_T, gl.CLAMP_TO_EDGE);
    camTex[i] = tex;
    draw();
  }};
  im.src = cam.img;
}});
buildFrusta(1.0);

const center = {center_json};
const SPREAD = {spread};
// initial orbit distance scales with the cloud's 90th-percentile radius —
// a fixed distance starts INSIDE large metric scenes (blank-ish view)
let theta = 0.6, phi = 0.4, dist = Math.max(0.5, 2.5 * SPREAD);
let panX = 0, panY = 0;
function mat() {{
  const aspect = canvas.width / canvas.height;
  const fov = 1.0, near = 0.01, far = 1000.0;
  const fy = 1 / Math.tan(fov / 2);
  const eye = [
    center[0] + dist * Math.cos(phi) * Math.sin(theta),
    center[1] + dist * Math.sin(phi),
    center[2] + dist * Math.cos(phi) * Math.cos(theta)];
  const f = norm3(sub3(center, eye));
  const r = norm3(cross3(f, [0, -1, 0]));
  const u = cross3(r, f);
  // z-row translation is +dot(f, eye): view_z(center) = -f.(center-eye)
  // = -dist (in FRONT of the camera). The sign was inverted once and the
  // whole cloud landed behind the near plane (blank canvas).
  const tx = -dot3(r, eye) + panX, ty = -dot3(u, eye) + panY, tz = dot3(f, eye);
  const view = [
    [r[0], r[1], r[2], tx], [u[0], u[1], u[2], ty],
    [-f[0], -f[1], -f[2], tz], [0, 0, 0, 1]];
  const projm = [
    [fy / aspect, 0, 0, 0], [0, fy, 0, 0],
    [0, 0, (far + near) / (near - far), 2 * far * near / (near - far)],
    [0, 0, -1, 0]];
  const m = mul44(projm, view);
  // column-major flatten for WebGL
  const out = new Float32Array(16);
  for (let c = 0; c < 4; c++) for (let rr = 0; rr < 4; rr++)
    out[c * 4 + rr] = m[rr][c];
  return out;
}}
function sub3(a, b) {{ return [a[0]-b[0], a[1]-b[1], a[2]-b[2]]; }}
function dot3(a, b) {{ return a[0]*b[0]+a[1]*b[1]+a[2]*b[2]; }}
function cross3(a, b) {{ return [a[1]*b[2]-a[2]*b[1], a[2]*b[0]-a[0]*b[2],
  a[0]*b[1]-a[1]*b[0]]; }}
function norm3(a) {{ const n = Math.hypot(a[0], a[1], a[2]) || 1;
  return [a[0]/n, a[1]/n, a[2]/n]; }}
function mul44(A, B) {{
  const C = [[0,0,0,0],[0,0,0,0],[0,0,0,0],[0,0,0,0]];
  for (let i = 0; i < 4; i++) for (let j = 0; j < 4; j++)
    for (let k = 0; k < 4; k++) C[i][j] += A[i][k] * B[k][j];
  return C; }}

let confThr = confLo;
function draw() {{
  canvas.width = window.innerWidth; canvas.height = window.innerHeight;
  gl.viewport(0, 0, canvas.width, canvas.height);
  gl.clearColor(0.07, 0.07, 0.07, 1);
  gl.clear(gl.COLOR_BUFFER_BIT | gl.DEPTH_BUFFER_BIT);
  gl.enable(gl.DEPTH_TEST);
  const m = mat();
  gl.useProgram(prog);
  gl.uniformMatrix4fv(gl.getUniformLocation(prog, "mvp"), false, m);
  gl.uniform1f(gl.getUniformLocation(prog, "uthr"), confThr);
  gl.bindBuffer(gl.ARRAY_BUFFER, pbuf);
  gl.vertexAttribPointer(ap, 3, gl.FLOAT, false, 0, 0);
  gl.bindBuffer(gl.ARRAY_BUFFER, cbuf);
  gl.vertexAttribPointer(ac, 3, gl.FLOAT, false, 0, 0);
  gl.bindBuffer(gl.ARRAY_BUFFER, kbuf);
  gl.vertexAttribPointer(ak, 1, gl.FLOAT, false, 0, 0);
  if (ibuf && document.getElementById("mesh").checked) {{
    gl.bindBuffer(gl.ELEMENT_ARRAY_BUFFER, ibuf);
    gl.drawElements(gl.TRIANGLES, IDX.length, gl.UNSIGNED_INT, 0);
  }} else {{
    gl.drawArrays(gl.POINTS, 0, N);
  }}
  if (document.getElementById("frusta").checked && fARR.length) {{
    gl.bindBuffer(gl.ARRAY_BUFFER, fbuf);
    gl.vertexAttribPointer(ap, 3, gl.FLOAT, false, 0, 0);
    gl.disableVertexAttribArray(ac);
    gl.vertexAttrib3f(ac, 1.0, 0.4, 0.2);
    gl.disableVertexAttribArray(ak);
    gl.vertexAttrib1f(ak, confHi + 1.0);   // frusta never conf-discarded
    gl.drawArrays(gl.LINES, 0, fARR.length / 3);
    gl.enableVertexAttribArray(ac);
    gl.enableVertexAttribArray(ak);
  }}
  if (document.getElementById("camimgs").checked && planeARR.length) {{
    gl.useProgram(tprog);
    gl.uniformMatrix4fv(gl.getUniformLocation(tprog, "mvp"), false, m);
    const tp = gl.getAttribLocation(tprog, "p");
    const tt = gl.getAttribLocation(tprog, "t");
    gl.bindBuffer(gl.ARRAY_BUFFER, planebuf);
    gl.enableVertexAttribArray(tp);
    gl.vertexAttribPointer(tp, 3, gl.FLOAT, false, 20, 0);
    gl.enableVertexAttribArray(tt);
    gl.vertexAttribPointer(tt, 2, gl.FLOAT, false, 20, 12);
    for (let i = 0; i < CAMS.length; i++) {{
      if (!camTex[i]) continue;
      gl.bindTexture(gl.TEXTURE_2D, camTex[i]);
      gl.drawArrays(gl.TRIANGLES, i * 6, 6);
    }}
    gl.useProgram(prog);
  }}
}}
let dragging = false, lx = 0, ly = 0, shift = false;
canvas.addEventListener("mousedown", (e) => {{ dragging = true;
  lx = e.clientX; ly = e.clientY; shift = e.shiftKey; }});
window.addEventListener("mouseup", () => dragging = false);
window.addEventListener("mousemove", (e) => {{
  if (!dragging) return;
  const dx = e.clientX - lx, dy = e.clientY - ly;
  lx = e.clientX; ly = e.clientY;
  if (shift) {{ panX += dx * 0.002 * dist; panY += dy * 0.002 * dist; }}
  else {{ theta -= dx * 0.005;
    phi = Math.min(1.5, Math.max(-1.5, phi + dy * 0.005)); }}
  draw();
}});
canvas.addEventListener("wheel", (e) => {{
  dist *= Math.exp(e.deltaY * 0.001); draw(); e.preventDefault(); }});
document.getElementById("frusta").addEventListener("change", draw);
if (IDX) {{
  document.getElementById("meshlab").style.display = "";
  document.getElementById("mesh").addEventListener("change", draw);
}}
const confEl = document.getElementById("confthr");
function applyConf() {{
  const pct = parseFloat(confEl.value);
  // slider 0 = the lowest VALID conf: invalid mesh verts (sentinel -1e30)
  // stay hidden in points mode at every slider position
  confThr = confLo + (pct / 100) * (confHi - confLo);
  document.getElementById("confval").textContent =
    pct <= 0 ? "" : confThr.toFixed(2);
  draw();
}}
confEl.addEventListener("input", applyConf);
document.getElementById("camsize").addEventListener("input", (e) => {{
  buildFrusta(parseFloat(e.target.value) / 100); draw(); }});
document.getElementById("camimgs").addEventListener("change", draw);
window.addEventListener("resize", draw);
draw();
</script></body></html>
"""


def _grid_mesh_indices(masks_s: np.ndarray) -> np.ndarray:
    """Triangle indices over per-frame strided grids: two triangles per
    2x2 neighborhood whose four vertices are all valid (the reference's
    pts3d_to_trimesh quad rule, dust3r/viz.py) — vectorised, vertices
    numbered frame-major row-major."""
    n, H, W = masks_s.shape
    base = (np.arange(n)[:, None, None] * H * W
            + np.arange(H - 1)[None, :, None] * W
            + np.arange(W - 1)[None, None, :])          # top-left vertex id
    tl, tr = base, base + 1
    bl, br = base + W, base + W + 1
    ok = (masks_s[:, :-1, :-1] & masks_s[:, :-1, 1:]
          & masks_s[:, 1:, :-1] & masks_s[:, 1:, 1:])
    tl, tr, bl, br = (x[ok] for x in (tl, tr, bl, br))
    tris = np.concatenate([np.stack([tl, bl, tr], -1),
                           np.stack([tr, bl, br], -1)], axis=0)
    return np.ascontiguousarray(tris.reshape(-1), np.uint32)


def export_scene_html(pts3d: np.ndarray, colors: np.ndarray, masks,
                      poses: np.ndarray, focals, path: str,
                      title: str = "Align3R scene",
                      max_points: int = 400_000, confs=None,
                      mesh: bool = False) -> str:
    """Write a standalone interactive viewer.

    pts3d: (n, H, W, 3) world points; colors: (n, H, W, 3) in [0, 1];
    masks: (n, H, W) bool (conf threshold); poses: (n, 4, 4) cam2world;
    focals: (n,); confs: optional (n, H, W) per-point confidence — embedded
    so the viewer's min-conf slider re-thresholds interactively (the
    reference gradio demo's min_conf_thr control, demo.py:234).
    Subsamples uniformly to max_points.

    mesh=True embeds grid-topology triangles as well (the gradio demo's
    default as_pointcloud=False view): frames are STRIDED (not uniformly
    subsampled) so 2x2 neighborhoods stay intact, and the viewer gets a
    mesh/points toggle. Invalid-vertex quads are dropped like
    pts3d_to_trimesh's quad rule.
    """
    pts3d = np.asarray(pts3d)
    colors = np.asarray(colors)
    thumb_src = colors                   # full-res frames for cam thumbnails
    masks_a = np.asarray(masks).astype(bool)
    kf3 = (np.ones(pts3d.shape[:-1], np.float32) if confs is None
           else np.asarray(confs, np.float32).reshape(pts3d.shape[:-1]))
    idx_b64 = ""
    if mesh:
        n, H, W = pts3d.shape[:3]
        s = 1
        # bounded: the product floors at n once s >= max(H, W) — with more
        # frames than the budget allows, export the coarsest grid
        while (s < max(H, W)
               and n * -(-H // s) * -(-W // s) > max_points):
            s += 1
        pts3d = pts3d[:, ::s, ::s]
        colors = colors[:, ::s, ::s]
        masks_s = masks_a[:, ::s, ::s]
        kf3 = kf3[:, ::s, ::s]
        tris = _grid_mesh_indices(masks_s)
        idx_b64 = base64.b64encode(tris.tobytes()).decode()
        # mesh vertex buffers keep the full strided grid (topology needs
        # stable ids); invalid verts are only reachable via dropped quads
        pts = pts3d.reshape(-1, 3)
        cols = colors.reshape(-1, 3)
        # invalid verts carry a -1e30 sentinel: below every slider value
        # (points mode hides them) and skipped by the JS conf-range scan
        kf = np.where(masks_s.reshape(-1), kf3.reshape(-1),
                      np.float32(-1e30)).astype(np.float32)
    else:
        pts = pts3d.reshape(-1, 3)
        cols = colors.reshape(-1, 3)
        kf = kf3.reshape(-1)
        m = masks_a.reshape(-1)
        pts, cols, kf = pts[m], cols[m], kf[m]
        if len(pts) > max_points:
            idx = np.linspace(0, len(pts) - 1, max_points).astype(int)
            pts, cols, kf = pts[idx], cols[idx], kf[idx]
    pts = np.ascontiguousarray(pts, np.float32)
    cols8 = np.ascontiguousarray(np.clip(cols * 255, 0, 255), np.uint8)
    kf = np.ascontiguousarray(kf, np.float32)

    stats_pts = pts[kf > -1e29] if mesh else pts   # exclude invalid verts
    if not len(stats_pts):
        stats_pts = np.zeros((1, 3), np.float32)
    center = stats_pts.mean(axis=0)
    spread = float(np.percentile(
        np.linalg.norm(stats_pts - center, axis=1), 90)) or 1.0
    def cam_thumb(i):
        """Per-camera PNG thumbnail data URL from the colour frames — the
        reference textures each frustum with its image (dust3r/viz.py
        add_scene_cam). None when colours aren't (n, H, W, 3) frames or the
        frame is synthesized zeros (no-image scenes would otherwise show
        opaque black planes at every camera)."""
        if thumb_src.ndim != 4 or i >= thumb_src.shape[0] \
                or not np.any(thumb_src[i]):
            return None
        im = np.clip(thumb_src[i] * 255, 0, 255).astype(np.uint8)
        if im.shape[1] > 128:
            im = resize_pil(im, 128, max(1, round(128 * im.shape[0] / im.shape[1])),
                            "bicubic")
        return ("data:image/png;base64,"
                + base64.b64encode(encode_png(im)).decode())

    cams = []
    for i, T in enumerate(np.asarray(poses)):
        f = float(np.asarray(focals).reshape(-1)[min(i, len(np.asarray(focals).reshape(-1)) - 1)])
        cam = {"pose": np.asarray(T, np.float64).tolist(),
               "focal": f, "scale": 0.05 * spread}
        if thumb_src.ndim == 4:
            cam["aspect"] = float(thumb_src.shape[1] / thumb_src.shape[2])
        thumb = cam_thumb(i)
        if thumb:
            cam["img"] = thumb
        cams.append(cam)

    html = _TEMPLATE.format(
        title=title, npts=len(pts), ncams=len(cams),
        pts_b64=base64.b64encode(pts.tobytes()).decode(),
        col_b64=base64.b64encode(cols8.tobytes()).decode(),
        conf_b64=base64.b64encode(kf.tobytes()).decode(),
        idx_b64=idx_b64,
        cams_json=json.dumps(cams),
        center_json=json.dumps([float(x) for x in center]),
        spread=repr(float(spread)),
    )
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        fh.write(html)
    return path


def export_scene_result_html(scene, path: str, title: str = "Align3R scene",
                             mesh: bool = True):
    """Convenience wrapper over the port's pipeline.SceneResult. mesh=True matches
    the reference demo's default as_pointcloud=False (grid-mesh view);
    the exported file has a live mesh/points toggle either way."""
    imgs01 = (scene.imgs * 0.5 + 0.5) if scene.imgs is not None else \
        np.zeros(scene.get_pts3d().shape, np.float32)
    return export_scene_html(scene.get_pts3d(), imgs01, scene.get_masks(),
                             scene.get_im_poses(), scene.get_focals(),
                             path, title=title, confs=scene.get_conf(),
                             mesh=mesh)
