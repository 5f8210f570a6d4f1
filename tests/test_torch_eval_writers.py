"""Port parity for the scene writers and the small modules around them:
align3r_tpu_torch.eval (viz, trajectory, html_viewer, glb),
alignment/clean.py, utils/sintel_io.py and compat.py against align3r_tpu.

- segment_sky's masks, the PLY bytes and the HTML text are JAX's exactly
  (the HTML's camera thumbnails aside: the port embeds PNGs, which decode
  exactly to PIL's default resize of the frame, where JAX embeds JPEGs);
- the .glb's JSON and buffers are JAX's except the textures, whose PNGs
  decode exactly to the frames (JAX: JPEG);
- trajectory functions and clean_pointcloud within 1e-6;
- sintel_io round-trips; the compat flow of tests/test_compat.py runs on
  the port's modules (CPU).
"""
import base64
import json
import re
import struct

import cv2
import jax.numpy as jnp
import numpy as np
import PIL.Image
import pytest
import torch
from scipy.spatial.transform import Rotation

from align3r_tpu.alignment import clean as jclean
from align3r_tpu.eval import glb as jglb
from align3r_tpu.eval import html_viewer as jhtml
from align3r_tpu.eval import trajectory as jtraj
from align3r_tpu.eval import viz as jviz
from align3r_tpu.geometry.core import closed_form_pose_inverse as jinv
from align3r_tpu.utils import sintel_io as jsio
from align3r_tpu_torch import compat
from align3r_tpu_torch import pipeline as tpipe
from align3r_tpu_torch.alignment import clean as tclean
from align3r_tpu_torch.alignment import scene as ts
from align3r_tpu_torch.eval import glb as tglb
from align3r_tpu_torch.eval import html_viewer as thtml
from align3r_tpu_torch.eval import trajectory as ttraj
from align3r_tpu_torch.eval import viz as tviz
from align3r_tpu_torch.geometry.core import closed_form_pose_inverse as tinv
from align3r_tpu_torch.models.align3r import Align3R, init_align3r_
from align3r_tpu_torch.models.config import TINY_TEST
from align3r_tpu_torch.utils import sintel_io as tsio
from align3r_tpu_torch.utils.png import read_png

torch.set_num_threads(2)


def _poses(n, seed=0):
    r = np.random.default_rng(seed)
    out = []
    for k in range(n):
        q = r.standard_normal(4)
        T = np.eye(4)
        T[:3, :3] = Rotation.from_quat(q / np.linalg.norm(q)).as_matrix()
        T[:3, 3] = r.standard_normal(3) + [0.3 * k, 0, 0]
        out.append(T)
    return np.stack(out)


def _scene(n=3, H=12, W=16, seed=0):
    """Frames in [0, 1] with a bright top band, points, masks, poses, focals."""
    r = np.random.default_rng(seed)
    imgs = r.uniform(0, 1, (n, H, W, 3)).astype(np.float32)
    imgs[:, :4] = [0.8, 0.82, 0.85]
    pts = (r.standard_normal((n, H, W, 3)) + [0, 0, 4]).astype(np.float32)
    masks = r.uniform(0, 1, (n, H, W)) > 0.2
    return imgs, pts, masks, _poses(n, seed).astype(np.float32), \
        (30 + r.uniform(0, 5, n)).astype(np.float32), r.uniform(1, 5, (n, H, W)).astype(np.float32)


# ------------------------------------------------------------------- viz

def test_hsv_matches_cv2():
    img = np.random.default_rng(0).integers(0, 256, (64, 80, 3), dtype=np.uint8)
    img[:4, :4] = 0
    img[4:8, :4] = 255
    hsv = cv2.cvtColor(img, cv2.COLOR_RGB2HSV)
    s, v = tviz.hsv_sv(img)
    np.testing.assert_array_equal(s, hsv[..., 1])
    np.testing.assert_array_equal(v, hsv[..., 2])


@pytest.mark.parametrize("seed", range(3))
def test_segment_sky_matches_jax(seed):
    r = np.random.default_rng(seed)
    H, W = 72, 96
    img = r.random((H, W, 3)) * 0.3 + 0.5
    img[: H // 2, : W // 2] = [0.8, 0.82, 0.85] + 0.05 * r.random((H // 2, W // 2, 3))
    img[40:, 60:] = r.random((32, 36, 3))
    img[2:6, 70:80] = 0.95                       # a small bright patch: too small
    got, ref = tviz.segment_sky(img), jviz.segment_sky(img)
    assert got.dtype == ref.dtype == bool and 0 < ref.mean() < 1
    np.testing.assert_array_equal(got, ref)
    assert not tviz.segment_sky(np.zeros((8, 8, 3))).any()


def test_ply_and_mesh_bytes_match_jax(tmp_path):
    imgs, pts, masks, poses, focals, _ = _scene()
    for colors, faces in ((None, None), (imgs[0], None), ((imgs[0] * 255).astype(np.uint8),
                                                          np.array([[0, 1, 2], [2, 3, 4]]))):
        tviz.write_ply(tmp_path / "t.ply", pts[0], colors, faces)
        jviz.write_ply(tmp_path / "j.ply", pts[0], colors, faces)
        assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    for a, b in zip(tviz.pts3d_to_mesh(pts[0], imgs[0], masks[0]),
                    jviz.pts3d_to_mesh(pts[0], imgs[0], masks[0])):
        np.testing.assert_array_equal(a, b)
    (tp, te), (jp, je) = (tviz.camera_frustum(poses[1], 40.0),
                          jviz.camera_frustum(poses[1], 40.0))
    np.testing.assert_array_equal(tp, jp)
    assert te == je
    for mod, name in ((tviz, "t"), (jviz, "j")):
        v = mod.SceneViz().add_pointcloud(pts, imgs, mask=masks)
        v.add_cameras(poses, focals=focals).save(tmp_path / f"{name}.ply")
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()


# ------------------------------------------------------------ trajectory

def test_trajectory_functions_match_jax(tmp_path):
    est, ref = _poses(6, 1), _poses(6, 2)
    np.testing.assert_allclose(ttraj.c2w_to_tumpose(est[0]), jtraj.c2w_to_tumpose(est[0]),
                               atol=1e-6)
    t_traj, j_traj = ttraj.poses_to_traj(est), jtraj.poses_to_traj(est)
    np.testing.assert_allclose(t_traj[0], j_traj[0], atol=1e-6)
    np.testing.assert_allclose(ttraj.tumpose_to_c2w(t_traj[0][2]), est[2], atol=1e-6)
    ttraj.save_tum_trajectory(t_traj, tmp_path / "t.txt")
    jtraj.save_tum_trajectory(j_traj, tmp_path / "j.txt")
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()
    for a, b in zip(ttraj.load_tum_trajectory(tmp_path / "t.txt"),
                    jtraj.load_tum_trajectory(tmp_path / "j.txt")):
        np.testing.assert_allclose(a, b, atol=1e-6)
    for f in ("ate_rmse", "rpe_rmse"):
        np.testing.assert_allclose(getattr(ttraj, f)(est, ref), getattr(jtraj, f)(est, ref),
                                   rtol=1e-6)
    s1, R1, t1 = ttraj.umeyama_alignment(est[:, :3, 3], ref[:, :3, 3])
    s2, R2, t2 = jtraj.umeyama_alignment(est[:, :3, 3], ref[:, :3, 3])
    np.testing.assert_allclose([s1, *R1.ravel(), *t1], [s2, *R2.ravel(), *t2], atol=1e-6)
    gt = jtraj.poses_to_traj(ref)
    got = ttraj.eval_metrics(t_traj, gt, seq="s", filename=str(tmp_path / "s_eval_metric.txt"))
    np.testing.assert_allclose(got, jtraj.eval_metrics(j_traj, gt), rtol=1e-6)
    np.testing.assert_allclose(ttraj.extract_metrics(str(tmp_path / "s_eval_metric.txt")), got,
                               rtol=1e-6)
    rows = ttraj.process_directory(str(tmp_path))
    assert rows == jtraj.process_directory(str(tmp_path)) and len(rows) == 1
    assert ttraj.calculate_averages(rows) == jtraj.calculate_averages(rows)
    np.savetxt(tmp_path / "pose.txt", ref.reshape(6, 16)[:, :12])
    for a, b in zip(ttraj.load_traj(str(tmp_path / "pose.txt"), "replica"),
                    jtraj.load_traj(str(tmp_path / "pose.txt"), "replica")):
        np.testing.assert_allclose(a, b, atol=1e-6)


def test_sintel_io_round_trips_and_matches_jax(tmp_path):
    r = np.random.default_rng(0)
    d = r.uniform(0, 10, (5, 7)).astype(np.float32)
    tsio.depth_write(str(tmp_path / "a.dpt"), d)
    np.testing.assert_array_equal(tsio.depth_read(str(tmp_path / "a.dpt")), d)
    np.testing.assert_array_equal(jsio.depth_read(str(tmp_path / "a.dpt")), d)
    flow = r.standard_normal((4, 6, 2)).astype(np.float32)
    with open(tmp_path / "a.flo", "wb") as f:
        np.float32(tsio.TAG_FLOAT).tofile(f)
        np.int32(6).tofile(f)
        np.int32(4).tofile(f)
        flow.tofile(f)
    np.testing.assert_array_equal(tsio.flow_read(str(tmp_path / "a.flo")), flow)
    cam_dir = tmp_path / "cams"
    cam_dir.mkdir()
    for k, T in enumerate(_poses(3)):
        w2c = np.linalg.inv(T)
        with open(cam_dir / f"frame_{k + 1:04d}.cam", "wb") as f:
            np.float32(tsio.TAG_FLOAT).tofile(f)
            np.diag([50.0, 50.0, 1.0]).astype(np.float64).tofile(f)
            w2c[:3].astype(np.float64).tofile(f)
    K, N = tsio.cam_read(str(cam_dir / "frame_0002.cam"))
    np.testing.assert_allclose(N, np.linalg.inv(_poses(3)[1])[:3], atol=1e-12)
    for a, b in zip(ttraj.load_traj(str(cam_dir), "sintel"), jtraj.load_traj(str(cam_dir), "sintel")):
        np.testing.assert_allclose(a, b, atol=1e-6)
    np.float32(1.0).tofile(str(tmp_path / "bad.dpt"))
    with pytest.raises(AssertionError):
        tsio.depth_read(str(tmp_path / "bad.dpt"))


# -------------------------------------------------------------- writers

_IMG = re.compile(r'"img": "data:image/(png|jpeg);base64,([A-Za-z0-9+/=]*)"')


def _thumbs(html):
    return _IMG.findall(html), _IMG.sub('"img": ""', html)


@pytest.mark.parametrize("mesh", [False, True])
def test_html_matches_jax(tmp_path, mesh):
    imgs, pts, masks, poses, focals, confs = _scene(W=160, H=96)
    args = (pts, imgs, masks, poses, focals)
    thtml.export_scene_html(*args, tmp_path / "t.html", confs=confs, mesh=mesh, max_points=5000)
    jhtml.export_scene_html(*args, tmp_path / "j.html", confs=confs, mesh=mesh, max_points=5000)
    (tt, ttext), (jt, jtext) = (_thumbs((tmp_path / f"{k}.html").read_text()) for k in "tj")
    assert ttext == jtext
    assert len(tt) == len(jt) == 3 and all(kind == "png" for kind, _ in tt)
    for (_, b64), im in zip(tt, imgs):
        (tmp_path / "thumb.png").write_bytes(base64.b64decode(b64))
        ref = PIL.Image.fromarray(np.clip(im * 255, 0, 255).astype(np.uint8)).resize((128, 77))
        np.testing.assert_array_equal(read_png(tmp_path / "thumb.png"), np.asarray(ref))
    assert "[-f[0], -f[1], -f[2], tz]" in ttext


def _glb(path):
    raw = open(path, "rb").read()
    magic, ver, total = struct.unpack_from("<4sII", raw, 0)
    assert magic == b"glTF" and ver == 2 and total == len(raw)
    n = struct.unpack_from("<I", raw, 12)[0]
    js = json.loads(raw[20:20 + n])
    m = struct.unpack_from("<I", raw, 20 + n)[0]
    return js, raw[28 + n:28 + n + m]


@pytest.mark.parametrize("as_pointcloud", [False, True])
def test_glb_matches_jax_but_png_textures(tmp_path, as_pointcloud):
    imgs, pts, masks, poses, focals, _ = _scene()
    for mod, k in ((tglb, "t"), (jglb, "j")):
        mod.export_scene_glb(tmp_path / f"{k}.glb", imgs, pts, masks, focals, poses,
                             as_pointcloud=as_pointcloud)
    (tj, tb), (jj, jb) = _glb(tmp_path / "t.glb"), _glb(tmp_path / "j.glb")
    image_views = {im["bufferView"] for im in tj["images"]}
    assert image_views == {im["bufferView"] for im in jj["images"]}
    assert [im["mimeType"] for im in tj["images"]] == ["image/png"] * 3
    for key in set(tj) | set(jj):
        if key not in ("bufferViews", "buffers", "images"):
            assert tj[key] == jj[key], key
    assert len(tj["bufferViews"]) == len(jj["bufferViews"])
    for v, (tv, jv) in enumerate(zip(tj["bufferViews"], jj["bufferViews"])):
        tdata = tb[tv["byteOffset"]:tv["byteOffset"] + tv["byteLength"]]
        if v in image_views:
            (tmp_path / "tex.png").write_bytes(tdata)
            k = sorted(image_views).index(v)
            np.testing.assert_array_equal(read_png(tmp_path / "tex.png"),
                                          (imgs[k] * 255).astype(np.uint8))
        else:
            assert tv.get("target") == jv.get("target")
            assert tdata == jb[jv["byteOffset"]:jv["byteOffset"] + jv["byteLength"]], v


def test_scene_result_writers(tmp_path):
    """The SceneResult wrappers and savers the demo calls: the HTML and the
    .glb of a scene are the writers' on its getters; save_rgb_imgs writes the
    frames as RGB PNGs."""
    from test_torch_scene import _output
    out, _ = _output()
    cfg, data, params = ts.build_scene(out, dict(min_conf_thr=1.1))
    imgs = np.random.default_rng(0).uniform(-1, 1, (cfg.n_imgs,) + cfg.imshape + (3,))
    res = tpipe.SceneResult(cfg, data, params, np.zeros(1), imgs=imgs.astype(np.float32))
    thtml.export_scene_result_html(res, tmp_path / "a.html", title="x")
    thtml.export_scene_html(res.get_pts3d(), res.imgs * 0.5 + 0.5, res.get_masks(),
                            res.get_im_poses(), res.get_focals(), tmp_path / "b.html",
                            title="x", confs=res.get_conf(), mesh=True)
    assert (tmp_path / "a.html").read_text() == (tmp_path / "b.html").read_text()
    tglb.export_scene_result_glb(res, tmp_path / "a.glb")
    tglb.export_scene_glb(tmp_path / "b.glb", res.imgs * 0.5 + 0.5, res.get_pts3d(),
                          res.get_masks(), res.get_focals(), res.get_im_poses())
    assert (tmp_path / "a.glb").read_bytes() == (tmp_path / "b.glb").read_bytes()
    res.save_rgb_imgs(tmp_path / "rgb", start=2)
    np.testing.assert_array_equal(read_png(tmp_path / "rgb" / "frame_0003.png"),
                                  ((imgs[1] * 0.5 + 0.5) * 255).astype(np.uint8))
    traj = res.save_tum_poses(tmp_path / "traj.txt")
    jtraj.save_tum_trajectory(jtraj.poses_to_traj(res.get_im_poses()), tmp_path / "jtraj.txt")
    assert (tmp_path / "traj.txt").read_text() == (tmp_path / "jtraj.txt").read_text()
    assert traj.shape == (cfg.n_imgs, 7)


# ------------------------------------------------------------------ clean

def test_clean_pointcloud_matches_jax():
    """Views of one smooth surface from shifted cameras, with noisy depths
    and confidences: some points are suppressed, in JAX's cascade order."""
    r = np.random.default_rng(0)
    n, H, W, f = 4, 12, 16, 20.0
    poses = np.stack([np.eye(4)] * n).astype(np.float32)
    poses[:, 0, 3] = np.arange(n) * 0.05
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    depth = (2 + 0.3 * r.standard_normal((n, H, W))).astype(np.float32)
    cam = np.stack([depth * (xx - W / 2) / f, depth * (yy - H / 2) / f, depth], -1)
    pts = cam + poses[:, None, None, :3, 3]
    K = np.tile(np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32), (n, 1, 1))
    conf = r.uniform(1, 3, (n, H, W)).astype(np.float32)
    ref = np.asarray(jclean.clean_pointcloud(jnp.asarray(conf), jnp.asarray(K),
                                             jinv(jnp.asarray(poses)), jnp.asarray(depth),
                                             jnp.asarray(pts)))
    t = torch.from_numpy
    got = tclean.clean_pointcloud(t(conf), t(K), tinv(t(poses)), t(depth), t(pts)).numpy()
    assert 0 < (ref == 0).mean() < 1
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()


# ----------------------------------------------------------------- compat

@pytest.fixture(scope="module")
def model():
    m = init_align3r_(Align3R(TINY_TEST), seed=0)
    with torch.no_grad():
        for h in (m.downstream_head1, m.downstream_head2):
            h.dpt.head[4].weight.mul_(0.01)
    return compat.Align3RModel(m, device="cpu")


def make_views(n=3, H=32, W=48, seed=0):
    rng = np.random.default_rng(seed)
    return [dict(img=rng.standard_normal((1, H, W, 3)).astype(np.float32) * 0.2,
                 pred_depth=rng.uniform(0, 1, (1, H, W, 3)).astype(np.float32),
                 true_shape=np.int32([[H, W]]), idx=i, instance=str(i))
            for i in range(n)]


def test_compat_reference_style_pipeline(model, tmp_path):
    imgs = make_views()
    pairs = compat.make_pairs(imgs, scene_graph="complete", symmetrize=True)
    assert isinstance(pairs[0], tuple) and "img" in pairs[0][0]
    output = compat.inference(pairs, model, device="cpu", batch_size=4)
    assert output["pred1"]["pts3d"].shape[0] == len(pairs)
    assert set(np.asarray(output["view1"]["idx"])) == {0, 1, 2}
    scene = compat.global_aligner(output, device=None,
                                  mode=compat.GlobalAlignerMode.PointCloudOptimizer,
                                  variant="prior", min_conf_thr=1.1)
    loss = scene.compute_global_alignment(init="mst", niter=20, schedule="cosine", lr=0.05)
    assert np.isfinite(loss)
    assert scene.get_im_poses().shape == (3, 4, 4)
    assert len(scene.get_depthmaps()) == len(scene.get_pts3d()) == len(scene.get_masks()) == 3
    assert scene.get_intrinsics().shape == (3, 3, 3)
    before = scene.data.im_conf.clone()
    scene.clean_pointcloud()
    assert scene.data.im_conf.shape == before.shape and (scene.data.im_conf <= before).all()
    # NCHW images accepted
    for v in imgs:
        v["img"] = v["img"].transpose(0, 3, 1, 2)
    out = compat.inference(compat.make_pairs(imgs, "complete", symmetrize=False), model,
                           batch_size=4)
    assert torch.isfinite(out["pred1"]["pts3d"]).all()
    # the score heatmap, and save_score_only skips the solve
    p = tmp_path / "scores.png"
    assert scene.compute_global_alignment(init="mst", niter=2, save_score_path=str(p),
                                          save_score_only=True) is None
    m = np.load(str(p) + ".npy")
    assert m.shape == (3, 3) and np.isfinite(m).sum() == scene.data.ei.shape[0]


def test_compat_preset_known_poses_frozen(model):
    output = compat.inference(compat.make_pairs(make_views(), "complete"), model, batch_size=4)
    scene = compat.global_aligner(output,
                                  mode=compat.GlobalAlignerMode.ModularPointCloudOptimizer,
                                  variant="prior", min_conf_thr=1.1)
    known = np.stack([np.eye(4, dtype=np.float32)] * 2)
    known[1, 0, 3] = 0.5
    scene.preset_pose(known, pose_msk=[True, True, False])
    scene.preset_focal([40.0], msk=[True, False, False])
    loss = scene.compute_global_alignment(init="known_poses", niter=15, schedule="cosine",
                                          lr=0.05)
    assert np.isfinite(loss)
    poses = scene.get_im_poses()
    np.testing.assert_allclose(poses[:2], known, atol=1e-5)
    np.testing.assert_allclose(scene.get_focals()[0], 40.0, rtol=1e-5)
    assert np.abs(poses[2] - np.eye(4)).max() > 1e-4
    f = compat._SceneWrapper._msk_indices
    np.testing.assert_array_equal(f([0, 3, 5], 3), [0, 3, 5])
    np.testing.assert_array_equal(f([True, False, True], 2), [0, 2])
    with pytest.raises(TypeError):
        f(np.array([0.5, 1.0]), 2)


def test_compat_prior_positional_signature_and_device(model):
    output = compat.inference(compat.make_pairs(make_views(), "complete"), model, batch_size=4)
    H, W = output["pred1"]["pts3d"].shape[1:3]
    mono = [np.full((H, W), 2.0, np.float32) for _ in range(3)]
    scene = compat.global_aligner(output, True, mono, None, min_conf_thr=1.1)
    assert scene._variant == "prior" and scene.cfg.if_use_mono
    assert np.isfinite(scene.compute_global_alignment(init="mst", niter=5, lr=0.05))
    assert model.device.type == "cpu"
    if not torch.cuda.is_available():   # to() really moves the model, to the card by default
        with pytest.raises(RuntimeError, match="device='cpu'"):
            model.to("cuda")
