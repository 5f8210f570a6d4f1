"""Port parity for the frame and prior loaders:
align3r_tpu_torch.inference.images (and utils.png) against PIL, OpenCV and
align3r_tpu.inference.images.

- PIL's LANCZOS, BICUBIC and NEAREST resizes and its "L" conversion are
  matched bit for bit (down and up, odd sizes, RGB and L); OpenCV's
  INTER_CUBIC on float32 within 1e-6 of the largest value.
- The PNG decoder gives PIL's pixels on PNGs that PIL wrote (gray, gray +
  alpha, RGB, RGBA, every orientation tag).
- load_images + stack_views give JAX's frames and masks exactly and its
  priors within 1e-6 of the largest value.
- With PIL and OpenCV blocked, the loader, the writers and the demo import
  and read a PNG folder and a baseline JPEG (the port's decoder, as PIL
  reads it), and a progressive JPEG or a video names the missing library.
"""
import os
import subprocess
import sys

import cv2
import numpy as np
import PIL.Image
import pytest
from PIL import ImageOps

from align3r_tpu.inference import images as jimg
from align3r_tpu_torch.inference import images as timg
from align3r_tpu_torch.utils.png import UnsupportedPNG, encode_png, read_png, write_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = [((576, 1024), (512, 288)), ((480, 854), (512, 288)), ((48, 64), (512, 384)),
         ((101, 77), (33, 45)), ((48, 64), (299, 224)), ((50, 50), (50, 70)),
         ((288, 512), (128, 72))]
PIL_MODES = {"lanczos": PIL.Image.LANCZOS, "bicubic": PIL.Image.BICUBIC,
             "nearest": PIL.Image.NEAREST}


@pytest.mark.parametrize("resample", sorted(PIL_MODES))
@pytest.mark.parametrize("src,dst", SIZES, ids=[f"{s[1]}x{s[0]}-{d[0]}x{d[1]}" for s, d in SIZES])
def test_resize_equals_pil(src, dst, resample):
    r = np.random.default_rng(sum(src) + sum(dst))
    for shape in (src + (3,), src):
        a = r.integers(0, 256, shape, dtype=np.uint8)
        ref = np.asarray(PIL.Image.fromarray(a).resize(dst, PIL_MODES[resample]))
        np.testing.assert_array_equal(timg.resize_pil(a, *dst, resample), ref)


@pytest.mark.parametrize("src,dst", SIZES, ids=[f"{s[1]}x{s[0]}-{d[0]}x{d[1]}" for s, d in SIZES])
def test_cubic_resize_matches_cv2(src, dst):
    r = np.random.default_rng(7)
    for shape in (src + (3,), src):
        a = r.uniform(-1, 2, shape).astype(np.float32)
        ref = cv2.resize(a, dst, interpolation=cv2.INTER_CUBIC)
        got = timg.resize_cubic(a, *dst)
        assert got.dtype == np.float32 and got.shape == ref.shape
        assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()


def test_rgb_to_l_equals_pil():
    a = np.random.default_rng(0).integers(0, 256, (40, 70, 3), dtype=np.uint8)
    np.testing.assert_array_equal(timg.rgb_to_l(a),
                                  np.asarray(PIL.Image.fromarray(a).convert("L")))


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
def test_png_decoder_equals_pil(tmp_path, mode):
    """PIL picks a filter per row (all five appear on this image); 37 x 53
    and odd strides."""
    r = np.random.default_rng(1)
    ch = {"L": 0, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
    ramp = np.linspace(0, 200, 53)[None, :] + np.linspace(0, 50, 37)[:, None]
    a = (r.integers(0, 40, (37, 53) + ((ch,) if ch else ())) +
         (ramp if not ch else ramp[..., None])).astype(np.uint8)
    p = tmp_path / "f.png"
    PIL.Image.fromarray(a, mode).save(p)
    np.testing.assert_array_equal(read_png(p), np.asarray(PIL.Image.open(p)))
    np.testing.assert_array_equal(timg.read_rgb(str(p)),
                                  np.asarray(PIL.Image.open(p).convert("RGB")))
    np.testing.assert_array_equal(timg.read_l(str(p)),
                                  np.asarray(PIL.Image.open(p).convert("L")))


@pytest.mark.parametrize("orientation", range(1, 9))
def test_png_orientation_equals_exif_transpose(tmp_path, orientation):
    a = np.random.default_rng(2).integers(0, 256, (7, 11, 3), dtype=np.uint8)
    exif = PIL.Image.Exif()
    exif[0x0112] = orientation
    p = tmp_path / "o.png"
    PIL.Image.fromarray(a).save(p, exif=exif)
    ref = np.asarray(ImageOps.exif_transpose(PIL.Image.open(p)).convert("RGB"))
    np.testing.assert_array_equal(timg.read_rgb(str(p)), ref)


def test_png_writer_round_trips(tmp_path):
    r = np.random.default_rng(3)
    for a in (r.integers(0, 256, (9, 13), dtype=np.uint8),
              r.integers(0, 256, (9, 13, 3), dtype=np.uint8)):
        write_png(a, tmp_path / "w.png")
        np.testing.assert_array_equal(np.asarray(PIL.Image.open(tmp_path / "w.png")), a)
        np.testing.assert_array_equal(read_png(tmp_path / "w.png"), a)
    with pytest.raises(ValueError):
        encode_png(np.zeros((4, 4, 4), np.uint8))


def test_unsupported_png_goes_through_pil(tmp_path):
    """A palette PNG is not read by the decoder; the loader hands it to PIL."""
    a = np.random.default_rng(4).integers(0, 256, (10, 12, 3), dtype=np.uint8)
    p = tmp_path / "p.png"
    PIL.Image.fromarray(a).convert("P").save(p)
    with pytest.raises(UnsupportedPNG):
        read_png(p)
    np.testing.assert_array_equal(timg.read_rgb(str(p)),
                                  np.asarray(PIL.Image.open(p).convert("RGB")))


def _write_frames(root, names, hw, seed, mask_dir=None, prior_dir=None):
    """Frames written by PIL (PNG, with one JPEG), `.npz` priors by the
    default naming or into prior_dir, masks (RGB and L PNGs) into mask_dir."""
    r = np.random.default_rng(seed)
    H, W = hw
    yy, xx = np.mgrid[0:H, 0:W]
    for k, name in enumerate(names):
        img = (127 + 100 * np.sin(xx[..., None] / (5 + k) + np.arange(3))
               * np.cos(yy[..., None] / 7) + r.integers(-20, 20, (H, W, 3)))
        PIL.Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(os.path.join(root, name))
        npz = (os.path.join(prior_dir, name[:-4] + ".npz") if prior_dir else
               os.path.join(root, name[:-4] + "_pred_depth_depthpro.npz"))
        np.savez(npz, depth=(1 + r.uniform(0, 3, (1, H, W))).astype(np.float32),
                 focallength_px=np.float32(60.0 + k))
        if mask_dir:
            m = (r.uniform(0, 1, (H, W)) > 0.5).astype(np.uint8) * 255
            m = np.stack([m, m, 255 - m], -1) if k % 2 else m
            PIL.Image.fromarray(m).save(os.path.join(mask_dir, name[:-4] + ".png"))


def _same_views(got, ref):
    assert len(got) == len(ref)
    for g, j in zip(got, ref):
        np.testing.assert_array_equal(g["img"], j["img"])
        np.testing.assert_array_equal(g["dynamic_mask"], j["dynamic_mask"])
        np.testing.assert_array_equal(g["true_shape"], j["true_shape"])
        assert (g["idx"], g["instance"]) == (j["idx"], j["instance"])
        assert g["pred_depth"].shape == j["pred_depth"].shape
        assert g["pred_depth"].dtype == np.float32
        assert np.abs(g["pred_depth"] - j["pred_depth"]).max() <= \
            1e-6 * max(np.abs(j["pred_depth"]).max(), 1e-30)
    gs, js = timg.stack_views(got), jimg.stack_views(ref)
    assert gs["instances"] == js["instances"]
    for k in ("imgs", "dynamic_masks"):
        np.testing.assert_array_equal(gs[k], js[k])
    assert np.abs(gs["priors"] - js["priors"]).max() <= 1e-6 * np.abs(js["priors"]).max()


@pytest.fixture(scope="module")
def default_folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("frames")
    masks = tmp_path_factory.mktemp("masks")
    names = [f"f{k:03d}.png" for k in range(3)] + ["f003.jpg"]
    _write_frames(str(root), names, (75, 101), 0, mask_dir=str(masks))
    return str(root), str(masks)


@pytest.mark.parametrize("size,crop", [(512, True), (512, False), (224, True), (224, False)])
def test_load_images_matches_jax(default_folder, size, crop):
    root, masks = default_folder
    kw = dict(crop=crop, traj_format="default", dynamic_mask_root=masks)
    ref = jimg.load_images(root, size, **kw)
    got = timg.load_images(root, size, **kw)
    _same_views(got, ref)
    assert any(v["dynamic_mask"].any() for v in got)
    assert np.abs(got[0]["pred_depth"][..., 2]).max() > 0


def test_load_images_sintel_naming_matches_jax(tmp_path_factory):
    """Sintel's layout: clean/<seq>/ frames, depth_prediction_<prior>/<seq>/
    priors, dynamic_label_perfect/<seq>/ masks found by path rewriting; a
    frame without prior gets zeros. start/interval slice the folder."""
    base = tmp_path_factory.mktemp("sintel")
    dirs = {k: os.path.join(str(base), k, "alley_1")
            for k in ("clean", "depth_prediction_depthpro", "dynamic_label_perfect")}
    for d in dirs.values():
        os.makedirs(d)
    names = [f"frame_{k:04d}.png" for k in range(1, 5)]
    _write_frames(dirs["clean"], names, (64, 96), 1, mask_dir=dirs["dynamic_label_perfect"],
                  prior_dir=dirs["depth_prediction_depthpro"])
    os.remove(os.path.join(dirs["depth_prediction_depthpro"], "frame_0004.npz"))
    files = [os.path.join(dirs["clean"], n) for n in names]
    for size in (512, 224):
        kw = dict(traj_format="sintel", start=1, interval=3)
        ref = jimg.load_images(files, size, **kw)
        got = timg.load_images(files, size, **kw)
        _same_views(got, ref)
        assert not got[-1]["pred_depth"].any() and got[0]["pred_depth"].any()


def test_load_video_matches_jax(tmp_path):
    H, W = 48, 64
    vid = str(tmp_path / "clip.avi")
    wr = cv2.VideoWriter(vid, cv2.VideoWriter_fourcc(*"MJPG"), 12.0, (W, H))
    r = np.random.default_rng(5)
    for _ in range(7):
        wr.write(r.integers(0, 255, (H, W, 3), np.uint8))
    wr.release()
    kw = dict(fps=6, interval=3, traj_format="default")
    _same_views(timg.load_images(vid, 224, **kw), jimg.load_images(vid, 224, **kw))


BLOCKED = """
import sys
sys.modules["PIL"] = None
sys.modules["cv2"] = None
import align3r_tpu_torch.inference.images as I
import align3r_tpu_torch.eval.viz, align3r_tpu_torch.eval.html_viewer
import align3r_tpu_torch.eval.glb, align3r_tpu_torch.eval.trajectory
import align3r_tpu_torch.tools.demo, align3r_tpu_torch.pipeline, align3r_tpu_torch.compat
views = I.load_images(sys.argv[1], 224, traj_format="default")
s = I.stack_views(views)
assert s["imgs"].shape == (3, 224, 224, 3) and s["priors"][..., 2].max() > 0
import numpy as np
assert (I.read_rgb(sys.argv[2]) == np.load(sys.argv[5])).all()
assert I.load_images(sys.argv[2], 224)[0]["img"].shape == (1, 224, 224, 3)
for path, lib in ((sys.argv[4], "Pillow"), (sys.argv[3], "OpenCV")):
    try:
        I.load_images(path, 224)
        raise SystemExit("no error")
    except ImportError as e:
        assert path in str(e) and lib in str(e), e
        assert lib == "OpenCV" or "SOF marker 0xC2" in str(e), e
bad = [m for m in sys.modules if m.split(".")[0] in ("PIL", "cv2") and sys.modules[m]]
assert not bad, bad
print("ok")
"""


def test_loader_writers_and_demo_without_pil_or_cv2(tmp_path):
    root = tmp_path / "png"
    root.mkdir()
    _write_frames(str(root), [f"f{k}.png" for k in range(3)], (48, 64), 2)
    frame = np.random.default_rng(3).integers(0, 255, (40, 56, 3), np.uint8)
    jpg, prog = tmp_path / "one.jpg", tmp_path / "progressive.jpg"
    PIL.Image.fromarray(frame).save(jpg)
    PIL.Image.fromarray(frame).save(prog, progressive=True)
    np.save(tmp_path / "one.npy", np.asarray(PIL.Image.open(jpg).convert("RGB")))
    vid = tmp_path / "v.mp4"
    vid.write_bytes(b"")
    res = subprocess.run([sys.executable, "-c", BLOCKED, str(root), str(jpg), str(vid),
                          str(prog), str(tmp_path / "one.npy")],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), res.stderr
