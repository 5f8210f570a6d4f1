"""Port parity: the training data path of align3r_tpu_torch (cropping, the
six dataset classes, the registry and the loader) against
align3r_tpu.training.data on the same synthetic folders and seeds.

The folders are written by the port's writers (`torch_data_fixtures`): the
preprocessed layout (`_rgb.jpg` frames, PFM depth, PNG masks, metadata and
DepthPro-style priors) with landscape, portrait and near-square scenes and
an off-centre principal point, SceneFlow's Driving / Monkaa /
FlyingThings3D folders, and Sintel's raw layout. The JAX package reads the
frames with cv2 and resamples with PIL and cv2; the port with its own
decoder and resamplers. Tolerances, each with its reason:
- `img` bit-identical (the decoders and resamplers give the same bits);
- `depthmap` exact (nearest-neighbour resizes and slices of the same maps);
- `pred_depth`, `pts3d` and `camera_intrinsics` within 1e-6 relative to
  each array's largest magnitude: the same float32 math, but the JAX
  package transforms the points with an XLA einsum and the prior through
  XLA, the port with torch;
- `valid_mask`, `true_shape`, `view_idx`, `camera_pose` and the labels equal.
"""
import os
import subprocess
import sys

import cv2
import numpy as np
import PIL.Image
import pytest

from align3r_tpu.training import data as jdata
from align3r_tpu.training.data import cropping as jcrop
from align3r_tpu_torch.training import data as tdata
from align3r_tpu_torch.training.data import cropping as tcrop
from torch_data_fixtures import frame_image, write_preprocessed_scene, write_sintel_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("data")
    po = base / "po"
    write_preprocessed_scene(po / "scene_a", 4, (60, 100), 0, world2cam=True, pp_shift=(3, -2))
    write_preprocessed_scene(po / "scene_b", 4, (60, 100), 1, world2cam=True)
    write_preprocessed_scene(po / "scene_c", 3, (100, 60), 2, world2cam=True)   # portrait
    write_preprocessed_scene(po / "scene_d", 3, (64, 66), 3, world2cam=True)    # near square
    sf = base / "sf"
    for i, (sub, n) in enumerate((("FlyingThings3D_proc/TRAIN/A/0000/left", 4),
                                  ("FlyingThings3D_proc/TRAIN/B/0001/left", 3),
                                  ("FlyingThings3D_proc/TEST/A/0002/left", 4),
                                  ("Monkaa_proc/a_rain/left", 3),
                                  ("Driving_proc/15mm/fwd/fast/left", 3))):
        write_preprocessed_scene(sf / sub, n, (54, 96), 10 + i)
    sintel = write_sintel_scene(str(base / "sintel"), "alley_1", 5, (44, 104), 20)
    return {"po": str(po), "sf": str(sf), "sintel": sintel}


CASES = {
    "pointodyssey": "PointodysseyDatasets(split='train', ROOT={po!r}, resolution=(96, 64), "
                    "seed=777)",
    "spring_aug_crop": "SpringDatasets(split='train', ROOT={po!r}, resolution=[(96, 64)], "
                       "aug_crop=16, seed=5)",
    "tartanair_aug_f": "TartanairDatasets(split='train', ROOT={po!r}, resolution=[(96, 64)], "
                       "aug_f=True, aug_crop=8, seed=9)",
    "vkitti_two_resolutions": "VkittiDatasets(split='train', ROOT={po!r}, "
                              "resolution=[(96, 64), (48, 32)], seed=3)",
    "sceneflow_train": "SceneFlowDatasets(split='train', ROOT={sf!r}, resolution=[(64, 48)], "
                       "aug_crop=16, seed=777)",
    "sceneflow_test": "SceneFlowDatasets(split='test', ROOT={sf!r}, resolution=[(64, 48)], "
                      "aug_f=True, seed=777)",
    "sintel": "SintelDatasets(split='train', ROOT={sintel!r}, resolution=[(64, 32)], "
              "aug_crop=16, seed=777)",
}


def _close(got, ref, name):
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max(),
                               err_msg=name)


def assert_views_match(got, ref):
    assert len(got) == len(ref)
    for t, j in zip(got, ref):
        assert set(t) == set(j)
        assert t["img"].dtype == j["img"].dtype == np.float32
        np.testing.assert_array_equal(t["img"], j["img"])
        np.testing.assert_array_equal(t["depthmap"], j["depthmap"])
        for k in ("pred_depth", "pts3d", "camera_intrinsics"):
            assert t[k].shape == j[k].shape, k
            _close(t[k], j[k], k)
        for k in ("valid_mask", "true_shape", "camera_pose"):
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
        for k in ("view_idx", "dataset", "label", "instance"):
            assert t[k] == j[k], k
        assert t["valid_mask"].any()


@pytest.mark.parametrize("case", sorted(CASES))
def test_dataset_views_match_jax(roots, case):
    expr = CASES[case].format(**roots)
    got, ref = tdata.build_dataset(expr), jdata.build_dataset(expr)
    assert len(got) == len(ref) > 0 and got.pairs == ref.pairs
    assert got.resolutions == ref.resolutions
    for ar in range(len(got.resolutions)):
        for idx in range(len(got)):
            assert_views_match(got[idx, ar], ref[idx, ar])


def test_portrait_scene_is_transposed_to_landscape(roots):
    ds = tdata.build_dataset(CASES["pointodyssey"].format(**roots))
    scenes = [p[0].split(os.sep)[-2] for p in ds.pairs]
    for v in ds[scenes.index("scene_c")]:
        assert tuple(v["true_shape"]) == (64, 96) and v["img"].shape == (64, 96, 3)


def test_get_data_loader_matches_jax(roots):
    """An expression over two classes and two resolutions: the same batches in
    the same order, each batch at one resolution."""
    res = "resolution=[(96, 64), (64, 48)]"
    expr = (f"10 @ PointodysseyDatasets(split='train', ROOT={roots['po']!r}, {res}, "
            f"aug_crop=8, seed=777) + 6 @ SintelDatasets(split='train', "
            f"ROOT={roots['sintel']!r}, {res}, seed=777)")
    got = tdata.get_data_loader(expr, batch_size=2, num_workers=3)
    ref = jdata.get_data_loader(expr, batch_size=2, num_workers=3)
    got.set_epoch(1)
    ref.set_epoch(1)
    batches = list(zip(got, ref))
    assert len(got) == len(ref) == len(batches) == 8
    shapes = set()
    for bt, bj in batches:
        for vn in ("view1", "view2"):
            assert set(bt[vn]) == set(bj[vn])
            for k, v in bt[vn].items():
                if k in ("pred_depth", "pts3d", "camera_intrinsics"):
                    _close(v, bj[vn][k], k)
                elif isinstance(v, np.ndarray):
                    np.testing.assert_array_equal(v, bj[vn][k], err_msg=k)
                else:
                    assert list(v) == list(bj[vn][k]), k
        shapes.add(bt["view1"]["img"].shape)
    assert shapes == {(2, 64, 96, 3), (2, 48, 64, 3)}


# --------------------------------------------------------------- cropping

@pytest.mark.parametrize("shape,size", [((54, 96), (64, 36)), ((60, 100, 3), (106, 64)),
                                        ((436, 1024), (717, 305)), ((7, 5, 3), (3, 11)),
                                        ((540, 960, 3), (512, 288))])
def test_resize_nearest_matches_cv2(shape, size):
    a = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    np.testing.assert_array_equal(tcrop.resize_nearest(a, size),
                                  cv2.resize(a, size, interpolation=cv2.INTER_NEAREST))


def test_crop_image_zero_fills_like_pil():
    img = frame_image(np.random.default_rng(1), 30, 40)
    for box in ((0, 0, 40, 30), (5, 3, 25, 20), (-4, -2, 30, 20), (20, 10, 50, 45),
                (-3, -3, 43, 33)):
        np.testing.assert_array_equal(tcrop.crop_image(img, *box),
                                      np.asarray(PIL.Image.fromarray(img).crop(box)))


@pytest.mark.parametrize("target,scale", [((64, 48), 1.0), ((160, 120), 0.8), ((96, 40), 0.9)])
def test_rescale_and_center_crop_match_jax(target, scale):
    r = np.random.default_rng(2)
    img = frame_image(r, 60, 100)
    depth = r.uniform(1, 5, (60, 100)).astype(np.float32)
    prior = r.uniform(0, 1, (60, 100, 3)).astype(np.float32)
    K = np.array([[80, 0, 51.3], [0, 82, 29.6], [0, 0, 1]], np.float32)
    got = tcrop.center_crop_image_depthmap(img, depth, prior, K, scale)
    ref = jcrop.center_crop_image_depthmap(PIL.Image.fromarray(img), depth, prior, K, scale)
    got = tcrop.rescale_image_depthmap(*got, target)
    ref = jcrop.rescale_image_depthmap(*ref, target)
    np.testing.assert_array_equal(got[0], np.asarray(ref[0]))
    for a, b in zip(got[1:], ref[1:]):
        np.testing.assert_array_equal(a, b)


# ----------------------------------------------- no imaging library needed

def test_dataset_item_and_jpeg_read_without_pil_or_cv2(roots):
    """The card machine has neither Pillow nor OpenCV: a dataset item over
    JPEG frames and a JPEG through read_rgb in a process where both imports
    fail, against this process's reads."""
    frame = os.path.join(roots["po"], "scene_a", "frame_0000_rgb.jpg")
    expr = CASES["spring_aug_crop"].format(**roots)
    code = (
        "import sys\n"
        "sys.modules['PIL'] = sys.modules['cv2'] = None\n"
        "import numpy as np\n"
        "from align3r_tpu_torch.inference.images import read_rgb\n"
        "from align3r_tpu_torch.training.data import build_dataset\n"
        f"v = build_dataset({expr!r})[3]\n"
        f"np.savez(sys.argv[1], img=read_rgb({frame!r}), view_img=v[0]['img'],"
        " pts3d=v[1]['pts3d'])\n")
    out = os.path.join(os.path.dirname(roots["po"]), "nopil.npz")
    res = subprocess.run([sys.executable, "-c", code, out], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    got = np.load(out)
    np.testing.assert_array_equal(got["img"], cv2.imread(frame)[..., ::-1])
    ref = tdata.build_dataset(expr)[3]
    np.testing.assert_array_equal(got["view_img"], ref[0]["img"])
    np.testing.assert_array_equal(got["pts3d"], ref[1]["pts3d"])
