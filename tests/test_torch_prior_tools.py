"""The port's prior and evaluation tools against the JAX tools, on the CPU.

- tools.prior_depth against tool/prior_depth.py on one folder of frames:
  the same files, depths within 1e-4 of the largest and the same focals
  (Depth Anything V2 and Depth Pro, tiny HF folders written by
  transformers' save_pretrained);
- tools.demo_refine at --device cpu on a tiny checkpoint and a tiny PromptDA
  folder: one refined map a frame at the frame's own resolution, equal to
  the refine step applied to the depths it wrote, and within 1e-4 of JAX's
  rescale_depth_maps on them;
- eval.depth_metrics (every alignment, align_lad2 included), tools.metric,
  tools.depth_test and tools.pose_test against the JAX modules and tools on
  the synthetic folders tests/test_depth_tool.py and test_pose_tool.py
  build. The tools' own logic (sequences, graphs, ground truth, upsampling,
  alignment, metrics, the solve's arguments) is compared with one stand-in
  solve on both sides; each port tool also runs end to end once on a tiny
  seeded model.
"""
import os
import shutil
import sys

import numpy as np
import PIL.Image
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from align3r_tpu.eval import depth_metrics as jdm  # noqa: E402
from align3r_tpu_torch.eval import depth_metrics as tdm  # noqa: E402
from align3r_tpu_torch.eval import metadata as tmeta  # noqa: E402
from align3r_tpu_torch.tools import demo as tdemo  # noqa: E402
from align3r_tpu_torch.utils import hf_weights  # noqa: E402

torch.set_num_threads(2)
TOL = 1e-4   # of the largest reference value


def _numpy(sd):
    return {k: v.float().numpy() if v.is_floating_point() else v.numpy() for k, v in sd.items()}


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max(), np.abs(got - ref).max()


def _run_jax_tool(main, argv):
    old = sys.argv
    sys.argv = argv
    try:
        return main()
    finally:
        sys.argv = old


def _dinov2(**kw):
    from transformers import Dinov2Config
    return Dinov2Config(hidden_size=32, num_attention_heads=4, intermediate_size=64, **kw)


def _da_like(kind, path):
    """A tiny DepthAnything or PromptDepthAnything HF folder (the JAX tests'
    config), with the head's bias raised so relu'd depths are positive."""
    from transformers import DepthAnythingConfig, PromptDepthAnythingConfig
    from transformers.models.depth_anything.modeling_depth_anything import (
        DepthAnythingForDepthEstimation)
    from transformers.models.prompt_depth_anything.modeling_prompt_depth_anything import (
        PromptDepthAnythingForDepthEstimation)
    torch.manual_seed(0)
    bc = _dinov2(num_hidden_layers=4, patch_size=14, image_size=70,
                 out_features=["stage1", "stage2", "stage3", "stage4"],
                 apply_layernorm=True, reshape_hidden_states=False)
    kw = dict(backbone_config=bc, patch_size=14, reassemble_factors=[4, 2, 1, 0.5],
              neck_hidden_sizes=[16, 24, 32, 32], fusion_hidden_size=16, head_hidden_size=8,
              reassemble_hidden_size=32, max_depth=1.0)
    if kind == "prompt":
        model = PromptDepthAnythingForDepthEstimation(
            PromptDepthAnythingConfig(depth_estimation_type="metric", **kw))
    else:
        model = DepthAnythingForDepthEstimation(
            DepthAnythingConfig(depth_estimation_type="relative", **kw))
    with torch.no_grad():
        model.head.conv3.bias.fill_(0.5)
    model.eval().save_pretrained(path)
    return path


def _depth_pro(path):
    from transformers import DepthProConfig
    from transformers.models.depth_pro.modeling_depth_pro import DepthProForDepthEstimation
    torch.manual_seed(0)
    vit = dict(num_hidden_layers=2, patch_size=8, image_size=32)
    cfg = DepthProConfig(
        patch_model_config=_dinov2(**vit), image_model_config=_dinov2(**vit),
        fov_model_config=_dinov2(**vit), patch_size=32, image_size=128,
        scaled_images_ratios=[0.25, 0.5, 1.0], scaled_images_overlap_ratios=[0.0, 0.5, 0.25],
        scaled_images_feature_dims=[32, 32, 16], intermediate_hook_ids=[1, 0],
        intermediate_feature_dims=[16, 16], fusion_hidden_size=16, merge_padding_value=3,
        num_fov_head_layers=2, use_fov_model=True)
    model = DepthProForDepthEstimation(cfg, use_fov_model=True)
    with torch.no_grad():   # inverse depth away from the 1e-4 clip, a 60 degree view
        model.head.layers[4].bias.fill_(1.0)
        model.fov_model.head.layers[4].bias.fill_(60.0)
    model.eval().save_pretrained(path)
    return path


def _frames(root, n=3, hw=(42, 56), seed=0):
    os.makedirs(root)
    rng = np.random.default_rng(seed)
    for i in range(n):
        PIL.Image.fromarray(rng.integers(0, 255, (*hw, 3), np.uint8)).save(
            os.path.join(root, f"frame_{i:03d}.png"))
    return root


@pytest.mark.parametrize("prior", ["depthanything", "depthpro"])
def test_prior_depth_tool_matches_jax(tmp_path, prior):
    """Same .npz files; depth within 1e-4 of the largest, focal within 1e-4
    relative (Depth Anything's pseudo-focal 200 exactly). JAX's Depth Pro
    postprocessing takes one image a batch, so its tool runs --batch_size 1
    and the port's 2."""
    from tool.prior_depth import main as jmain
    from align3r_tpu_torch.tools import prior_depth
    model = (_da_like("da", str(tmp_path / "m")) if prior == "depthanything"
             else _depth_pro(str(tmp_path / "m")))
    jdir = _frames(str(tmp_path / "jax"))
    tdir = str(tmp_path / "port")
    shutil.copytree(jdir, tdir)
    _run_jax_tool(jmain, ["prior_depth.py", "--input_dir", jdir, "--depth_prior_name", prior,
                          "--model_path", model,
                          "--batch_size", "2" if prior == "depthanything" else "1"])
    res = prior_depth.main(["--input_dir", tdir, "--depth_prior_name", prior,
                            "--model_path", model, "--batch_size", "2", "--device", "cpu"])
    names = sorted(f for f in os.listdir(jdir) if f.endswith(".npz"))
    assert names == sorted(f for f in os.listdir(tdir) if f.endswith(".npz"))
    assert sorted(os.path.basename(f) for f in res["files"]) == names and len(names) == 3
    for f in names:
        ref, got = np.load(os.path.join(jdir, f)), np.load(os.path.join(tdir, f))
        assert got["depth"].shape == (42, 56) and got["depth"].dtype == np.float32
        assert np.isfinite(got["depth"]).all()
        _close(got["depth"], ref["depth"])
        np.testing.assert_allclose(float(got["focallength_px"]), float(ref["focallength_px"]),
                                   rtol=TOL)
        if prior == "depthanything":
            assert float(got["focallength_px"]) == 200.0


def test_prior_depth_tool_runs_on_the_card_by_default(tmp_path):
    from align3r_tpu_torch.tools import prior_depth
    assert prior_depth.get_args_parser().parse_args(["--input_dir", "x"]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            prior_depth.main(["--input_dir", str(tmp_path)])


def _tiny_port_model(*_a, **_k):
    """The port's TINY_TEST Align3R, seeded, with the JAX tool tests' small
    final head conv, prepared on the CPU."""
    from align3r_tpu_torch import compat
    from align3r_tpu_torch.models.align3r import Align3R, init_align3r_
    from align3r_tpu_torch.models.config import TINY_TEST
    model = init_align3r_(Align3R(TINY_TEST), seed=0)
    with torch.no_grad():
        for h in (model.downstream_head1, model.downstream_head2):
            h.dpt.head[4].weight.mul_(0.01)
            h.dpt.head[4].bias.mul_(0.0)
    return compat.Align3RModel(model, "cpu").prepared()


def test_demo_refine_cli(tmp_path, monkeypatch):
    from align3r_tpu.models import depth_anything as jda
    from align3r_tpu.models import prompt_da as jpda
    from align3r_tpu_torch.models.prompt_da import load_prompt_da, rescale_depth_maps
    from align3r_tpu_torch.tools import demo_refine
    from align3r_tpu_torch.utils.png import write_png
    frames = tmp_path / "frames"
    frames.mkdir()
    rng = np.random.default_rng(0)
    for i in range(4):
        write_png((rng.random((48, 64, 3)) * 255).astype(np.uint8), frames / f"frame_{i:04d}.png")
        np.savez(frames / f"frame_{i:04d}_pred_depth_depthpro.npz",
                 depth=2 + rng.random((48, 64)).astype(np.float32),
                 focallength_px=np.float32(40.0))
    pda_dir = _da_like("prompt", str(tmp_path / "pda"))
    monkeypatch.setattr(demo_refine, "load_model", _tiny_port_model)
    res = demo_refine.main(["--input_dir", str(frames), "--output_dir", str(tmp_path / "out"),
                            "--seq_name", "ref", "--image_size", "224", "--niter", "5",
                            "--promptda_model", pda_dir, "--device", "cpu", "--silent"])
    seq = tmp_path / "out" / "ref"
    refined = sorted(p for p in os.listdir(seq) if p.endswith("_refined.npy"))
    assert len(refined) == 4 and {"pred_traj.txt", "pred_intrinsics.txt"} <= set(os.listdir(seq))
    got = np.stack([np.load(seq / r) for r in refined])
    assert got.shape == (4, 48, 64) and np.isfinite(got).all()
    assert {"reconstruct_s", "promptda_weights_s", "refine_s"} <= set(res["timings"])
    depths = np.stack([np.load(seq / f"frame_{i:04d}.npy") for i in range(4)])
    imgs = demo_refine.load_raw_images01([str(frames / f"frame_{i:04d}.png") for i in range(4)])
    pda, _ = load_prompt_da(pda_dir, "cpu")
    np.testing.assert_array_equal(rescale_depth_maps(pda, imgs, depths), got)
    config, sd = hf_weights.load(pda_dir)
    from transformers import AutoConfig
    jcfg = jda.config_from_hf(AutoConfig.from_pretrained(pda_dir))
    jparams = jpda.convert_hf_prompt_da(_numpy(sd), jcfg)
    _close(got, jpda.rescale_depth_maps(jparams, jcfg, imgs, depths))


# ------------------------------------------------------------------ metrics

@pytest.fixture(scope="module")
def pred_gt():
    rng = np.random.default_rng(0)
    gt = rng.uniform(1.0, 20.0, 3000)
    pred = 0.4 * gt + 0.3 + rng.normal(0, 0.3, gt.shape)
    pred[::50] *= 3.0                                  # outliers for the robust fits
    return np.abs(pred) + 0.05, gt


@pytest.mark.parametrize("align", ["lstsq", "lad", "lad2", "scale", "median"])
def test_alignment_matches_jax(pred_gt, align):
    """Scale and shift within 1e-6 (lad2: 1e-4; JAX's optax Adam and the
    port's torch Adam differ in the last bits of each step)."""
    pred, gt = pred_gt
    ref = jdm.ALIGN_FNS[align](pred, gt)
    got = tdm.ALIGN_FNS[align](pred, gt)
    np.testing.assert_allclose(got, ref, atol=1e-4 if align == "lad2" else 1e-6, rtol=0)


@pytest.mark.parametrize("align", ["lad", "lad2", "median"])
def test_sequence_metrics_match_jax(align):
    rng = np.random.default_rng(1)
    gt = rng.uniform(0.5, 80.0, (3, 16, 20))
    gt[0, :2] = 75.0                                  # pixels past depth_max
    pred = gt * rng.uniform(0.8, 1.2, gt.shape) * 0.5 + 0.2
    ref = jdm.evaluate_sequence_depth(pred, gt, align=align)
    got = tdm.evaluate_sequence_depth(pred, gt, align=align, device="cpu")
    assert set(got) == set(ref) and got["valid_pixels"] == ref["valid_pixels"]
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, err_msg=k)
    avg_r = jdm.average_metrics([ref, ref | {"valid_pixels": 7}])
    avg_g = tdm.average_metrics([got, got | {"valid_pixels": 7}])
    assert avg_r.keys() == avg_g.keys()
    mask = gt > 1.0
    for f in ("i_rmse", "silog_rmse"):
        np.testing.assert_allclose(getattr(tdm, f)(pred, gt, mask),
                                   getattr(jdm, f)(pred, gt, mask), rtol=1e-12)


def test_metric_tool_matches_jax(tmp_path, capsys):
    import tool.metric as jm
    from align3r_tpu_torch.tools import metric as tm
    rng = np.random.default_rng(2)
    gt = rng.uniform(0.5, 90.0, (2, 12, 14))
    pred = gt * rng.uniform(0.7, 1.3, gt.shape)
    valid = gt < 80
    for name in ("abs_relative_difference", "squared_relative_difference", "rmse_linear",
                 "rmse_log", "log10", "delta1_acc", "delta2_acc", "delta3_acc", "i_rmse",
                 "silog_rmse"):
        for mask in (valid, None):
            assert getattr(tm, name)(pred, gt, mask) == pytest.approx(
                getattr(jm, name)(pred, gt, mask), rel=1e-12), name
    np.save(tmp_path / "p.npy", pred)
    np.savez(tmp_path / "g.npz", depth=gt)
    argv = [str(tmp_path / "p.npy"), str(tmp_path / "g.npz")]
    _run_jax_tool(jm.main, ["metric.py", *argv])
    ref = capsys.readouterr().out
    tm.main(argv)
    assert capsys.readouterr().out == ref and "AbsRel" in ref


# -------------------------------------------------------------- depth_test

class _StandInScene:
    """A solve's result from the priors alone (the same numbers on both
    sides): depth = 1 + the prior's normalised z, poses a slow drift."""

    def __init__(self, imgs, priors, kw):
        self.n = imgs.shape[0]
        self.depths = (1.0 + np.asarray(priors)[..., 2]).astype(np.float32)
        self.kw = kw

    def get_depthmaps(self):
        return self.depths

    def get_im_poses(self):
        P = np.tile(np.eye(4, dtype=np.float32), (self.n, 1, 1))
        P[:, :3, 3] = np.arange(self.n)[:, None] * np.float32([0.1, 0.02, 0.01])
        return P

    def save_tum_poses(self, path):
        from align3r_tpu_torch.eval.trajectory import poses_to_traj, save_tum_trajectory
        save_tum_trajectory(poses_to_traj(self.get_im_poses()), path)

    def save_intrinsics(self, path):
        np.savetxt(path, np.tile(np.eye(3).reshape(1, 9), (self.n, 1)))

    def save_depth_maps(self, out_dir):
        for i, d in enumerate(self.depths):
            np.save(os.path.join(out_dir, f"frame_{i:04d}.npy"), d)
        return self.depths

    def save_dynamic_masks(self, out_dir):
        pass


def _stand_in(calls):
    def solve(imgs, priors, *model, **kw):
        calls.append({k: v for k, v in kw.items()
                      if k not in ("raft_params", "raft_kind", "sam2_model")})
        return _StandInScene(imgs, priors, kw)
    return solve


def _jax_tool_env(monkeypatch, calls):
    import tool.demo
    from align3r_tpu import pipeline as jpipe
    monkeypatch.setattr(tool.demo, "load_model", lambda *a, **k: (None, None))
    monkeypatch.setattr(jpipe, "reconstruct_scene", _stand_in(calls))


def _port_tool_env(monkeypatch, module, calls):
    monkeypatch.setattr(tdemo, "load_model", lambda *a, **k: None)
    monkeypatch.setattr(module, "reconstruct_scene", _stand_in(calls))


@pytest.mark.parametrize("align", ["lad", "lad2"])
def test_depth_test_tool_matches_jax(monkeypatch, tmp_path, align):
    """PointOdyssey layout (jpg frames, native-resolution pfm ground truth):
    the same solve arguments, depths, and metrics within 1e-4 relative."""
    import tool.depth_test as JDT
    from test_depth_tool import _make_po_fixture
    from align3r_tpu_torch.tools import depth_test as TDT
    _make_po_fixture(str(tmp_path))
    monkeypatch.chdir(tmp_path)
    jcalls, tcalls = [], []
    _jax_tool_env(monkeypatch, jcalls)
    _port_tool_env(monkeypatch, TDT, tcalls)
    common = ["--eval_dataset", "PointOdyssey", "--image_size", "64", "--niter", "5",
              "--align", align, "--no_promptda", "--if_use_mono"]
    _run_jax_tool(JDT.main, ["depth_test", "--output_dir", "jout", *common])
    TDT.main(["--output_dir", "tout", *common, "--device", "cpu"])
    assert len(jcalls) == len(tcalls) == 1
    jkw, tkw = jcalls[0], tcalls[0]
    np.testing.assert_allclose(tkw.pop("mono_depths"), jkw.pop("mono_depths"), atol=1e-6)
    assert tkw == jkw
    np.testing.assert_allclose(np.load("tout/seqA_depths.npy"), np.load("jout/seqA_depths.npy"),
                               atol=1e-6)
    read = lambda p: {l.split(":")[0]: float(l.split(":")[1]) for l in open(p)}  # noqa: E731
    ref, got = read("jout/_metrics_0.txt"), read("tout/_metrics_0.txt")
    assert got.keys() == ref.keys() and got["valid_pixels"] == ref["valid_pixels"] == 4 * 96 * 128
    for k in ref:
        assert got[k] == pytest.approx(ref[k], rel=1e-4, abs=1e-7), k


def test_depth_test_upsampling_matches_jax(tmp_path):
    """Bilinear (cv2 INTER_LINEAR in JAX) and PromptDA upsampling to the
    ground truth's resolution, within 1e-4 of the largest value."""
    import tool.depth_test as JDT
    from align3r_tpu.models import depth_anything as jda
    from align3r_tpu.models import prompt_da as jpda
    from align3r_tpu_torch.models.prompt_da import load_prompt_da
    from align3r_tpu_torch.tools import depth_test as TDT
    d = np.random.default_rng(3).uniform(1, 3, (2, 12, 16)).astype(np.float32)
    _close(TDT.upsample_predictions(d, ["x"], (30, 41)),
           JDT.upsample_predictions(d, ["x"], (30, 41), None))
    root = _frames(str(tmp_path / "f"), 2, (36, 50))
    files = [os.path.join(root, f"frame_{i:03d}.png") for i in range(2)]
    pda_dir = _da_like("prompt", str(tmp_path / "pda"))
    from transformers import AutoConfig
    jcfg = jda.config_from_hf(AutoConfig.from_pretrained(pda_dir))
    jparams = jpda.convert_hf_prompt_da(_numpy(hf_weights.read_state_dict(pda_dir)),
                                        jcfg)
    for gt_hw in ((36, 50), (40, 56)):
        ref = JDT.upsample_predictions(d, files, gt_hw, (jparams, jcfg))
        got = TDT.upsample_predictions(d, files, gt_hw, load_prompt_da(pda_dir, "cpu")[0])
        assert got.shape == (2, *gt_hw)
        _close(got, ref)


def test_depth_test_tool_end_to_end(monkeypatch, tmp_path):
    """The port's tool with its own pipeline on a tiny seeded model: depths
    at model resolution, metrics at the ground truth's (every GT pixel)."""
    from test_depth_tool import _make_po_fixture
    from align3r_tpu_torch.tools import depth_test as TDT
    _make_po_fixture(str(tmp_path))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tdemo, "load_model", _tiny_port_model)
    TDT.main(["--eval_dataset", "PointOdyssey", "--output_dir", "out", "--image_size", "64",
              "--niter", "5", "--batch_size", "4", "--no_promptda", "--device", "cpu"])
    d = np.load("out/seqA_depths.npy")
    assert d.shape[0] == 4 and d.shape[1] < 96 and np.isfinite(d).all()
    vals = {l.split(":")[0]: float(l.split(":")[1]) for l in open("out/_metrics_0.txt")}
    assert np.isfinite(vals["Abs Rel"]) and vals["valid_pixels"] == 4 * 96 * 128


def test_metadata_matches_jax(tmp_path):
    from align3r_tpu.eval import metadata as jmeta
    from align3r_tpu.parallel.mesh import process_slice
    assert jmeta.dataset_metadata.keys() == tmeta.dataset_metadata.keys()
    for name, j in jmeta.dataset_metadata.items():
        t = tmeta.dataset_metadata[name]
        for f in ("img_path", "anno_path", "mask_path", "traj_format", "seq_list", "full_seq",
                  "skip_if_done", "bottom_level", "seq_stride"):
            assert getattr(t, f) == getattr(j, f), (name, f)
        assert t.seq_dir("P", "s") == j.seq_dir("P", "s")
        assert t.gt_traj("P", "A", "s") == j.gt_traj("P", "A", "s")
        assert t.mask_dir("M", "s") == j.mask_dir("M", "s")
    for s in ("A/0001", "A/0002", "B/0003"):
        os.makedirs(tmp_path / s)
    for stride in (1, 2):
        kw = dict(img_path=str(tmp_path), full_seq=True, bottom_level=True, seq_stride=stride)
        assert tmeta.DatasetMeta(**kw).sequences() == jmeta.DatasetMeta(**kw).sequences()
    for n, i in ((1, 0), (3, 1)):
        assert tmeta.process_slice(range(8), n, i) == process_slice(range(8), n, i)


# --------------------------------------------------------------- pose_test

def test_pose_test_tool_matches_jax(monkeypatch, tmp_path):
    """ScanNet layout (replica-row ground truth): the same solve arguments,
    trajectory files, and ATE / RPE within 1e-6 relative."""
    import tool.pose_test as JPT
    from test_pose_tool import _make_scannet_fixture
    from align3r_tpu_torch.tools import pose_test as TPT
    _make_scannet_fixture(str(tmp_path), 6)
    monkeypatch.chdir(tmp_path)
    jcalls, tcalls = [], []
    _jax_tool_env(monkeypatch, jcalls)
    _port_tool_env(monkeypatch, TPT, tcalls)
    common = ["--eval_dataset", "scannet", "--image_size", "64", "--niter", "5",
              "--batch_size", "4", "--lr", "0.05"]
    _run_jax_tool(JPT.main, ["pose_test", "--output_dir", "jout", *common])
    TPT.main(["--output_dir", "tout", *common, "--device", "cpu"])
    assert not os.path.exists("jout/_error_log_0.txt") and not os.path.exists("tout/_error_log_0.txt")
    assert tcalls == jcalls and tcalls[0]["scene_graph"] == "swinstride-2-noncyclic"
    np.testing.assert_array_equal(np.loadtxt("tout/scene0/pred_traj.txt"),
                                  np.loadtxt("jout/scene0/pred_traj.txt"))
    ref = dict(l.split() for l in open("jout/_results_0.txt"))
    got = dict(l.split() for l in open("tout/_results_0.txt"))
    assert got.keys() == ref.keys()
    for k in ref:
        assert float(got[k]) == pytest.approx(float(ref[k]), rel=1e-6, abs=1e-9), k


def test_pose_test_tool_sam2_flag_matches_jax(monkeypatch, tmp_path):
    """--sam2_mask_refine reaches reconstruct_scene as in the JAX tool; with
    no local SAM2 checkpoint the port loads no model (the pipeline then
    cleans the masks up, as JAX's does)."""
    import tool.pose_test as JPT
    from test_pose_tool import _make_scannet_fixture
    from align3r_tpu_torch.tools import pose_test as TPT
    _make_scannet_fixture(str(tmp_path), 6)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    jcalls, tcalls = [], []
    _jax_tool_env(monkeypatch, jcalls)
    port = []
    monkeypatch.setattr(TPT, "reconstruct_scene",
                        lambda *a, **kw: port.append(kw.get("sam2_model", "absent"))
                        or _stand_in(tcalls)(*a, **kw))
    monkeypatch.setattr(tdemo, "load_model", lambda *a, **k: None)
    common = ["--eval_dataset", "scannet", "--image_size", "64", "--niter", "5",
              "--batch_size", "4", "--sam2_mask_refine"]
    _run_jax_tool(JPT.main, ["pose_test", "--output_dir", "jout", *common])
    TPT.main(["--output_dir", "tout", *common, "--device", "cpu"])
    assert tcalls == jcalls and tcalls[0]["sam2_mask_refine"] is True
    assert port == [None]


def test_pose_test_tool_end_to_end(monkeypatch, tmp_path):
    from test_pose_tool import _make_scannet_fixture
    from align3r_tpu_torch.tools import pose_test as TPT
    _make_scannet_fixture(str(tmp_path), 6)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tdemo, "load_model", _tiny_port_model)
    TPT.main(["--eval_dataset", "scannet", "--output_dir", "out", "--image_size", "64",
              "--niter", "5", "--batch_size", "4", "--lr", "0.05", "--device", "cpu"])
    assert not os.path.exists("out/_error_log_0.txt"), open("out/_error_log_0.txt").read()
    vals = dict(l.split() for l in open("out/_results_0.txt"))
    assert np.isfinite(float(vals["ate"])) and int(vals["n"]) == 1
    assert np.loadtxt("out/scene0/pred_traj.txt").shape == (6, 8)
