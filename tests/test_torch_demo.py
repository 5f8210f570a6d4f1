"""End to end on the CPU: `python -m align3r_tpu_torch.tools.demo`, as
tests/test_demo_tool.py drives tool/demo.py. A tiny seeded checkpoint
written by the port's export_torch_checkpoint and 4 synthetic 64x48 PNG
frames with DepthPro-style priors go through both modes at --image_size 224
with --niter 5 and --device cpu; the artifacts are checked, and the depths
are those of a direct reconstruct_scene call on the loaded arrays."""
import os
import struct

import numpy as np
import pytest
import torch

from align3r_tpu_torch.inference.images import load_images, stack_views
from align3r_tpu_torch.models.align3r import Align3R, init_align3r_
from align3r_tpu_torch.models.config import Align3RConfig
from align3r_tpu_torch.models.convert import load_torch_checkpoint
from align3r_tpu_torch.pipeline import reconstruct_scene
from align3r_tpu_torch.tools import demo
from align3r_tpu_torch.training.train import export_torch_checkpoint
from align3r_tpu_torch.utils.png import write_png

torch.set_num_threads(2)
H, W, N = 48, 64, 4


@pytest.fixture(scope="module")
def demo_inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("demo_in")
    rng = np.random.default_rng(0)
    for i in range(N):
        write_png((rng.random((H, W, 3)) * 255).astype(np.uint8), root / f"frame_{i:04d}.png")
        np.savez(root / f"frame_{i:04d}_pred_depth_depthpro.npz",
                 depth=2 + rng.random((H, W)).astype(np.float32),
                 focallength_px=np.float32(40.0))
    cfg = Align3RConfig(img_size=(H, W), enc_embed_dim=64, enc_depth=4, enc_num_heads=4,
                        dec_embed_dim=48, dec_depth=12, dec_num_heads=4, landscape_only=False)
    model = init_align3r_(Align3R(cfg), seed=0)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():   # the prior branch counts; random heads stay in expm1's range
        for z in model.zero_convs:
            z[0].weight.copy_(torch.randn(z[0].weight.shape, generator=g) * 0.2)
        for h in (model.downstream_head1, model.downstream_head2):
            h.dpt.head[4].weight.mul_(0.01)
            h.dpt.head[4].bias.mul_(0.01)
    export_torch_checkpoint(str(root / "tiny.pth"), model)
    return root


def test_exported_checkpoint_carries_its_config(demo_inputs):
    """export_torch_checkpoint records the config's constructor string, so
    the demo rebuilds the tiny config; the file loads with weights_only."""
    path = str(demo_inputs / "tiny.pth")
    ckpt = torch.load(path, weights_only=True)
    assert set(ckpt) == {"model", "args"}
    sd, cfg = load_torch_checkpoint(path)
    assert cfg == Align3RConfig(img_size=(H, W), enc_embed_dim=64, enc_depth=4,
                                enc_num_heads=4, dec_embed_dim=48, dec_depth=12,
                                dec_num_heads=4, landscape_only=False)
    Align3R(cfg).load_state_dict(sd, strict=True)


def _argv(inputs, out, *extra):
    return ["--weights", str(inputs / "tiny.pth"), "--input_dir", str(inputs),
            "--output_dir", str(out), "--seq_name", "smoke", "--image_size", "224",
            "--niter", "5", "--device", "cpu", "--silent", *extra]


def test_demo_cli_end_to_end(demo_inputs, tmp_path):
    res = demo.main(_argv(demo_inputs, tmp_path / "out"))
    seq = tmp_path / "out" / "smoke"
    assert res["out_dir"] == str(seq)
    assert {"weights_s", "frames_s", "inference_s", "init_s", "solve_s",
            "writers_s"} <= set(res["timings"])
    names = set(os.listdir(seq))
    for want in ("pred_traj.txt", "pred_intrinsics.txt", "pred_focals.txt", "scene.html",
                 "scene.glb", "frame_0000.npy", "frame_0000.png", "conf_0.npy",
                 "dynamic_mask_0.png"):
        assert want in names, (want, sorted(names))
    raw = (seq / "scene.glb").read_bytes()
    magic, ver, total = struct.unpack_from("<4sII", raw, 0)
    assert magic == b"glTF" and ver == 2 and total == len(raw)
    traj = np.loadtxt(seq / "pred_traj.txt")
    assert traj.shape == (N, 8) and np.isfinite(traj).all()
    assert "[-f[0], -f[1], -f[2], tz]" in (seq / "scene.html").read_text()
    depths = np.stack([np.load(seq / f"frame_{i:04d}.npy") for i in range(N)])
    assert np.isfinite(depths).all() and (depths > 0).all()
    assert np.loadtxt(seq / "pred_intrinsics.txt").shape == (N, 9)

    # the same solve called directly on the loaded arrays
    stacked = stack_views(load_images(str(demo_inputs), 224, traj_format="default",
                                      interval=30))
    pm = demo.load_model(str(demo_inputs / "tiny.pth"), 224, "cpu")
    scene = reconstruct_scene(
        stacked["imgs"], stacked["priors"], pm, scene_graph="swinstride-5-noncyclic",
        variant="flow", use_self_mask=True, niter=5, lr=0.01, schedule="linear",
        batch_size=8, scene_kw=dict(shared_focal=True, temporal_smoothing_weight=0.01,
                                    translation_weight=1.0, flow_loss_weight=0.0,
                                    flow_loss_start_epoch=0.1, flow_loss_thre=25,
                                    min_conf_thr=1.1))
    np.testing.assert_array_equal(scene.get_depthmaps(), depths)


def test_demo_cli_hierarchical(demo_inputs, tmp_path):
    """--mode eval_pose_h with 4 > clip_size + 1 frames: the hierarchical
    solve, which writes the trajectory and the stacked depth maps. The
    weights come prepared (main's `model`), so none are loaded."""
    pm = demo.load_model(str(demo_inputs / "tiny.pth"), 224, "cpu")
    res = demo.main(_argv(demo_inputs, tmp_path / "out", "--mode", "eval_pose_h",
                          "--clip_size", "2"), model=pm)
    assert "weights_s" not in res["timings"]
    seq = tmp_path / "out" / "smoke"
    assert sorted(os.listdir(seq)) == ["depth_maps.npy", "pred_traj.txt"]
    traj = np.loadtxt(seq / "pred_traj.txt")
    depths = np.load(seq / "depth_maps.npy")
    assert traj.shape == (N, 8) and np.isfinite(traj).all()
    assert depths.shape == (N, 224, 224) and np.isfinite(depths).all() and (depths > 0).all()
    assert res["timings"]["clips_solve_s"] > 0


def test_demo_runs_on_the_card_by_default(demo_inputs, tmp_path):
    """--device defaults to cuda; without a card the demo raises and names
    --device cpu's spelling, as prepare() does."""
    args = demo.get_args_parser().parse_args([])
    assert args.device == "cuda" and args.image_size == 512 and args.interval == 30
    if not torch.cuda.is_available():
        argv = [a for a in _argv(demo_inputs, tmp_path / "out") if a not in ("--device", "cpu")]
        with pytest.raises(RuntimeError, match="device='cpu'"):
            demo.main(argv)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            demo.main(argv + ["--device", "cuda"])
