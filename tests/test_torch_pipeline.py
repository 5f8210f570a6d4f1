"""Port parity for the slice as a whole: align3r_tpu_torch.pipeline.
reconstruct_scene against align3r_tpu.pipeline.reconstruct_scene on
TINY_TEST, plus the port's import and entry-point contracts.

The whole-slice comparison runs the fp32 engine (the JAX one on its XLA
path), the host MST init, and a 100-iteration mixed-precision flow-variant
solve (JAX: fused Pallas kernel in interpret mode). Random network weights
give pointmaps with no consistent geometry, where two RANSAC-PnP solvers may
legitimately pick different poses, so the PnP fallback is switched off on
both sides for this comparison (it has its own test against OpenCV in
test_torch_scene.py). Tolerances are stated inline.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from align3r_tpu import pipeline as jpipe
from align3r_tpu.alignment import init_poses as jinit
from align3r_tpu.alignment import pair_viewer as jpv
from align3r_tpu.models import raft as jraft
from align3r_tpu.models.config import TINY_TEST
from align3r_tpu_torch import pipeline as tpipe
from align3r_tpu_torch.alignment import init_poses as tinit
from align3r_tpu_torch.alignment import pair_viewer as tpv
from align3r_tpu_torch.models import raft as traft
from align3r_tpu_torch.models.align3r import Align3R
from align3r_tpu_torch.models.convert import state_dict_from_jax

from test_torch_engine import _numpy_init
from test_torch_flow import _pnp

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_IMG, H, W = 6, 48, 64
SCENE_KW = dict(shared_focal=True, temporal_smoothing_weight=0.01,
                translation_weight=1.0, flow_loss_weight=0.0, min_conf_thr=1.1)


def _tiny_scene():
    """TINY_TEST weights (zero convs made non-zero, final head convs scaled)
    for both packages, and seeded frames and priors."""
    params = jax.tree.map(jnp.asarray, _numpy_init(seed=4))
    r = np.random.default_rng(5)
    params["zero_convs"]["kernel"] = jnp.asarray(
        0.05 * r.standard_normal(params["zero_convs"]["kernel"].shape), jnp.float32)
    for h in ("head1", "head2"):
        params[h]["head_conv3"]["kernel"] = params[h]["head_conv3"]["kernel"] * 0.1
    model = Align3R(TINY_TEST)
    model.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params), TINY_TEST),
                          strict=True)
    imgs = r.uniform(-1, 1, (N_IMG, H, W, 3)).astype(np.float32)
    priors = r.uniform(0, 1, (N_IMG, H, W, 3)).astype(np.float32)
    return params, model, imgs, priors


def test_reconstruct_scene_matches_jax(monkeypatch):
    params, model, imgs, priors = _tiny_scene()
    monkeypatch.setattr(jinit, "fast_pnp", lambda *a, **k: None)
    monkeypatch.setattr(tinit, "fast_pnp", lambda *a, **k: None)
    common = dict(scene_graph="swinstride-2-noncyclic", batch_size=4, variant="flow",
                  niter=100, schedule="linear", lr=0.01)
    ref = jpipe.reconstruct_scene(imgs, priors, params, TINY_TEST,
                                  scene_kw=dict(SCENE_KW, fast_impl="fused"),
                                  inference_kw=dict(dtype=jnp.float32,
                                                    head_dtype=jnp.float32),
                                  **common)
    got = tpipe.reconstruct_scene(imgs, priors,
                                  model.prepare(torch.float32, torch.float32, device="cpu"),
                                  scene_kw=SCENE_KW, **common)
    assert got.cfg.n_edges == ref.cfg.n_edges and got.cfg.imshape == (H, W)
    # engine outputs carried into the scene: fp32 engine, 1e-5 of the range
    a, b = got.data.pred_i.numpy(), np.asarray(ref.data.pred_i)
    assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()
    # 100 Adam steps on bf16-then-fp32 packs from near-identical inits:
    # the loss curve to 1e-2 of its range, the outputs to 2e-2
    assert np.abs(got.losses - ref.losses).max() <= 1e-2 * np.abs(ref.losses).max()
    for name in ("get_im_poses", "get_focals", "get_depthmaps", "get_intrinsics"):
        x, y = getattr(got, name)(), getattr(ref, name)()
        assert x.shape == y.shape
        assert np.abs(x - y).max() <= 2e-2 * np.abs(y).max(), name


RAFT_TINY = dict(dim=32, radius=2, corr_levels=3, initial_dim=16, block_dims=(16, 24, 32),
                 n_blocks=(1, 1, 1), num_refine=1, iters=20)


def test_reconstruct_scene_with_raft_flows_matches_jax(monkeypatch):
    """The flow path end to end: RAFT flows for every edge in both
    directions, self-supervised motion masks, and a 100-iteration solve with
    the flow term (the demo's weight 0.01 from 10% of the iterations; the
    threshold raised to 1e6 so that the term acts on random weights) and the
    depth regulariser. JAX's compute_raft_flows is fixed to spring-M, so its
    side runs the JAX raft_forward at a tiny SEA-RAFT config from the same
    weights the port's module holds (raft_from_jax). PnP is the same
    deterministic stand-in on both sides (pair_viewer) or off (mst_init).
    Tolerances: flows to 1e-4 of their largest value; masks equal on all but
    0.1% of the pixels (fp32 rounding at the threshold); the loss curve to
    1e-4 of its range, the focals to 1e-4 and the frames' median depths to
    2e-3 of the largest. Poses and per-pixel depths are not compared: on this random-weight
    scene the flow term leaves them weakly determined, and Adam's
    per-coordinate normalisation turns rounding-level gradient differences
    into full steps along those flat directions (the port against itself,
    with its flows scaled by 1 + 1e-6, moves the poses by 0.13 in 30
    iterations while its loss curve moves by 4e-6). The flow term's own
    gradients are held to JAX's in test_torch_flow.py."""
    params, model, imgs, priors = _tiny_scene()
    jcfg, tcfg = jraft.RAFTConfig(**RAFT_TINY), traft.RAFTConfig(**RAFT_TINY)
    rparams = jax.tree.map(np.asarray, jraft.init_raft(jax.random.PRNGKey(7), jcfg))
    jfwd = jax.jit(lambda a, b: jraft.raft_forward(jax.tree.map(jnp.asarray, rparams), a, b,
                                                   jcfg, iters=20))

    def jax_flows(raft_params, imgs01, edges, raft_kind="raft2"):
        x = jnp.asarray(imgs01 * 255.0, jnp.float32)
        a, b = x[np.array([e[0] for e in edges])], x[np.array([e[1] for e in edges])]
        return np.asarray(jfwd(a, b)), np.asarray(jfwd(b, a))

    monkeypatch.setattr(jpipe, "compute_raft_flows", jax_flows)
    for mod in (jinit, tinit):
        monkeypatch.setattr(mod, "fast_pnp", lambda *a, **k: None)
    for mod in (jpv, tpv):
        monkeypatch.setattr(mod, "fast_pnp", _pnp)
    scene_kw = dict(SCENE_KW, flow_loss_weight=0.01, flow_loss_start_epoch=0.1,
                    flow_loss_thre=1e6, depth_regularize_weight=0.01)
    common = dict(scene_graph="swinstride-2-noncyclic", batch_size=4, variant="flow",
                  niter=100, schedule="linear", lr=0.01, use_self_mask=True)
    ref = jpipe.reconstruct_scene(imgs, priors, params, TINY_TEST, raft_params=rparams,
                                  scene_kw=dict(scene_kw, fast_impl="fused"),
                                  inference_kw=dict(dtype=jnp.float32,
                                                    head_dtype=jnp.float32),
                                  **common)
    raft = traft.raft_from_jax(rparams, tcfg)
    got = tpipe.reconstruct_scene(imgs, priors,
                                  model.prepare(torch.float32, torch.float32, device="cpu"),
                                  raft_params=raft, scene_kw=scene_kw, **common)
    assert {"raft_s", "masks_s", "inference_s", "init_s", "solve_s"} <= set(got.timings)
    fl = got.data.flow_ij.numpy()
    assert fl.shape == (got.cfg.n_edges, H, W, 2)
    assert np.abs(fl - np.asarray(ref.data.flow_ij)).max() <= 1e-4 * np.abs(fl).max()
    assert got.dynamic_masks.shape == (N_IMG, H, W)
    assert (got.dynamic_masks != np.asarray(ref.dynamic_masks)).mean() <= 1e-3
    assert 0.0 < got.dynamic_masks.mean() < 1.0
    assert got.data.init_depth is not None
    assert np.abs(got.losses - ref.losses).max() <= 1e-4 * np.abs(ref.losses).max()
    np.testing.assert_allclose(got.get_focals(), ref.get_focals(), rtol=1e-4)
    med = lambda d: np.median(d.reshape(N_IMG, -1), axis=1)
    a, b = med(got.get_depthmaps()), med(ref.get_depthmaps())
    assert np.abs(a - b).max() <= 2e-3 * np.abs(b).max()


def test_scene_result_savers(tmp_path):
    """The savers write the reference artifact formats."""
    from test_torch_scene import _output
    from align3r_tpu_torch.alignment import scene as ts
    out, _ = _output()
    cfg, data, params = ts.build_scene(out, SCENE_KW)
    params = tinit.mst_init(params, data, cfg, out["pred1"]["conf"], out["pred2"]["conf"])
    res = tpipe.SceneResult(cfg=cfg, data=data, params=params, losses=np.zeros(1))
    res.save_tum_poses(tmp_path / "traj.txt")
    rows = np.loadtxt(tmp_path / "traj.txt")
    assert rows.shape == (cfg.n_imgs, 8)
    np.testing.assert_allclose(np.linalg.norm(rows[:, 4:], axis=1), 1.0, rtol=1e-5)
    res.save_focals(tmp_path / "focals.txt")
    assert np.loadtxt(tmp_path / "focals.txt").shape == (cfg.n_imgs,)
    res.save_intrinsics(tmp_path / "K.txt")
    assert np.loadtxt(tmp_path / "K.txt").shape == (cfg.n_imgs, 9)
    depths = res.save_depth_maps(tmp_path / "depth")
    np.testing.assert_array_equal(np.load(tmp_path / "depth" / "frame_0000.npy"), depths[0])
    png = (tmp_path / "depth" / "frame_0000.png").read_bytes()
    assert png[:8] == b"\x89PNG\r\n\x1a\n"


def test_flow_savers(tmp_path):
    """Confidence maps as conf_{i}.npy, dynamic masks as 8-bit PNGs (255 =
    dynamic; all static when the solve had none)."""
    from test_torch_scene import _output
    from align3r_tpu_torch.alignment import scene as ts
    out, _ = _output()
    cfg, data, params = ts.build_scene(out, SCENE_KW)
    masks = np.zeros((cfg.n_imgs,) + cfg.imshape, bool)
    masks[1, 2:5, 3:7] = True
    res = tpipe.SceneResult(cfg=cfg, data=data, params=params, losses=np.zeros(1),
                            dynamic_masks=masks)
    confs = res.save_conf_maps(tmp_path / "conf")
    np.testing.assert_array_equal(np.load(tmp_path / "conf" / "conf_1.npy"), confs[1])
    res.save_dynamic_masks(tmp_path / "dyn", start=3)
    png = (tmp_path / "dyn" / "dynamic_mask_4.png").read_bytes()
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    import struct, zlib
    body = zlib.decompress(png[png.index(b"IDAT") + 4:png.index(b"IEND") - 8])
    rows = np.frombuffer(body, np.uint8).reshape(cfg.imshape[0], cfg.imshape[1] + 1)[:, 1:]
    np.testing.assert_array_equal(rows, masks[1].astype(np.uint8) * 255)
    assert struct.unpack(">II", png[16:24]) == (cfg.imshape[1], cfg.imshape[0])
    res.dynamic_masks = None
    assert not res.save_dynamic_masks(tmp_path / "none").any()


def test_sam2_refinement_raises():
    """SAM2 is not ported: the error points to ROADMAP's SAM2 item by name."""
    with pytest.raises(NotImplementedError, match='ROADMAP queue 1, the "SAM2" item'):
        tpipe.reconstruct_scene(np.zeros((2, 32, 32, 3), np.float32),
                                np.zeros((2, 32, 32, 3), np.float32), None,
                                sam2_mask_refine=True)


def test_prepare_defaults_to_the_card():
    """prepare() puts the serving weights on the card: without CUDA it
    raises and names device="cpu"; device="cpu" builds them on the CPU."""
    model = Align3R(TINY_TEST)
    pm = model.prepare(torch.float32, torch.float32, device="cpu")
    assert pm.device == torch.device("cpu") and pm.enc_blocks[0]["w1"].device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            model.prepare()


def test_port_imports_no_jax():
    code = ("import sys; import align3r_tpu_torch.pipeline, "
            "align3r_tpu_torch.models.convert, align3r_tpu_torch.ops._lib; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')]; "
            "assert not bad, bad; print('ok')")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_chip_smoke_fails_without_a_card(tmp_path):
    """chip_smoke.py exits non-zero and prints no result line where CUDA is
    unavailable, and where it stands alone without the port."""
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert res.returncode != 0 and '"ok": true' not in res.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    res = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and '"ok": true' not in res.stdout
