"""Port parity: MST initialisation, the numpy PnP and the Adam global-
alignment solve of align3r_tpu_torch against align3r_tpu (and OpenCV).

Scenes are synthetic and geometrically consistent (smooth depths, small
camera motion, as tests/test_alignment.py builds them), made with numpy.
The solve runs from the identical init (the JAX mst_init output carried
across) in the default mixed precision: the first 80% of the iterations on
bf16-packed observations, the rest on an fp32 repack; the JAX side runs its
fused Pallas kernel in interpret mode (fast_impl="fused"), the port the plain
versions of K3/K4. Tolerances are stated per test.
"""
import dataclasses

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from align3r_tpu.alignment import init_poses as jinit
from align3r_tpu.alignment import scene as js
from align3r_tpu.alignment.flow import flow_forward as jflow
from align3r_tpu_torch.alignment import init_poses as tinit
from align3r_tpu_torch.alignment import scene as ts
from align3r_tpu_torch.alignment.flow import flow_forward as tflow

torch.set_num_threads(2)
H, W, FOCAL = 16, 24, 40.0
SCENE_KW = dict(shared_focal=True, temporal_smoothing_weight=0.01,
                translation_weight=1.0, min_conf_thr=1.1)


def _synth(n=4, seed=0):
    grid = np.stack(np.meshgrid(np.arange(W), np.arange(H)), -1).astype(np.float32)
    depths = np.stack([2.0 + 0.3 * np.sin(grid[..., 0] / 5 + k)
                       + 0.2 * np.cos(grid[..., 1] / 4) for k in range(n)])
    poses = [np.eye(4, dtype=np.float32)]
    for k in range(1, n):
        th = 0.03 * k
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = [[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]]
        T[:3, 3] = [0.1 * k, 0.02 * k, 0.05 * k]
        poses.append(T)
    cams = np.stack([np.stack([d * (grid[..., 0] - W / 2) / FOCAL,
                               d * (grid[..., 1] - H / 2) / FOCAL, d], -1)
                     for d in depths]).astype(np.float32)
    return depths.astype(np.float32), np.stack(poses), cams


def _output(n=4, noise=0.0, seed=0):
    depths, poses, cams = _synth(n)
    edges = [(i, j) for i in range(n) for j in range(n) if i != j and abs(i - j) <= 2]
    E = len(edges)
    p1 = np.stack([cams[i] for i, _ in edges])
    p2 = np.stack([cams[j] @ (np.linalg.inv(poses[i]) @ poses[j])[:3, :3].T
                   + (np.linalg.inv(poses[i]) @ poses[j])[:3, 3] for i, j in edges])
    r = np.random.default_rng(seed)
    p1 = (p1 + noise * r.standard_normal(p1.shape)).astype(np.float32)
    p2 = (p2 + noise * r.standard_normal(p2.shape)).astype(np.float32)
    conf = np.full((E, H, W), 8.0, np.float32)
    return {"view1": {"idx": np.array([e[0] for e in edges])},
            "view2": {"idx": np.array([e[1] for e in edges])},
            "pred1": {"pts3d": p1, "conf": conf},
            "pred2": {"pts3d_in_other_view": p2, "conf": conf.copy()}}, poses


def _jax_out(out):
    return {k: ({kk: jnp.asarray(v) for kk, v in d.items()} if k.startswith("pred") else d)
            for k, d in out.items()}


def test_mst_init_matches_jax():
    """Noise-free scene: every initialised parameter agrees to 1e-4 (fp32
    registrations and SVDs in two libraries); the PnP fallback is reached."""
    out, _ = _output()
    jcfg, jdata, jparams = js.build_scene(_jax_out(out), SCENE_KW)
    ref = jinit.mst_init(jparams, jdata, jcfg, out["pred1"]["conf"], out["pred2"]["conf"])
    tcfg, tdata, tparams = ts.build_scene(out, SCENE_KW)
    calls = []
    orig = tinit.fast_pnp

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    tinit.fast_pnp = spy
    try:
        got = tinit.mst_init(tparams, tdata, tcfg, out["pred1"]["conf"], out["pred2"]["conf"])
    finally:
        tinit.fast_pnp = orig
    assert calls, "the synthetic scene should exercise the PnP fallback"
    for k in ("pw_poses", "im_poses", "im_focals", "im_depthmaps"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-4,
                                   atol=1e-4, err_msg=k)


def test_estimate_focal_weiszfeld_matches_jax():
    _, _, cams = _synth(1)
    assert tinit.estimate_focal_weiszfeld(cams[0]) == pytest.approx(
        jinit.estimate_focal_weiszfeld(cams[0]), rel=1e-5)


@pytest.mark.parametrize("sweep", [False, True])
def test_fast_pnp_matches_cv2(sweep):
    """Noise-free points on a 96x64 view: the numpy RANSAC-PnP recovers the
    same cam2world pose as cv2.solvePnPRansac(SQPNP) to 1e-4. With the sweep
    both try np.geomspace(max/2, 3 max, 21) (the true focal is on that grid)
    and must pick the same focal and agree on the pose to 2e-2."""
    h, w = 64, 96
    f_true = float(np.geomspace(w / 2, w * 3, 21)[10])
    u, v = np.meshgrid(np.arange(w), np.arange(h))
    depth = 2.0 + 0.6 * np.sin(u / 9.0) * np.cos(v / 7.0)
    cam = np.stack([depth * (u - w / 2) / f_true, depth * (v - h / 2) / f_true, depth], -1)
    _, poses, _ = _synth(3)
    world = (cam @ poses[2][:3, :3].T + poses[2][:3, 3]).astype(np.float32)
    msk = np.ones((h, w), bool)
    f_in = None if sweep else f_true
    got = tinit.fast_pnp(world, f_in, msk)
    ref = jinit.fast_pnp(world, f_in, msk)
    assert got is not None and ref is not None
    assert got[0] == pytest.approx(ref[0], rel=1e-6)
    if sweep:
        # the first focal of the sweep whose pose puts every point inside
        # the 5 px threshold wins, for both solvers; both then minimise the
        # reprojection error at that (wrong) focal, where no pose is exact and
        # the two refinements stop at slightly different points
        np.testing.assert_allclose(got[1], ref[1], atol=2e-2)
    else:
        np.testing.assert_allclose(got[1], ref[1], atol=1e-4)
        np.testing.assert_allclose(got[1], poses[2], atol=1e-4)
    assert cv2.__version__   # the oracle is OpenCV's solver


def _degenerate_output():
    """Two 288x512 views whose pointmaps are noise about 3e-4 from the
    camera, as random network weights give. Weiszfeld's focal for view 1 sits
    at the 1e-4 clamp, where every point projects to the principal point
    whatever the pose. Edge (0, 1) is the MST's root, so mst_init poses view 1
    by PnP on the seeded cloud `c1`, whose inliers' DLT puts the camera 1.4e5
    away (1e27 on a random ViT-L run of the demo: an inf loss)."""
    h, w = 288, 512
    cloud = lambda seed: (np.random.default_rng(seed).standard_normal((h, w, 3))
                          * [1.6e-4, 1.8e-4, 1.1e-4]
                          + [-1.9e-4, -1.8e-4, -3.0e-4]).astype(np.float32)
    c0, c1 = cloud(4), cloud(3)
    conf = np.stack([np.full((h, w), 3.0), np.full((h, w), 1.5)]).astype(np.float32)
    return {"view1": {"idx": np.array([0, 1])}, "view2": {"idx": np.array([1, 0])},
            "pred1": {"pts3d": np.stack([c0, c1]), "conf": conf},
            "pred2": {"pts3d_in_other_view": np.stack([c1, c0]), "conf": conf}}


def _degenerate_solve(out, niter=10):
    """The port's mst_init and a short solve on `out`: (im_poses, losses)."""
    cfg, data, params = ts.build_scene(out, SCENE_KW)
    params = tinit.mst_init(params, data, cfg, out["pred1"]["conf"], out["pred2"]["conf"])
    poses = ts.get_im_poses(params).numpy()
    _, losses = ts.global_alignment_loop(params, ts.default_masks(cfg, params), data, cfg,
                                         lr=0.05, niter=niter, schedule="cosine")
    return poses, np.asarray(losses)


def test_fast_pnp_stays_bounded_at_a_degenerate_focal():
    """On the degenerate-focal scene (_degenerate_output) the port keeps a
    camera as near the points as JAX's cv2.solvePnPRansac (SQPNP) does:
    within 10x of the larger of cv2's translation and the points' extent
    (the inliers' DLT alone gives 1.4e5, 1e8x the extent), and the solve's
    loss curve stays finite. JAX's poses on the same input are finite."""
    out = _degenerate_output()
    assert tinit.estimate_focal_weiszfeld(out["pred1"]["pts3d"][1]) == pytest.approx(1e-4)
    jcfg, jdata, jparams = js.build_scene(_jax_out(out), SCENE_KW)
    jparams = jinit.mst_init(jparams, jdata, jcfg, out["pred1"]["conf"], out["pred2"]["conf"])
    ref = np.asarray(js.get_im_poses(jparams))
    got, losses = _degenerate_solve(out)
    assert np.isfinite(ref).all()
    extent = max(np.abs(ref[:, :3, 3]).max(), np.abs(out["pred1"]["pts3d"]).max())
    assert np.isfinite(got).all() and np.abs(got[:, :3, 3]).max() <= 10 * extent
    assert losses.shape == (10,) and np.isfinite(losses).all()


def test_fast_pnp_gives_no_pose_without_a_bounded_one(monkeypatch):
    """When neither the inliers' refit nor the RANSAC hypothesis has a
    bounded translation, fast_pnp gives no pose at that focal (None here,
    one focal), and mst_init keeps view 1 at the identity pose: the solve
    stays finite."""
    refine = tinit._refine_pose
    monkeypatch.setattr(tinit, "_refine_pose",
                        lambda *a, **k: (lambda R, t: (R, t + 1e30))(*refine(*a, **k)))
    out = _degenerate_output()
    msk = np.ones(out["pred1"]["pts3d"].shape[1:3], bool)
    assert tinit.fast_pnp(out["pred1"]["pts3d"][1], 1e-4, msk) is None
    poses, losses = _degenerate_solve(out)
    np.testing.assert_array_equal(poses[1], np.eye(4, dtype=np.float32))
    assert np.isfinite(losses).all()


def test_adam_update_matches_optax():
    r = np.random.default_rng(3)
    params = {"a": r.standard_normal((4, 3)).astype(np.float32),
              "b": r.standard_normal(5).astype(np.float32)}
    opt = optax.scale_by_adam(b1=0.9, b2=0.9)
    jstate = opt.init(jax.tree.map(jnp.asarray, params))
    tstate = ts.adam_init({k: torch.from_numpy(v) for k, v in params.items()})
    for step in range(5):
        g = {k: r.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
        ju, jstate = opt.update(jax.tree.map(jnp.asarray, g), jstate)
        tu, tstate = ts.adam_update({k: torch.from_numpy(v) for k, v in g.items()}, tstate)
        for k in params:
            np.testing.assert_allclose(tu[k].numpy(), np.asarray(ju[k]), rtol=1e-6,
                                       atol=1e-7)


def test_fp32_pairwise_loss_and_grads_match():
    """The plain fp32 pairwise term (fast_solve off) and its gradients.
    Tolerance: the loss to 1e-5; gradients to 1e-3 of their largest value
    (each sums hundreds of per-pixel terms that nearly cancel)."""
    out, _ = _output(noise=0.02)
    jcfg, jdata, jparams = js.build_scene(_jax_out(out), SCENE_KW)
    jparams = jinit.mst_init(jparams, jdata, jcfg, out["pred1"]["conf"], out["pred2"]["conf"])
    tcfg, tdata, _ = ts.build_scene(out, SCENE_KW)
    lj, gj = jax.value_and_grad(jflow)(jparams, jdata, jcfg)
    leaves = {k: torch.from_numpy(np.array(v)).requires_grad_(True)
              for k, v in jparams.items()}
    lt = tflow(leaves, tdata, tcfg)
    lt.backward()
    assert lt.item() == pytest.approx(float(lj), rel=1e-5)
    for k in ("pw_poses", "im_poses", "im_focals", "im_depthmaps"):
        g = np.asarray(gj[k])
        assert np.abs(leaves[k].grad.numpy() - g).max() <= 1e-3 * np.abs(g).max(), k


def test_mixed_precision_solve_matches_jax():
    """300 iterations, linear schedule, flow variant with temporal
    smoothing, from the identical (JAX mst_init) init. Tolerances: the loss
    curve to 1e-2 relative to its largest value, final poses, focals and
    depths to 2e-2 relative — both sides quantise the same observations to
    bf16 identically and compute in fp32, but sum in other orders, and 300
    Adam steps amplify those last-digit differences."""
    out, _ = _output(noise=0.02)
    jcfg, jdata, jparams = js.build_scene(_jax_out(out), dict(SCENE_KW, fast_impl="fused"))
    jparams = jinit.mst_init(jparams, jdata, jcfg, out["pred1"]["conf"], out["pred2"]["conf"])
    masks = js.default_masks(jcfg, jparams)
    pj, lj = js.global_alignment_loop(jparams, masks, jdata, jcfg, lr=0.01, niter=300,
                                      schedule="linear", loss_fn=jflow)
    tcfg, tdata, _ = ts.build_scene(out, SCENE_KW)
    tp0 = {k: torch.from_numpy(np.array(v)) for k, v in jparams.items()}
    pt, lt = ts.global_alignment_loop(tp0, ts.default_masks(tcfg, tp0), tdata, tcfg,
                                      lr=0.01, niter=300, schedule="linear",
                                      loss_fn=tflow)
    lj, lt = np.asarray(lj), lt.numpy()
    assert lt.shape == (300,) and np.isfinite(lt).all()
    assert np.abs(lt - lj).max() <= 1e-2 * np.abs(lj).max()
    assert lt[-1] < lt[0]
    jpose = np.asarray(js.get_im_poses(pj))
    tpose = ts.get_im_poses(pt).numpy()
    assert np.abs(tpose - jpose).max() <= 2e-2 * np.abs(jpose).max()
    jf, tf = np.asarray(js.get_focals(pj, jcfg)), ts.get_focals(pt, tcfg).numpy()
    np.testing.assert_allclose(tf, jf, rtol=2e-2)
    jd = np.asarray(js.get_depthmaps_raw(pj, jdata, jcfg))
    td = ts.get_depthmaps_raw(pt, tdata, tcfg).numpy()
    assert np.abs(td - jd).max() <= 2e-2 * np.abs(jd).max()
    # frozen principal points stayed exactly frozen
    np.testing.assert_array_equal(pt["im_pp"].numpy(), tp0["im_pp"].numpy())


def test_precision_modes_and_step_offset():
    """'fp32' runs the plain path, 'bf16' the packed path throughout, and
    an unknown mode is refused; every mode reduces the loss."""
    out, _ = _output(noise=0.02)
    cfg, data, params = ts.build_scene(out, SCENE_KW)
    params = tinit.mst_init(params, data, cfg, out["pred1"]["conf"], out["pred2"]["conf"])
    masks = ts.default_masks(cfg, params)
    for precision in ("fp32", "bf16"):
        _, losses = ts.global_alignment_loop(params, masks, data, cfg, niter=20,
                                             loss_fn=tflow, precision=precision)
        assert losses[-1] < losses[0]
    with pytest.raises(ValueError):
        ts.global_alignment_loop(params, masks, data, cfg, niter=2, precision="fp16")
    seen = []
    ts.solve(params, masks, data, np.full(3, 0.01, np.float32), cfg,
             loss_fn=lambda p, d, c, i: (seen.append(i), ts.pairwise_pts_loss(p, d, c))[1],
             step0=7)
    assert seen == [7, 8, 9]

