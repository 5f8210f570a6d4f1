"""Port parity for the flow terms of the solve: geometry/warping.py,
alignment/flow.py (flow_forward with the ego-flow term and the depth
regulariser) and alignment/pair_viewer.py (PairViewer and the
self-supervised motion masks) against the JAX package on the CPU, fp32.

Inputs are numpy-seeded; scenes are the synthetic, geometrically consistent
ones of test_torch_scene.py. RANSAC-PnP differs between the packages (cv2 in
JAX, numpy in the port), so the PairViewer tests replace it on both sides
with the same deterministic function. Tolerances are stated per test.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from align3r_tpu.alignment import flow as jflow
from align3r_tpu.alignment import init_poses as jinit
from align3r_tpu.alignment import pair_viewer as jpv
from align3r_tpu.alignment import scene as js
from align3r_tpu.geometry import warping as jw
from align3r_tpu.inference.pairs import make_pairs
from align3r_tpu_torch.alignment import flow as tflow
from align3r_tpu_torch.alignment import pair_viewer as tpv
from align3r_tpu_torch.alignment import scene as ts
from align3r_tpu_torch.geometry import warping as tw

from test_torch_scene import FOCAL, H, SCENE_KW, W, _jax_out, _output, _synth

torch.set_num_threads(2)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _rotations(r, B, angle=0.1):
    """Rotations about random axes by up to `angle` rad (Rodrigues)."""
    out = []
    for _ in range(B):
        k = r.standard_normal(3)
        k /= np.linalg.norm(k)
        th = r.uniform(-angle, angle)
        Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        out.append(np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx)
    return np.stack(out).astype(np.float32)


# ----------------------------------------------------------------- warping

def test_sampling_and_occlusion_match_jax():
    """bilinear_sample, warp_image and occ_mask, with sample points partly
    outside the image: values to 1e-6 of the largest, masks equal."""
    r = np.random.default_rng(0)
    img = r.standard_normal((2, 7, 9, 3)).astype(np.float32)
    x = r.uniform(-2, 10, (2, 5, 6)).astype(np.float32)
    y = r.uniform(-2, 8, (2, 5, 6)).astype(np.float32)
    assert _rel(tw.bilinear_sample(*_t(img, x, y)).numpy(),
                jw.bilinear_sample(*map(jnp.asarray, (img, x, y)))) <= 1e-6
    f12 = r.uniform(-2, 2, (2, 7, 9, 2)).astype(np.float32)
    f21 = (-f12 + r.uniform(-3, 3, f12.shape)).astype(np.float32)
    assert _rel(tw.warp_image(*_t(img, f12)).numpy(),
                jw.warp_image(jnp.asarray(img), jnp.asarray(f12))) <= 1e-6
    got = tw.occ_mask(*_t(f12, f21)).numpy()
    ref = np.asarray(jw.occ_mask(jnp.asarray(f12), jnp.asarray(f21)))
    np.testing.assert_array_equal(got, ref)
    assert 0 < got.mean() < 1


def test_ego_flow_geometry_matches_jax():
    """warp_by_disp, unproject_depth_RT, get_relative_transform and
    inv_intrinsics at 1e-6 of the largest value."""
    r = np.random.default_rng(1)
    B, Hh, Ww = 3, 12, 16
    sR, tR = _rotations(r, B), _rotations(r, B)
    st, tt = (r.uniform(-0.2, 0.2, (B, 3, 1)).astype(np.float32) for _ in range(2))
    f = r.uniform(15, 25, B).astype(np.float32)
    K = np.zeros((B, 3, 3), np.float32)
    K[:, 0, 0], K[:, 1, 1], K[:, 2, 2] = f, f, 1
    K[:, 0, 2], K[:, 1, 2] = Ww / 2, Hh / 2
    invK = np.asarray(jflow.inv_intrinsics(jnp.asarray(K)))
    assert _rel(tflow.inv_intrinsics(torch.from_numpy(K)).numpy(), invK) <= 1e-6
    disp = r.uniform(0.3, 0.6, (B, Hh, Ww)).astype(np.float32)
    args = (sR, st, tR, tt, K, invK, disp)
    ref = jw.warp_by_disp(*map(jnp.asarray, args))
    got = tw.warp_by_disp(*_t(*args))
    assert tuple(got.shape) == (B, Hh, Ww, 3) and _rel(got.numpy(), ref) <= 1e-6
    ref = jw.unproject_depth_RT(*map(jnp.asarray, (1 / disp, invK, sR, st)))
    assert _rel(tw.unproject_depth_RT(*_t(1 / disp, invK, sR, st)).numpy(), ref) <= 1e-6
    for a, b in zip(tw.get_relative_transform(*_t(sR, st, tR, tt)),
                    jw.get_relative_transform(*map(jnp.asarray, (sR, st, tR, tt)))):
        assert _rel(a.numpy(), b) <= 1e-6


@pytest.mark.parametrize("thre", [50.0, 0.0, 2.0])
def test_smooth_l1_flow_loss_matches_jax(thre):
    """Both branches of the smooth L1, the per-pixel gate on, off, and
    cutting a share of the pixels: to 1e-6."""
    r = np.random.default_rng(2)
    est = r.standard_normal((3, 8, 10, 2)).astype(np.float32) * 3
    gt = r.standard_normal((3, 8, 10, 2)).astype(np.float32)
    mask = (r.uniform(size=(3, 8, 10)) > 0.3).astype(np.float32)
    ref = float(jw.smooth_l1_flow_loss(*map(jnp.asarray, (est, gt, mask)), per_pixel_thre=thre))
    got = tw.smooth_l1_flow_loss(*_t(est, gt, mask), per_pixel_thre=thre).item()
    assert got == pytest.approx(ref, rel=1e-6)


@pytest.mark.parametrize("weighted, normalize", [(False, False), (True, False), (True, True)])
def test_depth_regularization_matches_jax(weighted, normalize):
    r = np.random.default_rng(3)
    pred = r.uniform(0.5, 3, (2, 8, 10)).astype(np.float32)
    init = (pred * r.uniform(0.8, 1.2, pred.shape)).astype(np.float32)
    wgt = (r.uniform(size=pred.shape) > 0.5).astype(np.float32) if weighted else None
    ref = float(jw.depth_regularization_si_weighted(
        jnp.asarray(pred), jnp.asarray(init),
        pixel_wise_weight=None if wgt is None else jnp.asarray(wgt),
        pixel_weight_normalize=normalize))
    got = tw.depth_regularization_si_weighted(
        *_t(pred, init), pixel_wise_weight=None if wgt is None else torch.from_numpy(wgt),
        pixel_weight_normalize=normalize).item()
    assert got == pytest.approx(ref, rel=1e-6)


# ------------------------------------------------------------- flow_forward

def _flow_scene(thre):
    out, _ = _output(noise=0.02)
    kw = dict(SCENE_KW, flow_loss_weight=0.01, flow_loss_start_epoch=0.15,
              flow_loss_thre=thre, depth_regularize_weight=0.05, num_total_iter=100)
    jcfg, jdata, jparams = js.build_scene(_jax_out(out), kw)
    jparams = jinit.mst_init(jparams, jdata, jcfg, out["pred1"]["conf"], out["pred2"]["conf"])
    tcfg, tdata, _ = ts.build_scene(out, kw)
    r = np.random.default_rng(4)
    E = len(out["view1"]["idx"])
    extra = {"flow_ij": r.standard_normal((E, H, W, 2)).astype(np.float32),
             "flow_ji": r.standard_normal((E, H, W, 2)).astype(np.float32),
             "dynamic_masks": (r.uniform(size=(4, H, W)) > 0.7).astype(np.float32),
             "init_depth": (np.asarray(js.get_depthmaps_raw(jparams, jdata, jcfg))
                            * r.uniform(0.9, 1.1, (4, H * W))).astype(np.float32)}
    jdata = dataclasses.replace(jdata, **{k: jnp.asarray(v) for k, v in extra.items()})
    tdata = dataclasses.replace(tdata, **{k: torch.from_numpy(v) for k, v in extra.items()})
    return jcfg, jdata, jparams, tcfg, tdata


@pytest.mark.parametrize("step, thre", [(3, 1e6), (50, 1e6), (50, 1e-6)])
def test_flow_forward_loss_and_grads_match_jax(step, thre):
    """flow_forward with RAFT-like flows, dynamic masks and the depth
    regulariser, before the start epoch (step 3 < 15), after it with the
    threshold gate open (1e6) and with it shut (1e-6). The loss to 1e-5;
    gradients to 1e-3 of their largest value (per-pixel terms that nearly
    cancel, summed in another order)."""
    jcfg, jdata, jparams, tcfg, tdata = _flow_scene(thre)
    lj, gj = jax.value_and_grad(jflow.flow_forward)(jparams, jdata, jcfg, step)
    leaves = {k: torch.from_numpy(np.array(v)).requires_grad_(True) for k, v in jparams.items()}
    lt = tflow.flow_forward(leaves, tdata, tcfg, step)
    lt.backward()
    assert lt.item() == pytest.approx(float(lj), rel=1e-5)
    for k in ("pw_poses", "im_poses", "im_focals", "im_depthmaps"):
        g = np.asarray(gj[k])
        assert np.abs(leaves[k].grad.numpy() - g).max() <= 1e-3 * np.abs(g).max(), k
    # the flow term is what the gates switch
    fl = tflow.flow_term({k: v.detach() for k, v in leaves.items()}, tdata, tcfg).item()
    assert fl > 1e-3
    base = dataclasses.replace(tcfg, flow_loss_weight=0.0)
    lb = tflow.flow_forward({k: v.detach() for k, v in leaves.items()}, tdata, base, step)
    on = step >= 15 and thre > fl
    assert lt.item() - lb.item() == pytest.approx(0.01 * fl if on else 0.0, abs=1e-5)


# ---------------------------------------------------- pair viewer and masks

def _pair_output(n=4, seed=0):
    """Symmetrised complete graph ([forward..., reversed...]) over a
    consistent synthetic scene, with noisy pointmaps and confidences."""
    depths, poses, cams = _synth(n)
    pairs = make_pairs(n, "complete", symmetrize=True)
    r = np.random.default_rng(seed)
    p1 = np.stack([cams[i] for i, _ in pairs])
    rel = [np.linalg.inv(poses[i]) @ poses[j] for i, j in pairs]
    p2 = np.stack([cams[j] @ T[:3, :3].T + T[:3, 3] for (i, j), T in zip(pairs, rel)])
    noisy = lambda p: (p + 0.01 * r.standard_normal(p.shape)).astype(np.float32)
    conf = lambda: (2 + 4 * r.uniform(size=(len(pairs), H, W))).astype(np.float32)
    return {"view1": {"idx": np.array([p[0] for p in pairs])},
            "view2": {"idx": np.array([p[1] for p in pairs])},
            "pred1": {"pts3d": noisy(p1), "conf": conf()},
            "pred2": {"pts3d_in_other_view": noisy(p2), "conf": conf()}}


def _pnp(pts3d, focal, msk, pp=None, niter_PnP=10):
    """A deterministic stand-in for RANSAC-PnP, the same on both sides: a
    pose that depends on the masked points' mean."""
    m = float(np.asarray(pts3d, np.float64)[np.asarray(msk)].mean())
    th = 0.05 * m
    T = np.eye(4)
    T[:3, :3] = [[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]]
    T[:3, 3] = [0.1 * m, -0.02, 0.03]
    return float(focal), T


def test_pair_viewer_and_motion_masks_match_jax(monkeypatch):
    """PairViewer's poses, focals and depths to 1e-5 of the largest value
    (Weiszfeld focals in fp32 in two libraries); the motion masks equal on
    all but 0.1% of the pixels (a pixel flips where its mean error lies
    within fp32 rounding of the 0.35 threshold)."""
    monkeypatch.setattr(jpv, "fast_pnp", _pnp)
    monkeypatch.setattr(tpv, "fast_pnp", _pnp)
    out = _pair_output()
    E = len(out["view1"]["idx"])
    half = E // 2
    p1, p2 = out["pred1"]["pts3d"], out["pred2"]["pts3d_in_other_view"]
    c1, c2 = out["pred1"]["conf"], out["pred2"]["conf"]
    args = ({(0, 1): p1[0], (1, 0): p1[half]}, {(0, 1): p2[0], (1, 0): p2[half]},
            {(0, 1): c1[0], (1, 0): c1[half]}, {(0, 1): c2[0], (1, 0): c2[half]})
    ref, got = jpv.pair_viewer(*args, min_conf_thr=3.0), tpv.pair_viewer(*args, min_conf_thr=3.0)
    for k in ("poses", "focals", "pp", "depths"):
        assert got[k].shape == ref[k].shape and _rel(got[k], ref[k]) <= 1e-5, k

    # flows: the ego-motion flow of the true geometry, plus a moving patch
    r = np.random.default_rng(5)
    flow_ij = r.uniform(-0.5, 0.5, (E, H, W, 2)).astype(np.float32)
    flow_ji = r.uniform(-0.5, 0.5, (E, H, W, 2)).astype(np.float32)
    flow_ij[:, 4:9, 6:12] += 6.0
    ref = jpv.motion_masks_from_pairs(_jax_out(out), flow_ij, flow_ji, min_conf_thr=3.0)
    got = tpv.motion_masks_from_pairs(out, torch.from_numpy(flow_ij),
                                      torch.from_numpy(flow_ji), min_conf_thr=3.0)
    assert got.shape == ref.shape == (4, H, W) and got.dtype == bool
    assert (got != ref).mean() <= 1e-3
    assert 0.01 < got.mean() < 0.99
    with pytest.raises(ValueError, match="symmetrised"):
        tpv.motion_masks_from_pairs({k: ({kk: v[:-1] for kk, v in d.items()})
                                     for k, d in out.items()},
                                    flow_ij[:-1], flow_ji[:-1])
