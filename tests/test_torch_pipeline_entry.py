"""Port parity for the serving entry around the engine: the depth variant of
reconstruct_scene (variant="prior", with and without mono_depths), the
hierarchical long-video solve and SceneResult.mask_sky, against
align3r_tpu.pipeline.

The network is replaced on both sides by one geometrically consistent
scene (smooth depths, small camera motion, the pointmaps every edge's two
views would predict, 0.5% noise; test_torch_scene._synth), so the solve has
one answer. Random network weights give pointmaps without consistent
geometry: there the prior variant's rotations are set by rounding noise (on
TINY_TEST weights with mono depths, the two packages' initial parameters
agree to 6e-6 and their gradients to 3e-6 of the largest value, but the
quaternions' gradients are rounding noise about zero, and Adam takes full
steps of either sign along them), as the flow path's note in
test_torch_pipeline.py says. The engine itself is held to JAX's in
test_torch_pipeline.py::test_reconstruct_scene_matches_jax. PnP is switched
off on both sides, as there. The JAX side runs its fused Pallas solve in
interpret mode. Tolerances are test_reconstruct_scene_matches_jax's: the
loss curve to 1e-2 of its range, poses, focals and depths to 2e-2 of the
largest value.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from align3r_tpu import pipeline as jpipe
from align3r_tpu.alignment import init_poses as jinit
from align3r_tpu.alignment import scene as js
from align3r_tpu_torch import pipeline as tpipe
from align3r_tpu_torch.alignment import init_poses as tinit
from align3r_tpu_torch.alignment import scene as ts

from test_torch_scene import H, W, _synth

torch.set_num_threads(2)
N = 5
SCENE_KW = dict(shared_focal=True, temporal_smoothing_weight=0.01,
                translation_weight=1.0, min_conf_thr=1.1)
CPU_MODEL = types.SimpleNamespace(device=torch.device("cpu"))   # where the port's scene lives


def _frames():
    """Frames whose pixel (0, 0) names the frame, so that the stand-in
    network knows which views a call holds."""
    imgs = np.zeros((N, H, W, 3), np.float32)
    imgs[:, 0, 0, 0] = np.arange(N) / 10
    return imgs, np.zeros((N, H, W, 3), np.float32)


def _network(pairs, imgs):
    """The scene's pointmaps for each pair of the call's frames: view i's
    points in camera i, view j's points in camera i, with 0.5% noise
    seeded by the pair."""
    depths, poses, cams = _synth(N)
    g = [int(round(v * 10)) for v in np.asarray(imgs)[:, 0, 0, 0]]
    p1, p2, c1, c2 = [], [], [], []
    for i, j in pairs:
        a, b = g[i], g[j]
        rel = np.linalg.inv(poses[a]) @ poses[b]
        r = np.random.default_rng(100 * a + b)
        p1.append(cams[a] * (1 + 0.005 * r.standard_normal(cams[a].shape)))
        p2.append((cams[b] @ rel[:3, :3].T + rel[:3, 3])
                  * (1 + 0.005 * r.standard_normal(cams[b].shape)))
        c1.append(1.5 + r.uniform(0, 4, (H, W)))
        c2.append(1.5 + r.uniform(0, 4, (H, W)))
    f = lambda x: np.stack(x).astype(np.float32)
    return {"view1": {"idx": np.array([p[0] for p in pairs], np.int32)},
            "view2": {"idx": np.array([p[1] for p in pairs], np.int32)},
            "pred1": {"pts3d": f(p1), "conf": f(c1)},
            "pred2": {"pts3d_in_other_view": f(p2), "conf": f(c2)}}


@pytest.fixture
def network(monkeypatch):
    def jax_net(pairs, params, cfg, imgs, priors, **kw):
        out = _network(pairs, imgs)
        for k in ("pred1", "pred2"):
            out[k] = {kk: jnp.asarray(v) for kk, v in out[k].items()}
        return out

    def port_net(pairs, model, imgs, priors, **kw):
        out = _network(pairs, imgs)
        for k in ("pred1", "pred2"):
            out[k] = {kk: torch.from_numpy(v) for kk, v in out[k].items()}
        return out

    monkeypatch.setattr(jpipe, "inference", jax_net)
    monkeypatch.setattr(tpipe, "inference", port_net)
    for mod in (jinit, tinit):
        monkeypatch.setattr(mod, "fast_pnp", lambda *a, **k: None)


def _close(got, ref, names=("get_im_poses", "get_focals", "get_depthmaps", "get_intrinsics")):
    assert np.abs(got.losses - ref.losses).max() <= 1e-2 * np.abs(ref.losses).max()
    for name in names:
        x, y = getattr(got, name)(), getattr(ref, name)()
        assert x.shape == y.shape
        assert np.abs(x - y).max() <= 2e-2 * np.abs(y).max(), name


@pytest.mark.parametrize("mono", [False, True], ids=["no_mono", "mono"])
def test_prior_variant_matches_jax(network, mono):
    """The depth tool's path (tool/depth_test.py:204-216): complete graph,
    lr 0.05, cosine; with mono_depths, the solve's depths are the frozen mono
    depths (the true depths, 1% off) times per-pixel scales plus shifts."""
    imgs, priors = _frames()
    depths, _, _ = _synth(N)
    md = None
    if mono:
        r = np.random.default_rng(7)
        md = (depths * (1 + 0.01 * r.standard_normal(depths.shape))).reshape(N, -1)
        md = md.astype(np.float32)
    common = dict(scene_graph="complete", variant="prior", mono_depths=md, niter=60,
                  lr=0.05, schedule="cosine", conf_clamp=10.0)
    ref = jpipe.reconstruct_scene(imgs, priors, None, None,
                                  scene_kw=dict(SCENE_KW, fast_impl="fused"), **common)
    got = tpipe.reconstruct_scene(imgs, priors, CPU_MODEL, scene_kw=SCENE_KW, **common)
    assert got.cfg.if_use_mono == mono and ref.cfg.if_use_mono == mono
    assert set(got.params) == set(ref.params)
    _close(got, ref)
    if mono:   # the mono depths carried into the scene as given
        np.testing.assert_array_equal(got.data.mono_depths.numpy(), md)


def test_hierarchical_matches_jax(network):
    """5 frames, clip_size 2: a coarse solve over keyframes 0, 2, 4, then
    the clips (0, 1, 2), (2, 3, 4) and (4,), each anchored through
    init_priors to its keyframe's coarse pose, depth and focal."""
    imgs, priors = _frames()
    kw = dict(clip_size=2, coarse_niter=40, niter=40, variant="flow",
              schedule="linear")
    jres, jposes, jdepths = jpipe.reconstruct_scene_hierarchical(
        imgs, priors, None, None, scene_kw=dict(SCENE_KW, fast_impl="fused"), **kw)
    tres, tposes, tdepths = tpipe.reconstruct_scene_hierarchical(
        imgs, priors, CPU_MODEL, scene_kw=SCENE_KW, **kw)
    assert len(tres) == len(jres) == 2
    assert tposes.shape == (N, 4, 4) and tdepths.shape == (N, H, W)
    for got, ref in zip(tres, jres):
        _close(got, ref)
    assert np.abs(tposes - jposes).max() <= 2e-2 * np.abs(jposes).max()
    assert np.abs(tdepths - jdepths).max() <= 2e-2 * np.abs(jdepths).max()
    # every clip's first frame keeps its keyframe's coarse pose (masked)
    np.testing.assert_allclose(tres[1].get_im_poses()[0], tposes[2], atol=1e-6)


def test_mask_sky_matches_jax(network):
    """mask_sky zeroes the same pixels' confidence as JAX's, on the scene's
    device, and returns the new confidences; other pixels keep theirs."""
    imgs, _ = _frames()
    r = np.random.default_rng(3)
    imgs = np.clip(r.uniform(-1, 0.6, imgs.shape), -1, 1).astype(np.float32)
    imgs[:, : H // 3 + 1] = [0.7, 0.72, 0.76]            # bright, low saturation
    imgs[:2, :, : W // 2] = [0.9, -0.5, -0.5]             # saturated: not sky
    out = _network([(i, j) for i in range(N) for j in range(N) if i != j], _frames()[0])
    jcfg, jdata, jparams = js.build_scene(
        {k: ({kk: jnp.asarray(v) for kk, v in d.items()} if k.startswith("pred") else d)
         for k, d in out.items()}, SCENE_KW)
    tcfg, tdata, tparams = ts.build_scene(out, SCENE_KW)
    ref = jpipe.SceneResult(jcfg, jdata, jparams, np.zeros(1), imgs=imgs)
    got = tpipe.SceneResult(tcfg, tdata, tparams, np.zeros(1), imgs=imgs)
    before = got.get_conf()
    a, b = got.mask_sky(), ref.mask_sky()
    sky = b == 0
    assert 0 < sky.mean() < 1
    np.testing.assert_array_equal(a == 0, sky)
    np.testing.assert_allclose(a, b, rtol=1e-6)
    np.testing.assert_array_equal(got.get_conf(), a)
    assert got.data.im_conf.shape == tdata.im_conf.shape
    np.testing.assert_array_equal(a[~sky], before[~sky])
