"""Whole-slice parity with the real PnP on both sides: the JAX package's
mst_init and motion masks with cv2.solvePnPRansac(SQPNP), the port's with
one batched `ransac_pnp` call each, on the noisy synthetic scenes of
test_torch_scene.py (point noise 0.01, 0.2 px at focal 40) and
test_torch_flow.py (the symmetrised complete graph of 4 frames).

- mst_init: every initialised parameter to 1e-4 (rtol and atol), with the
  PnP fallback reached on both sides and one ransac_pnp call on the port's.
- mst_init on graphs that are not symmetrised (a noncyclic window, a star):
  the frames that are no edge's first view have no focal, and PnP sweeps
  21 focals for them on both sides; every parameter to 1e-4, the swept
  frames on a share of the seeds at 16x24 (see the test).
- PairViewer on every symmetric pair: poses to 1e-4; the motion masks equal
  on all but 0.1% of the pixels, from one ransac_pnp call for all the pairs.
"""
import numpy as np
import pytest
import torch

from align3r_tpu.alignment import init_poses as jinit
from align3r_tpu.alignment import pair_viewer as jpv
from align3r_tpu.alignment import scene as js
from align3r_tpu_torch.alignment import init_poses as tinit
from align3r_tpu_torch.alignment import pair_viewer as tpv
from align3r_tpu_torch.alignment import scene as ts
from align3r_tpu_torch.inference.pairs import make_pairs

from pnp_views import graph_output
from test_torch_flow import _pair_output
from test_torch_scene import SCENE_KW, _jax_out, _output

torch.set_num_threads(2)


def _spy(monkeypatch, mod, name, calls):
    orig = getattr(mod, name)

    def spy(*a, **k):
        calls.append(len(a[0]))
        return orig(*a, **k)

    monkeypatch.setattr(mod, name, spy)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mst_init_with_pnp_matches_jax(monkeypatch, seed):
    out, _ = _output(noise=0.01, seed=seed)
    jcalls, tcalls = [], []
    _spy(monkeypatch, jinit, "fast_pnp", jcalls)
    _spy(monkeypatch, tinit, "ransac_pnp", tcalls)
    jcfg, jdata, jparams = js.build_scene(_jax_out(out), SCENE_KW)
    ref = jinit.mst_init(jparams, jdata, jcfg, out["pred1"]["conf"], out["pred2"]["conf"])
    tcfg, tdata, tparams = ts.build_scene(out, SCENE_KW)
    got = tinit.mst_init(tparams, tdata, tcfg, out["pred1"]["conf"], out["pred2"]["conf"])
    assert jcalls and tcalls == [len(jcalls)], (jcalls, tcalls)
    for k in ("pw_poses", "im_poses", "im_focals", "im_depthmaps"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-4,
                                   atol=1e-4, err_msg=k)


@pytest.mark.parametrize("graph", ["swin-2-noncyclic", "oneref-0"])
@pytest.mark.parametrize("hw", [(16, 24), (48, 64)])
def test_mst_init_without_symmetrize_matches_jax(monkeypatch, graph, hw):
    """Per-frame focals (shared_focal off), seeds 0-2. pw_poses, and every
    frame PnP poses at its own focal, to 1e-4 on every seed. The swept
    frames to 1e-4 on at least one seed at 16x24 and on every seed at
    48x64: on 16x24 views every focal within about 35% of the true one makes
    every point an inlier, so the first focal with the most inliers turns on
    a point or two, and the port's 5-point EPnP (pnp.py's docstring) counts
    otherwise there now and then; a swept frame then takes a neighbouring
    focal (2 of swin-2's 3 swept frames, 3 of oneref's 9). At 48x64 the
    5 px tolerance tells the sweep's focals apart (none of 12 differ). The
    true focal is on the sweep's grid."""
    h, w = hw
    edges = make_pairs(4, graph, symmetrize=False)
    swept = sorted(set(range(4)) - {i for i, _ in edges})
    kw = dict(SCENE_KW, shared_focal=False)
    agree = 0
    for seed in range(3):
        out, _ = graph_output(edges, 4, h=h, w=w, f=float(tinit._focal_sweep(w, h)[10]),
                              seed=seed)
        jfocals, tcalls = [], []
        jpnp = jinit.fast_pnp
        monkeypatch.setattr(jinit, "fast_pnp",
                            lambda *a, **k: jfocals.append(a[1]) or jpnp(*a, **k))
        _spy(monkeypatch, tinit, "ransac_pnp", tcalls)
        jcfg, jdata, jparams = js.build_scene(_jax_out(out), kw)
        ref = jinit.mst_init(jparams, jdata, jcfg, out["pred1"]["conf"], out["pred2"]["conf"])
        tcfg, tdata, tparams = ts.build_scene(out, kw)
        got = tinit.mst_init(tparams, tdata, tcfg, out["pred1"]["conf"], out["pred2"]["conf"])
        monkeypatch.undo()
        assert jfocals.count(None) == len(swept) and tcalls == [len(jfocals)], (jfocals, tcalls)
        np.testing.assert_allclose(got["pw_poses"].numpy(), np.asarray(ref["pw_poses"]),
                                   rtol=1e-4, atol=1e-4)
        close = {k: np.isclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-4, atol=1e-4
                               ).reshape(4, -1).all(1)
                 for k in ("im_poses", "im_focals", "im_depthmaps")}
        for k, c in close.items():
            assert all(c[i] for i in range(4) if i not in swept), (k, seed, c)
        agree += all(c.all() for c in close.values())
    assert agree >= (1 if hw == (16, 24) else 3), agree


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_motion_masks_with_pnp_match_jax(monkeypatch, seed):
    out = _pair_output(seed=seed)
    E = len(out["view1"]["idx"])
    half = E // 2
    p1, p2 = out["pred1"]["pts3d"], out["pred2"]["pts3d_in_other_view"]
    c1, c2 = out["pred1"]["conf"], out["pred2"]["conf"]
    for e in range(half):
        args = ({(0, 1): p1[e], (1, 0): p1[e + half]}, {(0, 1): p2[e], (1, 0): p2[e + half]},
                {(0, 1): c1[e], (1, 0): c1[e + half]}, {(0, 1): c2[e], (1, 0): c2[e + half]})
        ref = jpv.pair_viewer(*args, min_conf_thr=3.0)
        got = tpv.pair_viewer(*args, min_conf_thr=3.0)
        np.testing.assert_allclose(got["poses"], ref["poses"], atol=1e-4, err_msg=str(e))

    H, W = p1.shape[1:3]
    r = np.random.default_rng(5)
    flow_ij = r.uniform(-0.5, 0.5, (E, H, W, 2)).astype(np.float32)
    flow_ji = r.uniform(-0.5, 0.5, (E, H, W, 2)).astype(np.float32)
    flow_ij[:, 4:9, 6:12] += 6.0
    calls = []
    _spy(monkeypatch, tpv, "ransac_pnp", calls)
    ref = jpv.motion_masks_from_pairs(_jax_out(out), flow_ij, flow_ji, min_conf_thr=3.0)
    got = tpv.motion_masks_from_pairs(out, torch.from_numpy(flow_ij), torch.from_numpy(flow_ji),
                                      min_conf_thr=3.0)
    assert calls == [E], calls
    assert got.shape == ref.shape and got.dtype == bool
    assert (got != ref).mean() <= 1e-3
