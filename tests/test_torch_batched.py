"""Port parity: the batched multi-scene solve (align3r_tpu_torch.alignment.
batched) and K3/K4's scene axis against align3r_tpu and against the port's
own single-scene solves.

Scenes are tests/test_torch_scene.py's synthetic ones (geometrically
consistent, small camera motion) and tests/test_edge_loss.py's random ones,
made with numpy or JAX's PRNG on both sides alike. On the CPU, K3/K4 are
their plain versions; the blocked ones (the kernels' walk, with the scene
axis's segmented second pass) are swapped in where the test says so.
Tolerances:
- the scene-axis blocked K3/K4 under torch.func.vmap against JAX's
  jax.vmap of the fused loss (Pallas in interpret mode, the scene axis on
  the grid): values 1e-6 relative, gradients 1e-6 absolute (JAX
  test_fused_loss_vmaps_over_scenes);
- batched_alignment against S sequential port solves and against JAX's
  batched_alignment (fused kernel, interpret mode): losses rtol 2e-4, atol
  1e-5 (JAX test_batched_alignment_matches_sequential), at the solve's
  default lr 0.01 (test_torch_scene.py's): at lr 0.05 one scene's fp32 solve
  drifts from JAX's by 4e-4 by step 17, the two frameworks' sum orders
  amplified by Adam, while the port's batched and sequential solves stay
  equal;
- an image without terms in one scene: the scene-axis losses and gradients
  against each scene alone, 1e-6 relative (the same sums in the same order
  within a scene).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from align3r_tpu.alignment import batched as jb
from align3r_tpu.alignment import init_poses as jinit
from align3r_tpu.alignment import scene as js
from align3r_tpu.alignment.flow import flow_forward as jflow
from align3r_tpu.inference.pairs import make_pairs
from align3r_tpu_torch.alignment import batched as tb
from align3r_tpu_torch.alignment import scene as ts
from align3r_tpu_torch.alignment.flow import flow_forward as tflow
from align3r_tpu_torch.ops import edge_loss as el
from test_torch_scene import H, SCENE_KW, W, _jax_out, _output

torch.set_num_threads(2)


def _tiles(monkeypatch):
    """K3/K4 on the CPU as their blocked plain versions."""
    monkeypatch.setattr(el, "edge_loss_fwd", lambda proj, pw34, pred, w, idx, order,
                        offsets, scenes=None: el.edge_loss_fwd_tiles_plain(
                            proj, pw34, pred, w, idx, order, offsets, scenes))
    monkeypatch.setattr(el, "edge_loss_bwd", lambda g, proj, pw34, pred, w, idx, order,
                        offsets, scenes=None: el.edge_loss_bwd_tiles_plain(
                            g, proj, pw34, pred, w, idx, order, offsets, scenes))


def _random_scene(n, Hs, Ws, seed, graph="complete"):
    """tests/test_edge_loss.py's _synthetic_scene on both sides: JAX (cfg,
    data, params) and the port's (cfg, data, params) from the same arrays."""
    pairs = make_pairs(n, graph, symmetrize=True)
    E = len(pairs)
    ks = jax.random.split(jax.random.PRNGKey(seed), 4)
    out = {"view1": {"idx": np.array([p[0] for p in pairs])},
           "view2": {"idx": np.array([p[1] for p in pairs])},
           "pred1": {"pts3d": np.asarray(jax.random.normal(ks[0], (E, Hs, Ws, 3))),
                     "conf": np.asarray(1 + jax.random.uniform(ks[1], (E, Hs, Ws)))},
           "pred2": {"pts3d_in_other_view": np.asarray(jax.random.normal(ks[2], (E, Hs, Ws, 3))),
                     "conf": np.asarray(1 + jax.random.uniform(ks[3], (E, Hs, Ws)))}}
    jcfg, jdata, jparams = js.build_scene(_jax_out(out), {"fast_impl": "fused"})
    tcfg, tdata, _ = ts.build_scene(out)
    tparams = {k: torch.from_numpy(np.array(v)) for k, v in jparams.items()}
    return (jcfg, jdata, jparams), (tcfg, tdata, tparams)


@pytest.mark.parametrize("case", ["complete", "chunked"])
def test_scene_axis_tiles_match_jax_vmap(monkeypatch, case):
    """The fused pairwise term over 2 scenes: one vmapped call (K3/K4's
    scene-axis blocked plain versions) against JAX's jax.vmap of
    _pairwise_pts_loss_fused, values and gradients. "chunked": 300 images
    of 8 x 16 on a swin-1 graph, JAX's chunked kernel (test_edge_loss.py's
    test_fused_chunked_vmaps_over_scenes)."""
    _tiles(monkeypatch)
    kw = (dict(n=3, Hs=12, Ws=16) if case == "complete"
          else dict(n=300, Hs=8, Ws=16, graph="swin-1"))
    scenes = [_random_scene(seed=s, **kw) for s in (0, 1)]
    jpacked = [(c, js.pack_scene(d, c, dtype=jnp.float32), p) for (c, d, p), _ in scenes]
    jcfg = jpacked[0][0]
    jds = jb.stack_scenes([d for _, d, _ in jpacked])
    jps = jb.stack_params([p for _, _, p in jpacked])
    jv = jax.vmap(lambda p, d: js._pairwise_pts_loss_fused(p, d, jcfg))(jps, jds)
    jg = jax.vmap(lambda p, d: jax.grad(js._pairwise_pts_loss_fused)(p, d, jcfg))(jps, jds)

    tcfg = dataclasses.replace(scenes[0][1][0], fast_solve=True)
    data_s = tb.pack_scenes([t[1] for _, t in scenes], tcfg, dtype=torch.float32)
    params = {k: v.requires_grad_(True)
              for k, v in tb.stack_params([t[2] for _, t in scenes]).items()}
    fields = {k: v for k, v in vars(data_s).items() if v is not None}
    tmpl = ts.SceneData(**{k: None for k in fields} | {
        k: None for k in vars(data_s) if k not in fields})
    v = torch.func.vmap(lambda p, o: ts._pairwise_pts_loss_fused(
        p, dataclasses.replace(tmpl, **o), tcfg))(params, fields)
    g = dict(zip(params, torch.autograd.grad(v.sum(), list(params.values()),
                                             allow_unused=True)))
    np.testing.assert_allclose(v.detach().numpy(), np.asarray(jv), rtol=1e-6)
    keys = ("im_poses",) if case == "chunked" else tuple(jg)
    for k in keys:
        got = np.zeros(params[k].shape, np.float32) if g[k] is None else g[k].numpy()
        np.testing.assert_allclose(got, np.asarray(jg[k]), atol=1e-6, err_msg=k)


def test_scene_axis_with_an_image_without_terms(monkeypatch):
    """Scene 1's image 2 is in no pair: its proj rows get a zero gradient,
    and every scene's loss and gradients are those of the scene alone."""
    _tiles(monkeypatch)
    r = np.random.default_rng(3)
    n, A, S = 4, 1500, 3
    per = []
    for z in range(S):
        imgs = [0, 1, 3] if z == 1 else [0, 1, 2, 3]
        idx = np.concatenate([imgs, r.choice(imgs, 11 - len(imgs))]).astype(np.int32)
        idx = np.sort(idx) if z % 2 == 0 else r.permutation(idx)
        e2 = len(idx)
        proj = torch.from_numpy(r.standard_normal((n, 3, A)).astype(np.float32))
        pw34 = torch.from_numpy((np.eye(3, 4) + 0.1 * r.standard_normal((e2, 3, 4)))
                                .astype(np.float32))
        pred = torch.from_numpy(r.standard_normal((e2, 3, A)).astype(np.float32))
        w = torch.from_numpy(r.uniform(0, 1, (e2, A)).astype(np.float32))
        order, offsets = el.term_csr(idx, n)
        per.append((proj, pw34, pred, w, torch.from_numpy(idx), order, offsets))
    st = [torch.stack(t) for t in zip(*per)]
    proj, pw34 = st[0].clone().requires_grad_(True), st[1].clone().requires_grad_(True)
    loss = torch.func.vmap(el.edge_loss)(proj, pw34, *st[2:])
    scale = torch.tensor([1.0, 2.0, 3.0])
    gp, gm = torch.autograd.grad((loss * scale).sum(), [proj, pw34])
    assert (gp[1, 2] == 0).all()
    for z, case in enumerate(per):
        p1, m1 = case[0].clone().requires_grad_(True), case[1].clone().requires_grad_(True)
        l1 = el.edge_loss(p1, m1, *case[2:])
        a, b = torch.autograd.grad(l1 * scale[z], [p1, m1])
        assert abs(loss[z].item() - l1.item()) <= 1e-6 * abs(l1.item())
        for got, want in ((gp[z], a), (gm[z], b)):
            assert (got - want).abs().max().item() <= 1e-6 * want.abs().max().item()


def _solved_scenes(seeds=(0, 1), flow=False):
    """Port and JAX (cfg, data, params, masks) of test_torch_scene.py's
    scenes from the identical (JAX mst_init) init; with flow, RAFT-like
    flows, dynamic masks and init depths (test_torch_flow.py's)."""
    kw = dict(SCENE_KW)
    if flow:
        kw.update(flow_loss_weight=0.01, flow_loss_start_epoch=0.3, flow_loss_thre=1e6,
                  depth_regularize_weight=0.05, num_total_iter=20)
    port, jax_side = [], []
    for seed in seeds:
        out, _ = _output(noise=0.02, seed=seed)
        jcfg, jdata, jparams = js.build_scene(_jax_out(out), dict(kw, fast_impl="fused"))
        jparams = jinit.mst_init(jparams, jdata, jcfg, out["pred1"]["conf"],
                                 out["pred2"]["conf"])
        tcfg, tdata, _ = ts.build_scene(out, kw)
        if flow:
            r = np.random.default_rng(10 + seed)
            E = len(out["view1"]["idx"])
            extra = {"flow_ij": r.standard_normal((E, H, W, 2)).astype(np.float32),
                     "flow_ji": r.standard_normal((E, H, W, 2)).astype(np.float32),
                     "dynamic_masks": (r.uniform(size=(4, H, W)) > 0.7).astype(np.float32),
                     "init_depth": (np.asarray(js.get_depthmaps_raw(jparams, jdata, jcfg))
                                    * r.uniform(0.9, 1.1, (4, H * W))).astype(np.float32)}
            jdata = dataclasses.replace(jdata, **{k: jnp.asarray(v) for k, v in extra.items()})
            tdata = dataclasses.replace(tdata, **{k: torch.from_numpy(v)
                                                  for k, v in extra.items()})
        tp = {k: torch.from_numpy(np.array(v)) for k, v in jparams.items()}
        port.append((tcfg, tdata, tp, ts.default_masks(tcfg, tp)))
        jax_side.append((jcfg, jdata, jparams, js.default_masks(jcfg, jparams)))
    return port, jax_side


@pytest.mark.parametrize("precision", ["mixed", "bf16", "fp32"])
def test_batched_alignment_matches_sequential_and_jax(precision):
    port, jax_side = _solved_scenes()
    niter = 20
    solved, losses = tb.batched_alignment([s[2] for s in port], [s[3] for s in port],
                                          [s[1] for s in port], port[0][0], lr=0.01,
                                          niter=niter, precision=precision)
    assert losses.shape == (2, niter) and np.isfinite(losses).all()
    for z, (c, d, p, m) in enumerate(port):
        p_seq, l_seq = ts.global_alignment_loop(p, m, d, c, lr=0.01, niter=niter,
                                                precision=precision)
        np.testing.assert_allclose(losses[z], l_seq.numpy(), rtol=2e-4, atol=1e-5)
        for k in p_seq:
            np.testing.assert_allclose(solved[z][k].numpy(), p_seq[k].numpy(),
                                       rtol=2e-4, atol=1e-5, err_msg=k)
        np.testing.assert_array_equal(solved[z]["im_pp"].numpy(), p["im_pp"].numpy())
    _, jl = jb.batched_alignment([s[2] for s in jax_side], [s[3] for s in jax_side],
                                 [s[1] for s in jax_side], jax_side[0][0], lr=0.01,
                                 niter=niter, precision=precision)
    np.testing.assert_allclose(losses, np.asarray(jl), rtol=2e-4, atol=1e-5)


def test_batched_flow_loss_matches_sequential_and_jax():
    """loss_fn=flow_forward with its step-gated flow term (opens at step 6
    of 20), the temporal smoothing and the depth regulariser, mixed
    precision: the gate sees the global step in both phases."""
    port, jax_side = _solved_scenes(flow=True)
    niter = 20
    _, losses = tb.batched_alignment([s[2] for s in port], [s[3] for s in port],
                                     [s[1] for s in port], port[0][0], lr=0.01,
                                     niter=niter, loss_fn=tflow)
    for z, (c, d, p, m) in enumerate(port):
        _, l_seq = ts.global_alignment_loop(p, m, d, c, lr=0.01, niter=niter, loss_fn=tflow)
        np.testing.assert_allclose(losses[z], l_seq.numpy(), rtol=2e-4, atol=1e-5)
    _, jl = jb.batched_alignment([s[2] for s in jax_side], [s[3] for s in jax_side],
                                 [s[1] for s in jax_side], jax_side[0][0], lr=0.01,
                                 niter=niter, loss_fn=jflow)
    np.testing.assert_allclose(losses, np.asarray(jl), rtol=2e-4, atol=1e-5)
    # the flow term switched on at step 6: the losses jump there
    base = dataclasses.replace(port[0][0], flow_loss_weight=0.0)
    _, l_off = tb.batched_alignment([s[2] for s in port], [s[3] for s in port],
                                    [s[1] for s in port], base, lr=0.01, niter=niter,
                                    loss_fn=tflow)
    np.testing.assert_array_equal(l_off[:, :6], losses[:, :6])
    assert (np.abs(l_off[:, 6:] - losses[:, 6:]) > 0).all()


def test_pack_scenes_is_each_scenes_pack():
    port, _ = _solved_scenes()
    cfg = port[0][0]
    st = tb.pack_scenes([s[1] for s in port], cfg)
    for z, (c, d, p, m) in enumerate(port):
        one = ts.pack_scene(d, c)
        for k in ("packed_pred", "packed_w", "packed_idx", "packed_perm", "packed_order",
                  "packed_offsets"):
            assert torch.equal(getattr(st, k)[z], getattr(one, k)), k


def test_batched_alignment_refuses_unknown_precision():
    port, _ = _solved_scenes(seeds=(0,))
    c, d, p, m = port[0]
    with pytest.raises(ValueError):
        tb.batched_alignment([p], [m], [d], c, niter=4, precision="Mixed")
