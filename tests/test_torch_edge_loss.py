"""Port parity: the plain versions of kernels K3/K4 (fused edge-residual loss,
forward and backward) in align3r_tpu_torch.ops.edge_loss against
align3r_tpu.ops.edge_loss.edge_loss run as Pallas in interpret mode.

Inputs come from numpy seeds; the JAX side packs them into its lane layout
with padded pixels and zero-weight dummy terms (which the port receives as
ordinary zero-weight terms). Storage is bf16 or fp32, arithmetic fp32 on both
sides. Tolerance: 1e-5 relative to the largest value — fp32 sums over the
same terms in another order.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from align3r_tpu.alignment import scene as js
from align3r_tpu.inference.pairs import make_pairs
from align3r_tpu.ops import edge_loss as jel
from align3r_tpu_torch.alignment import scene as ts
from align3r_tpu_torch.ops import edge_loss as tel

torch.set_num_threads(2)


def _close(got, ref, rel=1e-5):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert np.abs(got - ref).max() <= rel * max(np.abs(ref).max(), 1e-30), \
        (np.abs(got - ref).max(), np.abs(ref).max())


def _case(seed, n=5, e_real=13, e2=16, A=300):
    r = np.random.default_rng(seed)
    proj = r.standard_normal((n, A, 3)).astype(np.float32)
    pred = r.standard_normal((e2, A, 3)).astype(np.float32)
    w = r.uniform(0, 1, (e2, A)).astype(np.float32) / (e2 * A)
    w[e_real:] = 0.0                                   # dummy terms
    pred[e_real:] = pred[0]                            # dummy: copy of term 0
    idx = r.integers(0, n, e2).astype(np.int32)
    idx[e_real:] = 0
    pw34 = (np.eye(3, 4)[None] + 0.2 * r.standard_normal((e2, 3, 4))).astype(np.float32)
    pred[1, 7] = proj[idx[1], 7]                       # an exact zero residual
    pw34[1] = np.eye(3, 4)
    return proj, pred, w, idx, pw34


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_edge_loss_matches_pallas_interpret(dtype):
    proj, pred, w, idx, pw34 = _case(0)
    n, A, _ = proj.shape
    e2 = pred.shape[0]
    la = -(-A // 128)
    la = -(-la // 8) * 8                               # padded pixel rows
    jdt = jnp.float32 if dtype == "fp32" else jnp.bfloat16
    meta = jel.EdgeMeta(n=n, e2=e2, la=la, rb=8, eb=8, nc=0, interpret=True)
    proj_p = jel.pack_points(jnp.asarray(proj), la, jnp.float32)
    pred_p = jel.pack_points(jnp.asarray(pred), la, jdt)
    w_p = jel.pack_scalars(jnp.asarray(w), la, jdt)

    def f(pp, m):
        return jel.edge_loss(meta, pp, m, pred_p, w_p, jnp.asarray(idx))

    loss_j, (dproj_j, dpw_j) = jax.value_and_grad(f, argnums=(0, 1))(
        proj_p, jnp.asarray(pw34))
    dproj_j = np.asarray(jel.unpack_points(dproj_j, A))            # (n, A, 3)

    tdt = torch.float32 if dtype == "fp32" else torch.bfloat16
    to_t = lambda a: torch.from_numpy(np.array(a, np.float32))
    pred_t = to_t(np.asarray(pred_p.astype(jnp.float32)).reshape(e2, 3, -1)[..., :A]).to(tdt)
    w_t = to_t(np.asarray(w_p.astype(jnp.float32)).reshape(e2, -1)[:, :A]).to(tdt)
    proj_t = to_t(proj.transpose(0, 2, 1)).requires_grad_(True)
    pw_t = to_t(pw34).requires_grad_(True)
    idx_t = torch.from_numpy(idx)
    order, offsets = tel.term_csr(idx_t, n)
    loss_t = tel.edge_loss(proj_t, pw_t, pred_t, w_t, idx_t, order, offsets)
    loss_t.backward()
    _close(loss_t.item(), float(loss_j))
    _close(proj_t.grad.numpy().transpose(0, 2, 1), dproj_j)
    _close(pw_t.grad.numpy(), np.asarray(dpw_j))


def test_plain_backward_matches_autograd_of_plain_forward():
    """K4's plain version is the gradient of K3's plain version, including
    the zero-gradient convention at a zero residual."""
    proj, pred, w, idx, pw34 = _case(1)
    pt = torch.from_numpy(proj.transpose(0, 2, 1).copy()).requires_grad_(True)
    mt = torch.from_numpy(pw34).requires_grad_(True)
    pred_t = torch.from_numpy(pred.transpose(0, 2, 1).copy())
    idx_t = torch.from_numpy(idx)
    loss = tel.edge_loss_fwd_plain(pt, mt, pred_t, torch.from_numpy(w), idx_t)
    loss.backward()
    dp, dm = tel.edge_loss_bwd_plain(torch.tensor(1.0), pt.detach(), mt.detach(),
                                     pred_t, torch.from_numpy(w), idx_t)
    _close(dp.numpy(), pt.grad.numpy())
    _close(dm.numpy(), mt.grad.numpy())


def test_term_csr():
    idx = np.array([3, 0, 3, 1, 0, 3], np.int32)
    order, offsets = tel.term_csr(torch.from_numpy(idx), 5)
    np.testing.assert_array_equal(offsets.numpy(), [0, 2, 3, 3, 6, 6])
    np.testing.assert_array_equal(order.numpy(), [1, 4, 3, 0, 2, 5])


# ------------------------------------------- through the scene (pack + loss)

def _scene(seed=0, n=4, H=8, W=12):
    pairs = make_pairs(n, "complete", symmetrize=True)
    E = len(pairs)
    r = np.random.default_rng(seed)
    out = {"view1": {"idx": np.array([p[0] for p in pairs])},
           "view2": {"idx": np.array([p[1] for p in pairs])},
           "pred1": {"pts3d": r.standard_normal((E, H, W, 3)).astype(np.float32),
                     "conf": (1 + r.uniform(size=(E, H, W))).astype(np.float32)},
           "pred2": {"pts3d_in_other_view": r.standard_normal((E, H, W, 3)).astype(np.float32),
                     "conf": (1 + r.uniform(size=(E, H, W))).astype(np.float32)}}
    jcfg, jdata, jparams = js.build_scene(
        {k: ({kk: jnp.asarray(v) for kk, v in d.items()} if k.startswith("pred") else d)
         for k, d in out.items()}, dict(fast_impl="fused"))
    tcfg, tdata, _ = ts.build_scene(out)
    tparams = {k: torch.from_numpy(np.array(v)) for k, v in jparams.items()}
    return jcfg, jdata, jparams, tcfg, tdata, tparams


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_pack_scene_matches_streamed_pack(dtype):
    """The port's image-sorted pack holds, slot by slot, the streamed pack's
    term perm[slot] (the JAX natural order at n=4)."""
    jcfg, jdata, _, tcfg, tdata, _ = _scene(1)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "fp32"
                else (jnp.bfloat16, torch.bfloat16))
    jp = js.pack_scene(jdata, jcfg, dtype=jdt, impl="streamed")
    tp = ts.pack_scene(tdata, tcfg, dtype=tdt)
    e2, A = 2 * jcfg.n_edges, jcfg.imshape[0] * jcfg.imshape[1]
    perm = tp.packed_perm.numpy()
    idx = np.asarray(jp.packed_idx)[:e2]
    np.testing.assert_array_equal(perm, np.argsort(idx, kind="stable"))
    jpred = np.asarray(jp.packed_pred.astype(jnp.float32)).reshape(-1, 3, jp.packed_pred.shape[2] * 128)
    np.testing.assert_array_equal(tp.packed_pred.float().numpy(), jpred[perm, :, :A])
    jw = np.asarray(jp.packed_w.astype(jnp.float32)).reshape(-1, jp.packed_w.shape[1] * 128)
    # one fp32 division per weight; jit and eager may round it differently
    np.testing.assert_allclose(tp.packed_w.float().numpy(), jw[perm, :A], rtol=1e-2 if dtype == "bf16" else 3e-7)
    np.testing.assert_array_equal(tp.packed_idx.numpy(), idx[perm])
    # K4's CSR over image-sorted slots walks them in order
    np.testing.assert_array_equal(tp.packed_order.numpy(), np.arange(e2))


# ------------------------------------------------ K5 and the image-sorted pack

def _layout_scene(n, graph):
    """The two scenes of tests/test_edge_loss.py:90: n=4 complete (one
    chunk, natural order) and n=300 swin-1 (image-chunked, dummy slots)."""
    pairs = make_pairs(n, graph, symmetrize=True)
    E, H, W = len(pairs), 8, 16
    r = np.random.default_rng(n)
    out = {"view1": {"idx": np.array([p[0] for p in pairs])},
           "view2": {"idx": np.array([p[1] for p in pairs])},
           "pred1": {"pts3d": r.standard_normal((E, H, W, 3)).astype(np.float32),
                     "conf": (1 + r.uniform(size=(E, H, W))).astype(np.float32)},
           "pred2": {"pts3d_in_other_view": r.standard_normal((E, H, W, 3)).astype(np.float32),
                     "conf": (1 + r.uniform(size=(E, H, W))).astype(np.float32)}}
    jcfg, jdata, _ = js.build_scene(
        {k: ({kk: jnp.asarray(v) for kk, v in d.items()} if k.startswith("pred") else d)
         for k, d in out.items()})
    tcfg, tdata, _ = ts.build_scene(out)
    meta = js._edge_meta(jcfg)
    assert (meta.nc > 0) == (n == 300), meta
    idx_np = np.concatenate([np.asarray(jdata.ei), np.asarray(jdata.ej)]).astype(np.int64)
    if meta.nc:
        slots, perm, *_ = js._chunk_layout(idx_np, meta)
        valid = slots >= 0
    else:
        perm = np.concatenate([np.arange(2 * E), np.zeros(meta.e2 - 2 * E)]).astype(np.int32)
        valid = np.arange(meta.e2) < 2 * E
    return jcfg, jdata, tcfg, tdata, meta, perm.astype(np.int32), valid


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("n, graph", [(4, "complete"), (300, "swin-1")])
def test_permute_packed_plain_matches_pallas_interpret(n, graph, dtype):
    """K5's plain version against the Pallas permute_packed in interpret
    mode, bit for bit, on the JAX layouts' perm / valid (dummy slots copy
    term 0 with weight exactly 0)."""
    jcfg, jdata, _, _, meta, perm, valid = _layout_scene(n, graph)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "fp32"
                else (jnp.bfloat16, torch.bfloat16))
    E, la = jcfg.n_edges, meta.la
    r = np.random.default_rng(7)
    packs = [jel.pack_points(jnp.asarray(r.standard_normal((E, 40, 3)), jnp.float32), la, jdt)
             for _ in range(2)]
    packs += [jel.pack_scalars(jnp.asarray(r.uniform(-1, 1, (E, 40)), jnp.float32), la, jdt)
              for _ in range(2)]
    jpred, jw = jel.permute_packed(*packs, jnp.asarray(perm), jnp.asarray(valid, jnp.int32),
                                   e2=meta.e2, e_split=E, interpret=True)
    tpacks = [torch.from_numpy(np.array(p.astype(jnp.float32)).reshape(E, *p.shape[1:-2], -1)
                               ).to(tdt) for p in packs]
    tpred, tw = tel.permute_packed(*tpacks, torch.from_numpy(perm),
                                   torch.from_numpy(valid.astype(np.int32)))
    assert tpred.dtype == tdt and tw.dtype == tdt
    np.testing.assert_array_equal(tpred.float().numpy(),
                                  np.asarray(jpred.astype(jnp.float32)).reshape(meta.e2, 3, -1))
    np.testing.assert_array_equal(tw.float().numpy(),
                                  np.asarray(jw.astype(jnp.float32)).reshape(meta.e2, -1))
    assert (tw[torch.from_numpy(~valid)] == 0).all()


@pytest.mark.parametrize("n, graph", [(4, "complete"), (300, "swin-1")])
def test_image_sorted_pack_matches_fast_pack(n, graph):
    """The port's pack against JAX's default "fast" pack (natural lane pack
    + Pallas permute in interpret mode), term by term, in bf16 and fp32:
    each port slot holds the JAX slot of the same term. At n=300 JAX's
    image-chunked slots with the dummies taken out are the port's slots in
    the same order; at n=4 JAX keeps the natural order."""
    jcfg, jdata, tcfg, tdata, meta, perm, valid = _layout_scene(n, graph)
    A = jcfg.imshape[0] * jcfg.imshape[1]
    jslot = np.empty(2 * jcfg.n_edges, np.int64)            # JAX slot of each term
    jslot[perm[valid]] = np.flatnonzero(valid)
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        jp = js.pack_scene(jdata, jcfg, dtype=jdt, impl="fast")
        tp = ts.pack_scene(tdata, tcfg, dtype=tdt)
        np.testing.assert_array_equal(np.asarray(jp.packed_perm), perm)
        tperm = tp.packed_perm.numpy()
        if meta.nc:
            np.testing.assert_array_equal(tperm, perm[valid])
        at = jslot[tperm]
        jpred = np.asarray(jp.packed_pred.astype(jnp.float32)).reshape(meta.e2, 3, -1)
        np.testing.assert_array_equal(tp.packed_pred.float().numpy(), jpred[at][:, :, :A])
        jw = np.asarray(jp.packed_w.astype(jnp.float32)).reshape(meta.e2, -1)
        # one fp32 division per weight; jit and eager may round it differently
        np.testing.assert_allclose(tp.packed_w.float().numpy(), jw[at][:, :A],
                                   rtol=1e-2 if tdt == torch.bfloat16 else 3e-7)
        ids = np.concatenate([np.asarray(jdata.ei), np.asarray(jdata.ej)])
        np.testing.assert_array_equal(tp.packed_idx.numpy(), ids[tperm])
        assert (np.diff(tp.packed_idx.numpy()) >= 0).all()


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_fused_scene_loss_and_grads_match(dtype):
    """_pairwise_pts_loss_fused end to end (pose decode, adaptor fold,
    channel-major world points, K3/K4 plain) against the JAX fused loss in
    interpret mode, gradients for every parameter."""
    jcfg, jdata, jparams, tcfg, tdata, tparams = _scene(2)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "fp32"
                else (jnp.bfloat16, torch.bfloat16))
    jdata = js.pack_scene(jdata, jcfg, dtype=jdt, impl="streamed")
    tdata = ts.pack_scene(tdata, tcfg, dtype=tdt)
    jfast = dataclasses.replace(jcfg, fast_solve=True)
    tfast = dataclasses.replace(tcfg, fast_solve=True)
    lj, gj = jax.value_and_grad(js.pairwise_pts_loss)(jparams, jdata, jfast)
    leaves = {k: v.clone().requires_grad_(True) for k, v in tparams.items()}
    lt = ts.pairwise_pts_loss(leaves, tdata, tfast)
    lt.backward()
    _close(lt.item(), float(lj), rel=1e-5)
    for k in ("pw_poses", "im_poses", "im_focals", "im_depthmaps"):
        _close(leaves[k].grad.numpy(), np.asarray(gj[k]), rel=1e-4)
