"""Plain reference of the global alignment of the depth path
(`variant="prior"`): pairwise pointmaps of a frame graph -> per-frame
depth, pose and focal.

1. Confidences above 1 are clamped to `conf_clamp`; per-pixel weights are
   their log; each frame's confidence is the max over its edges.
2. Initialisation: a minimum spanning tree over the edges scored by
   mean(conf_i) mean(conf_j) (scipy), walked greedily from the best edge;
   each new frame registered by weighted Umeyama; Weiszfeld focals; frames
   left without a pose take RANSAC-PnP, which this reference does not
   compute: a focal of at most 5 px (the RANSAC tolerance) gives no pose,
   and above it the caller supplies the poses (`init`'s `pnp`). Then every
   edge's similarity is registered against the propagated cloud and the
   scales normalised. Under the control's precision the inputs are
   rounded as `Precision.r("init")` gives.
3. 300 Adam steps (b1 = b2 = 0.9, eps 1e-8, cosine learning rate) on the
   confidence-weighted L1 distance between each frame's back-projected
   depth and each edge's pointmaps under its similarity transform, in
   float32; under the control's precision the observations are rounded as
   `Precision.r(part)` gives for the solve's two phases.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.csgraph  # noqa: F401
import torch

PNP_TOLERANCE_PX = 5.0


# ------------------------------------------------------------- geometry

def _norm(x, dim=-1, keepdim=False):
    sq = (x * x).sum(dim=dim, keepdim=keepdim)
    return torch.sqrt(torch.clamp(sq, min=1e-12)) * torch.sign(sq)


def grid(W, H, device):
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=device),
                            torch.arange(W, dtype=torch.float32, device=device), indexing="ij")
    return torch.stack([xs, ys], -1)


def geotrf(T, pts):
    extra = pts.ndim - 1 - (T.ndim - 2)
    T = T.reshape(T.shape[:-2] + (1,) * extra + T.shape[-2:])
    return (T[..., :3, :3] @ pts.unsqueeze(-1)).squeeze(-1) + T[..., :3, 3]


def quat_to_R(q):
    q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=1e-12)
    x, y, z, w = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1)], -2)


def R_to_quat(R):
    m = [[R[..., i, j] for j in range(3)] for i in range(3)]
    tr = m[0][0] + m[1][1] + m[2][2]
    w2, x2 = 1.0 + tr, 1.0 + m[0][0] - m[1][1] - m[2][2]
    y2, z2 = 1.0 - m[0][0] + m[1][1] - m[2][2], 1.0 - m[0][0] - m[1][1] + m[2][2]
    sq = lambda v: torch.sqrt(torch.clamp(v, min=1e-12)) * 2
    sw, sx, sy, sz = sq(w2), sq(x2), sq(y2), sq(z2)
    cw = torch.stack([(m[2][1] - m[1][2]) / sw, (m[0][2] - m[2][0]) / sw,
                      (m[1][0] - m[0][1]) / sw, sw / 4], -1)
    cx = torch.stack([sx / 4, (m[0][1] + m[1][0]) / sx, (m[0][2] + m[2][0]) / sx,
                      (m[2][1] - m[1][2]) / sx], -1)
    cy = torch.stack([(m[0][1] + m[1][0]) / sy, sy / 4, (m[1][2] + m[2][1]) / sy,
                      (m[0][2] - m[2][0]) / sy], -1)
    cz = torch.stack([(m[0][2] + m[2][0]) / sz, (m[1][2] + m[2][1]) / sz, sz / 4,
                      (m[1][0] - m[0][1]) / sz], -1)
    idx = torch.argmax(torch.stack([x2, y2, z2, w2], -1), -1)
    c = torch.stack([cx, cy, cz, cw], -2)
    q = torch.gather(c, -2, idx[..., None, None].expand(*idx.shape, 1, 4))[..., 0, :]
    return q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=1e-12)


def pose_to_T(vec):
    R = quat_to_R(vec[..., :4])
    t = torch.sign(vec[..., 4:7]) * torch.expm1(torch.abs(vec[..., 4:7]))
    top = torch.cat([R, t[..., None]], -1)
    bot = torch.tensor([0.0, 0.0, 0.0, 1.0], device=vec.device).expand(*top.shape[:-2], 1, 4)
    return torch.cat([top, bot], -2)


def T_to_pose(T, scale=None):
    s = 1.0 if scale is None else scale
    v = T[..., :3, 3] / s
    vec = torch.cat([R_to_quat(T[..., :3, :3]), torch.sign(v) * torch.log1p(torch.abs(v))], -1)
    if scale is not None:
        vec = torch.cat([vec, torch.log(torch.as_tensor(scale, device=vec.device)).expand(
            *vec.shape[:-1], 1)], -1)
    return vec


def sim3(vec, base_scale):
    RT = pose_to_T(vec[..., :7])
    ls = vec[..., 7]
    ls = ls + (np.log(base_scale) - ls.mean(-1, keepdim=True))
    s = torch.exp(ls)[..., None, None]
    return torch.cat([RT[..., :3, :] * s, RT[..., 3:, :]], -2)


def register(a, b, w):
    """Weighted Umeyama s, R, t with sum w ||s R a + t - b||^2 least."""
    a, b = a.reshape(-1, 3).float(), b.reshape(-1, 3).float()
    c = torch.clamp(torch.maximum(a.abs().mean(), b.abs().mean()), min=1.0)
    a, b = a / c, b / c
    wn = w.reshape(-1).float()
    wn = wn / torch.clamp(wn.sum(), min=1e-12)
    ma, mb = (wn[:, None] * a).sum(0), (wn[:, None] * b).sum(0)
    ac, bc = a - ma, b - mb
    U, S, Vt = torch.linalg.svd((wn[:, None] * bc).T @ ac)
    d = torch.sign(torch.linalg.det(U @ Vt))
    D = torch.diag(torch.stack([torch.ones_like(d), torch.ones_like(d), d]))
    R = U @ D @ Vt
    s = (S * torch.diagonal(D)).sum() / torch.clamp((wn * (ac * ac).sum(-1)).sum(), min=1e-12)
    return R, (mb - s * (R @ ma)) * c, s


def weiszfeld(pts, n_iter=10):
    """Focal of a camera-frame pointmap (H, W, 3), principal point at the centre."""
    H, W = pts.shape[:2]
    p = pts.reshape(-1, 3).float()
    pix = grid(W, H, p.device).reshape(-1, 2) - torch.tensor([W / 2, H / 2], device=p.device)
    z = p[:, 2:3]
    xy = torch.nan_to_num(p[:, :2] / torch.clamp(z.abs(), min=1e-8) * torch.sign(z),
                          posinf=0.0, neginf=0.0)
    dxp, dxx = (xy * pix).sum(-1), (xy ** 2).sum(-1)
    f = dxp.mean() / torch.clamp(dxx.mean(), min=1e-12)
    for _ in range(n_iter):
        wgt = 1.0 / torch.clamp(torch.linalg.vector_norm(pix - f * xy, dim=-1), min=1e-8)
        f = (wgt * dxp).mean() / torch.clamp((wgt * dxx).mean(), min=1e-12)
    return float(torch.clamp(f, min=1e-4))


def _Tsrt(s, R, t):
    T = torch.eye(4, device=R.device)
    T[:3, :3] = R * s
    T[:3, 3] = t
    return T


# ----------------------------------------------------------------- init

def init(pred_i, pred_j, conf_i, conf_j, edges, n, hw, solve_cfg, pnp=None, P=None):
    """MST initialisation. pred_* (E, H, W, 3), conf_* (E, H, W) clamped.
    pnp(frames, focals): the (focal, cam2world) or None of each frame left
    without a pose whose focal is above the RANSAC tolerance, where a
    caller supplies them. Under P the inputs are rounded as `P.r("init")`
    gives. Returns the parameter dict and the numbers of frames that
    needed PnP and that it posed."""
    if P is not None:
        pred_i, pred_j, conf_i, conf_j = P.r("init", pred_i, pred_j, conf_i, conf_j)
    H, W = hw
    A = H * W
    dev = pred_i.device
    E = len(edges)
    ci, cj = conf_i.reshape(E, A), conf_j.reshape(E, A)
    scores = (ci.mean(1) * cj.mean(1)).cpu().numpy()
    g = sp.dok_array((n, n))
    for k, (i, j) in enumerate(edges):
        g[i, j] = -float(scores[k])
    msp = sp.csgraph.minimum_spanning_tree(g.tocsr()).tocoo()
    todo = sorted(zip(-msp.data, msp.row, msp.col))
    kof = {e: k for k, e in enumerate(edges)}
    pts = [None] * n
    poses = [None] * n
    focals = [None] * n
    eye = torch.eye(4, device=dev)
    _, i, j = todo.pop()
    k = kof[(i, j)]
    pts[i], pts[j] = pred_i[k].clone(), pred_j[k].clone()
    done = {i, j}
    poses[i] = eye
    focals[i] = weiszfeld(pred_i[k])
    stall = 0
    while todo:
        sc, i, j = todo.pop()
        k = kof[(i, j)]
        if i not in done and j not in done:
            todo.insert(0, (sc, i, j))
            stall += 1
            if stall > len(todo):
                sc, i, j = todo.pop()
                k = kof[(i, j)]
                pts[i], pts[j] = pred_i[k].clone(), pred_j[k].clone()
                poses[i] = eye
                if focals[i] is None:
                    focals[i] = weiszfeld(pred_i[k])
                done.update((i, j))
                stall = 0
            continue
        stall = 0
        if focals[i] is None:
            focals[i] = weiszfeld(pred_i[k])
        if i in done:
            R, t, s = register(pred_i[k], pts[i], ci[k])
            pts[j] = geotrf(_Tsrt(s, R, t), pred_j[k])
            done.add(j)
            if poses[i] is None:
                poses[i] = _Tsrt(1.0, R, t)
        elif j in done:
            R, t, s = register(pred_j[k], pts[j], cj[k])
            pts[i] = geotrf(_Tsrt(s, R, t), pred_i[k])
            done.add(i)
            if poses[i] is None:
                poses[i] = _Tsrt(1.0, R, t)
    for k in np.argsort([-s for s in scores]):
        i, _ = edges[k]
        if focals[i] is None:
            focals[i] = weiszfeld(pred_i[k])
    need = [i for i in range(n) if poses[i] is None and pts[i] is not None]
    posed = 0
    if any(focals[i] > PNP_TOLERANCE_PX for i in need):
        if pnp is None:
            raise NotImplementedError(f"frames {need} need a PnP with a focal above "
                                      f"{PNP_TOLERANCE_PX} px, which the reference does not cover")
        for i, r in zip(need, pnp(need, [focals[i] for i in need])):
            if r is not None:
                focals[i], poses[i] = r[0], r[1].float().to(dev)
                posed += 1
    for i in range(n):
        poses[i] = eye if poses[i] is None else poses[i]
        pts[i] = torch.zeros((H, W, 3), device=dev) if pts[i] is None else pts[i]
        focals[i] = float(max(H, W)) if focals[i] is None else focals[i]
    pts, poses = torch.stack(pts), torch.stack(poses)
    vecs, scales = [], []
    for k, (i, j) in enumerate(edges):
        R, t, s = register(pred_i[k], pts[i], ci[k])
        vecs.append(T_to_pose(_Tsrt(1.0, R, t), scale=s))
        scales.append(s)
    logs = np.log(torch.stack(scales).cpu().numpy().astype(np.float64))
    f = float(np.exp(np.log(solve_cfg["base_scale"]) - np.mean(logs)))
    poses = poses.clone()
    poses[:, :3, 3] *= f
    pts = pts * f
    fb = solve_cfg["focal_break"]
    cams = torch.from_numpy(np.linalg.inv(poses.cpu().numpy())).to(dev)
    depth = geotrf(cams, pts)[..., 2].reshape(n, A)
    params = {
        "pw_poses": torch.stack(vecs).float(),
        "im_poses": T_to_pose(poses).float(),
        "im_focals": fb * torch.log(torch.clamp(torch.tensor(focals, dtype=torch.float32),
                                                min=1e-4)).to(dev),
        "im_depthmaps": torch.log(torch.clamp(depth.float(), min=1e-8)),
    }
    return params, (len(need), posed)


# ---------------------------------------------------------------- solve

def _apply(T, pts):
    """Rows of 4x4 transforms T (m, 4, 4) on point sets pts (m, A, 3)."""
    return torch.einsum("mij,maj->mai", T[:, :3, :3], pts) + T[:, None, :3, 3]


def loss(params, obs, cfg, A):
    """The confidence-weighted L1 pairwise loss."""
    pw = sim3(params["pw_poses"], cfg["base_scale"])
    depth = torch.exp(params["im_depthmaps"])
    f = torch.exp(params["im_focals"] / cfg["focal_break"])[:, None, None]
    g, pp = obs["grid"], obs["pp"]
    rel = torch.cat([depth[..., None] * (g[None] - pp) / f, depth[..., None]], -1)
    proj = _apply(pose_to_T(params["im_poses"]), rel)
    di = _norm(proj.index_select(0, obs["ei"]) - _apply(pw, obs["pred_i"]))
    dj = _norm(proj.index_select(0, obs["ej"]) - _apply(pw, obs["pred_j"]))
    E = obs["ei"].shape[0]
    return (di * obs["w_i"]).sum() / (E * A) + (dj * obs["w_j"]).sum() / (E * A)


def observations(pred_i, pred_j, w_i, w_j, edges, hw, P, part):
    """What the loss reads: the edges' pointmaps and weights, rounded as
    P gives for `part` (the weights as the pack holds them, over E A)."""
    H, W = hw
    A, E = H * W, len(edges)
    dev = pred_i.device
    return {"ei": torch.tensor([e[0] for e in edges], device=dev),
            "ej": torch.tensor([e[1] for e in edges], device=dev),
            "grid": grid(W, H, dev).reshape(A, 2),
            "pp": torch.tensor([W / 2, H / 2], device=dev),
            "pred_i": P.r(part, pred_i.reshape(E, A, 3)),
            "pred_j": P.r(part, pred_j.reshape(E, A, 3)),
            "w_i": P.r(part, w_i.reshape(E, A) / (E * A)) * (E * A),
            "w_j": P.r(part, w_j.reshape(E, A) / (E * A)) * (E * A)}


def solve(params, pred_i, pred_j, w_i, w_j, edges, hw, cfg, P):
    """Adam over the cosine schedule; the observations of step k rounded as
    P gives for the phase step k is in (part "solve_first" for the first
    `first_share` of the steps, "solve_rest" after). Returns (params,
    losses (niter,))."""
    H, W = hw
    A = H * W
    niter, lr, lr_min = cfg["niter"], cfg["lr"], cfg["lr_min"]
    t = np.arange(niter, dtype=np.float64) / niter
    lrs = (lr_min + (lr - lr_min) * (1 + np.cos(t * np.pi)) / 2).astype(np.float32)
    k_first = int(niter * cfg["first_share"])

    def observations_of(part):
        return observations(pred_i, pred_j, w_i, w_j, edges, hw, P, part)

    p = {k: v.detach().clone() for k, v in params.items()}
    mu = {k: torch.zeros_like(v) for k, v in p.items()}
    nu = {k: torch.zeros_like(v) for k, v in p.items()}
    b1 = b2 = 0.9
    losses, obs, phase = [], None, None
    for step in range(niter):
        part = "solve_first" if step < k_first else "solve_rest"
        if part != phase:
            obs, phase = None, part
            obs = observations_of(part)
        with torch.enable_grad():
            leaves = {k: v.requires_grad_(True) for k, v in p.items()}
            val = loss(leaves, obs, cfg, A)
            grads = torch.autograd.grad(val, list(leaves.values()))
        c = step + 1
        bc1 = 1 - torch.tensor(b1, dtype=torch.float32) ** c
        bc2 = 1 - torch.tensor(b2, dtype=torch.float32) ** c
        new = {}
        for (k, v), gr in zip(leaves.items(), grads):
            mu[k] = (1 - b1) * gr + b1 * mu[k]
            nu[k] = (1 - b2) * gr * gr + b2 * nu[k]
            upd = (mu[k] / bc1.item()) / (torch.sqrt(nu[k] / bc2.item()) + 1e-8)
            new[k] = v.detach() - float(lrs[step]) * upd
        p = new
        losses.append(val.detach())
    return p, torch.stack(losses)


def outputs(params, hw, cfg):
    """Depths (n, H, W), cam2world poses (n, 4, 4), focals (n,)."""
    n = params["im_poses"].shape[0]
    return (torch.exp(params["im_depthmaps"]).reshape(n, *hw),
            pose_to_T(params["im_poses"]),
            torch.exp(params["im_focals"] / cfg["focal_break"]))


def weights(conf, clamp):
    """Per-pixel weights: the log of the confidences, those above 1
    clamped to `clamp`."""
    return torch.log(torch.where(conf > 1, torch.full_like(conf, clamp), conf))


def objective(pred_i, pred_j, conf_i, conf_j, edges, hw, cfg):
    """The solve's loss as a function of a state, on float32 observations."""
    from benchmark.reference.common import Precision
    obs = observations(pred_i, pred_j, weights(conf_i, cfg["conf_clamp"]),
                       weights(conf_j, cfg["conf_clamp"]), edges, hw, Precision(), "solve_rest")

    @torch.no_grad()
    def at(params):
        return float(loss({k: params[k].float() for k in ("pw_poses", "im_poses", "im_focals",
                                                          "im_depthmaps")},
                          obs, cfg, hw[0] * hw[1]))
    return at


def run(pred_i, pred_j, conf_i, conf_j, edges, n, hw, cfg, P, pnp=None, nudge=0.0):
    """The whole alignment from an engine's raw output. Returns a dict:
    the initialisation's parameters ("init"), each step's loss ("losses"),
    the final parameters ("final"), the final depths, cam2world poses and
    focals, and (frames that needed PnP, frames it posed) ("pnp"). `nudge`
    adds that much seeded noise to the initial log-depths (the readings'
    witness of how far rounding carries through the solve)."""
    clamp = cfg["conf_clamp"]
    ci = torch.where(conf_i > 1, torch.full_like(conf_i, clamp), conf_i)
    cj = torch.where(conf_j > 1, torch.full_like(conf_j, clamp), conf_j)
    params, n_pnp = init(pred_i, pred_j, ci, cj, edges, n, hw, cfg, pnp, P)
    start = params
    if nudge:
        g = torch.Generator(device=pred_i.device).manual_seed(12345)
        d = params["im_depthmaps"]
        start = dict(params, im_depthmaps=d + nudge * torch.randn(
            d.shape, generator=g, device=d.device))
    out, losses = solve(start, pred_i, pred_j, torch.log(ci), torch.log(cj), edges, hw,
                        cfg, P)
    d, T, f = outputs(out, hw, cfg)
    return {"init": params, "losses": losses, "final": out, "depths": d, "poses": T,
            "focals": f, "pnp": n_pnp}
