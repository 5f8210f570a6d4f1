"""Global alignment scene: parameters, losses and the Adam solve (port of
align3r_tpu/alignment/scene.py).

Parameters live in a flat dict of fp32 tensors; per-row freezing (preset
poses and focals, init_priors anchoring) is a gradient mask applied before
Adam, so frozen entries keep their initial values exactly. The pairwise term
runs either in plain fp32 (``pairwise_pts_loss`` with ``fast_solve`` off) or
through the fused edge-residual kernels K3/K4 (ops/edge_loss.py) on
observations packed once per solve by :func:`pack_scene`. The default mixed
schedule runs the first 80% of the iterations on a bf16 pack and polishes on
an fp32 repack, continuing the same Adam moments and step index.

All images of a scene share one (H, W).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from align3r_tpu_torch.alignment.schedules import schedule_array
from align3r_tpu_torch.geometry.core import geotrf, safe_norm, xy_grid
from align3r_tpu_torch.geometry.poses import (matrix_to_pose_vec, pose_vec_to_matrix,
                                              sim3_vec_to_matrix)
from align3r_tpu_torch.ops.edge_loss import (edge_loss, fold_pose_adaptors,
                                             permute_packed, term_csr)


@dataclasses.dataclass(frozen=True)
class SceneConfig:
    imshape: Tuple[int, int]           # (H, W), shared by all frames
    n_imgs: int
    n_edges: int
    if_use_mono: bool = False          # depth = mono*exp(scalemap)+shift vs exp(logdepth)
    focal_break: float = 20.0
    pw_break: float = 20.0
    base_scale: float = 0.5
    norm_pw_scale: bool = True
    conf: str = "log"                  # conf transform for pixel weights
    min_conf_thr: float = 3.0
    optimize_pp: bool = False
    shared_focal: bool = False         # flow variant: one focal for all frames
    allow_pw_adaptors: bool = False
    # flow-variant loss terms (0 = disabled; used by flow_forward)
    temporal_smoothing_weight: float = 0.0
    translation_weight: float = 1.0
    flow_loss_weight: float = 0.0
    depth_regularize_weight: float = 0.0
    flow_loss_start_epoch: float = 0.15
    flow_loss_thre: float = 50.0
    pxl_thre: float = 50.0
    num_total_iter: int = 300
    # pairwise term through the fused kernels on the packed observations
    # (toggled per phase by global_alignment_loop's precision schedule)
    fast_solve: bool = False

    @property
    def n_focals(self) -> int:
        return 1 if self.shared_focal else self.n_imgs


def conf_transform(conf, mode: str):
    if mode == "log":
        return torch.log(conf)
    if mode == "sqrt":
        return torch.sqrt(conf)
    if mode == "m1":
        return conf - 1
    if mode in ("id", "none"):
        return conf
    raise ValueError(mode)


@dataclasses.dataclass
class SceneData:
    """Frozen per-edge observations (tensors on the solve's device)."""
    ei: torch.Tensor                   # (E,) int64 view-1 image index per edge
    ej: torch.Tensor                   # (E,)
    pred_i: torch.Tensor               # (E, A, 3) pts3d in cam i
    pred_j: torch.Tensor               # (E, A, 3) pts3d of j in cam i
    weight_i: torch.Tensor             # (E, A) conf-transformed weights
    weight_j: torch.Tensor             # (E, A)
    grid: torch.Tensor                 # (A, 2) pixel coords
    base_pp: torch.Tensor              # (2,) = (W/2, H/2)
    mono_depths: Optional[torch.Tensor] = None   # (n, A)
    im_conf: Optional[torch.Tensor] = None       # (n, A) max conf per pixel
    dynamic_masks: Optional[torch.Tensor] = None  # (n, H, W) 1 = dynamic
    flow_ij: Optional[torch.Tensor] = None
    flow_ji: Optional[torch.Tensor] = None
    init_depth: Optional[torch.Tensor] = None
    # packed observations for the fused kernels (pack_scene)
    packed_pred: Optional[torch.Tensor] = None    # (2E, 3, A) bf16 | fp32
    packed_w: Optional[torch.Tensor] = None       # (2E, A), 1/(E*A) folded in
    packed_idx: Optional[torch.Tensor] = None     # (2E,) int32 image per slot
    packed_perm: Optional[torch.Tensor] = None    # (2E,) int64 term per slot
    packed_order: Optional[torch.Tensor] = None   # (2E,) int32 slots by image
    packed_offsets: Optional[torch.Tensor] = None  # (n + 1,) int32 CSR offsets


def build_scene(output: Dict, cfg_kw: Dict | None = None, mono_depths=None,
                seed: int = 0) -> Tuple[SceneConfig, SceneData, Dict]:
    """From the engine output dict, build (config, data, params)."""
    cfg_kw = dict(cfg_kw or {})
    pred1, pred2 = output["pred1"], output["pred2"]
    pts = torch.as_tensor(pred1["pts3d"], dtype=torch.float32)
    dev = pts.device
    idx_i = torch.as_tensor(np.asarray(output["view1"]["idx"]), dtype=torch.long,
                            device=dev)
    idx_j = torch.as_tensor(np.asarray(output["view2"]["idx"]), dtype=torch.long,
                            device=dev)
    E, H, W, _ = pts.shape
    A = H * W
    n_imgs = int(max(idx_i.max(), idx_j.max())) + 1
    cfg = SceneConfig(imshape=(H, W), n_imgs=n_imgs, n_edges=E,
                      if_use_mono=mono_depths is not None, **cfg_kw)
    as32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
    conf_i = as32(pred1["conf"]).reshape(E, A)
    conf_j = as32(pred2["conf"]).reshape(E, A)
    # per-image conf = max over incident edges (base_opt.py:169-175)
    im_conf = torch.zeros((n_imgs, A), device=dev)
    im_conf.scatter_reduce_(0, idx_i[:, None].expand(E, A), conf_i, "amax")
    im_conf.scatter_reduce_(0, idx_j[:, None].expand(E, A), conf_j, "amax")
    data = SceneData(
        ei=idx_i, ej=idx_j,
        pred_i=pts.reshape(E, A, 3),
        pred_j=as32(pred2["pts3d_in_other_view"]).reshape(E, A, 3),
        weight_i=conf_transform(conf_i, cfg.conf),
        weight_j=conf_transform(conf_j, cfg.conf),
        grid=xy_grid(W, H, device=dev).reshape(A, 2),
        base_pp=torch.tensor([W / 2, H / 2], dtype=torch.float32, device=dev),
        mono_depths=(as32(mono_depths).reshape(n_imgs, A)
                     if mono_depths is not None else None),
        im_conf=im_conf,
    )
    return cfg, data, init_params(cfg, seed=seed, device=dev)


def init_params(cfg: SceneConfig, seed: int = 0, device=None) -> Dict:
    """Random pose init (reference rand_pose = torch.randn), seeded."""
    H, W = cfg.imshape
    A = H * W
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)
    randn = lambda *s: torch.randn(*s, generator=gen).to(device)
    params = {
        "pw_poses": randn(cfg.n_edges, 8),
        "pw_adaptors": torch.zeros((cfg.n_edges, 2), device=device),
        "im_poses": randn(cfg.n_imgs, 7),
        "im_focals": torch.full((cfg.n_focals,),
                                cfg.focal_break * np.log(max(H, W)),
                                dtype=torch.float32, device=device),
        "im_pp": torch.zeros((cfg.n_imgs, 2), device=device),
    }
    if cfg.if_use_mono:
        params["scalemaps"] = torch.zeros((cfg.n_imgs, A), device=device)
        params["shifts"] = torch.zeros((cfg.n_imgs,), device=device)
    else:
        params["im_depthmaps"] = randn(cfg.n_imgs, A) / 10 - 3
    return params


def default_masks(cfg: SceneConfig, params: Dict) -> Dict:
    masks = {k: torch.ones_like(v) for k, v in params.items()}
    if not cfg.optimize_pp:
        masks["im_pp"] = torch.zeros_like(params["im_pp"])
    if not cfg.allow_pw_adaptors:
        masks["pw_adaptors"] = torch.zeros_like(params["pw_adaptors"])
    return masks


# ---------------------------------------------------------------- getters

def get_adaptors(params, cfg: SceneConfig):
    """Per-edge (x, y, z) scale adaptors, product-normalised."""
    a = params["pw_adaptors"]
    a = torch.cat([a[:, 0:1], a], dim=-1)
    if cfg.norm_pw_scale:
        a = a - a.mean(dim=1, keepdim=True)
    return torch.exp(a / cfg.pw_break)


def get_focals(params, cfg: SceneConfig):
    f = torch.exp(params["im_focals"] / cfg.focal_break)
    if cfg.shared_focal:
        f = f.expand(cfg.n_imgs)
    return f


def get_principal_points(params, data: SceneData):
    return data.base_pp[None] + 10 * params["im_pp"]


def get_im_poses(params):
    """(n, 4, 4) cam2world matrices."""
    return pose_vec_to_matrix(params["im_poses"])


def get_pw_poses(params, cfg: SceneConfig):
    return sim3_vec_to_matrix(params["pw_poses"], norm_scale=cfg.norm_pw_scale,
                              base_scale=cfg.base_scale)


def get_depthmaps_raw(params, data: SceneData, cfg: SceneConfig):
    if cfg.if_use_mono:
        return (data.mono_depths * torch.exp(params["scalemaps"])
                + params["shifts"][:, None])
    return torch.exp(params["im_depthmaps"])


def depth_to_pts3d(params, data: SceneData, cfg: SceneConfig):
    """(n, A, 3) world-frame points from per-pixel depths + poses."""
    depth = get_depthmaps_raw(params, data, cfg)
    focals = get_focals(params, cfg)[:, None, None]
    pp = get_principal_points(params, data)[:, None, :]
    rel = torch.cat([depth[..., None] * (data.grid[None] - pp) / focals,
                     depth[..., None]], dim=-1)
    return geotrf(get_im_poses(params), rel)


def depth_to_pts3d_packed(params, data: SceneData, cfg: SceneConfig):
    """The same world points channel-major, (n, 3, A) fp32, as K3/K4 read them."""
    depth = get_depthmaps_raw(params, data, cfg)
    f = get_focals(params, cfg)[:, None]
    pp = get_principal_points(params, data)
    g = data.grid
    relx = depth * (g[None, :, 0] - pp[:, 0:1]) / f
    rely = depth * (g[None, :, 1] - pp[:, 1:2]) / f
    P = get_im_poses(params)
    R, t = P[:, :3, :3], P[:, :3, 3]
    return torch.stack(
        [R[:, i, 0, None] * relx + R[:, i, 1, None] * rely
         + R[:, i, 2, None] * depth + t[:, i, None] for i in range(3)], dim=1)


def get_intrinsics(params, data: SceneData, cfg: SceneConfig):
    """(n, 3, 3) K matrices."""
    f = get_focals(params, cfg)
    pp = get_principal_points(params, data)
    z = torch.zeros_like(f)
    o = torch.ones_like(f)
    row0 = torch.stack([f, z, pp[:, 0]], -1)
    row1 = torch.stack([z, f, pp[:, 1]], -1)
    row2 = torch.stack([z, z, o], -1)
    return torch.stack([row0, row1, row2], -2)


# ------------------------------------------------------------------ loss

def pairwise_pts_loss(params, data: SceneData, cfg: SceneConfig, step=0):
    """The per-edge L1 alignment loss (reference optimizer.py:223-241)."""
    if cfg.fast_solve:
        return _pairwise_pts_loss_fused(params, data, cfg)
    pw = get_pw_poses(params, cfg)
    adapt = get_adaptors(params, cfg)[:, None, :]
    proj = depth_to_pts3d(params, data, cfg)
    aligned_i = geotrf(pw, adapt * data.pred_i)
    aligned_j = geotrf(pw, adapt * data.pred_j)
    di = safe_norm(proj.index_select(0, data.ei) - aligned_i, dim=-1)
    dj = safe_norm(proj.index_select(0, data.ej) - aligned_j, dim=-1)
    A = data.grid.shape[0]
    total_i = data.ei.shape[0] * A
    total_j = data.ej.shape[0] * A
    return (di * data.weight_i).sum() / total_i + (dj * data.weight_j).sum() / total_j


def pack_scene(data: SceneData, cfg: SceneConfig,
               dtype=torch.bfloat16) -> SceneData:
    """One-time pack of the frozen observations for K3/K4, as the JAX "fast"
    pack (scene.py:416-455) builds it: each per-edge buffer is laid out
    channel-major in natural order, (E, 3, A) points in `dtype` and (E, A)
    weights with the 1/(E*A) normalisation divided in fp32 before the cast;
    then K5 assembles the 2E terms in image-sorted order (the stable argsort
    of [ei; ej], the order of JAX's image-chunked layout without its per-chunk
    padding). Consecutive terms then read the same proj row, and K4's CSR of
    terms by image walks contiguous ranges (its order is the identity).
    packed_perm maps each slot to its [i-terms; j-terms] term, for the pose
    gather in the loss."""
    return dataclasses.replace(data, **{k: v[0] for k, v in
                                        pack_observations([data], cfg.n_imgs, dtype).items()})


def pack_observations(datas, n_imgs: int, dtype=torch.bfloat16) -> Dict:
    """The packed fields of pack_scene for S same-shape scenes, each with a
    leading scene axis: pred (S, 2E, 3, A), w (S, 2E, A), idx / perm / order
    (S, 2E), offsets (S, n + 1). One K5 launch assembles every scene's pack
    from the S natural-order packs laid end to end (each scene's perm offset
    to its own rows)."""
    S = len(datas)
    E, A, _ = datas[0].pred_i.shape
    norm = float(E * A)
    dev = datas[0].pred_i.device

    def natural(name_p, name_w):
        pp = torch.empty((S * E, 3, A), dtype=dtype, device=dev)
        ww = torch.empty((S * E, A), dtype=dtype, device=dev)
        for z, d in enumerate(datas):
            pp[z * E:(z + 1) * E].copy_(getattr(d, name_p).transpose(1, 2))
            ww[z * E:(z + 1) * E] = (getattr(d, name_w) / norm).to(dtype)
        return pp, ww

    pred_i, w_i = natural("pred_i", "weight_i")
    pred_j, w_j = natural("pred_j", "weight_j")
    idx, perm, gperm, order, offsets = [], [], [], [], []
    for z, d in enumerate(datas):
        ij = np.concatenate([d.ei.cpu().numpy(), d.ej.cpu().numpy()])
        p = np.argsort(ij, kind="stable")
        # term t < E is row z E + t of the i-packs, else row z E + t - E of the j-packs
        gperm.append(np.where(p < E, z * E + p, S * E + z * E + p - E))
        o, off = term_csr(ij[p], n_imgs)
        idx.append(ij[p])
        perm.append(p)
        order.append(o.numpy())
        offsets.append(off.numpy())
    to_dev = lambda a, dt: torch.from_numpy(np.stack(a).astype(dt)).to(dev)
    pred, w = permute_packed(pred_i, pred_j, w_i, w_j,
                             torch.from_numpy(np.concatenate(gperm).astype(np.int32)).to(dev),
                             torch.ones(2 * S * E, dtype=torch.int32, device=dev))
    return {"packed_pred": pred.reshape(S, 2 * E, 3, A), "packed_w": w.reshape(S, 2 * E, A),
            "packed_idx": to_dev(idx, np.int32), "packed_perm": to_dev(perm, np.int64),
            "packed_order": to_dev(order, np.int32),
            "packed_offsets": to_dev(offsets, np.int32)}


def _pairwise_pts_loss_fused(params, data: SceneData, cfg: SceneConfig):
    """Same loss as `pairwise_pts_loss` through K3 (forward) and K4
    (backward) on the packed observations; fp32 arithmetic throughout."""
    pw = get_pw_poses(params, cfg)
    pw34 = fold_pose_adaptors(pw, get_adaptors(params, cfg))
    # pack order (JAX jnp.take(pw34, packed_perm), scene.py:562); autograd
    # scatters the gradient back to the two natural-order copies
    pw34 = torch.cat([pw34, pw34]).float().index_select(0, data.packed_perm)
    proj = depth_to_pts3d_packed(params, data, cfg)
    return edge_loss(proj, pw34, data.packed_pred, data.packed_w,
                     data.packed_idx, data.packed_order, data.packed_offsets)


# ---------------------------------------------------------------- the loop

def adam_init(params: Dict) -> Dict:
    return {"count": 0,
            "mu": {k: torch.zeros_like(v) for k, v in params.items()},
            "nu": {k: torch.zeros_like(v) for k, v in params.items()}}


def adam_update(grads: Dict, state: Dict, b1: float = 0.9, b2: float = 0.9,
                eps: float = 1e-8):
    """optax.scale_by_adam(b1, b2, eps) exactly: moments, bias correction
    1 - b^count in fp32, mu_hat / (sqrt(nu_hat) + eps). Returns (updates,
    new state); the caller scales by -lr."""
    count = state["count"] + 1
    mu = {k: (1 - b1) * g + b1 * state["mu"][k] for k, g in grads.items()}
    nu = {k: (1 - b2) * (g * g) + b2 * state["nu"][k] for k, g in grads.items()}
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)
    bc1 = (1 - f32(b1) ** count).item()
    bc2 = (1 - f32(b2) ** count).item()
    updates = {k: (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + eps) for k in grads}
    return updates, {"count": count, "mu": mu, "nu": nu}


def solve(params, masks, data: SceneData, lrs, cfg: SceneConfig,
          loss_fn=pairwise_pts_loss, step0: int = 0, opt_state=None):
    """Adam over `lrs` (one step each). step0 offsets the step index passed
    to loss_fn; opt_state None starts fresh moments, else continues them.
    loss_fn may return one loss or several (the batched solve's scenes,
    alignment/batched.py); the gradient is that of their sum. Returns
    (params, losses (len(lrs),) + the loss's shape, opt_state)."""
    if opt_state is None:
        opt_state = adam_init(params)
    keys = list(params)
    losses = []
    p = {k: v.detach() for k, v in params.items()}
    for i, lr in enumerate(np.asarray(lrs, np.float32)):
        leaves = {k: v.requires_grad_(True) for k, v in p.items()}
        loss = loss_fn(leaves, data, cfg, step0 + i)
        grads = torch.autograd.grad(loss if loss.ndim == 0 else loss.sum(),
                                    [leaves[k] for k in keys], allow_unused=True)
        grads = {k: (torch.zeros_like(p[k]) if g is None else g) * masks[k]
                 for k, g in zip(keys, grads)}
        updates, opt_state = adam_update(grads, opt_state)
        lr32 = float(lr)
        p = {k: (p[k].detach() + (-lr32) * updates[k]) for k in keys}
        losses.append(loss.detach())
    return p, torch.stack(losses), opt_state


def solve_phases(niter: int, cfg: SceneConfig, precision: str):
    """The solve's phases under `precision`: (first step, end, cfg, pack),
    pack the observations' pack dtype, or None for the plain fp32 loss.
    'mixed': the first 80% of the steps through the fused kernels on a bf16
    pack, the rest on an fp32 repack (the same Adam moments and step
    index); 'bf16' (or a cfg with fast_solve) all on the bf16 pack; 'fp32'
    the plain fp32 path (fast_solve off)."""
    if precision not in ("mixed", "bf16", "fp32"):
        raise ValueError(precision)
    fast = dataclasses.replace(cfg, fast_solve=True)
    if precision == "fp32":
        return [(0, niter, dataclasses.replace(cfg, fast_solve=False), None)]
    if precision == "bf16" or cfg.fast_solve:
        return [(0, niter, fast, torch.bfloat16)]
    k = int(niter * 0.8)
    if k == 0 or k == niter:
        return [(0, niter, cfg, None)]
    return [(0, k, fast, torch.bfloat16), (k, niter, fast, torch.float32)]


def solve_in_phases(params, masks, pack, lrs, phases, loss_fn=pairwise_pts_loss):
    """solve() through `phases` (solve_phases), continuing the Adam moments
    and the step index; pack(dtype) gives each phase's observations, the
    previous phase's dropped first. Returns (params, losses)."""
    st, parts = None, []
    for lo, hi, cfg, dtype in phases:
        data = None
        data = pack(dtype)
        params, losses, st = solve(params, masks, data, lrs[lo:hi], cfg, loss_fn,
                                   step0=lo, opt_state=st)
        parts.append(losses)
    return params, torch.cat(parts)


def global_alignment_loop(params, masks, data: SceneData, cfg: SceneConfig,
                          lr: float = 0.01, niter: int = 300,
                          schedule: str = "cosine", lr_min: float = 1e-6,
                          loss_fn=pairwise_pts_loss, precision: str = "mixed"):
    """The full Adam solve under `precision` (solve_phases). Returns
    (params, losses (niter,) tensor)."""
    phases = solve_phases(niter, cfg, precision)
    # the solve's fp32 products must stay fp32 (no TF32 on the card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def pack(dtype):
        if dtype is None or (dtype == torch.bfloat16 and data.packed_pred is not None):
            return data
        return pack_scene(dataclasses.replace(data, packed_pred=None, packed_w=None),
                          cfg, dtype=dtype)
    return solve_in_phases(params, masks, pack, schedule_array(schedule, niter, lr, lr_min),
                           phases, loss_fn)


# ------------------------------------------------- setting params (init)

def set_focal(params, cfg: SceneConfig, idx, focal):
    """Set log-focals at `idx`. Indices past the focal vector are dropped, as
    a JAX scatter drops them: with shared_focal only image 0's value lands."""
    f = torch.clamp(torch.as_tensor(np.asarray(focal), dtype=torch.float32), min=1e-4)
    vals = (cfg.focal_break * torch.log(f)).reshape(-1)
    idx = torch.as_tensor(np.asarray(idx)).reshape(-1)
    vals = vals.expand(idx.shape[0]) if vals.numel() == 1 else vals
    foc = params["im_focals"].clone()
    keep = idx < foc.shape[0]
    foc[idx[keep]] = vals[keep].to(foc.device)
    return dict(params, im_focals=foc)


def set_depthmap(params, idx, depth):
    """depth: (A,) for a scalar idx, or (len(idx), A)."""
    logd = torch.log(torch.clamp(torch.as_tensor(np.asarray(depth),
                                                 dtype=torch.float32), min=1e-8))
    d = params["im_depthmaps"].clone()
    d[torch.as_tensor(idx)] = logd.to(d.device)
    return dict(params, im_depthmaps=d)


# ------------------------------------------- preset / freeze (known values)

def _rows(t, idx, value):
    """t with rows `idx` set to `value`; indices past t's rows are dropped,
    as a JAX scatter drops them."""
    idx = torch.as_tensor(np.asarray(idx)).reshape(-1)
    value = torch.as_tensor(value, dtype=t.dtype, device=t.device)
    if value.ndim == t.ndim:
        value = value[idx < t.shape[0]]
    out = t.clone()
    out[idx[idx < t.shape[0]].to(t.device)] = value
    return out


def preset_pose(params, masks, idx, poses_c2w):
    """Set known cam2world poses and freeze them (JAX scene.py:708-714)."""
    vecs = matrix_to_pose_vec(torch.as_tensor(np.asarray(poses_c2w), dtype=torch.float32))
    return (dict(params, im_poses=_rows(params["im_poses"], idx, vecs)),
            dict(masks, im_poses=_rows(masks["im_poses"], idx, 0.0)))


def preset_focal(params, masks, cfg: SceneConfig, idx, focals):
    return (set_focal(params, cfg, idx, focals),
            dict(masks, im_focals=_rows(masks["im_focals"], idx, 0.0)))


def preset_principal_point(params, masks, data: SceneData, idx, pps):
    pp = torch.as_tensor(np.asarray(pps), dtype=torch.float32, device=data.base_pp.device)
    v = (pp - data.base_pp) / 10.0
    return (dict(params, im_pp=_rows(params["im_pp"], idx, v)),
            dict(masks, im_pp=_rows(masks["im_pp"], idx, 0.0)))


def preset_depthmap(params, masks, idx, depths):
    return (set_depthmap(params, idx, depths),
            dict(masks, im_depthmaps=_rows(masks["im_depthmaps"], idx, 0.0)))
