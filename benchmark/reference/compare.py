"""The numbers that decide `correct`: gaps between what the program produced
and what the reference computes from the same inputs. Every gap is a
relative one, so it reads alike at any scale of the scene; each is compared
with its limit in the cell's workload file.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def _f64(t):
    return torch.as_tensor(t).double()


def rel_rms(a, b):
    """||a - b|| / ||b||."""
    a, b = _f64(a), _f64(b).to(_f64(a).device)
    return float(torch.linalg.vector_norm(a - b) / torch.clamp(torch.linalg.vector_norm(b),
                                                                min=1e-300))


def point_rel(a, b):
    """Mean over points (last axis 3) of ||a - b|| / ||b||, the reference's
    norm floored at a millionth of its median."""
    a, b = _f64(a).reshape(-1, 3), _f64(b).reshape(-1, 3).to(_f64(a).device)
    nb = torch.linalg.vector_norm(b, dim=-1)
    floor = 1e-6 * torch.median(nb)
    return float((torch.linalg.vector_norm(a - b, dim=-1) / torch.clamp(nb, min=floor)).mean())


def prior_gaps(prog, ref, depthpro: bool):
    """prog, ref: {frame: (depth (H, W), focal)}. Each prior is compared in
    what its network computes: Depth Pro's depth as its inverse (the
    canonical inverse depth; where it nears 0 the depth's own relative gap
    grows without bound), with its focal; Depth Anything V2's as the depth
    itself (its head's ReLU output, which nears 0 where the inverse grows
    without bound; PERF.md)."""
    if depthpro:
        return {"prior_inv_depth": max(rel_rms(1.0 / _f64(prog[k][0]), 1.0 / _f64(ref[k][0]))
                                       for k in ref),
                "prior_focal": max(abs(prog[k][1] / ref[k][1] - 1.0) for k in ref)}
    return {"prior_depth": max(rel_rms(prog[k][0], ref[k][0]) for k in ref)}


def prior_diagnostics(prog, ref):
    """Read for PERF.md, not compared: the depth's own relative gap and its
    inverse's, the reference's least inverse depth, its least depth over
    its median, and the share of pixels whose inverse depth is under a
    twentieth of its median."""
    gaps, inv_gaps, least, least_d, low = [], [], [], [], []
    for k in ref:
        d = _f64(ref[k][0])
        inv = 1.0 / d
        gaps.append(rel_rms(prog[k][0], d))
        inv_gaps.append(rel_rms(1.0 / _f64(prog[k][0]), inv))
        least.append(float(inv.min()))
        least_d.append(float(d.min() / d.median()))
        low.append(float((inv < 0.05 * inv.median()).double().mean()))
    return {"depth": max(gaps), "inv_depth": max(inv_gaps), "least_inv_depth": min(least),
            "least_depth_rel": min(least_d), "low_inv_share": max(low)}


def head_xyz(pts):
    """The DPT head's raw point channels, recovered from its 'exp' output
    pts = xyz / |xyz| expm1(|xyz|): xyz = pts / |pts| log1p(|pts|)."""
    pts = _f64(pts)
    n = torch.linalg.vector_norm(pts, dim=-1, keepdim=True)
    return pts / torch.clamp(n, min=1e-300) * torch.log1p(n)


def engine_gaps(prog, ref, stated):
    """prog, ref, stated: {pair: {pts3d_1, conf_1, pts3d_2, conf_2}}, stated
    the reference at the configuration's own precisions. The points' gap is
    that of the heads' raw channels, over the stated precision's own gap on
    the same pair and view (a seeded network's sensitivity to rounding
    varies several-fold from seed to seed, and this ratio does not); the
    log-confidences' gap is their relative RMS. Each the largest over the
    sampled pairs and both views."""
    def ratio(p, v):
        r = head_xyz(ref[p][f"pts3d_{v}"])
        return (rel_rms(head_xyz(prog[p][f"pts3d_{v}"]), r)
                / max(rel_rms(head_xyz(stated[p][f"pts3d_{v}"]), r), 1e-300))
    conf = max(rel_rms(torch.log(_f64(prog[p][f"conf_{v}"])), torch.log(_f64(ref[p][f"conf_{v}"])))
               for p in ref for v in (1, 2))
    return {"engine_xyz_vs_stated": max(ratio(p, v) for p in ref for v in (1, 2)),
            "engine_conf": conf}


def _init_parts(params, solve_cfg):
    """An initialisation's state as what it stands for: depths, pairwise
    similarities (E, 3, 4), cam2world poses (n, 3, 4), focals."""
    from benchmark.reference import scene
    fb = solve_cfg["focal_break"]
    return {"depth": torch.exp(_f64(params["im_depthmaps"])),
            "pairwise": scene.sim3(params["pw_poses"].float(), solve_cfg["base_scale"])[:, :3],
            "pose": scene.pose_to_T(params["im_poses"].float())[:, :3],
            "focal": torch.exp(_f64(params["im_focals"]) / fb)}


def init_gaps(prog, ref, solve_cfg):
    """prog, ref: the parameters the initialisation hands the solve. The
    depths' and the pairwise similarities' relative RMS gaps, and the
    largest relative focal gap."""
    a, b = _init_parts(prog, solve_cfg), _init_parts(ref, solve_cfg)
    return {"init_depth": rel_rms(a["depth"], b["depth"]),
            "init_pairwise": rel_rms(a["pairwise"], b["pairwise"]),
            "init_focal": float(torch.abs(a["focal"] / b["focal"].to(a["focal"].device)
                                          - 1.0).max())}


def curve(losses, steps):
    """Each step's loss over the first step's: the shape of the descent,
    free of a constant scale of the loss (which Adam's steps ignore)."""
    losses = np.asarray(losses, np.float64)
    return losses[list(steps)] / losses[0]


def solve_gaps(prog, ref, steps, objective):
    """prog, ref: {losses: each step's, final: the parameters the solve
    returns}; objective(params): the reference's loss at a state. The
    largest relative gap between the two descents (`curve`) at the given
    early steps, before the rounding of the program's pack has spread
    through the seeded scene's flat directions (PERF.md; a solve of another
    length fails), and the gap between the program's last loss and the
    reference's loss at the state the program returns."""
    lp, lr = np.asarray(prog["losses"]), np.asarray(ref["losses"])
    if lp.shape != lr.shape or not np.isfinite(lp).all():
        return {"solve_curve": math.inf, "solve_loss_at_state": math.inf}
    return {"solve_curve": float(np.abs(curve(lp, steps) / curve(lr, steps) - 1.0).max()),
            "solve_loss_at_state": abs(float(lp[-1]) / objective(prog["final"]) - 1.0)}


# the steps at which the readings record the descents' gap
READ_STEPS = (1, 2, 3, 5, 8, 10, 15, 20, 30, 40, 50, 60, 80, 100, 120, 150, 180, 210, 239,
              240, 270, 299)


def solve_diagnostics(prog, ref, prog_init=None, ref_init=None, solve_cfg=None):
    """Read for PERF.md, not compared: the descents' gap at READ_STEPS, the
    loss's own gap there, the last loss's, and the final state's (the mean
    relative depth gap, the largest rotation between the two solves'
    cameras in rad, the largest focal ratio), and the initial poses' gap."""
    lp, lr = np.asarray(prog["losses"]), np.asarray(ref["losses"])
    steps = [k for k in READ_STEPS if k < len(lr)]
    out = {"curve_at": dict(zip(map(str, steps),
                                np.abs(curve(lp, steps) / curve(lr, steps) - 1.0).tolist())),
           "loss_at": dict(zip(map(str, [0] + steps),
                               np.abs(lp[[0] + steps] / lr[[0] + steps] - 1.0).tolist())),
           "loss_last": float(abs(lp[-1] / lr[-1] - 1.0))}
    Tp = _f64(prog["poses"])
    Tr = _f64(ref["poses"]).to(Tp.device)
    cos = ((torch.einsum("nij,nij->n", Tp[:, :3, :3], Tr[:, :3, :3]) - 1.0) / 2.0).clamp(-1, 1)
    dp = _f64(prog["depths"])
    dr = _f64(ref["depths"]).to(dp.device)
    out.update(depth=float((torch.abs(dp - dr) / torch.clamp(dr, min=1e-300)).mean()),
               pose_rot=float(torch.acos(cos).max()),
               focal=float(torch.abs(_f64(prog["focals"]) / _f64(ref["focals"]).to(Tp.device)
                                     - 1.0).max()))
    if prog_init is not None:
        a, b = _init_parts(prog_init, solve_cfg), _init_parts(ref_init, solve_cfg)
        out["init_pose"] = rel_rms(a["pose"], b["pose"])
    return out


def engine_diagnostics(prog, ref):
    """Other statistics of the engine's points, read for PERF.md: the raw
    channels' relative RMS gap (not over the stated precision's), the points'
    own, the median per-point relative gap and the mean one, each the
    largest over the sampled pairs and views."""
    med, mean, rms = [], [], []
    xyz = max(rel_rms(head_xyz(prog[p][f"pts3d_{v}"]), head_xyz(ref[p][f"pts3d_{v}"]))
              for p in ref for v in (1, 2))
    for p in ref:
        for v in (1, 2):
            a = _f64(prog[p][f"pts3d_{v}"]).reshape(-1, 3)
            b = _f64(ref[p][f"pts3d_{v}"]).reshape(-1, 3).to(a.device)
            nb = torch.linalg.vector_norm(b, dim=-1)
            med.append(float(torch.median(torch.linalg.vector_norm(a - b, dim=-1)
                                          / torch.clamp(nb, min=1e-300))))
            mean.append(point_rel(a, b))
            rms.append(rel_rms(a, b))
    return {"xyz": xyz, "pts3d_rms": max(rms), "pts3d_median": max(med),
            "pts3d_mean": max(mean)}
