"""The correctness check of a run: what the timed path produced, against the
plain reference on the same generated inputs.

Before the window, a plan drawn from the seed names the checked video, the
frames of it whose priors are compared and the pairs among those frames
whose engine outputs are compared; the program keeps those outputs as it
produces them. After the window, with the program's state freed, the
reference recomputes them from the frames: the prior on the sampled frames,
their point clouds and network views, the network on the sampled pairs (in
float32, and at the configuration's stated precisions for the engine's
points, whose gap is read against that one's). Where the cell solves, the
reference's initialisation and solve start from the engine output the
program's solve started from (the stage before is checked on its own
pairs) and take the program's PnP poses (`follow_pnp`, checked rigid); the
state the reference's initialisation reaches is compared with the one the
program's hands its solve, and the reference's descent with the program's
at the workload's early steps.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.harness import weights as W
from benchmark.reference import align3r as ref_align3r
from benchmark.reference import common as C
from benchmark.reference import compare
from benchmark.reference import loader as ref_loader
from benchmark.reference import priors as ref_priors
from benchmark.reference import scene as ref_scene


def plan(seed: int, traffic: dict, check: dict) -> dict:
    """The checked video, frames and ordered pairs, drawn from the seed."""
    rng = C.seeded(seed, 11)
    n = traffic["frames"]
    frames = sorted(int(f) for f in rng.choice(n, check["frames"], replace=False))
    ordered = [(i, j) for i in frames for j in frames if i != j]
    pick = rng.choice(len(ordered), check["pairs"], replace=False)
    return {"video": int(rng.integers(check["videos"])), "frames": frames,
            "pairs": [ordered[k] for k in sorted(pick)], "prior": {},
            "solve_steps": check.get("solve_steps")}


@torch.no_grad()
def reference(cfg: dict, traffic: dict, seed: int, frames_u8: np.ndarray, cap: dict,
              device, P: C.Precision) -> dict:
    """The reference's outputs for the captured sample (see the module
    docstring)."""
    C.exact_fp32()
    out = {}
    fr = cap["frames"]
    H, W_ = frames_u8.shape[1:3]
    x01 = torch.from_numpy(frames_u8[fr]).to(device).float() / 255.0
    pc = cfg["prior"]
    prior = ref_priors.build(pc)
    W.load(prior, W.make_state(prior, "prior", seed, device))
    if pc["kind"] == "depthpro":
        d, f = prior.depth_focal(P, x01)
        f = f * W_ / d.shape[-1]
    else:
        d = prior.depth(P, x01)
        f = torch.full((len(fr),), float(pc["pseudo_focal"]), device=device)
    d = C.jax_resize(d, H, W_, "bilinear")
    out["prior"] = {k: (d[n], float(f[n])) for n, k in enumerate(fr)}
    del prior
    net = ref_align3r.build(cfg["network"])
    W.load(net, W.make_state(net, "align3r", seed, device))
    views = [ref_loader.network_view(frames_u8[k],
                                     ref_loader.depth_to_cloud(d[n], f[n]).cpu().numpy(),
                                     traffic["image_size"]) for n, k in enumerate(fr)]
    imgs = torch.from_numpy(np.stack([v[0] for v in views])).to(device)
    clouds = torch.from_numpy(np.stack([v[1] for v in views])).to(device)
    ii = torch.tensor([fr.index(i) for i, _ in cap["pairs"]], device=device)
    jj = torch.tensor([fr.index(j) for _, j in cap["pairs"]], device=device)

    def engine(Pe):
        r1, r2 = net.pairs(Pe, net.encode(Pe, imgs), clouds, ii, jj, imgs.shape[1:3])
        return {p: {"pts3d_1": r1["pts3d"][k], "conf_1": r1["conf"][k],
                    "pts3d_2": r2["pts3d_in_other_view"][k], "conf_2": r2["conf"][k]}
                for k, p in enumerate(cap["pairs"])}

    out["engine"] = engine(P)
    if P.mode == "reference":
        out["engine_stated"] = engine(C.Precision("stated", cfg["precision"]))
    del net
    if traffic.get("solve"):
        sc, raw = cap["scene"], cap["raw"]
        scfg = dict(cfg["solve"], **traffic["solve"])
        r = ref_scene.run(raw["pred_i"], raw["pred_j"], raw["conf_i"], raw["conf_j"],
                          sc["pairs"], frames_u8.shape[0], sc["hw"], scfg, P,
                          follow_pnp(cap.get("pnp"), exact=P.mode == "reference"))
        out["scene"] = dict(r, losses=r["losses"].double().cpu().numpy())
        out["init"] = r["init"]
        out["pnp_problems"] = r.pop("pnp")
        if P.mode == "reference":
            out["objective"] = ref_scene.objective(raw["pred_i"], raw["pred_j"], raw["conf_i"],
                                                   raw["conf_j"], sc["pairs"], sc["hw"], scfg)
    return out


def follow_pnp(kept, exact=True):
    """The program's PnP results for the reference's initialisation, which
    has no RANSAC-PnP of its own: a frame whose focal is within the RANSAC
    tolerance gets no pose (the port's rule too); above it the program's
    pose, where the program asked for the same frames at the same focal
    (`exact`; the control, whose focals are its own, takes the program's
    pose as it is), each pose checked to be a rigid transform."""
    def pnp(frames, focals):
        if kept is None or len(kept["results"]) != len(frames):
            raise NotImplementedError("the program's PnP call was not kept for these frames")
        out = []
        for f, asked, r in zip(focals, kept["focals"], kept["results"]):
            if f <= ref_scene.PNP_TOLERANCE_PX:
                if r is not None and exact:
                    raise ValueError(f"a pose at a focal of {f} px, within the RANSAC tolerance")
                out.append(None)
                continue
            if exact and asked != [f] and not (len(asked) == 1 and abs(asked[0] / f - 1.0) <= 1e-5):
                raise NotImplementedError(f"the program asked PnP at {asked}, the reference at {f}")
            if r is None:
                out.append(None)
                continue
            R = r[1][:3, :3]
            rigid = torch.allclose(R @ R.T, torch.eye(3, dtype=R.dtype), atol=1e-6) and \
                abs(float(torch.linalg.det(R)) - 1.0) <= 1e-6
            if not rigid or not torch.equal(r[1][3], torch.tensor([0.0, 0, 0, 1], dtype=R.dtype)):
                raise ValueError("the program's PnP returned a pose that is not rigid")
            out.append(r)
        return out
    return pnp


def gaps(cfg, traffic, check, prog: dict, ref: dict) -> dict:
    g = compare.prior_gaps(prog["prior"], ref["prior"], cfg["prior"]["kind"] == "depthpro")
    g.update(compare.engine_gaps(prog["engine"], ref["engine"], ref["engine_stated"]))
    if traffic.get("solve"):
        g.update(compare.init_gaps(prog["init"], ref["init"], cfg["solve"]))
        g.update(compare.solve_gaps(prog["scene"], ref["scene"], check["solve_steps"],
                                     ref["objective"]))
    return g


def verdict(g: dict, limits: dict):
    """(correct, [(name, value, limit)]): every gap finite and within its
    limit; a gap without a limit fails."""
    rows = [(k, v, limits.get(k)) for k, v in g.items()]
    ok = all(lim is not None and math.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows
