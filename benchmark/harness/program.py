"""The system under test, `align3r_tpu_torch`, driven as its depth tools
drive it, with the benchmark's spans around each call into a layer.

A video goes through:
1. the prior (`tools/prior_depth.py`'s path, at its batch of 4): Depth Pro
   on the frame resized to its 1536 x 1536 input, metric depth and focal by
   `postprocess_depth`, or Depth Anything V2 on `preprocess`'s 518-short-side
   input with the pseudo-focal 200; the depth resized back to the frame
   (`models.nn.resize`), unprojected by `geometry.core.pixel_to_pointcloud`;
2. the loader (`inference/images.py`): `crop_img` at the network size and
   `normalize_img`, on the host;
3. either `pipeline.reconstruct_scene` as `tools/depth_test.py` calls it
   (the complete graph, `variant="prior"`, cosine schedule, `conf_clamp`,
   `min_conf_thr`), or `inference.engine.inference` alone over the same
   graph.

The spans of the engine, the initialisation and the solve inside
`reconstruct_scene` come from thin wrappers that the benchmark installs on
the pipeline module's own names (`inference`, `mst_init`,
`global_alignment_loop`): each passes the call through unchanged and
records its host interval, which ends in a synchronise. The engine's
wrapper also keeps the outputs the correctness check samples, the solve's
the state the initialisation handed it.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import weights as W
from benchmark.reference import align3r as ref_align3r
from benchmark.reference import priors as ref_priors


# the initialisation's parameters that the check compares
INIT_KEYS = ("pw_poses", "im_poses", "im_focals", "im_depthmaps")


class Spans:
    """Host intervals (name, start, end, video) on the perf_counter clock."""

    def __init__(self):
        self.items = []
        self.video = None

    def add(self, name, t0, t1):
        self.items.append((name, t0, t1, self.video))

    def wrap(self, name, fn, dev, before=None, after=None):
        """fn with its interval recorded under `name`: the interval ends once
        the device has finished the work fn queued; `before` and `after`
        (the check's keeping) run outside it."""
        def call(*a, **k):
            if before is not None:
                before(a, k)
            t0 = time.perf_counter()
            out = fn(*a, **k)
            sync(dev)
            t1 = time.perf_counter()
            if after is not None:
                after(out, a, k)
            self.add(name, t0, t1)
            return out
        return call


def sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


class Program:
    """The port built from a configuration file, with weights drawn from
    `seed` on `device`."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from align3r_tpu_torch import pipeline
        from align3r_tpu_torch.models.align3r import Align3R
        from align3r_tpu_torch.models.config import parse_model_string

        self.cfg, self.traffic, self.dev = cfg, traffic, torch.device(device)
        self.spans = Spans()
        self.capture = None            # set by the harness for the checked video
        with torch.device("meta"):
            net = Align3R(parse_model_string(cfg["model"]))
        W.load(net, W.make_state(ref_align3r.build(cfg["network"]), "align3r", seed, self.dev))
        self.model = net.prepare(dtype=torch.bfloat16, head_dtype=torch.float32, device=self.dev)
        del net
        self.prior_kind = cfg["prior"]["kind"]
        self.prior, self.prior_cfg = self._build_prior(cfg["prior"], seed)
        self._pipeline = pipeline
        self._originals = {k: getattr(pipeline, k) for k in
                           ("inference", "mst_init", "global_alignment_loop")}
        pipeline.inference = self.spans.wrap("engine", self._originals["inference"], self.dev,
                                             after=self._keep_engine)
        pipeline.mst_init = self.spans.wrap("init", self._originals["mst_init"], self.dev)
        pipeline.global_alignment_loop = self.spans.wrap(
            "solve", self._originals["global_alignment_loop"], self.dev, before=self._keep_init)
        from align3r_tpu_torch.alignment import init_poses
        self._init_poses = init_poses
        self._ransac_pnp = init_poses.ransac_pnp
        init_poses.ransac_pnp = self._keep_pnp
        sync(self.dev)

    def _build_prior(self, pc: dict, seed: int):
        from align3r_tpu_torch.models import depth_anything as da
        from align3r_tpu_torch.models import depth_pro as dp
        state = W.make_state(ref_priors.build(pc), "prior", seed, self.dev)
        with torch.device("meta"):
            if self.prior_kind == "depthpro":
                pcfg = dp.config_from_hf_depth_pro(pc)
                m = dp.DepthPro(pcfg)
            else:
                pcfg = da.config_from_hf(pc)
                m = da.DepthAnything(pcfg)
        return W.load(m, state), pcfg

    def close(self):
        """Give the pipeline its own functions back and drop the weights."""
        for k, f in self._originals.items():
            setattr(self._pipeline, k, f)
        self._init_poses.ransac_pnp = self._ransac_pnp
        self.model = self.prior = None

    # ------------------------------------------------------------ layers
    @torch.inference_mode()
    def prior_batch(self, frames_u8):
        """Depth (B, H, W) at the frames' size and focal (B,) in pixels."""
        from align3r_tpu_torch.models import nn as L
        from align3r_tpu_torch.models.depth_anything import preprocess
        from align3r_tpu_torch.models.depth_pro import postprocess_depth
        from align3r_tpu_torch.models.raft import exact_fp32
        exact_fp32()
        x01 = torch.from_numpy(frames_u8).to(self.dev).float() / 255.0
        B, H, W_, _ = x01.shape
        if self.prior_kind == "depthpro":
            S = self.prior_cfg.image_size
            depth, focals = postprocess_depth(
                *self.prior((L.resize(x01, S, S, "bilinear") - 0.5) / 0.5), S)
            focals = focals * W_ / depth.shape[-1]
        else:
            pc = self.cfg["prior"]
            depth = self.prior(preprocess(x01, self.prior_cfg, pc["input_short_side"]))
            focals = torch.full((B,), float(pc["pseudo_focal"]), device=self.dev)
        return L.resize(depth, H, W_, "bilinear"), focals

    def run_video(self, frames_u8: np.ndarray, index: int) -> dict:
        """One request: a whole video through the path. Returns its record."""
        from align3r_tpu_torch.geometry.core import pixel_to_pointcloud
        from align3r_tpu_torch.inference.images import crop_img, normalize_img
        from align3r_tpu_torch.inference.pairs import make_pairs
        tr, sp = self.traffic, self.spans
        sp.video = index
        cap = self.capture if self.capture is not None and self.capture["video"] == index else None
        t_start = time.perf_counter()
        n = frames_u8.shape[0]
        clouds = []
        for s in range(0, n, tr["prior_batch"]):
            t0 = time.perf_counter()
            depth, focals = self.prior_batch(frames_u8[s:s + tr["prior_batch"]])
            with torch.inference_mode():
                clouds += [pixel_to_pointcloud(depth[k], focals[k]) for k in range(depth.shape[0])]
            if cap is not None:
                for k in range(depth.shape[0]):
                    if s + k in cap["frames"]:
                        cap["prior"][s + k] = (depth[k].clone(), float(focals[k]))
            sync(self.dev)
            sp.add("prior", t0, time.perf_counter())
        t0 = time.perf_counter()
        clouds = torch.stack(clouds).cpu().numpy()
        views = [crop_img(frames_u8[k], tr["image_size"], clouds[k]) for k in range(n)]
        imgs = np.stack([normalize_img(v[0]) for v in views])
        priors = np.stack([np.asarray(v[1], np.float32) for v in views])
        sp.add("loader", t0, time.perf_counter())
        pairs = make_pairs(n, tr["scene_graph"], symmetrize=tr["symmetrize"])
        self._engine_cap = cap
        rec = {"index": index, "frames": n, "pairs": len(pairs), "timings": {}}
        if tr.get("solve"):
            from align3r_tpu_torch.pipeline import reconstruct_scene
            so = tr["solve"]
            res = reconstruct_scene(
                imgs, priors, self.model, scene_graph=tr["scene_graph"],
                symmetrize=tr["symmetrize"], batch_size=tr["engine_batch"],
                variant=so["variant"], niter=so["niter"], lr=so["lr"], schedule=so["schedule"],
                conf_clamp=so["conf_clamp"], scene_kw=dict(min_conf_thr=so["min_conf_thr"]))
            rec["timings"] = dict(res.timings)
            if cap is not None:
                cap["scene"] = {"depths": res.get_depthmaps(), "poses": res.get_im_poses(),
                                "focals": res.get_focals(),
                                "final": {k: res.params[k] for k in INIT_KEYS},
                                "losses": np.asarray(res.losses, np.float64),
                                "hw": tuple(res.cfg.imshape), "pairs": pairs}
        else:
            self._pipeline.inference(pairs, self.model, imgs, priors,
                                     batch_size=tr["engine_batch"])
            sync(self.dev)
        self._engine_cap = None
        rec["t0"], rec["t1"] = t_start, time.perf_counter()
        sp.add("video", t_start, rec["t1"])
        return rec

    def _keep_pnp(self, *args, **kwargs):
        """`init_poses.ransac_pnp` as it is, keeping the checked video's
        problems' focals and results: the reference follows them (PERF.md)."""
        res = self._ransac_pnp(*args, **kwargs)
        cap = getattr(self, "_engine_cap", None)
        if cap is not None:
            cap["pnp"] = {"focals": [list(map(float, f)) for f in args[3]],
                          "results": [None if r is None else (float(r[0]), r[1].double().cpu())
                                      for r in res]}
        return res

    def _keep_init(self, args, kwargs):
        """The checked video's state as the initialisation hands it to the
        solve."""
        cap = getattr(self, "_engine_cap", None)
        if cap is not None:
            cap["init"] = {k: args[0][k].detach().clone() for k in INIT_KEYS}

    def _keep_engine(self, out, args, kwargs):
        cap = getattr(self, "_engine_cap", None)
        if cap is None:
            return
        pairs = list(map(tuple, args[0]))
        cap["engine"] = {p: {"pts3d_1": out["pred1"]["pts3d"][pairs.index(p)].clone(),
                             "conf_1": out["pred1"]["conf"][pairs.index(p)].clone(),
                             "pts3d_2": out["pred2"]["pts3d_in_other_view"][pairs.index(p)].clone(),
                             "conf_2": out["pred2"]["conf"][pairs.index(p)].clone()}
                         for p in cap["pairs"]}
        if self.traffic.get("solve"):
            # the raw output the solve starts from (reconstruct_scene then
            # replaces the conf entries with clamped copies)
            cap["raw"] = {"pred_i": out["pred1"]["pts3d"], "pred_j": out["pred2"]["pts3d_in_other_view"],
                          "conf_i": out["pred1"]["conf"], "conf_j": out["pred2"]["conf"]}
