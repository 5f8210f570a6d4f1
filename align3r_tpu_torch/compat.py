"""Reference-compatible API surface (port of align3r_tpu/compat.py).

The dust3r-style entry points keep their reference call shapes (view-dict
pairs in, prediction dicts out): `load_model`, `make_pairs`, `inference`,
`global_aligner` and the scene it returns, with its preset_* freezing,
getters and `clean_pointcloud`. Reference signatures: dust3r/inference.py:
55-78, dust3r/image_pairs.py:11, dust3r/cloud_opt/__init__.py:26-40,
dust3r/model.py:27-43.

Unlike the JAX facade, `Align3RModel.to(device)` really moves the model, and
the model goes to the card unless the caller asks for the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from align3r_tpu_torch.alignment import scene as S
from align3r_tpu_torch.alignment.clean import clean_pointcloud
from align3r_tpu_torch.alignment.flow import flow_forward
from align3r_tpu_torch.alignment.init_poses import mst_init, save_edge_score_heatmap
from align3r_tpu_torch.geometry.core import closed_form_pose_inverse
from align3r_tpu_torch.inference.engine import inference as _engine
from align3r_tpu_torch.inference.pairs import make_pairs as _make_pairs
from align3r_tpu_torch.models.align3r import Align3R
from align3r_tpu_torch.models.convert import load_torch_checkpoint
from align3r_tpu_torch.models.nn import device_or_raise


class Align3RModel:
    """The network module and the inference weights prepared from it, on
    one device (the reference's model object)."""

    def __init__(self, model: Align3R, device="cuda"):
        self.model = model
        self.cfg = model.cfg
        self._prepared = {}
        self.to(device)

    @classmethod
    def from_pretrained(cls, path_or_name, device="cuda"):
        sd, cfg = load_torch_checkpoint(path_or_name)
        dev = device_or_raise(device)
        with torch.device(dev):
            model = Align3R(cfg)
        model.load_state_dict(sd, strict=True)
        return cls(model, dev)

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def to(self, device=None):
        """Move the model (and drop the prepared weights) to `device`; None
        keeps it where it is."""
        if device is not None:
            self.model.to(device_or_raise(device))
            self._prepared = {}
        return self

    def prepared(self, dtype=torch.bfloat16, head_dtype=torch.float32):
        key = (dtype, head_dtype)
        if key not in self._prepared:
            self._prepared[key] = self.model.prepare(dtype, head_dtype, device=self.device)
        return self._prepared[key]


def load_model(model_path: str, device="cuda", verbose: bool = True) -> Align3RModel:
    """Reference dust3r.model.load_model signature."""
    if verbose:
        print("... loading model from", model_path)
    return Align3RModel.from_pretrained(model_path, device=device)


def make_pairs(imgs: Sequence[Dict], scene_graph="complete", prefilter=None,
               symmetrize=True) -> List[Tuple[Dict, Dict]]:
    """Reference signature: list of view dicts in, list of dict pairs out."""
    idx_pairs = _make_pairs(len(imgs), scene_graph, prefilter, symmetrize)
    return [(imgs[i], imgs[j]) for i, j in idx_pairs]


def inference(pairs: Sequence[Tuple[Dict, Dict]], model: Align3RModel,
              device=None, batch_size: int = 8, verbose: bool = True,
              dtype=torch.bfloat16, head_dtype=torch.float32, **engine_kw) -> Dict:
    """Reference dust3r.inference signature over view-dict pairs.

    Each view dict needs 'img' (1, H, W, 3) or (1, 3, H, W) in [-1, 1],
    'pred_depth' (1, H, W, 3) and 'idx'. Returns the reference output
    contract {view1, view2, pred1, pred2} (channel-last tensors on the
    model's device). The heads run in fp32, the reference's AMP rule, unless
    head_dtype says otherwise. `device` moves the model first."""
    model.to(device)
    views: Dict[int, Dict] = {}
    idx_pairs = []
    for v1, v2 in pairs:
        views[int(v1["idx"])] = v1
        views[int(v2["idx"])] = v2
        idx_pairs.append((int(v1["idx"]), int(v2["idx"])))
    order = sorted(views)
    remap = {k: i for i, k in enumerate(order)}
    idx_pairs = [(remap[i], remap[j]) for i, j in idx_pairs]

    def img_of(v):
        img = np.asarray(v["img"])
        if img.ndim == 4 and img.shape[1] == 3 and img.shape[-1] != 3:
            img = img.transpose(0, 2, 3, 1)  # NCHW -> NHWC
        return img[0]

    imgs = np.stack([img_of(views[k]) for k in order])
    priors = np.stack([np.asarray(views[k]["pred_depth"])[0] for k in order])
    out = _engine(idx_pairs, model.prepared(dtype, head_dtype), imgs, priors,
                  batch_size=batch_size, **engine_kw)
    inv = {i: k for k, i in remap.items()}
    out["view1"]["idx"] = np.asarray([inv[i] for i in out["view1"]["idx"]])
    out["view2"]["idx"] = np.asarray([inv[i] for i in out["view2"]["idx"]])
    return out


class GlobalAlignerMode:
    PointCloudOptimizer = "PointCloudOptimizer"
    ModularPointCloudOptimizer = "ModularPointCloudOptimizer"
    PairViewer = "PairViewer"


_SCENE_KEYS = {"shared_focal", "temporal_smoothing_weight", "translation_weight",
               "flow_loss_weight", "depth_regularize_weight", "min_conf_thr",
               "optimize_pp", "conf", "base_scale", "pw_break", "focal_break",
               "flow_loss_start_epoch", "flow_loss_thre", "num_total_iter"}


class _SceneWrapper:
    """Reference-scene-like facade over (cfg, data, params) and the solve,
    on the device of the output's tensors."""

    def __init__(self, output, mode, device=None, variant="flow", **kwargs):
        self._output = output
        self._variant = variant
        mono = kwargs.pop("mono_depths", None)
        if kwargs.pop("if_use_mono", False) and mono is not None:
            mono = np.stack([np.asarray(m).reshape(-1) for m in mono])
        else:
            mono = None
        cfg_kw = {k: v for k, v in kwargs.items() if k in _SCENE_KEYS}
        self.cfg, self.data, self.params = S.build_scene(output, cfg_kw=cfg_kw,
                                                         mono_depths=mono)
        self._mode = mode
        self._masks = None  # built lazily; preset_* freezes rows in it

    def _get_masks(self):
        if self._masks is None:
            self._masks = S.default_masks(self.cfg, self.params)
        return self._masks

    # ----- preset / freeze API: freezing is a row-level gradient mask, so
    # every scene is "modular"
    @staticmethod
    def _msk_indices(msk, n_values):
        """Reference _get_msk_indices (modular_optimizer.py:73-85): int
        scalars / int lists / int arrays ARE image indices; only BOOL masks
        go through np.where; msk=None means images 0..n-1."""
        if msk is None:
            return np.arange(n_values)
        if isinstance(msk, (int, np.integer)):
            return np.array([msk])
        msk = np.asarray(msk)
        if msk.dtype == bool:
            return np.where(msk)[0][:n_values]
        if np.issubdtype(msk.dtype, np.integer):
            return msk[:n_values]
        raise TypeError(f"bad mask dtype {msk.dtype!r} (bool or int)")

    def preset_pose(self, known_poses, pose_msk=None):
        poses = np.asarray(known_poses, np.float32)
        self.params, self._masks = S.preset_pose(
            self.params, self._get_masks(), self._msk_indices(pose_msk, len(poses)), poses)

    def preset_focal(self, known_focals, msk=None):
        f = np.asarray(known_focals, np.float32).reshape(-1)
        self.params, self._masks = S.preset_focal(
            self.params, self._get_masks(), self.cfg, self._msk_indices(msk, len(f)), f)

    def preset_principal_point(self, known_pp, msk=None):
        pp = np.asarray(known_pp, np.float32)
        self.params, self._masks = S.preset_principal_point(
            self.params, self._get_masks(), self.data, self._msk_indices(msk, len(pp)), pp)

    def preset_depthmap(self, known_depthmaps, msk=None):
        d = np.stack([np.asarray(m).reshape(-1) for m in known_depthmaps])
        self.params, self._masks = S.preset_depthmap(
            self.params, self._get_masks(), self._msk_indices(msk, len(d)), d)

    def compute_global_alignment(self, init=None, niter=300, schedule="cosine",
                                 lr=0.01, init_priors=None,
                                 save_score_path=None, save_score_only=False,
                                 **kw):
        conf_i, conf_j = self._output["pred1"]["conf"], self._output["pred2"]["conf"]
        if save_score_path is not None:
            # reference cloud_opt_flow/base_opt.py:460-466: dump the MST
            # edge-score heatmap; save_score_only skips the whole solve
            save_edge_score_heatmap(save_score_path, self.data, self.cfg, conf_i, conf_j)
            if save_score_only:
                return None
        if init in ("mst", "msp"):
            self.params = mst_init(self.params, self.data, self.cfg, conf_i, conf_j,
                                   init_priors=init_priors)
        # init="known_poses": poses were provided via preset_pose
        loss_fn = flow_forward if self._variant == "flow" else S.pairwise_pts_loss
        self.params, losses = S.global_alignment_loop(
            self.params, self._get_masks(), self.data, self.cfg, lr=lr, niter=niter,
            schedule=schedule, loss_fn=loss_fn)
        self.params = {k: v.detach() for k, v in self.params.items()}
        return float(losses[-1])

    # ----- getters matching the reference scene API
    def _host(self, t):
        return t.detach().cpu().numpy()

    def get_im_poses(self):
        return self._host(S.get_im_poses(self.params))

    def get_depthmaps(self, raw=False):
        H, W = self.cfg.imshape
        d = self._host(S.get_depthmaps_raw(self.params, self.data, self.cfg))
        return d if raw else list(d.reshape(self.cfg.n_imgs, H, W))

    def get_pts3d(self, raw=False):
        H, W = self.cfg.imshape
        p = self._host(S.depth_to_pts3d(self.params, self.data, self.cfg))
        return p if raw else list(p.reshape(self.cfg.n_imgs, H, W, 3))

    def get_focals(self):
        return self._host(S.get_focals(self.params, self.cfg))

    def get_intrinsics(self):
        return self._host(S.get_intrinsics(self.params, self.data, self.cfg))

    def get_masks(self):
        H, W = self.cfg.imshape
        conf = self._host(self.data.im_conf).reshape(self.cfg.n_imgs, H, W)
        return [c > self.cfg.min_conf_thr for c in conf]

    def clean_pointcloud(self, **kw):
        n, (H, W) = self.cfg.n_imgs, self.cfg.imshape
        dev = self.data.im_conf.device
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)
        poses = S.get_im_poses(self.params).detach()
        new = clean_pointcloud(self.data.im_conf.reshape(n, H, W),
                               t(self.get_intrinsics()), closed_form_pose_inverse(poses),
                               t(np.stack(self.get_depthmaps())),
                               t(np.stack(self.get_pts3d())), **kw)
        self.data = dataclasses.replace(self.data, im_conf=new.reshape(n, -1))
        return self


def global_aligner(dust3r_output, *args, device=None,
                   mode=GlobalAlignerMode.PointCloudOptimizer, **kwargs):
    """BOTH reference factory signatures, distinguished positionally:

    - flow variant  (cloud_opt_flow/__init__.py:20):
        global_aligner(output, device, mode=..., **optim_kw)
    - prior variant (cloud_opt/__init__.py:26):
        global_aligner(output, if_use_mono, mono_depths, device, mode=...,
                       **optim_kw)

    A bool second positional argument selects the prior-variant binding
    (if_use_mono); anything else binds as `device` (flow variant). The scene
    lives where the output's tensors are."""
    variant = kwargs.pop("variant", None)
    if args and isinstance(args[0], (bool, np.bool_)):
        kwargs["if_use_mono"] = bool(args[0])
        if len(args) > 1:
            kwargs.setdefault("mono_depths", args[1])
        if len(args) > 2:
            device = args[2]
        if len(args) > 3:
            mode = args[3]
        variant = variant or "prior"
    else:
        if len(args) > 0:
            device = args[0]
        if len(args) > 1:
            mode = args[1]
        variant = variant or "flow"
    if kwargs.pop("if_use_mono_env", False):
        variant = "prior"
    return _SceneWrapper(dust3r_output, mode, device, variant=variant, **kwargs)
