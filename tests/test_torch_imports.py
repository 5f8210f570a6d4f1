"""The port stands alone: importing every module of align3r_tpu_torch
brings neither jax nor any module of the JAX package into the process, nor
transformers, safetensors or huggingface_hub (the card has none of them;
the port reads Hugging Face folders itself), nor PIL or cv2 (imported only
inside the functions that need them), and the port's own copies of the JAX package's jax-free modules
(models/config.py, inference/pairs.py) agree with them."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from align3r_tpu.inference import pairs as jpairs
from align3r_tpu.models import config as jconfig
from align3r_tpu_torch.inference import pairs as tpairs
from align3r_tpu_torch.models import config as tconfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


FORBIDDEN = ("jax", "align3r_tpu", "transformers", "safetensors", "huggingface_hub", "PIL",
             "cv2")


def test_every_port_module_imports_without_jax_or_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import align3r_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "print(' '.join(names))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    names = set(res.stdout.split())
    assert len(names) >= 60                    # every module was reached
    assert {f"align3r_tpu_torch.{m}" for m in (
        "geometry.warping", "alignment.flow", "alignment.pair_viewer", "models.raft",
        "models.raft1", "ops.edge_loss", "pipeline", "inference.images", "eval.viz",
        "eval.trajectory", "eval.html_viewer", "eval.glb", "alignment.clean", "compat",
        "utils.png", "utils.sintel_io", "tools.demo", "utils.hf_weights", "utils.pfm",
        "models.depth_anything", "models.depth_pro", "models.prompt_da", "eval.depth_metrics",
        "eval.metadata", "tools.prior_depth", "tools.demo_refine", "tools.metric",
        "tools.depth_test", "tools.pose_test", "models.sam2", "models.sam2_video",
        "models.sam2_refine", "utils.jpeg", "training.data.base", "training.data.cropping",
        "training.data.datasets", "tools.train", "alignment.batched", "models.linear_head",
        "parallel.mesh", "tools.dist_smoke", "tools.serve_scene", "parallel.shardings",
        "tools.tp_drift", "alignment.pnp", "tools.profile_pnp")} <= names


MODEL_STRINGS = [
    # the reference fine-tune recipe (train.sh:8)
    "AsymmetricCroCo3DStereo(pos_embed='RoPE100', patch_embed_cls='ManyAR_PatchEmbed', "
    "img_size=(512, 288), head_type='dpt', output_mode='pts3d', depth_mode=('exp', -inf, inf), "
    "conf_mode=('exp', 1, inf), enc_embed_dim=1024, enc_depth=24, enc_num_heads=16, "
    "dec_embed_dim=768, dec_depth=12, dec_num_heads=12)",
    "AsymmetricCroCo3DStereo(img_size=512, pos_embed='cosine', head_type='linear', "
    "landscape_only=False, mlp_ratio=2.0)",
    "AsymmetricCroCo3DStereo(pos_embed='RoPE10', enc_embed_dim=64, enc_depth=2, "
    "enc_num_heads=4, dec_embed_dim=48, dec_depth=8, dec_num_heads=4)",
]


@pytest.mark.parametrize("s", MODEL_STRINGS)
def test_parse_model_string_matches_jax(s):
    assert (dataclasses.asdict(tconfig.parse_model_string(s))
            == dataclasses.asdict(jconfig.parse_model_string(s)))


def test_configs_match_jax():
    for name in ("VIT_L_512", "TINY_TEST"):
        t, j = getattr(tconfig, name), getattr(jconfig, name)
        assert dataclasses.asdict(t) == dataclasses.asdict(j), name
        assert (t.n_pc_blocks, t.dpt_hooks(), t.dpt_dim_tokens(), t.head_dim) == \
            (j.n_pc_blocks, j.dpt_hooks(), j.dpt_dim_tokens(), j.head_dim)


GRAPHS = ["complete", "swin", "swin-3", "swin-3-noncyclic", "swin-5-noncyclic",
          "swinstride-5-noncyclic", "swinstride-2", "swin2stride-2", "logwin",
          "logwin-3", "logwin-2-noncyclic", "oneref", "oneref-4"]


@pytest.mark.parametrize("graph", GRAPHS)
def test_make_pairs_matches_jax(graph):
    for n in (2, 7, 24):
        for sym in (True, False):
            for pre in (None, "seq2", "cyc3"):
                got = tpairs.make_pairs(n, graph, prefilter=pre, symmetrize=sym)
                assert got == jpairs.make_pairs(n, graph, prefilter=pre,
                                                symmetrize=sym), (n, sym, pre)
                assert tpairs.is_symmetrized(got) == jpairs.is_symmetrized(got)
    with pytest.raises(ValueError):
        tpairs.make_pairs(4, "bogus")


def test_hierarchical_pairs_and_edge_filter_match_jax():
    for n, clip in ((23, 10), (30, 5), (4, 10)):
        assert tpairs.hierarchical_pairs(n, clip) == jpairs.hierarchical_pairs(n, clip)
    pairs = tpairs.make_pairs(9, "complete")
    E = len(pairs)
    r = np.random.default_rng(0)
    out = {"view1": {"idx": np.array([p[0] for p in pairs]), "instance": "x"},
           "view2": {"idx": np.array([p[1] for p in pairs])},
           "pred1": {"pts3d": r.standard_normal((E, 4, 5, 3)).astype(np.float32)},
           "pred2": {"conf": r.standard_normal((E, 4, 5)).astype(np.float32)}}
    for cyclic in (False, True):
        ref = jpairs.filter_output_edges_seq(out, 3, cyclic)
        got = tpairs.filter_output_edges_seq(
            {**out, "pred1": {"pts3d": torch.from_numpy(out["pred1"]["pts3d"])}},
            3, cyclic)
        np.testing.assert_array_equal(got["view1"]["idx"], ref["view1"]["idx"])
        np.testing.assert_array_equal(got["pred1"]["pts3d"].numpy(),
                                      np.asarray(ref["pred1"]["pts3d"]))
        np.testing.assert_array_equal(got["pred2"]["conf"], np.asarray(ref["pred2"]["conf"]))
        assert got["view1"]["instance"] == "x"
