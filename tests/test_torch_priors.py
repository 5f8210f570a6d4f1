"""The port's monocular priors against the JAX package, on the CPU: Depth
Anything V2 (native and interpolated patch grid), Depth Pro (depth and
field of view) and PromptDA (with and without a prompt) at the JAX tests'
tiny HF configs, both sides built from one state dict that
`utils.hf_weights` reads from a transformers `save_pretrained` folder; the
JAX parameter tree loaded into the port's module gives the same bits as the
HF state dict; the jax.image.resize-equivalent resampler (bicubic with
a = -0.5, antialiased shrinking) against jax.image.resize; and the
safetensors reader and writer against the safetensors package."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from align3r_tpu.models import depth_anything as jda
from align3r_tpu.models import depth_pro as jdp
from align3r_tpu.models import prompt_da as jpda
from align3r_tpu_torch.models import depth_anything as tda
from align3r_tpu_torch.models import depth_pro as tdp
from align3r_tpu_torch.models import nn as L
from align3r_tpu_torch.models import prompt_da as tpda
from align3r_tpu_torch.utils import hf_weights

torch.set_num_threads(2)
TOL = 1e-4   # of the largest reference value: fp32 on both sides, sums in other orders


def _numpy(sd):
    return {k: v.float().numpy() if v.is_floating_point() else v.numpy() for k, v in sd.items()}


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


def _dinov2(**kw):
    from transformers import Dinov2Config
    return Dinov2Config(hidden_size=32, num_attention_heads=4, intermediate_size=64, **kw)


def _da_hf_config(prompt: bool):
    from transformers import DepthAnythingConfig, PromptDepthAnythingConfig
    bc = _dinov2(num_hidden_layers=4, patch_size=14, image_size=70,
                 out_features=["stage1", "stage2", "stage3", "stage4"],
                 apply_layernorm=True, reshape_hidden_states=False)
    kw = dict(backbone_config=bc, patch_size=14, reassemble_factors=[4, 2, 1, 0.5],
              neck_hidden_sizes=[16, 24, 32, 32], fusion_hidden_size=16, head_hidden_size=8,
              reassemble_hidden_size=32, max_depth=1.0)
    if prompt:
        return PromptDepthAnythingConfig(depth_estimation_type="metric", **kw)
    return DepthAnythingConfig(depth_estimation_type="relative", **kw)


def _save(model, path):
    torch.manual_seed(1)
    with torch.no_grad():    # non-trivial layer scales and biases
        for name, p in model.named_parameters():
            if name.endswith("lambda1"):
                p.uniform_(0.5, 1.5)
            elif name.endswith("bias"):
                p.normal_(0, 0.05)
    model.save_pretrained(path)
    return hf_weights.load(path)


@pytest.fixture(scope="module")
def da(tmp_path_factory):
    from transformers.models.depth_anything.modeling_depth_anything import (
        DepthAnythingForDepthEstimation)
    torch.manual_seed(0)
    path = str(tmp_path_factory.mktemp("da") / "tiny")
    config, sd = _save(DepthAnythingForDepthEstimation(_da_hf_config(False)).eval(), path)
    jcfg = jda.config_from_hf(_da_hf_config(False))
    jparams = jda.convert_hf_depth_anything(_numpy(sd), jcfg)
    model, cfg = tda.load_depth_anything(path, device="cpu")
    return path, model, cfg, jparams, jcfg


@pytest.mark.parametrize("hw", [(70, 70), (56, 112)], ids=["native", "interpolated"])
def test_depth_anything_matches_jax(da, hw):
    """1e-4 of the largest depth; (56, 112) resizes the 5x5 position grid to 4x8."""
    _, model, cfg, jparams, jcfg = da
    assert cfg.out_indices == jcfg.out_indices == (1, 2, 3, 4)
    x = np.random.default_rng(0).standard_normal((2, *hw, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda p, x: jda.depth_anything_forward(p, x, jcfg))(
        jparams, jnp.asarray(x)))
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    _close(got, ref)
    assert np.abs(ref).max() > 0


def test_depth_anything_jax_tree_route_gives_the_same_bits(da):
    path, model, cfg, jparams, _ = da
    with torch.device("cpu"):
        other = tda.load_jax_params(tda.DepthAnything(cfg).eval(), jparams)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((1, 70, 84, 3)).astype(np.float32))
    with torch.inference_mode():
        assert torch.equal(other(x), model(x))
    hf = hf_weights.read_state_dict(path)
    assert set(hf) == set(model.state_dict())


def test_preprocess_matches_jax():
    """jax.image.resize's antialiased bilinear on a shrink (1e-4 of max)."""
    imgs = np.random.default_rng(3).random((2, 64, 96, 3)).astype(np.float32)
    cfg = dataclasses.replace(tda.DA_V2_LARGE)
    ref = np.asarray(jda.preprocess(imgs, jda.DA_V2_LARGE, target=42))
    _close(tda.preprocess(imgs, cfg, target=42).numpy(), ref)


RESIZES = [((37, 37), (37, 66), "bicubic"),    # DA V2's grid at 518x924
           ((37, 37), (20, 20), "bicubic"),    # shrinking: antialiased
           ((64, 112), (56, 98), "bilinear"),  # preprocess's shrink
           ((48, 64), (96, 128), "bilinear"),  # growing
           ((57, 102), (50, 98), "bicubic")]   # PromptDA's image resize, shrinking


@pytest.mark.parametrize("src,dst,method", RESIZES)
def test_resize_matches_jax_image_resize(src, dst, method):
    """models.nn.resize against jax.image.resize within 1e-5 of the largest
    value; where the two semantics differ (bicubic, or shrinking),
    F.interpolate (a = -0.75, no antialiasing) is 100x further off."""
    x = np.random.default_rng(4).standard_normal((2, *src, 5)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, *dst, 5), method))
    got = L.resize(torch.from_numpy(x), *dst, method).numpy()
    _close(got, ref, 1e-5)
    torch_mode = "bicubic" if method == "bicubic" else "bilinear"
    ti = torch.nn.functional.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), size=dst,
                                         mode=torch_mode, align_corners=False)
    gap = np.abs(ti.permute(0, 2, 3, 1).numpy() - ref).max() / np.abs(ref).max()
    assert gap > 1e-3 if method == "bicubic" or dst[0] < src[0] else gap < 1e-5
    # 3-D (B, H, W) depth maps take the same path
    np.testing.assert_array_equal(L.resize(torch.from_numpy(x[..., 0]), *dst, method).numpy(),
                                  got[..., 0])


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    from transformers import DepthProConfig
    from transformers.models.depth_pro.modeling_depth_pro import DepthProForDepthEstimation
    torch.manual_seed(0)
    vit = dict(num_hidden_layers=2, patch_size=8, image_size=32)
    hf_cfg = DepthProConfig(
        patch_model_config=_dinov2(**vit), image_model_config=_dinov2(**vit),
        fov_model_config=_dinov2(**vit), patch_size=32, image_size=128,
        scaled_images_ratios=[0.25, 0.5, 1.0], scaled_images_overlap_ratios=[0.0, 0.5, 0.25],
        scaled_images_feature_dims=[32, 32, 16], intermediate_hook_ids=[1, 0],
        intermediate_feature_dims=[16, 16], fusion_hidden_size=16, merge_padding_value=3,
        num_fov_head_layers=2, use_fov_model=True)
    path = str(tmp_path_factory.mktemp("dp") / "tiny")
    _, sd = _save(DepthProForDepthEstimation(hf_cfg, use_fov_model=True).eval(), path)
    jcfg = jdp.config_from_hf_depth_pro(hf_cfg)
    jparams = jdp.convert_hf_depth_pro(_numpy(sd), jcfg)
    model, cfg = tdp.load_depth_pro(path, device="cpu")
    return path, model, cfg, jparams, jcfg


def test_depth_pro_matches_jax(dp):
    """Depth and field of view within 1e-4 of their largest values;
    postprocess_depth on the same outputs likewise (the random model's
    inverse depths sit near the 1e-4 clip, where 1 / x amplifies the
    forward's differences, so the postprocessing is held on one input)."""
    _, model, cfg, jparams, jcfg = dp
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    x = np.random.default_rng(0).standard_normal((2, 128, 128, 3)).astype(np.float32)
    ref_d, ref_f = jax.jit(lambda p, x: jdp.depth_pro_forward(p, x, jcfg))(
        jparams, jnp.asarray(x))
    with torch.inference_mode():
        got_d, got_f = model(torch.from_numpy(x))
    _close(got_d.numpy(), ref_d)
    _close(got_f.numpy(), ref_f)
    # JAX's postprocess_depth broadcasts (B,) against (B, S, S): one image at a time
    gd, gf = tdp.postprocess_depth(torch.tensor(np.asarray(ref_d)),
                                   torch.tensor(np.asarray(ref_f)), 128)
    for b in range(2):
        rd, rf = jdp.postprocess_depth(ref_d[b], ref_f[b], 128)
        _close(gd[b].numpy(), rd)
        _close(gf[b].numpy(), rf)
    np.testing.assert_allclose(float(tdp.fov_to_focal_px(torch.tensor(90.0), 512)), 256.0,
                               rtol=1e-6)


def test_depth_pro_jax_tree_route_and_geometry(dp):
    """The JAX tree gives the same bits; the published config builds the
    24x24 grid (577 tokens, exp 6) and the pinned JAX default 27 / exp 5."""
    _, model, cfg, jparams, _ = dp
    with torch.device("cpu"):
        other = tdp.load_jax_params(tdp.DepthPro(cfg).eval(), jparams)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((1, 128, 128, 3))
                         .astype(np.float32))
    with torch.inference_mode():
        a, b = other(x), model(x)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    pub = tdp.config_from_hf_depth_pro(tdp.PUBLISHED_HF_CONFIG)
    assert tdp._out_size(pub) == 24 and tdp._base_hw(pub, 1536, 1536) == (24, 24)
    assert tdp._out_size(tdp.DepthProConfig()) == 27
    assert tdp._base_hw(tdp.DepthProConfig(), 1536, 1536) == (48, 48)
    pieces = tdp.split_to_patches(torch.zeros(1, 3, 1536, 1536), 384, 0.25)
    assert pieces.shape[0] == 25


def test_split_and_merge_match_jax():
    x = np.random.default_rng(6).standard_normal((2, 96, 96, 3)).astype(np.float32)
    ref = np.asarray(jdp.split_to_patches(jnp.asarray(x), 32, 0.25))
    got = tdp.split_to_patches(torch.from_numpy(x).permute(0, 3, 1, 2), 32, 0.25)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), ref)
    f = np.random.default_rng(7).standard_normal((18, 8, 8, 4)).astype(np.float32)
    ref = np.asarray(jdp.merge_patches(jnp.asarray(f), 2, 3))
    got = tdp.merge_patches(torch.from_numpy(f).permute(0, 3, 1, 2), 2, 3)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), ref)


@pytest.fixture(scope="module")
def pda(tmp_path_factory):
    from transformers.models.prompt_depth_anything.modeling_prompt_depth_anything import (
        PromptDepthAnythingForDepthEstimation)
    torch.manual_seed(0)
    path = str(tmp_path_factory.mktemp("pda") / "tiny")
    _, sd = _save(PromptDepthAnythingForDepthEstimation(_da_hf_config(True)).eval(), path)
    jcfg = jda.config_from_hf(_da_hf_config(True))
    jparams = jpda.convert_hf_prompt_da(_numpy(sd), jcfg)
    model, cfg = tpda.load_prompt_da(path, device="cpu")
    return path, model, cfg, jparams, jcfg


@pytest.mark.parametrize("with_prompt", [True, False], ids=["prompt", "no_prompt"])
def test_prompt_da_matches_jax(pda, with_prompt):
    """1e-4 of the largest depth, with the min-max prompt normalisation and
    without a prompt."""
    _, model, cfg, jparams, jcfg = pda
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 70, 84, 3)).astype(np.float32)
    prompt = rng.uniform(0.5, 4.0, (2, 24, 32, 1)).astype(np.float32) if with_prompt else None
    fwd = jax.jit(lambda p, x, pr: jpda.prompt_da_forward(p, x, pr, jcfg))
    ref = np.asarray(fwd(jparams, jnp.asarray(x), None if prompt is None else jnp.asarray(prompt)))
    with torch.inference_mode():
        got = model(torch.from_numpy(x), None if prompt is None else torch.from_numpy(prompt))
    _close(got.numpy(), ref)
    with torch.device("cpu"):
        other = tpda.load_jax_params(tpda.PromptDepthAnything(cfg).eval(), jparams)
    with torch.inference_mode():
        assert torch.equal(other(torch.from_numpy(x), None if prompt is None
                                 else torch.from_numpy(prompt)), got)


def test_rescale_depth_maps_matches_jax(pda):
    """The refine step (bicubic image resize to the /14 grid, the prompt,
    bilinear back to the frame) within 1e-4 of the largest depth."""
    _, model, _, jparams, jcfg = pda
    rng = np.random.default_rng(8)
    imgs = rng.random((3, 45, 61, 3)).astype(np.float32)
    depths = rng.uniform(1.0, 3.0, (3, 12, 16)).astype(np.float32)
    ref = jpda.rescale_depth_maps(jparams, jcfg, imgs, depths, batch=2)
    got = tpda.rescale_depth_maps(model, imgs, depths, batch=2)
    assert got.shape == (3, 45, 61)
    _close(got, ref)


def test_init_prior_gives_finite_positive_depth(da, dp):
    """Seeded random weights (the chip smoke's) at the tiny widths: finite,
    positive depth and a focal in range."""
    cfg = da[2]
    model = tda.init_prior_(tda.DepthAnything(cfg).eval(), seed=0)
    x = torch.randn(1, 70, 84, 3, generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        d = model(x)
        dd, fov = tda.init_prior_(tdp.DepthPro(dp[2]).eval(), seed=0)(torch.randn(1, 128, 128, 3))
    assert torch.isfinite(d).all() and (d > 0).all()
    assert torch.isfinite(dd).all() and (dd > 0).all() and 30 < float(fov) < 90


def test_safetensors_reader_and_writer_match_the_library(tmp_path):
    from safetensors.numpy import load_file
    from safetensors.torch import save_file
    g = torch.Generator().manual_seed(0)
    sd = {"a.weight": torch.randn(3, 4, generator=g),
          "b": torch.randn(5, generator=g).to(torch.float16),
          "c.bias": torch.randn(2, 3, 2, generator=g).to(torch.bfloat16),
          "idx": torch.arange(7, dtype=torch.int64).reshape(7, 1),
          "scalar": torch.tensor(2.5)}
    save_file(sd, str(tmp_path / "lib.safetensors"))
    got = hf_weights.read_safetensors(str(tmp_path / "lib.safetensors"))
    assert set(got) == set(sd)
    for k, v in sd.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    hf_weights.write_safetensors(sd, str(tmp_path / "ours.safetensors"))
    back = load_file(str(tmp_path / "ours.safetensors"))
    for k, v in sd.items():
        if v.dtype == torch.bfloat16:
            continue       # numpy has no bfloat16
        np.testing.assert_array_equal(back[k], v.numpy())
    again = hf_weights.read_safetensors(str(tmp_path / "ours.safetensors"))
    assert all(torch.equal(again[k], v) for k, v in sd.items())
    with pytest.raises(ValueError, match="U8"):
        save_file({"u": torch.zeros(2, dtype=torch.uint8)}, str(tmp_path / "u8.safetensors"))
        hf_weights.read_safetensors(str(tmp_path / "u8.safetensors"))
    # a folder with pytorch_model.bin instead
    (tmp_path / "bin").mkdir()
    torch.save(sd, str(tmp_path / "bin" / "pytorch_model.bin"))
    back = hf_weights.read_state_dict(str(tmp_path / "bin"))
    assert all(torch.equal(back[k], v) for k, v in sd.items())


def test_hub_name_resolves_to_the_cached_snapshot(tmp_path, monkeypatch, da):
    snap = tmp_path / "hub" / "models--org--tiny-da" / "snapshots" / "abc123"
    snap.parent.mkdir(parents=True)
    os.symlink(da[0], snap)
    (tmp_path / "hub" / "models--org--tiny-da" / "refs").mkdir()
    (tmp_path / "hub" / "models--org--tiny-da" / "refs" / "main").write_text("abc123")
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    assert hf_weights.resolve("org/tiny-da") == str(snap)
    with pytest.raises(FileNotFoundError):
        hf_weights.resolve("org/absent")
    model, _ = tda.load_depth_anything("org/tiny-da", device="cpu")
    assert torch.equal(model.head.conv3.weight, da[1].head.conv3.weight)
