"""The port's SAM2 image model against the JAX package, on the CPU, at the
JAX tests' tiny HF config (tests/test_sam2.py): `sam2_image_forward` with no
prompt, a mask, points and a box; the config read from config.json; the
JAX-tree route; and the connected-components mask cleanup against
align3r_tpu.native. Both sides load one transformers `save_pretrained`
folder (JAX through load_hf_sam2, the port through `utils.hf_weights`),
written from seeded weights (`init_sam2_`) so that the outputs are of order
one, not HF's near-zero initial ones."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from align3r_tpu import native
from align3r_tpu.models import sam2 as js
from align3r_tpu_torch.eval import viz
from align3r_tpu_torch.models import sam2 as ts
from align3r_tpu_torch.utils import hf_weights

torch.set_num_threads(2)
TOL = 1e-4   # of the largest reference value: fp32 on both sides, sums in other orders


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


def save_seeded(hf_model, port_model, path, seed=0):
    """Seeded weights (ts.init_sam2_) into the transformers model, written
    with its save_pretrained: the folder both sides load. The prompt
    encoder's copy of the Gaussian matrix is tied to the shared one, and
    save_pretrained writes the shared one alone."""
    ts.init_sam2_(port_model, seed=seed)
    missing, unexpected = hf_model.load_state_dict(port_model.state_dict(), strict=False)
    assert missing == ["prompt_encoder.shared_embedding.positional_embedding"] \
        and not unexpected, (missing, unexpected)
    hf_model.save_pretrained(path)
    assert set(hf_weights.read_state_dict(path)) == set(port_model.state_dict())


def _hf_image_config():
    from transformers.models.sam2.configuration_sam2 import (
        Sam2Config, Sam2HieraDetConfig, Sam2MaskDecoderConfig, Sam2PromptEncoderConfig,
        Sam2VisionConfig)
    hiera = Sam2HieraDetConfig(
        hidden_size=16, num_attention_heads=1, image_size=128, patch_kernel_size=7,
        patch_stride=4, patch_padding=3, query_stride=[2, 2],
        window_positional_embedding_background_size=[4, 4], num_query_pool_stages=3,
        blocks_per_stage=[1, 2, 1, 1], embed_dim_per_stage=[16, 32, 64, 128],
        num_attention_heads_per_stage=[1, 2, 4, 8], window_size_per_stage=[4, 2, 4, 2],
        global_attention_blocks=[2], mlp_ratio=2.0)
    vision = Sam2VisionConfig(
        backbone_config=hiera, backbone_channel_list=[128, 64, 32, 16], fpn_hidden_size=32,
        fpn_top_down_levels=[2, 3], num_feature_levels=3,
        backbone_feature_sizes=[[32, 32], [16, 16], [8, 8]])
    prompt = Sam2PromptEncoderConfig(hidden_size=32, image_size=128, patch_size=16,
                                     mask_input_channels=8)
    decoder = Sam2MaskDecoderConfig(hidden_size=32, mlp_dim=64, num_hidden_layers=2,
                                    num_attention_heads=2, iou_head_depth=3,
                                    iou_head_hidden_dim=32,
                                    dynamic_multimask_via_stability=True)
    return Sam2Config(vision_config=vision, prompt_encoder_config=prompt,
                      mask_decoder_config=decoder)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    from transformers.models.sam2.modeling_sam2 import Sam2Model
    torch.manual_seed(0)
    hf_cfg = _hf_image_config()
    path = str(tmp_path_factory.mktemp("sam2") / "tiny")
    save_seeded(Sam2Model(hf_cfg).eval(),
                ts.SAM2Image(ts.config_from_hf_sam2(hf_cfg.to_dict())), path)
    jparams, jcfg = js.load_hf_sam2(path)
    model, cfg = ts.load_hf_sam2(path, device="cpu")
    return path, model, cfg, jparams, jcfg


rng = np.random.default_rng(0)
X = rng.standard_normal((1, 128, 128, 3)).astype(np.float32)
PROMPTS = {
    "none": dict(),
    # a mask prompt at the mask input size (4 * 128 / 16 = 32)
    "mask": dict(input_masks=(rng.random((1, 32, 32, 1)) > 0.5).astype(np.float32) * 8 - 4),
    "points": dict(input_points=np.array([[[[40.0, 60.0], [90.0, 30.0]]]], np.float32),
                   input_labels=np.array([[[1, 0]]], np.int64), multimask_output=True),
    "box": dict(input_boxes=np.array([[[20.0, 30.0, 90.0, 100.0]]], np.float32)),
}


@pytest.fixture(scope="module")
def jax_outputs(tiny):
    """All four prompt variants in one jit (one compile)."""
    _, _, _, jparams, jcfg = tiny

    def run(p, x):
        out = {}
        for name, kw in PROMPTS.items():
            kw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
            out[name] = js.sam2_image_forward(p, x, kw.pop("input_masks", None), jcfg, **kw)
        return out

    out = jax.jit(run)(jparams, jnp.asarray(X))
    return {k: [np.asarray(a) for a in v] for k, v in out.items()}


@pytest.mark.parametrize("prompt", list(PROMPTS))
def test_sam2_image_forward_matches_jax(tiny, jax_outputs, prompt):
    """Mask logits, IoU and object-score logits, 1e-4 of the largest value."""
    _, model, _, _, _ = tiny
    kw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
          for k, v in PROMPTS[prompt].items()}
    with torch.inference_mode():
        got = ts.sam2_image_forward(model, torch.from_numpy(X), kw.pop("input_masks", None),
                                    **kw)
    for g, r in zip(got, jax_outputs[prompt]):
        _close(g.numpy(), r)
    assert np.abs(jax_outputs[prompt][0]).max() > 0.1


def test_config_from_config_json_matches_jax(tiny):
    path, _, cfg, _, jcfg = tiny
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(ts.config_from_hf_sam2(hf_weights.read_config(path))) \
        == dataclasses.asdict(jcfg)


def test_jax_tree_route_gives_the_same_bits(tiny):
    _, model, cfg, jparams, _ = tiny
    other = ts.load_jax_params(ts.SAM2Image(cfg).eval(), jparams)
    ref = model.state_dict()
    assert set(other.state_dict()) == set(ref)
    assert all(torch.equal(v, ref[k]) for k, v in other.state_dict().items())


def test_attention_shapes_follow_the_trunk(tiny, monkeypatch):
    """hiera_attention_shapes (what the smoke counts K6 launches from) is the
    shape each block's attention sees."""
    _, model, cfg, _, _ = tiny
    seen = []
    orig = ts.attention

    def spy(q, k, v, impl):
        seen.append((q.shape[0], q.shape[1], q.shape[2], k.shape[2], q.shape[3]))
        return orig(q, k, v, impl)

    monkeypatch.setattr(ts, "attention", spy)
    with torch.inference_mode():
        ts.sam2_encode_image(model, torch.from_numpy(np.repeat(X, 2, 0)))
    assert seen == ts.hiera_attention_shapes(cfg.hiera, cfg.image_size, batch=2)


def _masks(seed, shape=(57, 83), p=0.55):
    return np.random.default_rng(seed).random(shape) > p


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_connected_components_match_native(seed):
    """8-connected labels (raster order), count and areas: the same as the
    JAX package's C++ op."""
    m = _masks(seed)
    got, ref = viz.connected_components(m), native.connected_components(m)
    assert got[1] == ref[1] > 10
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[2], ref[2])


@pytest.mark.parametrize("mode", ["islands", "holes"])
@pytest.mark.parametrize("seed", [3, 4])
def test_remove_small_regions_matches_native(mode, seed):
    m = _masks(seed, p=0.6 if mode == "islands" else 0.4)
    for thr in (2, 5, 30):
        got = viz.remove_small_regions(m, thr, mode=mode)
        ref = native.remove_small_regions(m, thr, mode=mode)
        assert got.dtype == bool and np.array_equal(got, ref)
        assert not np.array_equal(got, m)
