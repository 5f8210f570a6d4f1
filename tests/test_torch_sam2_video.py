"""The port's SAM2 video model and motion-mask refinement against the JAX
package, on the CPU, at the JAX tests' tiny HF config
(tests/test_sam2_video.py): the memory encoder, the memory attention with
invalid slots and pointer tokens, encode_new_memory, the memory-conditioned
features on a bank after several inserts, propagate_video with mask seeds,
point-conditioned tracking, refine_motion_masks (the parity swap) on 4
frames at 128x128, refine_motion_mask_w_sam2 without a checkpoint, and the
reconstruct_scene branch that refines the self masks. Both sides load one
transformers `save_pretrained` folder written from seeded weights
(`init_sam2_`). The JAX side is jitted once per route: its compiles are
most of this file's time."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from align3r_tpu.models import sam2_refine as jref
from align3r_tpu.models import sam2_video as jsv
from align3r_tpu.models.config import TINY_TEST
from align3r_tpu_torch import pipeline as tpipe
from align3r_tpu_torch.models import sam2_refine as tref
from align3r_tpu_torch.models import sam2_video as tsv
from align3r_tpu_torch.models.align3r import Align3R
from align3r_tpu_torch.utils import hf_weights

from test_torch_sam2 import _close, save_seeded

torch.set_num_threads(2)
T, S = 4, 128          # frames, image size (8x8 memory grid, 32x32 low-res logits)


def _hf_video_config():
    from transformers.models.sam2.configuration_sam2 import (Sam2HieraDetConfig,
                                                             Sam2VisionConfig)
    from transformers.models.sam2_video.configuration_sam2_video import (
        Sam2VideoConfig, Sam2VideoMaskDecoderConfig, Sam2VideoPromptEncoderConfig)
    hiera = Sam2HieraDetConfig(
        hidden_size=16, num_attention_heads=1, image_size=128, patch_kernel_size=7,
        patch_stride=4, patch_padding=3, query_stride=[2, 2],
        window_positional_embedding_background_size=[4, 4], num_query_pool_stages=3,
        blocks_per_stage=[1, 2, 1, 1], embed_dim_per_stage=[16, 32, 64, 128],
        num_attention_heads_per_stage=[1, 2, 4, 8], window_size_per_stage=[4, 2, 4, 2],
        global_attention_blocks=[2], mlp_ratio=2.0)
    vision = Sam2VisionConfig(
        backbone_config=hiera, backbone_channel_list=[128, 64, 32, 16], fpn_hidden_size=64,
        fpn_top_down_levels=[2, 3], num_feature_levels=3,
        backbone_feature_sizes=[[32, 32], [16, 16], [8, 8]])
    prompt = Sam2VideoPromptEncoderConfig(hidden_size=64, image_size=128, patch_size=16,
                                          mask_input_channels=8)
    decoder = Sam2VideoMaskDecoderConfig(
        hidden_size=64, mlp_dim=128, num_hidden_layers=2, num_attention_heads=2,
        iou_head_depth=3, iou_head_hidden_dim=32, dynamic_multimask_via_stability=True)
    return Sam2VideoConfig(
        vision_config=vision.to_dict(), prompt_encoder_config=prompt,
        mask_decoder_config=decoder, image_size=128, num_maskmem=3,
        max_object_pointers_in_encoder=4, memory_attention_hidden_size=64,
        memory_attention_num_layers=2, memory_attention_num_attention_heads=2,
        memory_attention_downsample_rate=1, memory_attention_feed_forward_hidden_size=128,
        memory_attention_rope_feat_sizes=[8, 8], memory_encoder_hidden_size=64,
        memory_encoder_output_channels=64, mask_downsampler_embed_dim=64,
        memory_fuser_num_layers=2, memory_fuser_embed_dim=64,
        memory_fuser_intermediate_dim=128)


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    from transformers.models.sam2_video.modeling_sam2_video import Sam2VideoModel
    torch.manual_seed(0)
    hf_cfg = _hf_video_config()
    path = str(tmp_path_factory.mktemp("sam2v") / "tiny")
    save_seeded(Sam2VideoModel(hf_cfg).eval(),
                tsv.SAM2Video(tsv.config_from_hf_sam2_video(hf_cfg.to_dict())), path, seed=1)
    jparams, jcfg = jsv.load_hf_sam2_video(path)
    model, cfg = tsv.load_hf_sam2_video(path, device="cpu")
    return path, model, cfg, jparams, jcfg


def test_config_and_jax_tree_route(video):
    """The config read from config.json equals JAX's; the JAX tree loaded
    into the port's module gives the same bits as the HF folder, for every
    entry the tree carries (all but the unused no-memory position encoding)."""
    path, model, cfg, jparams, jcfg = video
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    other = tsv.load_jax_params(tsv.SAM2Video(cfg).eval(), jparams)
    ref = model.state_dict()
    assert set(other.state_dict()) == set(ref) == set(hf_weights.read_state_dict(path))
    carried = set(tsv.sam2_video_state_dict(jparams, cfg))
    assert set(ref) - carried == {"no_memory_positional_encoding"}
    assert all(torch.equal(v, ref[k]) for k, v in other.state_dict().items() if k in carried)


# ------------------------------------------------------------ components

HW, C, D = 64, 64, 64
r = np.random.default_rng(1)
FEAT = r.standard_normal((1, 8, 8, C)).astype(np.float32)
MASK = (r.standard_normal((1, S, S, 1)) * 4).astype(np.float32)
CUR = r.standard_normal((1, HW, C)).astype(np.float32)
POS = r.standard_normal((1, HW, C)).astype(np.float32)
MEM = r.standard_normal((1, 2 * HW + 3, D)).astype(np.float32)
MPOS = r.standard_normal((1, 2 * HW + 3, D)).astype(np.float32)
# the second spatial slot and the middle pointer token are invalid
KVALID = np.ones((1, 2 * HW + 3), bool)
KVALID[:, HW:2 * HW] = False
KVALID[:, 2 * HW + 1] = False
OBJ = np.array([[2.0]], np.float32)
# bank inserts: cond frame 0, tracked 1 and 2, cond 3, tracked 4; then frame 6
INSERTS = [(f, r.standard_normal((1, HW, D)).astype(np.float32),
            r.standard_normal((1, C)).astype(np.float32), f in (0, 3)) for f in range(5)]
FRAME, MAX_PTR = 6, 4


def _jax_bank(jcfg):
    bank = jsv.init_memory_bank(jcfg, 1, HW, num_cond_slots=2)
    for f, mf, ptr, cond in INSERTS:
        bank = jsv.update_memory_bank(bank, jnp.asarray(mf), jnp.asarray(ptr), f, cond)
    return bank


@pytest.fixture(scope="module")
def components(video):
    """The JAX side of every component test, in one jit."""
    _, _, _, jparams, jcfg = video

    def run(p):
        a = jnp.asarray
        enc = jsv.memory_encoder(p["memory_encoder"], a(FEAT), a(MASK), jcfg)
        att = jsv.memory_attention(p["memory_attention"], a(CUR), a(POS), a(MEM), a(MPOS),
                                   jcfg, num_obj_ptr_tokens=3, k_valid=a(KVALID))
        new = [jsv.encode_new_memory(p, jcfg, a(FEAT), a(MASK), a(o), is_mask_from_pts=pts)
               for o, pts in ((OBJ, False), (-OBJ, False), (OBJ, True))]
        prep = jsv.prepare_memory_conditioned_features(
            p, jcfg, a(CUR), a(POS), _jax_bank(jcfg), FRAME, MAX_PTR)
        return enc, att, new, prep

    return jax.tree.map(np.asarray, jax.jit(run)(jparams))


def test_memory_encoder_matches_jax(video, components):
    _, model, cfg, _, _ = video
    with torch.inference_mode():
        f, pos = tsv.memory_encoder(model.memory_encoder, torch.from_numpy(FEAT),
                                    torch.from_numpy(MASK), cfg)
    _close(f.numpy(), components[0][0])
    _close(pos.numpy(), components[0][1])


def test_memory_attention_matches_jax(video, components):
    """Invalid spatial slots and an invalid pointer token masked out, the 3
    pointer tokens excluded from RoPE."""
    _, model, cfg, _, _ = video
    t = torch.from_numpy
    with torch.inference_mode():
        got = tsv.memory_attention(model.memory_attention, t(CUR), t(POS), t(MEM), t(MPOS),
                                   cfg, num_obj_ptr_tokens=3, k_valid=t(KVALID))
    _close(got.numpy(), components[1])


def test_encode_new_memory_matches_jax(video, components):
    """Present, occluded (the occlusion embedding mixed in) and from points.
    The output is rounded through bf16 on both sides: 1 bf16 ulp of the
    largest value."""
    _, model, _, _, _ = video
    t = torch.from_numpy
    for (o, pts), ref in zip(((OBJ, False), (-OBJ, False), (OBJ, True)), components[2]):
        with torch.inference_mode():
            got = tsv.encode_new_memory(model, t(FEAT), t(MASK), t(o), is_mask_from_pts=pts)
        _close(got.numpy(), ref, tol=2 ** -8)


def test_prepare_memory_conditioned_features_matches_jax(video, components):
    """A bank of 2 cond slots after 5 inserts (cond, tracked, tracked, cond,
    tracked), read at frame 6: the recent ring rolled, one pointer past the
    recency window; the keys and their order are JAX's."""
    _, model, cfg, _, _ = video
    bank = tsv.init_memory_bank(cfg, 1, HW, num_cond_slots=2)
    for f, mf, ptr, cond in INSERTS:
        bank = tsv.update_memory_bank(bank, torch.from_numpy(mf), torch.from_numpy(ptr), f,
                                      cond)
    assert bank.cond_valid.all() and bank.recent_valid.all() and bank.ptr_count == 5
    with torch.inference_mode():
        got = tsv.prepare_memory_conditioned_features(
            model, torch.from_numpy(CUR), torch.from_numpy(POS), bank, FRAME, MAX_PTR)
    _close(got.numpy(), components[3])


# ------------------------------------------------------------- tracking

rt = np.random.default_rng(2)
IMAGES01 = (rt.integers(0, 256, (T, S, S, 3)) / 256.0).astype(np.float32)
SELF_MASKS = np.zeros((T, S, S), bool)
for _t in range(T):       # a square moving right, and a speck to clean up
    SELF_MASKS[_t, 40:80, 20 + 8 * _t:60 + 8 * _t] = True
    SELF_MASKS[_t, 5:7, 100:102] = True


@pytest.fixture(scope="module")
def jax_refine(video):
    """JAX's refine_motion_masks on (IMAGES01, SELF_MASKS), recording each
    propagate_video call it makes (seeds, logits)."""
    _, _, _, jparams, jcfg = video
    calls = []
    orig = jsv.propagate_video

    def record(params, cfg, frames, seeds, num_cond_slots=None):
        out = orig(params, cfg, frames, seeds, num_cond_slots=num_cond_slots)
        calls.append(({k: np.asarray(v) for k, v in seeds.items()}, np.asarray(out)))
        return out

    jsv.propagate_video = record
    try:
        refined = jsv.refine_motion_masks(jparams, jcfg, IMAGES01, SELF_MASKS)
    finally:
        jsv.propagate_video = orig
    frames = np.asarray(jsv.preprocess_sam2_frames(IMAGES01, S))
    return refined, calls, frames


def test_preprocess_matches_jax(jax_refine):
    _close(tsv.preprocess_sam2_frames(IMAGES01, S).numpy(), jax_refine[2])


def test_propagate_video_with_mask_seeds_matches_jax(video, jax_refine):
    """Both of the refinement's runs (seeds on odd frames, from frame 1; on
    even frames): the (T, 32, 32) logits, 1e-4 of the largest value."""
    _, model, _, _, _ = video
    calls = jax_refine[1]
    assert [sorted(s) for s, _ in calls] == [[1, 3], [0, 2]]
    frames = torch.from_numpy(jax_refine[2].copy())
    for seeds, ref in calls:
        got = tsv.propagate_video(model, frames, {k: torch.tensor(v) for k, v in seeds.items()},
                                  num_cond_slots=8)
        _close(got.numpy(), ref)
        assert np.abs(ref[min(seeds) + 1]).max() > 1.0   # a tracked frame does work


def test_point_conditioned_tracking_matches_jax(video):
    """A point-conditioned frame (one positive click: multimask, best by
    IoU) then two tracked frames."""
    _, model, cfg, jparams, jcfg = video
    rng = np.random.default_rng(6)
    frames = rng.standard_normal((3, 1, S, S, 3)).astype(np.float32)
    pts = np.array([[[[64.0, 64.0]]]], np.float32)
    lab = np.array([[[1]]], np.int32)
    point = jax.jit(lambda p, pv, b: jsv.sam2_video_frame(
        p, jcfg, pv, b, 0, 3, init_points=jnp.asarray(pts), init_labels=jnp.asarray(lab)))
    step = jax.jit(lambda p, pv, b, i: jsv.sam2_video_frame(p, jcfg, pv, b, i, 3))
    jbank = jsv.init_memory_bank(jcfg, 1, HW)
    tbank = tsv.init_memory_bank(cfg, 1, HW)
    for f in range(3):
        if f == 0:
            jlow, jobj, jbank = point(jparams, jnp.asarray(frames[0]), jbank)
        else:
            jlow, jobj, jbank = step(jparams, jnp.asarray(frames[f]), jbank, f)
        with torch.inference_mode():
            low, obj, tbank = tsv.sam2_video_frame(
                model, torch.from_numpy(frames[f]), tbank, f, 3,
                **(dict(init_points=torch.from_numpy(pts), init_labels=torch.from_numpy(lab))
                   if f == 0 else {}))
        assert low.shape == (1, 1, 32, 32)
        _close(low.numpy(), np.asarray(jlow))
        _close(obj.numpy(), np.asarray(jobj))
    assert bool(tbank.cond_valid[0]) and bool(tbank.recent_valid[0])
    _close(tbank.ptr.numpy(), np.asarray(jbank.ptr))


def test_refine_motion_masks_matches_jax(video, jax_refine):
    """The parity swap: bool (T, H, W), a superset of the input masks that
    grows, the same pixels as JAX's."""
    _, model, _, _, _ = video
    ref = jax_refine[0]
    got = tsv.refine_motion_masks(model, IMAGES01, SELF_MASKS)
    assert got.shape == (T, S, S) and got.dtype == bool
    assert (got | SELF_MASKS).sum() == got.sum() and got.sum() > SELF_MASKS.sum()
    np.testing.assert_array_equal(got, ref)
    assert tsv.frame_steps(SELF_MASKS) == (7, 3)


def test_refine_without_checkpoint_is_jax_cleanup(tmp_path, monkeypatch):
    """No local checkpoint: both packages return the connected-component
    cleanup of the masks."""
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path))
    masks = np.random.default_rng(7).random((3, 40, 56)) > 0.55
    name = "nobody/sam2-not-cached"
    assert not tref.sam2_available(name) and not jref.sam2_available(name)
    got = tref.refine_motion_mask_w_sam2(None, masks, model_name=name)
    ref = jref.refine_motion_mask_w_sam2(None, masks, model_name=name)
    assert got.dtype == bool and np.array_equal(got, ref) and not np.array_equal(got, masks)
    np.testing.assert_array_equal(tref.cleanup_masks(masks), jref.cleanup_masks(masks))


@pytest.mark.parametrize("with_model", [True, False], ids=["sam2", "no_checkpoint"])
def test_reconstruct_scene_sam2_branch(video, jax_refine, monkeypatch, tmp_path, with_model):
    """reconstruct_scene(use_self_mask, sam2_mask_refine) passes on the masks
    JAX's branch (refine_motion_mask_w_sam2 on the same self masks) gives:
    with the SAM2 model, and with neither a model nor a local checkpoint.
    The self masks and the flows are stand-ins, fixed on the port's side."""
    _, model, cfg, _, _ = video
    jref_masks = jref.cleanup_masks(jax_refine[0]) if with_model else \
        jref.cleanup_masks(SELF_MASKS)
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path))
    monkeypatch.setattr(tpipe, "motion_masks_from_pairs", lambda *a, **k: SELF_MASKS.copy())

    def flows(raft, imgs01, edges, **k):
        np.testing.assert_array_equal(imgs01, IMAGES01)
        z = torch.zeros(len(edges), S, S, 2)
        return z, z

    monkeypatch.setattr(tpipe, "compute_raft_flows", flows)
    pm = Align3R(TINY_TEST).prepare(torch.float32, torch.float32, device="cpu")
    imgs = IMAGES01 * 2.0 - 1.0
    res = tpipe.reconstruct_scene(
        imgs, np.ones((T, S, S, 3), np.float32), pm, scene_graph="complete", batch_size=8,
        raft_params=object(), use_self_mask=True, sam2_mask_refine=True,
        sam2_model=(model, cfg) if with_model else None, niter=2,
        scene_kw=dict(flow_loss_weight=0.01, min_conf_thr=1.1))
    assert "sam2_s" in res.timings
    assert res.dynamic_masks.dtype == bool
    np.testing.assert_array_equal(res.dynamic_masks, jref_masks)
    np.testing.assert_array_equal(res.data.dynamic_masks.numpy(), jref_masks.astype(np.float32))
