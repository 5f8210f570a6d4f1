#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (align3r_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own line; any failure exits non-zero without the
final result line:
  1. device   - requires CUDA; prints `nvidia-smi` name and power limit.
  2. build    - compiles the port's CUDA kernels (align3r_tpu_torch/csrc)
                with nvcc into build/ and prints the seconds it took, and
                each kernel's registers and spill bytes (ptxas -v). K3/K4's
                kernels must spill nothing. Every
                instance of the GEMM core (K1/K2's gemm_sm90 and K7/K8's
                bf16 conv_sm90, 4 each) must spill nothing and its SASS
                (cuobjdump -sass) must hold HGMMA instructions; so must K7/
                K8's fp32 3xTF32 conv (conv_tf32_sm90, 4 epilogues), K9's
                bf16 D = 256 backward (dK/dV and dQ), K6's fp32 forward (3
                instances) and K9's fp32 forward and backward (dK/dV and dQ)
                at D = 64, 128 and 256; no bf16 instance of the old WMMA
                backward, and no scalar-FMA fp32 attention or conv kernel
                (conv3x3_fp32), may be in the library.
  3. kernels  - each kernel's wrapper against its plain PyTorch version on the
                card at the main path's shapes: max abs/rel error against a
                stated tolerance, and the time of each side (CUDA events; K1
                and K2 sites, the bf16 attention forwards K6 and K9 and the
                library call beside them replayed from a CUDA graph, since a
                wrapper's host time can match its kernels'; K3 and K4 the
                same way, with their split by launch (the walk, the second
                pass) under torch.profiler and two launches that must give
                the same bits; K9's backward and
                SDPA's as the sum of their kernels' device time under
                torch.profiler). K1's attention launch alone is held to K6 bit
                for bit on the same heads laid out per head, and timed beside
                K6 and SDPA on that layout. K1/K2's LayerNorm launch alone
                (the encoder's 9,216 rows x 1024, the decoder's 2 streams x
                18,432 rows x 768) against its plain version, timed from a
                CUDA graph beside F.layer_norm (one call per stream), each
                call on the next of 4 inputs so that it reads HBM, not L2;
                its launches count on fused_site._ln_cuda.launches. Each
                GEMM launch of K1 and K2
                alone (q/k with RoPE, v, out-projection with the residual,
                fc1 with GELU, fc2 with the residual; encoder and decoder
                shapes) against gemm_plain, timed from a CUDA graph beside
                torch.addmm (torch.baddbmm for two streams) on the same bf16
                product. Untimed, at the demo phase's shapes: K1/K2 at its
                encoder chunks (12, 6, 3, 2 frames) and decoder batches (8
                and the ragged tails 6, 4, 2), K3/K4 and K5 on the terms of
                its five solves (12 frames swinstride-5 and complete, 6, 3
                and 2 frames complete: e2 = 140, 264, 60, 12, 4), with the
                same tolerances and same-bits checks.
  4. parity   - a small model, a small solve and the flow term (gate off) run
                on the card and on the CPU, from the same seeded weights and
                inputs; they must agree.
  5. main     - the port's entry point, align3r_tpu_torch.pipeline.
                reconstruct_scene, at ViT-L 512 width (VIT_L_512, seeded random
                weights) on 24 synthetic 512x288 frames: swinstride-5 graph
                (190 pairs), batch 32, 300-iteration flow-variant solve. The
                kernels' launch counters are zeroed right before the call and
                every kernel must have launched, K3 and K4 300 times each
                (240 on the bf16 pack, 60 on the fp32 repack); outputs must
                be finite and of the expected shapes; the GEMM core must have
                launched 4
                times per K1 site and twice per K2 site, the LayerNorm launch
                twice per K1 site (one a site, and each decoder cross site
                normalises its memory too: as many as K1 - K2 sites). A
                second, warm run gives pairs/s and it/s.
  6. sam2     - SAM2.1 Hiera-L at the published geometry (SAM2_HF_CONFIG,
                seeded random weights, fp32 with TF32 off), written as a local
                HF folder with utils.hf_weights.save_pretrained and read back
                with load_hf_sam2_video. refine_motion_mask_w_sam2 on the main
                phase's first 12 frames (288x512) with a moving disc as every
                frame's motion mask: 23 frame steps (11 tracked), counters
                zeroed first; K6 fp32 must launch as often as dispatch_counts
                derives from the config (33 Hiera-L attentions a step route to
                it: the 32 windowed stage-3 blocks and the first stage-4 block),
                K9's fp32 forward 4 times a tracked step (the memory
                self-attention), its backward never; the refined masks bool
                (12, 288, 512) and a superset of the input. Then
                propagate_video on 4 frames with the kernels and with plain
                attention (attn_impl "xla"): median relative difference of the
                logits at most 1e-4. Prints seconds per frame step.
  7. flow     - the same entry point on the demo's flow path: SEA-RAFT
                spring-M at full width (seeded random weights) computes flows
                in both directions of every edge, the self-supervised motion
                masks come from PairViewer solves (numpy PnP on the host) and
                are refined by the sam2 phase's model (sam2_mask_refine=True,
                sam2_model=...: the reference's pose_test --sam2_mask_refine
                route), and the solve adds the flow term (the demo's scene_kw,
                weight 0.01). 12 of the 24 frames (70 pairs): the host PnP of
                the masks costs seconds per pair, and 24 frames would take most
                of the time limit. The counters are zeroed right before the
                call; K5 must launch twice (the bf16 pack and the fp32
                repack), K3 and K4 300 times, K6 and K9 as the sam2 phase's
                formula gives for the self masks; flows, masks (n, H, W) and
                outputs finite. Prints sam2_s and the dynamic share of the
                masks before and after the refinement.
  8. train    - the fine-tuning path: K6 against its plain version at the
                training shapes (and its time beside torch's SDPA), K6's and
                the differentiable K1/K2 sites' gradients against autograd of
                their twins, then align3r_tpu_torch.training.train.train at
                ViT-L width on 288x512 pairs with the reference per-GPU recipe
                (batch 2, accum_iter 4, remat full, frozen encoder in bf16,
                fp32 heads) over an in-memory synthetic dataset of 16 pairs,
                2 epochs (4 applied updates). The counters are zeroed right
                before the call; K6 must launch 80 times per micro-step, every
                loss must be finite, trainable parameters must move, frozen
                ones must stay bit-identical, and checkpoint-final.pth must
                reload strictly.
  9. heads    - the serving engine with the pipeline DPT heads
                (head_conv_impl="pipeline": K7 at every refinenet level, K8 at
                the tail) on the main phase's 24 frames (190 pairs, batch
                32), counters zeroed first: 84 K7 and 12 K8 launches, pts3d
                and conf within a median relative difference of 1e-2 of the
                default heads' in the same process (the two round bf16 at
                other points per stage); engine pairs/s of both, warm; then
                reconstruct_scene with inference_kw={"head_conv_impl":
                "pipeline"} and finite outputs. Then the same model with fp32
                heads (head_dtype fp32, the demo's): xla and pipeline heads on
                the same 190 pairs, counters zeroed first, 84 K7 and 12 K8
                launches on fp32 tensors (0 with the xla heads), pts3d and
                conf within a median relative difference of 1e-4 (cuDNN with
                TF32 off; the maximum printed too), engine seconds of both
                warm, in turns (xla, pipeline, pipeline, xla).
 10. long     - the fine-tuning entry point at the config's own 512x512 (1024
                tokens, so every attention takes K9, never K6): K9's gradient
                against autograd of its plain forward, then train() at
                Align3RConfig() on 8 synthetic 512x512 pairs, batch 2,
                accum_iter 2, 1 epoch; per micro-step 80 K9 forwards (24
                encoder, and 28 decoder and prior-branch attentions twice
                under remat) and 28 K9 backwards (the encoder is frozen), 0
                K6; finite losses, frozen weights bit-identical, trainable
                ones moved, checkpoint-final.pth reloads strictly.
 11. demo     - the demo's serving entry, run after `heads`: 12 synthetic
                1024x576 PNG frames with DepthPro-style `.npz` priors (the
                port's own writer) and a seeded VIT_L_512 checkpoint
                (export_torch_checkpoint) under build/demo, loaded once
                (tools.demo.load_model, timed); then with those prepared
                weights align3r_tpu_torch.tools.demo.main at --image_size 512
                (512x288), --niter 300, as eval_pose (the full artifact set:
                poses, intrinsics, focals, depth / conf / mask maps, frames,
                scene.html, scene.glb) and as eval_pose_h --clip_size 5
                (hierarchical: pred_traj.txt, depth_maps.npy); and one
                variant="prior" reconstruct_scene with the priors' z channel
                as mono_depths on the same frames (the depth tool's complete
                graph, lr 0.05, cosine, conf clamp 10). Counters are zeroed
                before each run: K1-K5 must launch in each; the artifacts
                must all exist, the .glb header be valid with PNG textures,
                trajectories and depths finite. Prints each stage's seconds
                (weights, load, engine, init, solve, writers, hierarchical
                total) and the card.
 12. prior    - the monocular priors on the demo phase's frames, with seeded
                random weights at full width: K9's fp32 forward (every
                DINOv2 attention of the priors takes it) against its plain
                version at the priors' five shapes (PRIOR_SHAPES), timed from
                a CUDA graph beside SDPA in fp32; Depth Anything V2 Large
                through tools.prior_depth.main on the 12 frames at batch 4,
                and Depth Pro at the published geometry (ViT-L patch 16 at
                384, config_from_hf_depth_pro of PUBLISHED_HF_CONFIG) on
                DP_FRAMES = 4 of them at batch 1 (the cut: 37 ViT-L passes a
                frame). K9's counters are zeroed before each call: 24 forwards
                a ViT pass (one a layer), 0 backwards, 0 K6. Each model runs
                again with plain attention (attn_impl "xla"); the depth's and
                the focal's median relative difference must stay within
                PRIOR_REL_TOL = 1e-4. Every .npz must exist with a finite
                depth of the frame's size and a finite focal. Then
                tools.demo on the Depth Anything priors (--depth_prior_name
                depthanything; K1-K5 must launch), and tools.demo_refine on
                the 4 Depth Pro frames with a seeded full-width PromptDA that
                utils.hf_weights wrote as a local folder (24 K9 forwards a
                batch of 2, one refined map a frame at 1024x576). Prints
                seconds per frame of each prior, the refine step's stage
                seconds, and the card.
 13. data     - the training data path, run after `train`: the port's JPEG
                codec built from csrc/jpeg_decode.cpp (its build seconds),
                then a preprocessed FlyingThings3D folder in SceneFlow's
                layout (2 TRAIN scenes of 6 frames and a TEST scene of 4,
                960x540 _rgb.jpg at quality 75 4:2:0, PFM depth, PNG masks,
                metadata, DepthPro-style priors) and a raw Sintel scene (6
                PNG frames at 1024x436, .dpt, .cam, dynamic masks, priors),
                written by the port's own writers under build/data. The
                decoder's ms a frame and the encoder's source back at quality
                95 (mean |diff| <= 2); load_images on the JPEG frames at size
                512; the loader alone over the epoch the training sees (ms a
                pair on one thread and on 4; every batch (288, 512), finite
                images in [-1, 1], valid pixels in every view); then
                tools.train.main over "24 @ SceneFlowDatasets(...) + 8 @
                SintelDatasets(...)" (aug_crop 16, 512x288, seed 777) with a
                SceneFlow test expression, at Align3RConfig(img_size=(288,
                512)) from a seeded start checkpoint, batch 2, accum_iter 4,
                1 epoch (16 micro-steps). Counters zeroed first; less the
                test epoch's launches (an eval step's, measured on one test
                batch), K6 must launch 80 times a micro-step and K1/K2 as
                often as in `train`; finite losses, frozen weights
                bit-identical, trainable ones moved, log.txt's record, a
                strict reload of checkpoint-final.pth. Prints ms a micro-step
                and the share of the epoch the loop waited on the loader
                beside the card.
 14. batch    - the batched multi-scene solve, run after `main`: 4 seeded
                24-frame 512x288 videos in the main phase's configuration
                (VIT_L_512, swinstride-5 symmetrised, 190 pairs each), the
                engine and mst_init on each, then alignment.batched.
                batched_alignment (mixed, 300 iterations, the main path's
                flow_forward loss and schedule) with the counters zeroed first:
                K3 and K4 must launch 300 times for the 4 scenes (240 on the
                bf16 packs, 60 on the fp32 repacks, one scene-axis launch an
                iteration), K5 twice. In the same call the 4 sequential
                global_alignment_loops; each scene's losses must match its
                sequential solve at rtol 2e-4, atol 1e-5. Prints the batched
                solve_s beside the sum of the sequential ones, and the card.
 15. ddp      - data parallelism on the one card, run after `data`: two
                ranks over gloo (NCCL refuses two ranks on one device), each
                `python -m align3r_tpu_torch.tools.train` at the recipe's
                288x512 (Align3RConfig(img_size=(288, 512)), a seeded start
                checkpoint, the data phase's dataset expression) with
                --n_data 2 --zero1 --ckpt_backend orbax, global batch 2,
                accum_iter 2, 4 micro-steps, then resumed from the
                asynchronous checkpoint for a second epoch; one process runs
                the same two epochs on the same global batches (resumed from
                its pickle checkpoint): epoch 0's loss within rtol 1e-4 (its
                4 micro-steps see the start weights: the first applied
                update has learning rate 0), epoch 1's, after an update at
                learning rate > 0, within 1e-2 (bf16 compute), and the
                trainable parameters' change over both epochs at cosine
                >= 0.9 to one process's. Then the
                data-parallel engine (inference(group=...)) on the main
                phase's 24 frames over the two ranks, with the pipeline and
                the default heads: within atol / rtol 1e-5 of one rank's
                output. Then a
                pos_embed="cosine" engine at VIT_L_512 widths on the same
                frames: K1/K2, GEMM and LayerNorm launches as the RoPE
                engine's, finite outputs. The dp engine's one-rank
                reference runs the ranks' own batch sizes (cuDNN picks the
                heads' bf16 conv algorithms by batch size).
The kernels phase also holds K7 (the four refinenet shapes, with and without
a base, in bf16 and fp32), K8 (the head tail at the main path's shape, bf16
and fp32, and at (4, 72, 128, 256) fp32), K3/K4 with a scene axis (4 scenes of
the main path's shape laid end to end, bf16 and fp32: against the plain
versions, each scene's loss within 1e-6 relative of its own S = 1 launch and
its gradients bit for bit, timed from a CUDA graph beside 4 x the S = 1 bound),
both timed from a CUDA graph and
split by launch beside the XLA-path chain (cuDNN, TF32 off; from a CUDA graph
and launched one by one), and untimed at the main path's last batch of 30
pairs, and K9
(forward and backward at the 512x512 training shapes, a ragged length,
D = 128 and D = 256, in bf16 and in fp32) to their plain versions, and K6's
and K9's fp32 forwards at SAM2.1 Hiera-L's shapes (SAM2_SHAPES: D = 72
windows, and the memory self-attention at (1, 1, 4096, 256)), timed from a
CUDA graph beside SDPA in fp32. Then the card line as nvidia-smi
prints it, one JSON line with the kernels (time, plain time, bound, launches
on their path, library-call time), and last {"ok": true, "device": {...}}.
The process fails if jax or the JAX package (align3r_tpu) was imported.
"""
from __future__ import annotations

import json
import os
import re
import struct
import subprocess
import sys
import tempfile
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
N_FRAMES, H, W = 24, 288, 512
FLOW_FRAMES = 12
BATCH = 32
TAIL_BATCH = 190 % BATCH   # the last decode batch of the main path's 190 pairs
LN_ROTATE = 4   # inputs the LayerNorm row cycles through: 75-226 MB, past the L2
TRAIN_PAIRS, TRAIN_BATCH, ACCUM, TRAIN_EPOCHS = 16, 2, 4, 2
LONG_HW, LONG_PAIRS, LONG_ACCUM = (512, 512), 8, 2
BATCH_SCENES = 4           # the batch phase's videos (seeds 0-3), solved together
DDP_RANKS, DDP_STEPS, DDP_ACCUM = 2, 4, 2
DP_TOL = 1e-5              # the data-parallel engine against one rank, atol and rtol
DEMO_FRAMES, DEMO_HW = 12, (576, 1024)
# the data phase: FlyingThings3D (SceneFlow layout) at 960x540, Sintel at
# 1024x436; 24 + 8 pairs, one epoch of 16 micro-steps
DATA_SCENES = (("TRAIN", "0000", 6), ("TRAIN", "0001", 6), ("TEST", "0000", 4))
DATA_HW, SINTEL_HW, SINTEL_FRAMES = (540, 960), (436, 1024), 6
DATA_PAIRS, DATA_WORKERS, DECODE_REPS, LOADER_ITEMS = 32, 4, 20, 6
# the demo phase's kernel shapes, checked (untimed) beside the main path's:
# K1/K2 batches (the encoder's chunk of 12 frames, the hierarchical solve's 6,
# 3 and 2; the decoder's batch of 8 and its ragged tails) and the solves'
# graphs (eval_pose, the prior run, the hierarchical clips and coarse solve)
DEMO_SITE_B = {"encoder": (12, 6, 3, 2), "decoder": (8, 6, 4, 2)}
DEMO_GRAPHS = ((12, "swinstride-5-noncyclic"), (12, "complete"), (6, "complete"),
               (3, "complete"), (2, "complete"))
# SAM2.1 Hiera-L's config.json fields (facebook/sam2.1-hiera-large, as
# transformers' Sam2VideoConfig writes them): the sam2 phase's geometry
SAM2_HF_CONFIG = {
    "model_type": "sam2_video", "image_size": 1024, "num_maskmem": 7,
    "max_object_pointers_in_encoder": 16, "sigmoid_scale_for_mem_enc": 20.0,
    "sigmoid_bias_for_mem_enc": -10.0, "enable_occlusion_spatial_embedding": True,
    "enable_temporal_pos_encoding_for_object_pointers": True,
    "multimask_output_for_tracking": True, "multimask_output_in_sam": True,
    "multimask_min_pt_num": 0, "multimask_max_pt_num": 1,
    "memory_attention_hidden_size": 256, "memory_attention_num_layers": 4,
    "memory_attention_num_attention_heads": 1, "memory_attention_downsample_rate": 1,
    "memory_attention_feed_forward_hidden_size": 2048,
    "memory_attention_feed_forward_hidden_act": "relu", "memory_attention_rope_theta": 10000,
    "memory_attention_rope_feat_sizes": [64, 64], "memory_encoder_hidden_size": 256,
    "memory_encoder_output_channels": 64, "mask_downsampler_embed_dim": 256,
    "mask_downsampler_kernel_size": 3, "mask_downsampler_stride": 2,
    "mask_downsampler_padding": 1, "mask_downsampler_total_stride": 16,
    "memory_fuser_num_layers": 2, "memory_fuser_embed_dim": 256,
    "memory_fuser_intermediate_dim": 1024, "memory_fuser_kernel_size": 7,
    "memory_fuser_padding": 3,
    "vision_config": {
        "model_type": "sam2_vision_model",
        "backbone_config": {
            "model_type": "sam2_hiera_det_model", "hidden_size": 144, "num_attention_heads": 2,
            "num_attention_heads_per_stage": [2, 4, 8, 16], "blocks_per_stage": [2, 6, 36, 4],
            "embed_dim_per_stage": [144, 288, 576, 1152], "window_size_per_stage": [8, 4, 16, 8],
            "global_attention_blocks": [23, 33, 43],
            "window_positional_embedding_background_size": [7, 7], "query_stride": [2, 2],
            "num_query_pool_stages": 3, "patch_kernel_size": 7, "patch_stride": 4,
            "patch_padding": 3, "mlp_ratio": 4.0, "layer_norm_eps": 1e-6,
            "image_size": [1024, 1024]},
        "backbone_channel_list": [1152, 576, 288, 144],
        "backbone_feature_sizes": [[256, 256], [128, 128], [64, 64]],
        "fpn_hidden_size": 256, "fpn_top_down_levels": [2, 3], "num_feature_levels": 3},
    "prompt_encoder_config": {"hidden_size": 256, "image_size": 1024, "patch_size": 16,
                              "mask_input_channels": 16, "num_point_embeddings": 4},
    "mask_decoder_config": {
        "hidden_size": 256, "num_hidden_layers": 2, "num_attention_heads": 8, "mlp_dim": 2048,
        "attention_downsample_rate": 2, "num_multimask_outputs": 3, "iou_head_depth": 3,
        "iou_head_hidden_dim": 256, "dynamic_multimask_via_stability": True,
        "dynamic_multimask_stability_delta": 0.05, "dynamic_multimask_stability_thresh": 0.98},
}
SAM2_FRAMES = 12         # the main phase's first 12 frames, 288x512
SAM2_AGREE_FRAMES = 4    # propagate_video with K6/K9 and with plain attention
SAM2_REL_TOL = 1e-4      # median relative difference of the logits
# the dispatched attentions SAM2.1 Hiera-L gives the kernels, (B, H, Nq, D, Nk)
# fp32: K6 at the stage-3 windows and the first stage-4 block, K9 at the
# memory self-attention
SAM2_SHAPES = (("K6 fp32", "Hiera-L stage-3 windows", (16, 8, 256, 72, 256)),
               ("K6 fp32", "Hiera-L first stage-4 block (pooled queries)", (16, 16, 64, 72, 256)),
               ("K9 fp32", "SAM2.1 memory self-attention", (1, 1, 4096, 256, 4096)))
# published H100 SXM peaks (dense): bf16 tensor cores, fp32 without them, HBM
PEAK_BF16, PEAK_FP32, HBM_BYTES_S = 989e12, 67e12, 3.35e12
# dense TF32 tensor cores; an fp32-accurate product there is 3 TF32 products
# (3xTF32), so fp32 attention's bound is max(bytes, 3 ops / PEAK_TF32)
PEAK_TF32 = 494.7e12


def fail(phase: str, msg: str) -> int:
    print(f"FAIL {phase}: {msg}", flush=True)
    return 1


def cuda_time(fn, reps: int, warmup: int = 2):
    """Mean milliseconds of fn() over `reps` launches, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def ptxas_usage(log: str) -> dict:
    """{kernel (mangled name): [registers, spill store bytes, spill load
    bytes]} from the build's `ptxas -v` report."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            out[name] = [None, 0, 0]
        elif name and "spill stores" in line:
            out[name][1:] = map(int, re.findall(r"(\d+) bytes spill (?:stores|loads)", line))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            out[name][0] = int(m.group(1))
    return out


# the instances of the Hopper GEMM core (gemm.cuh), by kernel name: K1/K2's
# GEMM (4 epilogues) and K7/K8's bf16 3x3 conv (4 epilogues)
CORE_INSTANCES = {"gemm_sm90": 4, "conv_sm90": 4}
# the attention kernels this build must hold on the warpgroup-MMA core, by a
# regular expression on the mangled name: K9's bf16 backward at D = 256
# (dK/dV and dQ), K6's fp32 forward (3xTF32, at DP = 32, 64, 128) and K9's
# fp32 forward and backward (dK/dV and dQ) at D = 64, 128, 256
ATTN_INSTANCES = {r"flash_bwd_dkv_sm90ILi256E": 1, r"flash_bwd_dq_sm90ILi256E": 1,
                  r"small_attention_tf32I": 3, r"flash_fwd_tf32I": 3,
                  r"flash_bwd_dkv_tf32I": 3, r"flash_bwd_dq_tf32I": 3}
# the old WMMA backward kernels in bf16, which must not be in the library
WMMA_BF16 = r"flash_bwd_(dkv|dq)I(?!f)"
# K7/K8's fp32 3x3 conv on the 3xTF32 tensor-core policy, 4 epilogues
TF32_CONV = {"conv_tf32_sm90": 4}
# the scalar-FMA fp32 attention and conv kernels, which must not be in the library
FMA_F32 = r"flash_fwd_f32|flash_bwd_(dkv|dq)If|conv3x3_fp32"


def hgmma_counts(lib_path, patterns) -> dict:
    """{kernel (mangled name) matching one of `patterns`: HGMMA instructions
    in its SASS}, from cuobjdump -sass on the built library."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    out = {}
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        name = fn.split("\n", 1)[0].strip()
        if any(re.search(p, name) for p in patterns):
            out[name] = fn.count("HGMMA")
    return out


def graph_time(fn, reps: int):
    """Mean milliseconds of fn() replayed from one CUDA graph of `reps` calls,
    by CUDA events: the device's time, without the host's. A short kernel's
    Python wrapper can take longer than the kernel, and cuda_time then times
    the host."""
    import torch
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    g.replay()
    t1.record()
    torch.cuda.synchronize()
    del g
    return t0.elapsed_time(t1) / reps


def device_time(fn, reps: int):
    """Mean device milliseconds of fn() over `reps` calls: the sum of the
    kernels' times under torch.profiler, without the gaps between them.
    For a call that cannot be captured in a CUDA graph (autograd's backward
    of a library op), timed the same way as the kernel it is held against."""
    import torch
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(e.device_time for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False))
    if total <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    return total / 1e3 / reps


def ratios(row):
    """The row with ms / library_ms and bound_ms / ms beside its numbers."""
    if row.get("library_ms"):
        row["ms_over_library"] = row["ms"] / row["library_ms"]
    row["bound_over_ms"] = row["bound_ms"] / row["ms"]
    return row


def max_err(a, b):
    d = (a.float() - b.float()).abs().max().item()
    scale = b.float().abs().max().item()
    return d, d / max(scale, 1e-30), scale


def bound(nbytes, ops, peak):
    """(ms, what bounds it): the least time for `nbytes` of device memory
    traffic (each input read once, each output written once) and `ops`
    operations at `peak` per second."""
    tb, to = nbytes / HBM_BYTES_S * 1e3, ops / peak * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# ----------------------------------------------------------------- phase 3

def check_site_attention(dev, gen, name, rows, N, C, Hh):
    """K1's attention launch alone at a site's shape, (rows, N, C) bf16 with
    the heads side by side, against K6 on the same values laid out per head
    (rows, H, N, 64): bit-identical. Beside it, K6 and SDPA on the per-head
    layout; all three timed from a CUDA graph (`_eager`: one by one)."""
    import torch
    import torch.nn.functional as F
    from align3r_tpu_torch.ops import fused_site as fs
    from align3r_tpu_torch.ops import small_attention as sa
    q, k, v = (torch.randn(rows, N, C, generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    per_head = lambda t: t.reshape(rows, N, Hh, C // Hh).transpose(1, 2).contiguous()
    qh, kh, vh = per_head(q), per_head(k), per_head(v)
    kern = lambda: fs.site_attention(q, k, v, Hh)
    k6 = lambda: sa.small_attention(qh, kh, vh)
    lib = lambda: F.scaled_dot_product_attention(qh, kh, vh)
    out, ref6 = kern(), k6()
    ref = fs.site_attention_plain(q, k, v, Hh)
    torch.cuda.synchronize()
    same = torch.equal(per_head(out), ref6)
    err, rel, scale = max_err(out, ref)
    b_ms, b_by = bound(4 * rows * N * C * 2, 4 * rows * N * N * C, PEAK_BF16)
    row = ratios(dict(
        kernel="K1", shape=f"{name} attention launch alone ({rows}, {N}, {C}) H={Hh}",
        max_abs_err=err, max_rel_err=rel, tol=f"bits of K6; plain {1.6e-2 * scale:.3g}",
        ok=same and err <= 1.6e-2 * scale, bits_of_k6=same, ms=graph_time(kern, 20),
        ms_eager=cuda_time(kern, 20), plain_ms=cuda_time(lambda: fs.site_attention_plain(
            q, k, v, Hh), 3), k6_ms=graph_time(k6, 20), library_ms=graph_time(lib, 20),
        bound_ms=b_ms, bound_by=b_by))
    row["ms_over_k6"] = row["ms"] / row["k6_ms"]
    return row


def check_sites(dev, gen):
    """K1 and K2 against their plain versions at the main path's shapes,
    and, untimed, at the demo phase's batches (DEMO_SITE_B). Tolerance: 2 bf16 ulps at the output's largest magnitude (1.6e-2 x
    max|plain|); the two sides round q, k, v, P and the output to bf16 at the
    same points but accumulate in a different order. Timed from a CUDA graph
    (device time; `_eager`: launched one by one). Beside the encoder's and
    the decoder's self site, K1's attention launch alone
    (check_site_attention)."""
    import torch
    from align3r_tpu_torch.ops import fused_site as fs
    bf = torch.bfloat16

    def rnd(*s, scale=1.0, dtype=bf):
        return (torch.randn(*s, generator=gen, device=dev) * scale).to(dtype)

    def ln(G, C):
        return (1 + rnd(G, C, scale=0.1, dtype=torch.float32),
                rnd(G, C, scale=0.1, dtype=torch.float32))

    rows = []
    pos = None
    for name, G, Bn, C, Hh, cross in (
            ("encoder self", 1, 16, 1024, 16, False),
            ("decoder self", 2, 32, 768, 12, False),
            ("decoder cross", 2, 32, 768, 12, True)):
        from align3r_tpu_torch.models.rope import make_grid_positions
        pos = make_grid_positions(H // 16, W // 16, device=dev)
        N = pos.shape[0]
        w = [rnd(G, C, C, scale=C ** -0.5) for _ in range(4)]
        b = [rnd(G, C, scale=0.1, dtype=torch.float32) for _ in range(4)]
        lnq = ln(G, C)
        lnkv = ln(G, C) if cross else "same"
        cos, sin = fs.site_tables(pos, C // Hh, 100.0, bf)
        for Bs in (Bn, *DEMO_SITE_B[name.split()[0]]):
            x = rnd(G, Bs, N, C)
            kv = rnd(G, Bs, N, C) if cross else x
            kern = lambda: fs.attention_site(x, kv, *w, *b, pos, Hh, 100.0,
                                             ln_q=lnq, ln_kv=lnkv, residual=True)
            plain = lambda: fs.site_plain(x, kv, *w, *b, cos, sin, Hh, ln_q=lnq,
                                          ln_kv=lnkv, residual=True)
            out, ref = kern(), plain()
            torch.cuda.synchronize()
            err, rel, scale = max_err(out, ref)
            ok = err <= 1.6e-2 * scale and torch.isfinite(out.float()).all().item()
            row = dict(kernel="K1", shape=f"{name} G={G} B={Bs} N={N} C={C} H={Hh}",
                       max_abs_err=err, max_rel_err=rel, tol=1.6e-2 * scale, ok=ok)
            if Bs == Bn:   # the main path's shape: timed
                act = G * Bn * N * C * 2
                nbytes = (act * (3 if cross else 2) + 4 * G * C * C * 2 + 4 * G * C * 4
                          + (2 if cross else 1) * 2 * G * C * 4 + 2 * N * (C // Hh) * 2)
                b_ms, b_by = bound(nbytes, 8 * G * Bn * N * C * C + 4 * G * Bn * N * N * C,
                                   PEAK_BF16)
                row.update(ms=graph_time(kern, 10), ms_eager=cuda_time(kern, 10),
                           plain_ms=cuda_time(plain, 3), bound_ms=b_ms, bound_by=b_by)
            rows.append(row)
            del x, kv, out, ref
        del w
        if not cross:
            rows.append(check_site_attention(dev, gen, name, G * Bn, N, C, Hh))
    for name, G, Bn, C in (("encoder mlp", 1, 16, 1024), ("decoder mlp", 2, 32, 768)):
        N = pos.shape[0]
        F = 4 * C
        w1, w2 = rnd(G, C, F, scale=C ** -0.5), rnd(G, F, C, scale=F ** -0.5)
        b1 = rnd(G, F, scale=0.1, dtype=torch.float32)
        b2 = rnd(G, C, scale=0.1, dtype=torch.float32)
        lnp = ln(G, C)
        for Bs in (Bn, *DEMO_SITE_B[name.split()[0]]):
            x = rnd(G, Bs, N, C)
            kern = lambda: fs.mlp_site(x, w1, b1, w2, b2, ln=lnp, residual=True)
            plain = lambda: fs.mlp_plain(x, w1, b1, w2, b2, ln=lnp, residual=True)
            out, ref = kern(), plain()
            torch.cuda.synchronize()
            err, rel, scale = max_err(out, ref)
            ok = err <= 1.6e-2 * scale and torch.isfinite(out.float()).all().item()
            row = dict(kernel="K2", shape=f"{name} G={G} B={Bs} N={N} C={C} F={F}",
                       max_abs_err=err, max_rel_err=rel, tol=1.6e-2 * scale, ok=ok)
            if Bs == Bn:
                nbytes = (2 * G * Bn * N * C * 2 + 2 * G * C * F * 2 + G * (F + C) * 4
                          + 2 * G * C * 4)
                b_ms, b_by = bound(nbytes, 4 * G * Bn * N * C * F, PEAK_BF16)
                row.update(ms=graph_time(kern, 10), ms_eager=cuda_time(kern, 10),
                           plain_ms=cuda_time(plain, 3), bound_ms=b_ms, bound_by=b_by)
            rows.append(row)
            del x, out, ref
        del w1, w2
    rows += check_layernorm(dev, gen)
    return rows


def check_layernorm(dev, gen):
    """K1/K2's LayerNorm launch alone (fused_site._ln_cuda) at the encoder's
    9,216 rows x 1024 and the decoder's 2 streams x 18,432 rows x 768, bf16,
    against its plain version _ln. Tolerance: 2 bf16 ulps of max|plain|
    (1.6e-2 x max), as for the sites: fp32 statistics summed in another
    order, one rounding to bf16. Timed from a CUDA graph beside
    F.layer_norm on the same bf16 rows with bf16 weights (one call per
    stream), the library call the port never makes; bound by bytes (x read,
    y written, the fp32 scale and bias read). Each timed call takes the next
    of LN_ROTATE inputs and writes a new output, the last 2 x LN_ROTATE
    outputs kept alive, so that a call reads x from HBM and not from the
    50 MB L2 as its bound assumes (at the encoder's 18.9 MB a row set, one
    x alone would stay in L2)."""
    import collections
    import itertools
    import torch
    import torch.nn.functional as F
    from align3r_tpu_torch.ops import _lib
    from align3r_tpu_torch.ops import fused_site as fs
    N = (H // 16) * (W // 16)
    lib = _lib.library()
    rows = []
    for name, G, Bn, C in (("encoder", 1, 16, 1024), ("decoder", 2, 32, 768)):
        xs = [torch.randn(G, Bn, N, C, generator=gen, device=dev).to(torch.bfloat16)
              for _ in range(LN_ROTATE)]
        p = (1 + 0.1 * torch.randn(G, C, generator=gen, device=dev),
             0.1 * torch.randn(G, C, generator=gen, device=dev))
        wb = [t.to(torch.bfloat16) for t in p]
        keep = collections.deque(maxlen=2 * LN_ROTATE)

        def rotated(f):
            turn = itertools.count()
            return lambda: keep.append(f(xs[next(turn) % LN_ROTATE]))

        kern = rotated(lambda x: fs._ln_cuda(lib, x, p, _lib.stream()))
        library = rotated(lambda x: [F.layer_norm(x[g], (C,), wb[0][g], wb[1][g], 1e-6)
                                     for g in range(G)])
        out, ref = fs._ln_cuda(lib, xs[0], p, _lib.stream()), fs._ln(xs[0], p)
        torch.cuda.synchronize()
        err, rel, scale = max_err(out, ref)
        b_ms, b_by = bound(2 * G * Bn * N * C * 2 + 2 * G * C * 4, 8 * G * Bn * N * C, PEAK_FP32)
        rows.append(ratios(dict(
            kernel="K1/K2 LN", shape=f"LayerNorm launch {name} G={G} rows={Bn * N} C={C} bf16",
            max_abs_err=err, max_rel_err=rel, tol=1.6e-2 * scale,
            ok=err <= 1.6e-2 * scale and torch.isfinite(out.float()).all().item(),
            ms=graph_time(kern, 20), ms_eager=cuda_time(kern, 20),
            plain_ms=cuda_time(lambda: fs._ln(xs[0], p), 5),
            library_ms=graph_time(library, 20), bound_ms=b_ms, bound_by=b_by)))
        keep.clear()
        del xs, out, ref
    return rows


def check_gemms(dev, gen):
    """Each GEMM launch of K1 and K2 alone (csrc/gemm.cuh) at the main path's
    shapes, 576 tokens a row: the encoder's (1 stream x 16 images, C = 1024,
    F = 4096) and the decoder's (2 streams x 32 pairs, C = 768, F = 3072)
    q/k (bias + RoPE), v (bias), out-projection (bias + residual), fc1 (bias +
    GELU) and fc2 (bias + residual), against gemm_plain. Tolerance: 2 bf16
    ulps of max|plain| (1.6e-2 x max): both round at the same points after
    fp32 sums in another order. Timed from a CUDA graph, with its 128 x 128
    tiles and their rounds of the card's SMs; beside it torch.addmm
    (torch.baddbmm for 2 streams) of the same bf16 product plus a bf16 bias,
    the library call the port never makes, timed the same way."""
    import torch
    from align3r_tpu_torch.ops import fused_site as fs
    bf = torch.bfloat16
    N_tok = (H // 16) * (W // 16)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ang = torch.randn(N_tok, 64, generator=gen, device=dev) * 3
    cos, sin = torch.cos(ang).to(bf), torch.sin(ang).to(bf)
    rows = []
    for site, G, Bn, C in (("encoder", 1, 16, 1024), ("decoder", 2, 32, 768)):
        M, F = Bn * N_tok, 4 * C
        for kern_name, launch, N, K, epi in (
                ("K1", "q/k (bias + RoPE)", C, C, fs.EPI_ROPE),
                ("K1", "v (bias)", C, C, fs.EPI_BIAS),
                ("K1", "out-projection (bias + residual)", C, C, fs.EPI_RESID),
                ("K2", "fc1 (bias + GELU)", F, C, fs.EPI_GELU),
                ("K2", "fc2 (bias + residual)", C, F, fs.EPI_RESID)):
            a = torch.randn(G, M, K, generator=gen, device=dev).to(bf)
            w = (torch.randn(G, K, N, generator=gen, device=dev) * K ** -0.5).to(bf)
            b = torch.randn(G, N, generator=gen, device=dev) * 0.1
            resid = torch.randn(G, M, N, generator=gen, device=dev).to(bf) \
                if epi == fs.EPI_RESID else None
            kw = dict(resid=resid, cos=cos if epi == fs.EPI_ROPE else None,
                      sin=sin if epi == fs.EPI_ROPE else None, rope_d=64, rope_n=N_tok)
            kern = lambda: fs.gemm(a, w, b, epi, **kw)
            plain = lambda: fs.gemm_plain(a, w, b, epi, **kw)
            out, ref = kern(), plain()
            torch.cuda.synchronize()
            err, rel, scale = max_err(out, ref)
            bb = b.to(bf)
            lib = ((lambda: torch.addmm(bb[0], a[0], w[0])) if G == 1
                   else (lambda: torch.baddbmm(bb[:, None], a, w)))
            flop = 2 * G * M * N * K
            nbytes = (G * (M * K + K * N + M * N) * 2 + G * N * 4
                      + (G * M * N * 2 if resid is not None else 0))
            b_ms, b_by = bound(nbytes, flop, PEAK_BF16)
            ms = graph_time(kern, 20)
            tiles = G * -(-M // fs.GEMM_BM) * (N // fs.GEMM_BN)
            rows.append(ratios(dict(
                kernel=kern_name, shape=f"GEMM {site} {launch} G={G} M={M} N={N} K={K}",
                max_abs_err=err, max_rel_err=rel, tol=1.6e-2 * scale,
                ok=err <= 1.6e-2 * scale and torch.isfinite(out.float()).all().item(),
                tiles=tiles, rounds=tiles / sms, ms=ms,
                tflops=flop / ms / 1e9, plain_ms=cuda_time(plain, 3),
                library_ms=graph_time(lib, 20), bound_ms=b_ms, bound_by=b_by)))
            del a, w, resid, out, ref
    return rows


def kernel_split(fn, reps: int, main: str) -> dict:
    """Device ms per call of fn()'s kernels under torch.profiler over `reps`
    calls: those whose name matches the regular expression `main`, and the
    rest ("second pass")."""
    import torch
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = {"main": 0.0, "second pass": 0.0}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(
                e, "is_user_annotation", False):
            split["main" if re.search(main, e.name) else "second pass"] += \
                e.device_time / 1e3 / reps
    return split


def check_edge(dev, gen, n=N_FRAMES, pairs=None):
    """K3/K4 against their plain versions, bf16 and fp32 storage: at 24
    frames (e2 = 380 terms of random images, A = 147,456), timed; or, given
    a scene graph's `pairs` over `n` frames, untimed at its terms (e2 = 2
    pairs, image i's then image j's, as the solve packs them). Tolerance:
    relative 1e-4 of the largest value (fp32 arithmetic on both sides, sums
    in another order); two launches must give the same bits. Timed from a
    CUDA graph with the terms sorted by image, as the pack lays them out (ms;
    `ms_eager`: one by one, CUDA events), and in the random order of the
    check (ms_unsorted, from a graph); split by launch (the walk, the second
    pass) under torch.profiler."""
    import torch
    from align3r_tpu_torch.ops import edge_loss as el
    e2, A = (380 if pairs is None else 2 * len(pairs)), H * W
    rows = []
    for dt in (torch.bfloat16, torch.float32):
        proj = torch.randn(n, 3, A, generator=gen, device=dev)
        pred = torch.randn(e2, 3, A, generator=gen, device=dev).to(dt)
        w = (torch.rand(e2, A, generator=gen, device=dev) / (e2 * A)).to(dt)
        idx = (torch.randint(0, n, (e2,), generator=gen, device=dev, dtype=torch.int32)
               if pairs is None else torch.tensor([p[0] for p in pairs] + [p[1] for p in pairs],
                                                  dtype=torch.int32, device=dev))
        pw34 = (torch.eye(3, 4, device=dev)[None]
                + 0.1 * torch.randn(e2, 3, 4, generator=gen, device=dev)).contiguous()
        order, offsets = (t.to(dev) for t in el.term_csr(idx, n))
        g = torch.tensor(1.5, device=dev)
        kf = lambda: el.edge_loss_fwd(proj, pw34, pred, w, idx, order, offsets)
        pf = lambda: el.edge_loss_fwd_plain(proj, pw34, pred, w, idx)
        kb = lambda: el.edge_loss_bwd(g, proj, pw34, pred, w, idx, order, offsets)
        pb = lambda: el.edge_loss_bwd_plain(g, proj, pw34, pred, w, idx)
        lk, lp = kf(), pf()
        (dpk, dmk), (dpp, dmp) = kb(), pb()
        lk2, (dpk2, dmk2) = kf(), kb()
        torch.cuda.synchronize()
        same_f = torch.equal(lk, lk2)
        same_b = torch.equal(dpk, dpk2) and torch.equal(dmk, dmk2)
        tag = "bf16" if dt == torch.bfloat16 else "fp32"
        ef = max_err(lk, lp)
        # bytes: proj once, the 3x4 matrices, pred, w, the CSR, the loss;
        # about 30 fp32 operations per (term, pixel): transform, residual,
        # norm, weight
        isz = 2 if dt == torch.bfloat16 else 4
        fwd_bytes = (n * 3 * A * 4 + e2 * 48 + e2 * 3 * A * isz + e2 * A * isz + e2 * 4
                     + (n + 1) * 4)
        b_ms, b_by = bound(fwd_bytes + 4, 30 * e2 * A, PEAK_FP32)
        idx_s = torch.sort(idx).values
        order_s, offsets_s = (t.to(dev) for t in el.term_csr(idx_s, n))
        kf_s = lambda: el.edge_loss_fwd(proj, pw34, pred, w, idx_s, order_s, offsets_s)
        kb_s = lambda: el.edge_loss_bwd(g, proj, pw34, pred, w, idx_s, order_s, offsets_s)
        es = max_err(kf_s(), el.edge_loss_fwd_plain(proj, pw34, pred, w, idx_s))
        es_b = [max_err(a, b) for a, b in zip(kb_s(), el.edge_loss_bwd_plain(
            g, proj, pw34, pred, w, idx_s))]
        row = dict(kernel="K3", shape=f"{tag} e2={e2} A={A} n={n}",
                   max_abs_err=max(ef[0], es[0]), max_rel_err=max(ef[1], es[1]),
                   tol=1e-4 * ef[2], same_bits=same_f,
                   ok=ef[0] <= 1e-4 * ef[2] and es[0] <= 1e-4 * es[2] and same_f)
        if pairs is None:
            row = ratios(dict(row, ms=graph_time(kf_s, 20), ms_eager=cuda_time(kf_s, 20),
                              ms_unsorted=graph_time(kf, 20),
                              split_ms=kernel_split(kf_s, 10, "edge_fwd"),
                              plain_ms=cuda_time(pf, 3), bound_ms=b_ms, bound_by=b_by))
        rows.append(row)
        e1, e2m = max_err(dpk, dpp), max_err(dmk, dmp)
        row = dict(kernel="K4", shape=f"{tag} e2={e2} A={A} n={n}",
                   max_abs_err=max(e1[0], e2m[0], *(e[0] for e in es_b)),
                   max_rel_err=max(e1[1], e2m[1], *(e[1] for e in es_b)),
                   tol=f"1e-4 x max (dproj {1e-4 * e1[2]:.3g}, dM {1e-4 * e2m[2]:.3g})",
                   ok=(e1[0] <= 1e-4 * e1[2] and e2m[0] <= 1e-4 * e2m[2] and same_b
                       and all(e[0] <= 1e-4 * e[2] for e in es_b)),
                   same_bits=same_b)
        if pairs is None:
            # the forward's reads and g, plus dproj and dM written; about
            # twice its work
            b_ms, b_by = bound(fwd_bytes + 4 + n * 3 * A * 4 + e2 * 48, 60 * e2 * A,
                               PEAK_FP32)
            row = ratios(dict(row, bound_ms=b_ms, bound_by=b_by, ms=graph_time(kb_s, 20),
                              ms_eager=cuda_time(kb_s, 20), ms_unsorted=graph_time(kb, 20),
                              split_ms=kernel_split(kb_s, 10, "edge_bwd"),
                              plain_ms=cuda_time(pb, 3)))
        rows.append(row)
        del proj, pred, w, dpk, dpp, dpk2
    return rows


def check_edge_scenes(dev, gen, S=BATCH_SCENES, n=N_FRAMES, e2=380):
    """K3/K4 with a scene axis: S scenes of the main path's shape (n images,
    e2 image-sorted terms, A = 147,456) laid end to end (stack_packs), bf16
    and fp32 storage. Against the plain versions (relative 1e-4 of the
    largest value); each scene's loss within 1e-6 relative of its own S = 1
    launch and its dproj and dM bit for bit (the same walk); two launches
    give the same bits. Timed from a CUDA graph beside S x the S = 1 bound."""
    import torch
    from align3r_tpu_torch.ops import edge_loss as el
    A = H * W
    rows = []
    for dt in (torch.bfloat16, torch.float32):
        proj = torch.randn(S, n, 3, A, generator=gen, device=dev)
        pred = torch.randn(S, e2, 3, A, generator=gen, device=dev).to(dt)
        w = (torch.rand(S, e2, A, generator=gen, device=dev) / (e2 * A)).to(dt)
        idx = torch.sort(torch.randint(0, n, (S, e2), generator=gen, device=dev,
                                       dtype=torch.int32), dim=1).values
        pw34 = (torch.eye(3, 4, device=dev)[None, None]
                + 0.1 * torch.randn(S, e2, 3, 4, generator=gen, device=dev)).contiguous()
        csr = [el.term_csr(idx[z], n) for z in range(S)]
        order = torch.stack([c[0] for c in csr]).to(dev)
        offsets = torch.stack([c[1] for c in csr]).to(dev)
        fi, fo, ff = el.stack_packs(idx, order, offsets, n)
        flat = [t.reshape(-1, *t.shape[2:]) for t in (proj, pw34, pred, w)]
        one = lambda z: (proj[z], pw34[z], pred[z], w[z], idx[z], order[z], offsets[z])
        g = torch.tensor([1.5, 0.5, 2.0, 1.0][:S], device=dev)
        kf = lambda: el.edge_loss_fwd(*flat, fi, fo, ff, scenes=S)
        kb = lambda: el.edge_loss_bwd(g, *flat, fi, fo, ff, scenes=S)
        pf = lambda: el.edge_loss_fwd_plain(*flat, fi, scenes=S)
        pb = lambda: el.edge_loss_bwd_plain(g, *flat, fi, scenes=S)
        lk, (dpk, dmk) = kf(), kb()
        lk2, (dpk2, dmk2) = kf(), kb()
        lp = pf()
        torch.cuda.synchronize()
        same_f = torch.equal(lk, lk2)
        same_b = torch.equal(dpk, dpk2) and torch.equal(dmk, dmk2)
        ones = [el.edge_loss_fwd(*one(z)) for z in range(S)]
        own = max(abs(lk[z].item() - ones[z].item()) / abs(ones[z].item()) for z in range(S))
        bits_b = all(torch.equal(dpk[z * n:(z + 1) * n], d1) and torch.equal(
            dmk[z * e2:(z + 1) * e2], m1) for z in range(S)
            for d1, m1 in [el.edge_loss_bwd(g[z], *one(z))])
        tag = "bf16" if dt == torch.bfloat16 else "fp32"
        isz = 2 if dt == torch.bfloat16 else 4
        fwd_bytes = (n * 3 * A * 4 + e2 * 48 + e2 * 3 * A * isz + e2 * A * isz + e2 * 4
                     + (n + 1) * 4)
        ef = max_err(lk, lp)
        b_ms, b_by = bound(S * (fwd_bytes + 4), S * 30 * e2 * A, PEAK_FP32)
        shape = f"{tag} S={S} n={S}x{n} e2={S}x{e2} A={A}, image-sorted"
        rows.append(ratios(dict(
            kernel="K3 scenes", shape=shape, max_abs_err=ef[0], max_rel_err=ef[1],
            tol=f"1e-4 x max; each scene 1e-6 of its S = 1 launch ({own:.3g})",
            same_bits=same_f, own_launch_rel_err=own,
            ok=ef[0] <= 1e-4 * ef[2] and own <= 1e-6 and same_f,
            ms=graph_time(kf, 20), ms_eager=cuda_time(kf, 20),
            split_ms=kernel_split(kf, 10, "edge_fwd"), plain_ms=cuda_time(pf, 3),
            bound_ms=b_ms, bound_by=b_by)))
        del lp
        (dpp, dmp) = pb()
        e1, e2m = max_err(dpk, dpp), max_err(dmk, dmp)
        del dpp, dmp
        b_ms, b_by = bound(S * (fwd_bytes + 4 + n * 3 * A * 4 + e2 * 48), S * 60 * e2 * A,
                           PEAK_FP32)
        rows.append(ratios(dict(
            kernel="K4 scenes", shape=shape, max_abs_err=max(e1[0], e2m[0]),
            max_rel_err=max(e1[1], e2m[1]),
            tol=f"1e-4 x max (dproj {1e-4 * e1[2]:.3g}, dM {1e-4 * e2m[2]:.3g}); each "
                "scene's bits of its S = 1 launch",
            same_bits=same_b, own_launch_bits=bits_b,
            ok=e1[0] <= 1e-4 * e1[2] and e2m[0] <= 1e-4 * e2m[2] and same_b and bits_b,
            ms=graph_time(kb, 20), ms_eager=cuda_time(kb, 20),
            split_ms=kernel_split(kb, 10, "edge_bwd"), plain_ms=cuda_time(pb, 3),
            bound_ms=b_ms, bound_by=b_by)))
        del proj, pred, w, flat, dpk, dpk2
        torch.cuda.empty_cache()
    return rows


def check_k5(dev, gen, n=N_FRAMES, graph="swinstride-5-noncyclic", timed=True):
    """K5 against its plain version, bf16 and fp32, on the image-sorted perm
    of `graph` over `n` frames: at 24 frames of the swinstride-5 graph (E =
    190 edges, e2 = 380 slots, A = 147,456) with every 19th slot made a
    dummy (perm 0, valid 0), timed; untimed at the demo phase's graphs with
    the pack's own layout (every slot valid). Tolerance: bit-identical. Beside it, torch.index_select of the same rows
    of the stacked [i; j] packs (pred and w), the library call the port
    never makes."""
    import numpy as np
    import torch
    from align3r_tpu_torch.inference.pairs import make_pairs
    from align3r_tpu_torch.ops import edge_loss as el
    pairs = make_pairs(n, graph, symmetrize=True)
    E, A = len(pairs), H * W
    idx = np.array([p[0] for p in pairs] + [p[1] for p in pairs])
    perm = np.argsort(idx, kind="stable").astype(np.int32)
    valid = np.ones(2 * E, np.int32)
    if timed:
        valid[::19], perm[::19] = 0, 0
    perm_d, valid_d = (torch.from_numpy(a).to(dev) for a in (perm, valid))
    rows = []
    for dt in (torch.bfloat16, torch.float32):
        pi, pj = (torch.randn(E, 3, A, generator=gen, device=dev).to(dt) for _ in range(2))
        wi, wj = (torch.rand(E, A, generator=gen, device=dev).to(dt) for _ in range(2))
        kern = lambda: el.permute_packed(pi, pj, wi, wj, perm_d, valid_d)
        plain = lambda: el.permute_packed_plain(pi, pj, wi, wj, perm_d, valid_d)
        (pk, wk), (pp, wp) = kern(), plain()
        torch.cuda.synchronize()
        ok = torch.equal(pk, pp) and torch.equal(wk, wp)
        err = max((pk.float() - pp.float()).abs().max().item(),
                  (wk.float() - wp.float()).abs().max().item())
        p_cat, w_cat, perm_l = torch.cat([pi, pj]), torch.cat([wi, wj]), perm_d.long()
        lib = lambda: (torch.index_select(p_cat, 0, perm_l), torch.index_select(w_cat, 0, perm_l))
        isz = pk.element_size()
        # each slot's source rows read once and its rows written once
        b_ms, b_by = bound(2 * 2 * E * 4 * A * isz + 2 * 2 * E * 4, 2 * E * A, PEAK_FP32)
        row = dict(kernel="K5", shape=f"{'bf16' if dt == torch.bfloat16 else 'fp32'} "
                   f"n={n} E={E} e2={2 * E} A={A}, {int((valid == 0).sum())} dummy slots",
                   max_abs_err=err, max_rel_err=0.0 if ok else None, tol=0.0, ok=ok)
        if timed:
            row.update(ms=cuda_time(kern, 20), plain_ms=cuda_time(plain, 5),
                       library_ms=cuda_time(lib, 20), bound_ms=b_ms, bound_by=b_by)
        rows.append(row)
        del pi, pj, wi, wj, pk, wk, pp, wp, p_cat, w_cat
    return rows


def check_k7(dev, gen):
    """K7 against its plain version at the pipeline heads' four refinenet
    shapes (decode batch 32 at 512x288, and the last batch of the main
    path's 190 pairs, TAIL_BATCH = 30), without and with a base (the fusion
    block's x + res1(skip)), in bf16 and fp32. Tolerance: bf16, 2 bf16
    ulps of max|plain| (1.6e-2 x max): both round each conv's fp32 sum plus
    bias to bf16 at the same points, summed in another order; fp32, 1e-4 x
    max (3xTF32 products within about 2^-21, sums in another order). At
    batch 32 beside it, the port's XLA-path residual unit on the same inputs
    (the default head's chain: cuDNN convolutions, TF32 off); no single
    PyTorch call computes the unit. Both are timed from a CUDA graph and
    launched one by one (`_eager`), and the unit's device time is split by
    launch under torch.profiler (conv 1, conv 2 with the residual, the
    weights' stack, cast and, in fp32, TF32 split as `other`). The batch of
    30 is checked untimed. Bound: the operations at the bf16 peak, in fp32
    three TF32 products each (3xTF32) at the TF32 peak."""
    import torch
    from align3r_tpu_torch.models.dpt_head import _residual_conv_unit
    from align3r_tpu_torch.ops import dpt_pipeline as dp
    from align3r_tpu_torch.tools.profile_heads import K7_PARTS
    from align3r_tpu_torch.tools.profile_site import split_site
    torch.backends.cudnn.allow_tf32 = False
    C = 256
    rows = []
    for dt in (torch.bfloat16, torch.float32):
        conv = lambda: ((torch.randn(C, C, 3, 3, generator=gen, device=dev) / (3 * C ** 0.5)).to(
            dt), (0.1 * torch.randn(C, generator=gen, device=dev)).to(dt))
        unit = (conv(), conv())
        w, b = dp._unit_weights(unit, dt)
        f32 = dt == torch.float32
        for hw in ((72, 128), (36, 64), (18, 32), (9, 16)):     # the largest share first
            for B_ in (BATCH, TAIL_BATCH):
                v, base = (torch.randn(B_, *hw, C, generator=gen, device=dev).to(dt)
                           for _ in range(2))
                for bs in (None, base):
                    kern = lambda: dp.fused_res_unit(v, unit, bs)
                    plain = lambda: dp.res_unit_plain(v, bs, w, b)
                    xla = ((lambda: _residual_conv_unit(unit, v)) if bs is None
                           else (lambda: bs + _residual_conv_unit(unit, v)))
                    out, ref = kern(), plain()
                    torch.cuda.synchronize()
                    err, rel, scale = max_err(out, ref)
                    tol = (1e-4 if f32 else 1.6e-2) * scale
                    shape = (f"({B_}, {hw[0]}, {hw[1]}, {C}) {'fp32' if f32 else 'bf16'}"
                             f"{' + base' if bs is not None else ''}")
                    row = dict(kernel="K7 fp32" if f32 else "K7", shape=shape,
                               max_abs_err=err, max_rel_err=rel, tol=tol,
                               ok=err <= tol and torch.isfinite(out.float()).all().item())
                    del out, ref
                    if B_ == BATCH:
                        px = B_ * hw[0] * hw[1]
                        isz = v.element_size()
                        act = px * C * isz
                        flop = 2 * 2 * 9 * C * C * px
                        b_ms, b_by = bound(act * (3 if bs is not None else 2)
                                           + 2 * 9 * C * C * isz + 2 * C * 4,
                                           3 * flop if f32 else flop,
                                           PEAK_TF32 if f32 else PEAK_BF16)
                        split = split_site(shape, kern, K7_PARTS, 10)
                        row = ratios(dict(
                            row, ms=split["graph_ms"], ms_eager=cuda_time(kern, 10),
                            split_ms=split["split_ms"], plain_ms=cuda_time(plain, 2),
                            library_ms=None, xla_chain_ms=graph_time(xla, 10),
                            xla_chain_ms_eager=cuda_time(xla, 10), bound_ms=b_ms,
                            bound_by=b_by))
                    rows.append(row)
                del v, base
    return rows


def check_k8(dev, gen):
    """K8 against its plain version at the pipeline heads' tail: path1 of a
    decode batch of 32 at 512x288, (32, 144, 256, 256) -> (32, 288, 512, 4)
    fp32, from bf16 and from fp32 (the fp32 heads' run), and of the main
    path's last batch (TAIL_BATCH = 30) in both dtypes, untimed; and at
    (4, 72, 128, 256) fp32. Tolerance: 2 bf16 ulps of max|plain| in bf16
    (h1, the column mix and the row mix are rounded at the same points on
    both sides after fp32 sums in another order); 1e-4 x max in fp32. Beside
    it, the port's XLA-path head tail on the same inputs (the default head's
    chain, cuDNN with TF32 off); no single PyTorch call computes the tail.
    Both from a CUDA graph and one by one (`_eager`; at the fp32 batch of 32
    over 2 calls), the tail's device time split by launch (conv 1, the
    upsample, conv 2 with the 1x1). The plain version's time at the fp32
    batch of 32 is that of the one call that gives the reference. Bound: the
    convs' and the upsample's operations at the bf16 peak, the 1x1's at the
    fp32 peak; in fp32 the convs as three TF32 products each at the TF32
    peak, the rest at the fp32 peak."""
    import torch
    from align3r_tpu_torch.models import nn as L
    from align3r_tpu_torch.ops import dpt_pipeline as dp
    from align3r_tpu_torch.tools.profile_heads import K8_PARTS
    from align3r_tpu_torch.tools.profile_site import split_site
    torch.backends.cudnn.allow_tf32 = False
    rows = []
    f32 = torch.float32
    for shape, dt, timed in (((BATCH, 144, 256, 256), torch.bfloat16, True),
                             ((TAIL_BATCH, 144, 256, 256), torch.bfloat16, False),
                             ((BATCH, 144, 256, 256), f32, True),
                             ((TAIL_BATCH, 144, 256, 256), f32, False),
                             ((4, 72, 128, 256), f32, True)):
        B_, Hin, Win, C1 = shape
        C2, Co = 128, 4
        x = torch.randn(*shape, generator=gen, device=dev).to(dt)
        p1 = ((torch.randn(C2, C1, 3, 3, generator=gen, device=dev) / (3 * C1 ** 0.5)).to(dt),
              (0.1 * torch.randn(C2, generator=gen, device=dev)).to(dt))
        p2 = ((torch.randn(C2, C2, 3, 3, generator=gen, device=dev) / (3 * C2 ** 0.5)).to(dt),
              (0.1 * torch.randn(C2, generator=gen, device=dev)).to(dt))
        p3 = (torch.randn(Co, C2, 1, 1, generator=gen, device=dev) / C2 ** 0.5,
              0.1 * torch.randn(Co, generator=gen, device=dev))
        ws = dp._head_weights(p1, p2, p3, dt)
        kern = lambda: dp.fused_head_final(x, p1, p2, p3)
        plain = lambda: dp.head_final_plain(x, *ws)

        def xla():
            h = L.conv2d(x, *p1, padding=1)
            h = L.bilinear_resize(h, 2 * Hin, 2 * Win, align_corners=True)
            h = torch.relu(L.conv2d(h, *p2, padding=1))
            return L.conv2d(h.float(), *p3)

        out = kern()
        torch.cuda.synchronize()
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        ref = plain()
        t1.record()
        torch.cuda.synchronize()
        err, rel, scale = max_err(out, ref)
        tol = (1.6e-2 if dt == torch.bfloat16 else 1e-4) * scale
        label = (f"{tuple(shape)} {'bf16' if dt == torch.bfloat16 else 'fp32'} -> "
                 f"({B_}, {2 * Hin}, {2 * Win}, {Co}) fp32")
        row = dict(kernel="K8" if dt == torch.bfloat16 else "K8 fp32", shape=label,
                   max_abs_err=err, max_rel_err=rel, tol=tol,
                   ok=err <= tol and torch.isfinite(out).all().item())
        del out, ref
        if timed:
            isz = x.element_size()
            px_in, px_out = B_ * Hin * Win, B_ * 4 * Hin * Win
            conv_ops = 2 * 9 * C1 * C2 * px_in + 2 * 9 * C2 * C2 * px_out
            up_ops, ops32 = 4 * 2 * C2 * px_out, 2 * C2 * Co * px_out
            t_conv = ((conv_ops + up_ops) / PEAK_BF16 if dt == torch.bfloat16
                      else 3 * conv_ops / PEAK_TF32 + up_ops / PEAK_FP32)
            t_ops = (t_conv + ops32 / PEAK_FP32) * 1e3
            t_bytes = ((px_in * C1 * isz + px_out * Co * 4 + 9 * (C1 + C2) * C2 * isz)
                       / HBM_BYTES_S * 1e3)
            b_ms, b_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
            big32 = dt == f32 and B_ == BATCH   # the fp32 cuDNN chain: seconds a call
            split = split_site(label, kern, K8_PARTS, 5)
            row = ratios(dict(
                row, ms=split["graph_ms"], ms_eager=cuda_time(kern, 5),
                split_ms=split["split_ms"],
                plain_ms=t0.elapsed_time(t1) if big32 else cuda_time(plain, 2, warmup=1),
                library_ms=None, xla_chain_ms=graph_time(xla, 2 if big32 else 5),
                xla_chain_ms_eager=cuda_time(xla, 2 if big32 else 5, warmup=1),
                bound_ms=b_ms, bound_by=b_by))
        rows.append(row)
        del x
    return rows


def check_k9(dev, gen):
    """K9's forward and backward against their plain versions at the 512x512
    training shapes (the encoder's 4 images x 16 heads, the decoder's and
    prior branch's 4 x 12 heads, 1024 tokens, D = 64, bf16), a ragged length
    (1000), D = 128 and D = 256 (whose bf16 backward runs two warpgroups per
    dK/dV block and 32-key dQ tiles), and fp32 at D = 64, 128 and 256 (3xTF32
    on the tensor cores; the D = 256 backward on clusters of two CTAs). The
    backward is held on the same (o, lse, dO).
    Tolerance: 2 bf16 ulps of max|plain| (1.6e-2 x max) in bf16: both round P
    against the same running max over the same key blocks, block_k (and P,
    dS to bf16 in the backward), summed in another order; 1e-4 x max in fp32.
    Beside each, scaled_dot_product_attention on the same inputs (forward;
    and its backward alone, on a retained graph), which the port never
    calls. The forwards are timed from a CUDA graph (device time; `_eager`:
    launched one by one). The backwards, K9's and SDPA's alike, are timed as
    the sum of their kernels' device time under torch.profiler (autograd's
    backward cannot be captured in a graph); K9's also from a CUDA graph
    (`ms_graph`) and one by one (`ms_eager`, SDPA's `library_ms_eager`).
    Both backwards run 7 products where the bound counts 5 (S and dP are
    recomputed in both of K9's kernels). fp32 bounds count each product as
    3 TF32 products at PEAK_TF32 (the least time of an fp32-accurate route
    on this card's tensor cores)."""
    import torch
    import torch.nn.functional as F
    from align3r_tpu_torch.ops import flash_attention as fa
    rows = []
    for name, shape, dt in (("encoder", (4, 16, 1024, 64), torch.bfloat16),
                            ("decoder / prior", (4, 12, 1024, 64), torch.bfloat16),
                            ("ragged", (4, 16, 1000, 64), torch.bfloat16),
                            ("fp32", (4, 16, 1024, 64), torch.float32),
                            ("D=128", (4, 8, 1024, 128), torch.bfloat16),
                            ("D=256", (4, 4, 1024, 256), torch.bfloat16),
                            ("fp32 D=128", (4, 8, 1024, 128), torch.float32),
                            ("fp32 D=256", (4, 4, 1024, 256), torch.float32)):
        q, k, v, do = (torch.randn(*shape, generator=gen, device=dev).to(dt) for _ in range(4))
        (o, lse), (ro, rlse) = fa.flash_attention_fwd(q, k, v), fa.flash_attention_plain(q, k, v)
        grads = fa.flash_attention_bwd(q, k, v, ro, rlse, do)
        refs = fa.flash_attention_bwd_plain(q, k, v, ro, rlse, do)
        torch.cuda.synchronize()
        rel_tol = 1.6e-2 if dt == torch.bfloat16 else 1e-4
        ef = max_err(o, ro)
        eb = [max_err(a, r) for a, r in zip(grads, refs)]
        ok_f = ef[0] <= rel_tol * ef[2] and torch.isfinite(o.float()).all().item()
        ok_b = all(e[0] <= rel_tol * e[2] for e in eb) and all(
            torch.isfinite(a.float()).all().item() for a in grads)
        qs, ks, vs = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
        so = F.scaled_dot_product_attention(qs, ks, vs)
        B_, H_, N_, D_ = shape
        isz = q.element_size()
        # fp32: an fp32-accurate product on the tensor cores is 3 TF32 ones
        peak, mult = (PEAK_BF16, 1) if isz == 2 else (PEAK_TF32, 3)
        heads = B_ * H_
        fb_ms, fb_by = bound(4 * heads * N_ * D_ * isz + heads * N_ * 4,
                             mult * 4 * heads * N_ * N_ * D_, peak)
        # the backward's five products: S, dP, dV, dK, dQ
        bb_ms, bb_by = bound(8 * heads * N_ * D_ * isz + heads * N_ * 4,
                             mult * 10 * heads * N_ * N_ * D_, peak)
        tag = f"{name} {tuple(shape)} {'bf16' if isz == 2 else 'fp32'}"
        kern = lambda: fa.flash_attention_fwd(q, k, v)
        lib = lambda: F.scaled_dot_product_attention(q, k, v)
        rows.append(ratios(dict(
            kernel="K9", shape=tag, max_abs_err=ef[0], max_rel_err=ef[1],
            tol=rel_tol * ef[2], ok=ok_f, ms=graph_time(kern, 20),
            ms_eager=cuda_time(kern, 20),
            plain_ms=cuda_time(lambda: fa.flash_attention_plain(q, k, v), 3),
            library_ms=graph_time(lib, 20), library_ms_eager=cuda_time(lib, 20),
            bound_ms=fb_ms, bound_by=fb_by)))
        kb = lambda: fa.flash_attention_bwd(q, k, v, ro, rlse, do)
        lb = lambda: torch.autograd.grad(so, (qs, ks, vs), do, retain_graph=True)
        rows.append(ratios(dict(kernel="K9 bwd", shape=tag, max_abs_err=max(e[0] for e in eb),
                         max_rel_err=max(e[1] for e in eb),
                         tol=f"{rel_tol} x max (dq {eb[0][2]:.3g}, dk {eb[1][2]:.3g}, "
                             f"dv {eb[2][2]:.3g})", ok=ok_b,
                         ms=device_time(kb, 10), ms_graph=graph_time(kb, 10),
                         ms_eager=cuda_time(kb, 10),
                         plain_ms=cuda_time(
                             lambda: fa.flash_attention_bwd_plain(q, k, v, ro, rlse, do), 3),
                         library_ms=device_time(lb, 10), library_ms_eager=cuda_time(lb, 10),
                         products_run=7, products_bound=5, bound_ms=bb_ms, bound_by=bb_by)))
        del q, k, v, do, o, ro, grads, refs, so, qs, ks, vs
    return rows


# ----------------------------------------------------------------- phase 4

def parity_small(dev):
    """A small model (D = 64 heads, C = 128) through the kernels on the card
    and the plain versions on the CPU from the same weights; and a small
    solve through K3/K4 against the plain solve. Tolerances are stated
    inline."""
    import numpy as np
    import torch
    from align3r_tpu_torch.models.config import Align3RConfig
    from align3r_tpu_torch.models.align3r import Align3R, init_align3r_, apply_align3r
    from align3r_tpu_torch.alignment import scene as sc
    cfg = Align3RConfig(img_size=(64, 96), enc_embed_dim=128, enc_depth=2,
                        enc_num_heads=2, dec_embed_dim=128, dec_depth=8,
                        dec_num_heads=2)
    model = init_align3r_(Align3R(cfg), seed=3)
    with torch.no_grad():
        for z in model.zero_convs:
            z[0].weight.normal_(0, 0.05)
        for h in (model.downstream_head1, model.downstream_head2):
            h.dpt.head[4].weight.mul_(0.1)
    rng = np.random.default_rng(4)
    imgs = torch.from_numpy(rng.uniform(-1, 1, (4, 64, 96, 3)).astype(np.float32))
    pri = torch.from_numpy(rng.uniform(0, 1, (4, 64, 96, 3)).astype(np.float32))
    v1 = {"img": imgs[:2], "pred_depth": pri[:2]}
    v2 = {"img": imgs[2:], "pred_depth": pri[2:]}
    ref = apply_align3r(model.prepare(device="cpu"), v1, v2)
    gpu = apply_align3r(model.prepare(),        # the card, by default
                        {k: t.to(dev) for k, t in v1.items()},
                        {k: t.to(dev) for k, t in v2.items()})
    out = {}
    for i, (r, g) in enumerate(zip(ref, gpu)):
        for k in r:
            err, rel, scale = max_err(g[k].cpu(), r[k])
            out[f"view{i + 1}.{k}"] = rel
            # bf16 network: 5% of the output range (the CPU and the card
            # round bf16 intermediates after different accumulation orders)
            if not rel <= 5e-2:
                raise AssertionError(f"model parity {k}: rel err {rel:.3g} > 5e-2")
    # solve: 60 mixed-precision iterations, fp32 arithmetic on both sides
    g = torch.Generator().manual_seed(5)
    E, A, n = 12, 32 * 48, 4
    pairs = [(i, j) for i in range(n) for j in range(n) if i != j]
    outp = {"view1": {"idx": np.array([p[0] for p in pairs])},
            "view2": {"idx": np.array([p[1] for p in pairs])},
            "pred1": {"pts3d": torch.randn(E, 32, 48, 3, generator=g),
                      "conf": 1 + torch.rand(E, 32, 48, generator=g)},
            "pred2": {"pts3d_in_other_view": torch.randn(E, 32, 48, 3, generator=g),
                      "conf": 1 + torch.rand(E, 32, 48, generator=g)}}
    res = []
    for d in ("cpu", dev):
        o = {"view1": outp["view1"], "view2": outp["view2"],
             "pred1": {k: v.to(d) for k, v in outp["pred1"].items()},
             "pred2": {k: v.to(d) for k, v in outp["pred2"].items()}}
        cfg_s, data, params = sc.build_scene(o)
        p, losses = sc.global_alignment_loop(params, sc.default_masks(cfg_s, params),
                                             data, cfg_s, niter=60)
        res.append(losses.cpu())
    err, rel, _ = max_err(res[1], res[0])
    out["solve.losses"] = rel
    if not rel <= 1e-3:
        raise AssertionError(f"solve parity: loss curve rel err {rel:.3g} > 1e-3")
    out.update(parity_flow_term(dev))
    return out


def parity_flow_term(dev):
    """flow_forward with the flow term (threshold gate off, past its start),
    dynamic masks and the depth regulariser, on the card and on the CPU from
    the same seeded scene (4 frames at 32x48, points in front of the
    cameras), flows and masks: the loss and every gradient to 1e-4 of their
    largest value (fp32 on both sides, TF32 off, sums in another order).
    Random RAFT weights may keep the gate shut through the whole flow-phase
    solve; this holds the term's code on the card regardless."""
    import dataclasses
    import numpy as np
    import torch
    from align3r_tpu_torch.alignment import scene as sc
    from align3r_tpu_torch.alignment.flow import flow_forward
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    r = np.random.default_rng(6)
    n, h, w = 4, 32, 48
    pairs = [(i, j) for i in range(n) for j in range(n) if i != j]
    E = len(pairs)
    scene = {"view1": {"idx": np.array([p[0] for p in pairs])},
             "view2": {"idx": np.array([p[1] for p in pairs])},
             "pred1": {"pts3d": r.normal(0, 1, (E, h, w, 3)) + [0, 0, 4],
                       "conf": 1 + r.uniform(size=(E, h, w))},
             "pred2": {"pts3d_in_other_view": r.normal(0, 1, (E, h, w, 3)) + [0, 0, 4],
                       "conf": 1 + r.uniform(size=(E, h, w))}}
    extra = {"flow_ij": r.normal(0, 2, (E, h, w, 2)), "flow_ji": r.normal(0, 2, (E, h, w, 2)),
             "dynamic_masks": r.uniform(size=(n, h, w)) > 0.7,
             "init_depth": r.uniform(1, 2, (n, h * w))}
    kw = dict(flow_loss_weight=0.01, flow_loss_thre=0.0, flow_loss_start_epoch=0.0,
              depth_regularize_weight=0.01, shared_focal=True)
    out, got = {}, []
    for d in ("cpu", dev):
        o = {k: {kk: (torch.as_tensor(v, dtype=torch.float32, device=d) if kk != "idx" else v)
                 for kk, v in val.items()} for k, val in scene.items()}
        cfg, data, params = sc.build_scene(o, kw)
        data = dataclasses.replace(data, **{k: torch.as_tensor(v, dtype=torch.float32, device=d)
                                            for k, v in extra.items()})
        leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
        loss = flow_forward(leaves, data, cfg, step=10)
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        got.append([("loss", loss.detach().cpu())]
                   + [(k, g.cpu()) for k, g in zip(leaves, grads) if g is not None])
    for (name, a), (_, b) in zip(got[1], got[0]):
        rel = max_err(a, b)[1]
        out[f"flow_term.{name}"] = rel
        if not rel <= 1e-4:
            raise AssertionError(f"flow term parity: {name} rel err {rel:.3g} > 1e-4")
    return out


# ----------------------------------------------------------------- phase 5

def synthetic_video(seed: int = 0):
    """24 smooth frames in [-1, 1] and prior pointclouds from a synthetic
    depth through the port's pixel_to_pointcloud."""
    import numpy as np
    import torch
    from align3r_tpu_torch.geometry.core import pixel_to_pointcloud
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    imgs, priors = [], []
    for k in range(N_FRAMES):
        ph = rng.uniform(0, 2 * np.pi, 3)
        img = np.stack([np.sin(xx / (40 + 7 * c) + 0.15 * k + ph[c])
                        * np.cos(yy / (30 + 5 * c) - 0.1 * k) for c in range(3)], -1)
        img = img + 0.05 * rng.standard_normal(img.shape)
        imgs.append(np.clip(img, -1, 1))
        depth = 2.0 + 0.5 * np.sin(xx / 60 + 0.1 * k) + 0.3 * np.cos(yy / 45)
        priors.append(pixel_to_pointcloud(torch.from_numpy(depth.astype(np.float32)),
                                          500.0).numpy())
    return np.stack(imgs).astype(np.float32), np.stack(priors).astype(np.float32)


def main_path(dev):
    import numpy as np
    import torch
    from align3r_tpu_torch.models.config import VIT_L_512
    import dataclasses
    from align3r_tpu_torch.models.align3r import Align3R, init_align3r_
    from align3r_tpu_torch.models.dpt_head import prepare_dpt_head
    from align3r_tpu_torch.ops import edge_loss as el
    from align3r_tpu_torch.ops import fused_site as fs
    from align3r_tpu_torch.pipeline import reconstruct_scene

    t0 = time.perf_counter()
    with torch.device(dev):
        model = Align3R(VIT_L_512)
    init_align3r_(model, seed=0)
    with torch.no_grad():
        gz = torch.Generator(device=dev).manual_seed(1)
        for z in model.zero_convs:   # random init zeroes them: make the prior branch count
            z[0].weight.copy_(torch.randn(z[0].weight.shape, generator=gz, device=dev) * 0.02)
        for h in (model.downstream_head1, model.downstream_head2):
            h.dpt.head[4].weight.mul_(0.01)   # keep random heads inside expm1's range
    pm = model.prepare(torch.bfloat16, torch.bfloat16)
    # the same network with fp32 heads (the demo's), for the heads phase
    pm32 = dataclasses.replace(pm, head_dtype=torch.float32, **{
        k: prepare_dpt_head(h, torch.float32) for k, h in (
            ("head1", model.downstream_head1), ("head2", model.downstream_head2))})
    del model
    torch.cuda.empty_cache()
    imgs, priors = synthetic_video()
    print(f"main: model + inputs ready in {time.perf_counter() - t0:.1f} s", flush=True)

    scene_kw = dict(shared_focal=True, temporal_smoothing_weight=0.01,
                    translation_weight=1.0, flow_loss_weight=0.0,
                    flow_loss_start_epoch=0.1, flow_loss_thre=25,
                    min_conf_thr=1.1)
    kw = dict(scene_graph="swinstride-5-noncyclic", batch_size=BATCH,
              variant="flow", niter=300, schedule="linear", lr=0.01,
              scene_kw=scene_kw)
    counters = (fs.attention_site, fs.mlp_site, el.edge_loss_fwd, el.edge_loss_bwd,
                el.permute_packed, fs.gemm, fs._ln_cuda)
    for c in counters:
        c.launches = 0
    res = reconstruct_scene(imgs, priors, pm, **kw)
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    print(f"main: cold run {json.dumps(res.timings)} launches {json.dumps(launches)}",
          flush=True)
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    # 300 solve iterations: 240 on the bf16 pack, 60 on the fp32 repack
    if launches["edge_loss_fwd"] != 300 or launches["edge_loss_bwd"] != 300:
        raise AssertionError(f"K3/K4 did not launch once per solve iteration: {launches}")
    if launches["gemm"] != 4 * launches["attention_site"] + 2 * launches["mlp_site"]:
        raise AssertionError("the GEMM core did not run every projection of K1 and K2: "
                             f"{launches}")
    # one LayerNorm a site, and a second at each decoder cross site (its
    # memory's norm_y): an encoder-style block is one K1 and one K2 site, a
    # decoder layer two K1 and one K2, so K1 - K2 cross sites, 2 K1 in all
    if launches["_ln_cuda"] != 2 * launches["attention_site"]:
        raise AssertionError(f"the LayerNorm launch did not run once per normalised "
                             f"input of K1 and K2: {launches}")
    n_pairs = res.cfg.n_edges
    checks = {
        "pairs": n_pairs == 190,
        "losses": res.losses.shape == (300,) and bool(np.isfinite(res.losses).all()),
        "poses": res.get_im_poses().shape == (N_FRAMES, 4, 4),
        "focals": res.get_focals().shape == (N_FRAMES,),
        "depths": res.get_depthmaps().shape == (N_FRAMES, H, W),
        "pred_pts3d": tuple(res.data.pred_i.shape) == (190, H * W, 3),
    }
    finite = all(np.isfinite(a).all() for a in (res.get_im_poses(), res.get_focals(),
                                                 res.get_depthmaps()))
    checks["finite"] = bool(finite and torch.isfinite(res.data.pred_i).all().item()
                            and torch.isfinite(res.data.im_conf).all().item())
    if not all(checks.values()):
        raise AssertionError(f"main path output checks failed: {checks}")
    print(f"main: checks {json.dumps(checks)} loss[0]={res.losses[0]:.6g} "
          f"loss[-1]={res.losses[-1]:.6g}", flush=True)
    del res
    warm = reconstruct_scene(imgs, priors, pm, **kw).timings
    rates = {"pairs_per_s": n_pairs / warm["inference_s"],
             "alignment_it_per_s": 300 / warm["solve_s"],
             "warm_timings_s": warm,
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
    print(f"main: warm run {json.dumps(rates)}", flush=True)
    return launches, rates, pm, pm32, imgs, priors


MAIN_SCENE_KW = dict(shared_focal=True, temporal_smoothing_weight=0.01,
                     translation_weight=1.0, flow_loss_weight=0.0,
                     flow_loss_start_epoch=0.1, flow_loss_thre=25, min_conf_thr=1.1)


def batch_path(dev, pm, card):
    """The batched multi-scene solve (see the module docstring)."""
    import numpy as np
    import torch
    from align3r_tpu_torch.alignment.batched import batched_alignment
    from align3r_tpu_torch.alignment.flow import flow_forward
    from align3r_tpu_torch.alignment.init_poses import mst_init
    from align3r_tpu_torch.alignment.scene import (build_scene, default_masks,
                                                   global_alignment_loop)
    from align3r_tpu_torch.inference.engine import inference
    from align3r_tpu_torch.inference.pairs import make_pairs
    from align3r_tpu_torch.ops import edge_loss as el

    phase_t0 = time.perf_counter()
    pairs = make_pairs(N_FRAMES, "swinstride-5-noncyclic", symmetrize=True)
    kw = dict(MAIN_SCENE_KW, num_total_iter=300)
    solve = dict(lr=0.01, niter=300, schedule="linear", loss_fn=flow_forward)
    scenes = []
    t0 = time.perf_counter()
    for seed in range(BATCH_SCENES):
        imgs, priors = synthetic_video(seed)
        out = inference(pairs, pm, imgs, priors, batch_size=BATCH)
        cfg, data, params = build_scene(out, cfg_kw=kw)
        params = mst_init(params, data, cfg, out["pred1"]["conf"], out["pred2"]["conf"])
        scenes.append((cfg, data, params, default_masks(cfg, params)))
        del out
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    counters = (el.edge_loss_fwd, el.edge_loss_bwd, el.permute_packed)
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    solved, losses = batched_alignment([s[2] for s in scenes], [s[3] for s in scenes],
                                       [s[1] for s in scenes], scenes[0][0], **solve)
    torch.cuda.synchronize()
    batched_s = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    seq_s, errs, finite = [], [], bool(np.isfinite(losses).all())
    for z, (cfg, data, params, masks) in enumerate(scenes):
        t0 = time.perf_counter()
        p, l_seq = global_alignment_loop(params, masks, data, cfg, **solve)
        torch.cuda.synchronize()
        seq_s.append(time.perf_counter() - t0)
        l_seq = l_seq.cpu().numpy()
        errs.append(float(np.max(np.abs(losses[z] - l_seq) / (1e-5 + 2e-4 * np.abs(l_seq)))))
        finite = finite and all(bool(torch.isfinite(v).all()) for v in solved[z].values())
    checks = {"losses_shape": losses.shape == (BATCH_SCENES, 300), "finite": finite,
              "k3_k4_300_for_all_scenes": launches["edge_loss_fwd"] == 300
              and launches["edge_loss_bwd"] == 300,
              "k5_two_packs": launches["permute_packed"] == 2,
              "match_sequential": max(errs) <= 1.0}
    stats = {"batched_solve_s": batched_s, "sequential_solve_s": seq_s,
             "sequential_solve_s_sum": sum(seq_s),
             "batched_it_per_s": 300 / batched_s, "engine_and_init_s": prep_s,
             "max_err_over_tol": max(errs), "launches": launches,
             "loss_first": losses[:, 0].tolist(), "loss_last": losses[:, -1].tolist(),
             "phase_s": time.perf_counter() - phase_t0, "card": card}
    print(f"batch: {BATCH_SCENES} scenes solved together in {batched_s:.3f} s, "
          f"one by one in {sum(seq_s):.3f} s ({', '.join(f'{x:.3f}' for x in seq_s)}); "
          f"{card}", flush=True)
    print(f"batch: checks {json.dumps(checks)}", flush=True)
    print(f"batch: stats {json.dumps(stats)}", flush=True)
    if not all(checks.values()):
        raise AssertionError(f"batch path checks failed: {checks}")
    return launches, stats


def seeded_vit_l(dev, cfg=None):
    """The main phase's network: VIT_L_512 (or `cfg`) from seed 0, zero convs
    filled from seed 1, the final head convs scaled by 0.01; prepared bf16."""
    import torch
    from align3r_tpu_torch.models.align3r import Align3R, init_align3r_
    from align3r_tpu_torch.models.config import VIT_L_512
    with torch.device(dev):
        model = Align3R(cfg or VIT_L_512)
    init_align3r_(model, seed=0)
    with torch.no_grad():
        gz = torch.Generator(device=dev).manual_seed(1)
        for z in model.zero_convs:
            z[0].weight.copy_(torch.randn(z[0].weight.shape, generator=gz, device=dev) * 0.02)
        for h in (model.downstream_head1, model.downstream_head2):
            h.dpt.head[4].weight.mul_(0.01)
    return model.prepare(torch.bfloat16, torch.bfloat16, device=dev)


def dp_engine_rank() -> int:
    """One rank of the ddp phase's data-parallel engine (chip_smoke.py
    --dp-engine-rank, ALIGN3R_* variables set): inference(group=WORLD) on the
    main phase's frames (batch 32, encode chunk 16), pipeline heads and the
    default heads; rank 0 then runs one rank alone and prints DP_ENGINE
    {json} with the differences. The one-rank reference runs the ranks' own
    batches (16 pairs, chunks of 8: the same kernels on the same inputs;
    cuDNN picks the heads' bf16 conv algorithms by batch size); its
    difference from one rank at batch 32 is printed beside it."""
    sys.path.insert(0, HERE)
    import numpy as np
    import torch
    import torch.distributed as dist
    from align3r_tpu_torch.inference.engine import inference
    from align3r_tpu_torch.inference.pairs import make_pairs
    from align3r_tpu_torch.ops import fused_site as fs
    from align3r_tpu_torch.parallel.mesh import maybe_init_distributed, rank

    assert maybe_init_distributed()
    dev = torch.device("cuda", 0)
    pm = seeded_vit_l(dev)
    imgs, priors = synthetic_video(0)
    pairs = make_pairs(N_FRAMES, "swinstride-5-noncyclic", symmetrize=True)
    out = {}
    for impl in ("pipeline", "xla"):
        fs.attention_site.launches = fs.mlp_site.launches = 0
        dist.barrier()
        t0 = time.perf_counter()
        res = inference(pairs, pm, imgs, priors, batch_size=BATCH, encode_chunk=16,
                        head_conv_impl=impl, group=dist.group.WORLD)
        torch.cuda.synchronize()
        out[impl] = {"s": time.perf_counter() - t0, "res": res,
                     "k1": fs.attention_site.launches, "k2": fs.mlp_site.launches}
    dist.barrier()
    if rank() == 0:
        def diff(got, ref):
            """max |got - ref|, and whether |got - ref| <= DP_TOL (1 + |ref|)."""
            d, ok = {}, True
            for k in ("pred1", "pred2"):
                for v, r in ref[k].items():
                    g = got[k][v]
                    d[f"{k}.{v}"] = (g - r).abs().max().item()
                    ok = ok and ((g - r).abs() <= DP_TOL * (1 + r.abs())).all().item() \
                        and bool(torch.isfinite(g).all())
            return d, ok
        stats = {}
        for impl, o in out.items():
            t0 = time.perf_counter()
            one = inference(pairs, pm, imgs, priors, batch_size=BATCH // 2, encode_chunk=8,
                            head_conv_impl=impl)
            torch.cuda.synchronize()
            one_s = time.perf_counter() - t0
            d, ok = diff(o["res"], one)
            d32, _ = diff(o["res"], inference(pairs, pm, imgs, priors, batch_size=BATCH,
                                              encode_chunk=16, head_conv_impl=impl))
            stats[impl] = {"max_abs_diff": d, "within_tol": ok,
                           "max_abs_diff_one_rank_batch_32": d32, "dp_s": o["s"],
                           "one_rank_s": one_s, "k1_launches_rank0": o["k1"],
                           "k2_launches_rank0": o["k2"]}
        print("DP_ENGINE " + json.dumps(stats), flush=True)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _launch_ranks(argv, log_dir, tag, timeout=600):
    """DDP_RANKS processes of argv on the one card (tcp:// on localhost;
    more ranks than cards, so maybe_init_distributed picks gloo); their
    outputs are kept under log_dir. Fails on a non-zero exit."""
    import socket
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    env = dict(os.environ, ALIGN3R_COORDINATOR=f"localhost:{port}",
               ALIGN3R_NUM_PROCESSES=str(DDP_RANKS), PYTHONPATH=HERE)
    logs = [os.path.join(log_dir, f"{tag}.rank{r}.log") for r in range(DDP_RANKS)]
    procs = []
    for r in range(DDP_RANKS):
        with open(logs[r], "w") as f:
            procs.append(subprocess.Popen(argv, cwd=HERE, stdout=f, stderr=subprocess.STDOUT,
                                          env=dict(env, ALIGN3R_PROCESS_ID=str(r))))
    try:
        rcs = [p.wait(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = [open(f).read() for f in logs]
    if any(rcs):
        raise AssertionError(f"{tag}: ranks exited {rcs}:\n" + "\n".join(
            o[-3000:] for o in outs))
    return outs


def ddp_path(dev, card):
    """Data-parallel training and serving, and the cosine engine (see the
    module docstring)."""
    import dataclasses
    import math
    import shutil
    import numpy as np
    import torch
    from align3r_tpu_torch.inference.engine import inference
    from align3r_tpu_torch.inference.pairs import make_pairs
    from align3r_tpu_torch.models.align3r import Align3R, init_align3r_
    from align3r_tpu_torch.models.config import VIT_L_512, Align3RConfig
    from align3r_tpu_torch.ops import fused_site as fs
    from align3r_tpu_torch.tools import train as cli
    from align3r_tpu_torch.training import step as ts
    from align3r_tpu_torch.training.train import export_torch_checkpoint

    phase_t0 = time.perf_counter()
    root = os.path.join(HERE, "build", "ddp")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    stats, checks = {"card": card}, {}
    # the start checkpoint, as run_train makes it
    with torch.device(dev):
        start = init_align3r_(Align3R(Align3RConfig(img_size=(H, W))), seed=0)
    with torch.no_grad():
        for h in (start.downstream_head1, start.downstream_head2):
            h.dpt.head[4].weight.mul_(0.01)
    pretrained = os.path.join(root, "start.pth")
    export_torch_checkpoint(pretrained, start)
    del start
    torch.cuda.empty_cache()
    train_expr, _ = data_exprs(os.path.join(HERE, "build", "data", "sceneflow"),
                               os.path.join(HERE, "build", "data", "sintel",
                                            "MPI-Sintel-training_images", "training", "final"))

    def argv(out, epochs, *extra):
        return ["--model", f"Align3RConfig(img_size={(H, W)})", "--pretrained", pretrained,
                "--train_dataset", train_expr, "--batch_size", str(DDP_RANKS),
                "--accum_iter", str(DDP_ACCUM), "--epochs", str(epochs),
                "--warmup_epochs", "0", "--num_workers", "2", "--output_dir", out,
                "--max_steps_per_epoch", str(DDP_STEPS), "--print_freq", "1",
                "--keep_freq", str(10 ** 6), *extra]

    def log(out):
        with open(os.path.join(out, "log.txt")) as f:
            return [json.loads(line) for line in f]

    dp_out = os.path.join(root, "ranks")
    cmd = [sys.executable, "-m", "align3r_tpu_torch.tools.train"]
    t0 = time.perf_counter()
    outs_first = _launch_ranks(cmd + argv(dp_out, 1, "--n_data", str(DDP_RANKS), "--zero1",
                                          "--ckpt_backend", "orbax"), root, "train")
    stats["ddp_epoch_s"] = time.perf_counter() - t0
    print("ddp: rank 0's run\n" + "\n".join(outs_first[0].splitlines()[-12:]), flush=True)
    last = os.path.join(dp_out, "checkpoint-last")
    checks["async_checkpoint_committed"] = (os.path.exists(os.path.join(last, "meta.json"))
                                            and os.path.isdir(os.path.join(last, "dcp")))
    t0 = time.perf_counter()
    outs = _launch_ranks(cmd + argv(dp_out, 2, "--n_data", str(DDP_RANKS), "--zero1",
                                    "--ckpt_backend", "orbax"), root, "resume")
    stats["ddp_resumed_epoch_s"] = time.perf_counter() - t0
    dp_log = log(dp_out)
    checks["resumed"] = ("resumed from" in outs[0] and [r["epoch"] for r in dp_log] == [0, 1]
                         and all(math.isfinite(r["train_loss"]) for r in dp_log))
    # one process on the same global batches, resumed the same way (pickle)
    one_out = os.path.join(root, "one")
    for epochs, key in ((1, "one_process_epoch_s"), (2, "one_process_resumed_epoch_s")):
        t0 = time.perf_counter()
        cli.main(argv(one_out, epochs, "--device", str(dev)))
        torch.cuda.synchronize()
        stats[key] = time.perf_counter() - t0
    one_log = log(one_out)
    checks["one_process_resumed"] = [r["epoch"] for r in one_log] == [0, 1]
    # epoch 0 sees the start weights; epoch 1 the weights after an update at
    # learning rate > 0 (bf16 compute: parameters one ulp apart round some
    # activations the other way, so 1e-2, as the CPU test holds it)
    for e, tol in ((0, 1e-4), (1, 1e-2)):
        a, b = dp_log[e]["train_loss"], one_log[e]["train_loss"]
        stats[f"loss_two_ranks_epoch{e}"], stats[f"loss_one_process_epoch{e}"] = a, b
        stats[f"loss_rel_diff_epoch{e}"] = abs(a - b) / abs(b)
        checks[f"loss_matches_one_process_epoch{e}"] = abs(a - b) <= tol * abs(b)
    # the trainable parameters' change over both epochs against one process's
    # (Adam normalises each element's step, so a missing sum over the ranks or
    # a wrong ZeRO-1 reassembly turns the direction, not only the length)
    p0 = torch.load(pretrained, map_location="cpu")["model"]
    fin = [torch.load(os.path.join(o, "checkpoint-final.pth"), map_location="cpu")["model"]
           for o in (dp_out, one_out)]
    names = [n for n in p0 if ts.is_trainable(n)]
    u_dp, u_one = (torch.cat([(f[n].double() - p0[n].double()).ravel() for n in names])
                   for f in fin)
    stats["update_cosine"] = float(torch.nn.functional.cosine_similarity(u_dp, u_one, dim=0))
    stats["update_rel_diff"] = float((u_dp - u_one).norm() / u_one.norm())
    checks["update_matches_one_process"] = (stats["update_cosine"] >= 0.9
                                            and float(u_one.norm()) > 0)
    print(f"ddp: two ranks (gloo, zero1, async checkpoints) epoch losses "
          f"{stats['loss_two_ranks_epoch0']:.7g}, {stats['loss_two_ranks_epoch1']:.7g}; one "
          f"process {stats['loss_one_process_epoch0']:.7g}, "
          f"{stats['loss_one_process_epoch1']:.7g} (rel {stats['loss_rel_diff_epoch0']:.2e}, "
          f"{stats['loss_rel_diff_epoch1']:.2e}); parameter change cosine "
          f"{stats['update_cosine']:.6f}, rel diff {stats['update_rel_diff']:.3e}; "
          f"{stats['ddp_epoch_s']:.1f} s and {stats['one_process_epoch_s']:.1f} s for "
          f"{DDP_STEPS} micro-steps with start-up; {card}", flush=True)

    # the data-parallel engine over the two ranks
    outs = _launch_ranks([sys.executable, os.path.join(HERE, "chip_smoke.py"),
                          "--dp-engine-rank"], root, "engine")
    line = next(ln for ln in outs[0].splitlines() if ln.startswith("DP_ENGINE "))
    stats["dp_engine"] = json.loads(line[len("DP_ENGINE "):])
    checks["dp_engine_within_tol"] = all(v["within_tol"] for v in stats["dp_engine"].values())
    print(f"ddp: data-parallel engine against one rank {json.dumps(stats['dp_engine'])}",
          flush=True)

    # pos_embed="cosine" at VIT_L_512 widths beside the RoPE engine
    imgs, priors = synthetic_video(0)
    pairs = make_pairs(N_FRAMES, "swinstride-5-noncyclic", symmetrize=True)
    counts, res = {}, {}
    for tag, cfg in (("rope", VIT_L_512), ("cosine", dataclasses.replace(
            VIT_L_512, pos_embed="cosine"))):
        pm = seeded_vit_l(dev, cfg)
        counters = (fs.attention_site, fs.mlp_site, fs.gemm, fs._ln_cuda)
        for c in counters:
            c.launches = 0
        out = inference(pairs, pm, imgs, priors, batch_size=BATCH)
        torch.cuda.synchronize()
        counts[tag] = {c.__name__: c.launches for c in counters}
        res[tag] = out["pred1"]["pts3d"]
        checks[f"{tag}_finite"] = all(bool(torch.isfinite(v).all()) for k in ("pred1", "pred2")
                                      for v in out[k].values())
        del pm, out
        torch.cuda.empty_cache()
    checks["cosine_launches_as_rope"] = counts["cosine"] == counts["rope"] and all(
        counts["cosine"].values())
    stats["cosine_vs_rope_median_rel"] = float(
        ((res["cosine"] - res["rope"]).abs() / (res["rope"].abs() + 1e-3)).median())
    checks["cosine_differs"] = stats["cosine_vs_rope_median_rel"] > 0
    stats["engine_launches"] = counts
    stats["phase_s"] = time.perf_counter() - phase_t0
    print(f"ddp: checks {json.dumps(checks)}", flush=True)
    print(f"ddp: stats {json.dumps(stats)}", flush=True)
    if not all(checks.values()):
        raise AssertionError(f"ddp path checks failed: {checks}")
    return counts["cosine"], stats


# ----------------------------------------------------------------- phase 6

def flow_path(dev, pm, imgs, priors, sam2):
    """The demo's flow path (see the module docstring) on FLOW_FRAMES frames,
    with the motion masks refined by `sam2` (model, cfg): the reference's
    pose_test --sam2_mask_refine route."""
    import numpy as np
    import torch
    from align3r_tpu_torch import pipeline as tp
    from align3r_tpu_torch.alignment.flow import flow_term
    from align3r_tpu_torch.models import sam2_video as tsv
    from align3r_tpu_torch.models.raft import RAFT2, SPRING_M, init_raft_
    from align3r_tpu_torch.ops import edge_loss as el
    from align3r_tpu_torch.ops import flash_attention as fa
    from align3r_tpu_torch.ops import fused_site as fs
    from align3r_tpu_torch.ops import small_attention as sa
    from align3r_tpu_torch.pipeline import compute_raft_flows, reconstruct_scene

    n = FLOW_FRAMES
    imgs, priors = imgs[:n], priors[:n]
    raft = init_raft_(RAFT2(SPRING_M), seed=0).to(dev)
    # cuDNN picks its convolution algorithms on the first call at a shape:
    # one untimed chunk at the path's batch (12 edges, both directions)
    compute_raft_flows(raft, imgs * 0.5 + 0.5, [(0, 1)] * 12, iters=1)
    torch.cuda.synchronize()
    scene_kw = dict(shared_focal=True, temporal_smoothing_weight=0.01,
                    translation_weight=1.0, flow_loss_weight=0.01,
                    flow_loss_start_epoch=0.1, flow_loss_thre=25, min_conf_thr=1.1)
    kw = dict(scene_graph="swinstride-5-noncyclic", batch_size=BATCH, variant="flow",
              raft_params=raft, use_self_mask=True, sam2_mask_refine=True, sam2_model=sam2,
              niter=300, schedule="linear", lr=0.01, scene_kw=scene_kw)
    counters = (fs.attention_site, fs.mlp_site, el.edge_loss_fwd, el.edge_loss_bwd,
                el.permute_packed, fs.gemm, sa.small_attention, fa.flash_attention)
    # the self masks SAM2 refines, as the pipeline computes them
    self_masks = []
    own = tp.motion_masks_from_pairs
    tp.motion_masks_from_pairs = lambda *a, **k: self_masks.append(own(*a, **k)) or self_masks[-1]
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    try:
        res = reconstruct_scene(imgs, priors, pm, **kw)
    finally:
        tp.motion_masks_from_pairs = own
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    steps, tracked = tsv.frame_steps(self_masks[0])
    trunk, mem = tsv.dispatch_counts(sam2[1])
    t = res.timings
    E = res.cfg.n_edges
    print(f"flow: {n} frames, {E} pairs, timings {json.dumps(t)} launches "
          f"{json.dumps(launches)}", flush=True)
    masks = res.dynamic_masks
    checks = {
        "k5_2_per_solve": launches["permute_packed"] == 2,
        "k3_k4_300": launches["edge_loss_fwd"] == 300 and launches["edge_loss_bwd"] == 300,
        "k1_k2_launched": launches["attention_site"] > 0 and launches["mlp_site"] > 0,
        "timings": {"raft_s", "masks_s", "sam2_s", "solve_s"} <= set(t),
        "sam2_launches": (launches["small_attention"] == steps * trunk["small"]
                          and launches["flash_attention"] == tracked * mem["flash"]),
        "flows": tuple(res.data.flow_ij.shape) == (E, H, W, 2)
        and bool(torch.isfinite(res.data.flow_ij).all() and torch.isfinite(res.data.flow_ji).all()),
        "masks": masks is not None and masks.shape == (n, H, W) and masks.dtype == bool,
        "losses": res.losses.shape == (300,) and bool(np.isfinite(res.losses).all()),
        "finite": all(np.isfinite(a).all() for a in (res.get_im_poses(), res.get_focals(),
                                                      res.get_depthmaps())),
    }
    print(f"flow: checks {json.dumps(checks)}", flush=True)
    if not all(checks.values()):
        raise AssertionError(f"flow path checks failed: {checks}")
    # the flow term's cost, forward and backward at the final parameters,
    # and whether its gate was open there
    params = {k: v.detach().clone().requires_grad_(True) for k, v in res.params.items()}

    def term():
        torch.autograd.grad(flow_term(params, res.data, res.cfg), list(params.values()),
                            allow_unused=True)

    with torch.no_grad():
        fl = flow_term(res.params, res.data, res.cfg).item()
    term_ms = cuda_time(term, 5, warmup=1)
    active = 300 - int(np.ceil(res.cfg.flow_loss_start_epoch * 300))
    stats = {"frames": n, "pairs": E, "raft_s": t["raft_s"],
             "raft_ms_per_directed_pair": t["raft_s"] * 1e3 / (2 * E),
             "masks_s": t["masks_s"], "masks_s_per_symmetric_pair": t["masks_s"] / (E / 2),
             "sam2_s": t["sam2_s"], "sam2_frame_steps": steps, "sam2_tracked_steps": tracked,
             "sam2_s_per_frame_step": t["sam2_s"] / max(steps, 1),
             "dynamic_share_self_masks": float(self_masks[0].mean()),
             "inference_s": t["inference_s"], "init_s": t["init_s"], "solve_s": t["solve_s"],
             "alignment_it_per_s": 300 / t["solve_s"],
             "dynamic_share": float(masks.mean()),
             "flow_term_final": fl, "flow_gate_open_at_end": fl <= res.cfg.flow_loss_thre,
             "flow_term_fwd_bwd_ms": term_ms,
             "flow_term_share_of_solve_est": active * term_ms / (t["solve_s"] * 1e3),
             "loss_first": float(res.losses[0]), "loss_last": float(res.losses[-1]),
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
    print(f"flow: stats {json.dumps(stats)}", flush=True)
    return launches, stats


# ----------------------------------------------------------------- phase 7

def check_k6(dev, gen):
    """K6 against its plain version at the training path's shapes (VIT_L_512
    at 288x512, 2 pairs: the encoder's 4 images x 16 heads, the decoder's
    2 streams x 2 pairs x 12 heads, and the prior branch's 4 images x 12
    heads), bf16, and at the encoder's shape in fp32; beside each, torch's
    scaled_dot_product_attention on the same inputs (the library call the
    port never makes). Tolerance: 2 bf16 ulps of max|plain| (1.6e-2 x max)
    in bf16 as for K1; 1e-4 x max in fp32 (3xTF32 products, about 2^-21
    relative, and an online softmax against the plain version's exact max,
    sums over 576 keys in another order). Kernel and library call are timed
    from a CUDA graph (device time; `_eager`: launched one by one). The fp32
    bound counts each product as 3 TF32 products at PEAK_TF32."""
    import torch
    import torch.nn.functional as F
    from align3r_tpu_torch.ops import small_attention as sa
    N = (H // 16) * (W // 16)
    rows = []
    for name, shape, dt in (("encoder", (4, 16, N, 64), torch.bfloat16),
                            ("decoder self/cross", (4, 12, N, 64), torch.bfloat16),
                            ("prior branch", (4, 12, N, 64), torch.bfloat16),
                            ("encoder fp32", (4, 16, N, 64), torch.float32)):
        q, k, v = (torch.randn(*shape, generator=gen, device=dev).to(dt) for _ in range(3))
        kern = lambda: sa.small_attention(q, k, v)
        plain = lambda: sa.small_attention_plain(q, k, v)
        lib = lambda: F.scaled_dot_product_attention(q, k, v)
        out, ref = kern(), plain()
        torch.cuda.synchronize()
        err, rel, scale = max_err(out, ref)
        tol = (1.6e-2 if dt == torch.bfloat16 else 1e-4) * scale
        B_, H_, N_, D_ = shape
        isz = out.element_size()
        ops = 4 * B_ * H_ * N_ * N_ * D_   # fp32: as 3xTF32
        b_ms, b_by = bound(4 * B_ * H_ * N_ * D_ * isz, ops if isz == 2 else 3 * ops,
                           PEAK_BF16 if isz == 2 else PEAK_TF32)
        rows.append(ratios(dict(
            kernel="K6", shape=f"{name} {tuple(shape)} "
            f"{'bf16' if dt == torch.bfloat16 else 'fp32'}",
            max_abs_err=err, max_rel_err=rel, tol=tol,
            ok=err <= tol and torch.isfinite(out.float()).all().item(),
            ms=graph_time(kern, 20), ms_eager=cuda_time(kern, 20), plain_ms=cuda_time(plain, 5),
            library_ms=graph_time(lib, 20), library_ms_eager=cuda_time(lib, 20),
            bound_ms=b_ms, bound_by=b_by)))
        del q, k, v, out, ref
    return rows


def check_grads(dev, gen):
    """K6's gradient on the card at (4, 12, 576, 64) bf16, and the
    differentiable K1/K2 sites' (small shape), against autograd of their
    plain twins on the card. The backward of each is autograd of that twin,
    so the tolerance is 1e-5 x max|twin gradient|; the forwards are held to
    the twins at 2 bf16 ulps."""
    import torch
    from align3r_tpu_torch.models.rope import make_grid_positions
    from align3r_tpu_torch.ops import fused_site as fs
    from align3r_tpu_torch.ops import small_attention as sa
    bf = torch.bfloat16
    out = {}

    def rel_grads(got, ref):
        return max(max_err(a, b)[1] for a, b in zip(got, ref))

    N = (H // 16) * (W // 16)
    qkv = [torch.randn(4, 12, N, 64, generator=gen, device=dev).to(bf).requires_grad_(True)
           for _ in range(3)]
    g = torch.randn(4, 12, N, 64, generator=gen, device=dev).to(bf)
    got = torch.autograd.grad(sa.small_attention(*qkv), qkv, g)
    ref = torch.autograd.grad(sa.small_attention_twin(*qkv), qkv, g)
    out["K6 grad (4,12,576,64)"] = rel_grads(got, ref)

    G, B_, C, Hh, F = 2, 2, 768, 12, 3072
    pos = make_grid_positions(H // 16, W // 16, device=dev)
    Np = pos.shape[0]
    rnd = lambda *s, sc=1.0: (torch.randn(*s, generator=gen, device=dev) * sc).requires_grad_(True)
    x = (torch.randn(G, B_, Np, C, generator=gen, device=dev).to(bf)).requires_grad_(True)
    w = [rnd(G, C, C, sc=C ** -0.5) for _ in range(4)]
    b = [rnd(G, C, sc=0.1) for _ in range(4)]
    ln = ((1 + 0.1 * torch.randn(G, C, generator=gen, device=dev)).requires_grad_(True),
          rnd(G, C, sc=0.1))
    gy = torch.randn(G, B_, Np, C, generator=gen, device=dev).to(bf)
    leaves = [x, *w, *b, *ln]
    y = fs.attention_site_diff(x, x, *w, *b, pos, Hh, 100.0, ln_q=ln, ln_kv="same",
                               residual=True)
    cos, sin = fs.site_tables(pos, C // Hh, 100.0, bf)
    yt = fs.site_plain(x, x, *[t.to(bf) for t in w], *b, cos, sin, Hh, ln_q=ln,
                       ln_kv="same", residual=True, twin=True)
    out["K1 site_diff fwd vs twin"] = max_err(y, yt)[1]
    out["K1 site_diff grad"] = rel_grads(torch.autograd.grad(y, leaves, gy),
                                         torch.autograd.grad(yt, leaves, gy))
    w1, w2 = rnd(G, C, F, sc=C ** -0.5), rnd(G, F, C, sc=F ** -0.5)
    b1, b2 = rnd(G, F, sc=0.1), rnd(G, C, sc=0.1)
    leaves = [x, w1, b1, w2, b2, *ln]
    y = fs.mlp_site_diff(x, w1, b1, w2, b2, ln=ln, residual=True)
    yt = fs.mlp_plain(x, w1.to(bf), b1, w2.to(bf), b2, ln=ln, residual=True)
    out["K2 mlp_diff fwd vs twin"] = max_err(y, yt)[1]
    out["K2 mlp_diff grad"] = rel_grads(torch.autograd.grad(y, leaves, gy),
                                        torch.autograd.grad(yt, leaves, gy))
    bad = {k: v for k, v in out.items()
           if v > (1.6e-2 if "fwd" in k else 1e-5)}
    if bad:
        raise AssertionError(f"gradient checks out of tolerance: {bad}")
    return out


class SyntheticPairs:
    """An in-memory two-view training set at hw (288x512 by default): per
    pair a smooth synthetic depth for each view, cam2world poses a small
    motion apart, world points from the depth through a 500 px pinhole,
    images in [-1, 1], and the prior pointcloud from a perturbed depth
    (pixel_to_pointcloud). The dataset object the port's get_data_loader
    takes."""

    def __init__(self, n, seed=0, hw=(H, W)):
        import numpy as np
        import torch
        from align3r_tpu_torch.geometry.core import pixel_to_pointcloud
        H, W = hw
        self.resolutions = [(W, H)]
        rng = np.random.default_rng(seed)
        yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
        self.items = []
        for i in range(n):
            base = np.eye(4, dtype=np.float32)
            base[:3, 3] = rng.uniform(-1, 1, 3)
            views = []
            for j in range(2):
                ph = rng.uniform(0, 2 * np.pi, 3)
                depth = (2.0 + 0.5 * np.sin(xx / 60 + ph[0]) + 0.3 * np.cos(yy / 45 + ph[1])
                         ).astype(np.float32)
                cam = np.stack([(xx - W / 2) * depth / 500.0,
                                (yy - H / 2) * depth / 500.0, depth], -1)
                pose = base.copy()
                a = 0.05 * j
                pose[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                                [-np.sin(a), 0, np.cos(a)]]
                pose[:3, 3] += [0.1 * j, 0, 0]
                pts = cam @ pose[:3, :3].T + pose[:3, 3]
                img = np.stack([np.sin(xx / (40 + 7 * c) + ph[c]) * np.cos(yy / 30 - ph[2])
                                for c in range(3)], -1)
                noisy = depth * (1 + 0.05 * rng.standard_normal(depth.shape))
                prior = pixel_to_pointcloud(torch.from_numpy(noisy.astype(np.float32)),
                                            500.0).numpy()
                views.append({"img": img.astype(np.float32), "pred_depth": prior,
                              "pts3d": pts.astype(np.float32), "camera_pose": pose,
                              "valid_mask": rng.uniform(0, 1, (H, W)) > 0.05})
            self.items.append(views)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx):
        return self.items[idx[0] if isinstance(idx, tuple) else idx]


def run_train(dev, tag, hw, n_pairs, accum, epochs, counters, exprs=None, workers=2):
    """train() at ViT-L width (Align3RConfig at `hw`) with the reference
    per-GPU recipe (batch 2, remat full, frozen encoder in bf16, fp32 heads)
    over SyntheticPairs(n_pairs), from a seeded random start checkpoint; or,
    with exprs = (train, test) dataset expressions, the same recipe through
    the command line's `tools.train.main` (n_pairs: the training
    expression's length). The counters are zeroed right before the call.
    Returns (launches, checks, stats, result): finite losses, trainable
    parameters moved, frozen ones bit-identical, log.txt's records,
    checkpoint-final.pth reloading strictly, the applied updates; warm ms
    per micro-step, the loader's wait and peak memory."""
    import math
    import torch
    from align3r_tpu_torch.models.align3r import Align3R, init_align3r_
    from align3r_tpu_torch.models.config import Align3RConfig
    from align3r_tpu_torch.tools import train as cli
    from align3r_tpu_torch.training.step import is_trainable
    from align3r_tpu_torch.training.train import (TrainArgs, export_torch_checkpoint,
                                                  train)

    t0 = time.perf_counter()
    cfg = Align3RConfig(img_size=hw)
    ds = SyntheticPairs(n_pairs, hw=hw) if exprs is None else None
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as out:
        # the recipe starts from a checkpoint: one from seeded random weights,
        # final head convs scaled so random heads stay inside expm1's range
        with torch.device(dev):
            start = init_align3r_(Align3R(cfg), seed=0)
        with torch.no_grad():
            for h in (start.downstream_head1, start.downstream_head2):
                h.dpt.head[4].weight.mul_(0.01)
        pretrained = os.path.join(out, "start.pth")
        export_torch_checkpoint(pretrained, start)
        del start
        torch.cuda.empty_cache()
        print(f"{tag}: data + start checkpoint in {time.perf_counter() - t0:.1f} s",
              flush=True)

        model = f"Align3RConfig(img_size={tuple(hw)})"
        if exprs is None:
            args = TrainArgs(model=model, pretrained=pretrained,
                             train_dataset=ds, batch_size=TRAIN_BATCH, accum_iter=accum,
                             epochs=epochs, warmup_epochs=0, num_workers=workers,
                             output_dir=out, save_freq=epochs, keep_freq=10 ** 6,
                             print_freq=4, remat="full", cast_frozen=True, head_bf16=False,
                             device=str(dev))
        else:   # the command line's defaults are the recipe's: remat full, cast_frozen
            argv = ["--model", model, "--pretrained", pretrained,
                    "--train_dataset", exprs[0], "--test_dataset", exprs[1],
                    "--batch_size", str(TRAIN_BATCH), "--accum_iter", str(accum),
                    "--epochs", str(epochs), "--warmup_epochs", "0",
                    "--num_workers", str(workers), "--output_dir", out,
                    "--save_freq", str(epochs), "--keep_freq", str(10 ** 6),
                    "--print_freq", "4", "--device", str(dev)]
        torch.cuda.reset_peak_memory_stats()
        for c in counters:
            c.launches = 0
        t1 = time.perf_counter()
        res = train(args) if exprs is None else cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches = {c.__name__: c.launches for c in counters}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        steps = len(res.history)
        print(f"{tag}: {steps} micro-steps, {res.optimizer.count} applied updates in "
              f"{wall:.1f} s, launches {json.dumps(launches)}", flush=True)

        start_sd = torch.load(pretrained, map_location=dev, weights_only=True)["model"]
        frozen_bad, moved, total = [], {}, {}
        for k, v in res.model.state_dict().items():
            ref = start_sd[k].to(v.dtype)
            if is_trainable(k):
                grp = k.split(".", 1)[0]
                total[grp] = total.get(grp, 0) + 1
                moved[grp] = moved.get(grp, 0) + (not torch.equal(v, ref))
            elif not torch.equal(v, ref):
                frozen_bad.append(k)
        del start_sd
        sd = torch.load(os.path.join(out, "checkpoint-final.pth"), map_location="cpu",
                        weights_only=True)["model"]
        with torch.device("meta"):
            fresh = Align3R(cfg)
        fresh.load_state_dict(sd, strict=True, assign=True)
        reload_ok = all(fresh.state_dict()[k].dtype == torch.float32 for k in sd)
        del sd, fresh
        with open(os.path.join(out, "log.txt")) as f:
            records = [json.loads(line) for line in f]
    losses = [h["loss"] for h in res.history]
    checks = {
        "losses_finite": len(losses) == epochs * n_pairs // TRAIN_BATCH
        and all(math.isfinite(x) for x in losses),
        "trainable_moved": all(moved[g] > 0 for g in total),
        "frozen_bit_identical": not frozen_bad,
        "log_records": [r["epoch"] for r in records] == list(range(epochs))
        and all(math.isfinite(r["train_loss"]) and (exprs is None or math.isfinite(
            r["test_loss"])) for r in records),
        "final_pth_reloads_strict": reload_ok,
        "applied_updates": res.optimizer.count == steps // accum >= 2,
    }
    warm = res.log[-1]
    ms_step = warm["train_s"] / warm["steps"] * 1e3
    stats = {"micro_steps": steps, "applied_updates": res.optimizer.count,
             "loss_first": losses[0], "loss_last": losses[-1],
             "warm_ms_per_micro_step": ms_step,
             "train_pairs_per_s": TRAIN_BATCH / ms_step * 1e3,
             "loader_wait_share": warm["data_s"] / warm["train_s"],
             "peak_mem_gb": peak, "moved_tensors": moved, "trainable_tensors": total,
             "frozen_changed": frozen_bad[:5]}
    return launches, checks, stats, res


def train_path(dev):
    """train() at ViT-L width on 288x512 pairs (see the module docstring)."""
    from align3r_tpu_torch.ops import edge_loss as el
    from align3r_tpu_torch.ops import fused_site as fs
    from align3r_tpu_torch.ops import small_attention as sa

    counters = (fs.attention_site, fs.mlp_site, el.edge_loss_fwd,
                el.edge_loss_bwd, sa.small_attention)
    launches, checks, stats, _ = run_train(dev, "train", (H, W), TRAIN_PAIRS, ACCUM,
                                           TRAIN_EPOCHS, counters)
    steps = stats["micro_steps"]
    checks["k6_80_per_micro_step"] = launches["small_attention"] == 80 * steps
    stats["k6_launches_per_micro_step"] = launches["small_attention"] / steps
    print(f"train: checks {json.dumps(checks)}", flush=True)
    print(f"train: stats {json.dumps(stats)}", flush=True)
    if not all(checks.values()):
        raise AssertionError(f"train path checks failed: {checks}")
    return launches, stats


# ------------------------------------------------------------- data phase

def _smooth_rgb(h, w, phase=0.0, noise=None):
    """A smooth colour field (uint8 (h, w, 3)), plus seeded noise if given."""
    import numpy as np
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([128 + 100 * np.sin(xx / (40 + 7 * c) + yy / 30 + phase + c)
                    for c in range(3)], -1)
    if noise is not None:
        img = img + noise.normal(0, 6, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def write_data_inputs(root):
    """The training layouts at the datasets' native sizes, written by the
    port's own writers: FlyingThings3D in SceneFlow's preprocessed layout
    (FlyingThings3D_proc/{TRAIN,TEST}/A/<seq>/left: _rgb.jpg at quality 75,
    4:2:0, as the preprocess writes them, _depth.pfm, _mask.png,
    _metadata.npz, a DepthPro-style _rgb_pred_depth_depthpro.npz) and one
    Sintel scene in the raw layout (PNG frames, .dpt depth, .cam cameras,
    dynamic_label_perfect masks, depth_prediction_depthpro priors). Smooth
    synthetic depths (2-3 m), cam2world poses a small motion apart (world2cam
    in Sintel's .cam), priors a 5% noisy depth. Returns (SceneFlow root,
    Sintel's final/ folder, the first SceneFlow scene)."""
    import numpy as np
    from align3r_tpu_torch.utils.jpeg import write_jpeg
    from align3r_tpu_torch.utils.pfm import write_pfm
    from align3r_tpu_torch.utils.png import write_png
    from align3r_tpu_torch.utils.sintel_io import TAG_FLOAT, depth_write

    rng = np.random.default_rng(16)

    def frame(h, w, k, f):
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        depth = (2.5 + 0.5 * np.sin(xx / 90 + 0.2 * k) + 0.3 * np.cos(yy / 70)).astype(np.float32)
        a = 0.02 * k
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
        pose[:3, 3] = [0.05 * k, 0.01 * k, 0.02 * k]
        K = np.array([[f, 0, (w - 1) / 2], [0, f, (h - 1) / 2], [0, 0, 1]], np.float32)
        prior = (depth * (1 + 0.05 * rng.standard_normal(depth.shape))).astype(np.float32)
        mask = np.full((h, w), 255, np.uint8)
        mask[: h // 10, : w // 10] = 0
        return _smooth_rgb(h, w, 0.3 * k, rng), depth, pose, K, prior, mask

    sf = os.path.join(root, "sceneflow")
    scenes = []
    for split, seq, n in DATA_SCENES:
        d = os.path.join(sf, "FlyingThings3D_proc", split, "A", seq, "left")
        os.makedirs(d, exist_ok=True)
        scenes.append(d)
        for k in range(n):
            img, depth, pose, K, prior, mask = frame(*DATA_HW, k, 1050.0)
            stem = os.path.join(d, f"{k:04d}")
            write_jpeg(img, stem + "_rgb.jpg")
            write_pfm(stem + "_depth.pfm", depth)
            write_png(mask, stem + "_mask.png")
            np.savez(stem + "_metadata.npz", camera_intrinsics=K, camera_pose=pose)
            np.savez(stem + "_rgb_pred_depth_depthpro.npz", depth=prior,
                     focallength_px=np.float32(1050.0))
    sintel = os.path.join(root, "sintel")
    final = os.path.join(sintel, "MPI-Sintel-training_images", "training", "final")
    sub = {s: os.path.join(sintel, "MPI-Sintel-depth-training", "training", s, "alley_1")
           for s in ("depth", "dynamic_label_perfect", "camdata_left")}
    sub["prior"] = os.path.join(sintel, "MPI-Sintel-training_images", "training",
                                "depth_prediction_depthpro", "alley_1")
    for d in [os.path.join(final, "alley_1"), *sub.values()]:
        os.makedirs(d, exist_ok=True)
    for k in range(1, SINTEL_FRAMES + 1):
        img, depth, pose, K, prior, mask = frame(*SINTEL_HW, k, 688.0)
        name = f"frame_{k:04d}"
        write_png(img, os.path.join(final, "alley_1", name + ".png"))
        depth_write(os.path.join(sub["depth"], name + ".dpt"), depth)
        write_png(mask, os.path.join(sub["dynamic_label_perfect"], name + ".png"))
        with open(os.path.join(sub["camdata_left"], name + ".cam"), "wb") as f:
            np.float32(TAG_FLOAT).tofile(f)
            K.astype(np.float64).tofile(f)
            np.linalg.inv(pose)[:3].astype(np.float64).tofile(f)
        np.savez(os.path.join(sub["prior"], name + ".npz"), depth=prior,
                 focallength_px=np.float32(688.0))
    return sf, final, scenes[0]


def data_exprs(sf, final):
    """The data phase's training and test expressions (the recipe's form)."""
    kw = "aug_crop=16, resolution=[(512, 288)], seed=777"
    return (f"24 @ SceneFlowDatasets(split='train', ROOT={sf!r}, {kw}) + "
            f"8 @ SintelDatasets(split='train', ROOT={final!r}, {kw})",
            f"4 @ SceneFlowDatasets(split='test', ROOT={sf!r}, "
            "resolution=[(512, 288)], seed=777)")


def data_path(dev, card, train_launches, train_stats):
    """The training data path on the card (see the module docstring)."""
    import glob
    import shutil
    import numpy as np
    import torch
    from align3r_tpu_torch.inference.images import load_images, read_rgb
    from align3r_tpu_torch.ops import fused_site as fs
    from align3r_tpu_torch.ops import small_attention as sa
    from align3r_tpu_torch.training.data import build_dataset, get_data_loader
    from align3r_tpu_torch.training.step import make_eval_step
    from align3r_tpu_torch.training.train import BATCH_KEYS
    from align3r_tpu_torch.utils import jpeg

    stats, checks = {}, {}
    path, stats["jpeg_build_s"] = jpeg.build()
    jpeg.library()
    print(f"data: JPEG codec {path.name} built in {stats['jpeg_build_s']:.2f} s", flush=True)
    root = os.path.join(HERE, "build", "data")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    sf, final, scene = write_data_inputs(root)
    stats["write_s"] = time.perf_counter() - t0

    # the decoder: ms a frame, and the encoder's source back within 2 levels
    frames = sorted(glob.glob(os.path.join(scene, "*_rgb.jpg")))
    with open(frames[0], "rb") as f:
        data = f.read()
    jpeg.decode_jpeg(data)
    t0 = time.perf_counter()
    for _ in range(DECODE_REPS):
        img = jpeg.decode_jpeg(data)
    stats["decode_ms_per_frame"] = (time.perf_counter() - t0) / DECODE_REPS * 1e3
    src = _smooth_rgb(*DATA_HW)
    stats["q95_mean_abs_diff"] = float(np.abs(
        jpeg.decode_jpeg(jpeg.encode_jpeg(src, 95)).astype(np.int32) - src).mean())
    checks["decode_shape"] = img.shape == DATA_HW + (3,)
    checks["q95_within_2"] = stats["q95_mean_abs_diff"] <= 2
    # load_images on the scene's JPEG frames (the serving loader)
    views = load_images(frames, size=512)
    checks["load_images_jpeg"] = len(views) == len(frames) and all(
        v["img"].shape == (1, H, W, 3) and np.isfinite(v["img"]).all() for v in views)
    checks["read_rgb_is_decoder"] = bool((read_rgb(frames[0]) == img).all())

    # the loader alone over the epoch the training sees (set_epoch(0), the same
    # seeds): every batch at (288, 512), finite images in [-1, 1], valid pixels
    train_expr, test_expr = exprs = data_exprs(sf, final)
    ds = build_dataset(train_expr)
    ds.set_epoch(0)
    ds[0, 0]
    t0 = time.perf_counter()
    for i in range(1, 1 + LOADER_ITEMS):
        ds[i, 0]
    stats["loader_ms_per_pair_1_thread"] = (time.perf_counter() - t0) / LOADER_ITEMS * 1e3
    dl = get_data_loader(train_expr, TRAIN_BATCH, num_workers=DATA_WORKERS)
    dl.set_epoch(0)
    t0 = time.perf_counter()
    batches = list(dl)
    stats["loader_ms_per_pair"] = (time.perf_counter() - t0) / (
        len(batches) * TRAIN_BATCH) * 1e3
    bad = [i for i, b in enumerate(batches) for v in b.values() if not (
        (v["true_shape"] == (H, W)).all() and np.isfinite(v["img"]).all()
        and v["img"].min() >= -1 and v["img"].max() <= 1
        and v["valid_mask"].reshape(TRAIN_BATCH, -1).any(1).all())]
    checks["batches_ok"] = len(batches) == DATA_PAIRS // TRAIN_BATCH and not bad
    del batches, ds
    print(f"data: decoder {stats['decode_ms_per_frame']:.2f} ms a {DATA_HW[1]}x{DATA_HW[0]} "
          f"frame; loader {stats['loader_ms_per_pair']:.1f} ms a pair with {DATA_WORKERS} "
          f"threads, {stats['loader_ms_per_pair_1_thread']:.1f} with one; "
          f"q95 mean |diff| {stats['q95_mean_abs_diff']:.3f}; {card}", flush=True)

    counters = (fs.attention_site, fs.mlp_site, sa.small_attention)
    launches, tchecks, tstats, res = run_train(dev, "data", (H, W), DATA_PAIRS, ACCUM, 1,
                                               counters, exprs=exprs, workers=DATA_WORKERS)
    checks.update(tchecks)
    # the eval step's launches on one test batch, to take the test epoch's out
    test = get_data_loader(test_expr, TRAIN_BATCH, num_workers=1, shuffle=False)
    test.set_epoch(0)
    batch = next(iter(test))
    for c in counters:
        c.launches = 0
    make_eval_step(res.model)({vn: {k: torch.as_tensor(np.asarray(v)).to(dev)
                                    for k, v in bv.items() if k in BATCH_KEYS}
                               for vn, bv in batch.items()})
    torch.cuda.synchronize()
    per_eval = {c.__name__: c.launches for c in counters}
    del res
    steps = tstats["micro_steps"]
    per_step = {k: (launches[k] - len(test) * per_eval[k]) / steps for k in launches}
    train_per_step = {k: train_launches[k] / train_stats["micro_steps"] for k in per_step}
    checks["k6_80_per_micro_step"] = per_step["small_attention"] == 80
    checks["k1_k2_as_train_phase"] = all(per_step[k] == train_per_step[k]
                                         for k in ("attention_site", "mlp_site"))
    stats.update(tstats)
    stats.update({"launches_per_micro_step": per_step, "eval_launches_per_batch": per_eval,
                  "train_phase_launches_per_micro_step": train_per_step, "card": card})
    print(f"data: {tstats['warm_ms_per_micro_step']:.1f} ms a micro-step, "
          f"{100 * tstats['loader_wait_share']:.2f}% of the epoch waiting on the loader; "
          f"{card}", flush=True)
    print(f"data: checks {json.dumps(checks)}", flush=True)
    print(f"data: stats {json.dumps(stats)}", flush=True)
    if not all(checks.values()):
        raise AssertionError(f"data path checks failed: {checks}")
    # the training run's K6 launches less the test epoch's: those of its micro-steps
    return {**launches, "small_attention": launches["small_attention"]
            - len(test) * per_eval["small_attention"]}, stats


# ----------------------------------------------------------------- phase 9

def check_k9_grad(dev, gen):
    """K9's gradient (the kernel's forward and backward through the autograd
    Function) against autograd of its plain forward at (4, 12, 1024, 64)
    bf16. The kernel rounds P and dS to bf16 before their products, autograd
    of the plain forward carries them in fp32: tolerance 2 bf16 ulps of the
    largest gradient (1.6e-2 x max)."""
    import torch
    from align3r_tpu_torch.ops import flash_attention as fa
    leaves = [torch.randn(4, 12, 1024, 64, generator=gen, device=dev).to(torch.bfloat16)
              .requires_grad_(True) for _ in range(3)]
    g = torch.randn(4, 12, 1024, 64, generator=gen, device=dev).to(torch.bfloat16)
    got = torch.autograd.grad(fa.flash_attention(*leaves), leaves, g)
    ref = torch.autograd.grad(fa.flash_attention_plain(*leaves)[0], leaves, g)
    out = {f"d{n}": max_err(a, b)[1] for n, a, b in zip("qkv", got, ref)}
    if not all(v <= 1.6e-2 for v in out.values()):
        raise AssertionError(f"K9 gradient out of tolerance: {out}")
    return out


def long_path(dev):
    """train() at the config's own 512x512 (see the module docstring)."""
    from align3r_tpu_torch.ops import fused_site as fs
    from align3r_tpu_torch.ops import flash_attention as fa
    from align3r_tpu_torch.ops import small_attention as sa

    counters = (fa.flash_attention, fa.flash_attention_bwd, sa.small_attention,
                fs.attention_site, fs.mlp_site)
    launches, checks, stats, _ = run_train(dev, "long", LONG_HW, LONG_PAIRS, LONG_ACCUM, 1,
                                           counters)
    steps = stats["micro_steps"]
    checks["k9_fwd_80_per_micro_step"] = launches["flash_attention"] == 80 * steps
    checks["k9_bwd_28_per_micro_step"] = launches["flash_attention_bwd"] == 28 * steps
    checks["k6_0"] = launches["small_attention"] == 0
    stats["k9_launches_per_micro_step"] = {k: launches[k] / steps for k in (
        "flash_attention", "flash_attention_bwd")}
    print(f"long: checks {json.dumps(checks)}", flush=True)
    print(f"long: stats {json.dumps(stats)}", flush=True)
    if not all(checks.values()):
        raise AssertionError(f"512x512 training checks failed: {checks}")
    return launches, stats


# ----------------------------------------------------------------- phase 8

def heads_path(dev, pm, pm32, imgs, priors):
    """The serving engine with the pipeline DPT heads (see the module
    docstring) on the main phase's model and frames; then with fp32 heads
    (pm32)."""
    import numpy as np
    import torch
    from align3r_tpu_torch.inference.engine import inference
    from align3r_tpu_torch.inference.pairs import make_pairs
    from align3r_tpu_torch.ops import dpt_pipeline as dp
    from align3r_tpu_torch.pipeline import reconstruct_scene

    pairs = make_pairs(N_FRAMES, "swinstride-5-noncyclic", symmetrize=True)
    counters = (dp.fused_res_unit, dp.fused_head_final)

    def engines(model):
        """Each head's outputs and launches (counters zeroed first), then
        warm engine seconds in turns."""
        out, launches, secs = {}, {}, {}
        for impl in ("xla", "pipeline"):
            for c in counters:
                c.launches = c.launches_fp32 = 0
            out[impl] = inference(pairs, model, imgs, priors, batch_size=BATCH,
                                  head_conv_impl=impl)
            torch.cuda.synchronize()
            launches[impl] = {**{c.__name__: c.launches for c in counters},
                              **{c.__name__ + "_fp32": c.launches_fp32 for c in counters}}
        for impl in ("xla", "pipeline", "pipeline", "xla"):    # warm, in turns
            t0 = time.perf_counter()
            inference(pairs, model, imgs, priors, batch_size=BATCH, head_conv_impl=impl)
            torch.cuda.synchronize()
            secs.setdefault(impl, []).append(time.perf_counter() - t0)
        return out, launches, secs

    def rel(a, b):   # |a - b| / (|b| + 1e-3), as the JAX head tests
        a, b = a.float(), b.float()
        return (a - b).abs() / (b.abs() + 1e-3)

    keys = (("pred1", "pts3d"), ("pred1", "conf"), ("pred2", "pts3d_in_other_view"),
            ("pred2", "conf"))
    out, launches, secs = engines(pm)
    print(f"heads: launches {json.dumps(launches)}", flush=True)
    diffs = {f"{k}.{v}": rel(out["pipeline"][k][v], out["xla"][k][v]).median().item()
             for k, v in keys}
    finite = all(torch.isfinite(out["pipeline"][k][v]).all().item()
                 for k in ("pred1", "pred2") for v in out["pipeline"][k])
    del out
    torch.cuda.empty_cache()
    kw = dict(scene_graph="swinstride-5-noncyclic", batch_size=BATCH, variant="flow",
              niter=300, schedule="linear", lr=0.01,
              scene_kw=dict(shared_focal=True, temporal_smoothing_weight=0.01,
                            translation_weight=1.0, flow_loss_weight=0.0,
                            flow_loss_start_epoch=0.1, flow_loss_thre=25, min_conf_thr=1.1))
    res = reconstruct_scene(imgs, priors, pm, inference_kw={"head_conv_impl": "pipeline"}, **kw)
    torch.cuda.synchronize()

    # fp32 heads: cuDNN's convolutions in full fp32 (TF32 off) on the xla side
    torch.backends.cudnn.allow_tf32 = False
    out32, launches32, secs32 = engines(pm32)
    print(f"heads: fp32 launches {json.dumps(launches32)}", flush=True)
    diffs32, max32 = {}, {}
    for k, v in keys:
        r = rel(out32["pipeline"][k][v], out32["xla"][k][v])
        diffs32[f"{k}.{v}"], max32[f"{k}.{v}"] = r.median().item(), r.max().item()
    finite32 = all(torch.isfinite(out32["pipeline"][k][v]).all().item()
                   for k in ("pred1", "pred2") for v in out32["pipeline"][k])
    del out32
    torch.cuda.empty_cache()
    checks = {
        "k7_84": launches["pipeline"]["fused_res_unit"] == 84,
        "k8_12": launches["pipeline"]["fused_head_final"] == 12,
        "xla_heads_launch_neither": sum(launches["xla"].values()) == 0,
        "outputs_finite": finite,
        "median_rel_diff_1e-2": all(d <= 1e-2 for d in diffs.values()),
        "scene_finite": bool(np.isfinite(res.losses).all()
                             and all(np.isfinite(a).all() for a in (
                                 res.get_im_poses(), res.get_focals(), res.get_depthmaps()))),
        "fp32_k7_84": launches32["pipeline"]["fused_res_unit_fp32"] == 84
        and launches32["pipeline"]["fused_res_unit"] == 84,
        "fp32_k8_12": launches32["pipeline"]["fused_head_final_fp32"] == 12
        and launches32["pipeline"]["fused_head_final"] == 12,
        "fp32_xla_heads_launch_neither": sum(launches32["xla"].values()) == 0,
        "fp32_outputs_finite": finite32,
        "fp32_median_rel_diff_1e-4": all(d <= 1e-4 for d in diffs32.values()),
    }
    stats = {"pairs": len(pairs), "launches": launches["pipeline"],
             "median_rel_diff_vs_xla_heads": diffs,
             "engine_s": {k: v for k, v in secs.items()},
             "pairs_per_s": {k: len(pairs) / min(v) for k, v in secs.items()},
             "scene_timings_s": res.timings,
             "fp32": {"launches": launches32["pipeline"],
                      "median_rel_diff_vs_xla_heads": diffs32,
                      "max_rel_diff_vs_xla_heads": max32,
                      "engine_s": secs32,
                      "pairs_per_s": {k: len(pairs) / min(v) for k, v in secs32.items()}}}
    print(f"heads: checks {json.dumps(checks)}", flush=True)
    print(f"heads: stats {json.dumps(stats)}", flush=True)
    if not all(checks.values()):
        raise AssertionError(f"pipeline-head checks failed: {checks}")
    return {**launches["pipeline"], **{k: v for k, v in launches32["pipeline"].items()
                                        if k.endswith("_fp32")}}, stats


# ---------------------------------------------------------------- phase 10

def write_demo_inputs(root):
    """DEMO_FRAMES smooth 1024x576 PNG frames, each with a DepthPro-style
    prior (`<frame>_pred_depth_depthpro.npz`: depth and focallength_px),
    written by the port's own PNG writer."""
    import numpy as np
    from align3r_tpu_torch.utils.png import write_png
    rng = np.random.default_rng(3)
    Hf, Wf = DEMO_HW
    yy, xx = np.mgrid[0:Hf, 0:Wf].astype(np.float32)
    for k in range(DEMO_FRAMES):
        ph = rng.uniform(0, 2 * np.pi, 3)
        img = np.stack([np.sin(xx / (80 + 14 * c) + 0.15 * k + ph[c])
                        * np.cos(yy / (60 + 10 * c) - 0.1 * k) for c in range(3)], -1)
        img = 127.5 + 110 * img + 8 * rng.standard_normal(img.shape)
        write_png(np.clip(img, 0, 255).astype(np.uint8), os.path.join(root, f"{k:05d}.png"))
        depth = 2.0 + 0.5 * np.sin(xx / 120 + 0.1 * k) + 0.3 * np.cos(yy / 90)
        np.savez(os.path.join(root, f"{k:05d}_pred_depth_depthpro.npz"),
                 depth=depth.astype(np.float32), focallength_px=np.float32(1000.0))


def demo_path(dev, card):
    """The demo's serving entry (see the module docstring)."""
    import shutil
    import numpy as np
    import torch
    from align3r_tpu_torch.models.config import VIT_L_512
    from align3r_tpu_torch.models.align3r import Align3R, init_align3r_
    from align3r_tpu_torch.ops import edge_loss as el
    from align3r_tpu_torch.ops import fused_site as fs
    from align3r_tpu_torch.inference.images import load_images, stack_views
    from align3r_tpu_torch.pipeline import reconstruct_scene
    from align3r_tpu_torch.tools import demo
    from align3r_tpu_torch.training import step as ts
    from align3r_tpu_torch.training.train import export_torch_checkpoint

    phase_t0 = time.perf_counter()
    base = os.path.join(HERE, "build", "demo")
    shutil.rmtree(base, ignore_errors=True)
    frames = os.path.join(base, "frames")
    os.makedirs(frames)
    t0 = time.perf_counter()
    write_demo_inputs(frames)
    with torch.device(dev):
        model = Align3R(VIT_L_512)
    init_align3r_(model, seed=0)
    with torch.no_grad():   # as the main phase: the prior branch counts, heads in range
        gz = torch.Generator(device=dev).manual_seed(1)
        for z in model.zero_convs:
            z[0].weight.copy_(torch.randn(z[0].weight.shape, generator=gz, device=dev) * 0.02)
        for h in (model.downstream_head1, model.downstream_head2):
            h.dpt.head[4].weight.mul_(0.01)
    ckpt = os.path.join(base, "vit_l_512_seed0.pth")
    export_torch_checkpoint(ckpt, model)
    del model
    torch.cuda.empty_cache()
    setup_s = time.perf_counter() - t0
    print(f"demo: {DEMO_FRAMES} frames {DEMO_HW[1]}x{DEMO_HW[0]} and a seeded VIT_L_512 "
          f"checkpoint written in {setup_s:.1f} s", flush=True)

    counters = (fs.attention_site, fs.mlp_site, el.edge_loss_fwd, el.edge_loss_bwd,
                el.permute_packed, fs.gemm)

    def run(tag, fn):
        for c in counters:
            c.launches = 0
        out = fn()
        torch.cuda.synchronize()
        launches = {c.__name__: c.launches for c in counters}
        print(f"demo: {tag} launches {json.dumps(launches)}", flush=True)
        return out, launches

    # the weights are loaded once, as a user's run loads them, and the
    # prepared model serves both modes and the prior run
    t0 = time.perf_counter()
    pm = demo.load_model(ckpt, 512, dev)
    torch.cuda.synchronize()
    weights_s = time.perf_counter() - t0
    argv = ["--weights", ckpt, "--input_dir", frames, "--image_size", "512",
            "--niter", "300", "--seq_name", "synthetic", "--silent"]
    runs, launches, checks = {}, {}, {}
    for mode in ("eval_pose", "eval_pose_h"):
        out = os.path.join(base, mode)
        runs[mode], launches[mode] = run(mode, lambda: demo.main(
            argv + ["--output_dir", out, "--mode", mode, "--clip_size", "5"], model=pm))
    seq = runs["eval_pose"]["out_dir"]
    names = set(os.listdir(seq))
    want = {"pred_traj.txt", "pred_intrinsics.txt", "pred_focals.txt", "scene.html",
            "scene.glb"} | {f"frame_{i:04d}.{e}" for i in range(DEMO_FRAMES) for e in ("npy", "png")} \
        | {f"conf_{i}.npy" for i in range(DEMO_FRAMES)} \
        | {f"dynamic_mask_{i}.png" for i in range(DEMO_FRAMES)}
    checks["artifacts"] = want <= names
    raw = open(os.path.join(seq, "scene.glb"), "rb").read()
    magic, ver, total = struct.unpack_from("<4sII", raw, 0)
    jlen, jtag = struct.unpack_from("<I4s", raw, 12)
    gltf = json.loads(raw[20:20 + jlen])
    checks["glb_header"] = (magic == b"glTF" and ver == 2 and total == len(raw)
                            and jtag == b"JSON"
                            and [im["mimeType"] for im in gltf["images"]]
                            == ["image/png"] * DEMO_FRAMES)
    checks["html"] = "[-f[0], -f[1], -f[2], tz]" in open(os.path.join(seq, "scene.html")).read()
    traj = np.loadtxt(os.path.join(seq, "pred_traj.txt"))
    depths = np.stack([np.load(os.path.join(seq, f"frame_{i:04d}.npy"))
                       for i in range(DEMO_FRAMES)])
    checks["eval_pose_finite"] = (traj.shape == (DEMO_FRAMES, 8) and bool(np.isfinite(traj).all())
                                  and depths.shape == (DEMO_FRAMES, H, W)
                                  and bool(np.isfinite(depths).all() and (depths > 0).all()))
    hseq = runs["eval_pose_h"]["out_dir"]
    htraj = np.loadtxt(os.path.join(hseq, "pred_traj.txt"))
    hdepths = np.load(os.path.join(hseq, "depth_maps.npy"))
    checks["eval_pose_h_finite"] = (htraj.shape == (DEMO_FRAMES, 8)
                                    and bool(np.isfinite(htraj).all())
                                    and hdepths.shape == (DEMO_FRAMES, H, W)
                                    and bool(np.isfinite(hdepths).all()))

    # the depth tool's prior variant (tool/depth_test.py:204-216) on the same
    # frames: the prior's z channel as frozen mono depth, complete graph
    t0 = time.perf_counter()
    stacked = stack_views(load_images(frames, 512, traj_format="default"))
    load_s = time.perf_counter() - t0
    n = stacked["imgs"].shape[0]
    mono = stacked["priors"][..., 2].reshape(n, -1)
    prior, launches["prior"] = run("prior", lambda: reconstruct_scene(
        stacked["imgs"], stacked["priors"], pm, scene_graph="complete", variant="prior",
        mono_depths=mono, niter=300, lr=0.05, schedule="cosine", batch_size=8,
        conf_clamp=10.0, scene_kw=dict(min_conf_thr=1.1)))
    del pm
    checks["prior_finite"] = (prior.cfg.if_use_mono and prior.losses.shape == (300,)
                              and bool(np.isfinite(prior.losses).all())
                              and all(np.isfinite(a).all() for a in (
                                  prior.get_im_poses(), prior.get_focals(),
                                  prior.get_depthmaps())))
    checks["k1_k5_launched"] = all(v > 0 for ln in launches.values() for v in ln.values())
    t = runs["eval_pose"]["timings"]
    th = runs["eval_pose_h"]["timings"]
    stats = {"frames": DEMO_FRAMES, "frame_hw": DEMO_HW, "image_hw": [H, W],
             "setup_s": setup_s,
             "weights_s": weights_s,
             "eval_pose": {"load_s": t["frames_s"],
                           "engine_s": t["inference_s"], "init_s": t["init_s"],
                           "solve_s": t["solve_s"], "writers_s": t["writers_s"],
                           "reconstruct_s": t["reconstruct_s"]},
             "eval_pose_h": {"load_s": th["frames_s"],
                             "hierarchical_s": th["reconstruct_s"],
                             "clips": {k: v for k, v in th.items() if k.startswith("clips_")},
                             "writers_s": th["writers_s"]},
             "prior": {"load_s": load_s, **prior.timings},
             "launches": launches, "card": card,
             "phase_s": time.perf_counter() - phase_t0}
    print(f"demo: checks {json.dumps(checks)}", flush=True)
    print(f"demo: stage seconds {json.dumps(stats)}", flush=True)
    if not all(checks.values()):
        raise AssertionError(f"demo checks failed: {checks}")
    return stats


# ---------------------------------------------------------------- phase 11
# K9's fp32 forward at the monocular priors' DINOv2 attentions (D = 64, 16
# heads): Depth Pro's patch encoder (35 crops a frame) at --batch_size 1 and
# 4, its image and FOV encoders, Depth Anything V2 at 518x924 (batch 4) and
# PromptDA at 574x1022 (batch 2)
def check_sam2_attention(dev, gen):
    """K6's and K9's fp32 forwards at SAM2_SHAPES against their plain
    versions (1e-4 x max, the fp32 rows' tolerance), timed from a CUDA graph
    beside scaled_dot_product_attention in fp32 and the plain version; bound
    3 TF32 products a product at PEAK_TF32, or the bytes (q, k, v read, o
    written; K9's log-sum-exp too)."""
    import torch
    import torch.nn.functional as F
    from align3r_tpu_torch.ops import flash_attention as fa
    from align3r_tpu_torch.ops import small_attention as sa
    rows = []
    for kernel, name, (B_, H_, Nq, D_, Nk) in SAM2_SHAPES:
        q = torch.randn(B_, H_, Nq, D_, generator=gen, device=dev)
        k, v = (torch.randn(B_, H_, Nk, D_, generator=gen, device=dev) for _ in range(2))
        if kernel == "K6 fp32":
            kern = lambda: sa.small_attention(q, k, v)
            plain = lambda: sa.small_attention_plain(q, k, v)
            out, ref, lse_bytes = kern(), plain(), 0
        else:
            kern = lambda: fa.flash_attention_fwd(q, k, v)
            plain = lambda: fa.flash_attention_plain(q, k, v)
            out, ref, lse_bytes = kern()[0], plain()[0], B_ * H_ * Nq * 4
        torch.cuda.synchronize()
        e = max_err(out, ref)
        heads = B_ * H_
        b_ms, b_by = bound(heads * (2 * Nq + 2 * Nk) * D_ * 4 + lse_bytes,
                           3 * 4 * heads * Nq * Nk * D_, PEAK_TF32)
        rows.append(ratios(dict(
            kernel=kernel, shape=f"{name} {(B_, H_, Nq, Nk, D_)} fp32", max_abs_err=e[0],
            max_rel_err=e[1], tol=1e-4 * e[2],
            ok=e[0] <= 1e-4 * e[2] and torch.isfinite(out).all().item(),
            ms=graph_time(kern, 20), ms_eager=cuda_time(kern, 20),
            plain_ms=cuda_time(plain, 3),
            library_ms=graph_time(lambda: F.scaled_dot_product_attention(q, k, v), 20),
            bound_ms=b_ms, bound_by=b_by)))
        del q, k, v, out, ref
    return rows


def moving_discs(n, radius=40, step=16):
    """(n, H, W) bool: a disc moving right by `step` pixels a frame."""
    import numpy as np
    yy, xx = np.mgrid[0:H, 0:W]
    return np.stack([(yy - H // 2) ** 2 + (xx - 120 - step * t) ** 2 <= radius ** 2
                     for t in range(n)])


def sam2_path(dev, card, imgs):
    """SAM2.1 Hiera-L from seeded weights, written and read back as a local
    HF folder, refining moving-disc masks on the main phase's first frames
    (see the module docstring). Returns the model (for the flow phase), the
    K6 / K9 launches and the stats."""
    import numpy as np
    import shutil
    import torch
    from align3r_tpu_torch.models import sam2 as ts
    from align3r_tpu_torch.models import sam2_video as tsv
    from align3r_tpu_torch.models.raft import exact_fp32
    from align3r_tpu_torch.models.sam2_refine import refine_motion_mask_w_sam2
    from align3r_tpu_torch.ops import flash_attention as fa
    from align3r_tpu_torch.ops import small_attention as sa
    from align3r_tpu_torch.utils import hf_weights

    phase_t0 = time.perf_counter()
    exact_fp32()
    cfg = tsv.config_from_hf_sam2_video(SAM2_HF_CONFIG)
    hi = cfg.image.hiera
    published = (hi.hidden_size == 144 and hi.num_heads_per_stage == (2, 4, 8, 16)
                 and hi.blocks_per_stage == (2, 6, 36, 4)
                 and hi.embed_dim_per_stage == (144, 288, 576, 1152)
                 and hi.window_size_per_stage == (8, 4, 16, 8)
                 and hi.global_attention_blocks == (23, 33, 43)
                 and hi.window_pos_bg_size == (7, 7) and cfg.image.image_size == 1024
                 and cfg.image.fpn_hidden_size == 256 and cfg.ma_num_layers == 4
                 and cfg.ma_num_heads == 1 and cfg.ma_hidden_size == 256
                 and cfg.ma_ff_hidden_size == 2048 and cfg.ma_rope_feat_sizes == (64, 64)
                 and cfg.mem_dim == 64 and cfg.num_maskmem == 7
                 and cfg.max_object_pointers == 16)
    folder = os.path.join(HERE, "build", "sam2", "sam2.1-hiera-large-seed0")
    shutil.rmtree(folder, ignore_errors=True)
    t0 = time.perf_counter()
    with torch.device(dev):
        seeded = ts.init_sam2_(tsv.SAM2Video(cfg).eval(), seed=0)
    n_params = sum(p.numel() for p in seeded.parameters())
    hf_weights.save_pretrained(folder, SAM2_HF_CONFIG, seeded.state_dict())
    del seeded
    torch.cuda.empty_cache()
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model, cfg = tsv.load_hf_sam2_video(folder, device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0

    frames01 = np.asarray(imgs[:SAM2_FRAMES]) * 0.5 + 0.5
    masks = moving_discs(SAM2_FRAMES)
    steps, tracked = tsv.frame_steps(masks)
    trunk, mem = tsv.dispatch_counts(cfg)
    expect = {"small_attention": steps * trunk["small"],
              "flash_attention": tracked * mem["flash"], "flash_attention_bwd": 0}
    counters = (sa.small_attention, fa.flash_attention, fa.flash_attention_bwd)
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    refined = refine_motion_mask_w_sam2(frames01, masks, model=model, device=dev)
    torch.cuda.synchronize()
    refine_s = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    print(f"sam2: {SAM2_FRAMES} frames, {steps} frame steps ({tracked} tracked); per step "
          f"{dict(trunk)} Hiera-L attentions, per tracked step {dict(mem)} memory "
          f"self-attentions; launches {json.dumps(launches)}, expected {json.dumps(expect)}",
          flush=True)

    # K6 / K9 against plain attention on the same frames
    fr = tsv.preprocess_sam2_frames(frames01[:SAM2_AGREE_FRAMES], cfg.image.image_size,
                                    device=dev)
    S = cfg.image.image_size
    seed = (torch.nn.functional.interpolate(
        torch.as_tensor(masks[0], dtype=torch.float32, device=dev)[None, None], size=(S, S),
        mode="bilinear", align_corners=False)[0, 0, :, :, None] > 0.5).float()
    t0 = time.perf_counter()
    got = tsv.propagate_video(model, fr, seed)
    torch.cuda.synchronize()
    auto_s = time.perf_counter() - t0
    model.attn_impl = "xla"
    t0 = time.perf_counter()
    ref = tsv.propagate_video(model, fr, seed)
    torch.cuda.synchronize()
    xla_s = time.perf_counter() - t0
    model.attn_impl = "auto"
    rel = _rel_diff(got.cpu().numpy(), ref.cpu().numpy())
    checks = {
        "published_geometry": published,
        "launches": launches == expect and steps == 23 and tracked == 11,
        "refined": refined.shape == (SAM2_FRAMES, H, W) and refined.dtype == bool,
        "contains_input": bool((refined | masks).sum() == refined.sum()),
        "logits_finite": bool(torch.isfinite(got).all() and torch.isfinite(ref).all()),
        "matches_plain_attention": rel <= SAM2_REL_TOL,
    }
    stats = {"card": card, "params": n_params, "write_s": write_s, "load_s": load_s,
             "frame_steps": steps, "tracked_steps": tracked, "launches": launches,
             "k6_per_step": trunk["small"], "k9_per_tracked_step": mem["flash"],
             "refine_s": refine_s, "s_per_frame_step": refine_s / steps,
             "dynamic_share_in": float(masks.mean()), "dynamic_share_out": float(refined.mean()),
             "propagate_s": auto_s, "propagate_s_plain_attention": xla_s,
             "logits_median_rel_diff_vs_plain": rel,
             "logits_max_abs_diff_vs_plain": float((got - ref).abs().max()),
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
             "phase_s": time.perf_counter() - phase_t0}
    print(f"sam2: checks {json.dumps(checks)}", flush=True)
    print(f"sam2: stats {json.dumps(stats)}", flush=True)
    if not all(checks.values()):
        raise AssertionError(f"sam2 checks failed: {checks}")
    return (model, cfg), launches, stats


PRIOR_SHAPES = (("Depth Pro patch encoder, batch 1", (35, 16, 577, 64)),
                ("Depth Pro patch encoder, batch 4", (140, 16, 577, 64)),
                ("Depth Pro image / FOV encoder, batch 1", (1, 16, 577, 64)),
                ("Depth Anything V2 518x924, batch 4", (4, 16, 2443, 64)),
                ("PromptDA 574x1022, batch 2", (2, 16, 2994, 64)))
DP_FRAMES = 4          # Depth Pro's cut: 37 ViT-L passes a frame
PRIOR_REL_TOL = 1e-4   # median relative difference, K9 against plain attention


def check_k9_prior(dev, gen):
    """K9's fp32 forward against flash_attention_plain at PRIOR_SHAPES
    (1e-4 x max), timed from a CUDA graph beside scaled_dot_product_attention
    in fp32 and the plain version; bound 3 TF32 products a product at
    PEAK_TF32, or the bytes."""
    import torch
    import torch.nn.functional as F
    from align3r_tpu_torch.ops import flash_attention as fa
    rows = []
    for name, shape in PRIOR_SHAPES:
        q, k, v = (torch.randn(*shape, generator=gen, device=dev) for _ in range(3))
        (o, _), (ro, _) = fa.flash_attention_fwd(q, k, v), fa.flash_attention_plain(q, k, v)
        torch.cuda.synchronize()
        e = max_err(o, ro)
        B_, H_, N_, D_ = shape
        heads = B_ * H_
        b_ms, b_by = bound(4 * heads * N_ * D_ * 4 + heads * N_ * 4,
                           3 * 4 * heads * N_ * N_ * D_, PEAK_TF32)
        kern = lambda: fa.flash_attention_fwd(q, k, v)
        rows.append(ratios(dict(
            kernel="K9 fp32", shape=f"{name} {tuple(shape)} fp32", max_abs_err=e[0],
            max_rel_err=e[1], tol=1e-4 * e[2],
            ok=e[0] <= 1e-4 * e[2] and torch.isfinite(o).all().item(),
            ms=graph_time(kern, 10), ms_eager=cuda_time(kern, 10),
            plain_ms=cuda_time(lambda: fa.flash_attention_plain(q, k, v), 2),
            library_ms=graph_time(lambda: F.scaled_dot_product_attention(q, k, v), 10),
            bound_ms=b_ms, bound_by=b_by)))
        del q, k, v, o, ro
        torch.cuda.empty_cache()
    return rows


def _copy_frames(src, dst, n=None):
    import shutil
    os.makedirs(dst)
    names = sorted(f for f in os.listdir(src) if f.endswith(".png"))[:n]
    for f in names:
        shutil.copy(os.path.join(src, f), dst)
    return names


def _rel_diff(a, b):
    """Median over entries of |a - b| / |b| (entries where b != 0)."""
    import numpy as np
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    nz = b != 0
    return float(np.median(np.abs(a[nz] - b[nz]) / np.abs(b[nz]))) if nz.any() else 0.0


def prior_path(dev, card, rows):
    """The monocular priors and the tools around them (see the module
    docstring), on the demo phase's frames."""
    import dataclasses
    import numpy as np
    import shutil
    import torch
    from align3r_tpu_torch.models import depth_anything as tda
    from align3r_tpu_torch.models import depth_pro as tdp
    from align3r_tpu_torch.models.prompt_da import PromptDepthAnything
    from align3r_tpu_torch.ops import edge_loss as el
    from align3r_tpu_torch.ops import flash_attention as fa
    from align3r_tpu_torch.ops import fused_site as fs
    from align3r_tpu_torch.ops import small_attention as sa
    from align3r_tpu_torch.tools import demo, demo_refine, prior_depth
    from align3r_tpu_torch.utils import hf_weights

    phase_t0 = time.perf_counter()
    k9 = check_k9_prior(dev, torch.Generator(device=dev).manual_seed(11))
    for r in k9:
        print("prior: " + json.dumps(r), flush=True)
    rows += k9
    if not all(r["ok"] for r in k9):
        raise AssertionError("K9 fp32 forward out of tolerance at the prior shapes")

    base = os.path.join(HERE, "build", "prior")
    shutil.rmtree(base, ignore_errors=True)
    frames = os.path.join(HERE, "build", "demo", "frames")
    attn = (fa.flash_attention, fa.flash_attention_bwd, sa.small_attention)
    stats, checks, launches = {"card": card}, {}, {}

    def counted(tag, fn):
        for c in attn:
            c.launches = 0
        out = fn()
        torch.cuda.synchronize()
        launches[tag] = {c.__name__: c.launches for c in attn}
        print(f"prior: {tag} launches {json.dumps(launches[tag])}", flush=True)
        return out

    def run_prior(tag, prior, model, n_frames, batch, passes, layers):
        """prior_depth.main on a copy of n_frames frames with K9 ("auto"),
        then on another copy with plain attention; checks and differences.
        One K9 forward a layer of each of `passes` ViT passes."""
        names = _copy_frames(frames, os.path.join(base, tag), n_frames)
        _copy_frames(frames, os.path.join(base, tag + "_xla"), n_frames)
        argv = ["--depth_prior_name", prior, "--batch_size", str(batch)]
        model[0].attn_impl = "auto"
        res = counted(tag, lambda: prior_depth.main(
            argv + ["--input_dir", os.path.join(base, tag)], model=model))
        model[0].attn_impl = "xla"
        ref = prior_depth.main(argv + ["--input_dir", os.path.join(base, tag + "_xla")],
                               model=model)
        model[0].attn_impl = "auto"
        got = [np.load(f) for f in res["files"]]
        want = [np.load(f) for f in ref["files"]]
        checks[tag + "_npz"] = len(got) == len(names) == n_frames and all(
            os.path.isfile(os.path.join(base, tag, os.path.splitext(f)[0]
                                        + f"_pred_depth_{prior}.npz")) for f in names)
        checks[tag + "_finite"] = all(
            np.isfinite(z["depth"]).all() and np.isfinite(z["focallength_px"])
            and z["depth"].shape == DEMO_HW for z in got)
        checks[tag + "_launches"] = (launches[tag]["flash_attention"] == layers * passes
                                     and launches[tag]["flash_attention_bwd"] == 0
                                     and launches[tag]["small_attention"] == 0)
        d_rel = _rel_diff(np.stack([z["depth"] for z in got]),
                          np.stack([z["depth"] for z in want]))
        f_rel = _rel_diff([z["focallength_px"] for z in got],
                          [z["focallength_px"] for z in want])
        checks[tag + "_matches_plain_attention"] = d_rel <= PRIOR_REL_TOL and f_rel <= PRIOR_REL_TOL
        t = res["timings"]
        stats[tag] = {"frames": n_frames, "batch": batch, "vit_passes": passes,
                      "k9_launches": launches[tag]["flash_attention"],
                      "depth_median_rel_diff_vs_plain": d_rel,
                      "focal_median_rel_diff_vs_plain": f_rel,
                      "depth_range": [float(min(z["depth"].min() for z in got)),
                                      float(max(z["depth"].max() for z in got))],
                      "focal_px": [float(z["focallength_px"]) for z in got],
                      "s_per_frame": (t["frames_s"] + t["model_s"] + t["write_s"]) / n_frames,
                      "model_s_per_frame": t["model_s"] / n_frames,
                      "model_s_per_frame_plain_attention": ref["timings"]["model_s"] / n_frames,
                      **t}
        print(f"prior: {tag} {json.dumps(stats[tag])}", flush=True)

    # Depth Anything V2 Large, seeded, on all 12 frames at batch 4 (24 K9
    # forwards a batch: one ViT-L pass)
    t0 = time.perf_counter()
    with torch.device(dev):
        da = tda.init_prior_(tda.DepthAnything(tda.DA_V2_LARGE).eval(), seed=0)
    torch.cuda.synchronize()
    stats["da_init_s"] = time.perf_counter() - t0
    run_prior("depthanything", "depthanything", (da, tda.DA_V2_LARGE), DEMO_FRAMES, 4,
              -(-DEMO_FRAMES // 4), tda.DA_V2_LARGE.num_layers)
    del da
    torch.cuda.empty_cache()

    # Depth Pro at the published geometry (ViT-L patch 16 at 384, as
    # config_from_hf_depth_pro builds it), DP_FRAMES frames at batch 1: 35
    # crops through the patch encoder, the image and the FOV encoders, 3 ViT
    # passes a frame
    t0 = time.perf_counter()
    dp_cfg = tdp.config_from_hf_depth_pro(tdp.PUBLISHED_HF_CONFIG)
    with torch.device(dev):
        dp = tda.init_prior_(tdp.DepthPro(dp_cfg).eval(), seed=1)
    torch.cuda.synchronize()
    stats["dp_init_s"] = time.perf_counter() - t0
    run_prior("depthpro", "depthpro", (dp, dp_cfg), DP_FRAMES, 1, 3 * DP_FRAMES,
              dp_cfg.patch_model.num_layers)
    del dp
    torch.cuda.empty_cache()

    # the demo on the Depth Anything priors just written
    kernels = (fs.attention_site, fs.mlp_site, el.edge_loss_fwd, el.edge_loss_bwd,
               el.permute_packed)
    ckpt = os.path.join(HERE, "build", "demo", "vit_l_512_seed0.pth")
    t0 = time.perf_counter()
    pm = demo.load_model(ckpt, 512, dev)
    stats["align3r_weights_s"] = time.perf_counter() - t0
    for c in kernels:
        c.launches = 0
    out = demo.main(["--input_dir", os.path.join(base, "depthanything"), "--output_dir",
                     os.path.join(base, "demo_da"), "--image_size", "512", "--niter", "300",
                     "--seq_name", "synthetic", "--depth_prior_name", "depthanything",
                     "--silent"], model=pm)
    torch.cuda.synchronize()
    launches["demo_depthanything"] = {c.__name__: c.launches for c in kernels}
    traj = np.loadtxt(os.path.join(out["out_dir"], "pred_traj.txt"))
    checks["demo_depthanything"] = (traj.shape == (DEMO_FRAMES, 8) and bool(np.isfinite(traj).all())
                                    and all(launches["demo_depthanything"].values()))
    stats["demo_depthanything"] = out["timings"]

    # the refine tool with a seeded full-width PromptDA written as a local HF
    # folder, on the Depth Pro frames (their .npz priors are the tool's)
    t0 = time.perf_counter()
    pda_cfg = dataclasses.replace(tda.DA_V2_LARGE, depth_estimation_type="metric")
    with torch.device(dev):
        pda = tda.init_prior_(PromptDepthAnything(pda_cfg).eval(), seed=2)
    pda_dir = os.path.join(base, "promptda_vitl_seed2")
    hf_weights.save_pretrained(pda_dir, tda.hf_config(pda_cfg, "prompt_depth_anything"),
                               pda.state_dict())
    del pda
    torch.cuda.empty_cache()
    stats["promptda_write_s"] = time.perf_counter() - t0
    out = counted("refine", lambda: demo_refine.main(
        ["--input_dir", os.path.join(base, "depthpro"), "--output_dir",
         os.path.join(base, "refine"), "--image_size", "512", "--niter", "300",
         "--seq_name", "synthetic", "--promptda_model", pda_dir, "--silent"], model=pm))
    del pm
    refined = out["refined"]
    checks["refine"] = (refined.shape == (DP_FRAMES, *DEMO_HW) and bool(np.isfinite(refined).all())
                        and len([f for f in os.listdir(out["out_dir"])
                                 if f.endswith("_refined.npy")]) == DP_FRAMES
                        and launches["refine"]["flash_attention"]
                        == pda_cfg.num_layers * -(-DP_FRAMES // 2)
                        and launches["refine"]["flash_attention_bwd"] == 0)
    stats["refine"] = {**out["timings"], "k9_launches": launches["refine"]["flash_attention"],
                       "refine_s_per_frame": out["timings"]["refine_s"] / DP_FRAMES}
    stats["launches"] = launches
    stats["phase_s"] = time.perf_counter() - phase_t0
    print(f"prior: checks {json.dumps(checks)}", flush=True)
    print(f"prior: stage seconds {json.dumps(stats)}", flush=True)
    if not all(checks.values()):
        raise AssertionError(f"prior checks failed: {checks}")
    k9_launches = {"flash_attention": sum(launches[t]["flash_attention"]
                                          for t in ("depthanything", "depthpro", "refine"))}
    return k9_launches, stats


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "align3r_tpu_torch")):
        return fail("setup", "align3r_tpu_torch/ is not beside chip_smoke.py: "
                             "run from the root of the repository")
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        return fail("device", "torch.cuda.is_available() is False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    card = smi[0].strip() if smi else "nvidia-smi gave no output"
    dev = torch.device("cuda", 0)
    print(f"device: {card} (torch {torch.__version__}, cuda {torch.version.cuda})",
          flush=True)

    phase = "build"
    try:
        from align3r_tpu_torch.ops import _lib
        path, secs = _lib.build()
        _lib.library()
        print(f"build: {path.name} in {secs:.1f} s", flush=True)
        usage = ptxas_usage(path.with_suffix(".log").read_text())
        print("build: ptxas registers and spill bytes " + json.dumps(usage), flush=True)
        print("build: kernels that spill " + json.dumps(
            [k for k, (_, st, ld) in usage.items() if st or ld]), flush=True)
        sass = hgmma_counts(path, [*CORE_INSTANCES, *TF32_CONV, *ATTN_INSTANCES])
        core_sass = {k: n for k, n in sass.items() if any(c in k for c in CORE_INSTANCES)}
        tf32_sass = {k: n for k, n in sass.items() if any(c in k for c in TF32_CONV)}
        attn_sass = {k: n for k, n in sass.items() if k not in core_sass and k not in tf32_sass}
        print("build: HGMMA instructions per GEMM-core instance " + json.dumps(core_sass),
              flush=True)
        print("build: HGMMA instructions per K7/K8 fp32 conv instance " + json.dumps(tf32_sass),
              flush=True)
        print("build: HGMMA instructions per K9 D=256 backward, K6 fp32 and K9 fp32 kernel "
              + json.dumps(attn_sass), flush=True)
        core = {k: v for k, v in usage.items() if any(n in k for n in CORE_INSTANCES)}
        counts = {n: sum(n in k for k in core) for n in CORE_INSTANCES}
        bad = [k for k, (_, st, ld) in core.items() if st or ld]
        tf32 = {k: v for k, v in usage.items() if any(n in k for n in TF32_CONV)}
        stray = [k for k in usage if ("gemm" in k or "conv" in k) and k not in core
                 and k not in tf32 and not re.search(FMA_F32, k)]
        edge_spills = [k for k, (_, st, ld) in usage.items() if "edge" in k and (st or ld)]
        if edge_spills:
            return fail(phase, f"K3/K4 kernels spill: {edge_spills}")
        if (counts != CORE_INSTANCES or bad or stray or sorted(core_sass) != sorted(core)
                or not all(core_sass.values())):
            return fail(phase, f"GEMM-core instances {counts} ({CORE_INSTANCES} expected); "
                               f"spilling: {bad}; not on the sm90 core: {stray}; without "
                               f"HGMMA: {[k for k, n in core_sass.items() if not n]}")
        tf32_counts = {n: sum(n in k for k in tf32) for n in TF32_CONV}
        tf32_bad = [k for k, (_, st, ld) in tf32.items() if st or ld]
        if (tf32_counts != TF32_CONV or tf32_bad or sorted(tf32_sass) != sorted(tf32)
                or not all(tf32_sass.values())):
            return fail(phase, f"fp32 conv instances {tf32_counts} ({TF32_CONV} expected); "
                               f"spilling: {tf32_bad}; without HGMMA: "
                               f"{[k for k, n in tf32_sass.items() if not n]}")
        attn = {k: v for k, v in usage.items() if any(re.search(p, k) for p in ATTN_INSTANCES)}
        attn_counts = {p: sum(bool(re.search(p, k)) for k in attn) for p in ATTN_INSTANCES}
        attn_bad = [k for k, (_, st, ld) in attn.items() if st or ld]
        wmma = [k for k in usage if re.search(WMMA_BF16, k)]
        fma = [k for k in usage if re.search(FMA_F32, k)]
        if (attn_counts != ATTN_INSTANCES or attn_bad or wmma or fma
                or sorted(attn_sass) != sorted(attn) or not all(attn_sass.values())):
            return fail(phase, f"attention instances {attn_counts} ({ATTN_INSTANCES} "
                               f"expected); spilling: {attn_bad}; bf16 WMMA backward: {wmma}; "
                               f"FMA fp32 attention or conv: {fma}; "
                               f"without HGMMA: {[k for k, n in attn_sass.items() if not n]}")

        phase = "kernels"
        from align3r_tpu_torch.inference.pairs import make_pairs
        gen = torch.Generator(device=dev).manual_seed(0)
        rows = (check_sites(dev, gen) + check_gemms(dev, gen) + check_edge(dev, gen)
                + [r for n, g in DEMO_GRAPHS for r in check_edge(
                    dev, gen, n, make_pairs(n, g, symmetrize=True))]
                + check_edge_scenes(dev, gen) + check_k5(dev, gen)
                + [r for n, g in DEMO_GRAPHS for r in check_k5(dev, gen, n, g, timed=False)]
                + check_k7(dev, gen) + check_k8(dev, gen) + check_k9(dev, gen)
                + check_sam2_attention(dev, gen))
        for r in rows:
            print("kernels: " + json.dumps(r), flush=True)
        bad = [r for r in rows if not r["ok"]]
        if bad:
            return fail(phase, f"{len(bad)} kernel checks out of tolerance")
        torch.cuda.empty_cache()

        phase = "parity"
        print("parity: " + json.dumps(parity_small(dev)), flush=True)
        torch.cuda.empty_cache()

        phase = "main"
        launches, rates, pm, pm32, imgs, priors = main_path(dev)
        torch.cuda.empty_cache()

        phase = "batch"
        batch_launches, batch_stats = batch_path(dev, pm, card)
        torch.cuda.empty_cache()

        phase = "sam2"
        sam2, sam2_launches, sam2_stats = sam2_path(dev, card, imgs)
        torch.cuda.empty_cache()

        phase = "flow"
        flow_launches, flow_stats = flow_path(dev, pm, imgs, priors, sam2)
        del sam2
        torch.cuda.empty_cache()

        phase = "heads"
        heads_launches, heads_stats = heads_path(dev, pm, pm32, imgs, priors)
        del pm, pm32
        torch.cuda.empty_cache()

        phase = "demo"
        demo_stats = demo_path(dev, card)
        torch.cuda.empty_cache()

        phase = "prior"
        prior_launches, prior_stats = prior_path(dev, card, rows)
        torch.cuda.empty_cache()

        phase = "train"
        k6_rows = check_k6(dev, gen)
        for r in k6_rows:
            print("train: " + json.dumps(r), flush=True)
        if not all(r["ok"] for r in k6_rows):
            return fail(phase, "K6 out of tolerance")
        print("train: gradients " + json.dumps(check_grads(dev, gen)), flush=True)
        torch.cuda.empty_cache()
        train_launches, train_stats = train_path(dev)
        # the K6 share of a micro-step, from the kernel times above: 24
        # encoder-shaped and 56 decoder-shaped launches per micro-step
        k6_ms = 24 * k6_rows[0]["ms"] + 56 * k6_rows[1]["ms"]
        train_stats["k6_share_est"] = k6_ms / train_stats["warm_ms_per_micro_step"]
        print(f"train: K6 {k6_ms:.3f} ms per micro-step, "
              f"{100 * train_stats['k6_share_est']:.1f}% of it", flush=True)
        rows += k6_rows
        torch.cuda.empty_cache()

        phase = "data"
        data_launches, data_stats = data_path(dev, card, train_launches, train_stats)
        torch.cuda.empty_cache()

        phase = "ddp"
        cosine_launches, ddp_stats = ddp_path(dev, card)
        torch.cuda.empty_cache()

        phase = "long"
        print("long: K9 gradient " + json.dumps(check_k9_grad(dev, gen)), flush=True)
        torch.cuda.empty_cache()
        long_launches, long_stats = long_path(dev)
        # the K9-forward share of a micro-step, from the kernel times above:
        # 24 encoder-shaped and 56 decoder-shaped forwards per micro-step
        k9 = {r["shape"].split(" (")[0]: r["ms"] for r in rows if r["kernel"] == "K9"}
        k9_ms = 24 * k9["encoder"] + 56 * k9["decoder / prior"]
        long_stats["k9_fwd_share_est"] = k9_ms / long_stats["warm_ms_per_micro_step"]
        print(f"long: K9 forward {k9_ms:.3f} ms per micro-step, "
              f"{100 * long_stats['k9_fwd_share_est']:.1f}% of it", flush=True)
        # the backward's: 28 decoder-shaped backwards per micro-step (the
        # encoder is frozen)
        k9b = {r["shape"].split(" (")[0]: r["ms"] for r in rows if r["kernel"] == "K9 bwd"}
        long_stats["k9_bwd_ms_est"] = 28 * k9b["decoder / prior"]
        print(f"long: K9 backward {long_stats['k9_bwd_ms_est']:.3f} ms per micro-step",
              flush=True)
    except Exception:
        traceback.print_exc()
        return fail(phase, "exception (traceback above)")
    bad_mods = [m for m in sys.modules if m.split(".")[0] in ("jax", "align3r_tpu")]
    if bad_mods:
        return fail("imports", f"jax or the JAX package was imported: {bad_mods[:5]}")

    src = "align3r_tpu_torch/csrc/"
    meta = {
        "K1": ("attention_site", src + "fused_site.cu", "align3r_tpu/ops/fused_site.py:78"),
        "K2": ("mlp_site", src + "fused_site.cu", "align3r_tpu/ops/fused_site.py:242"),
        "K3": ("edge_loss_fwd", src + "edge_loss.cu", "align3r_tpu/ops/edge_loss.py:172"),
        "K4": ("edge_loss_bwd", src + "edge_loss.cu", "align3r_tpu/ops/edge_loss.py:207"),
        "K3 scenes": ("edge_loss_fwd", src + "edge_loss.cu",
                      "align3r_tpu/ops/edge_loss.py:172"),
        "K4 scenes": ("edge_loss_bwd", src + "edge_loss.cu",
                      "align3r_tpu/ops/edge_loss.py:207"),
        "K5": ("permute_packed", src + "permute_packed.cu", "align3r_tpu/ops/edge_loss.py:417"),
        "K6": ("small_attention", src + "small_attention.cu",
               "align3r_tpu/ops/small_attention.py:47"),
        "K1/K2 LN": ("_ln_cuda", src + "fused_site.cu", "align3r_tpu/ops/fused_site.py:78"),
        "K7": ("fused_res_unit", src + "dpt_pipeline.cu",
               "align3r_tpu/ops/dpt_pipeline.py:101"),
        "K7 fp32": ("fused_res_unit_fp32", src + "dpt_pipeline.cu",
                    "align3r_tpu/ops/dpt_pipeline.py:101"),
        "K8": ("fused_head_final", src + "dpt_pipeline.cu",
               "align3r_tpu/ops/dpt_pipeline.py:319"),
        "K8 fp32": ("fused_head_final_fp32", src + "dpt_pipeline.cu",
                    "align3r_tpu/ops/dpt_pipeline.py:319"),
        "K9": ("flash_attention", src + "flash_attention.cu",
               "align3r_tpu/ops/attention.py:44"),
        "K9 bwd": ("flash_attention_bwd", src + "flash_attention.cu",
                   "align3r_tpu/ops/attention.py:44"),
        "K9 fp32": ("flash_attention", src + "flash_attention.cu",
                    "align3r_tpu/ops/attention.py:44"),
        "K6 fp32": ("small_attention", src + "small_attention.cu",
                    "align3r_tpu/ops/small_attention.py:47"),
    }
    # the path(s) each kernel's launches were counted on
    paths = {"K5": {"flow": flow_launches},
             "K3 scenes": {"batch": batch_launches}, "K4 scenes": {"batch": batch_launches},
             "K6": {"train": train_launches, "data": data_launches},
             "K7": {"heads": heads_launches}, "K7 fp32": {"heads": heads_launches},
             "K8": {"heads": heads_launches}, "K8 fp32": {"heads": heads_launches},
             "K9": {"long": long_launches}, "K9 bwd": {"long": long_launches},
             "K9 fp32": {"prior": prior_launches, "sam2": sam2_launches},
             "K6 fp32": {"sam2": sam2_launches}}
    kernels = []
    for k, (fn, source, replaces) in meta.items():
        # the headline row is the first of its path's rows (K9 fp32: the
        # priors', which came first; SAM2's shape follows among the checks)
        mine = sorted((r for r in rows if r["kernel"] == k),
                      key=lambda r: k == "K9 fp32" and "SAM2" in r["shape"])
        by_path = {name: counts[fn] for name, counts in paths.get(k, {"main": launches}).items()}
        kernels.append({"name": f"{k} {fn}", "route": "cuda", "source": source,
                        "replaces": replaces, "launches": sum(by_path.values()),
                        "launches_on": by_path,
                        "max_abs_err": max(r["max_abs_err"] for r in mine),
                        "ms": mine[0]["ms"], "plain_ms": mine[0]["plain_ms"],
                        "bound_ms": mine[0]["bound_ms"], "bound_by": mine[0]["bound_by"],
                        "library_ms": mine[0].get("library_ms"),
                        "shape": mine[0]["shape"],
                        "checks": [{k2: r.get(k2) for k2 in (
                            "shape", "ms", "ms_eager", "ms_graph", "ms_unsorted", "plain_ms",
                            "library_ms", "library_ms_eager", "ms_over_library", "k6_ms",
                            "same_bits",
                            "ms_over_k6", "bits_of_k6", "bound_over_ms", "products_run",
                            "products_bound", "xla_chain_ms", "xla_chain_ms_eager", "split_ms",
                            "bound_ms", "bound_by",
                            "max_abs_err", "tiles", "rounds", "tflops",
                            "own_launch_rel_err", "own_launch_bits")}
                                   for r in mine]})
    print(card, flush=True)
    print(json.dumps({"kernels": kernels, "main_path": rates, "flow_path": flow_stats,
                      "sam2_path": sam2_stats,
                      "train_path": train_stats, "data_path": data_stats,
                      "heads_path": heads_stats,
                      "demo_path": demo_stats, "prior_path": prior_stats,
                      "long_path": long_stats, "batch_path": batch_stats,
                      "ddp_path": ddp_stats}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--dp-engine-rank"]:
        sys.exit(dp_engine_rank())
    sys.exit(main())
