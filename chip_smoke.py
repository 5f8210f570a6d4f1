#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (align3r_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own line; any failure exits non-zero without the
final result line:
  1. device   - requires CUDA; prints `nvidia-smi` name and power limit.
  2. build    - compiles the port's CUDA kernels (align3r_tpu_torch/csrc)
                with nvcc into build/ and prints the seconds it took.
  3. kernels  - each kernel's wrapper against its plain PyTorch version on the
                card at the main path's shapes: max abs/rel error against a
                stated tolerance, and the time of each side (CUDA events).
  4. parity   - a small model, a small solve and the flow term (gate off) run
                on the card and on the CPU, from the same seeded weights and
                inputs; they must agree.
  5. main     - the port's entry point, align3r_tpu_torch.pipeline.
                reconstruct_scene, at ViT-L 512 width (VIT_L_512, seeded random
                weights) on 24 synthetic 512x288 frames: swinstride-5 graph
                (190 pairs), batch 32, 300-iteration flow-variant solve. The
                kernels' launch counters are zeroed right before the call and
                every kernel must have launched; outputs must be finite and of
                the expected shapes. A second, warm run gives pairs/s and it/s.
  6. flow     - the same entry point on the demo's flow path: SEA-RAFT
                spring-M at full width (seeded random weights) computes flows
                in both directions of every edge, the self-supervised motion
                masks come from PairViewer solves (numpy PnP on the host), and
                the solve adds the flow term (the demo's scene_kw, weight
                0.01). 12 of the 24 frames (70 pairs): the host PnP of the
                masks costs seconds per pair, and 24 frames would take most of
                the time limit. The counters are zeroed right before the call;
                K5 must launch twice (the bf16 pack and the fp32 repack), K3
                and K4 300 times; flows, masks (n, H, W) and outputs finite.
  7. train    - the fine-tuning path: K6 against its plain version at the
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
Then the card line as nvidia-smi prints it, one JSON line with the kernels
(time, plain time, bound, launches on their path, library-call time), and
last {"ok": true, "device": {...}}. The process fails if jax or the JAX
package (align3r_tpu) was imported.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
N_FRAMES, H, W = 24, 288, 512
FLOW_FRAMES = 12
BATCH = 32
TRAIN_PAIRS, TRAIN_BATCH, ACCUM, TRAIN_EPOCHS = 16, 2, 4, 2
# published H100 SXM peaks (dense): bf16 tensor cores, fp32 without them, HBM
PEAK_BF16, PEAK_FP32, HBM_BYTES_S = 989e12, 67e12, 3.35e12


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

def check_sites(dev, gen):
    """K1 and K2 against their plain versions at the main path's shapes.
    Tolerance: 2 bf16 ulps at the output's largest magnitude (1.6e-2 x
    max|plain|); the two sides round q, k, v, P and the output to bf16 at the
    same points but accumulate in a different order."""
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
        x = rnd(G, Bn, N, C)
        kv = rnd(G, Bn, N, C) if cross else x
        w = [rnd(G, C, C, scale=C ** -0.5) for _ in range(4)]
        b = [rnd(G, C, scale=0.1, dtype=torch.float32) for _ in range(4)]
        lnq = ln(G, C)
        lnkv = ln(G, C) if cross else "same"
        cos, sin = fs.site_tables(pos, C // Hh, 100.0, bf)
        kern = lambda: fs.attention_site(x, kv, *w, *b, pos, Hh, 100.0,
                                         ln_q=lnq, ln_kv=lnkv, residual=True)
        plain = lambda: fs.site_plain(x, kv, *w, *b, cos, sin, Hh, ln_q=lnq,
                                      ln_kv=lnkv, residual=True)
        out, ref = kern(), plain()
        torch.cuda.synchronize()
        err, rel, scale = max_err(out, ref)
        ok = err <= 1.6e-2 * scale and torch.isfinite(out.float()).all().item()
        ms, pms = cuda_time(kern, 10), cuda_time(plain, 3)
        act = G * Bn * N * C * 2
        nbytes = (act * (3 if cross else 2) + 4 * G * C * C * 2 + 4 * G * C * 4
                  + (2 if cross else 1) * 2 * G * C * 4 + 2 * N * (C // Hh) * 2)
        b_ms, b_by = bound(nbytes, 8 * G * Bn * N * C * C + 4 * G * Bn * N * N * C,
                           PEAK_BF16)
        rows.append(dict(kernel="K1", shape=f"{name} G={G} B={Bn} N={N} C={C} H={Hh}",
                         max_abs_err=err, max_rel_err=rel, tol=1.6e-2 * scale,
                         ok=ok, ms=ms, plain_ms=pms, bound_ms=b_ms, bound_by=b_by))
        del x, kv, w, out, ref
    for name, G, Bn, C in (("encoder mlp", 1, 16, 1024), ("decoder mlp", 2, 32, 768)):
        N = pos.shape[0]
        F = 4 * C
        x = rnd(G, Bn, N, C)
        w1, w2 = rnd(G, C, F, scale=C ** -0.5), rnd(G, F, C, scale=F ** -0.5)
        b1 = rnd(G, F, scale=0.1, dtype=torch.float32)
        b2 = rnd(G, C, scale=0.1, dtype=torch.float32)
        lnp = ln(G, C)
        kern = lambda: fs.mlp_site(x, w1, b1, w2, b2, ln=lnp, residual=True)
        plain = lambda: fs.mlp_plain(x, w1, b1, w2, b2, ln=lnp, residual=True)
        out, ref = kern(), plain()
        torch.cuda.synchronize()
        err, rel, scale = max_err(out, ref)
        ok = err <= 1.6e-2 * scale and torch.isfinite(out.float()).all().item()
        ms, pms = cuda_time(kern, 10), cuda_time(plain, 3)
        nbytes = (2 * G * Bn * N * C * 2 + 2 * G * C * F * 2 + G * (F + C) * 4
                  + 2 * G * C * 4)
        b_ms, b_by = bound(nbytes, 4 * G * Bn * N * C * F, PEAK_BF16)
        rows.append(dict(kernel="K2", shape=f"{name} G={G} B={Bn} N={N} C={C} F={F}",
                         max_abs_err=err, max_rel_err=rel, tol=1.6e-2 * scale,
                         ok=ok, ms=ms, plain_ms=pms, bound_ms=b_ms, bound_by=b_by))
        del x, w1, w2, out, ref
    return rows


def check_edge(dev, gen):
    """K3/K4 against their plain versions at 24 frames (e2 = 380 terms,
    A = 147,456), bf16 and fp32 storage. Tolerance: relative 1e-4 of the
    largest value (fp32 arithmetic on both sides, sums in another order).
    Timed with the terms sorted by image, as the pack lays them out (ms), and
    in the random order of the check (ms_unsorted)."""
    import torch
    from align3r_tpu_torch.ops import edge_loss as el
    n, e2, A = N_FRAMES, 380, H * W
    rows = []
    for dt in (torch.bfloat16, torch.float32):
        proj = torch.randn(n, 3, A, generator=gen, device=dev)
        pred = torch.randn(e2, 3, A, generator=gen, device=dev).to(dt)
        w = (torch.rand(e2, A, generator=gen, device=dev) / (e2 * A)).to(dt)
        idx = torch.randint(0, n, (e2,), generator=gen, device=dev, dtype=torch.int32)
        pw34 = (torch.eye(3, 4, device=dev)[None]
                + 0.1 * torch.randn(e2, 3, 4, generator=gen, device=dev)).contiguous()
        order, offsets = (t.to(dev) for t in el.term_csr(idx, n))
        g = torch.tensor(1.5, device=dev)
        kf = lambda: el.edge_loss_fwd(proj, pw34, pred, w, idx)
        pf = lambda: el.edge_loss_fwd_plain(proj, pw34, pred, w, idx)
        kb = lambda: el.edge_loss_bwd(g, proj, pw34, pred, w, idx, order, offsets)
        pb = lambda: el.edge_loss_bwd_plain(g, proj, pw34, pred, w, idx)
        lk, lp = kf(), pf()
        (dpk, dmk), (dpp, dmp) = kb(), pb()
        torch.cuda.synchronize()
        tag = "bf16" if dt == torch.bfloat16 else "fp32"
        ef = max_err(lk, lp)
        # bytes: proj, the 3x4 matrices, pred, w, idx; about 30 fp32
        # operations per (term, pixel): transform, residual, norm, weight
        isz = 2 if dt == torch.bfloat16 else 4
        fwd_bytes = n * 3 * A * 4 + e2 * 48 + e2 * 3 * A * isz + e2 * A * isz + e2 * 4
        b_ms, b_by = bound(fwd_bytes + 4, 30 * e2 * A, PEAK_FP32)
        idx_s = torch.sort(idx).values
        order_s, offsets_s = (t.to(dev) for t in el.term_csr(idx_s, n))
        kf_s = lambda: el.edge_loss_fwd(proj, pw34, pred, w, idx_s)
        kb_s = lambda: el.edge_loss_bwd(g, proj, pw34, pred, w, idx_s, order_s, offsets_s)
        rows.append(dict(kernel="K3", shape=f"{tag} e2={e2} A={A} n={n}",
                         max_abs_err=ef[0], max_rel_err=ef[1], tol=1e-4 * ef[2],
                         ok=ef[0] <= 1e-4 * ef[2], ms=cuda_time(kf_s, 20),
                         ms_unsorted=cuda_time(kf, 20),
                         plain_ms=cuda_time(pf, 3), bound_ms=b_ms, bound_by=b_by))
        e1, e2m = max_err(dpk, dpp), max_err(dmk, dmp)
        # the forward's reads, plus dproj and dM written; about twice its work
        b_ms, b_by = bound(fwd_bytes + n * 3 * A * 4 + e2 * 48, 60 * e2 * A, PEAK_FP32)
        rows.append(dict(kernel="K4", shape=f"{tag} e2={e2} A={A} n={n}",
                         bound_ms=b_ms, bound_by=b_by,
                         max_abs_err=max(e1[0], e2m[0]),
                         max_rel_err=max(e1[1], e2m[1]),
                         tol=f"1e-4 x max (dproj {1e-4 * e1[2]:.3g}, dM {1e-4 * e2m[2]:.3g})",
                         ok=e1[0] <= 1e-4 * e1[2] and e2m[0] <= 1e-4 * e2m[2],
                         ms=cuda_time(kb_s, 20), ms_unsorted=cuda_time(kb, 20),
                         plain_ms=cuda_time(pb, 3)))
        del proj, pred, w, dpk, dpp
    return rows


def check_k5(dev, gen):
    """K5 against its plain version at 24 frames (E = 190 edges, e2 = 380
    slots, A = 147,456), bf16 and fp32: the image-sorted perm of the
    swinstride-5 graph with every 19th slot made a dummy (perm 0, valid 0).
    Tolerance: bit-identical. Beside it, torch.index_select of the same rows
    of the stacked [i; j] packs (pred and w), the library call the port
    never makes."""
    import numpy as np
    import torch
    from align3r_tpu_torch.inference.pairs import make_pairs
    from align3r_tpu_torch.ops import edge_loss as el
    pairs = make_pairs(N_FRAMES, "swinstride-5-noncyclic", symmetrize=True)
    E, A = len(pairs), H * W
    idx = np.array([p[0] for p in pairs] + [p[1] for p in pairs])
    perm = np.argsort(idx, kind="stable").astype(np.int32)
    valid = np.ones(2 * E, np.int32)
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
        rows.append(dict(kernel="K5", shape=f"{'bf16' if dt == torch.bfloat16 else 'fp32'} "
                         f"E={E} e2={2 * E} A={A}, {int((valid == 0).sum())} dummy slots",
                         max_abs_err=err, max_rel_err=0.0 if ok else None, tol=0.0, ok=ok,
                         ms=cuda_time(kern, 20), plain_ms=cuda_time(plain, 5),
                         library_ms=cuda_time(lib, 20), bound_ms=b_ms, bound_by=b_by))
        del pi, pj, wi, wj, pk, wk, pp, wp, p_cat, w_cat
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
    from align3r_tpu_torch.models.align3r import Align3R, init_align3r_
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
                el.permute_packed)
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
    return launches, rates, pm, imgs, priors


# ----------------------------------------------------------------- phase 6

def flow_path(dev, pm, imgs, priors):
    """The demo's flow path (see the module docstring) on FLOW_FRAMES frames."""
    import numpy as np
    import torch
    from align3r_tpu_torch.alignment.flow import flow_term
    from align3r_tpu_torch.models.raft import RAFT2, SPRING_M, init_raft_
    from align3r_tpu_torch.ops import edge_loss as el
    from align3r_tpu_torch.ops import fused_site as fs
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
              raft_params=raft, use_self_mask=True, niter=300, schedule="linear",
              lr=0.01, scene_kw=scene_kw)
    counters = (fs.attention_site, fs.mlp_site, el.edge_loss_fwd, el.edge_loss_bwd,
                el.permute_packed)
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    res = reconstruct_scene(imgs, priors, pm, **kw)
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    t = res.timings
    E = res.cfg.n_edges
    print(f"flow: {n} frames, {E} pairs, timings {json.dumps(t)} launches "
          f"{json.dumps(launches)}", flush=True)
    masks = res.dynamic_masks
    checks = {
        "k5_2_per_solve": launches["permute_packed"] == 2,
        "k3_k4_300": launches["edge_loss_fwd"] == 300 and launches["edge_loss_bwd"] == 300,
        "k1_k2_launched": launches["attention_site"] > 0 and launches["mlp_site"] > 0,
        "timings": {"raft_s", "masks_s", "solve_s"} <= set(t),
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
    in bf16 as for K1; 1e-4 x max in fp32 (fp32 arithmetic on both sides,
    sums over 576 keys in another order)."""
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
        b_ms, b_by = bound(4 * B_ * H_ * N_ * D_ * isz, 4 * B_ * H_ * N_ * N_ * D_,
                           PEAK_BF16 if dt == torch.bfloat16 else PEAK_FP32)
        rows.append(dict(kernel="K6", shape=f"{name} {tuple(shape)} "
                         f"{'bf16' if dt == torch.bfloat16 else 'fp32'}",
                         max_abs_err=err, max_rel_err=rel, tol=tol,
                         ok=err <= tol and torch.isfinite(out.float()).all().item(),
                         ms=cuda_time(kern, 20), plain_ms=cuda_time(plain, 5),
                         library_ms=cuda_time(lib, 20), bound_ms=b_ms, bound_by=b_by))
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
    """An in-memory two-view training set at 288x512: per pair a smooth
    synthetic depth for each view, cam2world poses a small motion apart,
    world points from the depth through a 500 px pinhole, images in [-1, 1],
    and the prior pointcloud from a perturbed depth (pixel_to_pointcloud).
    The dataset object the port's get_data_loader takes."""

    resolutions = [(W, H)]

    def __init__(self, n, seed=0):
        import numpy as np
        import torch
        from align3r_tpu_torch.geometry.core import pixel_to_pointcloud
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


def train_path(dev):
    """The fine-tuning driver at ViT-L width (see the module docstring)."""
    import math
    import torch
    from align3r_tpu_torch.models.align3r import Align3R, init_align3r_
    from align3r_tpu_torch.models.config import Align3RConfig
    from align3r_tpu_torch.ops import edge_loss as el
    from align3r_tpu_torch.ops import fused_site as fs
    from align3r_tpu_torch.ops import small_attention as sa
    from align3r_tpu_torch.training.step import is_trainable
    from align3r_tpu_torch.training.train import (TrainArgs, export_torch_checkpoint,
                                                  train)

    t0 = time.perf_counter()
    cfg = Align3RConfig(img_size=(H, W))     # VIT_L_512 at the 288x512 recipe size
    ds = SyntheticPairs(TRAIN_PAIRS)
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
        print(f"train: data + start checkpoint in {time.perf_counter() - t0:.1f} s",
              flush=True)

        args = TrainArgs(model="Align3RConfig(img_size=(288, 512))", pretrained=pretrained,
                         train_dataset=ds, batch_size=TRAIN_BATCH, accum_iter=ACCUM,
                         epochs=TRAIN_EPOCHS, warmup_epochs=0, num_workers=2,
                         output_dir=out, save_freq=TRAIN_EPOCHS, keep_freq=10 ** 6,
                         print_freq=4, remat="full", cast_frozen=True, head_bf16=False,
                         device=str(dev))
        counters = (fs.attention_site, fs.mlp_site, el.edge_loss_fwd,
                    el.edge_loss_bwd, sa.small_attention)
        torch.cuda.reset_peak_memory_stats()
        for c in counters:
            c.launches = 0
        t1 = time.perf_counter()
        res = train(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches = {c.__name__: c.launches for c in counters}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        steps = len(res.history)
        print(f"train: {steps} micro-steps, {res.optimizer.count} applied updates in "
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
    losses = [h["loss"] for h in res.history]
    checks = {
        "losses_finite": len(losses) == TRAIN_EPOCHS * TRAIN_PAIRS // TRAIN_BATCH
        and all(math.isfinite(x) for x in losses),
        "k6_80_per_micro_step": launches["small_attention"] == 80 * steps,
        "trainable_moved": all(moved[g] > 0 for g in total),
        "frozen_bit_identical": not frozen_bad,
        "final_pth_reloads_strict": reload_ok,
        "applied_updates": res.optimizer.count == steps // ACCUM >= 2,
    }
    warm = res.log[-1]
    ms_step = warm["train_s"] / warm["steps"] * 1e3
    stats = {"micro_steps": steps, "applied_updates": res.optimizer.count,
             "loss_first": losses[0], "loss_last": losses[-1],
             "warm_ms_per_micro_step": ms_step,
             "train_pairs_per_s": TRAIN_BATCH / ms_step * 1e3,
             "peak_mem_gb": peak, "k6_launches_per_micro_step": launches["small_attention"] / steps,
             "moved_tensors": moved, "trainable_tensors": total,
             "frozen_changed": frozen_bad[:5]}
    print(f"train: checks {json.dumps(checks)}", flush=True)
    print(f"train: stats {json.dumps(stats)}", flush=True)
    if not all(checks.values()):
        raise AssertionError(f"train path checks failed: {checks}")
    return launches, stats


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

        phase = "kernels"
        gen = torch.Generator(device=dev).manual_seed(0)
        rows = check_sites(dev, gen) + check_edge(dev, gen) + check_k5(dev, gen)
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
        launches, rates, pm, imgs, priors = main_path(dev)
        torch.cuda.empty_cache()

        phase = "flow"
        flow_launches, flow_stats = flow_path(dev, pm, imgs, priors)
        del pm
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
        "K5": ("permute_packed", src + "permute_packed.cu", "align3r_tpu/ops/edge_loss.py:417"),
        "K6": ("small_attention", src + "small_attention.cu",
               "align3r_tpu/ops/small_attention.py:47"),
    }
    kernels = []
    for k, (fn, source, replaces) in meta.items():
        mine = [r for r in rows if r["kernel"] == k]
        path = {"K5": flow_launches, "K6": train_launches}.get(k, launches)
        kernels.append({"name": f"{k} {fn}", "route": "cuda", "source": source,
                        "replaces": replaces, "launches": path[fn],
                        "max_abs_err": max(r["max_abs_err"] for r in mine),
                        "ms": mine[0]["ms"], "plain_ms": mine[0]["plain_ms"],
                        "bound_ms": mine[0]["bound_ms"], "bound_by": mine[0]["bound_by"],
                        "library_ms": mine[0].get("library_ms"),
                        "shape": mine[0]["shape"],
                        "checks": [{k2: r.get(k2) for k2 in (
                            "shape", "ms", "ms_unsorted", "plain_ms", "library_ms",
                            "bound_ms", "bound_by", "max_abs_err")} for r in mine]})
    print(card, flush=True)
    print(json.dumps({"kernels": kernels, "main_path": rates, "flow_path": flow_stats,
                      "train_path": train_stats}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
