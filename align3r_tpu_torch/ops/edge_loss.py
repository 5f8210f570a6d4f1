"""Fused edge-residual loss of the global-alignment solve: kernels K3
(forward) and K4 (backward), and K5, the row permute that builds their
packed observations, each beside its plain PyTorch version (port of
align3r_tpu/ops/edge_loss.py).

    loss = sum_e sum_a w[e, a] * safe_norm(proj[idx[e], :, a] - M[e] @ [pred[e, :, a]; 1])

K3 ``edge_loss_fwd`` replaces the Pallas ``_fwd_kernel`` /
``_fwd_kernel_chunked`` (edge_loss.py:172-204, called through ``_fwd_call``
:303-324); K4 ``edge_loss_bwd`` replaces ``_bwd_kernel`` /
``_bwd_kernel_chunked`` / ``_bwd_body`` (:207-268, ``_bwd_call`` :327-357).
``EdgeLoss`` is the ``torch.autograd.Function`` that ties them together:
gradients flow to ``proj`` and the folded (e2, 3, 4) pose matrices; the
frozen observations get none. K5 ``permute_packed`` replaces the Pallas
``permute_packed`` (:360-439, inner ``kern`` :417).

Layout (csrc/edge_loss.cu says why): observations are packed once per solve
channel-major, pred (e2, 3, A) and w (e2, A), bf16 or fp32; proj (n, 3, A)
fp32; idx (e2,) int32; and for the backward a CSR list of each image's terms
(``order`` (e2,), ``offsets`` (n + 1,)), built by :func:`term_csr`.

Dispatch: CPU tensors take the plain version; CUDA tensors launch the kernel
(counted on the wrapper's ``launches``) or raise. There is no fallback.
"""
from __future__ import annotations

import numpy as np
import torch

from align3r_tpu_torch.ops import _lib

EPS = 1e-12  # must match geometry.core.safe_norm


def fold_pose_adaptors(pw_poses_44, adaptors):
    """(E, 4, 4) Sim(3) + (E, 3) xyz adaptors -> (E, 3, 4) = [R diag(a) | t]."""
    R = pw_poses_44[:, :3, :3] * adaptors[:, None, :]
    return torch.cat([R, pw_poses_44[:, :3, 3:4]], dim=-1)


def term_csr(idx, n: int):
    """CSR of edge terms by image: order (e2,) term ids sorted by image
    (stable), offsets (n + 1,). Built on the host once per pack."""
    idx_np = np.asarray(idx.cpu() if torch.is_tensor(idx) else idx, np.int64)
    order = np.argsort(idx_np, kind="stable").astype(np.int32)
    offsets = np.zeros(n + 1, np.int32)
    np.cumsum(np.bincount(idx_np, minlength=n), out=offsets[1:])
    return torch.from_numpy(order), torch.from_numpy(offsets)


def _residual(proj, pw34, pred, idx):
    pv = proj.index_select(0, idx.long())                     # (e2, 3, A)
    pd = pred.float()
    al = torch.einsum("eck,eka->eca", pw34[:, :, :3], pd) + pw34[:, :, 3:]
    return pv - al, pd


def edge_loss_fwd_plain(proj, pw34, pred, w, idx):
    """Plain PyTorch version of K3 (fp32 arithmetic on the stored values)."""
    r, _ = _residual(proj, pw34, pred, idx)
    sq = (r * r).sum(dim=1)
    d = torch.where(sq > 0, torch.sqrt(torch.clamp(sq, min=EPS)),
                    torch.zeros_like(sq))
    return (w.float() * d).sum()


def edge_loss_bwd_plain(g, proj, pw34, pred, w, idx):
    """Plain PyTorch version of K4: (dproj (n, 3, A), dM (e2, 3, 4))."""
    r, pd = _residual(proj, pw34, pred, idx)
    sq = (r * r).sum(dim=1)
    scale = torch.where(sq > EPS, g * w.float() * torch.rsqrt(sq),
                        torch.zeros_like(sq))
    u = scale[:, None, :] * r                                   # (e2, 3, A)
    dproj = torch.zeros_like(proj).index_add_(0, idx.long(), u)
    dm = -torch.einsum("eca,eka->eck", u, pd)
    dt = -u.sum(dim=-1, keepdim=True)
    return dproj, torch.cat([dm, dt], dim=-1)


def _check_cuda(proj, pw34, pred, w, idx):
    if pred.dtype not in (torch.bfloat16, torch.float32) or w.dtype != pred.dtype:
        raise ValueError(f"K3/K4 store observations in bf16 or fp32; got "
                         f"pred {pred.dtype}, w {w.dtype}")
    for name, t, dt in (("proj", proj, torch.float32),
                        ("pw34", pw34, torch.float32),
                        ("idx", idx, torch.int32)):
        if t.dtype != dt or not t.is_cuda or not t.is_contiguous():
            raise ValueError(f"K3/K4: {name} must be contiguous {dt} on CUDA")
    e2, three, A = pred.shape
    if (three != 3 or proj.shape[1:] != (3, A) or w.shape != (e2, A)
            or pw34.shape != (e2, 3, 4) or idx.shape != (e2,)
            or not pred.is_contiguous() or not w.is_contiguous()):
        raise ValueError("K3/K4: inconsistent shapes or layout")


def edge_loss_fwd(proj, pw34, pred, w, idx):
    """K3: the scalar loss (fp32)."""
    if not proj.is_cuda:
        return edge_loss_fwd_plain(proj, pw34, pred, w, idx)
    _check_cuda(proj, pw34, pred, w, idx)
    lib = _lib.library()
    e2, _, A = pred.shape
    partials = torch.empty(lib.a3r_edge_tiles(A) * e2, dtype=torch.float32,
                           device=proj.device)
    out = torch.empty((), dtype=torch.float32, device=proj.device)
    _lib.check(lib.a3r_edge_fwd(proj.data_ptr(), pw34.data_ptr(),
                                pred.data_ptr(), w.data_ptr(), idx.data_ptr(),
                                partials.data_ptr(), out.data_ptr(), e2, A,
                                int(pred.dtype == torch.bfloat16),
                                _lib.stream()), "K3 edge_loss_fwd")
    edge_loss_fwd.launches += 1
    return out


edge_loss_fwd.launches = 0


def edge_loss_bwd(g, proj, pw34, pred, w, idx, order, offsets):
    """K4: (dproj (n, 3, A) fp32, dM (e2, 3, 4) fp32) for upstream g."""
    if not proj.is_cuda:
        return edge_loss_bwd_plain(g, proj, pw34, pred, w, idx)
    _check_cuda(proj, pw34, pred, w, idx)
    n = proj.shape[0]
    if (order.dtype != torch.int32 or offsets.dtype != torch.int32
            or not order.is_cuda or offsets.shape != (n + 1,)):
        raise ValueError("K4: order/offsets must be int32 CUDA CSR of n images")
    lib = _lib.library()
    e2, _, A = pred.shape
    tiles = lib.a3r_edge_tiles(A)
    g = g.reshape(1).float().contiguous()
    dproj = torch.empty_like(proj)
    partials = torch.empty(e2 * tiles * 12, dtype=torch.float32,
                           device=proj.device)
    dm = torch.empty((e2, 3, 4), dtype=torch.float32, device=proj.device)
    _lib.check(lib.a3r_edge_bwd(proj.data_ptr(), pw34.data_ptr(),
                                pred.data_ptr(), w.data_ptr(),
                                order.data_ptr(), offsets.data_ptr(),
                                g.data_ptr(), dproj.data_ptr(),
                                partials.data_ptr(), dm.data_ptr(), n, e2, A,
                                int(pred.dtype == torch.bfloat16),
                                _lib.stream()), "K4 edge_loss_bwd")
    edge_loss_bwd.launches += 1
    return dproj, dm


edge_loss_bwd.launches = 0


def permute_packed_plain(pred_i_p, pred_j_p, w_i_p, w_j_p, perm, valid):
    """Plain PyTorch version of K5: slot s takes term perm[s] of the flat
    [i-terms; j-terms] list (rows clamped to [0, E), as the TPU kernel's
    index maps clamp them), its weight multiplied by valid[s] in the
    storage type."""
    E = pred_i_p.shape[0]
    t = perm.long()
    from_i = t < E
    ri, rj = t.clamp(0, E - 1), (t - E).clamp(0, E - 1)
    pred = torch.where(from_i[:, None, None], pred_i_p.index_select(0, ri),
                       pred_j_p.index_select(0, rj))
    w = torch.where(from_i[:, None], w_i_p.index_select(0, ri),
                    w_j_p.index_select(0, rj))
    return pred, w * valid.to(w.dtype)[:, None]


def permute_packed(pred_i_p, pred_j_p, w_i_p, w_j_p, perm, valid):
    """K5: assemble the packed observations ((e2, 3, A), (e2, A)) from the
    naturally ordered per-edge packs pred_*_p (E, 3, A), w_*_p (E, A) by
    perm / valid (e2,) int32 (see csrc/permute_packed.cu)."""
    if not pred_i_p.is_cuda:
        return permute_packed_plain(pred_i_p, pred_j_p, w_i_p, w_j_p, perm, valid)
    srcs = (pred_i_p, pred_j_p, w_i_p, w_j_p)
    dt = pred_i_p.dtype
    if dt not in (torch.bfloat16, torch.float32) or any(t.dtype != dt for t in srcs):
        raise ValueError(f"K5 permutes bf16 or fp32 packs of one type; got "
                         f"{[t.dtype for t in srcs]}")
    E, three, A = pred_i_p.shape
    e2 = perm.shape[0]
    if (three != 3 or pred_j_p.shape != (E, 3, A) or w_i_p.shape != (E, A)
            or w_j_p.shape != (E, A) or valid.shape != (e2,)
            or perm.dtype != torch.int32 or valid.dtype != torch.int32
            or not all(t.is_cuda and t.is_contiguous() for t in srcs + (perm, valid))):
        raise ValueError("K5: needs contiguous CUDA (E, 3, A) / (E, A) packs and "
                         "int32 perm / valid of one length")
    pred = torch.empty((e2, 3, A), dtype=dt, device=pred_i_p.device)
    w = torch.empty((e2, A), dtype=dt, device=pred_i_p.device)
    isz = pred_i_p.element_size()
    vec = int((A * isz) % 16 == 0
              and all(t.data_ptr() % 16 == 0 for t in srcs + (pred, w)))
    lib = _lib.library()
    _lib.check(lib.a3r_permute_packed(*(t.data_ptr() for t in srcs), perm.data_ptr(),
                                      valid.data_ptr(), pred.data_ptr(), w.data_ptr(),
                                      E, e2, A, int(dt == torch.bfloat16), vec,
                                      _lib.stream()), "K5 permute_packed")
    permute_packed.launches += 1
    return pred, w


permute_packed.launches = 0


class EdgeLoss(torch.autograd.Function):
    """loss(proj, pw34) with frozen observations; K3 forward, K4 backward."""

    @staticmethod
    def forward(ctx, proj, pw34, pred, w, idx, order, offsets):
        proj = proj.contiguous()
        pw34 = pw34.contiguous()
        ctx.save_for_backward(proj, pw34, pred, w, idx, order, offsets)
        return edge_loss_fwd(proj, pw34, pred, w, idx)

    @staticmethod
    def backward(ctx, g):
        proj, pw34, pred, w, idx, order, offsets = ctx.saved_tensors
        dproj, dm = edge_loss_bwd(g, proj, pw34, pred, w, idx, order, offsets)
        return dproj, dm, None, None, None, None, None


def edge_loss(proj, pw34, pred, w, idx, order, offsets):
    """Differentiable fused edge loss (gradients to proj and pw34)."""
    return EdgeLoss.apply(proj, pw34, pred, w, idx, order, offsets)
