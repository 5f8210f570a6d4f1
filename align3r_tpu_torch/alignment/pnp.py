"""RANSAC-PnP batched over problems, focals and hypotheses, on the device of
its inputs: the computation that cv2.solvePnPRansac(..., iterationsCount=
niter, reprojectionError=5, flags=SOLVEPNP_SQPNP) performs for the JAX
package (align3r_tpu/alignment/init_poses.py:64-91), in torch, fp64.

OpenCV's steps, each reproduced here:
- Every call seeds cv::RNG with -1, a multiply-with-carry generator. A
  hypothesis draws 5 distinct indices into the masked points, each
  `next() % count`, redrawing an index already in the sample
  (`ransac_subsets`). The points are float32 in this stage.
- The minimal solver is EPnP on those 5 points (`epnp`): Lepetit et al.'s
  control points from a PCA that follows OpenCV's Jacobi SVD (its
  eigenvector signs change the result), the 12x12 null space, three
  approximations of the betas each refined by 5 Gauss-Newton steps, and the
  pose with the least mean reprojection error.
- A point is an inlier when its squared reprojection error, in float32, is
  at most 25 (5 px). The iteration count falls as the best count rises
  (confidence 0.99), and the first hypothesis with the most inliers wins.
- The pose is SQPnP (Terzakis and Lourakis, ECCV 2020, as OpenCV's
  sqpnp.cpp implements it; `sqpnp`) on that hypothesis's inliers.
- With 5 points, the pose is EPnP on all of them; with 4, P3P; with fewer,
  none. Each is counted as that many inliers.

The result equals cv2's to rounding wherever both reach the same best
hypothesis. EPnP on exactly 5 points has a 2-dimensional null space whose
basis OpenCV's SVD sets from rounding, so a few hypotheses differ from
cv2's by more than rounding, and a different best hypothesis then moves
the pose as far as another RANSAC draw does.

Two guards of the port's own, per problem and focal. A focal of at most
THRESHOLD px gives no pose: the 5 px tolerance is then 45 degrees or more
wide at the principal point and the image spans nearly 180 degrees, so the
pixels no longer pin the pose down (Weiszfeld's focal sits at its 1e-4
clamp on the pointmaps of random weights; there cv2 returns a pose that its
rounding sets, which nothing else reproduces). And a pose whose translation
exceeds MAX_T_OVER_EXTENT times the points' extent (their largest
coordinate) is no pose at that focal: SQPnP's pose is the only candidate,
with no fallback to the RANSAC hypothesis.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

MIN_PNP_POINTS = 4          # cv2's minimum for a pose
MODEL_POINTS = 5            # cv2's RANSAC kernel: EPnP on 5 points
CONFIDENCE = 0.99           # cv2.solvePnPRansac's default
SCRATCH_BYTES = 2 << 30     # bound on one scoring or reduction chunk
MAX_T_OVER_EXTENT = 1e6     # the guard on a pose's translation (see above)
THRESHOLD = 5.0             # reprojectionError of the JAX package's cv2 call, px
_F64 = torch.float64
_DBL_EPS = float(np.finfo(np.float64).eps)
_DBL_MIN = float(np.finfo(np.float64).tiny)

# OpenCV sqpnp.cpp's constants
_RANK_TOLERANCE = 1e-7
_SQP_SQUARED_TOLERANCE = 1e-10
_SQP_DET_THRESHOLD = 1.001
_ORTHOGONALITY_SQUARED_ERROR_THRESHOLD = 1e-8
_EQUAL_VECTORS_SQUARED_DIFF = 1e-10
_EQUAL_SQUARED_ERRORS_DIFF = 1e-6
_POINT_VARIANCE_THRESHOLD = 1e-5
_SQP_MAX_ITERATION = 15


# ------------------------------------------------------------ cv::RNG(-1)

def cv_rng_stream(n: int) -> np.ndarray:
    """The first n outputs of cv::RNG((uint64)-1): state = (state & 0xffffffff)
    * 4164903690 + (state >> 32), output the low 32 bits."""
    out = np.empty(n, np.uint64)
    s = 0xFFFFFFFFFFFFFFFF
    for k in range(n):
        s = (s & 0xFFFFFFFF) * 4164903690 + (s >> 32)
        out[k] = s & 0xFFFFFFFF
    return out


def ransac_subsets(counts: Sequence[int], niter: int) -> np.ndarray:
    """(B, niter, 5) indices into each problem's masked points, as cv2's
    RANSAC draws them for a problem of counts[b] points (each > 5): 5
    distinct `next() % count` per hypothesis from one stream that starts
    anew for every problem."""
    counts = np.asarray(counts, np.uint64).reshape(-1)
    B = len(counts)
    out = np.zeros((B, niter, MODEL_POINTS), np.int64)
    stream = cv_rng_stream(2 * MODEL_POINTS * niter + 64)
    ptr = np.zeros(B, np.int64)
    for h in range(niter):
        for i in range(MODEL_POINTS):
            todo = np.ones(B, bool)
            while todo.any():
                if ptr.max() >= len(stream):
                    stream = cv_rng_stream(2 * len(stream))
                cand = (stream[ptr] % counts).astype(np.int64)
                dup = todo & (out[:, h, :i] == cand[:, None]).any(1)
                take = todo & ~dup
                out[take, h, i] = cand[take]
                ptr += todo
                todo = dup
    return out


# ------------------------------------------------------------------ EPnP

def _jacobi_svd3(A):
    """OpenCV's one-sided Jacobi SVD (JacobiSVDImpl_, which cv::SVD takes for
    matrices under 25 rows) of (P, 3, 3) matrices: singular values in
    descending order, the left and the right singular vectors as rows, with
    OpenCV's signs and, for a near-singular A, its choice of basis."""
    At = A.transpose(-1, -2).clone()        # rows are A's columns
    V = torch.eye(3, dtype=A.dtype, device=A.device).expand_as(A).clone()
    W = (At * At).sum(-1)
    eps = 10 * _DBL_EPS
    for _ in range(12):                     # 3x3 converges in a few sweeps
        for i, j in ((0, 1), (0, 2), (1, 2)):
            a, b = W[:, i], W[:, j]
            p = (At[:, i] * At[:, j]).sum(-1)
            go = p.abs() > eps * torch.sqrt(a * b)
            p2 = 2 * p
            beta = a - b
            gamma = torch.hypot(p2, beta)
            s_neg = torch.sqrt((gamma - beta) * 0.5 / gamma)
            c_pos = torch.sqrt((gamma + beta) / (gamma * 2))
            c = torch.where(beta < 0, p2 / (gamma * s_neg * 2), c_pos)
            s = torch.where(beta < 0, s_neg, p2 / (gamma * c_pos * 2))
            c = torch.where(go, c, torch.ones_like(c))[:, None]
            s = torch.where(go, s, torch.zeros_like(s))[:, None]
            ai, aj, vi, vj = At[:, i], At[:, j], V[:, i], V[:, j]
            At[:, i], At[:, j] = c * ai + s * aj, -s * ai + c * aj
            V[:, i], V[:, j] = c * vi + s * vj, -s * vi + c * vj
            W[:, i] = torch.where(go, (At[:, i] * At[:, i]).sum(-1), W[:, i])
            W[:, j] = torch.where(go, (At[:, j] * At[:, j]).sum(-1), W[:, j])
    w = torch.sqrt((At * At).sum(-1))
    order = torch.argsort(-w, dim=-1, stable=True)
    w = torch.gather(w, 1, order)
    rows = order[..., None].expand(-1, -1, 3)
    return w, torch.gather(At, 1, rows) / w[..., None], torch.gather(V, 1, rows)


_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


def _finite(x):
    """x with non-finite entries zeroed, so that a decomposition of a
    degenerate sample gives garbage instead of raising; callers mark such
    samples invalid."""
    return torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)


def _canonical_plane(v):
    """A basis of the plane spanned by each pair of rows v (P, 2, 12) that
    depends on the plane alone: the projections of two fixed vectors, made
    orthonormal. With 5 points M^T M has an exact 2-dimensional null space,
    whose basis an eigensolver sets from rounding, and EPnP's result depends
    on it; this makes the CPU's and the card's agree. (OpenCV's is its own
    Jacobi sweeps' rounding, which no other solver reproduces.)"""
    k = torch.arange(12, dtype=v.dtype, device=v.device)
    w = torch.stack([torch.cos(1.3 * k + 0.2), torch.sin(0.7 * k + 1.1)])       # (2, 12)
    proj = torch.einsum("pij,kj->pki", v, w) @ v                                 # (P, 2, 12)
    a = proj[:, 0] / torch.linalg.vector_norm(proj[:, 0], dim=-1, keepdim=True)
    b = proj[:, 1] - (proj[:, 1] * a).sum(-1, keepdim=True) * a
    return torch.stack([a, b / torch.linalg.vector_norm(b, dim=-1, keepdim=True)], 1)


def epnp(pw, us, f, c):
    """Batched EPnP as OpenCV's epnp.cpp computes it. pw (P, n, 3) world
    points, us (P, n, 2) pixels, f (P,) focal, c (P, 2) principal point, all
    fp64. Returns world-to-camera R (P, 3, 3) and t (P, 3)."""
    P, n, _ = pw.shape
    c0 = pw.mean(1)
    P0 = pw - c0[:, None]
    dc, uct, _ = _jacobi_svd3(P0.transpose(1, 2) @ P0)
    cws = torch.cat([c0[:, None], c0[:, None] + torch.sqrt(dc / n)[..., None] * uct], 1)
    CC = (cws[:, 1:] - c0[:, None]).transpose(1, 2)             # columns c_j - c_0
    a123 = torch.linalg.solve_ex(_finite(CC), P0.transpose(1, 2))[0].transpose(1, 2)
    ok = torch.isfinite(a123).flatten(1).all(1) & torch.isfinite(us).flatten(1).all(1)
    alphas = torch.cat([1 - a123.sum(-1, keepdim=True), a123], -1)     # (P, n, 4)
    fu, uc, vc = f[:, None, None], c[:, 0, None, None], c[:, 1, None, None]
    M = torch.zeros((P, n, 2, 4, 3), dtype=_F64, device=pw.device)
    M[:, :, 0, :, 0] = alphas * fu
    M[:, :, 0, :, 2] = alphas * (uc - us[..., 0:1])
    M[:, :, 1, :, 1] = alphas * fu
    M[:, :, 1, :, 2] = alphas * (vc - us[..., 1:2])
    M = M.reshape(P, 2 * n, 12)
    v = torch.linalg.eigh(_finite(M.transpose(1, 2) @ M))[1][..., :4].transpose(1, 2)  # v[0] smallest
    if n == MODEL_POINTS:
        v = torch.cat([_canonical_plane(v[:, :2]), v[:, 2:]], 1)
    v = v.reshape(P, 4, 4, 3)
    dv = torch.stack([v[:, :, a] - v[:, :, b] for a, b in _PAIRS], 2)          # (P, 4, 6, 3)
    d = lambda i, j: (dv[:, i] * dv[:, j]).sum(-1)
    L = torch.stack([d(0, 0), 2 * d(0, 1), d(1, 1), 2 * d(0, 2), 2 * d(1, 2), d(2, 2),
                     2 * d(0, 3), 2 * d(1, 3), 2 * d(2, 3), d(3, 3)], -1)      # (P, 6, 10)
    rho = torch.stack([((cws[:, a] - cws[:, b]) ** 2).sum(-1) for a, b in _PAIRS], -1)

    def solve(cols):
        return (torch.linalg.pinv(_finite(L[..., cols])) @ _finite(rho)[..., None])[..., 0]

    def two(bb):                            # find_betas_approx_2/3's first two
        neg = bb[:, 0] < 0
        b0 = torch.sqrt(bb[:, 0].abs())
        b1 = torch.where(neg, torch.where(bb[:, 2] < 0, torch.sqrt(-bb[:, 2]), 0.0),
                         torch.where(bb[:, 2] > 0, torch.sqrt(bb[:, 2].abs()), 0.0))
        return torch.where(bb[:, 1] < 0, -b0, b0), b1

    b4 = solve([0, 1, 3, 6])
    b0 = torch.sqrt(b4[:, 0].abs())
    sgn = torch.where(b4[:, 0] < 0, -1.0, 1.0).to(_F64)
    beta1 = torch.stack([b0, sgn * b4[:, 1] / b0, sgn * b4[:, 2] / b0, sgn * b4[:, 3] / b0], -1)
    x0, x1 = two(solve([0, 1, 2]))
    zero = torch.zeros_like(x0)
    beta2 = torch.stack([x0, x1, zero, zero], -1)
    b5 = solve([0, 1, 2, 3, 4])
    x0, x1 = two(b5)
    beta3 = torch.stack([x0, x1, b5[:, 3] / x0, zero], -1)
    betas = torch.stack([beta1, beta2, beta3], 1)                           # (P, 3, 4)

    Lb = L[:, None]                                                          # (P, 1, 6, 10)
    rhob = rho[:, None]
    for _ in range(5):                      # gauss_newton
        b = betas
        Aj = torch.stack([
            2 * Lb[..., 0] * b[..., 0:1] + Lb[..., 1] * b[..., 1:2] + Lb[..., 3] * b[..., 2:3] + Lb[..., 6] * b[..., 3:4],
            Lb[..., 1] * b[..., 0:1] + 2 * Lb[..., 2] * b[..., 1:2] + Lb[..., 4] * b[..., 2:3] + Lb[..., 7] * b[..., 3:4],
            Lb[..., 3] * b[..., 0:1] + Lb[..., 4] * b[..., 1:2] + 2 * Lb[..., 5] * b[..., 2:3] + Lb[..., 8] * b[..., 3:4],
            Lb[..., 6] * b[..., 0:1] + Lb[..., 7] * b[..., 1:2] + Lb[..., 8] * b[..., 2:3] + 2 * Lb[..., 9] * b[..., 3:4],
        ], -1)                                                               # (P, 3, 6, 4)
        prod = torch.stack([b[..., 0] * b[..., 0], b[..., 0] * b[..., 1], b[..., 1] * b[..., 1],
                            b[..., 0] * b[..., 2], b[..., 1] * b[..., 2], b[..., 2] * b[..., 2],
                            b[..., 0] * b[..., 3], b[..., 1] * b[..., 3], b[..., 2] * b[..., 3],
                            b[..., 3] * b[..., 3]], -1)                      # (P, 3, 10)
        r = rhob - (Lb @ prod[..., None])[..., 0]
        betas = betas + (torch.linalg.pinv(_finite(Aj)) @ _finite(r)[..., None])[..., 0]

    # compute_R_and_t for the three
    ccs = torch.einsum("pki,pijl->pkjl", betas, v)                           # (P, 3, 4, 3)
    pcs = torch.einsum("pnj,pkjl->pknl", alphas, ccs)                        # (P, 3, n, 3)
    pcs = torch.where(pcs[:, :, :1, 2:3] < 0, -pcs, pcs)                     # solve_for_sign
    pc0 = pcs.mean(2)
    pw0 = pw.mean(1)
    ABt = (pcs - pc0[:, :, None]).transpose(-1, -2) @ (pw - pw0[:, None])[:, None]
    U, _, Vh = torch.linalg.svd(_finite(ABt))
    R = U @ Vh
    flip = torch.tensor([1.0, 1.0, -1.0], dtype=_F64, device=pw.device)[:, None]
    R = torch.where((torch.linalg.det(R) < 0)[..., None, None], R * flip, R)
    t = pc0 - (R @ pw0[:, None, :, None])[..., 0]
    cam = torch.einsum("pkij,pnj->pkni", R, pw) + t[:, :, None]
    inv_z = 1.0 / cam[..., 2]
    ue = c[:, 0, None, None] + f[:, None, None] * cam[..., 0] * inv_z
    ve = c[:, 1, None, None] + f[:, None, None] * cam[..., 1] * inv_z
    err = torch.sqrt((us[:, None, :, 0] - ue) ** 2 + (us[:, None, :, 1] - ve) ** 2).sum(-1) / n
    err = torch.nan_to_num(err, nan=float("inf"))
    N = torch.where(err[:, 1] < err[:, 0], 1, 0)
    N = torch.where(err[:, 2] < torch.gather(err, 1, N[:, None])[:, 0], 2, N)
    R = torch.gather(R, 1, N[:, None, None, None].expand(-1, 1, 3, 3))[:, 0]
    t = torch.gather(t, 1, N[:, None, None].expand(-1, 1, 3))[:, 0]
    ok = ok & torch.isfinite(err.min(1).values) & torch.isfinite(t).all(1)
    nan = torch.full_like(t[:, :1, None], float("nan"))
    return torch.where(ok[:, None, None], R, nan), torch.where(ok[:, None], t, nan[..., 0])


# ----------------------------------------------------------------- SQPnP

def _nearest_rotation_svd(e):
    """OpenCV's nearestRotationMatrixSVD: U diag(1, 1, det U det V^T) V^T from
    its Jacobi SVD of each (..., 9) row-major matrix."""
    shape = e.shape
    _, U, Vt = _jacobi_svd3(_finite(e.reshape(-1, 3, 3)))
    Uc = U.transpose(1, 2)
    d = torch.linalg.det(Uc) * torch.linalg.det(Vt)
    D = torch.stack([torch.ones_like(d), torch.ones_like(d), d], -1)
    return ((Uc * D[:, None, :]) @ Vt).reshape(shape)


def _det9(r):
    return torch.linalg.det(r.reshape(*r.shape[:-1], 3, 3))


def _foam(e):
    """OpenCV's nearestRotationMatrixFOAM of each (..., 9) row-major matrix:
    the outermost root l on det(e)'s side of FOAM's characteristic
    polynomial (l^2 - |e|^2)^2 - 8 l det(e) - 4 |adj(e)|^2, by Newton from
    sign(det) sqrt(3 |e|^2), a bound on every root; then R = ((l^2 + |e|^2) e
    + 2 (l adj(e)^T - e e^T e)) / (l (l^2 - |e|^2) - 2 det(e)). Where
    |det(e)| < 1e-4, the SVD's nearest rotation. For a near-singular e this
    differs from the SVD's, and SQPnP's starts are FOAM's."""
    e0, e1, e2, e3, e4, e5, e6, e7, e8 = e.unbind(-1)
    det = (e0 * e4 * e8 - e0 * e5 * e7 - e1 * e3 * e8 + e2 * e3 * e7
           + e1 * e6 * e5 - e2 * e6 * e4)
    adj = torch.stack([e4 * e8 - e5 * e7, e5 * e6 - e3 * e8, e3 * e7 - e4 * e6,
                       e2 * e7 - e1 * e8, e0 * e8 - e2 * e6, e1 * e6 - e0 * e7,
                       e1 * e5 - e2 * e4, e2 * e3 - e0 * e5, e0 * e4 - e1 * e3], -1)  # adj(e)^T
    e_sq, adj_sq = (e * e).sum(-1), (adj * adj).sum(-1)
    l = torch.where(det < 0, -1.0, 1.0).to(e.dtype) * torch.sqrt(3 * e_sq)
    lprev = torch.zeros_like(det)
    for _ in range(60):
        go = (l - lprev).abs() > 1e-12 * lprev.abs()
        tmp = l * l - e_sq
        step = (tmp * tmp - 8.0 * l * det - 4.0 * adj_sq) / (8.0 * (0.5 * tmp * l - det))
        lprev = torch.where(go, l, lprev)
        l = torch.where(go, l - step, l)
    E = e.reshape(*e.shape[:-1], 3, 3)
    tmp = (E @ E.transpose(-1, -2) @ E).reshape(e.shape)
    r = ((l * l + e_sq)[..., None] * e + 2.0 * (l[..., None] * adj - tmp)) \
        / (l * (l * l - e_sq) - 2.0 * det)[..., None]
    return torch.where((det.abs() < 1e-4)[..., None], _nearest_rotation_svd(e), r)


def _orthogonality_error(a):
    r1, r2, r3 = a[..., 0:3], a[..., 3:6], a[..., 6:9]
    n1, n2, n3 = (r1 * r1).sum(-1), (r2 * r2).sum(-1), (r3 * r3).sum(-1)
    d12, d13, d23 = (r1 * r2).sum(-1), (r1 * r3).sum(-1), (r2 * r3).sum(-1)
    return ((n1 - 1) ** 2 + (n2 - 1) ** 2 + (n3 - 1) ** 2
            + 2 * (d12 * d12 + d13 * d13 + d23 * d23))


def _sqp(omega, r):
    """OpenCV's runSQP from each start r (N, 9): Newton steps on min r^T Omega r
    over the 6 orthonormality constraints, each step the KKT solution of the
    linearised constraints, until a step's squared norm is at most 1e-10 or
    after 15 steps; then the sign with det > 0, and the nearest rotation if
    det exceeds 1.001."""
    N = r.shape[0]
    K = torch.zeros((N, 15, 15), dtype=_F64, device=r.device)
    K[:, :9, :9] = omega
    active = torch.ones(N, dtype=torch.bool, device=r.device)
    for _ in range(_SQP_MAX_ITERATION):
        r1, r2, r3 = r[:, 0:3], r[:, 3:6], r[:, 6:9]
        J = torch.zeros((N, 6, 9), dtype=_F64, device=r.device)
        J[:, 0, 0:3], J[:, 1, 3:6], J[:, 2, 6:9] = 2 * r1, 2 * r2, 2 * r3
        J[:, 3, 0:3], J[:, 3, 3:6] = r2, r1
        J[:, 4, 3:6], J[:, 4, 6:9] = r3, r2
        J[:, 5, 0:3], J[:, 5, 6:9] = r3, r1
        g = torch.stack([1 - (r1 * r1).sum(-1), 1 - (r2 * r2).sum(-1), 1 - (r3 * r3).sum(-1),
                         -(r1 * r2).sum(-1), -(r2 * r3).sum(-1), -(r1 * r3).sum(-1)], -1)
        K[:, 9:, :9] = J
        K[:, :9, 9:] = J.transpose(1, 2)
        rhs = torch.cat([-(omega @ r[..., None])[..., 0], g], -1)
        delta = torch.linalg.solve_ex(_finite(K), _finite(rhs))[0][:, :9]
        delta = torch.where(active[:, None], delta, torch.zeros_like(delta))
        r = r + delta
        active = active & ((delta * delta).sum(-1) > _SQP_SQUARED_TOLERANCE)
    det = _det9(r)
    r = torch.where((det < 0)[:, None], -r, r)
    return torch.where((det.abs() > _SQP_DET_THRESHOLD)[:, None], _foam(r), r)


def _chunks(B: int, per_problem_bytes: int):
    step = max(1, SCRATCH_BYTES // max(per_problem_bytes, 1))
    return [slice(b, min(B, b + step)) for b in range(0, B, step)]


def sqpnp(X, xn, w):
    """Batched SQPnP as OpenCV's sqpnp.cpp solves it (Terzakis and Lourakis,
    ECCV 2020). X (B, A, 3) object points, xn (B, A, 2) normalised image
    points, w (B, A) 0/1 weights selecting each problem's points; fp64.

    With Q_i = [[1, 0, -x], [0, 1, -y], [-x, -y, x^2 + y^2]] (the image-plane
    residual of a point scaled by its depth) and A_i the 3x9 map r -> R X_i,
    the three masked reductions sum(Q_i), sum(Q_i A_i) and sum(A_i^T Q_i A_i)
    give Omega (9x9), whose quadratic form in the row-major rotation r is the
    error once t = p r is eliminated. SQP runs from the nearest rotations of
    +-sqrt(3) times Omega's eigenvectors, the smallest first, as OpenCV
    chooses them; a solution counts if the points' mean, or most points, lie
    in front. Returns world-to-camera R (B, 3, 3), t (B, 3) and ok (B,)."""
    B, A, _ = X.shape
    dev = X.device
    S = torch.empty((B, 4, 13), dtype=_F64, device=dev)
    for sl in _chunks(B, A * 8 * 24):
        x, y = xn[sl, :, 0], xn[sl, :, 1]
        Y = torch.stack([torch.ones_like(x), x, y, x * x + y * y], -1) * w[sl, :, None]
        P = X[sl]
        Z = torch.cat([(P[..., :, None] * P[..., None, :]).flatten(-2), P,
                       torch.ones_like(P[..., :1])], -1)
        S[sl] = Y.transpose(1, 2) @ Z
    n, sx, sy, ssq = S[:, 0, 12], S[:, 1, 12], S[:, 2, 12], S[:, 3, 12]
    XX = S[:, :, :9].reshape(B, 4, 3, 3)
    sX = S[:, :, 9:12]
    z3, z33 = torch.zeros_like(sX[:, 0]), torch.zeros_like(XX[:, 0])
    omega = torch.cat([torch.cat([XX[:, 0], z33, -XX[:, 1]], -1),
                       torch.cat([z33, XX[:, 0], -XX[:, 2]], -1),
                       torch.cat([-XX[:, 1], -XX[:, 2], XX[:, 3]], -1)], -2)
    qa = torch.stack([torch.cat([sX[:, 0], z3, -sX[:, 1]], -1),
                      torch.cat([z3, sX[:, 0], -sX[:, 2]], -1),
                      torch.cat([-sX[:, 1], -sX[:, 2], sX[:, 3]], -1)], -2)
    zero = torch.zeros_like(n)
    q = torch.stack([torch.stack([n, zero, -sx], -1), torch.stack([zero, n, -sy], -1),
                     torch.stack([-sx, -sy, ssq], -1)], -2)
    p = -torch.linalg.solve_ex(_finite(q), _finite(qa))[0]                  # t = p r
    omega = omega + qa.transpose(1, 2) @ p
    variance = ssq / n - (sx * sx + sy * sy) / (n * n)
    ok = (n >= 3) & (variance >= _POINT_VARIANCE_THRESHOLD) & torch.isfinite(p).flatten(1).all(1)
    omega = _finite(omega)
    s, U = torch.linalg.eigh(omega)                                         # ascending
    s = s.abs()
    n_null = (s < _RANK_TOLERANCE).sum(-1)
    ok = ok & (s[:, -1] >= _RANK_TOLERANCE) & (n_null <= 6)
    n_eig = torch.clamp(n_null, min=1)
    mean = sX[:, 0] / n[:, None]

    # every start OpenCV may take: eigenvector k (k < 8, the smallest first),
    # as it is (if orthogonal) and SQP from FOAM's rotation of +-e. OpenCV
    # scales e by sqrt(3) in its first loop only, and FOAM's test for a
    # singular e is not scale-free, so the start follows the loop
    u = U[..., :8].transpose(1, 2)                                           # (B, 8, 9)
    e = u * math.sqrt(3.0)
    direct = _det9(e)[..., None] * e
    orth = _orthogonality_error(e) < _ORTHOGONALITY_SQUARED_ERROR_THRESHOLD
    first_k = torch.arange(8, device=dev) < n_eig[:, None]                   # (B, 8)
    starts = _foam(torch.stack([torch.where(first_k[..., None], e, u),
                                torch.where(first_k[..., None], -e, -u)], 2))  # (B, 8, 2, 9)
    sols = _sqp(omega.repeat_interleave(16, 0), starts.reshape(-1, 9)).reshape(B, 8, 2, 9)
    cand = torch.cat([direct[:, :, None], sols], 2)                         # (B, 8, 3, 9)
    t = torch.einsum("bij,bkcj->bkci", p, cand)
    err = torch.einsum("bkci,bij,bkcj->bkc", cand, omega, cand)
    front = (cand[..., 6:9] * mean[:, None, None]).sum(-1) + t[..., 2] > 0
    npos = torch.empty_like(err)
    for sl in _chunks(B, A * 8 * 24):
        z = torch.einsum("baj,bkcj->bkca", X[sl], cand[sl, ..., 6:9]) + t[sl, ..., 2:3]
        npos[sl] = ((z > 0).to(_F64) * w[sl, None, None]).sum(-1)
    front = front | (npos >= n[:, None, None] - npos)

    # OpenCV's order and choice: the first eigenvectors (n_eig of them, from
    # the n_eig-th smallest down), then further ones while the least error
    # exceeds 3x their eigenvalue; solutions_[0] is the least error, a later
    # one within 1e-6 of it replacing it only if it is the same rotation
    rows = torch.arange(B, device=dev)
    min_err = torch.full((B,), float("inf"), dtype=_F64, device=dev)
    best_r, best_t = torch.zeros((B, 9), dtype=_F64, device=dev), torch.zeros((B, 3), dtype=_F64, device=dev)
    best_err = min_err.clone()
    found = torch.zeros(B, dtype=torch.bool, device=dev)
    extra = torch.ones(B, dtype=torch.bool, device=dev)

    def check(k, c, act):
        nonlocal min_err, best_r, best_t, best_err, found
        r_c, t_c, e_c = cand[rows, k, c], t[rows, k, c], err[rows, k, c]
        act = act & front[rows, k, c] & torch.isfinite(e_c)
        big = (min_err - e_c).abs() > _EQUAL_SQUARED_ERRORS_DIFF
        lower = act & big & (e_c < min_err)
        near = (act & ~big & found & (best_err > e_c)
                & (((best_r - r_c) ** 2).sum(-1) < _EQUAL_VECTORS_SQUARED_DIFF))
        take = lower | near
        best_r = torch.where(take[:, None], r_c, best_r)
        best_t = torch.where(take[:, None], t_c, best_t)
        best_err = torch.where(take, e_c, best_err)
        found = found | lower
        min_err = torch.where(lower | (act & ~big), torch.minimum(min_err, e_c), min_err)

    for pos in range(8):
        first = pos < n_eig
        k = torch.where(first, n_eig - 1 - pos, torch.full_like(n_eig, pos))
        extra = extra & (first | (min_err > 3 * s[rows, k]))
        o = orth[rows, k]
        check(k, 0, first & o)
        check(k, 1, (first & ~o) | (~first & extra))
        check(k, 2, (first & ~o) | (~first & extra))
    ok = ok & found
    R = _nearest_rotation_svd(best_r).reshape(B, 3, 3)
    return R, best_t, ok


# ---------------------------------------------------------------- P3P (4)

def _kabsch(P, C):
    """The rotation and translation taking points P (m, 3) onto C (m, 3)."""
    pc, cc = P.mean(0), C.mean(0)
    U, _, Vt = np.linalg.svd((P - pc).T @ (C - cc))
    R = Vt.T @ np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))]) @ U.T
    return R, cc - R @ pc


def _p3p(X, xn):
    """World->camera poses [R | t] that put 3 points X (3, 3) on the rays
    of the normalised image points xn (3, 2): Grunert's system. With d2 =
    u d1, d3 = v d1 the distances along the unit rays j1..j3, the law of
    cosines over the sides a = |X2 - X3|, b = |X1 - X3|, c = |X1 - X2| gives
    two quadratics in u whose coefficients are polynomials in v; their
    resultant is a quartic in v (scaled so that b = 1), each positive real
    root gives u from their difference, then the camera-frame points and
    the rigid fit. Up to four poses."""
    from numpy.polynomial import polynomial as P
    j = np.concatenate([xn, np.ones((3, 1))], axis=1)
    j /= np.linalg.norm(j, axis=1, keepdims=True)
    b = np.linalg.norm(X[0] - X[2])
    if b < 1e-12:
        return []
    a, c = np.linalg.norm(X[1] - X[2]) / b, np.linalg.norm(X[0] - X[1]) / b
    ca, cb, cg = j[1] @ j[2], j[0] @ j[2], j[0] @ j[1]
    # b^2 u^2 + p1 u + p0 = 0 and b^2 u^2 + q1 u + q0 = 0 (b = 1)
    p1, p0 = np.array([0.0, -2 * ca]), np.array([-a * a, 2 * a * a * cb, 1 - a * a])
    q1, q0 = np.array([-2 * cg]), np.array([1 - c * c, 2 * c * c * cb, -c * c])
    res = P.polysub(P.polymul(P.polysub(q0, p0), P.polysub(q0, p0)),
                    P.polymul(P.polysub(q1, p1), P.polysub(P.polymul(p1, q0),
                                                          P.polymul(q1, p0))))
    poses = []
    for v in P.polyroots(res):
        if abs(v.imag) > 1e-6 * max(1.0, abs(v)) or v.real <= 0:
            continue
        v = v.real
        den = P.polyval(v, P.polysub(p1, q1))
        if abs(den) < 1e-12:
            continue
        u = (P.polyval(v, q0) - P.polyval(v, p0)) / den
        s2 = 1 + v * v - 2 * v * cb
        if u <= 0 or s2 <= 0:
            continue
        d1 = b / np.sqrt(s2)
        poses.append(_kabsch(X, np.array([d1, u * d1, v * d1])[:, None] * j))
    return poses


def _pose_from_4(X, xn):
    """World->camera [R | t] from 4 points: the P3P pose of the first three
    that puts all four nearest their image points, or None if none has every
    point in front."""
    best, best_err = None, np.inf
    for R, t in _p3p(X[:3], xn[:3]):
        cam = X @ R.T + t
        if (cam[:, 2] <= 1e-9).any():
            continue
        err = np.linalg.norm(cam[:, :2] / cam[:, 2:] - xn, axis=1).sum()
        if err < best_err:
            best, best_err = (R, t), err
    return best


# ---------------------------------------------------------------- RANSAC

def _inlier_masks(X, pix32, mask, R, t, f, c):
    """(g, h, A) inlier masks of hypotheses (R (g, h, 3, 3), t (g, h, 3),
    focal f (g, h)) over problems' points X (g, A, 3), as cv2 scores them:
    projectPoints in fp64 rounded to float32, the squared pixel distance in
    float32, at most THRESHOLD^2 rounded to float32."""
    cam = torch.einsum("gaj,ghij->ghai", X, R) + t[:, :, None]
    z = cam[..., 2]
    inv_z = torch.where(z != 0, 1.0 / z, torch.ones_like(z))
    fh = f[..., None]
    u = (fh * (cam[..., 0] * inv_z) + c[0]).float()
    v = (fh * (cam[..., 1] * inv_z) + c[1]).float()
    du, dv = pix32[..., 0] - u, pix32[..., 1] - v
    return ((du * du + dv * dv) <= float(np.float32(THRESHOLD ** 2))) & mask[:, None]


def _count_inliers(X, prob, pix32, masks, R, t, f, c):
    """(J, H) inlier counts of H hypotheses (R (J, H, 3, 3), t (J, H, 3)) per
    job j, which scores problem prob[j] at focal f[j], in chunks whose
    scratch stays under SCRATCH_BYTES."""
    J, H = R.shape[:2]
    A = X.shape[1]
    out = torch.empty((J, H), dtype=torch.int64, device=X.device)
    per_h = max(1, SCRATCH_BYTES // (A * 96))
    for j, p in enumerate(prob):
        for h in range(0, H, per_h):
            hs = slice(h, min(H, h + per_h))
            fj = f[j:j + 1, None].expand(1, hs.stop - hs.start)
            out[j, hs] = _inlier_masks(X[p:p + 1], pix32, masks[p:p + 1], R[j:j + 1, hs],
                                       t[j:j + 1, hs], fj, c)[0].sum(-1)
    return out


def _stop_rule(counts, n_points, niter):
    """cv2's adaptive RANSAC: hypotheses run in order while their index is
    below the current iteration budget, which each new best count k lowers
    to round(log(1 - 0.99) / log(1 - (k / n)^5)); the first hypothesis with
    the most inliers (more than 4) wins. counts (..., niter), n_points (...).
    Returns the winner's index and whether there is one."""
    good = torch.where(counts > MODEL_POINTS - 1, counts, torch.zeros_like(counts))
    best_so_far = torch.cummax(good, -1).values
    prev = torch.cat([torch.zeros_like(best_so_far[..., :1]), best_so_far[..., :-1]], -1)
    n = n_points[..., None].to(_F64)
    ep = (n - prev.to(_F64)) / n
    denom = 1.0 - (1.0 - ep) ** MODEL_POINTS
    num = math.log(max(1.0 - CONFIDENCE, _DBL_MIN))
    log_denom = torch.log(torch.clamp(denom, min=_DBL_MIN))
    budget = torch.where(log_denom < 0, torch.round(num / log_denom), torch.full_like(denom, niter))
    budget = torch.where(denom < _DBL_MIN, torch.zeros_like(budget), budget)
    budget = torch.where(prev > 0, torch.clamp(budget, max=niter), torch.full_like(budget, niter))
    idx = torch.arange(counts.shape[-1], device=counts.device)
    run = torch.cumprod((idx < budget).to(torch.int64), -1).bool()
    score = torch.where(run, good, torch.full_like(good, -1))
    best = torch.argmax(score, -1)
    return best, torch.gather(good, -1, best[..., None])[..., 0] > 0


def ransac_pnp(X, pixels, masks, focals, pp, niter: int
               ) -> List[Optional[Tuple[float, torch.Tensor]]]:
    """RANSAC-PnP of B problems at once, on X's device.

    X (B, A, 3) world points; pixels (A, 2) their pixel coordinates (shared);
    masks (B, A) which points each problem uses; focals, per problem, the
    focals to try (problems may try different numbers of them); pp the
    principal point (2,); niter the RANSAC budget. Every (problem, focal)
    pair is one job: the cv2-equivalent RANSAC, ending in SQPnP on the
    winning hypothesis's inliers. A problem takes the focal with the most
    inliers (the first on a tie). Returns, per problem, (focal, cam2world
    (4, 4) fp64 on X's device) or None. The sample draw and the result's read
    sync with the host; the rest stays on the device."""
    dev = X.device
    B, A, _ = X.shape
    X = X.float().to(_F64)                  # cv2 takes the points in float32
    masks = torch.as_tensor(masks, device=dev).reshape(B, A).bool()
    if torch.is_tensor(focals):
        focals = focals.detach().cpu().numpy()
    lists = [np.asarray(f.detach().cpu() if torch.is_tensor(f) else f, np.float64).reshape(-1)
             for f in focals]
    if len(lists) != B:
        raise ValueError(f"{len(lists)} focal lists for {B} problems")
    # the jobs, problem by problem; a focal of at most THRESHOLD px gives none
    jb = np.repeat(np.arange(B), [len(f) for f in lists])
    jf = np.concatenate(lists) if B else np.zeros(0)
    keep = np.flatnonzero(jf > THRESHOLD)
    jb, jf = jb[keep], jf[keep]
    J = len(jb)
    f32 = torch.as_tensor(jf.astype(np.float32).astype(np.float64), device=dev)       # (J,)
    c = torch.as_tensor(np.asarray(pp, np.float32).astype(np.float64).reshape(2), device=dev)
    pixels = torch.as_tensor(pixels, device=dev).reshape(A, 2)
    pix32 = pixels.float()
    pix64 = pixels.to(_F64)
    counts = masks.sum(-1).cpu().numpy()
    jcounts = counts[jb]
    extent = torch.where(masks[..., None], X.abs(), torch.zeros_like(X)).amax((1, 2))   # (B,)
    jbt = torch.as_tensor(jb, device=dev)

    R = torch.full((J, 3, 3), float("nan"), dtype=_F64, device=dev)
    t = torch.full((J, 3), float("nan"), dtype=_F64, device=dev)
    n_inl = torch.zeros(J, dtype=torch.int64, device=dev)
    ok = torch.zeros(J, dtype=torch.bool, device=dev)
    cs = torch.cumsum(masks.to(torch.int64), -1)

    def hyp_inputs(j, k):
        """World points and EPnP pixels of the k-th masked points of jobs j
        (idx k (len(j), S, 5)): EPnP's pixels are undistortPoints' float32
        normalised coordinates times f."""
        p = jbt[j]
        idx = torch.searchsorted(cs[p], k.reshape(len(j), -1) + 1)
        pw = X[p[:, None], idx].reshape(*k.shape, 3)
        fj = f32[j].reshape(-1, 1, 1, 1)
        xn = ((pix64[idx].reshape(*k.shape, 2) - c) * (1.0 / fj)).float().to(_F64)
        return pw, xn * fj + c              # (j, S, 5, 3), (j, S, 5, 2)

    # RANSAC jobs: more than 5 points
    rj = np.flatnonzero(jcounts > MODEL_POINTS)
    if len(rj):
        rjt = torch.as_tensor(rj, device=dev)
        nr, prob = len(rj), jb[rj]
        sub = torch.as_tensor(ransac_subsets(jcounts[rj], niter), device=dev)     # (r, niter, 5)
        pw, us = hyp_inputs(rjt, sub)
        fj = f32[rjt]
        P = nr * niter
        Rh, th = epnp(pw.reshape(P, MODEL_POINTS, 3), us.reshape(P, MODEL_POINTS, 2),
                      fj.repeat_interleave(niter), c.expand(P, 2))
        Rh, th = Rh.reshape(nr, niter, 3, 3), th.reshape(nr, niter, 3)
        cnt = _count_inliers(X, prob, pix32, masks, Rh, th, fj, c)
        win, found = _stop_rule(cnt, torch.as_tensor(jcounts[rj], device=dev), niter)
        rows = torch.arange(nr, device=dev)
        Rw, tw = Rh[rows, win], th[rows, win]
        # the winners' inliers, then SQPnP on them
        inl = torch.cat([_inlier_masks(X[p:p + 1], pix32, masks[p:p + 1], Rw[i:i + 1, None],
                                       tw[i:i + 1, None], fj[i:i + 1, None], c)[:, 0]
                         for i, p in enumerate(prob)], 0)                         # (r, A)
        xn = (pix64 - c) * (1.0 / fj[:, None, None])                              # (r, A, 2)
        Rs, ts, oks = sqpnp(X[jbt[rjt]], xn, inl.to(_F64))
        R[rjt], t[rjt], ok[rjt] = Rs, ts, oks & found
        n_inl[rjt] = inl.sum(-1)

    # 5 points: EPnP on all of them
    ej = np.flatnonzero(jcounts == MODEL_POINTS)
    if len(ej):
        ejt = torch.as_tensor(ej, device=dev)
        pw, us = hyp_inputs(ejt, torch.arange(MODEL_POINTS, device=dev).expand(len(ej), 1, -1))
        Re, te = epnp(pw[:, 0], us[:, 0], f32[ejt], c.expand(len(ej), 2))
        R[ejt], t[ejt] = Re, te
        ok[ejt] = torch.isfinite(te).all(-1)
        n_inl[ejt] = MODEL_POINTS

    # 4 points: P3P, on the host
    for j in np.flatnonzero(jcounts == MIN_PNP_POINTS):
        sel = masks[jb[j]].nonzero()[:, 0]
        pose = _pose_from_4(X[jb[j], sel].cpu().numpy(), ((pix64[sel] - c) / f32[j]).cpu().numpy())
        if pose is not None:
            R[j] = torch.as_tensor(pose[0], device=dev)
            t[j] = torch.as_tensor(pose[1], device=dev)
            ok[j] = True
            n_inl[j] = MIN_PNP_POINTS

    # the guard, then per problem the first job with the most inliers
    ok = ok & (t.abs().amax(-1) <= MAX_T_OVER_EXTENT * extent[jbt])
    score = torch.where(ok, n_inl, torch.full_like(n_inl, -1))
    top = torch.full((B,), -1, dtype=torch.int64, device=dev).scatter_reduce(0, jbt, score, "amax")
    jobs = torch.arange(J, device=dev)
    first = torch.where((score == top[jbt]) & (score > 0), jobs, torch.full_like(jobs, J))
    best = torch.full((B,), J, dtype=torch.int64, device=dev).scatter_reduce(0, jbt, first, "amin")
    pick = torch.clamp(best, max=max(J - 1, 0))
    c2w = torch.eye(4, dtype=_F64, device=dev).repeat(B, 1, 1)
    if J:
        Rk, tk = R[pick], t[pick]
        c2w[:, :3, :3] = Rk.transpose(1, 2)
        c2w[:, :3, 3] = -(Rk.transpose(1, 2) @ tk[..., None])[..., 0]
    best = best.cpu().numpy()
    return [(float(jf[best[b]]), c2w[b]) if best[b] < J else None for b in range(B)]
