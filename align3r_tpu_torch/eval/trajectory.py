"""Camera trajectory I/O and ATE/RPE metrics (port of
align3r_tpu/eval/trajectory.py, numpy and scipy).

Behavioural reference: the reference's dust3r/utils/vo_eval.py
(load_traj:124-148, load_sintel_traj:96-121, sintel_cam_read:17-37,
eval_metrics:185-268, save_trajectory_tum_format:308-316) and
cloud_opt_flow/base_opt.py (c2w_to_tumpose:29-44).

The APE/RPE pipeline is reimplemented without evo: Sim(3) Umeyama
alignment on positions, ATE = RMSE of translation residuals after
alignment, RPE = RMSE over consecutive-frame
relative-pose errors (translation norm / rotation angle in degrees) after
the same alignment — matching evo main_ape.ape / main_rpe.rpe with
align=True, correct_scale=True, delta=1 frame, all_pairs.

Trajectory array convention (reference 'TUM' layout): (N, 7) rows
[x, y, z, qw, qx, qy, qz] — note the wxyz quaternion order the reference
writes (vo_eval.py:308-316).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy.spatial.transform import Rotation


# ----------------------------------------------------------------- formats

def c2w_to_tumpose(c2w: np.ndarray) -> np.ndarray:
    """4x4 cam2world -> [x y z qw qx qy qz]."""
    c2w = np.asarray(c2w)
    xyz = c2w[:3, 3]
    qx, qy, qz, qw = Rotation.from_matrix(c2w[:3, :3]).as_quat()
    return np.concatenate([xyz, [qw, qx, qy, qz]])


def tumpose_to_c2w(pose: np.ndarray) -> np.ndarray:
    x, y, z, qw, qx, qy, qz = pose
    T = np.eye(4)
    T[:3, :3] = Rotation.from_quat([qx, qy, qz, qw]).as_matrix()
    T[:3, 3] = [x, y, z]
    return T


def poses_to_traj(poses: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(N, 4, 4) cam2world -> (tum (N,7), timestamps (N,))."""
    tum = np.stack([c2w_to_tumpose(p) for p in poses])
    return tum, np.arange(len(poses), dtype=np.float64)


def save_tum_trajectory(traj, path):
    """traj: (tum (N,7), timestamps (N,)). Reference format: ts x y z qw qx qy qz."""
    tum, ts = traj
    with open(path, "w") as f:
        for t, p in zip(np.asarray(ts).ravel(), tum):
            f.write(f"{t} " + " ".join(str(v) for v in p) + "\n")


def load_tum_trajectory(path):
    rows = []
    ts = []
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            vals = [float(x) for x in line.split()]
            ts.append(vals[0])
            rows.append(vals[1:8])
    return np.asarray(rows), np.asarray(ts)


def load_tum_gt(path):
    """TUM groundtruth.txt: ts x y z qx qy qz qw -> our wxyz layout."""
    rows, ts = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            v = [float(x) for x in line.split()]
            x, y, z, qx, qy, qz, qw = v[1:8]
            rows.append([x, y, z, qw, qx, qy, qz])
            ts.append(v[0])
    return np.asarray(rows), np.asarray(ts)


def sintel_cam_read(filename):
    """Sintel .cam: (K (3,3), world2cam extrinsic (3,4)) (vo_eval.py:17-37)."""
    TAG = 202021.25
    with open(filename, "rb") as f:
        check = np.fromfile(f, dtype=np.float32, count=1)[0]
        assert check == TAG, f"bad sintel cam tag {check}"
        M = np.fromfile(f, dtype="float64", count=9).reshape(3, 3)
        N = np.fromfile(f, dtype="float64", count=12).reshape(3, 4)
    return M, N


def load_sintel_traj(cam_dir):
    """Directory of .cam files -> (tum (N,7) mean-centred, ts) (vo_eval.py:96-121)."""
    import os
    files = sorted(os.path.join(cam_dir, x) for x in os.listdir(cam_dir)
                   if x.endswith(".cam"))
    ts = [float(os.path.basename(x)[:-4].split("_")[-1]) for x in files]
    rows = []
    for f in files:
        _, N = sintel_cam_read(f)
        w2c = np.eye(4)
        w2c[:3] = N
        c2w = np.linalg.inv(w2c)
        rows.append(c2w_to_tumpose(c2w))
    tum = np.stack(rows)
    tum[:, :3] -= tum[:, :3].mean(0, keepdims=True)
    return tum, np.asarray(ts)


def load_replica_traj(path):
    """Replica/ScanNet-style pose file: one row per frame, 12 or 16 floats of
    the row-major cam2world matrix (vo_eval.py:38-66 load_replica_traj; the
    scannet registry points pose_30.txt at this format, eval_metadata.py:44-55).
    Rows with non-finite entries (scannet emits '-inf' for untracked frames)
    keep their slot but reuse the previous valid pose."""
    raw = np.loadtxt(path)
    raw = raw.reshape(len(raw), -1) if raw.ndim > 1 else raw[None]
    assert raw.shape[1] in (12, 16), f"bad replica pose row width {raw.shape[1]}"
    rows, last = [], np.eye(4)
    for r in raw:
        T = np.eye(4)
        T[:3] = r[:12].reshape(3, 4)
        if not np.isfinite(T).all():
            T = last
        last = T
        rows.append(c2w_to_tumpose(T))
    return np.stack(rows), np.arange(len(rows), dtype=np.float64)


def load_kitti_traj(path):
    """KITTI odometry poses: 12 floats per row, world2cam convention is NOT
    used here — KITTI poses files are cam2world of the left camera, same
    matrix-row layout as replica."""
    return load_replica_traj(path)


def load_traj(gt_file, traj_format="sintel", skip=0, stride=1, num_frames=None):
    if traj_format == "sintel":
        tum, ts = load_sintel_traj(gt_file)
    elif traj_format in ("tum", "tartanair", "bonn"):
        tum, ts = load_tum_gt(gt_file)
    elif traj_format in ("replica", "scannet"):
        tum, ts = load_replica_traj(gt_file)
    elif traj_format == "kitti":
        tum, ts = load_kitti_traj(gt_file)
    else:
        raise NotImplementedError(traj_format)
    tum, ts = tum[skip::stride], ts[skip::stride]
    if num_frames is not None:
        tum, ts = tum[:num_frames], ts[:num_frames]
    return tum, ts


# ---------------------------------------------------------------- metrics

def _traj_to_mats(tum: np.ndarray) -> np.ndarray:
    return np.stack([tumpose_to_c2w(p) for p in tum])


def umeyama_alignment(src: np.ndarray, dst: np.ndarray, with_scale=True):
    """Sim(3) aligning src positions (N,3) onto dst. Returns (s, R, t)."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    sc, dc = src - mu_s, dst - mu_d
    cov = dc.T @ sc / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_s = (sc ** 2).sum() / len(src)
    s = float(np.trace(np.diag(D) @ S) / var_s) if with_scale else 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def align_trajectory(est_mats, ref_mats, with_scale=True):
    """Apply Umeyama sim3 to est poses: position+rotation transformed."""
    s, R, t = umeyama_alignment(est_mats[:, :3, 3], ref_mats[:, :3, 3], with_scale)
    out = est_mats.copy()
    out[:, :3, 3] = (s * (R @ est_mats[:, :3, 3].T)).T + t
    out[:, :3, :3] = R @ est_mats[:, :3, :3]
    return out


def ate_rmse(est_mats, ref_mats, with_scale=True) -> float:
    aligned = align_trajectory(est_mats, ref_mats, with_scale)
    err = aligned[:, :3, 3] - ref_mats[:, :3, 3]
    return float(np.sqrt((err ** 2).sum(-1).mean()))


def rpe_rmse(est_mats, ref_mats, delta: int = 1, with_scale=True):
    """(rpe_trans, rpe_rot_deg): RMSE over all (i, i+delta) pairs of the
    relative-pose error, trajectories sim3-aligned first (evo semantics)."""
    est = align_trajectory(est_mats, ref_mats, with_scale)
    t_errs, r_errs = [], []
    for i in range(len(est) - delta):
        dref = np.linalg.inv(ref_mats[i]) @ ref_mats[i + delta]
        dest = np.linalg.inv(est[i]) @ est[i + delta]
        E = np.linalg.inv(dref) @ dest
        t_errs.append(np.linalg.norm(E[:3, 3]))
        cos = np.clip((np.trace(E[:3, :3]) - 1) / 2, -1, 1)
        r_errs.append(np.degrees(np.arccos(cos)))
    return (float(np.sqrt(np.mean(np.square(t_errs)))),
            float(np.sqrt(np.mean(np.square(r_errs)))))


def eval_metrics(pred_traj, gt_traj=None, seq="", filename=None,
                 sample_stride: int = 1):
    """ATE / RPE-trans / RPE-rot for (tum, ts) trajectories
    (vo_eval.py:185-268). Returns (ate, rpe_trans, rpe_rot)."""
    pred_tum, pred_ts = pred_traj
    if sample_stride > 1:
        pred_tum, pred_ts = pred_tum[::sample_stride], pred_ts[::sample_stride]
        if gt_traj is not None:
            gt_traj = (gt_traj[0][::sample_stride], gt_traj[1][::sample_stride])
    if gt_traj is None:
        return 0.0, 0.0, 0.0
    gt_tum, gt_ts = gt_traj
    n = min(len(pred_tum), len(gt_tum))
    est = _traj_to_mats(pred_tum[:n])
    ref = _traj_to_mats(gt_tum[:n])
    ate = ate_rmse(est, ref)
    rpe_trans, rpe_rot = rpe_rmse(est, ref, delta=1)
    if filename:
        with open(filename, "w") as f:
            f.write(f"Seq: {seq}\n\n")
            f.write(f"APE w.r.t. translation part (m)\nrmse\t{ate}\n")
            f.write(f"RPE w.r.t. translation part (m)\nrmse\t{rpe_trans}\n")
            f.write(f"RPE w.r.t. rotation angle in degrees (deg)\nrmse\t{rpe_rot}\n")
    return ate, rpe_trans, rpe_rot


# --------------------------------------------- plotting + results scraping

def plot_trajectory(pred_traj, gt_traj=None, title="", filename="",
                    align=True, correct_scale=True):
    """2D trajectory plot (vo_eval.py:271-305).  Picks the plot plane by
    dropping the least-varying axis (best_plotmode) and Sim(3)/SE(3)-aligns
    the prediction to GT first."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    est = _traj_to_mats(pred_traj[0])
    ref = _traj_to_mats(gt_traj[0]) if gt_traj is not None else None
    if ref is not None and align:
        n = min(len(est), len(ref))
        est, ref = est[:n], ref[:n]
        est = align_trajectory(est, ref, with_scale=correct_scale)
    basis = ref if ref is not None else est
    drop = np.argmin(basis[:, :3, 3].std(axis=0))   # least-varying axis
    keep = [i for i in range(3) if i != drop]
    labels = "xyz"
    fig, ax = plt.subplots(figsize=(8, 8))
    ax.set_title(title)
    if ref is not None:
        ax.plot(ref[:, keep[0], 3], ref[:, keep[1], 3], "--", color="gray",
                label="Ground Truth")
    ax.plot(est[:, keep[0], 3], est[:, keep[1], 3], "-", color="blue",
            label="Predicted")
    ax.set_xlabel(labels[keep[0]])
    ax.set_ylabel(labels[keep[1]])
    ax.legend()
    ax.set_aspect("equal", adjustable="datalim")
    out = filename if str(filename).endswith(".png") else f"{filename}.png"
    fig.savefig(out, dpi=90)
    plt.close(fig)
    return out


def extract_metrics(file_path):
    """Scrape (ate, rpe_trans, rpe_rot) from an *_eval_metric.txt written by
    eval_metrics (vo_eval.py:319-334)."""
    import re
    with open(file_path) as f:
        content = f.read()
    def grab(pat):
        m = re.search(pat + r".*?rmse\s+([0-9.eE+-]+)", content, re.DOTALL)
        return float(m.group(1)) if m else 0.0
    return (grab(r"APE w\.r\.t\. translation part \(m\)"),
            grab(r"RPE w\.r\.t\. translation part \(m\)"),
            grab(r"RPE w\.r\.t\. rotation angle in degrees \(deg\)"))


def process_directory(directory):
    """Collect per-sequence metric files (vo_eval.py:336-349)."""
    import os
    results = []
    for root, _dirs, files in os.walk(directory):
        for file in sorted(files):
            if file.endswith("_metric.txt"):
                ate, rt, rr = extract_metrics(os.path.join(root, file))
                results.append((file.replace("_eval_metric.txt", ""),
                                ate, rt, rr))
    return results


def calculate_averages(results):
    """(avg_ate, avg_rpe_trans, avg_rpe_rot) over scraped per-sequence rows
    (vo_eval.py:352-361)."""
    if not results:
        return 0.0, 0.0, 0.0
    return tuple(float(np.mean([r[k] for r in results])) for k in (1, 2, 3))
