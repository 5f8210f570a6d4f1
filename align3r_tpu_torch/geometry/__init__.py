from .core import (
    safe_norm,
    xy_grid,
    geotrf,
    inv,
    closed_form_pose_inverse,
    depthmap_to_pts3d,
    pixel_to_pointcloud,
    normalize_pointcloud,
)
from .poses import (
    signed_log1p,
    signed_expm1,
    quat_to_rotmat,
    rotmat_to_quat,
    pose_vec_to_matrix,
    matrix_to_pose_vec,
    sim3_vec_to_matrix,
    relative_pose_error,
    rigid_points_registration,
)

__all__ = [k for k in dir() if not k.startswith("_")]
