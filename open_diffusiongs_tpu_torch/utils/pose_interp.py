"""Camera pose interpolation (quaternion slerp) for eval videos.

Equivalent of the nerfstudio-derived helpers the reference uses for its
camera-path mp4s (models/gsrenderer/cam_utils.py:105-139, 245-280):
slerp between consecutive poses with linear translation blending.

The port's own copy of open_diffusiongs_tpu/utils/pose_interp.py.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def rotmat_to_quat(R: np.ndarray) -> np.ndarray:
    """[3, 3] -> (w, x, y, z) unit quaternion."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        w = (R[2, 1] - R[1, 2]) / s
        x = 0.25 * s
        y = (R[0, 1] + R[1, 0]) / s
        z = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        w = (R[0, 2] - R[2, 0]) / s
        x = (R[0, 1] + R[1, 0]) / s
        y = 0.25 * s
        z = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        w = (R[1, 0] - R[0, 1]) / s
        x = (R[0, 2] + R[2, 0]) / s
        y = (R[1, 2] + R[2, 1]) / s
        z = 0.25 * s
    q = np.asarray([w, x, y, z])
    return q / np.linalg.norm(q)


def quat_to_rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q / np.linalg.norm(q)
    return np.asarray([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def quaternion_slerp(q0: np.ndarray, q1: np.ndarray, t: float) -> np.ndarray:
    """Spherical interpolation (cam_utils.py:105-139 semantics)."""
    d = float(np.dot(q0, q1))
    if d < 0:
        q1 = -q1
        d = -d
    if d > 0.9995:
        out = q0 + t * (q1 - q0)
        return out / np.linalg.norm(out)
    theta0 = np.arccos(np.clip(d, -1, 1))
    theta = theta0 * t
    s0 = np.cos(theta) - d * np.sin(theta) / np.sin(theta0)
    s1 = np.sin(theta) / np.sin(theta0)
    return s0 * q0 + s1 * q1


def interpolate_poses(pose_a: np.ndarray, pose_b: np.ndarray,
                      steps: int) -> List[np.ndarray]:
    """slerp rotation + lerp translation between two [4, 4] c2ws
    (`steps` poses, endpoint excluded — cam_utils.get_interpolated_poses)."""
    qa = rotmat_to_quat(pose_a[:3, :3])
    qb = rotmat_to_quat(pose_b[:3, :3])
    out = []
    for t in np.linspace(0.0, 1.0, steps, endpoint=False):
        c2w = np.eye(4, dtype=np.float64)
        c2w[:3, :3] = quat_to_rotmat(quaternion_slerp(qa, qb, float(t)))
        c2w[:3, 3] = pose_a[:3, 3] * (1 - t) + pose_b[:3, 3] * t
        out.append(c2w)
    return out


def get_interpolated_poses_many(poses: np.ndarray,
                                steps_per_transition: int = 10
                                ) -> np.ndarray:
    """[n, 4, 4] keyframes -> smooth path (cam_utils.py:245-280)."""
    out: List[np.ndarray] = []
    for i in range(len(poses) - 1):
        out.extend(interpolate_poses(poses[i], poses[i + 1],
                                     steps_per_transition))
    out.append(poses[-1].astype(np.float64))
    return np.stack(out).astype(np.float32)


def rotation_matrix_between(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Rotation taking unit vector a to unit vector b (cam_utils.py:449-478,
    Rodrigues form with the antiparallel special case)."""
    a = np.asarray(a, np.float64) / np.linalg.norm(a)
    b = np.asarray(b, np.float64) / np.linalg.norm(b)
    v = np.cross(a, b)
    c = float(np.dot(a, b))
    if np.linalg.norm(v) < 1e-12:
        if c > 0:
            return np.eye(3)
        # antiparallel: rotate pi around any axis orthogonal to a
        axis = np.cross(a, [1.0, 0.0, 0.0])
        if np.linalg.norm(axis) < 1e-6:
            axis = np.cross(a, [0.0, 1.0, 0.0])
        axis /= np.linalg.norm(axis)
        return 2.0 * np.outer(axis, axis) - np.eye(3)
    skew = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + skew + skew @ skew * (1.0 / (1.0 + c))


def focus_of_attention(poses: np.ndarray, initial: np.ndarray) -> np.ndarray:
    """Closest point to all camera optical axes, restricted iteratively to
    the cameras that look at it (cam_utils.py:481-513)."""
    poses = np.asarray(poses, np.float64)
    active_d = -poses[:, :3, 2:3]                      # [n, 3, 1] look dirs
    active_o = poses[:, :3, 3:4]
    focus = np.asarray(initial, np.float64)
    active = np.ones(len(poses), bool)
    done = False
    while active.sum() > 1 and not done:
        active_d = active_d[active]
        active_o = active_o[active]
        m = np.eye(3) - active_d * np.transpose(active_d, (0, 2, 1))
        mt_m = np.transpose(m, (0, 2, 1)) @ m
        focus = np.linalg.inv(mt_m.mean(0)) @ (mt_m @ active_o).mean(0)[:, 0]
        active = np.sum(active_d[..., 0] * (focus - active_o[..., 0]),
                        axis=-1) > 0
        done = bool(active.all())
    return focus


def auto_orient_and_center_poses(poses: np.ndarray, method: str = "up",
                                 center_method: str = "poses"
                                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Orient + center camera-to-world poses (nerfstudio convention;
    cam_utils.py:515-624).  method: 'pca' | 'up' | 'vertical' | 'none';
    center_method: 'poses' | 'focus' | 'none'.  Returns ([n, 3, 4] oriented
    poses, [3, 4] transform)."""
    poses = np.asarray(poses, np.float64)
    origins = poses[..., :3, 3]
    mean_origin = origins.mean(0)
    translation_diff = origins - mean_origin

    if center_method == "poses":
        translation = mean_origin
    elif center_method == "focus":
        translation = focus_of_attention(poses, mean_origin)
    elif center_method == "none":
        translation = np.zeros_like(mean_origin)
    else:
        raise ValueError(f"Unknown center_method: {center_method}")

    if method == "pca":
        _, eigvec = np.linalg.eigh(translation_diff.T @ translation_diff)
        eigvec = np.flip(eigvec, axis=-1).copy()
        if np.linalg.det(eigvec) < 0:
            eigvec[:, 2] = -eigvec[:, 2]
        transform = np.concatenate(
            [eigvec, eigvec @ -translation[..., None]], axis=-1)
        oriented = transform @ poses
        if oriented.mean(0)[2, 1] < 0:
            oriented[:, 1:3] = -oriented[:, 1:3]
    elif method in ("up", "vertical"):
        up = poses[:, :3, 1].mean(0)
        up = up / np.linalg.norm(up)
        if method == "vertical":
            # 3D direction that most projects vertically in all cameras:
            # total-least-squares via SVD of the stacked camera x-axes
            x_axes = poses[:, :3, 0]
            _, svals, vh = np.linalg.svd(x_axes, full_matrices=False)
            if svals[1] > 0.17 * np.sqrt(len(poses)):
                up_vertical = vh[2, :]
                up = up_vertical if np.dot(up_vertical, up) > 0 \
                    else -up_vertical
            else:  # degenerate (near-parallel cameras): project mean-up
                up = up - vh[0, :] * np.dot(up, vh[0, :])
                up = up / np.linalg.norm(up)
        rot = rotation_matrix_between(up, np.array([0.0, 0.0, 1.0]))
        transform = np.concatenate([rot, rot @ -translation[..., None]],
                                   axis=-1)
        oriented = transform @ poses
    elif method == "none":
        transform = np.eye(4)
        transform[:3, 3] = -translation
        transform = transform[:3, :]
        oriented = transform @ poses
    else:
        raise ValueError(f"Unknown method: {method}")
    return oriented.astype(np.float32), transform.astype(np.float32)
