"""Batched Lie-group math on SO(3) (port of the parts of mc_slam_tpu/lie.py
that tracking reaches).

Rotations are (..., 3, 3) matrices. Every function broadcasts over leading
batch dims and follows the dtype and device of its input. The small-angle
branches are `torch.where` selects on safe inputs, exactly as the JAX package
writes them, so both sides take the same branch for the same input.
"""
from __future__ import annotations

import torch

_EPS = 1e-6  # small-angle switch (rad)


def _eye3(like):
    return torch.eye(3, dtype=like.dtype, device=like.device)


def hat(v):
    """so(3) hat operator: (..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    o = torch.zeros_like(x)
    return torch.stack([
        torch.stack([o, -z, y], dim=-1),
        torch.stack([z, o, -x], dim=-1),
        torch.stack([-y, x, o], dim=-1),
    ], dim=-2)


def _theta_sq(phi):
    return torch.sum(phi * phi, dim=-1)


def _taylor_coeffs(theta_sq):
    """(A, B, C) = (sin t/t, (1-cos t)/t^2, (t-sin t)/t^3) with Taylor fallbacks."""
    small = theta_sq < _EPS ** 2
    ts_safe = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    theta = torch.sqrt(ts_safe)
    st, ct = torch.sin(theta), torch.cos(theta)
    A = torch.where(small, 1.0 - theta_sq / 6.0 + theta_sq ** 2 / 120.0, st / theta)
    B = torch.where(small, 0.5 - theta_sq / 24.0 + theta_sq ** 2 / 720.0,
                    (1.0 - ct) / ts_safe)
    C = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0 + theta_sq ** 2 / 5040.0,
                    (theta - st) / (ts_safe * theta))
    return A, B, C


def so3_exp(phi):
    """Exponential map so(3) -> SO(3): (..., 3) -> (..., 3, 3), Rodrigues."""
    A, B, _ = _taylor_coeffs(_theta_sq(phi))
    W = hat(phi)
    return _eye3(phi) + A[..., None, None] * W + B[..., None, None] * (W @ W)


def so3_to_quat(R):
    """Rotation matrix -> unit quaternion (w, x, y, z), w >= 0 (branchless
    Shepperd: the largest pivot of four candidate extractions)."""
    r00, r01, r02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    r10, r11, r12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    r20, r21, r22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    t0 = 1.0 + r00 + r11 + r22
    t1 = 1.0 + r00 - r11 - r22
    t2 = 1.0 - r00 + r11 - r22
    t3 = 1.0 - r00 - r11 + r22
    q0 = torch.stack([t0, r21 - r12, r02 - r20, r10 - r01], dim=-1)
    q1 = torch.stack([r21 - r12, t1, r01 + r10, r02 + r20], dim=-1)
    q2 = torch.stack([r02 - r20, r01 + r10, t2, r12 + r21], dim=-1)
    q3 = torch.stack([r10 - r01, r02 + r20, r12 + r21, t3], dim=-1)
    ts = torch.stack([t0, t1, t2, t3], dim=-1)
    idx = torch.argmax(ts, dim=-1)             # first max, as jnp.argmax
    qs = torch.stack([q0, q1, q2, q3], dim=-2)  # (..., 4 candidates, 4)
    sel = idx[..., None, None].expand(*idx.shape, 1, 4)
    q = torch.gather(qs, -2, sel)[..., 0, :]
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-20)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def so3_log(R):
    """Logarithm map SO(3) -> so(3): (..., 3, 3) -> (..., 3), via quaternion."""
    q = so3_to_quat(R)
    w, v = q[..., 0], q[..., 1:]
    vn = torch.linalg.norm(v, dim=-1)
    theta = 2.0 * torch.atan2(vn, w)
    small = vn < _EPS
    vn_safe = torch.where(small, torch.ones_like(vn), vn)
    scale = torch.where(small, 2.0 / torch.clamp(w, min=0.5), theta / vn_safe)
    return scale[..., None] * v


def so3_jr(phi):
    """Right Jacobian of SO(3): Jr(phi) = I - B*hat + C*hat^2."""
    _, B, C = _taylor_coeffs(_theta_sq(phi))
    W = hat(phi)
    return _eye3(phi) - B[..., None, None] * W + C[..., None, None] * (W @ W)


def _jr_inv_coeff(ts):
    """k(t) = 1/t^2 - (1+cos t)/(2 t sin t), Taylor 1/12 + t^2/720 + t^4/30240."""
    small = ts < _EPS ** 2
    ts_safe = torch.where(small, torch.ones_like(ts), ts)
    t = torch.sqrt(ts_safe)
    st, ct = torch.sin(t), torch.cos(t)
    k_big = 1.0 / ts_safe - (1.0 + ct) / (2.0 * t * st)
    k_small = 1.0 / 12.0 + ts / 720.0 + ts * ts / 30240.0
    return torch.where(small, k_small, k_big)


def so3_jr_inv(phi):
    """Inverse right Jacobian: Jr^{-1}(phi) = I + hat/2 + k*hat^2."""
    k = _jr_inv_coeff(_theta_sq(phi))
    W = hat(phi)
    return _eye3(phi) + 0.5 * W + k[..., None, None] * (W @ W)


def so3_normalize_fast(R):
    """Cheap Gram-Schmidt re-orthonormalization (no SVD) for hot loops."""
    r0 = R[..., 0, :]
    r0 = r0 / torch.clamp(torch.linalg.norm(r0, dim=-1, keepdim=True), min=1e-12)
    r1 = R[..., 1, :]
    r1 = r1 - torch.sum(r0 * r1, dim=-1, keepdim=True) * r0
    r1 = r1 / torch.clamp(torch.linalg.norm(r1, dim=-1, keepdim=True), min=1e-12)
    r2 = torch.linalg.cross(r0, r1, dim=-1)
    return torch.stack([r0, r1, r2], dim=-2)

