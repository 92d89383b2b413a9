"""The box/disc obstacle pass of ``check_collisions`` as a CUDA kernel.

Counterpart of ``commonroad_rp_tpu/ops/pallas_kernels.py``
(``_collision_kernel``, launched by ``obb_collision_pallas``): the collision
mask [K] of ego OBBs, given as step-major center poses [T, K] already
shifted ``wb_rear_axle`` ahead of the rear axle, against the M rows of the
box/disc obstacle group at every step where a row is valid.  Box rows take
the four-axis separating-axis test, disc rows (``radius > 0``) the exact
closest-point test, as ``ops.collision.check_collisions`` does
(``commonroad_rp_tpu/ops/collision.py:639-671``).

``obb_collision`` launches the kernel of ``csrc/collision.cu`` (float32 or
float64 instance, built with nvcc on first use, bound through ctypes) for
tensors on the card and raises if it cannot; for tensors on the CPU it runs
the plain PyTorch version ``obb_collision_reference``.
``obb_collision.launches`` counts kernel launches only.
"""

from __future__ import annotations

import ctypes
from typing import TYPE_CHECKING

import torch

from commonroad_rp_tpu_torch.ops import cuda_build

if TYPE_CHECKING:
    from commonroad_rp_tpu_torch.ops.collision import ObstacleArrays

KERNEL_SOURCE = cuda_build.CSRC_DIR / "collision.cu"


def obb_collision_reference(cx: torch.Tensor, cy: torch.Tensor,
                            theta: torch.Tensor, obstacles: ObstacleArrays,
                            half_length, half_width) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same arguments and output as
    :func:`obb_collision`), on whatever device the inputs are: dense
    [T, M, K] separating-axis tests, op for op the JAX package's obstacle
    pass."""
    K = cx.shape[1]
    if obstacles.pose.shape[0] == 0:
        return torch.zeros(K, dtype=torch.bool, device=cx.device)
    e_cos = torch.cos(theta)[:, None, :]                     # [T, 1, K]
    e_sin = torch.sin(theta)[:, None, :]
    ex = cx[:, None, :]
    ey = cy[:, None, :]
    ehl, ehw = half_length, half_width

    ox = obstacles.pose[..., 0].T[:, :, None]                # [T, M, 1]
    oy = obstacles.pose[..., 1].T[:, :, None]
    otheta = obstacles.pose[..., 2].T[:, :, None]
    ohl = obstacles.half_ext[:, 0][None, :, None]
    ohw = obstacles.half_ext[:, 1][None, :, None]

    o_cos = torch.cos(otheta)
    o_sin = torch.sin(otheta)
    dx = ox - ex                                             # [T, M, K]
    dy = oy - ey
    rel_cos = torch.abs(e_cos * o_cos + e_sin * o_sin)
    rel_sin = torch.abs(o_sin * e_cos - o_cos * e_sin)

    lx = torch.abs(dx * e_cos + dy * e_sin)
    ly = torch.abs(-dx * e_sin + dy * e_cos)
    sep = lx > ehl + ohl * rel_cos + ohw * rel_sin
    sep = sep | (ly > ehw + ohl * rel_sin + ohw * rel_cos)
    sep = sep | (torch.abs(dx * o_cos + dy * o_sin) >
                 ohl + ehl * rel_cos + ehw * rel_sin)
    sep = sep | (torch.abs(-dx * o_sin + dy * o_cos) >
                 ohw + ehl * rel_sin + ehw * rel_cos)
    hit = ~sep
    if obstacles.radius is not None:
        # exact disc rows (closest-point test in the ego frame)
        r = obstacles.radius[None, :, None]                  # [1, M, 1]
        qx = torch.clamp(lx - ehl, min=0.0)
        qy = torch.clamp(ly - ehw, min=0.0)
        disc_hit = qx * qx + qy * qy <= r * r
        hit = torch.where(r > 0, disc_hit, hit)
    hit = hit & obstacles.valid.T[:, :, None]
    return torch.any(hit.reshape(-1, K), dim=0)


def _bind(lib: ctypes.CDLL):
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, scalar in (("crp_obb_collision_f32", ctypes.c_float),
                         ("crp_obb_collision_f64", ctypes.c_double)):
        fn = getattr(lib, name)
        fn.argtypes = [p, p, p, p, p, p, p, scalar, scalar, i, i, i, p, p]
        fn.restype = ctypes.c_int


def _check_operands(cx, cy, theta, obstacles):
    dtype, device = cx.dtype, cx.device
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"obb_collision: dtype {dtype}; the kernel takes "
                         "float32 or float64")
    T, K = cx.shape
    M = obstacles.pose.shape[0]
    expect = [("cx", cx, (T, K)), ("cy", cy, (T, K)),
              ("theta", theta, (T, K)), ("pose", obstacles.pose, (M, T, 3)),
              ("half_ext", obstacles.half_ext, (M, 2))]
    if obstacles.radius is not None:
        expect.append(("radius", obstacles.radius, (M,)))
    for name, t, shape in expect:
        if t.dtype != dtype or t.device != device or \
                tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"obb_collision: {name} must be a contiguous "
                             f"{dtype} tensor of shape {shape} on {device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    valid = obstacles.valid
    if valid.dtype != torch.bool or valid.device != device or \
            tuple(valid.shape) != (M, T) or not valid.is_contiguous():
        raise ValueError(f"obb_collision: valid must be a contiguous bool "
                         f"tensor of shape {(M, T)} on {device}")


def _launch(cx, cy, theta, obstacles, half_length, half_width):
    _check_operands(cx, cy, theta, obstacles)
    T, K = cx.shape
    M = obstacles.pose.shape[0]
    out = torch.empty(K, dtype=torch.uint8, device=cx.device)
    lib = cuda_build.load(KERNEL_SOURCE, _bind)
    fn = lib.crp_obb_collision_f32 if cx.dtype == torch.float32 \
        else lib.crp_obb_collision_f64
    radius = obstacles.radius
    stream = torch.cuda.current_stream(cx.device).cuda_stream
    rc = fn(cx.data_ptr(), cy.data_ptr(), theta.data_ptr(),
            obstacles.pose.data_ptr(), obstacles.half_ext.data_ptr(),
            obstacles.valid.data_ptr(),
            None if radius is None else radius.data_ptr(),
            float(half_length), float(half_width), K, T, M, out.data_ptr(),
            stream)
    if rc != 0:
        raise RuntimeError(f"collision kernel launch failed: CUDA error {rc}")
    obb_collision.launches += 1
    return out.to(torch.bool)


def obb_collision(cx: torch.Tensor, cy: torch.Tensor, theta: torch.Tensor,
                  obstacles: ObstacleArrays, half_length,
                  half_width) -> torch.Tensor:
    """Collision mask [K] (bool) of ego OBBs against the box/disc group.

    ``cx``/``cy``/``theta`` [T, K]: ego OBB centers (already shifted
    ``wb_rear_axle`` ahead of the rear axle) and headings, contiguous, in
    the obstacle tables' dtype (float32 or float64); ``obstacles``: pose
    [M, T, 3], half extents [M, 2], valid [M, T] (bool), optional disc radii
    [M] (the polygon group is not read); ``half_length``/``half_width``: the
    ego half extents (host scalars).  With M = 0 nothing is launched.

    CUDA inputs launch the kernel (``obb_collision.launches`` counts the
    launches) and raise if it cannot be built or launched; CPU inputs run
    :func:`obb_collision_reference`.
    """
    device = cx.device
    if device.type == "cpu":
        return obb_collision_reference(cx, cy, theta, obstacles,
                                       half_length, half_width)
    if device.type != "cuda":
        raise ValueError(f"obb_collision: unsupported device {device}")
    if obstacles.pose.shape[0] == 0:
        return torch.zeros(cx.shape[1], dtype=torch.bool, device=device)
    return _launch(cx, cy, theta, obstacles, half_length, half_width)


obb_collision.launches = 0
