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
``obb_collision.launches`` counts the launches made through this Python
wrapper (eager, a warm-up or a capture); the replays of a captured graph
run the kernel without it and count nothing.  A block stages its
problem's rows in shared memory (``shared_bytes``); rows and steps past
``SHARED_BLOCK_LIMIT`` raise ``ValueError``.  Each call is one launch on the
current stream, writing the bool mask in place.

``obb_collision_fleet`` is the fleet form of the same pass (the XLA fleet
path's ``check_collisions``, ``jax.vmap`` of the single-problem pass at
``commonroad_rp_tpu/parallel/fleet.py:138-140``): F problems' poses
[F, T, K] against their rows [F, M, T] in one launch, with per-problem ego
extents [F]; plain version ``obb_collision_fleet_reference``, launch count
``obb_collision_fleet.launches``.
"""

from __future__ import annotations

import ctypes
from typing import TYPE_CHECKING

import torch

from commonroad_rp_tpu_torch.ops import cuda_build

if TYPE_CHECKING:
    from commonroad_rp_tpu_torch.ops.collision import ObstacleArrays

KERNEL_SOURCE = cuda_build.CSRC_DIR / "collision.cu"
# the kernel's bounding-circle skip (csrc/collision.cu, Skip): a pair further
# apart than SKIP_SCALE x (R_e + R_o) is not tested, and only where
# R_e + R_o >= SKIP_MIN_RADIUS
SKIP_SCALE = 1.0 + 2.0 ** -8
SKIP_MIN_RADIUS = 2.0 ** -20
# the most dynamic shared memory a collision block may ask for: sm_90 gives a
# block 227 KB, of which the step groups' hit flags (256 ints) are static
SHARED_BLOCK_LIMIT = (227 - 1) * 1024


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


def obb_collision_fleet_reference(cx: torch.Tensor, cy: torch.Tensor,
                                  theta: torch.Tensor,
                                  obstacles: ObstacleArrays, half_length,
                                  half_width) -> torch.Tensor:
    """Plain PyTorch version of the fleet kernel (same arguments and output
    as :func:`obb_collision_fleet`): :func:`obb_collision_reference` with a
    leading problem axis, dense [F, T, M, K] separating-axis tests."""
    F, _, K = cx.shape
    if obstacles.pose.shape[1] == 0:
        return torch.zeros((F, K), dtype=torch.bool, device=cx.device)
    per = lambda x: torch.as_tensor(x, dtype=cx.dtype, device=cx.device) \
        .reshape(-1, 1, 1, 1)                                # [F|1, 1, 1, 1]
    e_cos = torch.cos(theta)[:, :, None, :]                  # [F, T, 1, K]
    e_sin = torch.sin(theta)[:, :, None, :]
    ex = cx[:, :, None, :]
    ey = cy[:, :, None, :]
    ehl, ehw = per(half_length), per(half_width)

    pose = obstacles.pose.transpose(1, 2)                    # [F, T, M, 3]
    ox = pose[..., 0:1]                                      # [F, T, M, 1]
    oy = pose[..., 1:2]
    otheta = pose[..., 2:3]
    ohl = obstacles.half_ext[:, None, :, 0:1]                # [F, 1, M, 1]
    ohw = obstacles.half_ext[:, None, :, 1:2]

    o_cos = torch.cos(otheta)
    o_sin = torch.sin(otheta)
    dx = ox - ex                                             # [F, T, M, K]
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
        r = obstacles.radius[:, None, :, None]               # [F, 1, M, 1]
        qx = torch.clamp(lx - ehl, min=0.0)
        qy = torch.clamp(ly - ehw, min=0.0)
        disc_hit = qx * qx + qy * qy <= r * r
        hit = torch.where(r > 0, disc_hit, hit)
    hit = hit & obstacles.valid.transpose(1, 2)[..., None]
    return torch.any(hit.reshape(F, -1, K), dim=1)


def far_pairs_reference(cx: torch.Tensor, cy: torch.Tensor,
                        theta: torch.Tensor, obstacles: ObstacleArrays,
                        half_length, half_width) -> torch.Tensor:
    """[F, T, M, K] bool on fleet-form operands (those of
    :func:`obb_collision_fleet`): the (step, row) pairs whose test the
    kernel's bounding-circle skip removes (``skip_reach2`` and ``far_apart``
    of ``csrc/collision.cu``, op for op), valid or not.  The kernel never
    needs it; it counts the kernel's work (``chip_smoke.collision_work``) and
    lets a test hold every skipped pair to a miss of the full test."""
    per = lambda x: torch.as_tensor(x, dtype=cx.dtype, device=cx.device) \
        .reshape(-1, 1, 1, 1)                                # [F|1, 1, 1, 1]
    r_ego = torch.hypot(per(half_length), per(half_width))
    r = torch.zeros_like(obstacles.half_ext[..., 0]) \
        if obstacles.radius is None else obstacles.radius    # [F, M]
    r_obs = torch.where(r > 0, r, torch.hypot(obstacles.half_ext[..., 0],
                                              obstacles.half_ext[..., 1]))
    r_sum = r_ego + r_obs[:, None, :, None]                  # [F, 1, M, 1]
    reach = SKIP_SCALE * r_sum
    reach2 = reach * reach
    otheta = obstacles.pose[..., 2].transpose(1, 2)[..., None]  # [F, T, M, 1]
    reach2 = torch.where((r_sum >= SKIP_MIN_RADIUS) & torch.isfinite(otheta)
                         & torch.isfinite(reach2), reach2,
                         torch.full_like(reach2, float("nan")))
    dx = obstacles.pose[..., 0].transpose(1, 2)[..., None] - cx[:, :, None]
    dy = obstacles.pose[..., 1].transpose(1, 2)[..., None] - cy[:, :, None]
    d2 = dx * dx + dy * dy                                   # [F, T, M, K]
    return (d2 > reach2) & torch.isfinite(d2) \
        & torch.isfinite(theta)[:, :, None]


def shared_bytes(M: int, T: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory (bytes) of a collision block, either form, for
    M rows over T steps in ``dtype``: per (step, row) the position, cos/sin
    and the skip's squared reach, per row the half extents and the radius,
    then a valid byte per (step, row); ``csrc/collision.cu::staged_bytes``
    computes the same."""
    return dtype.itemsize * (5 * M * T + 3 * M) + M * T


def max_rows(T: int, dtype: torch.dtype) -> int:
    """The most obstacle rows over T steps a block of either form stages
    within ``SHARED_BLOCK_LIMIT``; one row more raises ``ValueError``."""
    return SHARED_BLOCK_LIMIT // shared_bytes(1, T, dtype)


def _check_shared(M, T, dtype, who):
    nbytes = shared_bytes(M, T, dtype)
    if nbytes > SHARED_BLOCK_LIMIT:
        raise ValueError(f"{who}: {M} obstacle rows over {T} steps in "
                         f"{dtype} need {nbytes} bytes of shared memory per "
                         f"block, above {SHARED_BLOCK_LIMIT}")


def _bind(lib: ctypes.CDLL):
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, scalar in (("crp_obb_collision_f32", ctypes.c_float),
                         ("crp_obb_collision_f64", ctypes.c_double)):
        fn = getattr(lib, name)
        fn.argtypes = [p, p, p, p, p, p, p, scalar, scalar, i, i, i, p, p]
        fn.restype = ctypes.c_int
    for name in ("crp_obb_collision_fleet_f32", "crp_obb_collision_fleet_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, p, p]
        fn.restype = ctypes.c_int
    lib.crp_collision_shared_bytes.argtypes = [i, i, i]
    lib.crp_collision_shared_limit.argtypes = []
    for fn in (lib.crp_collision_shared_bytes,
               lib.crp_collision_shared_limit):
        fn.restype = ctypes.c_long


def library() -> ctypes.CDLL:
    """The collision library (built on first use), its entry points bound."""
    return cuda_build.load(KERNEL_SOURCE, _bind)


def _check_operands(cx, cy, theta, obstacles, extents=(),
                    who="obb_collision"):
    """Raise unless every operand is contiguous, on ``cx``'s device, in its
    dtype (float32 or float64; ``valid`` bool), of the kernel's shapes: [T, K]
    poses and [M, ...] rows, or with a leading problem axis [F, ...] (then
    ``extents`` are the [F] ego half extents)."""
    dtype, device = cx.dtype, cx.device
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{who}: dtype {dtype}; the kernel takes "
                         "float32 or float64")
    lead = tuple(cx.shape[:-2])                      # () or (F,)
    T, K = cx.shape[-2:]
    M = obstacles.pose.shape[len(lead)]
    expect = [("cx", cx, lead + (T, K)), ("cy", cy, lead + (T, K)),
              ("theta", theta, lead + (T, K)),
              ("pose", obstacles.pose, lead + (M, T, 3)),
              ("half_ext", obstacles.half_ext, lead + (M, 2))]
    if obstacles.radius is not None:
        expect.append(("radius", obstacles.radius, lead + (M,)))
    expect += [(name, t, lead) for name, t in
               zip(("half_length", "half_width"), extents)]
    for name, t, shape in expect:
        if t.dtype != dtype or t.device != device or t.shape != shape \
                or not t.is_contiguous():
            raise ValueError(f"{who}: {name} must be a contiguous "
                             f"{dtype} tensor of shape {shape} on {device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    valid = obstacles.valid
    if valid.dtype != torch.bool or valid.device != device or \
            valid.shape != lead + (M, T) or not valid.is_contiguous():
        raise ValueError(f"{who}: valid must be a contiguous bool "
                         f"tensor of shape {lead + (M, T)} on {device}")


def _launch(cx, cy, theta, obstacles, half_length, half_width,
            fleet=False):
    """One launch of either form on the current stream: checks the operands,
    the shared memory and the device (raising on what the kernels do not
    take), allocates the bool mask, reads the raw stream handle, calls the
    library, checks its return code and counts the launch."""
    wrapper = obb_collision_fleet if fleet else obb_collision
    who = wrapper.__name__
    _check_operands(cx, cy, theta, obstacles,
                    (half_length, half_width) if fleet else (), who)
    *lead, T, K = cx.shape
    M = obstacles.pose.shape[len(lead)]
    _check_shared(M, T, cx.dtype, who)
    if cx.device.type != "cuda":
        raise ValueError(f"{who}: unsupported device {cx.device}")
    out = torch.empty((*lead, K), dtype=torch.bool, device=cx.device)
    radius = obstacles.radius
    args = (cx.data_ptr(), cy.data_ptr(), theta.data_ptr(),
            obstacles.pose.data_ptr(), obstacles.half_ext.data_ptr(),
            obstacles.valid.data_ptr(),
            None if radius is None else radius.data_ptr())
    if fleet:
        args += (half_length.data_ptr(), half_width.data_ptr(), *lead)
    else:
        args += (float(half_length), float(half_width))
    entry = (f"crp_{'obb_collision_fleet' if fleet else 'obb_collision'}_"
             f"{'f32' if cx.dtype == torch.float32 else 'f64'}")
    rc = getattr(library(), entry)(
        *args, K, T, M, out.data_ptr(),
        torch._C._cuda_getCurrentRawStream(cx.device.index))
    if rc != 0:
        raise RuntimeError(f"{who}: kernel launch failed: CUDA error {rc}")
    wrapper.launches += 1
    return out


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
    wrapper's launches, not the replays of a captured graph) and raise if
    it cannot be built or launched; CPU inputs run
    :func:`obb_collision_reference`.
    """
    if cx.device.type == "cpu":
        return obb_collision_reference(cx, cy, theta, obstacles,
                                       half_length, half_width)
    if obstacles.pose.shape[0] == 0:
        return torch.zeros(cx.shape[1], dtype=torch.bool, device=cx.device)
    return _launch(cx, cy, theta, obstacles, half_length, half_width)


def obb_collision_fleet(cx: torch.Tensor, cy: torch.Tensor,
                        theta: torch.Tensor, obstacles: ObstacleArrays,
                        half_length: torch.Tensor,
                        half_width: torch.Tensor) -> torch.Tensor:
    """Collision masks [F, K] (bool) of F problems' ego OBBs against their
    box/disc groups, in one launch.

    ``cx``/``cy``/``theta`` [F, T, K]: ego OBB centers (already shifted
    ``wb_rear_axle`` ahead of the rear axle) and headings, contiguous, in the
    rows' dtype (float32 or float64); ``obstacles``: pose [F, M, T, 3], half
    extents [F, M, 2], valid [F, M, T] (bool), optional disc radii [F, M]
    (padded rows are kept out by ``valid`` alone; the polygon group is not
    read); ``half_length``/``half_width``: the per-problem ego half extents,
    [F] tensors on the same device.  With M = 0 nothing is launched.

    CUDA inputs launch the kernel (``obb_collision_fleet.launches`` counts
    the wrapper's launches, not the replays of a captured graph) and raise
    if it cannot be built or launched; CPU inputs run
    :func:`obb_collision_fleet_reference`.
    """
    if cx.device.type == "cpu":
        return obb_collision_fleet_reference(cx, cy, theta, obstacles,
                                             half_length, half_width)
    if obstacles.pose.shape[1] == 0:
        return torch.zeros(cx.shape[0], cx.shape[2], dtype=torch.bool,
                           device=cx.device)
    return _launch(cx, cy, theta, obstacles, half_length, half_width,
                   fleet=True)


obb_collision.launches = 0
obb_collision_fleet.launches = 0
