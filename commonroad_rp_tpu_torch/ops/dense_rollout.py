"""The dense XLA fleet cycle's candidate pass as one CUDA kernel.

The XLA fleet path (``parallel.fleet._single_problem_cycle``) rolls out,
checks, costs and corridor-tests every candidate of every problem.  Its plain
version, :func:`dense_rollout_reference`, composes ``kinematics.rollout``
(bounded by each route's end ``s_last``), ``cost.default_cost``,
``collision.check_corridor`` and the ego-centre lines of the fleet collision
check over [T, F, K] arrays; on the card :func:`dense_rollout` launches
``dense_rollout_kernel`` of ``csrc/dense_rollout.cu`` instead, which walks
each candidate's T steps in registers and writes only what the cycle reads
on: the collision kernel's operands ``cx``/``cy``/``theta`` [F, T, K] and
``feasible``, ``cost`` and the corridor mask [F, K].  :func:`dense_winner`
gives the states the selection and the standstill fallback read at the
chosen candidates: on the card ``dense_winner_kernel`` walks each problem's
chosen candidate again, on the CPU they are gathered from the plain
version's bundle.

The tensors' device picks the path: CUDA tensors launch the kernels (float32
or float64, built with nvcc on first use, bound through ctypes) or raise;
CPU tensors run the plain version.  ``dense_rollout.launches`` and
``dense_winner.launches`` count the wrappers' launches (eager, a warm-up or
a capture), not the replays of a captured graph.  The JAX package has no
counterpart kernel: it leaves this path to XLA's fusion.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from commonroad_rp_tpu_torch.ops import collision as collision_ops
from commonroad_rp_tpu_torch.ops import cost as cost_ops
from commonroad_rp_tpu_torch.ops import cuda_build
from commonroad_rp_tpu_torch.ops import frenet as frenet_ops
from commonroad_rp_tpu_torch.ops import kinematics as kin_ops

KERNEL_SOURCE = cuda_build.CSRC_DIR / "dense_rollout.cu"
# the most dynamic shared memory a rollout block may ask for (sm_90: 227 KB
# a block, the kernels have no static shared memory)
SHARED_BLOCK_LIMIT = 227 * 1024
# staged scalars of a block (csrc/dense_rollout.cu kScalStaged)
_SCALARS_STAGED = 16

# the states dense_winner returns, in its columns: at step replan_offset,
# then the speed at step lookahead
WINNER_FIELDS = ("s", "s_dot", "s_ddot", "d", "d_dot", "d_ddot", "theta_gl",
                 "v", "x", "y", "kappa_gl", "v_lookahead")


class DenseInputs(NamedTuple):
    """One cycle's candidates and scene, every leaf with a leading problem
    axis F: the velocity-keeping grid ([F, K, 6] coefficients, [F, K] int32
    valid steps), the reference tables [F, P, ...], the vehicles [F], the
    carried orientation [F], the low-velocity flags [F] (bool), each route's
    end [F], the desired speeds [F] and the corridor bands [F, P]."""

    coeffs_lon: torch.Tensor
    coeffs_lat: torch.Tensor
    traj_len: torch.Tensor
    ref: frenet_ops.RefPathTables
    veh: kin_ops.VehicleArrays
    orientation: torch.Tensor
    low_vel: torch.Tensor
    s_last: torch.Tensor
    desired_speed: torch.Tensor
    corridor_lo: torch.Tensor
    corridor_hi: torch.Tensor


class DenseRollout(NamedTuple):
    """The pass's outputs: ego box centres and headings [F, T, K] (the fleet
    collision kernel's operands), kinematic-and-domain feasibility, cost and
    corridor violation [F, K]; ``bundle`` is the plain version's rollout
    (None from the kernel)."""

    cx: torch.Tensor
    cy: torch.Tensor
    theta: torch.Tensor
    feasible: torch.Tensor
    cost: torch.Tensor
    corridor: torch.Tensor
    bundle: Optional[kin_ops.RolloutResult] = None


def dense_rollout_reference(inp: DenseInputs, dt: float,
                            n_steps: int) -> DenseRollout:
    """Plain PyTorch version of the kernel (the XLA fleet cycle's passes as
    they were composed before it): ``kinematics.rollout``,
    ``cost.default_cost`` (acceleration weight 5, lateral target 0, each
    problem's desired speed), ``collision.check_corridor`` and the ego
    centres of the fleet collision check, on whatever device the inputs
    are."""
    rollout = kin_ops.rollout(inp.coeffs_lon, inp.coeffs_lat, inp.traj_len,
                              inp.ref, inp.veh, inp.orientation, dt, n_steps,
                              inp.low_vel, s_last=inp.s_last)
    costs = cost_ops.default_cost(rollout, w_a=5.0, desired_d=0.0,
                                  desired_speed=inp.desired_speed)
    corridor = collision_ops.check_corridor(
        rollout.s, rollout.d, rollout.theta_cl, inp.ref.s,
        collision_ops.CorridorArrays(d_lo=inp.corridor_lo,
                                     d_hi=inp.corridor_hi),
        inp.veh.half_length, inp.veh.half_width, inp.veh.wb_rear_axle,
        s_last=inp.s_last)
    theta_t = rollout.theta_gl.transpose(1, 2).contiguous()     # [F, T, K]
    wb = inp.veh.wb_rear_axle.to(theta_t.dtype).reshape(-1, 1, 1)
    cx = (rollout.x.transpose(1, 2) + wb * torch.cos(theta_t)).contiguous()
    cy = (rollout.y.transpose(1, 2) + wb * torch.sin(theta_t)).contiguous()
    return DenseRollout(cx, cy, theta_t, rollout.feasible, costs, corridor,
                        rollout)


def dense_winner_reference(result: DenseRollout, best: torch.Tensor,
                           replan_offset: int,
                           lookahead: int) -> torch.Tensor:
    """[F, 12] (``WINNER_FIELDS``): the plain version's bundle gathered at
    each problem's candidate ``best`` [F]."""
    b = result.bundle
    problem = torch.arange(best.shape[0], device=best.device)
    at = lambda arr, step=replan_offset: arr[problem, best, step]
    return torch.stack([at(b.s), at(b.s_dot), at(b.s_ddot), at(b.d),
                        at(b.d_dot), at(b.d_ddot), at(b.theta_gl), at(b.v),
                        at(b.x), at(b.y), at(b.kappa_gl),
                        at(b.v, lookahead)], dim=1)


def shared_bytes(P: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory (bytes) of a rollout block at P table rows in
    ``dtype``: the staged scalars, the arclength column and the two bands
    (``csrc/dense_rollout.cu::staged_bytes`` computes the same)."""
    return dtype.itemsize * (_SCALARS_STAGED + 3 * P)


def _bind(lib: ctypes.CDLL):
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for name in ("crp_dense_rollout_f32", "crp_dense_rollout_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [p, d, i, i, i, i, p, p]
        fn.restype = ctypes.c_int
    for name in ("crp_dense_winner_f32", "crp_dense_winner_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [p, d, p, i, i, i, i, i, i, p, p]
        fn.restype = ctypes.c_int
    lib.crp_dense_shared_bytes.argtypes = [i, i]
    lib.crp_dense_shared_limit.argtypes = []
    for fn in (lib.crp_dense_shared_bytes, lib.crp_dense_shared_limit):
        fn.restype = ctypes.c_long


def library() -> ctypes.CDLL:
    """The library of both kernels (built on first use), its entry points
    bound."""
    return cuda_build.load(KERNEL_SOURCE, _bind)


def _operands(inp: DenseInputs, who: str):
    """(The kernels' operand pointers, in ``csrc/dense_rollout.cu``'s
    ``Operands`` order, as a ctypes array; (F, K, P)).  Raises unless every
    operand is contiguous, on ``coeffs_lon``'s device, in its dtype (float32
    or float64; ``traj_len`` int32, ``low_vel`` bool) and of its shape, and
    that device is the card, and unless a block's staged tables fit its
    shared memory."""
    dtype, device = inp.coeffs_lon.dtype, inp.coeffs_lon.device
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{who}: dtype {dtype}; the kernel takes float32 "
                         "or float64")
    F, K = inp.traj_len.shape
    P = inp.ref.s.shape[-1]
    ref = inp.ref
    expect = [("coeffs_lon", inp.coeffs_lon, (F, K, 6), dtype),
              ("coeffs_lat", inp.coeffs_lat, (F, K, 6), dtype),
              ("traj_len", inp.traj_len, (F, K), torch.int32),
              ("ref.s", ref.s, (F, P), dtype),
              ("ref.theta", ref.theta, (F, P), dtype),
              ("ref.curv", ref.curv, (F, P), dtype),
              ("ref.curv_d", ref.curv_d, (F, P), dtype),
              ("ref.points", ref.points, (F, P, 2), dtype),
              ("ref.tangent", ref.tangent, (F, P, 2), dtype),
              ("ref.normal", ref.normal, (F, P, 2), dtype),
              ("corridor_lo", inp.corridor_lo, (F, P), dtype),
              ("corridor_hi", inp.corridor_hi, (F, P), dtype)]
    expect += [(f"veh.{name}", getattr(inp.veh, name), (F,), dtype)
               for name in kin_ops.VehicleArrays._fields]
    expect += [("orientation", inp.orientation, (F,), dtype),
               ("low_vel", inp.low_vel, (F,), torch.bool),
               ("s_last", inp.s_last, (F,), dtype),
               ("desired_speed", inp.desired_speed, (F,), dtype)]
    for name, t, shape, want in expect:
        if not isinstance(t, torch.Tensor) or t.dtype != want or \
                t.device != device or tuple(t.shape) != shape or \
                not t.is_contiguous():
            got = (f"{t.dtype} {tuple(t.shape)} on {t.device}"
                   if isinstance(t, torch.Tensor) else type(t).__name__)
            raise ValueError(f"{who}: {name} must be a contiguous {want} "
                             f"tensor of shape {shape} on {device}, got "
                             f"{got}")
    if P < 2:
        raise ValueError(f"{who}: the reference tables need 2 rows or more")
    nbytes = shared_bytes(P, dtype)
    if nbytes > SHARED_BLOCK_LIMIT:
        raise ValueError(f"{who}: {P} table rows in {dtype} need {nbytes} "
                         f"bytes of shared memory per block, above "
                         f"{SHARED_BLOCK_LIMIT}")
    if device.type != "cuda":
        raise ValueError(f"{who}: unsupported device {device}")
    return (ctypes.c_void_p * len(expect))(
        *(t.data_ptr() for _, t, _, _ in expect)), (F, K, P)


def _entry(name: str, dtype: torch.dtype):
    return getattr(library(), f"crp_{name}_"
                   f"{'f32' if dtype == torch.float32 else 'f64'}")


def _check(rc: int, who: str):
    if rc != 0:
        raise RuntimeError(f"{who}: kernel launch failed: CUDA error {rc}")


def dense_rollout(inp: DenseInputs, dt: float, n_steps: int) -> DenseRollout:
    """Rollout, constraint checks, projection domain, default cost (desired
    speed per problem, no stop target) and corridor test of every candidate
    of ``inp`` over T = ``n_steps`` + 1 steps of ``dt``.

    CUDA inputs launch ``dense_rollout_kernel`` once on the current stream
    (``dense_rollout.launches`` counts it) and raise if it cannot be built
    or launched, or if an operand is not what it takes; CPU inputs run
    :func:`dense_rollout_reference`."""
    if inp.coeffs_lon.device.type == "cpu":
        return dense_rollout_reference(inp, dt, n_steps)
    who = "dense_rollout"
    ptrs, (F, K, P) = _operands(inp, who)
    dtype, device = inp.coeffs_lon.dtype, inp.coeffs_lon.device
    T = n_steps + 1
    poses = [torch.empty((F, T, K), dtype=dtype, device=device)
             for _ in range(3)]
    feasible = torch.empty((F, K), dtype=torch.bool, device=device)
    cost = torch.empty((F, K), dtype=dtype, device=device)
    corridor = torch.empty((F, K), dtype=torch.bool, device=device)
    out = (ctypes.c_void_p * 6)(*(t.data_ptr() for t in (
        *poses, feasible, cost, corridor)))
    _check(_entry("dense_rollout", dtype)(
        ptrs, float(dt), F, K, P, T, out,
        torch._C._cuda_getCurrentRawStream(device.index)), who)
    dense_rollout.launches += 1
    return DenseRollout(*poses, feasible, cost, corridor)


def dense_winner(inp: DenseInputs, result: DenseRollout, best: torch.Tensor,
                 dt: float, n_steps: int, replan_offset: int,
                 lookahead: int) -> torch.Tensor:
    """[F, 12] (``WINNER_FIELDS``): each problem's candidate ``best`` [F]
    (int64) of :func:`dense_rollout`'s pass at step ``replan_offset``, and
    its speed at step ``lookahead``.

    CUDA inputs launch ``dense_winner_kernel`` (a warp per problem stages
    it, one thread walks the candidate through the rollout kernel's walk;
    ``dense_winner.launches`` counts it);
    CPU inputs gather ``result``'s bundle (:func:`dense_winner_reference`)."""
    if inp.coeffs_lon.device.type == "cpu":
        return dense_winner_reference(result, best, replan_offset, lookahead)
    who = "dense_winner"
    ptrs, (F, K, P) = _operands(inp, who)
    T = n_steps + 1
    if not (0 <= replan_offset < T and 0 <= lookahead < T):
        raise ValueError(f"{who}: steps {replan_offset} and {lookahead} "
                         f"must lie in [0, {T})")
    if best.dtype != torch.int64 or best.shape != (F,) or \
            best.device != inp.coeffs_lon.device or not best.is_contiguous():
        raise ValueError(f"{who}: best must be a contiguous int64 tensor of "
                         f"shape ({F},) on {inp.coeffs_lon.device}")
    out = torch.empty((F, len(WINNER_FIELDS)), dtype=inp.coeffs_lon.dtype,
                      device=best.device)
    _check(_entry("dense_winner", out.dtype)(
        ptrs, float(dt), best.data_ptr(), F, K, P, T, replan_offset,
        lookahead, out.data_ptr(),
        torch._C._cuda_getCurrentRawStream(best.device.index)), who)
    dense_winner.launches += 1
    return out


dense_rollout.launches = 0
dense_winner.launches = 0
