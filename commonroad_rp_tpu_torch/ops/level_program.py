"""The compiled level programs: ``ops.cycle.evaluate_levels_fast`` and
``ops.cycle.evaluate_level`` run as one captured CUDA graph per jit
signature.

Counterpart of the JAX package's jitted level programs:
``_evaluate_levels_fast`` (commonroad_rp_tpu/ops/cycle.py:216-220, the
fused level program of ``plan()``) and ``evaluate_level`` (:65-68, the
conformance level program), each compiled once per signature and dispatched
once per call with one readback (commonroad_rp_tpu/models/planner.py:974,
:986).  A :class:`LevelProgram` is built for one signature (:func:`signature`:
the shapes and dtypes of every array argument, the static arguments, the
ego half extents and the device) and owns static buffers for every array
argument.  A call

1. writes the host data (coefficients, ``traj_len``, ``goal_valid``, level
   ids, the heading, the cost parameters and the vehicle scalars) into one
   pinned staging buffer and moves it to the device with one asynchronous
   copy; the scene tensors already on the device (reference tables,
   corridor, obstacle window, road boundary) are copied into their buffers;
2. runs the step (``ops.program.CapturedStep``): on the card a replay of the
   captured body, elsewhere the body eagerly;
3. reads one packed row back into pinned memory: the scalars, the [14, T]
   winner, the refinement-overflow flag, the rejection counts per reason
   code and, when asked for, the dense bundle of trajectory-set capture.

Nothing a call passes is baked into a capture: host numbers reach the body
as 0-d views of the staged buffer (the scorer's scalar row in the fused
program), never as Python floats, which a capture would freeze.  The ego
half extents are the exception: the collision kernel
(``ops.collision_kernel.obb_collision``) takes them by value, so they are
part of the signature.

The fused program runs the exact ``segments``/continuous refinement as
``cycle.refine_cheapest`` over ``cycle.REFINE_WIDTH`` candidates; when that
width is not enough (``overflow``), :meth:`LevelProgram.continue_lazy`
carries the JAX ``while_loop`` on eagerly from the program's masked row.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from commonroad_rp_tpu_torch.ops import cycle as cycle_ops
from commonroad_rp_tpu_torch.ops import kinematics
from commonroad_rp_tpu_torch.ops import scoring
from commonroad_rp_tpu_torch.ops.collision import (BoundaryArrays,
                                                   CorridorArrays,
                                                   ObstacleArrays)
from commonroad_rp_tpu_torch.ops.frenet import RefPathTables
from commonroad_rp_tpu_torch.ops.program import CapturedStep
from commonroad_rp_tpu_torch.utils import profiling

FAST, LEVEL = "fast", "level"
# static arguments of each program (the JAX jits' static_argnames, and the
# conformance program's request for the dense bundle)
STATIC = {FAST: ("dt", "n_steps", "low_vel_mode", "cost_structure",
                 "constraint_flags", "n_levels", "continuous"),
          LEVEL: ("dt", "n_steps", "low_vel_mode", "cost_structure",
                  "constraint_flags", "boundary_mode", "continuous_check",
                  "bundle")}
# the rejection counts come back per reason code 0..4 (REASON_NAMES)
N_REASONS = len(kinematics.REASON_NAMES)
assert sorted(kinematics.REASON_NAMES) == list(range(N_REASONS))
# vehicle scalars staged per call (the half extents are in the signature)
_VEH_STAGED = ("wheelbase", "wb_rear_axle", "a_max", "v_switch",
               "kappa_max", "v_delta_max")
# the conformance program's staged values: heading, cost parameters,
# vehicle scalars
_LEVEL_VALUES = ("x0_orientation",) + cycle_ops.CostParams._fields \
    + _VEH_STAGED
_ROW_VEH = dict(wheelbase=scoring._S_WHEELBASE,
                wb_rear_axle=scoring._S_WB_REAR, a_max=scoring._S_A_MAX,
                v_switch=scoring._S_V_SWITCH,
                kappa_max=scoring._S_KAPPA_MAX,
                v_delta_max=scoring._S_V_DELTA_MAX)


class LevelArgs(NamedTuple):
    """One call's arguments.  Host data: numpy arrays and Python numbers;
    scene data: tensors on the program's device."""

    coeffs_lon: np.ndarray                  # [K, 6]
    coeffs_lat: np.ndarray                  # [K, 6]
    traj_len: np.ndarray                    # [K] valid steps
    goal_valid: np.ndarray                  # [K] bool
    level_ids: Optional[np.ndarray]         # [K] (fused program), else None
    x0_orientation: float
    cost_params: cycle_ops.CostParams       # floats
    veh: kinematics.VehicleArrays           # floats
    ref: RefPathTables
    corridor: Optional[CorridorArrays]
    obstacles: ObstacleArrays
    boundary: Optional[BoundaryArrays]


class LevelOutput(NamedTuple):
    """One call's results on the host (copies: a later call changes none)."""

    scalars: np.ndarray       # fused [6]: best_idx, best_cost, n_inf_kin,
                              # n_coll, re-roll feasible, level; else [4]
    optimal: np.ndarray       # [14, T] winner (CANDIDATE_FIELDS)
    overflow: bool            # the bounded refinement stopped short
    reason_counts: np.ndarray  # [N_REASONS] rejections per reason code
    bundle: Optional[tuple]   # (x [K, T], y [K, T], costs [K],
                              #  feasible [K], collides [K]) or None


def _spec(tree):
    """Shapes and dtypes of a call's array arguments (host arrays by shape:
    the program stages them in its own dtypes); host numbers are values,
    not part of a signature."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tuple(tree.shape), tree.dtype, tree.device
    if isinstance(tree, np.ndarray):
        return tuple(tree.shape)
    if isinstance(tree, tuple):
        return tuple(_spec(x) for x in tree)
    return ()


def signature(kind: str, args: LevelArgs, static: dict, graph: bool = True):
    """The program's key: what the JAX jit retraces on (array shapes and
    dtypes, static arguments) plus the ego half extents, the device (in the
    tensors' specs) and whether it captures."""
    return (kind, _spec(args), tuple(static[k] for k in STATIC[kind]),
            float(args.veh.half_length), float(args.veh.half_width),
            bool(graph))


def _leaves(tree):
    """The tensors of nested NamedTuples, in field order, None skipped."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, tuple):
        return [t for x in tree for t in _leaves(x)]
    return []


def _empty_like(tree):
    """Static buffers shaped like the tensors of ``tree``."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return torch.empty_like(tree, memory_format=torch.contiguous_format)
    parts = [_empty_like(x) for x in tree]
    return type(tree)(*parts) if hasattr(tree, "_fields") else tuple(parts)


def host_dtypes(kind: str, ref_dtype: torch.dtype) -> dict:
    """The dtypes a program stages its host arrays in: those the planner
    gave the eager bodies (float32 operands and int32 lengths for the
    fused scorer; the tables' dtype and int64 lengths for the conformance
    program)."""
    if kind == FAST:
        return dict(coeffs=torch.float32, traj_len=torch.int32,
                    values=torch.float32)
    return dict(coeffs=ref_dtype, traj_len=torch.int64, values=ref_dtype)


def eager_arguments(kind: str, args: LevelArgs, device) -> dict:
    """The array arguments of the eager body (``evaluate_levels_fast`` or
    ``evaluate_level``) for ``args``: the host arrays as tensors on
    ``device`` in the dtypes the program stages them in, the host numbers
    as they are.  With the static arguments added, the body's keyword
    arguments."""
    dtypes = host_dtypes(kind, args.ref.s.dtype)
    dev = lambda a, dtype: torch.as_tensor(np.asarray(a), dtype=dtype,
                                           device=device)
    out = dict(coeffs_lon=dev(args.coeffs_lon, dtypes["coeffs"]),
               coeffs_lat=dev(args.coeffs_lat, dtypes["coeffs"]),
               traj_len=dev(args.traj_len, dtypes["traj_len"]),
               goal_valid=dev(args.goal_valid, torch.bool),
               ref=args.ref, veh=args.veh, obstacles=args.obstacles,
               corridor=args.corridor, x0_orientation=args.x0_orientation,
               cost_params=args.cost_params, boundary=args.boundary)
    if kind == FAST:
        out["level_ids"] = dev(args.level_ids, torch.int32)
    return out


def _reason_counts(reasons: torch.Tensor, rejected: torch.Tensor):
    """[N_REASONS] counts of ``rejected`` candidates per reason code."""
    codes = torch.arange(N_REASONS, dtype=reasons.dtype,
                         device=reasons.device)
    return torch.sum((reasons[None] == codes[:, None]) & rejected[None],
                     dim=1)


def pack_fast(result: cycle_ops.FastLevelResult, goal_valid: torch.Tensor,
              level_ids: torch.Tensor) -> torch.Tensor:
    """The fused program's readback row: scalars [6], winner [14 T],
    overflow flag, reason counts of the selected level (a candidate counts
    when goal-valid and kinematically infeasible, as the reference's
    statistics count it)."""
    dtype = result.scalars.dtype
    level_mask = level_ids.to(torch.int64) == \
        result.scalars[5].to(torch.int64)
    rejected = goal_valid & level_mask & ~torch.isfinite(result.kin_costs)
    return torch.cat([result.scalars, result.optimal.reshape(-1),
                      result.overflow.to(dtype).reshape(1),
                      _reason_counts(result.reasons, rejected).to(dtype)])


def pack_level(result: cycle_ops.LevelResult, goal_valid: torch.Tensor,
               bundle: bool) -> torch.Tensor:
    """The conformance program's readback row: scalars [4], winner [14 T],
    reason counts and, with ``bundle``, x and y [K T], the costs [K] and
    the feasible and colliding labels [2 K]."""
    dtype = result.costs.dtype
    rejected = goal_valid & (result.masks[0] == 0)
    parts = [result.scalars, result.optimal.reshape(-1),
             _reason_counts(result.masks[2], rejected).to(dtype)]
    if bundle:
        parts += [result.rollout.x.reshape(-1), result.rollout.y.reshape(-1),
                  result.costs, result.masks[:2].to(dtype).reshape(-1)]
    return torch.cat(parts)


class LevelProgram:
    """The fused (``kind=FAST``) or conformance (``kind=LEVEL``) level
    program built for the signature of ``args`` and ``static``.

    ``program(args) -> LevelOutput`` stages ``args`` into the static
    buffers, runs the step (a replay of the captured body on a CUDA device
    unless ``graph=False``; the body eagerly otherwise) and reads one packed
    row back.  ``calls``, ``readbacks`` and ``continuations`` count the
    calls, the device reads and the eager continuations of the lazy
    refinement; ``buffer_bytes`` is the size of the static buffers and
    ``pool_bytes`` that of the captured graph's memory pool (None until a
    capture).  ``outputs`` holds the last step's device results
    (the body's result and the packed row), valid until the next call.
    """

    def __init__(self, kind: str, args: LevelArgs, static: dict,
                 graph: bool = True):
        if kind not in STATIC:
            raise ValueError(f"unknown level program {kind!r}")
        self.kind = kind
        self.static = {k: static[k] for k in STATIC[kind]}
        self.key = signature(kind, args, static, graph)
        device = args.ref.s.device
        self.device = device
        cuda = device.type == "cuda"
        self.K, self.T = args.coeffs_lon.shape[0], static["n_steps"] + 1
        self.calls = self.readbacks = self.continuations = 0

        # ---- one staging buffer for the host data, typed views into it
        dtypes = host_dtypes(kind, args.ref.s.dtype)
        K = self.K
        n_values = scoring._NUM_SCALARS if kind == FAST \
            else len(_LEVEL_VALUES)
        layout = [("coeffs_lon", (K, 6), dtypes["coeffs"]),
                  ("coeffs_lat", (K, 6), dtypes["coeffs"]),
                  ("traj_len", (K,), dtypes["traj_len"]),
                  ("goal_valid", (K,), torch.bool),
                  ("values", (n_values,), dtypes["values"])]
        if kind == FAST:
            layout.append(("level_ids", (K,), torch.int32))
        offsets, nbytes = [], 0
        for _, shape, dtype in layout:
            offsets.append(nbytes)
            size = math.prod(shape) * dtype.itemsize
            nbytes += -(-size // 8) * 8            # 8-byte aligned segments
        self._stage_dev = torch.zeros(nbytes, dtype=torch.uint8,
                                      device=device)
        self._stage_host = torch.zeros(nbytes, dtype=torch.uint8,
                                       pin_memory=True) \
            if cuda else self._stage_dev
        host_np = self._stage_host.numpy()
        self._host, staged = {}, {}
        for (name, shape, dtype), off in zip(layout, offsets):
            size = math.prod(shape) * dtype.itemsize
            staged[name] = self._stage_dev[off:off + size].view(
                dtype).view(shape)
            np_dtype = torch.empty((), dtype=dtype).numpy().dtype
            self._host[name] = host_np[off:off + size].view(
                np_dtype).reshape(shape)
        self._values = staged["values"]

        # ---- the body's arguments: staged views, static scene buffers
        scene = (args.ref, args.corridor, args.obstacles, args.boundary)
        self._scene = _empty_like(scene)
        self._scene_leaves = _leaves(self._scene)
        self.buffer_bytes = self._stage_dev.nbytes + sum(
            t.nbytes for t in self._scene_leaves)
        v = self._values
        if kind == FAST:
            veh_view = lambda f: v[_ROW_VEH[f]]
            x0 = v[scoring._S_X0_THETA]
            cost = cycle_ops.CostParams(
                w_a=v[scoring._S_W_A], desired_d=v[scoring._S_DESIRED_D],
                desired_speed=v[scoring._S_DESIRED_V],
                desired_s=v[scoring._S_DESIRED_S])
        else:
            at = {name: v[i] for i, name in enumerate(_LEVEL_VALUES)}
            veh_view = lambda f: at[f]
            x0 = at["x0_orientation"]
            cost = cycle_ops.CostParams(
                *(at[f] for f in cycle_ops.CostParams._fields))
        veh = kinematics.VehicleArrays(
            **{f: veh_view(f) for f in _VEH_STAGED},
            half_length=float(args.veh.half_length),
            half_width=float(args.veh.half_width))
        self._args = LevelArgs(
            coeffs_lon=staged["coeffs_lon"], coeffs_lat=staged["coeffs_lat"],
            traj_len=staged["traj_len"], goal_valid=staged["goal_valid"],
            level_ids=staged.get("level_ids"), x0_orientation=x0,
            cost_params=cost, veh=veh, ref=self._scene[0],
            corridor=self._scene[1], obstacles=self._scene[2],
            boundary=self._scene[3])
        self._out_host = None
        self._program = CapturedStep(
            self._fast_step if kind == FAST else self._level_step, device,
            graph)
        self.graph = self._program.graph

    # ------------------------------------------------------------------
    # the steps: the eager bodies on the static buffers
    # ------------------------------------------------------------------

    def _fast_step(self):
        a, v = self._args, self._values
        s = a.ref.s.to(torch.float32)
        # the scorer's scalar row: the staged values with the path's first
        # and last arclength (scoring.prepare_inputs's table_s0, ref_s_last)
        row = torch.cat([v[:scoring._S_REF_S_LAST], s[-1:],
                         v[scoring._S_REF_S_LAST + 1:scoring._S_TABLE_S0],
                         s[:1]])
        result = cycle_ops.evaluate_levels_fast(
            a.coeffs_lon, a.coeffs_lat, a.traj_len, a.goal_valid,
            a.level_ids, a.ref, a.veh, a.obstacles, a.corridor,
            a.x0_orientation, a.cost_params, a.boundary, **self.static,
            refine_width=cycle_ops.REFINE_WIDTH, scalar_row=row)
        return result, pack_fast(result, a.goal_valid, a.level_ids)

    def _level_step(self):
        a = self._args
        static = dict(self.static)
        bundle = static.pop("bundle")
        result = cycle_ops.evaluate_level(
            a.coeffs_lon, a.coeffs_lat, a.traj_len, a.goal_valid, a.ref,
            a.veh, a.obstacles, a.boundary, a.corridor, a.x0_orientation,
            a.cost_params, **static)
        return result, pack_level(result, a.goal_valid, bundle)

    # ------------------------------------------------------------------
    # a call
    # ------------------------------------------------------------------

    def _stage(self, args: LevelArgs):
        if _spec(args) != self.key[1] or (
                float(args.veh.half_length), float(args.veh.half_width)) \
                != self.key[3:5]:
            raise ValueError("level program: the arguments' shapes, dtypes "
                             "or ego extents differ from the program's "
                             "signature")
        h = self._host
        for name in ("coeffs_lon", "coeffs_lat", "traj_len", "goal_valid"):
            h[name][...] = getattr(args, name)
        values = h["values"]
        cost, veh = args.cost_params, args.veh
        if self.kind == FAST:
            h["level_ids"][...] = args.level_ids
            has_s = self.static["cost_structure"][0] == "default" \
                and self.static["cost_structure"][2]
            for field, slot in _ROW_VEH.items():
                values[slot] = getattr(veh, field)
            for slot, value in (
                    (scoring._S_HALF_LEN, veh.half_length),
                    (scoring._S_HALF_WID, veh.half_width),
                    (scoring._S_X0_THETA, args.x0_orientation),
                    (scoring._S_DT, self.static["dt"]),
                    (scoring._S_LOW_VEL, bool(self.static["low_vel_mode"])),
                    (scoring._S_DESIRED_V, cost.desired_speed),
                    (scoring._S_DESIRED_D, cost.desired_d),
                    (scoring._S_W_A, cost.w_a),
                    (scoring._S_DESIRED_S,
                     cost.desired_s if has_s else 0.0)):
                values[slot] = value
        else:
            values[:] = [args.x0_orientation, *cost,
                         *(getattr(veh, f) for f in _VEH_STAGED)]
        if self._stage_host is not self._stage_dev:
            self._stage_dev.copy_(self._stage_host, non_blocking=True)
        torch._foreach_copy_(self._scene_leaves, _leaves(
            (args.ref, args.corridor, args.obstacles, args.boundary)))

    def _read(self, packed: torch.Tensor) -> LevelOutput:
        """One device read of the packed row; the host copy is unpacked."""
        with profiling.span("level_program.readback"):
            if self.device.type == "cuda":
                if self._out_host is None:
                    self._out_host = torch.empty(
                        packed.shape, dtype=packed.dtype, pin_memory=True)
                self._out_host.copy_(packed, non_blocking=True)
                torch.cuda.current_stream(self.device).synchronize()
                row = self._out_host.numpy().copy()
            else:
                row = packed.numpy().copy()
            self.readbacks += 1
            T, K = self.T, self.K
            n = 6 if self.kind == FAST else 4
            o = n + 14 * T
            scalars, optimal = row[:n], row[n:o].reshape(14, T)
            overflow = False
            if self.kind == FAST:
                overflow = bool(row[o] > 0.5)
                o += 1
            counts = row[o:o + N_REASONS].astype(np.int64)
            o += N_REASONS
            bundle = None
            if self.kind == LEVEL and self.static["bundle"]:
                x = row[o:o + K * T].reshape(K, T)
                y = row[o + K * T:o + 2 * K * T].reshape(K, T)
                o += 2 * K * T
                labels = row[o + K:o + 3 * K].reshape(2, K).astype(bool)
                bundle = (x, y, row[o:o + K], labels[0], labels[1])
            return LevelOutput(scalars=scalars, optimal=optimal,
                               overflow=overflow, reason_counts=counts,
                               bundle=bundle)

    def __call__(self, args: LevelArgs) -> LevelOutput:
        with profiling.span("level_program.stage"):
            self._stage(args)
        _, packed = self._program()
        out = self._read(packed)
        self.calls += 1
        return out

    @property
    def outputs(self):
        """(the body's result, the packed row) of the last step, on the
        device: the captured outputs on a graph, rewritten by each call."""
        return self._program.outputs

    @property
    def replays(self) -> int:
        return self._program.replays

    @property
    def pool_bytes(self):
        return self._program.pool_bytes

    def continue_lazy(self) -> LevelOutput:
        """After a fused call that reported overflow: the lazy refinement
        (``cycle.lazy_refinement``, the JAX ``while_loop``) carried on
        eagerly on the device from the program's masked row, then the
        selection and the winner's re-roll; one more packed readback."""
        if self.kind != FAST:
            raise ValueError("continue_lazy: the fused program only")
        result, _ = self._program.outputs
        a = self._args
        static = {k: self.static[k] for k in
                  ("dt", "n_steps", "low_vel_mode", "constraint_flags",
                   "n_levels", "continuous")}
        cont = cycle_ops.select_levels_fast(
            result.costs.clone(), result.kin_costs, result.reasons,
            a.coeffs_lon, a.coeffs_lat, a.traj_len, a.goal_valid,
            a.level_ids, a.ref, a.veh, a.obstacles, a.x0_orientation,
            a.boundary, **static)
        self.continuations += 1
        return self._read(pack_fast(cont, a.goal_valid, a.level_ids))
