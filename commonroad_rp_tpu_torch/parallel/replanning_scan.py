"""Device replanning loops on the fused scorer.

Counterpart of ``commonroad_rp_tpu/parallel/pallas_fleet.py``:

* ``make_replanning_scan`` -- one problem, one static grid, the
  velocity-keeping cycle (``make_pallas_replanning_scan``);
* ``make_fleet_scan`` -- F heterogeneous problems (``parallel.fleet``), one
  fleet-scorer launch per cycle (``make_pallas_fleet_scan``);
* ``make_facade_replanning_scan`` -- the loop behind
  ``ReactivePlanner.plan_scan``: every sampling level's grid, level
  escalation, stopping mode, corridor sampling, the recorded states.

Each cycle generates its candidate grids on the device around the carried
state, scores them in one kernel launch, selects the winner by argmin, and
re-rolls only the winner (K = 1 per problem) through ``kinematics.rollout``
to advance the carry.  The fleet scan makes no grid tensors: it passes the
carried state and the level's static grid (``scoring.FleetLatticeInputs``),
the fleet kernel builds each candidate from them, and one small kernel
gives the winners' coefficients (``scoring.lattice_candidates``).  The
jitted ``lax.scan`` becomes a :class:`ScanProgram`: the carry lives in
static buffers, each cycle writes its metrics into preallocated
[n_cycles, ...] buffers at a device-side cycle counter, and no cycle reads
the device.  On a CUDA device the program
captures one cycle as a CUDA graph at its first call and replays it
``n_cycles`` times per call, so the host does no per-cycle work, as the JAX
scan's one dispatch does; ``graph=False`` runs the same cycles eagerly (the
twin the captured scan is held against), and the CPU always runs them
eagerly.  The constant operands (packed tables, scalar rows, obstacle
tables, grid constants) are built once before the first cycle.  Every
cycle takes the replanning rules it shares with the XLA fleet path from
one function each: the velocity window (``ops.grid.velocity_window``), the
obstacle window (``parallel.fleet.window_rows``: ``dynamic_slice``'s clamp,
and the steps past the prediction span read an appended invalid row), the
standstill rule (``parallel.fleet.standstill``) and, in the fleet scan,
the advance along the winners (``parallel.fleet.advance_fleet``).

``scorer`` is the scoring function on prepared operands (the fleet
scan's are ``FleetLatticeInputs``): by default
``ops.scoring.score_prepared`` (the CUDA kernels on the card, the plain
version on the CPU); ``ops.scoring.score_prepared_reference`` runs the plain
version on any device, to hold the kernel's scan against it.  The fleet
scan takes its winners' coefficients from ``candidates``, by default the
scorer's own: ``scoring.lattice_candidates_reference`` for the plain
scorer, so that its scan is plain throughout, else
``scoring.lattice_candidates``.

The facade scan's exact refinement (``segments`` boundary, continuous
collision checks) is the JAX scan's lazy winner loop in a form that reads
nothing from the device: the ``ops.cycle.REFINE_WIDTH`` cheapest
selectable candidates, in selection order, are re-rolled and checked at
once, and the colliding run at their head is masked before the selection
(``ops.cycle.refine_cheapest``).  ``make_fleet_scan(mesh=group)`` runs one
rank's slice of the fleet under a ``torch.distributed`` process group
(``parallel.mesh``), its three per-cycle aggregates summed by
``parallel.mesh.fleet_all_reduce``; on the card (NCCL) its cycle is
captured with the three all-reduces in the graph, under gloo on the CPU it
runs eagerly as every CPU scan does.  The dense XLA fleet rollout
(``parallel.fleet.make_fleet_rollout``) is a :class:`ScanProgram` too, and
``plan()``'s level programs are captured as well, one graph per jit
signature (``ops.level_program``).  :class:`ScanProgram` lives in
``ops.program``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from commonroad_rp_tpu_torch.ops import cycle as cycle_ops
from commonroad_rp_tpu_torch.ops import frenet as frenet_ops
from commonroad_rp_tpu_torch.ops import grid as grid_ops
from commonroad_rp_tpu_torch.ops import kinematics as kin_ops
from commonroad_rp_tpu_torch.ops import scoring
from commonroad_rp_tpu_torch.ops.collision import (BoundaryArrays,
                                                   CorridorArrays,
                                                   ObstacleArrays)
from commonroad_rp_tpu_torch.ops.cycle import (CANDIDATE_FIELDS,
                                               refine_cheapest)
from commonroad_rp_tpu_torch.ops.program import ScanProgram
from commonroad_rp_tpu_torch.parallel.fleet import (FleetCarry, FleetScene,
                                                    advance_fleet, standstill,
                                                    true_path_lengths,
                                                    window_rows)
from commonroad_rp_tpu_torch.parallel.mesh import fleet_all_reduce
from commonroad_rp_tpu_torch.utils import profiling

_F32 = torch.float32
_DYNAMIC_SLOTS = (scoring._S_X0_THETA, scoring._S_LOW_VEL)


class ReplanningCarry(NamedTuple):
    """Carry of ``make_replanning_scan`` (``PallasCycleCarry``)."""

    x0_lon: torch.Tensor          # [3]
    x0_lat: torch.Tensor          # [3]
    orientation: torch.Tensor     # scalar
    velocity: torch.Tensor        # scalar
    time_step: torch.Tensor       # scalar int32
    alive: torch.Tensor           # scalar bool


class FacadeScanCarry(NamedTuple):
    """Carry of the facade replanning scan (mirror of the planner's
    per-cycle state: curvilinear x0, pose, liveness).

    ``kappa``/``px``/``py`` carry the current curvature (tan(steering)/L)
    and Cartesian rear-axle position so the on-device standstill fallback
    (reactive_planner.py:667-713) can emit the host's exact trajectory
    arrays without a round-trip."""

    x0_lon: torch.Tensor          # [3]
    x0_lat: torch.Tensor          # [3]
    orientation: torch.Tensor     # scalar
    velocity: torch.Tensor        # scalar
    time_step: torch.Tensor       # scalar int32
    alive: torch.Tensor           # scalar bool
    kappa: torch.Tensor           # scalar: current curvature tan(delta)/L
    px: torch.Tensor              # scalar: cartesian x (rear axle)
    py: torch.Tensor              # scalar: cartesian y (rear axle)


def _f32_tensors(tup):
    return type(tup)(*(torch.as_tensor(x, dtype=_F32) if x is not None
                       else None for x in tup))


def _device_veh(veh: kin_ops.VehicleArrays, device) -> kin_ops.VehicleArrays:
    """Vehicle scalars as float32 device tensors (uploaded once)."""
    return kin_ops.VehicleArrays(*(
        torch.as_tensor(np.float32(float(x)) if not isinstance(x, torch.Tensor)
                        else x, dtype=_F32, device=device)
        for x in veh))


def _with_invalid_row(table: torch.Tensor, step_dim: int) -> torch.Tensor:
    """The table with one all-zero (invalid) step appended; window steps past
    the prediction span read it."""
    pad_shape = list(table.shape)
    pad_shape[step_dim] = 1
    return torch.cat([table, table.new_zeros(pad_shape)],
                     dim=step_dim).contiguous()


def _table_rows(time_step: torch.Tensor, T: int, n_rows: int,
                t_full: int) -> torch.Tensor:
    """``parallel.fleet.window_rows`` over a table with the appended invalid
    row (``_with_invalid_row``): every step past the prediction span reads
    row ``n_rows``."""
    rows, in_span = window_rows(time_step, T, n_rows, t_full)
    return torch.where(in_span, rows, n_rows)


def _scan_scalar_row(veh32, dt, desired_speed, desired_d, w_a, ref_s_last,
                desired_s, table_s0) -> torch.Tensor:
    """[17] scalar row of one problem; the per-cycle slots (heading, mode)
    are written each cycle."""
    row = scoring.fleet_scalar_rows(
        scoring.pack_veh_stack(veh32)[None], 0.0, dt, 0.0, desired_speed,
        desired_d, w_a, ref_s_last.reshape(1),
        None if desired_s is None else desired_s, table_s0.reshape(1))
    return row[0]


def _obstacle_window_tables(obstacles_full: ObstacleArrays, T: int, device):
    """(obstacle table [M, T_o + 1, 7], T_o, polygon table or None,
    T_p, vertex count, t_full): the full-span tables with an invalid step
    appended."""
    M = obstacles_full.pose.shape[0]
    t_full = obstacles_full.pose.shape[1] if M else T
    if M:
        obs = _with_invalid_row(scoring.obstacle_rows(
            obstacles_full.pose.to(device), obstacles_full.half_ext.to(device),
            obstacles_full.valid.to(device),
            None if obstacles_full.radius is None
            else obstacles_full.radius.to(device)), 1)
    else:
        obs = None
    poly, t_poly, V = None, 0, 1
    if obstacles_full.poly_verts is not None:
        Mp, t_poly, V = obstacles_full.poly_verts.shape[:3]
        poly = _with_invalid_row(torch.cat([
            obstacles_full.poly_verts.to(device=device, dtype=_F32).reshape(
                Mp, t_poly, 2 * V),
            obstacles_full.poly_valid.to(device=device,
                                         dtype=_F32)[..., None]], dim=-1), 1)
        t_full = max(t_full, t_poly)
    for n in (obstacles_full.pose.shape[1] if M else T, t_poly or T):
        if n < T:
            raise ValueError(f"obstacle tables span {n} steps, fewer than "
                             f"the horizon's {T}")
    return obs, (obstacles_full.pose.shape[1] if M else 0), poly, t_poly, \
        V, t_full


def window_obstacle_arrays(obs: torch.Tensor, poly, half_ext: torch.Tensor,
                           radius, n_poly_verts: int) -> ObstacleArrays:
    """One cycle's obstacle window as ObstacleArrays (the continuous pass's
    operand): ``obs`` [M, T, 7] and ``poly`` [Mp, T, 2V + 1] (or None) are
    windows of the tables of ``_obstacle_window_tables`` at
    ``_table_rows``, whose validity column already clears the steps past
    the prediction span (the JAX scan's ``window_valid & in_span``)."""
    T = obs.shape[1]
    poly_verts = poly_valid = None
    if poly is not None:
        V = n_poly_verts
        poly_verts = poly[..., :2 * V].reshape(poly.shape[0], T, V, 2)
        poly_valid = poly[..., 2 * V] > 0.5
    return ObstacleArrays(pose=obs[..., :3], half_ext=half_ext,
                          valid=obs[..., 5] > 0.5, radius=radius,
                          poly_verts=poly_verts, poly_valid=poly_valid)


# ---------------------------------------------------------------------------
# one problem, one static grid
# ---------------------------------------------------------------------------

def make_replanning_scan(ref: frenet_ops.RefPathTables,
                         corridor: CorridorArrays,
                         obstacles_full: ObstacleArrays,
                         veh: kin_ops.VehicleArrays,
                         static_grid: grid_ops.StaticGrid,
                         dt: float, n_steps: int, replan_offset: int,
                         low_vel_threshold: float, horizon: float,
                         desired_speed: float, n_cycles: int,
                         scorer=scoring.score_prepared, graph: bool = True):
    """``run(carry: ReplanningCarry) -> (carry, metrics)`` running
    ``n_cycles`` fused-scorer cycles of one problem; metrics (found, cost,
    x, y), each [n_cycles].  ``run`` is a :class:`ScanProgram`: on a CUDA
    device it replays a captured cycle unless ``graph=False``."""
    device = ref.s.device
    T = n_steps + 1
    ref32 = _f32_tensors(ref)
    packed = scoring.pack_ref_tables(ref32, _f32_tensors(corridor))
    ref_s_last = scoring.true_path_length(ref32)
    veh32 = _device_veh(veh, device)
    obs_tab, t_obs, poly_tab, t_poly, V, t_full = _obstacle_window_tables(
        obstacles_full, T, device)
    template = _scan_scalar_row(veh32, dt, float(np.float32(desired_speed)),
                                0.0, 5.0, ref_s_last, None, packed[0, 0])
    slots = torch.tensor(_DYNAMIC_SLOTS, device=device)
    flags = scoring._flags((True,) * 5, False, True)
    goal_valid = torch.ones(static_grid.size, dtype=_F32, device=device)
    no_obs = torch.zeros((0, T, scoring._OBS_COLS), dtype=_F32, device=device)
    no_poly = torch.zeros((0, T, 3), dtype=_F32, device=device)
    held = grid_ops.upload_constants(static_grid, device)
    r = replan_offset

    def cycle(carry: ReplanningCarry):
        v_min, v_max, low_vel = grid_ops.velocity_window(
            carry.velocity, veh32.a_max, horizon, low_vel_threshold)
        cl, ca, tl = grid_ops.velocity_keeping_candidates(
            carry.x0_lon, carry.x0_lat, v_min, v_max, low_vel, static_grid)
        obs = no_obs if obs_tab is None else obs_tab[
            :, _table_rows(carry.time_step, T, t_obs, t_full)]
        poly = no_poly if poly_tab is None else poly_tab[
            :, _table_rows(carry.time_step, T, t_poly, t_full)]
        scalars = template.index_copy(0, slots, torch.stack(
            [carry.orientation.to(_F32), low_vel.to(_F32)]))
        costs, _, _ = scorer(scoring.ScorerInputs(
            coeffs_lon=cl, coeffs_lat=ca, traj_len=tl.to(_F32),
            goal_valid=goal_valid, table=packed, obs=obs, poly=poly,
            scalars=scalars, n_steps=n_steps, n_poly_verts=V, flags=flags))
        best = torch.argmin(costs).reshape(1)
        best_cost = torch.gather(costs, 0, best)[0]
        found = torch.isfinite(best_cost)

        pick = lambda x: torch.index_select(x, 0, best)
        ro = kin_ops.rollout(pick(cl), pick(ca), pick(tl), ref32, veh32,
                             carry.orientation, dt, n_steps, low_vel)
        alive = carry.alive & found
        keep = lambda new, old: torch.where(alive, new, old)
        new_carry = ReplanningCarry(
            x0_lon=keep(torch.stack([ro.s[0, r], ro.s_dot[0, r],
                                     ro.s_ddot[0, r]]), carry.x0_lon),
            x0_lat=keep(torch.stack([ro.d[0, r], ro.d_dot[0, r],
                                     ro.d_ddot[0, r]]), carry.x0_lat),
            orientation=keep(ro.theta_gl[0, r], carry.orientation),
            velocity=keep(ro.v[0, r], carry.velocity),
            time_step=torch.where(alive, carry.time_step + r,
                                  carry.time_step),
            alive=alive)
        return new_carry, (found, best_cost, ro.x[0, r], ro.y[0, r])

    return ScanProgram(cycle, n_cycles, device, graph, keep=held)


# ---------------------------------------------------------------------------
# the fleet: F problems, one fleet-scorer launch per cycle
# ---------------------------------------------------------------------------

def make_fleet_scan(scene: FleetScene, static_grid: grid_ops.StaticGrid,
                    dt: float, n_steps: int, replan_offset: int,
                    low_vel_threshold: float, horizon: float,
                    n_cycles: int, mesh=None,
                    longitudinal_mode: str = "velocity_keeping",
                    desired_s=None, s_window=None, w_a: float = 5.0,
                    standstill_lookahead: int = 10,
                    scorer=scoring.score_prepared, candidates=None,
                    graph: bool = True):
    """Fleet replanning scan on the fused fleet scorer.

    Takes a :class:`parallel.fleet.FleetScene` and returns
    ``run(carry: FleetCarry) -> (carry, metrics)``; every cycle launches one
    fleet kernel over all F problems' K candidates, which it builds from the
    carry and ``static_grid`` (``scoring.FleetLatticeInputs``; the counter
    ``fleet_scan.lattice_scorer`` counts the scans built so), and re-rolls
    only the F winners.  Metrics, each with a leading cycle axis, in the JAX
    order: (alive [F], best cost [F] (+inf when dead), x [F], y [F], fleet
    success count, fleet mean cost, kinematically infeasible [F], colliding
    [F], orientation [F], velocity [F]).

    ``longitudinal_mode='stopping'`` samples quintic stop trajectories
    toward per-problem ``s_window`` [F, 2] absolute windows with the
    ``desired_s`` [F] stopping cost (``w_a`` should then be 1.0 --
    reactive_planner.py:376) and goal-behind filtering.  The standstill
    fallback (reactive_planner.py:638-653) runs per problem on the device:
    a blocked member at v ~ 0 freezes its pose at zero velocity and cost 0
    and stays alive.

    ``mesh`` is a ``torch.distributed`` process group over the fleet axis
    (``parallel.mesh``), or None for one process: under a group, ``scene``
    and the carry are this rank's slice (``parallel.mesh.shard_fleet``), and
    the fleet success count, cost sum and found count are summed over the
    group by three one-element ``fleet_all_reduce`` calls per cycle (the JAX
    scan's ``psum``, pallas_fleet.py:335-343); the mean divides by the
    global found count, at least 1.

    ``run`` is a :class:`ScanProgram`: on a CUDA device it replays a
    captured cycle unless ``graph=False``, under a group too (NCCL: the
    warm-up cycle creates the communicator before the capture records the
    three all-reduces; verified only on a world of one, a multi-rank
    capture is unverified); the gloo group of the CPU runs it eagerly, as
    the CPU does every scan.
    """
    stopping = longitudinal_mode == "stopping"
    if longitudinal_mode not in ("velocity_keeping", "stopping"):
        raise ValueError(f"unknown longitudinal mode {longitudinal_mode!r}")
    if stopping and (desired_s is None or s_window is None):
        raise ValueError("stopping mode requires desired_s and s_window")

    device = scene.ref.s.device
    T = n_steps + 1
    F = scene.obs_pose.shape[0]
    ref32 = _f32_tensors(scene.ref)
    packed = scoring.pack_ref_tables(
        ref32, CorridorArrays(scene.corridor_lo.to(_F32),
                              scene.corridor_hi.to(_F32)))
    ref_s_last = true_path_lengths(ref32.s)
    veh32 = _f32_tensors(scene.veh)
    veh_stack = scoring.pack_veh_stack(veh32)

    t_obs = scene.obs_pose.shape[2]
    obs_tab = _with_invalid_row(scoring.obstacle_rows(
        scene.obs_pose, scene.obs_half, scene.obs_valid, scene.obs_radius), 2)
    M = obs_tab.shape[1]
    Mp = scene.poly_verts.shape[1]
    V = scene.poly_verts.shape[3] if Mp else 1
    t_poly = scene.poly_verts.shape[2]
    poly_tab = None
    if Mp:
        poly_tab = _with_invalid_row(torch.cat([
            scene.poly_verts.to(_F32).reshape(F, Mp, t_poly, 2 * V),
            scene.poly_valid.to(_F32)[..., None]], dim=-1), 2)
    no_poly = torch.zeros((F, 0, T, 3), dtype=_F32, device=device)

    if stopping:
        s_win = torch.as_tensor(np.asarray(s_window, np.float32),
                                device=device)
        desired_s_t = torch.as_tensor(np.asarray(desired_s, np.float32),
                                      device=device)
    template = scoring.fleet_scalar_rows(
        veh_stack, 0.0, dt, 0.0, scene.desired_speed, 0.0,
        float(np.float32(w_a)), ref_s_last,
        desired_s_t if stopping else None, packed[:, 0, 0])
    slots = torch.tensor(_DYNAMIC_SLOTS, device=device)
    flags = scoring._flags((True,) * 5, stopping, True)
    inf = torch.full((), np.inf, dtype=_F32, device=device)
    # the kernels read the level's lattice table, the plain version the
    # grid's constants, from ops.grid's cache: the program holds them for as
    # long as its graph reads them
    held = (*grid_ops.upload_constants(static_grid, device),
            scoring.lattice_table(static_grid, device))
    if candidates is None:
        candidates = scoring.lattice_candidates_reference \
            if scorer is scoring.score_prepared_reference \
            else scoring.lattice_candidates
    lookahead = min(standstill_lookahead, n_steps)
    r = replan_offset
    # every cycle scores the lattice form: the fleet kernel builds the
    # candidates from the carry (counted per built scan; replays bypass it)
    profiling.count("fleet_scan.lattice_scorer")

    def cycle(carry: FleetCarry):
        v_min, v_max, low_vel = grid_ops.velocity_window(
            carry.velocity, veh32.a_max, horizon, low_vel_threshold)
        bounds = s_win if stopping else torch.stack([v_min, v_max], dim=1)

        rows = _table_rows(carry.time_step, T, t_obs, t_obs)       # [F, T]
        obs = torch.gather(obs_tab, 2, rows[:, None, :, None].expand(
            F, M, T, scoring._OBS_COLS))
        if poly_tab is None:
            poly = no_poly
        else:
            rows_p = _table_rows(carry.time_step, T, t_poly, t_poly)
            poly = torch.gather(poly_tab, 2, rows_p[:, None, :, None].expand(
                F, Mp, T, 2 * V + 1))
        scalars = template.index_copy(1, slots, torch.stack(
            [carry.orientation.to(_F32), low_vel.to(_F32)], dim=1))
        lattice = scoring.FleetLatticeInputs(
            x0_lon=carry.x0_lon, x0_lat=carry.x0_lat, bounds=bounds,
            grid=static_grid, stopping=stopping, tables=packed, obs=obs,
            poly=poly, scalars=scalars, n_steps=n_steps, n_poly_verts=V,
            flags=flags)
        costs, kin_costs, _ = scorer(lattice)

        best = torch.argmin(costs, dim=1)                          # [F]
        best_cost = torch.gather(costs, 1, best[:, None])[:, 0]
        found = torch.isfinite(best_cost)
        # per-problem rejection statistics from the kernel's two cost rows
        # (kinematic = inf in the stats row; colliding = kinematically
        # feasible but masked out)
        kin_inf = torch.isinf(kin_costs)
        n_kin_infeasible = torch.sum(kin_inf, dim=1).to(torch.int32)
        n_colliding = torch.sum(~kin_inf & torch.isinf(costs),
                                dim=1).to(torch.int32)

        # re-roll ONLY the winners (K = 1 per problem) for the carry update
        cl, ca, tl = candidates(lattice, best[:, None])
        ro = kin_ops.rollout(cl, ca, tl, ref32, veh32, carry.orientation, dt,
                             n_steps, low_vel)
        pick = lambda a: a[:, 0, r]
        new_carry, step_alive, (cost, x, y, theta, v) = advance_fleet(
            carry, found, best_cost,
            torch.stack([pick(ro.s), pick(ro.s_dot), pick(ro.s_ddot)], dim=1),
            torch.stack([pick(ro.d), pick(ro.d_dot), pick(ro.d_ddot)], dim=1),
            pick(ro.theta_gl), pick(ro.v), pick(ro.x), pick(ro.y),
            pick(ro.kappa_gl), ro.v[:, 0, lookahead], r, inf)
        # dead members (incl. pad_fleet padding) drop out of the aggregates
        n_success = torch.sum(step_alive.to(torch.int32))
        cost_sum = torch.sum(torch.where(step_alive, cost, 0.0))
        n_found = n_success
        if mesh is not None:
            n_success = fleet_all_reduce(n_success, mesh)
            cost_sum = fleet_all_reduce(cost_sum, mesh)
            n_found = fleet_all_reduce(
                torch.sum(step_alive.to(torch.int32)), mesh)
        metrics = (step_alive, cost, x, y, n_success,
                   cost_sum / torch.clamp(n_found, min=1),
                   n_kin_infeasible, n_colliding, theta, v)
        return new_carry, metrics

    return ScanProgram(cycle, n_cycles, device, graph, keep=held)


# ---------------------------------------------------------------------------
# the facade scan behind ReactivePlanner.plan_scan
# ---------------------------------------------------------------------------

def make_facade_replanning_scan(ref: frenet_ops.RefPathTables,
                                corridor: CorridorArrays,
                                obstacles_full: ObstacleArrays,
                                veh: kin_ops.VehicleArrays,
                                static_grids, dt: float, n_steps: int,
                                replan_offset: int,
                                low_vel_threshold: float, horizon: float,
                                desired_speed: float,
                                w_a: float, desired_d: float,
                                constraint_flags: tuple, n_cycles: int,
                                longitudinal_mode: str = "velocity_keeping",
                                desired_s: float | None = None,
                                s_window: tuple | None = None,
                                standstill_lookahead: int = 10,
                                boundary=None,
                                continuous: bool = False,
                                corridor_grids: tuple | None = None,
                                scorer=scoring.score_prepared,
                                graph: bool = True):
    """The loop behind ``ReactivePlanner.plan_scan``: ``n_cycles`` fused
    level-escalated planning cycles, none of which reads the device.

    Each cycle regenerates every sampling level's candidate grid on the
    device around the carried state (set_desired_velocity semantics,
    reactive_planner.py:329-335), scores the level union in one scorer
    launch, selects the first-found level's winner
    (``cycle.select_across_levels``), re-rolls only the winner, and records
    its first ``replan_offset`` states -- the reference driver's cyclic
    replanning loop (run_planner.py:61-107).

    The host's ``np.unique`` d-grid union (sampling.py:226) is reproduced by
    masking the appended current-offset sample ``goal_valid=False`` whenever
    it duplicates a base grid value.

    Longitudinal modes (reference sampling.py:253-266): ``velocity_keeping``
    (quartics toward a velocity window derived from the carried speed each
    cycle) and ``stopping`` (quintics toward stop positions sampled from the
    static ``s_window``, the ``desired_s`` cost term, goal-behind
    candidates masked).  Corridor sampling (``corridor_grids``) is
    velocity-keeping only.

    Standstill fallback on the device (reactive_planner.py:638-653,
    :667-713): when the carried velocity is <= 0.05 and either no candidate
    survived or the winner's speed at ``standstill_lookahead`` is <= 0.05,
    the cycle emits the host's exact standstill arrays (position and
    orientation frozen, v = 0, a[1] = -v0/dt, kappa from the carried
    steering curvature, cost 0) and the scan continues.

    ``boundary`` (exact 'segments' road-boundary SAT) and ``continuous``
    (swept-OBB pass, reference :1049-1058) refine the scorer's selection
    (``ops.cycle.refine_cheapest`` over the ``REFINE_WIDTH`` cheapest
    candidates; a cycle needing more re-selections raises after the scan);
    the scorer itself masks kinematics, obstacles and the corridor bands.

    Returns ``run(carry, desired_speed=None) -> (carry, metrics)`` with
    metrics = (found [C], best_cost [C], n_inf_kin [C], n_coll [C],
    states [C, 14, replan_offset + 1] -- CANDIDATE_FIELDS rows for offsets
    0..replan_offset of each cycle's winner, reselections [C] -- winners the
    refinement masked, refine_overflow [C] -- the refinement needed more
    than ``ops.cycle.REFINE_WIDTH`` re-selections).  ``run`` is a
    :class:`ScanProgram`: on a CUDA device it replays a captured cycle
    unless ``graph=False``; a run's ``desired_speed`` (None: the build's) is
    written into the scan's static scalar row before the first cycle.
    """
    device = ref.s.device
    T = n_steps + 1
    n_levels = len(corridor_grids) if corridor_grids is not None \
        else len(static_grids)
    stopping = longitudinal_mode == "stopping"
    if stopping and (desired_s is None or s_window is None):
        raise ValueError("stopping mode requires desired_s and s_window")

    # static union layout: per-level sizes + appended-d-sample positions
    # (corridor mode: CorridorGrid lattices replace the static grids;
    # CorridorSampling has no appended-d union, reference sampling.py:340)
    appended = []
    if corridor_grids is not None:
        if longitudinal_mode != "velocity_keeping":
            raise ValueError("corridor sampling: velocity_keeping only "
                             "(reference sampling.py:340-397)")
        sizes = [cg.size for cg in corridor_grids]
    else:
        sizes = []
        for g in static_grids:
            nd1 = len(g.d_values) + 1
            k_l = len(g.t_values) * g.n_lon * nd1
            sizes.append(k_l)
            appended.append(torch.as_tensor(
                (np.arange(k_l) % nd1) == nd1 - 1, device=device))
    level_ids = torch.as_tensor(np.concatenate(
        [np.full(k, j, np.int32) for j, k in enumerate(sizes)]),
        device=device)
    held = tuple(t for g in corridor_grids or static_grids
                 for t in grid_ops.upload_constants(g, device))
    d_values = [grid_ops.constant(g.d_values, _F32, device)
                for g in static_grids or ()]

    ref32 = _f32_tensors(ref)
    packed = scoring.pack_ref_tables(ref32, _f32_tensors(corridor))
    ref_s_last = scoring.true_path_length(ref32)
    veh32 = _device_veh(veh, device)
    obs_tab, t_obs, poly_tab, t_poly, V, t_full = _obstacle_window_tables(
        obstacles_full, T, device)
    no_obs = torch.zeros((0, T, scoring._OBS_COLS), dtype=_F32, device=device)
    no_poly = torch.zeros((0, T, 3), dtype=_F32, device=device)
    colliding = cycle_ops.exact_refinement(
        None if boundary is None else BoundaryArrays(
            boundary.segments.to(device=device, dtype=_F32),
            boundary.valid.to(device)), continuous)
    half_all = obstacles_full.half_ext.to(device=device, dtype=_F32)
    radius_all = None if obstacles_full.radius is None \
        else obstacles_full.radius.to(device=device, dtype=_F32)
    no_reselections = torch.zeros((), dtype=torch.int64, device=device)
    no_overflow = torch.zeros((), dtype=torch.bool, device=device)

    f32 = lambda x: float(np.float32(x))
    # the scalar row the cycles read; each run writes its desired speed
    scalars_run = _scan_scalar_row(veh32, dt, f32(desired_speed),
                                   f32(desired_d), f32(w_a), ref_s_last,
                                   f32(desired_s) if stopping else None,
                                   packed[0, 0])
    slots = torch.tensor(_DYNAMIC_SLOTS, device=device)
    flags = scoring._flags(constraint_flags, stopping, True)
    if stopping:
        s_lo = torch.full((), f32(s_window[0]), dtype=_F32, device=device)
        s_hi = torch.full((), f32(s_window[1]), dtype=_F32, device=device)
    r = replan_offset
    offsets = torch.arange(r + 1, device=device)
    cv, ck_v, ck, ckd, cy = constraint_flags

    def cycle(carry: FacadeScanCarry):
        v_min, v_max, low_vel = grid_ops.velocity_window(
            carry.velocity, veh32.a_max, horizon, low_vel_threshold)

        cls, cas, tls, gvs = [], [], [], []
        if corridor_grids is not None:
            for cg in corridor_grids:
                cl, ca, tl, gv_l = grid_ops.corridor_candidates(
                    carry.x0_lon, carry.x0_lat, cg)
                cls.append(cl)
                cas.append(ca)
                tls.append(tl)
                gvs.append(gv_l)
        else:
            for g, app, d_g in zip(static_grids, appended, d_values):
                if stopping:
                    cl, ca, tl, gv_goal = grid_ops.stopping_candidates(
                        carry.x0_lon, carry.x0_lat, s_lo, s_hi, low_vel, g)
                else:
                    cl, ca, tl = grid_ops.velocity_keeping_candidates(
                        carry.x0_lon, carry.x0_lat, v_min, v_max, low_vel, g)
                    gv_goal = True
                dup = torch.any(d_g == carry.x0_lat[0])
                gvs.append(~(app & dup) & gv_goal)
                cls.append(cl)
                cas.append(ca)
                tls.append(tl)
        cl = torch.cat(cls)
        ca = torch.cat(cas)
        tl = torch.cat(tls)
        gv = torch.cat(gvs)

        obs = no_obs if obs_tab is None else obs_tab[
            :, _table_rows(carry.time_step, T, t_obs, t_full)]
        poly = no_poly if poly_tab is None else poly_tab[
            :, _table_rows(carry.time_step, T, t_poly, t_full)]
        scalars = scalars_run.index_copy(0, slots, torch.stack(
            [carry.orientation.to(_F32), low_vel.to(_F32)]))
        masked, kin, _ = scorer(scoring.ScorerInputs(
            coeffs_lon=cl, coeffs_lat=ca, traj_len=tl.to(_F32),
            goal_valid=gv.to(_F32), table=packed, obs=obs, poly=poly,
            scalars=scalars, n_steps=n_steps, n_poly_verts=V, flags=flags))

        reselections, overflow = no_reselections, no_overflow
        if colliding is not None:
            window = window_obstacle_arrays(
                obs, None if poly_tab is None else poly, half_all,
                radius_all, V)
            masked, reselections, overflow = refine_cheapest(
                masked, kin, gv, level_ids, n_levels,
                cycle_ops.REFINE_WIDTH,
                lambda idx: kin_ops.rollout(
                    cl[idx], ca[idx], tl[idx], ref32, veh32,
                    carry.orientation, dt, n_steps, low_vel),
                lambda ro: colliding(ro, window, veh32))

        (found, best_idx, best_cost, _stat_level, n_inf_kin,
         n_coll) = cycle_ops.select_across_levels(masked, kin, gv,
                                                  level_ids, n_levels)

        # re-roll ONLY the winner for the recorded states + carry update
        pick = lambda x: torch.index_select(x, 0, best_idx.reshape(1))
        ro = kin_ops.rollout(
            pick(cl), pick(ca), pick(tl), ref32, veh32, carry.orientation,
            dt, n_steps, low_vel, check_velocity=cv, check_acceleration=ck_v,
            check_kappa=ck, check_kappa_dot=ckd, check_yaw_rate=cy)
        states = torch.stack([getattr(ro, f)[0, :r + 1]
                              for f in CANDIDATE_FIELDS])     # [14, r+1]

        # on-device standstill fallback (reactive_planner.py:638-653):
        # engaged at v ~ 0 when nothing was found OR the winner stays slow
        # at the lookahead step -- replaces the winner with the host's exact
        # standstill arrays (:667-713) at cost 0
        still = standstill(carry.velocity, found,
                           ro.v[0, standstill_lookahead])
        fill = lambda v: v.reshape(1).expand(r + 1)
        s0 = carry.x0_lon[0]
        idx0 = frenet_ops.interp_index(ref32, s0[None])
        theta_ref = frenet_ops.interpolate_angle_at(ref32, s0[None], idx0)[0]
        zeros = torch.zeros((r + 1,), dtype=_F32, device=device)
        ss_states = torch.stack([
            fill(s0), fill(carry.x0_lon[1]), fill(carry.x0_lon[2]),
            fill(carry.x0_lat[0]), fill(carry.x0_lat[1]),
            fill(carry.x0_lat[2]),
            fill(carry.orientation - theta_ref),          # theta_cl
            fill(carry.px), fill(carry.py),
            fill(carry.orientation),
            zeros,                                        # v = 0
            torch.where(offsets == 1, -carry.velocity / dt, zeros),
            fill(carry.kappa),
            zeros])                                       # kappa_dot = 0
        states = torch.where(still, ss_states, states)
        best_cost = torch.where(still, 0.0, best_cost)
        found = found | still

        step_alive = carry.alive & found
        keep = lambda new, old: torch.where(step_alive, new, old)
        new_carry = FacadeScanCarry(
            x0_lon=keep(states[0:3, r], carry.x0_lon),
            x0_lat=keep(states[3:6, r], carry.x0_lat),
            orientation=keep(states[9, r], carry.orientation),
            velocity=keep(states[10, r], carry.velocity),
            time_step=torch.where(step_alive, carry.time_step + r,
                                  carry.time_step),
            alive=step_alive,
            kappa=keep(states[12, r], carry.kappa),
            px=keep(states[7, r], carry.px),
            py=keep(states[8, r], carry.py))
        return new_carry, (step_alive, best_cost, n_inf_kin, n_coll, states,
                           reselections, overflow)

    def prepare(desired_speed_val: float | None = None):
        # the desired speed varies per run (velocity-tracking missions)
        # without rebuilding the scan: a fill, not a host copy
        scalars_run[scoring._S_DESIRED_V].fill_(f32(
            desired_speed if desired_speed_val is None
            else desired_speed_val))

    return ScanProgram(cycle, n_cycles, device, graph, keep=held,
                       prepare=prepare)
