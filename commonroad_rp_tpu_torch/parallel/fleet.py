"""Fleet planning: many independent planning problems replanned in lockstep.

Counterpart of ``commonroad_rp_tpu/parallel/fleet.py``: ``FleetScene``
(per-problem scene tables with a leading fleet axis F), ``FleetCarry``
(per-problem planner state between cycles), ``pad_fleet``,
``build_fleet_scene`` and ``problem_from_planner_setup`` (host-side numpy
assembly, each leaf uploaded once to the fleet's device), the XLA fleet
path: ``_single_problem_cycle``, ``make_fleet_step`` and
``make_fleet_rollout``, and the rules that every device cycle of the port
takes from here: the obstacle window (``window_rows``), each route's true
end (``true_path_lengths``), the standstill rule (``standstill``) and,
for both fleet paths, the advance along the winners (``advance_fleet``).

The XLA fleet path evaluates every candidate of every problem densely --
grid generation, then ``ops.dense_rollout``: the K-wide rollout, the cost
and the corridor test (on the card one launch of ``dense_rollout_kernel``,
elsewhere the plain passes of ``kinematics.rollout``, ``cost.default_cost``
and ``check_corridor``), then one launch of the fleet form of the collision
kernel on its poses -- and advances ``replan_offset`` steps along each
problem's optimum (on the card ``dense_winner_kernel`` gives the optimum's
states).  ``jax.vmap`` over problems becomes one batched program
over the leading axis; ``shard_map`` over the fleet mesh becomes one process
per slice of the fleet (``parallel.mesh.shard_fleet``), whose three per-cycle
aggregates are summed by ``parallel.mesh.fleet_all_reduce``; the jitted
``lax.scan`` becomes an ``ops.program.ScanProgram``: one cycle captured as a
CUDA graph on the card and replayed once per cycle, with the carry and the
scene in static buffers (eager on the CPU and with ``graph=False``).  The
fleet replanning loop on the fused fleet scorer is
``parallel.replanning_scan.make_fleet_scan``.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from commonroad_rp_tpu_torch.ops import collision as collision_ops
from commonroad_rp_tpu_torch.ops import dense_rollout as dense_ops
from commonroad_rp_tpu_torch.ops import frenet as frenet_ops
from commonroad_rp_tpu_torch.ops import grid as grid_ops
from commonroad_rp_tpu_torch.ops import kinematics as kin_ops
from commonroad_rp_tpu_torch.ops.program import ScanProgram, StaticBuffers
from commonroad_rp_tpu_torch.parallel.mesh import fleet_all_reduce


class FleetScene(NamedTuple):
    """Stacked per-problem scene tables (leading fleet axis F on every leaf)."""

    ref: frenet_ops.RefPathTables          # leaves [F, P, ...]
    obs_pose: torch.Tensor                 # [F, M, T_scene, 3]
    obs_half: torch.Tensor                 # [F, M, 2]
    obs_valid: torch.Tensor                # [F, M, T_scene] bool
    obs_radius: torch.Tensor               # [F, M] disc radius (0 = OBB row)
    poly_verts: torch.Tensor               # [F, Mp, T_scene, V, 2] (Mp may be 0)
    poly_valid: torch.Tensor               # [F, Mp, T_scene] bool
    corridor_lo: torch.Tensor              # [F, P] drivable band lower offset
    corridor_hi: torch.Tensor              # [F, P] drivable band upper offset
    desired_speed: torch.Tensor            # [F]
    veh: kin_ops.VehicleArrays             # leaves [F] (per-problem vehicles)


class FleetCarry(NamedTuple):
    """Scan carry: per-problem planner state between cycles.

    ``kappa``/``px``/``py`` (curvature tan(delta)/L and Cartesian rear-axle
    position) feed the on-device standstill fallback of both fleet paths
    (``advance_fleet``, reactive_planner.py:638-653)."""

    x0_lon: torch.Tensor                   # [F, 3] (s, s_dot, s_ddot)
    x0_lat: torch.Tensor                   # [F, 3] (d, d_dot, d_ddot)
    orientation: torch.Tensor              # [F]
    velocity: torch.Tensor                 # [F]
    time_step: torch.Tensor                # [F] int32
    alive: torch.Tensor                    # [F] bool (False once planning fails)
    kappa: torch.Tensor                    # [F] current curvature tan(delta)/L
    px: torch.Tensor                       # [F] cartesian x (rear axle)
    py: torch.Tensor                       # [F] cartesian y (rear axle)


class CycleMetrics(NamedTuple):
    """Per-cycle outputs of the XLA fleet path, stacked over cycles by
    ``make_fleet_rollout``.  The first six fields are the JAX package's;
    ``orientation``/``velocity`` (the selected next heading and speed, as the
    fused fleet scan's metrics carry them) feed the host-side goal check of
    ``run_fleet --xla``."""

    found: torch.Tensor                    # [F] bool
    best_cost: torch.Tensor                # [F]
    x: torch.Tensor                        # [F] selected next x position
    y: torch.Tensor                        # [F]
    fleet_success: torch.Tensor            # scalar: sum of found over the fleet
    fleet_mean_cost: torch.Tensor          # scalar
    orientation: Optional[torch.Tensor] = None   # [F]
    velocity: Optional[torch.Tensor] = None      # [F]


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def window_rows(time_step: torch.Tensor, T: int, n_rows: int,
                t_full: int):
    """The obstacle window of every device cycle: the rows [..., T] of a
    table of ``n_rows`` steps that ``dynamic_slice_in_dim(table, time_step,
    T)`` reads (the start clamped to [0, n_rows - T]), and the mask [..., T]
    of the steps inside the prediction span (the unclamped step ``time_step
    + t`` below ``t_full``).  A clamped window past the span would repeat
    stale poses: those steps are invalid."""
    ts = time_step.to(torch.int64)[..., None]
    ar = torch.arange(T, device=ts.device)
    return torch.clamp(ts, 0, n_rows - T) + ar, ts + ar < t_full


def true_path_lengths(ref_s: torch.Tensor) -> torch.Tensor:
    """Each problem's route end [F] from the fleet's arclength tables
    [F, P]: the largest arclength below the sentinel band that
    ``build_fleet_scene`` pads the shorter routes with (1e6 apart).  The
    XLA fleet cycle and the fused fleet scan end every route there, as
    ``plan()`` does."""
    return torch.max(torch.where(
        ref_s < ref_s[:, :1] + 5e5, ref_s, torch.full_like(ref_s, -np.inf)),
        dim=1).values


def standstill(velocity, found, v_lookahead):
    """The device standstill rule (reactive_planner.py:638-653): at v ~ 0
    with nothing found, or a winner still slow at the lookahead step, the
    cycle plans the standstill trajectory instead."""
    return (velocity <= 0.05) & (~found | (v_lookahead <= 0.05))


def advance_fleet(carry: FleetCarry, found, best_cost, lon, lat,
                  orientation, velocity, x, y, kappa, v_lookahead,
                  replan_offset: int, inf: torch.Tensor):
    """Advance every member ``replan_offset`` steps along its winner, whose
    states at that step are ``lon``/``lat`` [F, 3] and ``orientation``,
    ``velocity``, ``x``, ``y``, ``kappa`` [F], and ``v_lookahead`` [F] its
    speed at the standstill lookahead step (run_planner.py:94-107).  A
    member under the :func:`standstill` rule keeps its pose at v = 0 and
    cost 0 and stays alive; a member that found nothing else dies and
    keeps its carry.  Returns (the new carry, step_alive [F], (cost [F],
    ``inf`` (a 0-d +inf) for dead members, so that fleet aggregates count
    live problems only; x, y, orientation, velocity [F]))."""
    still = standstill(carry.velocity, found, v_lookahead)
    sel = lambda cond, a, b: torch.where(
        cond.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)
    lon = sel(still, carry.x0_lon, lon)
    lat = sel(still, carry.x0_lat, lat)
    orientation = torch.where(still, carry.orientation, orientation)
    velocity = torch.where(still, 0.0, velocity)
    x = torch.where(still, carry.px, x)
    y = torch.where(still, carry.py, y)
    kappa = torch.where(still, carry.kappa, kappa)
    best_cost = torch.where(still, 0.0, best_cost)
    step_alive = carry.alive & (found | still)
    keep = lambda new, old: sel(step_alive, new, old)
    new_carry = FleetCarry(
        x0_lon=keep(lon, carry.x0_lon), x0_lat=keep(lat, carry.x0_lat),
        orientation=keep(orientation, carry.orientation),
        velocity=keep(velocity, carry.velocity),
        time_step=torch.where(step_alive, carry.time_step + replan_offset,
                              carry.time_step),
        alive=step_alive, kappa=keep(kappa, carry.kappa),
        px=keep(x, carry.px), py=keep(y, carry.py))
    return new_carry, step_alive, (
        torch.where(step_alive, best_cost, inf), x, y, orientation,
        velocity)


def dense_inputs(carry: FleetCarry, scene: FleetScene,
                 veh: kin_ops.VehicleArrays, *,
                 static_grid: grid_ops.StaticGrid, low_vel_threshold: float,
                 horizon: float) -> dense_ops.DenseInputs:
    """One cycle's candidate pass operands (``ops.dense_rollout``) from the
    carry, the scene and the vehicles ([F] leaves), each with the leading
    problem axis F: the velocity window, the velocity-keeping grid around
    each problem's carried state and each route's true end."""
    v_min, v_max, low_vel = grid_ops.velocity_window(
        carry.velocity, veh.a_max, horizon, low_vel_threshold)
    coeffs_lon, coeffs_lat, traj_len = grid_ops.velocity_keeping_candidates(
        carry.x0_lon, carry.x0_lat, v_min, v_max, low_vel, static_grid)
    return dense_ops.DenseInputs(
        coeffs_lon.contiguous(), coeffs_lat.contiguous(),
        traj_len.contiguous(), scene.ref,
        kin_ops.VehicleArrays(*(x.contiguous() for x in veh)),
        carry.orientation.contiguous(), low_vel,
        true_path_lengths(scene.ref.s), scene.desired_speed.contiguous(),
        scene.corridor_lo, scene.corridor_hi)


def _single_problem_cycle(carry: FleetCarry, scene: FleetScene,
                          veh: kin_ops.VehicleArrays, *,
                          static_grid: grid_ops.StaticGrid, dt: float,
                          n_steps: int, replan_offset: int,
                          low_vel_threshold: float, horizon: float):
    """One planning cycle for every problem of the fleet (or of this rank's
    slice) at once: the JAX function under ``jax.vmap``, as one batched
    program over the leading problem axis F of the carry, the scene and
    the vehicles ``veh`` ([F] leaves).

    The standstill fallback (reactive_planner.py:638-653) runs on the
    device (:func:`advance_fleet`).  Every route ends at its true length
    (``true_path_lengths``): the projection domain and the corridor's
    probes stop there, not in the padding past it.  Returns (the new
    carry, (found, best cost, x, y, orientation, velocity)), each [F]."""
    inputs = dense_inputs(carry, scene, veh, static_grid=static_grid,
                          low_vel_threshold=low_vel_threshold,
                          horizon=horizon)
    # rollout, constraint checks, projection domain, cost and corridor test
    # of every candidate: one kernel on the card, the plain passes elsewhere
    dense = dense_ops.dense_rollout(inputs, dt, n_steps)

    # obstacle windows starting at each problem's current scenario step
    # (the four tables share their span), invalid past the span
    F, _, n = scene.obs_pose.shape[:3]
    T = n_steps + 1
    rows, in_span = window_rows(carry.time_step, T, n, n)       # [F, T]
    in_span = in_span[:, None, :]
    window = lambda table: torch.gather(table, 2, rows.reshape(
        (F, 1, T) + (1,) * (table.dim() - 3)).expand(
        (F, table.shape[1], T) + tuple(table.shape[3:])))
    box = collision_ops.ObstacleArrays(
        pose=window(scene.obs_pose).contiguous(),
        half_ext=scene.obs_half.contiguous(),
        valid=(window(scene.obs_valid) & in_span).contiguous(),
        radius=scene.obs_radius.contiguous())
    collides = collision_ops.obb_collision_fleet(
        dense.cx, dense.cy, dense.theta, box,
        collision_ops.per_problem_vector(veh.half_length, dense.theta),
        collision_ops.per_problem_vector(veh.half_width, dense.theta))
    if scene.poly_verts.shape[1] > 0:
        collides = collides | collision_ops._poly_obb_overlap_fleet(
            window(scene.poly_verts).transpose(1, 2),
            (window(scene.poly_valid) & in_span).transpose(1, 2),
            dense.cx, dense.cy, torch.cos(dense.theta),
            torch.sin(dense.theta),
            collision_ops._per_problem(veh.half_length, dense.theta),
            collision_ops._per_problem(veh.half_width, dense.theta))
    collides = collides | dense.corridor

    ok = dense.feasible & ~collides
    inf = torch.full((), np.inf, dtype=dense.cost.dtype,
                     device=dense.cost.device)
    masked = torch.where(ok, dense.cost, inf)
    best = torch.argmin(masked, dim=1)                             # [F]
    found = torch.any(ok, dim=1)

    # the optimum's states at step replan_offset (curvilinear carry from
    # the trajectory arrays as in run_planner.py:85) and its speed at the
    # standstill lookahead step (10, reactive_planner.py)
    states = dense_ops.dense_winner(inputs, dense, best, dt, n_steps,
                                    replan_offset, min(10, n_steps))
    new_carry, step_alive, (cost, x, y, theta, v) = advance_fleet(
        carry, found, masked[torch.arange(F, device=best.device), best],
        states[:, 0:3], states[:, 3:6], *states[:, 6:].unbind(dim=1),
        replan_offset, inf)
    return new_carry, (step_alive, cost, x, y, theta, v)


def make_fleet_step(group, veh: Optional[kin_ops.VehicleArrays],
                    static_grid: grid_ops.StaticGrid, dt: float, n_steps: int,
                    replan_offset: int, low_vel_threshold: float,
                    horizon: float, device="cuda"):
    """The one-cycle fleet step: ``step(carry: FleetCarry, scene: FleetScene)
    -> (FleetCarry, CycleMetrics)``.

    Vehicle parameters come from scene.veh ([F] leaves: heterogeneous
    fleets); ``veh``, if given, overrides them with one shared parameter set
    (floats or 0-d tensors).  ``group`` is a ``torch.distributed`` process
    group over the fleet axis (``parallel.mesh``), or None for one process:
    under a group, ``carry`` and ``scene`` are this rank's slice
    (``parallel.mesh.shard_fleet``), and the three fleet aggregates (success
    count, cost sum, finite count: ``psum`` in the JAX package) are three
    one-element ``fleet_all_reduce`` calls.  The grid's constants are
    uploaded to ``device`` here, before any cycle.
    """
    grid_ops.upload_constants(static_grid, torch.device(device))

    def step(carry: FleetCarry, scene: FleetScene):
        # one shared parameter set as [F] leaves (fills: no host-to-device
        # copy inside a cycle)
        veh_f = scene.veh if veh is None else kin_ops.VehicleArrays(*(
            collision_ops.per_problem_vector(x, carry.velocity)
            for x in veh))
        new_carry, (found, best_cost, x, y, theta, v) = _single_problem_cycle(
            carry, scene, veh_f, static_grid=static_grid, dt=dt,
            n_steps=n_steps, replan_offset=replan_offset,
            low_vel_threshold=low_vel_threshold, horizon=horizon)
        n_success = torch.sum(found.to(torch.int32))
        finite = torch.isfinite(best_cost)
        cost_sum = torch.sum(torch.where(finite, best_cost, 0.0))
        n_finite = torch.sum(finite.to(torch.int32))
        if group is not None:
            # fleet-level aggregates over the ranks of the fleet axis
            n_success = fleet_all_reduce(n_success, group)
            cost_sum = fleet_all_reduce(cost_sum, group)
            n_finite = fleet_all_reduce(n_finite, group)
        mean_cost = cost_sum / torch.clamp(n_finite, min=1)
        metrics = CycleMetrics(found=found, best_cost=best_cost, x=x, y=y,
                               fleet_success=n_success,
                               fleet_mean_cost=mean_cost, orientation=theta,
                               velocity=v)
        return new_carry, metrics

    return step


def make_fleet_rollout(group, veh: Optional[kin_ops.VehicleArrays],
                       static_grid: grid_ops.StaticGrid, dt: float,
                       n_steps: int, replan_offset: int,
                       low_vel_threshold: float, horizon: float,
                       n_cycles: int, device="cuda", graph: bool = True):
    """The full replanning loop: ``run(carry, scene) -> (carry,
    CycleMetrics)`` runs ``n_cycles`` fleet steps (:func:`make_fleet_step`)
    and returns each metric with a leading cycle axis, as ``lax.scan``
    does.

    ``run`` is an ``ops.program.ScanProgram``: every call copies the
    caller's carry and scene into static buffers (a scene or carry whose
    field differs in shape or dtype from the first call's raises
    ``ValueError``), and each cycle writes its metrics at a device-side
    cycle counter.  On a CUDA device the first call captures one cycle as a
    CUDA graph and every call replays it ``n_cycles`` times, under a
    ``group`` too (NCCL: the three all-reduces are recorded in the graph;
    verified only on a world of one, a multi-rank capture is unverified);
    ``graph=False``, and the CPU whatever ``graph`` says, run the same
    cycles eagerly.  A capture or a replay that fails raises."""
    step = make_fleet_step(group, veh, static_grid, dt, n_steps,
                           replan_offset, low_vel_threshold, horizon, device)
    scene = StaticBuffers("scene", device)
    return ScanProgram(lambda carry: step(carry, scene.value), n_cycles,
                       device, graph,
                       keep=grid_ops.upload_constants(static_grid, device),
                       prepare=scene.load)


def pad_fleet(scene: FleetScene, carry: FleetCarry,
              n_devices: int) -> Tuple[FleetScene, FleetCarry, int]:
    """Pad the fleet axis to a multiple of ``n_devices`` with DEAD members.

    Uneven fleets are padded by repeating the final problem with
    ``alive=False``: padded members freeze immediately and report
    found=False / +inf cost, so per-cycle aggregates cover exactly the real
    fleet.  Returns (scene, carry, original_F); slice metrics back with
    [:original_F]."""
    F = int(carry.alive.shape[0])
    pad = (-F) % n_devices
    if pad == 0:
        return scene, carry, F
    rep = lambda a: torch.cat([a, a[-1:].repeat_interleave(pad, dim=0)],
                              dim=0)
    scene_p = FleetScene(
        ref=frenet_ops.RefPathTables(*(rep(x) for x in scene.ref)),
        **{name: rep(getattr(scene, name)) for name in FleetScene._fields
           if name not in ("ref", "veh")},
        veh=kin_ops.VehicleArrays(*(rep(x) for x in scene.veh)))
    carry_p = carry._replace(
        **{name: rep(getattr(carry, name)) for name in FleetCarry._fields
           if name != "alive"},
        alive=torch.cat([carry.alive,
                         torch.zeros(pad, dtype=torch.bool,
                                     device=carry.alive.device)]))
    return scene_p, carry_p, F


def build_fleet_scene(problems: List[dict], n_steps: int,
                      dtype=torch.float32,
                      device="cuda") -> Tuple[FleetScene, FleetCarry]:
    """Stack per-problem scene tables and initial carries with padding.

    ``problems`` entries carry: 'ref_tables' (RefPathTables), 'obstacles'
    (ObstacleArrays over the FULL scenario span + horizon padding),
    'corridor' (CorridorArrays), 'x0_lon', 'x0_lat', 'orientation',
    'velocity', 'desired_speed', 'time_step', optionally 'vehicle',
    'kappa', 'px', 'py'.  Padding: reference paths to the longest with
    arclength sentinels 1e6 apart along the final tangent, obstacles to the
    most with invalid rows, polygons to the most pieces and vertices.
    """
    F = len(problems)
    P_max = max(p["ref_tables"].s.shape[0] for p in problems)
    M_max = max(max(p["obstacles"].pose.shape[0], 1) for p in problems)
    T_max = max(p["obstacles"].pose.shape[1] if p["obstacles"].pose.shape[0]
                else n_steps + 1 for p in problems)
    up = lambda a, dt=dtype: torch.as_tensor(np.asarray(a), dtype=dt,
                                             device=device)

    def pad_ref(tables: frenet_ops.RefPathTables):
        leaves = {f: _host(getattr(tables, f)).astype(np.float64)
                  for f in frenet_ops.RefPathTables._fields}
        n = leaves["s"].shape[0]
        pad = P_max - n
        if pad == 0:
            return leaves
        # extend the arclength monotonically so searchsorted stays correct;
        # padded vertices continue the final tangent direction
        extra_s = leaves["s"][-1] + np.arange(1, pad + 1) * 1e6
        extra_pts = leaves["points"][-1] + np.outer(
            np.arange(1, pad + 1) * 1e6, leaves["tangent"][-1])
        rep = lambda a: np.concatenate([a, np.repeat(a[-1:], pad, axis=0)])
        return dict(points=np.concatenate([leaves["points"], extra_pts]),
                    s=np.concatenate([leaves["s"], extra_s]),
                    theta=rep(leaves["theta"]), curv=rep(leaves["curv"]),
                    curv_d=rep(leaves["curv_d"]),
                    curv_dd=rep(leaves["curv_dd"]),
                    tangent=rep(leaves["tangent"]),
                    normal=rep(leaves["normal"]))

    refs = [pad_ref(p["ref_tables"]) for p in problems]
    ref_stacked = frenet_ops.RefPathTables(
        *[up(np.stack([r[f] for r in refs]))
          for f in frenet_ops.RefPathTables._fields])

    def pad_obstacles(obs: collision_ops.ObstacleArrays):
        M = obs.pose.shape[0]
        T = obs.pose.shape[1] if M else 0
        pose = np.zeros((M_max, T_max, 3))
        half = np.ones((M_max, 2))
        valid = np.zeros((M_max, T_max), dtype=bool)
        radius = np.zeros(M_max)
        if M:
            pose[:M, :T] = _host(obs.pose)
            half[:M] = _host(obs.half_ext)
            valid[:M, :T] = _host(obs.valid)
            if obs.radius is not None:
                radius[:M] = _host(obs.radius)
        return pose, half, valid, radius

    obs = [pad_obstacles(p["obstacles"]) for p in problems]

    # polygon group: pad every problem to (Mp_max, V_max) with invalid
    # pieces / repeated final vertices (degenerate edges never separate)
    Mp_max = max((p["obstacles"].poly_verts.shape[0]
                  if p["obstacles"].poly_verts is not None else 0)
                 for p in problems)
    V_max = max((p["obstacles"].poly_verts.shape[2]
                 if p["obstacles"].poly_verts is not None else 1)
                for p in problems)
    poly_verts = np.zeros((F, Mp_max, T_max, V_max, 2))
    poly_valid = np.zeros((F, Mp_max, T_max), dtype=bool)
    for f, p in enumerate(problems):
        pv = p["obstacles"].poly_verts
        if pv is None:
            continue
        pv = _host(pv)
        mp, t_p, v_p = pv.shape[0], pv.shape[1], pv.shape[2]
        padded = np.concatenate(
            [pv, np.repeat(pv[:, :, -1:, :], V_max - v_p, axis=2)], axis=2)
        poly_verts[f, :mp, :t_p] = padded
        poly_valid[f, :mp, :t_p] = _host(p["obstacles"].poly_valid)

    def pad_corridor(c: collision_ops.CorridorArrays):
        n = c.d_lo.shape[0]
        lo = np.full(P_max, -1e4)
        hi = np.full(P_max, 1e4)
        lo[:n] = _host(c.d_lo)
        hi[:n] = _host(c.d_hi)
        return lo, hi

    corrs = [pad_corridor(p["corridor"]) for p in problems]

    # per-problem vehicle parameter stacks (heterogeneous fleets); problems
    # without an explicit 'vehicle' entry default to the BMW 320i set
    from commonroad_rp_tpu_torch.utils.config import VehicleConfiguration

    veh_rows = []
    for p in problems:
        cfg = p.get("vehicle") or VehicleConfiguration()
        veh_rows.append([cfg.wheelbase, cfg.wb_rear_axle, cfg.a_max,
                         cfg.v_switch, np.tan(cfg.delta_max) / cfg.wheelbase,
                         cfg.v_delta_max, 0.5 * cfg.length, 0.5 * cfg.width])
    veh_mat = np.asarray(veh_rows, dtype=np.float64)

    scene = FleetScene(
        ref=ref_stacked,
        obs_pose=up(np.stack([o[0] for o in obs])),
        obs_half=up(np.stack([o[1] for o in obs])),
        obs_valid=up(np.stack([o[2] for o in obs]), torch.bool),
        obs_radius=up(np.stack([o[3] for o in obs])),
        poly_verts=up(poly_verts), poly_valid=up(poly_valid, torch.bool),
        corridor_lo=up(np.stack([c[0] for c in corrs])),
        corridor_hi=up(np.stack([c[1] for c in corrs])),
        desired_speed=up([p["desired_speed"] for p in problems]),
        veh=kin_ops.VehicleArrays(*[up(veh_mat[:, i]) for i in range(8)]))
    carry = FleetCarry(
        x0_lon=up(np.stack([_host(p["x0_lon"]) for p in problems])),
        x0_lat=up(np.stack([_host(p["x0_lat"]) for p in problems])),
        orientation=up([p["orientation"] for p in problems]),
        velocity=up([p["velocity"] for p in problems]),
        time_step=up([p.get("time_step", 0) for p in problems], torch.int32),
        alive=torch.ones(F, dtype=torch.bool, device=device),
        kappa=up([p.get("kappa", 0.0) for p in problems]),
        px=up([p.get("px", 0.0) for p in problems]),
        py=up([p.get("py", 0.0) for p in problems]))
    return scene, carry


def problem_from_planner_setup(scenario, planning_problem, reference_path,
                               n_steps: int, horizon_pad: int,
                               dtype=torch.float32, vehicle=None,
                               device="cpu") -> dict:
    """Build one fleet-problem dict from scenario data (host, once).

    ``vehicle``: optional VehicleConfiguration for heterogeneous fleets
    (defaults to the BMW 320i parameter set, config.py:198).
    """
    from commonroad_rp_tpu_torch.models.state import ReactivePlannerState
    from commonroad_rp_tpu_torch.utils.config import VehicleConfiguration
    from commonroad_rp_tpu_torch.utils.coordinate_system import \
        CoordinateSystem
    from commonroad_rp_tpu_torch.utils.general import \
        retrieve_desired_velocity_from_pp

    veh_cfg = vehicle or VehicleConfiguration()
    co = CoordinateSystem(reference_path, dtype=dtype, device=device)
    x_0 = ReactivePlannerState.create_from_initial_state(
        planning_problem.initial_state, veh_cfg.wheelbase,
        veh_cfg.wb_rear_axle)

    low_vel = x_0.velocity < 4.0
    x0_lon, x0_lat = co.compute_initial_curvilinear_states(
        x_0.position, x_0.orientation, x_0.velocity, x_0.acceleration or 0.0,
        x_0.steering_angle or 0.0, veh_cfg.wheelbase, low_vel)

    # scenario span: last dynamic-obstacle prediction step + horizon padding
    last_step = 0
    for obstacle in scenario.dynamic_obstacles:
        if obstacle.trajectory:
            last_step = max(last_step, obstacle.trajectory[-1].time_step)
    span = last_step + horizon_pad + n_steps + 1
    obstacles = collision_ops.compile_obstacles(scenario, 0, span - 1, 1,
                                                dtype=dtype, device=device)
    boundary = collision_ops.compile_road_boundary(scenario, dtype=dtype,
                                                   device=device)
    corridor = collision_ops.compile_corridor(boundary, co.tables,
                                              dtype=dtype, device=device)
    return dict(ref_tables=co.tables, obstacles=obstacles, boundary=boundary,
                corridor=corridor, vehicle=veh_cfg,
                x0_lon=np.asarray(x0_lon), x0_lat=np.asarray(x0_lat),
                orientation=x_0.orientation, velocity=x_0.velocity,
                time_step=0,
                desired_speed=retrieve_desired_velocity_from_pp(
                    planning_problem),
                kappa=float(np.tan(x_0.steering_angle or 0.0)
                            / veh_cfg.wheelbase),
                px=float(x_0.position[0]), py=float(x_0.position[1]))
