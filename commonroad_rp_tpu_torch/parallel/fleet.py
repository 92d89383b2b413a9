"""Fleet planning: many independent planning problems replanned in lockstep.

Counterpart of ``commonroad_rp_tpu/parallel/fleet.py``: ``FleetScene``
(per-problem scene tables with a leading fleet axis F), ``FleetCarry``
(per-problem planner state between cycles), ``pad_fleet``,
``build_fleet_scene`` and ``problem_from_planner_setup`` (host-side numpy
assembly, each leaf uploaded once to the fleet's device), and the XLA fleet
path: ``_single_problem_cycle``, ``make_fleet_step`` and
``make_fleet_rollout``.

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
    position) feed the fleet scan's on-device standstill fallback
    (reactive_planner.py:638-653)."""

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


def _window(table: torch.Tensor, time_step: torch.Tensor, T: int):
    """``dynamic_slice_in_dim(table, time_step, T, axis=1)`` per problem
    over [F, M, T_scene, ...] tables (the start clamped to [0, T_scene - T])
    and the mask [F, 1, T] of window steps inside the span (``time_step + t
    < T_scene``): one gather, no device read."""
    F, M, n = table.shape[:3]
    ts = time_step.to(torch.int64)[:, None]                    # [F, 1]
    ar = torch.arange(T, device=table.device)
    rows = torch.clamp(ts, 0, n - T) + ar                      # [F, T]
    index = rows.reshape((F, 1, T) + (1,) * (table.dim() - 3)).expand(
        (F, M, T) + tuple(table.shape[3:]))
    return torch.gather(table, 2, index), ((ts + ar) < n)[:, None, :]


def true_path_lengths(ref_s: torch.Tensor) -> torch.Tensor:
    """Each problem's route end [F] from the fleet's arclength tables
    [F, P]: the largest arclength below the sentinel band that
    ``build_fleet_scene`` pads the shorter routes with (1e6 apart).  The
    XLA fleet cycle and the fused fleet scan end every route there, as
    ``plan()`` does."""
    return torch.max(torch.where(
        ref_s < ref_s[:, :1] + 5e5, ref_s, torch.full_like(ref_s, -np.inf)),
        dim=1).values


def dense_inputs(carry_lon, carry_lat, orientation, velocity,
                 ref: frenet_ops.RefPathTables, corridor_lo, corridor_hi,
                 desired_speed, veh: kin_ops.VehicleArrays, *,
                 static_grid: grid_ops.StaticGrid, low_vel_threshold: float,
                 horizon: float) -> dense_ops.DenseInputs:
    """One cycle's candidate pass operands (``ops.dense_rollout``) from the
    carry and the scene, each with the leading problem axis F: the
    velocity window (reactive_planner.py:332-334), the velocity-keeping
    grid around each problem's carried state and each route's true end."""
    v_min = torch.clamp(velocity - 0.125 * horizon * veh.a_max, min=0.0)
    v_max = torch.maximum(v_min + 5.0, velocity + 2.0)
    low_vel = velocity < low_vel_threshold
    coeffs_lon, coeffs_lat, traj_len = grid_ops.velocity_keeping_candidates(
        carry_lon, carry_lat, v_min, v_max, low_vel, static_grid)
    return dense_ops.DenseInputs(
        coeffs_lon.contiguous(), coeffs_lat.contiguous(),
        traj_len.contiguous(), ref,
        kin_ops.VehicleArrays(*(x.contiguous() for x in veh)),
        orientation.contiguous(), low_vel, true_path_lengths(ref.s),
        desired_speed.contiguous(), corridor_lo, corridor_hi)


def _single_problem_cycle(carry_lon, carry_lat, orientation, velocity,
                          time_step, alive,
                          ref: frenet_ops.RefPathTables,
                          obs_pose, obs_half, obs_valid, obs_radius,
                          poly_verts, poly_valid,
                          corridor_lo, corridor_hi, desired_speed,
                          veh: kin_ops.VehicleArrays,
                          kappa=None, px=None, py=None,
                          *, static_grid: grid_ops.StaticGrid,
                          dt: float, n_steps: int, replan_offset: int,
                          low_vel_threshold: float, horizon: float,
                          standstill_lookahead: int = 10):
    """One planning cycle for every problem of the fleet (or of this rank's
    slice) at once: the JAX function under ``jax.vmap``, as one batched
    program over the leading problem axis F.

    Every argument carries that axis (carry [F, 3] / [F], scene tables
    [F, ...], vehicle leaves [F]).  With ``kappa``/``px``/``py`` given (the
    FleetCarry pose fields), the standstill fallback (reactive_planner.py:
    638-653) engages on device: at v ~ 0 with no feasible candidate (or a
    winner still slow at the lookahead step) the member freezes its pose at
    v = 0 / cost 0 and stays alive.  Without them failure deadens the
    member.  Every route ends at its true length (``true_path_lengths``):
    the projection domain and the corridor's probes stop there, not in the
    padding past it.  Returns (carry fields, (found, best cost, x, y,
    orientation, velocity)), each [F]."""
    dtype = carry_lon.dtype
    F = carry_lon.shape[0]
    inputs = dense_inputs(carry_lon, carry_lat, orientation, velocity, ref,
                          corridor_lo, corridor_hi, desired_speed, veh,
                          static_grid=static_grid,
                          low_vel_threshold=low_vel_threshold,
                          horizon=horizon)
    # rollout, constraint checks, projection domain, cost and corridor test
    # of every candidate: one kernel on the card, the plain passes elsewhere
    dense = dense_ops.dense_rollout(inputs, dt, n_steps)

    # obstacle windows starting at each problem's current scenario step;
    # the start clamps as dynamic_slice's does, so windows past the
    # prediction span would repeat stale poses -- those steps are invalid
    T = n_steps + 1
    window_pose, _ = _window(obs_pose, time_step, T)
    window_valid, in_span = _window(obs_valid, time_step, T)
    box = collision_ops.ObstacleArrays(
        pose=window_pose.contiguous(), half_ext=obs_half.contiguous(),
        valid=(window_valid & in_span).contiguous(),
        radius=obs_radius.contiguous())
    collides = collision_ops.obb_collision_fleet(
        dense.cx, dense.cy, dense.theta, box,
        collision_ops.per_problem_vector(veh.half_length, dense.theta),
        collision_ops.per_problem_vector(veh.half_width, dense.theta))
    if poly_verts.shape[1] > 0:
        poly_w, _ = _window(poly_verts, time_step, T)
        poly_valid_w, in_span_p = _window(poly_valid, time_step, T)
        collides = collides | collision_ops._poly_obb_overlap_fleet(
            poly_w.transpose(1, 2), (poly_valid_w & in_span_p).transpose(1, 2),
            dense.cx, dense.cy, torch.cos(dense.theta),
            torch.sin(dense.theta),
            collision_ops._per_problem(veh.half_length, dense.theta),
            collision_ops._per_problem(veh.half_width, dense.theta))
    collides = collides | dense.corridor

    ok = dense.feasible & ~collides
    inf = torch.full((), np.inf, dtype=dtype, device=dense.cost.device)
    masked = torch.where(ok, dense.cost, inf)
    best = torch.argmin(masked, dim=1)                             # [F]
    found = torch.any(ok, dim=1)

    # advance replan_offset steps along the optimum (run_planner.py:94-107;
    # curvilinear carry from the trajectory arrays as in run_planner.py:85):
    # the optimum's states at that step, and its speed at the standstill
    # lookahead step
    r = replan_offset
    lookahead = min(standstill_lookahead, n_steps)
    states = dense_ops.dense_winner(inputs, dense, best, dt, n_steps, r,
                                    lookahead)
    new_lon, new_lat = states[:, 0:3], states[:, 3:6]
    (new_orientation, new_velocity, new_x, new_y, new_kappa,
     v_lookahead) = states[:, 6:].unbind(dim=1)
    problem = torch.arange(F, device=best.device)
    best_cost = masked[problem, best]

    if kappa is not None:
        # device-side standstill fallback (reactive_planner.py:638-653)
        standstill = ((velocity <= 0.05)
                      & (~found | (v_lookahead <= 0.05)))
        new_lon = torch.where(standstill[:, None], carry_lon, new_lon)
        new_lat = torch.where(standstill[:, None], carry_lat, new_lat)
        new_orientation = torch.where(standstill, orientation,
                                      new_orientation)
        new_velocity = torch.where(standstill, 0.0, new_velocity)
        new_x = torch.where(standstill, px, new_x)
        new_y = torch.where(standstill, py, new_y)
        new_kappa = torch.where(standstill, kappa, new_kappa)
        best_cost = torch.where(standstill, 0.0, best_cost)
        found = found | standstill

    step_alive = alive & found
    keep = lambda new, old: torch.where(
        step_alive.reshape((F,) + (1,) * (new.dim() - 1)), new, old)
    out_carry = (keep(new_lon, carry_lon), keep(new_lat, carry_lat),
                 keep(new_orientation, orientation),
                 keep(new_velocity, velocity),
                 torch.where(step_alive, time_step + r, time_step),
                 step_alive,
                 keep(new_kappa, kappa) if kappa is not None else None,
                 keep(new_x, px) if px is not None else None,
                 keep(new_y, py) if py is not None else None)
    # dead members (incl. pad_fleet padding) report found=False / inf cost so
    # fleet aggregates count live problems only
    metrics = (step_alive, torch.where(step_alive, best_cost, inf),
               new_x, new_y, new_orientation, new_velocity)
    return out_carry, metrics


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
        out_carry, (found, best_cost, x, y, theta, v) = _single_problem_cycle(
            carry.x0_lon, carry.x0_lat, carry.orientation, carry.velocity,
            carry.time_step, carry.alive, scene.ref, scene.obs_pose,
            scene.obs_half, scene.obs_valid, scene.obs_radius,
            scene.poly_verts, scene.poly_valid, scene.corridor_lo,
            scene.corridor_hi, scene.desired_speed, veh_f,
            carry.kappa, carry.px, carry.py, static_grid=static_grid, dt=dt,
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
        return FleetCarry(*out_carry), metrics

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
