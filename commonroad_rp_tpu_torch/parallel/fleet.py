"""Fleet planning state: many independent planning problems stacked.

Counterpart of the host half of ``commonroad_rp_tpu/parallel/fleet.py``:
``FleetScene`` (per-problem scene tables with a leading fleet axis F),
``FleetCarry`` (per-problem planner state between cycles), ``pad_fleet``,
``build_fleet_scene`` and ``problem_from_planner_setup``.  The assembly is
host-side numpy; each leaf is uploaded once to the fleet's device.  The
fleet replanning loop on the fused fleet scorer is
``parallel.replanning_scan.make_fleet_scan``.

Not ported yet: the XLA fleet path (``make_fleet_step``,
``make_fleet_rollout``, ``_single_problem_cycle``), which runs the
conformance checks per problem (an [F, ...] form of the collision kernel)
and shards over a mesh (ROADMAP queue 1 items 7 and 10).
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from commonroad_rp_tpu_torch.ops import collision as collision_ops
from commonroad_rp_tpu_torch.ops import frenet as frenet_ops
from commonroad_rp_tpu_torch.ops import kinematics as kin_ops


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


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


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
                      device="cpu") -> Tuple[FleetScene, FleetCarry]:
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
