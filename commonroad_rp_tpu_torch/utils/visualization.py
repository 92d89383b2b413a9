"""Scenario/trajectory/bundle rendering and GIF export.

Counterpart of ``commonroad_rp_tpu/utils/visualization.py`` (reference:
commonroad_rp/utility/visualization.py:47-275), rendered with plain
matplotlib on the Agg backend (no commonroad-io MPRenderer dependency):
lanelet network, obstacles, planning problem, the planned trajectory, and
the sampled bundle colored by feasibility status.  Every function draws
host numpy data; a compiled collision scene on the card is copied to the
host first.  The same inputs draw the JAX package's pixels.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from commonroad_rp_tpu_torch.models.trajectories import (BundleSummary,
                                                         FeasibilityStatus)
from commonroad_rp_tpu_torch.utils.scenario import (Circle, DynamicObstacle,
                                                    Polygon, Rectangle,
                                                    Scenario)

# bundle colors by feasibility label (visualization.py:40-44)
_STATUS_COLORS = {
    FeasibilityStatus.FEASIBLE: "#2ecc71",
    FeasibilityStatus.INFEASIBLE_KINEMATIC: "#a569bd",
    FeasibilityStatus.INFEASIBLE_COLLISION: "#e74c3c",
}


def _draw_lanelets(ax, scenario: Scenario):
    for lanelet in scenario.lanelet_network.lanelets:
        ax.fill(*lanelet.polygon.T, color="#cfd8dc", zorder=0)
        ax.plot(*lanelet.left_vertices.T, color="#607d8b", lw=0.6, zorder=1)
        ax.plot(*lanelet.right_vertices.T, color="#607d8b", lw=0.6, zorder=1)


def _draw_shape(ax, shape, center, orientation, **kwargs):
    import matplotlib.patches as patches
    import matplotlib.transforms as transforms

    if isinstance(shape, Rectangle):
        total_center = np.asarray(center) + shape.center
        total_orient = orientation + shape.orientation
        rect = patches.Rectangle(
            (-shape.length / 2, -shape.width / 2), shape.length, shape.width,
            **kwargs)
        transform = (transforms.Affine2D().rotate(total_orient)
                     .translate(*total_center) + ax.transData)
        rect.set_transform(transform)
        ax.add_patch(rect)
    elif isinstance(shape, Circle):
        ax.add_patch(patches.Circle(np.asarray(center) + shape.center,
                                    shape.radius, **kwargs))
    elif isinstance(shape, Polygon):
        # body-frame vertices -> world via the obstacle state pose
        c, s = np.cos(orientation), np.sin(orientation)
        rot = np.array([[c, -s], [s, c]])
        pts = np.asarray(shape.points) @ rot.T + np.asarray(center)
        ax.add_patch(patches.Polygon(pts, closed=True, **kwargs))


def _draw_obstacles(ax, scenario: Scenario, timestep: int = 0):
    for obstacle in scenario.static_obstacles:
        state = obstacle.initial_state
        _draw_shape(ax, obstacle.shape, state.position,
                    state.orientation or 0.0, color="#37474f", zorder=3)
    for obstacle in scenario.dynamic_obstacles:
        state = obstacle.state_at_time(timestep)
        if state is not None and state.position is not None:
            _draw_shape(ax, obstacle.shape, state.position,
                        state.orientation or 0.0, color="#1f77b4", zorder=3)


def _draw_planning_problem(ax, planning_problem):
    ax.plot(*planning_problem.initial_state.position, marker="*",
            markersize=12, color="#f1c40f", zorder=5)
    for goal_state in planning_problem.goal.state_list:
        for shape in goal_state.position_shapes:
            _draw_shape(ax, shape, np.zeros(2), 0.0, color="#f9e79f",
                        alpha=0.6, zorder=2)


def visualize_scenario_and_pp(scenario: Scenario, planning_problem,
                              cosy=None, save_path: Optional[str] = None):
    """Scenario + planning problem (+ reference path) plot
    (visualization.py:47-70)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(12, 6))
    _draw_lanelets(ax, scenario)
    _draw_obstacles(ax, scenario)
    _draw_planning_problem(ax, planning_problem)
    if cosy is not None:
        ax.plot(*np.asarray(cosy.reference).T, color="#2e86c1", lw=1.2,
                zorder=4, label="reference path")
        if hasattr(cosy, "projection_domain"):
            # projection-domain outline (reference visualization.py:68-69)
            ax.plot(*cosy.projection_domain().T, color="#85c1e9", lw=0.8,
                    ls="--", zorder=3)
    ax.set_aspect("equal")
    if save_path:
        fig.savefig(save_path, dpi=150, bbox_inches="tight")
        plt.close(fig)
    return fig


def visualize_collision_checker(scenario: Scenario, collision_checker=None,
                                timestep: int = 0,
                                save_path: Optional[str] = None):
    """Render the compiled collision scene: road-boundary segments and
    obstacle OBB footprints at ``timestep`` (reference visualization.py:73-82,
    drawing the pycrcc CollisionChecker's objects).

    ``collision_checker`` is a models.planner.CollisionChecker on any
    device; built on the CPU in float64 from the scenario when omitted.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import torch

    if collision_checker is None:
        from commonroad_rp_tpu_torch.models.planner import CollisionChecker
        collision_checker = CollisionChecker(scenario, torch.device("cpu"),
                                             dtype=torch.float64)
    host = lambda t: t.detach().cpu().numpy()

    fig, ax = plt.subplots(figsize=(12, 6))
    # boundary segments of the drivable-area complement
    b = collision_checker.boundary
    if b is not None and b.segments.shape[0]:
        segs = host(b.segments)                  # [B, 2, 2]
        bval = host(b.valid)
        for m in range(segs.shape[0]):
            if bval[m]:
                ax.plot(segs[m, :, 0], segs[m, :, 1], color="#e74c3c",
                        lw=1.0, zorder=3)

    # obstacle OBBs at the requested step (one compiled window)
    obs = collision_checker.obstacles_for_window(timestep, 0, 1)
    pose = host(obs.pose)                # [M, 1, 3]
    half = host(obs.half_ext)            # [M, 2]
    valid = host(obs.valid)              # [M, 1]
    for m in range(pose.shape[0]):
        if not valid[m, 0]:
            continue
        cx, cy, th = pose[m, 0]
        hl, hw = half[m]
        c, s = np.cos(th), np.sin(th)
        corners = np.array([[hl, hw], [hl, -hw], [-hl, -hw], [-hl, hw],
                            [hl, hw]])
        world = corners @ np.array([[c, s], [-s, c]]) + [cx, cy]
        ax.plot(world[:, 0], world[:, 1], color="#34495e", lw=1.2, zorder=4)
        ax.fill(world[:, 0], world[:, 1], color="#5d6d7e", alpha=0.5, zorder=4)

    ax.set_aspect("equal")
    ax.set_title(f"collision checker @ t={timestep}")
    if save_path:
        fig.savefig(save_path, dpi=150, bbox_inches="tight")
        plt.close(fig)
    return fig


def visualize_planner_at_timestep(scenario: Scenario, planning_problem, ego,
                                  timestep: int,
                                  config=None,
                                  traj_set: Optional[BundleSummary] = None,
                                  ref_path: Optional[np.ndarray] = None,
                                  save_path: Optional[str] = None):
    """Per-timestep plot: scenario, ego trajectory, sampled bundle colored by
    feasibility (visualization.py:85-165)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(12, 6))
    _draw_lanelets(ax, scenario)
    _draw_obstacles(ax, scenario, timestep)
    _draw_planning_problem(ax, planning_problem)

    if traj_set is not None:
        # draw up to a manageable number of candidates, feasible on top
        order = np.argsort([lbl == FeasibilityStatus.FEASIBLE
                            for lbl in traj_set.labels])
        for k in order[-2000:]:
            ax.plot(traj_set.x[k], traj_set.y[k], lw=0.3, alpha=0.4,
                    color=_STATUS_COLORS[traj_set.labels[k]], zorder=4)

    if isinstance(ego, DynamicObstacle):
        states = ego.trajectory
        positions = np.array([s.position for s in states])
        ax.plot(positions[:, 0], positions[:, 1], color="#000000", lw=1.5,
                zorder=6)
        first = states[0]
        _draw_shape(ax, ego.shape, first.position, first.orientation or 0.0,
                    color="#e67e22", zorder=6)

    if ref_path is not None:
        ax.plot(*np.asarray(ref_path).T, color="#2e86c1", lw=1.0, ls="--",
                zorder=4)

    ax.set_aspect("equal")
    ax.set_title(f"t = {timestep}")
    if save_path is None and config is not None and config.debug.save_plots:
        out_dir = os.path.join(config.general.path_output,
                               config.general.name_scenario or "scenario")
        os.makedirs(out_dir, exist_ok=True)
        save_path = os.path.join(out_dir, f"{timestep}.png")
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig


def plot_final_trajectory(scenario: Scenario, planning_problem, state_list,
                          config=None, save_path: Optional[str] = None):
    """Final driven trajectory plot (visualization.py:168-241)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(12, 6))
    _draw_lanelets(ax, scenario)
    _draw_obstacles(ax, scenario)
    _draw_planning_problem(ax, planning_problem)
    positions = np.array([s.position for s in state_list])
    ax.plot(positions[:, 0], positions[:, 1], color="#000000", lw=2.0, zorder=6,
            label="driven trajectory")
    ax.set_aspect("equal")
    ax.legend()
    if save_path is None and config is not None:
        out_dir = config.general.path_output
        os.makedirs(out_dir, exist_ok=True)
        save_path = os.path.join(
            out_dir, f"final_trajectory_{config.general.name_scenario}.png")
    if save_path:
        fig.savefig(save_path, dpi=150, bbox_inches="tight")
        plt.close(fig)
    return fig


def make_gif(config, time_steps, duration: float = 0.1):
    """Assemble per-timestep PNGs into a GIF (visualization.py:244-275)."""
    try:
        import imageio.v2 as imageio
    except ImportError:
        import warnings
        warnings.warn("imageio not available; skipping GIF export")
        return
    out_dir = os.path.join(config.general.path_output,
                           config.general.name_scenario or "scenario")
    images = []
    for step in time_steps:
        path = os.path.join(out_dir, f"{step}.png")
        if os.path.exists(path):
            images.append(imageio.imread(path))
    if images:
        imageio.mimsave(os.path.join(
            config.general.path_output,
            f"{config.general.name_scenario}.gif"), images, duration=duration)
