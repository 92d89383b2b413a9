"""Plots (Agg backend): the port against the JAX package.

* The cases of ``tests/test_visualization.py`` on the port: a planned cycle
  with ``draw_traj_set`` and ``save_plots`` populates the bundle, and each
  plot is written.
* Each plotting function is fed identical host inputs through both
  packages -- the same scenario file, and the same ``BundleSummary`` and
  state-list arrays built once with numpy -- and the decoded pixels of the
  two PNGs must be identical.  This covers ``visualize_scenario_and_pp``,
  ``visualize_collision_checker``, ``visualize_planner_at_timestep``,
  ``plot_final_trajectory``, ``make_gif``, ``plot_states``, ``plot_inputs``
  and ``CoordinateSystem.plot_reference_states``.
"""

import functools
import logging
import os

import numpy as np
import pytest
import torch

matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")
Image = pytest.importorskip("PIL.Image")

from commonroad_rp_tpu.models import state as jax_state
from commonroad_rp_tpu.models import trajectories as jax_traj
from commonroad_rp_tpu.utils import evaluation as jax_evaluation
from commonroad_rp_tpu.utils import visualization as jax_viz
from commonroad_rp_tpu.utils.coordinate_system import \
    CoordinateSystem as JaxCoordinateSystem
from commonroad_rp_tpu.utils.general import \
    load_scenario_and_planning_problem as jax_load
from commonroad_rp_tpu.utils.route import RoutePlanner as JaxRoutePlanner
from commonroad_rp_tpu.utils.scenario import DynamicObstacle as JaxDynamic
from commonroad_rp_tpu.utils.scenario import Rectangle as JaxRectangle

from commonroad_rp_tpu_torch.models import state as port_state
from commonroad_rp_tpu_torch.models import trajectories as port_traj
from commonroad_rp_tpu_torch.models.trajectories import FeasibilityStatus
from commonroad_rp_tpu_torch.run_planner import load_config, make_planner
from commonroad_rp_tpu_torch.utils import evaluation as port_evaluation
from commonroad_rp_tpu_torch.utils import visualization as viz
from commonroad_rp_tpu_torch.utils.coordinate_system import CoordinateSystem
from commonroad_rp_tpu_torch.utils.general import \
    load_scenario_and_planning_problem
from commonroad_rp_tpu_torch.utils.route import RoutePlanner
from commonroad_rp_tpu_torch.utils.scenario import (DynamicObstacle,
                                                    Rectangle)

logging.getLogger("RP_LOGGER").setLevel(logging.CRITICAL)

SCENARIO = "ZAM_Over-1_1"


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def planned(repo_root):
    config = load_config(SCENARIO, repo_root)
    config.debug.draw_traj_set = True
    config.debug.save_plots = True
    planner = make_planner(config, device="cpu")
    planner.set_desired_velocity(current_speed=planner.x_0.velocity)
    result = planner.plan()
    assert result is not None
    return config, planner, result


def test_scenario_plot(planned, tmp_path):
    config, planner, _ = planned
    path = str(tmp_path / "scenario.png")
    viz.visualize_scenario_and_pp(config.scenario, config.planning_problem,
                                  cosy=planner.coordinate_system,
                                  save_path=path)
    assert os.path.getsize(path) > 10_000


def test_timestep_plot_with_bundle(planned, tmp_path):
    config, planner, result = planned
    assert planner.stored_trajectories is not None, \
        "draw_traj_set should populate the stored bundle"
    ego = planner.convert_state_list_to_commonroad_object(result[0].state_list)
    path = str(tmp_path / "step.png")
    viz.visualize_planner_at_timestep(
        config.scenario, config.planning_problem, ego, timestep=0,
        config=config, traj_set=planner.stored_trajectories,
        ref_path=planner.reference_path, save_path=path)
    assert os.path.getsize(path) > 10_000


def test_final_trajectory_plot(planned, tmp_path):
    config, _, result = planned
    path = str(tmp_path / "final.png")
    viz.plot_final_trajectory(config.scenario, config.planning_problem,
                              result[0].state_list, config, save_path=path)
    assert os.path.getsize(path) > 10_000


def test_bundle_labels(planned):
    _, planner, _ = planned
    bundle = planner.stored_trajectories
    assert FeasibilityStatus.FEASIBLE in set(bundle.labels)
    assert len(bundle.labels) == len(bundle.costs)


def test_visualize_collision_checker_and_projection_domain(repo_root,
                                                           tmp_path):
    scenario, pp, _ = load_scenario_and_planning_problem(
        str(repo_root / "example_scenarios" / "ZAM_Tjunction-1_42_T-1.xml"))
    out = tmp_path / "cc.png"
    viz.visualize_collision_checker(scenario, timestep=0, save_path=str(out))
    assert out.stat().st_size > 1000

    route = RoutePlanner(scenario, pp).plan_routes().retrieve_first_route()
    cosy = CoordinateSystem(route.reference_path)
    domain = cosy.projection_domain()
    assert domain.shape[1] == 2 and domain.shape[0] > 10
    assert np.isfinite(domain).all()
    np.testing.assert_allclose(domain[0], domain[-1])
    out2 = tmp_path / "pp.png"
    viz.visualize_scenario_and_pp(scenario, pp, cosy=cosy, save_path=str(out2))
    assert out2.stat().st_size > 1000


# ---------------------------------------------------------------------------
# pixel equality with the JAX package
# ---------------------------------------------------------------------------

def _pixels(path):
    with Image.open(path) as image:
        return np.asarray(image.convert("RGBA"))


def assert_same_pixels(path_a, path_b):
    a, b = _pixels(path_a), _pixels(path_b)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a, b)
    assert len(np.unique(a.reshape(-1, 4), axis=0)) > 4   # not blank


@functools.lru_cache(maxsize=None)
def _scene(repo_root, name):
    path = str(repo_root / "example_scenarios" / f"{name}.xml")
    port = load_scenario_and_planning_problem(path)
    jax = jax_load(path)
    return port, jax


def _host_inputs(seed=0, K=40, T=21):
    """A bundle and a state list as numpy arrays, built once."""
    rng = np.random.default_rng(seed)
    x = 30.0 + np.cumsum(rng.uniform(0.5, 2.0, (K, T)), axis=1)
    y = -1.2 + np.cumsum(rng.normal(0.0, 0.15, (K, T)), axis=1)
    costs = rng.uniform(10.0, 500.0, K)
    feasible = rng.random(K) > 0.3
    collides = rng.random(K) > 0.6
    n = 28
    states = dict(time_step=np.arange(n),
                  position=np.stack([30.0 + 2.0 * np.arange(n),
                                     -1.1 + 0.15 * np.arange(n)], axis=1),
                  orientation=0.05 * np.sin(np.arange(n) / 4.0),
                  velocity=20.0 - 0.1 * np.arange(n),
                  acceleration=rng.normal(0.0, 0.5, n),
                  yaw_rate=rng.normal(0.0, 0.02, n),
                  steering_angle=rng.normal(0.0, 0.01, n))
    inputs = dict(time_step=np.arange(n), acceleration=rng.normal(0, 0.5, n),
                  steering_angle_speed=rng.normal(0.0, 0.05, n))
    return (x, y, costs, feasible, collides), states, inputs


def _states(module, states):
    return [module.ReactivePlannerState(
        time_step=int(states["time_step"][i]),
        position=states["position"][i].copy(),
        **{f: float(states[f][i]) for f in ("orientation", "velocity",
                                            "acceleration", "yaw_rate",
                                            "steering_angle")})
        for i in range(len(states["time_step"]))]


def _inputs(module, inputs):
    return [module.InputState(time_step=int(inputs["time_step"][i]),
                              acceleration=float(inputs["acceleration"][i]),
                              steering_angle_speed=float(
                                  inputs["steering_angle_speed"][i]))
            for i in range(len(inputs["time_step"]))]


def _both(tmp_path, draw):
    """``draw(package_tag, save_path)`` once per package; returns the two
    paths."""
    paths = [str(tmp_path / f"{tag}.png") for tag in ("port", "jax")]
    for tag, path in zip(("port", "jax"), paths):
        draw(tag, path)
    return paths


@pytest.mark.parametrize("name", ["ZAM_Over-1_1", "ZAM_Tjunction-1_42_T-1"])
def test_scenario_plot_pixels(repo_root, tmp_path, name):
    (scenario, pp, _), (jscenario, jpp, _) = _scene(repo_root, name)
    route = RoutePlanner(scenario, pp).plan_routes().retrieve_first_route()
    jroute = JaxRoutePlanner(jscenario, jpp).plan_routes() \
        .retrieve_first_route()
    cosy = {"port": CoordinateSystem(route.reference_path),
            "jax": JaxCoordinateSystem(jroute.reference_path)}
    np.testing.assert_array_equal(cosy["port"].reference,
                                  cosy["jax"].reference)
    args = {"port": (viz, scenario, pp), "jax": (jax_viz, jscenario, jpp)}

    def draw(tag, path):
        module, sc, problem = args[tag]
        module.visualize_scenario_and_pp(sc, problem, cosy=cosy[tag],
                                         save_path=path)
    assert_same_pixels(*_both(tmp_path, draw))


@pytest.mark.parametrize("name,timestep", [("ZAM_Tjunction-1_42_T-1", 0),
                                           ("DEU_Test-1_1_T-1", 12)])
def test_collision_checker_pixels(repo_root, tmp_path, name, timestep):
    (scenario, _, _), (jscenario, _, _) = _scene(repo_root, name)
    args = {"port": (viz, scenario), "jax": (jax_viz, jscenario)}

    def draw(tag, path):
        module, sc = args[tag]
        module.visualize_collision_checker(sc, timestep=timestep,
                                           save_path=path)
    assert_same_pixels(*_both(tmp_path, draw))


def test_timestep_plot_pixels(repo_root, tmp_path):
    (scenario, pp, _), (jscenario, jpp, _) = _scene(repo_root, SCENARIO)
    bundle, states, _ = _host_inputs()
    ref_path = states["position"] + [0.0, 0.5]
    ego = {}
    for tag, module, dyn, rect in (("port", port_state, DynamicObstacle,
                                    Rectangle),
                                   ("jax", jax_state, JaxDynamic,
                                    JaxRectangle)):
        state_list = _states(module, states)
        ego[tag] = dyn(42, "car", rect(4.5, 1.8), state_list[0],
                       trajectory=state_list)
    args = {"port": (viz, scenario, pp, port_traj),
            "jax": (jax_viz, jscenario, jpp, jax_traj)}

    def draw(tag, path):
        module, sc, problem, traj = args[tag]
        traj_set = traj.BundleSummary(*[a.copy() for a in bundle])
        module.visualize_planner_at_timestep(sc, problem, ego[tag],
                                             timestep=3, traj_set=traj_set,
                                             ref_path=ref_path,
                                             save_path=path)
    assert_same_pixels(*_both(tmp_path, draw))


def test_final_trajectory_pixels(repo_root, tmp_path):
    (scenario, pp, _), (jscenario, jpp, _) = _scene(repo_root, SCENARIO)
    _, states, _ = _host_inputs(1)
    args = {"port": (viz, scenario, pp, port_state),
            "jax": (jax_viz, jscenario, jpp, jax_state)}

    def draw(tag, path):
        module, sc, problem, st = args[tag]
        module.plot_final_trajectory(sc, problem, _states(st, states),
                                     save_path=path)
    assert_same_pixels(*_both(tmp_path, draw))


def test_state_and_input_plots_pixels(repo_root, tmp_path):
    config = load_config(SCENARIO, repo_root)
    _, states, inputs = _host_inputs(2)
    _, rec_states, rec_inputs = _host_inputs(3)
    args = {"port": (port_evaluation, port_state),
            "jax": (jax_evaluation, jax_state)}
    for kind in ("states", "inputs"):
        def draw(tag, path):
            module, st = args[tag]
            if kind == "states":
                module.plot_states(config, _states(st, states),
                                   _states(st, rec_states), plot_bounds=True,
                                   save_path=path)
            else:
                module.plot_inputs(config, _inputs(st, inputs),
                                   _inputs(st, rec_inputs), plot_bounds=True,
                                   save_path=path)
        sub = tmp_path / kind
        sub.mkdir()
        assert_same_pixels(*_both(sub, draw))


def test_reference_states_plot_pixels(repo_root, tmp_path):
    import matplotlib.pyplot as plt

    (scenario, pp, _), (jscenario, jpp, _) = _scene(repo_root, SCENARIO)
    route = RoutePlanner(scenario, pp).plan_routes().retrieve_first_route()
    cosy = {"port": CoordinateSystem(route.reference_path),
            "jax": JaxCoordinateSystem(route.reference_path)}

    def draw(tag, path):
        cosy[tag].plot_reference_states()
        plt.gcf().savefig(path, dpi=80)
        plt.close("all")
    assert_same_pixels(*_both(tmp_path, draw))


def test_make_gif_matches_jax(tmp_path):
    """Timestep PNGs (the same frames for both) assembled into a GIF; the
    decoded frames are the JAX package's.  Without ``imageio`` both warn and
    skip."""
    import matplotlib.pyplot as plt

    config = load_config(SCENARIO)
    frames_dir = tmp_path / "frames"
    config.general.path_output = str(frames_dir) + "/"
    out_dir = frames_dir / (config.general.name_scenario or "scenario")
    out_dir.mkdir(parents=True)
    for step in range(3):
        fig, ax = plt.subplots(figsize=(2, 2))
        ax.plot([0, 1], [0, step])
        fig.savefig(out_dir / f"{step}.png", dpi=40)
        plt.close(fig)
    gif = frames_dir / f"{config.general.name_scenario}.gif"
    try:
        import imageio  # noqa: F401
    except ImportError:
        for module in (viz, jax_viz):
            with pytest.warns(UserWarning, match="imageio"):
                module.make_gif(config, range(3))
        assert not gif.exists()
        return
    decoded = []
    for module in (viz, jax_viz):
        module.make_gif(config, range(3))
        with Image.open(gif) as image:
            frames = []
            for i in range(image.n_frames):
                image.seek(i)
                frames.append(np.asarray(image.convert("RGBA")))
        decoded.append(np.stack(frames))
        gif.unlink()
    assert decoded[0].shape[0] == 3
    np.testing.assert_array_equal(decoded[0], decoded[1])
