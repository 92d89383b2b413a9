"""The inputs of a cell, made from its configuration file and the seed.

The scenarios are the repository's bundled CommonRoad files, loaded and
route-planned once per run with the program's public loader and route
planner; the loaded scenario and the route's polyline are handed alike to
the program and to the reference.  The jitter of each problem (start
speed x U(0.92, 1.08), lateral start offset + U(-0.25, 0.25) m, desired
speed x U(0.95, 1.05); the ranges sit in the configuration file) is drawn
here from ``numpy.random.default_rng(seed)``, so a seed's inputs do not
depend on the program.
"""

from __future__ import annotations

import logging

import numpy as np

from benchlib.core import ROOT
from reference import path as ref_path
from reference import planner as ref_planner
from reference import scene as ref_scene


def scenario_settings(config: dict, scenario: str) -> dict:
    """The planner settings of one scenario: the configuration's defaults
    with the scenario's own overrides."""
    out = {k: dict(v) if isinstance(v, dict) else v
           for k, v in config["planner"].items()}
    for key, value in config.get("per_scenario", {}).get(scenario,
                                                         {}).items():
        out[key].update(value)
    return out


def load_scenario(scenario: str):
    """(scenario, planning problem, route polyline) of a bundled scenario."""
    from commonroad_rp_tpu_torch.utils.general import \
        load_scenario_and_planning_problem
    from commonroad_rp_tpu_torch.utils.route import RoutePlanner

    scn, pp, _ = load_scenario_and_planning_problem(
        str(ROOT / "example_scenarios" / f"{scenario}.xml"))
    route = RoutePlanner(scn, pp).plan_routes().retrieve_first_route()
    return scn, pp, np.asarray(route.reference_path, dtype=np.float64)


def port_config(scenario: str, settings: dict, vehicle_type: int, scn, pp):
    """The program's configuration object for one scenario."""
    from commonroad_rp_tpu_torch.utils import config as cfg

    logging.getLogger("RP_LOGGER").setLevel(logging.ERROR)
    config = cfg.ReactivePlannerConfiguration(
        vehicle=cfg.VehicleConfiguration(id_type_vehicle=vehicle_type),
        planning=cfg.PlanningConfiguration(**settings["planning"]),
        sampling=cfg.SamplingConfiguration(**settings["sampling"]),
        debug=cfg.DebugConfiguration(kernel_dtype=settings["kernel_dtype"],
                                     logging_level="ERROR"))
    config.general.path_scenarios = str(ROOT / "example_scenarios") + "/"
    config.general.set_path_scenario(f"{scenario}.xml")
    config.update(scenario=scn, planning_problem=pp)
    return config


def jitter(config: dict, rng: np.random.Generator):
    """(speed factor, lateral offset in m, desired-speed factor) of one
    problem."""
    j = config["jitter"]
    return (float(rng.uniform(*j["speed"])), float(rng.uniform(*j["lateral_m"])),
            float(rng.uniform(*j["desired_speed"])))


def reference_scene(scn, polyline, vehicle: dict, span: int) -> dict:
    """The reference's own scene of one problem."""
    tables = ref_path.tables(ref_path.prepare(polyline))
    segments = ref_scene.road_boundary(scn)
    return dict(tables=tables,
                band=ref_scene.corridor(tables.points, tables.normal,
                                        segments),
                obstacles=ref_scene.obstacles(scn, span),
                veh=ref_planner.vehicle_row(vehicle))


def rear_axle(position, orientation: float, wb_rear: float):
    return np.asarray(position, dtype=np.float64) - wb_rear * np.array(
        [np.cos(orientation), np.sin(orientation)])
