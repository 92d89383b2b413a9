"""Typed configuration system: YAML -> nested dataclasses.

Equivalent of the reference's OmegaConf-based config
(reference: commonroad_rp/utility/config.py:43-290) with identical field names
and defaults, so the reference's per-scenario YAML files load unchanged.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Union

import numpy as np

from commonroad_rp_tpu_torch.utils.vehicle_params import VehicleParameters, vehicle_parameters


def _fill_dataclass(cls, data: Dict[str, Any]):
    """Recursively build a dataclass from a (possibly partial) dict.

    Unknown keys raise; missing keys keep dataclass defaults.  Plays the role
    of the reference's _dict_to_params + OmegaConf merge validation
    (config.py:22-40, :98-101).
    """
    import typing
    hints = typing.get_type_hints(cls)
    field_names = {f.name for f in dataclasses.fields(cls)}
    kwargs = {}
    for key, value in (data or {}).items():
        if key not in field_names:
            raise KeyError(f"Unknown config key '{key}' for {cls.__name__}")
        sub_cls = hints.get(key)
        if isinstance(value, dict) and isinstance(sub_cls, type) \
                and dataclasses.is_dataclass(sub_cls):
            kwargs[key] = _fill_dataclass(sub_cls, value)
        else:
            kwargs[key] = value
    return cls(**kwargs)


@dataclass
class PlanningConfiguration:
    """Planning parameters (reference: config.py:107-130)."""

    dt: float = 0.1
    time_steps_computation: int = 60
    planning_horizon: float = 6.0
    replanning_frequency: int = 3
    continuous_collision_check: bool = False
    factor: int = 1
    low_vel_mode_threshold: float = 4.0
    constraints_to_check: List[str] = field(
        default_factory=lambda: ["velocity", "acceleration", "kappa", "kappa_dot", "yaw_rate"])
    standstill_lookahead: int = 10
    # Port extension: road-boundary check implementation
    # "corridor": drivable d-band gathers along the reference path (fast)
    # "segments": exact OBB-vs-boundary-segment SAT tests
    boundary_mode: str = "corridor"

    def __post_init__(self):
        self.planning_horizon = self.dt * self.time_steps_computation


@dataclass
class SamplingConfiguration:
    """Sampling parameters (reference: config.py:133-165)."""

    sampling_method: int = 1
    longitudinal_mode: str = "velocity_keeping"
    num_sampling_levels: int = 4
    t_min: float = 0.4
    v_min: float = 0.0
    v_max: float = 0.0
    s_min: float = -1.0
    s_max: float = 1.0
    d_min: float = -3.0
    d_max: float = 3.0


@dataclass
class DebugConfiguration:
    """Debug/observability parameters (reference: config.py:168-191).

    ``multiproc``/``num_workers`` are accepted for YAML compatibility; the
    port's parallelism is the candidate-axis batch on device, so they have no
    effect (SURVEY.md section 2.3).
    """

    save_plots: bool = False
    save_config: bool = False
    show_plots: bool = False
    draw_ref_path: bool = True
    draw_planning_problem: bool = True
    draw_icons: bool = False
    draw_traj_set: bool = False
    logging_level: str = "INFO"
    multiproc: bool = True
    num_workers: int = 6
    # Port extension: dtype of the device planning kernels.  "auto" resolves
    # to float32 at planner construction (the fused scorer's path);
    # "float64" plans through the conformance level program
    # (ops.cycle.evaluate_level), the JAX package's default off the TPU.
    kernel_dtype: str = "auto"
    # Port extension: score candidates with the fused scorer
    # (ops.scoring).  None resolves to True; False plans through the
    # conformance level program in kernel_dtype.
    fast_scoring: Optional[bool] = None


@dataclass
class VehicleConfiguration:
    """Vehicle dimensions and constraint parameters (reference: config.py:194-222)."""

    id_type_vehicle: int = 2
    length: float = 0.0
    width: float = 0.0
    wb_front_axle: float = 0.0
    wb_rear_axle: float = 0.0
    a_max: float = 0.0
    v_switch: float = 0.0
    delta_min: float = 0.0
    delta_max: float = 0.0
    v_delta_min: float = 0.0
    v_delta_max: float = 0.0
    wheelbase: float = 0.0

    def __post_init__(self):
        params: VehicleParameters = vehicle_parameters(self.id_type_vehicle)
        # Any field left at its 0.0 sentinel is pulled from the vehicle DB,
        # mirroring the pull-from-vehicle-models defaults at config.py:203-219.
        self.length = self.length or params.l
        self.width = self.width or params.w
        self.wb_front_axle = self.wb_front_axle or params.a
        self.wb_rear_axle = self.wb_rear_axle or params.b
        self.a_max = self.a_max or params.a_max
        self.v_switch = self.v_switch or params.v_switch
        self.delta_min = self.delta_min or params.delta_min
        self.delta_max = self.delta_max or params.delta_max
        self.v_delta_min = self.v_delta_min or params.v_delta_min
        self.v_delta_max = self.v_delta_max or params.v_delta_max
        self.wheelbase = self.wheelbase or (params.a + params.b)
        # maximum curvature from max steering angle (config.py:222)
        self.kappa_max = np.tan(self.delta_max) / self.wheelbase


@dataclass
class GeneralConfiguration:
    """Paths (reference: config.py:225-243)."""

    path_scenarios: str = "example_scenarios/"
    path_output: str = "output/"
    path_logs: str = "output/logs/"
    path_pickles: str = "output/pickles/"
    path_scenario: Optional[str] = None
    name_scenario: Optional[str] = None

    def set_path_scenario(self, scenario_name: str):
        self.path_scenario = os.path.join(self.path_scenarios, scenario_name)
        self.name_scenario = scenario_name


@dataclass
class ReactivePlannerConfiguration:
    """Root configuration (reference: config.py:246-290)."""

    vehicle: VehicleConfiguration = field(default_factory=VehicleConfiguration)
    planning: PlanningConfiguration = field(default_factory=PlanningConfiguration)
    sampling: SamplingConfiguration = field(default_factory=SamplingConfiguration)
    debug: DebugConfiguration = field(default_factory=DebugConfiguration)
    general: GeneralConfiguration = field(default_factory=GeneralConfiguration)

    def __post_init__(self):
        self.scenario = None
        self.planning_problem = None
        self.planning_problem_set = None

    @property
    def name_scenario(self) -> Optional[str]:
        return self.general.name_scenario

    @classmethod
    def load(cls, file_path: Union[pathlib.Path, str],
             scenario_name: Optional[str] = None) -> "ReactivePlannerConfiguration":
        """Load a YAML config file (reference: config.py:84-104)."""
        import yaml

        file_path = pathlib.Path(file_path)
        assert file_path.suffix == ".yaml", \
            f"File type {file_path.suffix} is unsupported! Please use .yaml!"
        with open(file_path) as fh:
            loaded = yaml.safe_load(fh) or {}
        config = _fill_dataclass(cls, loaded)
        if scenario_name:
            config.general.set_path_scenario(scenario_name)
        return config

    def update(self, scenario=None, planning_problem=None,
               idx_planning_problem: Optional[int] = None):
        """Attach (or load) scenario + planning problem (reference: config.py:265-290)."""
        from commonroad_rp_tpu_torch.utils.general import load_scenario_and_planning_problem

        self.scenario = scenario
        self.planning_problem = planning_problem
        if scenario is None and planning_problem is None:
            self.scenario, self.planning_problem, self.planning_problem_set = \
                load_scenario_and_planning_problem(self.general.path_scenario,
                                                   idx_planning_problem)
        assert self.scenario is not None, \
            "<Configuration.update()>: no scenario has been specified"
