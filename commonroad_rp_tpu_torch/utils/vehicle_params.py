"""Static vehicle parameter tables.

Equivalent of the commonroad-vehicle-models parameter database as consumed by
the reference's VehicleConfiguration (reference: commonroad_rp/utility/config.py:194-222):
dimensions, axle distances, acceleration limits with switching velocity, and
steering limits, keyed by the CommonRoad vehicle-type id (1 = Ford Escort,
2 = BMW 320i, 3 = VW Vanagon).  Values are the published parameter sets of the
vehicle-models package (parameters_vehicle{1,2,3}).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class VehicleParameters:
    """Subset of the CommonRoad vehicle parameter set used by the planner."""

    # dimensions
    l: float            # vehicle length [m]
    w: float            # vehicle width [m]
    # axle distances from center of gravity
    a: float            # distance CoG -> front axle [m]
    b: float            # distance CoG -> rear axle [m]
    # longitudinal constraints
    a_max: float        # maximum absolute acceleration [m/s^2]
    v_switch: float     # switching velocity for acceleration limit [m/s]
    v_min: float        # minimum velocity [m/s]
    v_max: float        # maximum velocity [m/s]
    # steering constraints
    delta_min: float    # minimum steering angle [rad]
    delta_max: float    # maximum steering angle [rad]
    v_delta_min: float  # minimum steering velocity [rad/s]
    v_delta_max: float  # maximum steering velocity [rad/s]

    @property
    def wheelbase(self) -> float:
        return self.a + self.b


# Published parameter sets (vehiclemodels.parameters_vehicle1/2/3).
_VEHICLE_DB = {
    # 1: Ford Escort
    1: VehicleParameters(
        l=4.298, w=1.674,
        a=1.0893921146, b=1.4261068854,
        a_max=11.4999, v_switch=4.755, v_min=-13.9, v_max=45.8,
        delta_min=-0.910, delta_max=0.910,
        v_delta_min=-0.4, v_delta_max=0.4,
    ),
    # 2: BMW 320i (reference default, config.py:198)
    2: VehicleParameters(
        l=4.508, w=1.610,
        a=1.1561957064, b=1.4227170936,
        a_max=11.5751, v_switch=7.319, v_min=-13.6, v_max=50.8,
        delta_min=-1.066, delta_max=1.066,
        v_delta_min=-0.4, v_delta_max=0.4,
    ),
    # 3: VW Vanagon
    3: VehicleParameters(
        l=4.569, w=1.844,
        a=1.2453616375, b=1.5808183625,
        a_max=11.4736, v_switch=7.824, v_min=-11.2, v_max=41.7,
        delta_min=-1.023, delta_max=1.023,
        v_delta_min=-0.4, v_delta_max=0.4,
    ),
}


def vehicle_parameters(id_type_vehicle: int) -> VehicleParameters:
    """Look up the parameter set for a CommonRoad vehicle-type id.

    Mirrors VehicleParameterMapping.from_vehicle_type usage at config.py:200.
    """
    try:
        return _VEHICLE_DB[int(id_type_vehicle)]
    except KeyError:
        raise ValueError(
            f"Unknown vehicle type id {id_type_vehicle}; supported: {sorted(_VEHICLE_DB)}"
        ) from None
