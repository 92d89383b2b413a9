"""Host-side scene compilation: the port against the JAX package.

On all four bundled scenarios, the lanelet route's reference path, the
curvilinear tables (``RefPathTables``), the obstacle tables and the
quantized corridor bands of ``commonroad_rp_tpu_torch`` equal the JAX
package's to 1e-9, both built in float64.
"""

import functools

import numpy as np
import pytest
import torch

from commonroad_rp_tpu.ops import collision as jax_collision
from commonroad_rp_tpu.utils.config import \
    ReactivePlannerConfiguration as JaxConfig
from commonroad_rp_tpu.utils.coordinate_system import \
    CoordinateSystem as JaxCoSys
from commonroad_rp_tpu.utils.route import RoutePlanner as JaxRoutePlanner

from commonroad_rp_tpu_torch.ops import collision as port_collision
from commonroad_rp_tpu_torch.utils.config import \
    ReactivePlannerConfiguration as PortConfig
from commonroad_rp_tpu_torch.utils.coordinate_system import \
    CoordinateSystem as PortCoSys
from commonroad_rp_tpu_torch.utils.route import \
    RoutePlanner as PortRoutePlanner

SCENARIOS = ["ZAM_Over-1_1", "DEU_Test-1_1_T-1", "ZAM-Ramp-1_1-T-1",
             "ZAM_Tjunction-1_42_T-1"]
TOL = 1e-9


def _config(cls, repo_root, name):
    config = cls.load(repo_root / "configurations" / f"{name}.yaml",
                      f"{name}.xml")
    config.general.path_scenarios = str(repo_root / "example_scenarios") + "/"
    config.general.set_path_scenario(f"{name}.xml")
    config.update()
    return config


@functools.lru_cache(maxsize=None)
def _scenes(repo_root, name):
    out = {}
    for key, cfg_cls, route_cls, cosys_cls in (
            ("jax", JaxConfig, JaxRoutePlanner, JaxCoSys),
            ("port", PortConfig, PortRoutePlanner, PortCoSys)):
        config = _config(cfg_cls, repo_root, name)
        route = route_cls(config.scenario, config.planning_problem) \
            .plan_routes().retrieve_first_route()
        if key == "jax":
            import jax.numpy as jnp
            cosys = cosys_cls(route.reference_path, dtype=jnp.float64)
        else:
            cosys = cosys_cls(route.reference_path, dtype=torch.float64)
        out[key] = dict(config=config, route=route, cosys=cosys)
    return out


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


@pytest.mark.parametrize("name", SCENARIOS)
def test_route_matches(repo_root, name):
    sc = _scenes(repo_root, name)
    want = np.asarray(sc["jax"]["route"].reference_path)
    got = np.asarray(sc["port"]["route"].reference_path)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert sc["port"]["route"].lanelet_ids == sc["jax"]["route"].lanelet_ids


@pytest.mark.parametrize("name", SCENARIOS)
def test_ref_path_tables_match(repo_root, name):
    sc = _scenes(repo_root, name)
    want, got = sc["jax"]["cosys"].tables, sc["port"]["cosys"].tables
    assert got._fields == want._fields
    for field in want._fields:
        assert getattr(got, field).dtype == torch.float64
        np.testing.assert_allclose(_np(getattr(got, field)),
                                   _np(getattr(want, field)), rtol=0,
                                   atol=TOL, err_msg=field)


@pytest.mark.parametrize("name", SCENARIOS)
def test_obstacle_tables_match(repo_root, name):
    sc = _scenes(repo_root, name)
    scen_j, scen_p = sc["jax"]["config"].scenario, sc["port"]["config"].scenario
    for t_start, horizon in ((0, 20), (7, 60)):
        import jax.numpy as jnp
        want = jax_collision.compile_obstacles(scen_j, t_start, horizon, 1,
                                               dtype=jnp.float64)
        got = port_collision.compile_obstacles(scen_p, t_start, horizon, 1,
                                               dtype=torch.float64)
        for field in want._fields:
            w, g = getattr(want, field), getattr(got, field)
            assert (w is None) == (g is None), field
            if w is not None:
                assert _np(g).shape == _np(w).shape, field
                np.testing.assert_allclose(_np(g).astype(float),
                                           _np(w).astype(float), rtol=0,
                                           atol=TOL, err_msg=field)


@pytest.mark.parametrize("name", SCENARIOS)
def test_corridor_bands_match(repo_root, name):
    import jax.numpy as jnp

    sc = _scenes(repo_root, name)
    bound_j = jax_collision.compile_road_boundary(
        sc["jax"]["config"].scenario, dtype=jnp.float64)
    bound_p = port_collision.compile_road_boundary(
        sc["port"]["config"].scenario, dtype=torch.float64)
    np.testing.assert_allclose(_np(bound_p.segments), _np(bound_j.segments),
                               rtol=0, atol=TOL)
    want = jax_collision.compile_corridor(bound_j, sc["jax"]["cosys"].tables,
                                          dtype=jnp.float64)
    got = port_collision.compile_corridor(bound_p, sc["port"]["cosys"].tables,
                                          dtype=torch.float64)
    for field in ("d_lo", "d_hi"):
        g = _np(getattr(got, field))
        np.testing.assert_allclose(g, _np(getattr(want, field)), rtol=0,
                                   atol=TOL, err_msg=field)
        # the band-value contract: multiples of 2**-10, within +-32 m
        np.testing.assert_array_equal(g * 1024.0, np.round(g * 1024.0))
        assert np.all(np.abs(g) <= port_collision.BAND_CLAMP)
