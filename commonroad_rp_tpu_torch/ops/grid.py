"""Device-side terminal-manifold grid generation.

Counterpart of ``commonroad_rp_tpu/ops/grid.py``: the candidate grids of the
device replanning loops (``parallel.replanning_scan``), built on the device
around the carried state each cycle, because their bounds depend on it
(set_desired_velocity semantics, reactive_planner.py:329-335) and the loops
never read the device back.  ``models.sampling`` builds the same grids on
the host for ``plan()``.

Static per scan: the time grid, per-time-sample step counts, the base d grid
and the sample counts (``StaticGrid``; ``CorridorGrid`` for corridor
sampling).  Tensors: the velocity window or stop-position bounds, the
current lateral offset (the ``∪ {x_0_lat[0]}`` extra d sample,
sampling.py:226) and the low-velocity mode.  Every generator takes an
optional leading problem axis on its state arguments (x0 [..., 3], bounds
and mode [...]), so the fleet builds all problems' grids in one pass.

Not ported: ``candidate_lon_span*``, ``_span*`` and ``corridor_lon_span*``
(JAX ``ops/grid.py:124-262, :364``).  They only bound the arclength span of
a candidate set for the TPU scorer's table windows; the CUDA kernel finds
its table rows by binary search over the whole table and needs no bounds.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from commonroad_rp_tpu_torch.models.sampling import (PositionSampling,
                                                     TimeSampling,
                                                     traj_length_steps)
from commonroad_rp_tpu_torch.ops import polynomial as poly


class StaticGrid(NamedTuple):
    """Host-precomputed static grid components for one sampling level."""

    t_values: Tuple[float, ...]       # time samples
    traj_len: Tuple[int, ...]         # valid steps per time sample
    d_values: Tuple[float, ...]       # base lateral offsets
    n_lon: int                        # number of longitudinal samples

    @property
    def size(self) -> int:
        return len(self.t_values) * self.n_lon * (len(self.d_values) + 1)


def make_static_grid(level: int, t_min: float, horizon: float, dt: float,
                     d_min: float, d_max: float, num_levels: int) -> StaticGrid:
    """Precompute the static grid parts for a sampling level (host)."""
    ts = TimeSampling(t_min, horizon, num_levels, dt).samples_at_level(level)
    ds = PositionSampling(d_min, d_max, num_levels).samples_at_level(level)
    n = 3
    for _ in range(level):
        n = n * 2 - 1
    return StaticGrid(t_values=tuple(float(t) for t in ts),
                      traj_len=tuple(int(v) for v in traj_length_steps(ts, dt)),
                      d_values=tuple(float(d) for d in ds),
                      n_lon=n)


@functools.lru_cache(maxsize=256)
def constant(values: tuple, dtype: torch.dtype,
             device: torch.device) -> torch.Tensor:
    """A grid's static values as a device tensor, uploaded once per
    (values, dtype, device): the scans call the generators every cycle and
    must not copy from the host inside the loop.  Read-only."""
    return torch.tensor(values, dtype=dtype, device=device)


def upload_constants(grid, device, dtype=torch.float32) -> tuple:
    """Upload a StaticGrid's or CorridorGrid's static values once, before a
    scan's loop, so that no cycle copies from the host.  Returns the
    tensors: a captured scan holds them for as long as its graph reads
    them (the cache may drop them).  A bare ``cuda`` names the current
    card, as the cycles' tensors do, so that both look up one entry."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    held = (constant(grid.t_values, dtype, device),
            constant(grid.traj_len, torch.int32, device))
    if isinstance(grid, StaticGrid):
        held += (constant(grid.d_values, dtype, device),)
    return held


def linspace(start: torch.Tensor, stop: torch.Tensor, num: int) -> torch.Tensor:
    """``jnp.linspace(start, stop, num)`` term for term, batched over the
    bounds' shape ([...] -> [..., num]): start * (1 - i/div) + stop * i/div
    for i < num - 1, then ``stop`` exactly.  Takes device tensors as bounds
    without reading them back."""
    div = num - 1
    step = torch.arange(div, dtype=start.dtype, device=start.device) / div
    out = start[..., None] * (1 - step) + stop[..., None] * step
    return torch.cat([out, stop[..., None]], dim=-1)


def _lattice(x0_lon, x0_lat, lon_values, grid: StaticGrid):
    """(T, L, D) grids [..., Nt, Nlon, Nd+1] of the (time, longitudinal
    target, lateral target) lattice in meshgrid 'ij' order."""
    dtype, device = x0_lon.dtype, x0_lon.device
    t_g = constant(grid.t_values, dtype, device)
    d_base = constant(grid.d_values, dtype, device)
    batch = x0_lon.shape[:-1]
    d_g = torch.cat([d_base.expand(batch + d_base.shape),
                     x0_lat[..., :1]], dim=-1)                # [..., Nd+1]
    shape = batch + (len(grid.t_values), grid.n_lon, d_g.shape[-1])
    T = t_g[:, None, None].expand(shape)
    L = lon_values[..., None, :, None].expand(shape)
    D = d_g[..., None, None, :].expand(shape)
    return T, L, D


def _lateral(coeffs_lon, x0_lon, x0_lat, T, D, low_vel):
    """Quintic lateral coefficients; in low-velocity mode the lateral span
    is the travelled arclength (sampling.py:229-238), t where that is not
    positive."""
    shape = T.shape
    bshape = shape[:-3] + (1, 1, 1)
    s_goal = poly.eval_position(coeffs_lon, T) - x0_lon[..., 0].reshape(bshape)
    low_vel = torch.as_tensor(low_vel, device=T.device).reshape(bshape)
    tau_lat = torch.where(low_vel, torch.where(s_goal <= 0, T, s_goal), T)
    zeros = torch.zeros_like(D)
    xd_lat = torch.stack([D, zeros, zeros], dim=-1)
    return poly.quintic_coeffs(x0_lat[..., None, None, None, :].expand(
        shape + (3,)), xd_lat, tau_lat)


def _flat(grid: StaticGrid, c_lon, c_lat, device):
    batch = c_lon.shape[:-4]
    traj_len = constant(grid.traj_len, torch.int32, device)
    traj_len = traj_len[:, None, None].expand(c_lon.shape[:-1])
    return (c_lon.reshape(batch + (-1, 6)), c_lat.reshape(batch + (-1, 6)),
            traj_len.reshape(batch + (-1,)))


def velocity_window(velocity: torch.Tensor, a_max, horizon: float,
                    low_vel_threshold: float):
    """(v_min, v_max, low_vel) around the carried speed [...]: the
    velocity-keeping window (set_desired_velocity, reactive_planner.py:
    332-334) and the low-velocity mode, for every device cycle."""
    v_min = torch.clamp(velocity - 0.125 * horizon * a_max, min=0.0)
    v_max = torch.maximum(v_min + 5.0, velocity + 2.0)
    return v_min, v_max, velocity < low_vel_threshold


def velocity_keeping_candidates(x0_lon: torch.Tensor, x0_lat: torch.Tensor,
                                v_min: torch.Tensor, v_max: torch.Tensor,
                                low_vel, grid: StaticGrid):
    """The velocity-keeping candidate batch on the device.

    Returns (coeffs_lon [..., K, 6], coeffs_lat [..., K, 6], traj_len
    [..., K] int32) with K = Nt * Nv * (Nd + 1): FixedIntervalSampling's
    triple loop (sampling.py:218-242) as one broadcast evaluation of the
    closed-form quartics (lon) and quintics (lat).
    """
    v_g = linspace(v_min, v_max, grid.n_lon)                   # [..., Nv]
    T, V, D = _lattice(x0_lon, x0_lat, v_g, grid)
    c_lon = poly.quartic_coeffs(
        x0_lon[..., None, None, None, :].expand(T.shape + (3,)), V, T)
    c_lat = _lateral(c_lon, x0_lon, x0_lat, T, D, low_vel)
    return _flat(grid, c_lon, c_lat, x0_lon.device)


def stopping_candidates(x0_lon: torch.Tensor, x0_lat: torch.Tensor,
                        s_min: torch.Tensor, s_max: torch.Tensor,
                        low_vel, grid: StaticGrid):
    """Stopping-mode candidate batch: quintic longitudinal polynomials toward
    sampled stop positions with terminal velocity and acceleration zero
    (sampling.py:259-263), plus the goal-validity mask [..., K]
    (filter_goals_behind, trajectories.py:545-550)."""
    s_g = linspace(s_min, s_max, grid.n_lon)                   # [..., Ns]
    T, S, D = _lattice(x0_lon, x0_lat, s_g, grid)
    zeros = torch.zeros_like(S)
    c_lon = poly.quintic_coeffs(
        x0_lon[..., None, None, None, :].expand(T.shape + (3,)),
        torch.stack([S, zeros, zeros], dim=-1), T)
    c_lat = _lateral(c_lon, x0_lon, x0_lat, T, D, low_vel)
    cl, ca, tl = _flat(grid, c_lon, c_lat, x0_lon.device)
    goal_valid = x0_lon[..., 0].reshape(S.shape[:-3] + (1, 1, 1)) < S
    return cl, ca, tl, goal_valid.reshape(tl.shape)


class CorridorGrid(NamedTuple):
    """Dense corridor lattice tables for one sampling level (device scan
    counterpart of models.sampling.CorridorSampling.corridor_tables).

    Static shapes; the candidate set is the full (t, v, interval, d-slot)
    lattice with a validity mask (the host path compresses the same mask;
    lattice enumeration order matches, so argmin tie-breaking agrees).
    """

    t_values: Tuple[float, ...]       # [Nt]
    traj_len: Tuple[int, ...]         # [Nt]
    num: int                          # samples per interval at this level
    v_bounds: torch.Tensor            # [Nt, 2]
    lat: torch.Tensor                 # [Nt, I, 4] (s_lo, s_hi, d_lo, d_hi)
    lat_valid: torch.Tensor           # [Nt, I]

    @property
    def size(self) -> int:
        n_iv = self.lat.shape[1]
        return len(self.t_values) * self.num * n_iv * (self.num + 1)


def make_corridor_grid(sampling_space, level: int, dt: float,
                       device="cpu") -> CorridorGrid:
    """CorridorGrid from a CorridorSampling space with its corridor set."""
    ts, v_bounds, lat, lat_valid = sampling_space.corridor_tables(level)
    return CorridorGrid(
        t_values=tuple(float(t) for t in ts),
        traj_len=tuple(int(v) for v in traj_length_steps(ts, dt)),
        num=int(sampling_space._num_samples[level]),
        v_bounds=torch.as_tensor(np.asarray(v_bounds), dtype=torch.float32,
                                 device=device),
        lat=torch.as_tensor(np.asarray(lat), dtype=torch.float32,
                            device=device),
        lat_valid=torch.as_tensor(np.asarray(lat_valid), dtype=torch.bool,
                                  device=device))


def corridor_candidates(x0_lon: torch.Tensor, x0_lat: torch.Tensor,
                        cg: CorridorGrid):
    """Corridor-mode candidate batch on the device: the same broadcast
    (t, v, interval, d-slot) lattice as the host path
    (models.sampling.CorridorSampling.generate_trajectories_at_level,
    reference sampling.py:340-397), kept dense with a goal_valid mask
    instead of compressed on the host.

    Returns (coeffs_lon [K, 6], coeffs_lat [K, 6], traj_len [K],
    goal_valid [K]) with K = Nt * num * I * (num + 1).
    """
    dtype, device = x0_lon.dtype, x0_lon.device
    num = cg.num
    ts = constant(cg.t_values, dtype, device)                    # [Nt]
    vb = cg.v_bounds.to(dtype)
    lat = cg.lat.to(dtype)
    idx = torch.arange(num, dtype=dtype, device=device)

    def linspace_rows(lo, hi):
        # np.linspace's construction with the endpoint forced
        step = (hi - lo) / (num - 1)
        rows = lo[..., None] + idx * step[..., None]
        return torch.cat([rows[..., :-1], hi[..., None]], dim=-1)

    V = linspace_rows(vb[:, 0], vb[:, 1])                         # [Nt, num]
    v_keep = torch.cat([torch.ones_like(V[:, :1], dtype=torch.bool),
                        V[:, 1:] != V[:, :-1]], dim=1)

    c_lon = poly.quartic_coeffs(x0_lon.expand(V.shape + (3,)), V,
                                ts[:, None].expand(V.shape))      # [Nt,num,6]
    s_end = poly.eval_position(c_lon, ts[:, None].expand(V.shape))

    sel = (cg.lat_valid[:, None, :]
           & (lat[:, None, :, 0] <= s_end[:, :, None])
           & (s_end[:, :, None] <= lat[:, None, :, 1]))           # [Nt,num,I]

    d_lo, d_hi = lat[:, :, 2], lat[:, :, 3]                       # [Nt, I]
    D = linspace_rows(d_lo, d_hi)                                 # [Nt,I,num]
    inf = torch.full((), np.inf, dtype=dtype, device=device)
    zero_slot = torch.where((d_lo < 0) & (d_hi > 0),
                            torch.zeros((), dtype=dtype, device=device), inf)
    D_all = torch.cat([D, zero_slot[:, :, None]], dim=-1)
    D_sorted = torch.sort(D_all, dim=-1).values                   # [Nt,I,num+1]
    d_keep = torch.cat([torch.ones_like(D_sorted[..., :1], dtype=torch.bool),
                        D_sorted[..., 1:] != D_sorted[..., :-1]], dim=-1)
    d_keep = d_keep & torch.isfinite(D_sorted)
    # inf slots are masked out; zero them so lateral coefficients stay finite
    D_safe = torch.where(torch.isfinite(D_sorted), D_sorted,
                         torch.zeros((), dtype=dtype, device=device))

    mask = (sel & v_keep[:, :, None])[..., None] \
        & d_keep[:, None, :, :]                          # [Nt,num,I,num+1]
    shape = mask.shape
    T_g = ts[:, None, None, None].expand(shape)
    D_g = D_safe[:, None, :, :].expand(shape)
    c_lon_g = c_lon[:, :, None, None, :].expand(shape + (6,))

    # corridor sampling keeps tau_lat = t (host path, sampling.py:394)
    zeros = torch.zeros_like(D_g)
    c_lat = poly.quintic_coeffs(x0_lat.expand(shape + (3,)),
                                torch.stack([D_g, zeros, zeros], dim=-1), T_g)

    traj_len = constant(cg.traj_len, torch.int32, device)
    traj_len = traj_len[:, None, None, None].expand(shape)
    return (c_lon_g.reshape(-1, 6), c_lat.reshape(-1, 6),
            traj_len.reshape(-1), mask.reshape(-1))
