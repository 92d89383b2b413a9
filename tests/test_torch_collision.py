"""The exact collision checks of the conformance path: the port against the
JAX package.

* ``obb_collision_reference`` (the plain version of the CUDA collision
  kernel) against the TPU kernel ``obb_collision_pallas(...,
  interpret=True)`` on the inputs of ``tests/test_pallas_kernels.py``
  (seeds 0 and 1, K=300, T=21, M=3), plus M=0.
* ``check_collisions`` on OBB, disc and polygon rows and a ``segments``
  boundary, ``check_corridor``, ``check_collisions_continuous``,
  ``merge_obb_pairs`` and ``obb_segment_overlap`` against the JAX package's
  functions, in float32 and float64, on inputs made with numpy from a seed.

The bar is identical masks (merged boxes to float rounding).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from commonroad_rp_tpu.ops import collision as jax_co
from commonroad_rp_tpu.ops.pallas_kernels import obb_collision_pallas

from commonroad_rp_tpu_torch import interop
from commonroad_rp_tpu_torch.ops import collision as co
from commonroad_rp_tpu_torch.ops import collision_kernel as ck

DTYPES = {"float32": (torch.float32, jnp.float32),
          "float64": (torch.float64, jnp.float64)}
HL, HW, WB = 2.25, 0.8, 1.42


def _pallas_inputs(seed):
    """tests/test_pallas_kernels.py:14-30: ego rear-axle poses [K, T] and
    three OBB rows with random validity."""
    rng = np.random.default_rng(seed)
    K, T, M = 300, 21, 3
    x = rng.uniform(0, 100, (K, T)).astype(np.float32)
    y = rng.uniform(-5, 5, (K, T)).astype(np.float32)
    theta = rng.uniform(-0.5, 0.5, (K, T)).astype(np.float32)
    pose = np.stack([rng.uniform(0, 100, (M, T)), rng.uniform(-5, 5, (M, T)),
                     rng.uniform(-np.pi, np.pi, (M, T))],
                    axis=-1).astype(np.float32)
    half = rng.uniform(0.5, 3.0, (M, 2)).astype(np.float32)
    valid = rng.random((M, T)) > 0.2
    return x, y, theta, pose, half, valid


def _centers(x, y, theta, wb, dtype=torch.float32):
    """Step-major ego OBB centers as ``check_collisions`` builds them."""
    theta_t = torch.as_tensor(theta, dtype=dtype).T.contiguous()
    cx = (torch.as_tensor(x, dtype=dtype).T
          + wb * torch.cos(theta_t)).contiguous()
    cy = (torch.as_tensor(y, dtype=dtype).T
          + wb * torch.sin(theta_t)).contiguous()
    return cx, cy, theta_t


@pytest.mark.parametrize("seed", [0, 1])
def test_reference_matches_pallas_kernel(seed):
    x, y, theta, pose, half, valid = _pallas_inputs(seed)
    want = np.asarray(obb_collision_pallas(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(theta),
        jax_co.ObstacleArrays(pose=jnp.asarray(pose),
                              half_ext=jnp.asarray(half),
                              valid=jnp.asarray(valid)),
        jnp.float32(HL), jnp.float32(HW), jnp.float32(WB), interpret=True))
    obstacles = co.ObstacleArrays(pose=torch.as_tensor(pose),
                                  half_ext=torch.as_tensor(half),
                                  valid=torch.as_tensor(valid))
    cx, cy, theta_t = _centers(x, y, theta, float(np.float32(WB)))
    before = ck.obb_collision.launches
    got = ck.obb_collision(cx, cy, theta_t, obstacles,
                           float(np.float32(HL)), float(np.float32(HW)))
    assert ck.obb_collision.launches == before      # CPU: plain version
    assert want.any() and not want.all(), "degenerate test"
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        ck.obb_collision_reference(cx, cy, theta_t, obstacles, HL, HW)
        .numpy(), got.numpy())


def test_reference_without_obstacles():
    z = jnp.zeros((10, 5), jnp.float32)
    want = obb_collision_pallas(
        z, z, z, jax_co.ObstacleArrays(pose=jnp.zeros((0, 5, 3)),
                                       half_ext=jnp.zeros((0, 2)),
                                       valid=jnp.zeros((0, 5), dtype=bool)),
        jnp.float32(1.0), jnp.float32(1.0), jnp.float32(0.0), interpret=True)
    zt = torch.zeros((5, 10))
    obstacles = co.ObstacleArrays(pose=torch.zeros((0, 5, 3)),
                                  half_ext=torch.zeros((0, 2)),
                                  valid=torch.zeros((0, 5), dtype=torch.bool))
    for fn in (ck.obb_collision, ck.obb_collision_reference):
        got = fn(zt, zt, zt, obstacles, 1.0, 1.0)
        assert got.dtype == torch.bool and got.shape == (10,)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_kernel_operand_checks():
    """The wrapper's checks (run before every launch) reject what the kernel
    does not take."""
    x, y, theta, pose, half, valid = _pallas_inputs(0)
    obstacles = co.ObstacleArrays(pose=torch.as_tensor(pose),
                                  half_ext=torch.as_tensor(half),
                                  valid=torch.as_tensor(valid))
    cx, cy, theta_t = _centers(x, y, theta, WB)
    ck._check_operands(cx, cy, theta_t, obstacles)
    with pytest.raises(ValueError, match="float32 or float64"):
        ck._check_operands(cx.half(), cy, theta_t, obstacles)
    with pytest.raises(ValueError, match="theta"):
        ck._check_operands(cx, cy, theta_t.double(), obstacles)
    with pytest.raises(ValueError, match="cy"):
        ck._check_operands(cx, cy.T, theta_t, obstacles)
    with pytest.raises(ValueError, match="valid"):
        ck._check_operands(cx, cy, theta_t,
                           obstacles._replace(valid=obstacles.valid.int()))
    with pytest.raises(ValueError, match="radius"):
        ck._check_operands(cx, cy, theta_t, obstacles._replace(
            radius=torch.zeros(2)))


def _scene(seed, T=21, K=240):
    """Ego rear-axle poses [K, T] along a two-lane road, three OBB rows and
    two disc rows (one row without occupancy at the start), two convex
    polygon pieces of 4 and 5 vertices, and eight boundary segments."""
    rng = np.random.default_rng(seed)
    t = np.arange(T) * 0.1
    v = rng.uniform(5.0, 15.0, K)
    lat = rng.uniform(-1.5, 1.5, K)
    x = 5.0 + v[:, None] * t[None]
    y = rng.uniform(-4.5, 4.5, K)[:, None] + lat[:, None] * t[None]
    theta = np.broadcast_to(np.arctan2(lat, v)[:, None], (K, T)).copy()
    M = 5
    pose = np.zeros((M, T, 3))
    pose[..., 0] = rng.uniform(15.0, 40.0, M)[:, None] \
        + rng.uniform(0.0, 5.0, M)[:, None] * t[None]
    pose[..., 1] = rng.uniform(-4.0, 4.0, M)[:, None]
    pose[..., 2] = rng.uniform(-0.5, 0.5, M)[:, None]
    half = np.array([[2.2, 0.9], [1.5, 1.0], [3.0, 1.2], [0.0, 0.0],
                     [0.0, 0.0]])
    radius = np.array([0.0, 0.0, 0.0, 1.1, 0.7])
    valid = np.ones((M, T), bool)
    valid[1, :6] = False
    body4 = np.array([[-1.0, -0.8], [1.2, -0.8], [1.0, 0.9], [-1.1, 0.7]])
    body5 = np.array([[-1.5, -1.0], [1.5, -1.2], [2.0, 0.4], [0.0, 1.5],
                      [-1.8, 0.6]])
    verts = np.zeros((2, T, 5, 2))
    for m, (body, cx0, cy0) in enumerate(((body4, 28.0, -2.0),
                                          (body5, 20.0, 2.5))):
        padded = np.concatenate([body, np.repeat(body[-1:], 5 - len(body),
                                                 axis=0)])
        verts[m] = padded[None] + np.stack(
            [cx0 + 2.0 * t, cy0 - 0.5 * t], axis=1)[:, None, :]
    poly_valid = np.ones((2, T), bool)
    poly_valid[0, T // 2:] = False
    xs = np.linspace(0.0, 60.0, 5)
    segments = np.concatenate([
        np.stack([np.stack([xs[:-1], np.full(4, 5.5)], 1),
                  np.stack([xs[1:], np.full(4, 5.6)], 1)], 1),
        np.stack([np.stack([xs[:-1], np.full(4, -5.5)], 1),
                  np.stack([xs[1:], np.full(4, -5.4)], 1)], 1)])
    return dict(x=x, y=y, theta=theta, pose=pose, half_ext=half, valid=valid,
                radius=radius, poly_verts=verts, poly_valid=poly_valid,
                segments=segments, seg_valid=np.ones(len(segments), bool))


def _both(scene, dtype_name, *, discs=True, polys=True):
    """(JAX operands, port operands) of one scene in one dtype."""
    td, jd = DTYPES[dtype_name]
    j = {k: jnp.asarray(v, jd) if v.dtype.kind == "f" else jnp.asarray(v)
         for k, v in scene.items()}
    obstacles = jax_co.ObstacleArrays(
        pose=j["pose"], half_ext=j["half_ext"], valid=j["valid"],
        radius=j["radius"] if discs else None,
        poly_verts=j["poly_verts"] if polys else None,
        poly_valid=j["poly_valid"] if polys else None)
    boundary = jax_co.BoundaryArrays(segments=j["segments"],
                                     valid=j["seg_valid"])
    jax_ops = (j["x"], j["y"], j["theta"], obstacles, boundary)
    port_ops = tuple(interop.tensor(a, dtype=td) for a in jax_ops[:3]) + (
        interop.obstacles(obstacles, dtype=td),
        interop.boundary(boundary, dtype=td))
    return jax_ops, port_ops


@pytest.mark.parametrize("dtype_name", ["float32", "float64"])
@pytest.mark.parametrize("seed", [0, 1])
def test_check_collisions_matches_jax(seed, dtype_name):
    """OBB + disc + polygon rows and the ``segments`` boundary in one pass,
    and each group alone."""
    scene = _scene(seed)
    for discs, polys, with_boundary in ((True, True, True),
                                        (True, False, False),
                                        (False, True, False),
                                        (False, False, True)):
        jax_ops, port_ops = _both(scene, dtype_name, discs=discs,
                                  polys=polys)
        (jx, jy, jt, jobs, jb), (px, py, pt, pobs, pb) = jax_ops, port_ops
        want = np.asarray(jax_co.check_collisions(
            jx, jy, jt, jobs, jb if with_boundary else None,
            jnp.asarray(HL), jnp.asarray(HW), jnp.asarray(WB)))
        got = co.check_collisions(px, py, pt, pobs,
                                  pb if with_boundary else None, HL, HW, WB)
        assert want.any() and not want.all(), "degenerate test"
        np.testing.assert_array_equal(
            got.numpy(), want, err_msg=f"discs={discs} polys={polys} "
            f"boundary={with_boundary}")


@pytest.mark.parametrize("dtype_name", ["float32", "float64"])
def test_check_collisions_continuous_matches_jax(dtype_name):
    jax_ops, port_ops = _both(_scene(2), dtype_name)
    (jx, jy, jt, jobs, _), (px, py, pt, pobs, _) = jax_ops, port_ops
    want = np.asarray(jax_co.check_collisions_continuous(
        jx, jy, jt, jobs, jnp.asarray(HL), jnp.asarray(HW), jnp.asarray(WB)))
    got = co.check_collisions_continuous(px, py, pt, pobs, HL, HW, WB)
    assert want.any() and not want.all(), "degenerate test"
    np.testing.assert_array_equal(got.numpy(), want)
    # the swept pass covers the discrete one
    assert bool(torch.all(got | ~co.check_collisions(
        px, py, pt, pobs, None, HL, HW, WB)))


@pytest.mark.parametrize("dtype_name", ["float32", "float64"])
def test_merge_obb_pairs_and_segment_overlap_match_jax(dtype_name):
    td, jd = DTYPES[dtype_name]
    scene = _scene(3, K=64)
    rng = np.random.default_rng(3)
    center = np.stack([scene["x"], scene["y"]], axis=-1)
    half = np.stack([rng.uniform(0.5, 2.5, 64), rng.uniform(0.3, 1.2, 64)],
                    axis=-1)
    want = jax_co.merge_obb_pairs(jnp.asarray(center, jd),
                                  jnp.asarray(scene["theta"], jd),
                                  jnp.asarray(half, jd))
    got = co.merge_obb_pairs(torch.as_tensor(center, dtype=td),
                             torch.as_tensor(scene["theta"], dtype=td),
                             torch.as_tensor(half, dtype=td))
    rtol = 1e-6 if dtype_name == "float32" else 1e-13
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol,
                                   atol=rtol)

    seg = scene["segments"]
    shape = lambda a: a[:, None]                       # [K, 1, ...] x [B]
    want = jax_co.obb_segment_overlap(
        shape(jnp.asarray(center[:, 0], jd)),
        shape(jnp.asarray(scene["theta"][:, 0], jd)),
        shape(jnp.asarray(half, jd)), jnp.asarray(seg[:, 0], jd),
        jnp.asarray(seg[:, 1], jd))
    got = co.obb_segment_overlap(
        shape(torch.as_tensor(center[:, 0], dtype=td)),
        shape(torch.as_tensor(scene["theta"][:, 0], dtype=td)),
        shape(torch.as_tensor(half, dtype=td)),
        torch.as_tensor(seg[:, 0], dtype=td),
        torch.as_tensor(seg[:, 1], dtype=td))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype_name", ["float32", "float64"])
def test_check_corridor_matches_jax(dtype_name):
    """d-band probes on a road whose band narrows and widens, with an
    ``active`` step mask."""
    td, jd = DTYPES[dtype_name]
    rng = np.random.default_rng(4)
    K, T, P = 300, 21, 80
    ref_s = np.cumsum(rng.uniform(0.8, 1.2, P)) - 1.0
    d_hi = np.round(3.0 + np.sin(ref_s / 9.0) * 1024.0) / 1024.0
    d_lo = -np.round((3.2 + np.cos(ref_s / 7.0)) * 1024.0) / 1024.0
    s = rng.uniform(0.0, 60.0, K)[:, None] + np.linspace(0, 15, T)[None]
    d = rng.uniform(-1.5, 1.5, K)[:, None] \
        + rng.uniform(-0.5, 0.5, K)[:, None] * np.linspace(0, 1, T)[None]
    theta_cl = rng.uniform(-0.2, 0.2, (K, T))
    active = np.arange(T)[None] < rng.integers(5, T + 1, K)[:, None]
    j = lambda a: jnp.asarray(a, jd)
    t = lambda a: torch.as_tensor(a, dtype=td)
    for act in (None, active):
        want = np.asarray(jax_co.check_corridor(
            j(s), j(d), j(theta_cl), j(ref_s),
            jax_co.CorridorArrays(d_lo=j(d_lo), d_hi=j(d_hi)), j(HL), j(HW),
            j(WB), active=None if act is None else jnp.asarray(act)))
        got = co.check_corridor(
            t(s), t(d), t(theta_cl), t(ref_s),
            co.CorridorArrays(d_lo=t(d_lo), d_hi=t(d_hi)), HL, HW, WB,
            active=None if act is None else torch.as_tensor(act))
        assert want.any() and not want.all(), "degenerate test"
        np.testing.assert_array_equal(got.numpy(), want)


def test_pad_obstacles_matches_jax():
    jax_ops, port_ops = _both(_scene(5), "float64")
    want = jax_co.pad_obstacles(jax_ops[3], 8)
    got = co.pad_obstacles(port_ops[3], 8)
    for name in ("pose", "half_ext", "valid", "radius"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert got.poly_verts is port_ops[3].poly_verts
    assert co.pad_obstacles(got, 8) is got
