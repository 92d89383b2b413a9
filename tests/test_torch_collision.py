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


# ---- the redesigned kernel's pair test, skip and shared memory (CPU side)

SCENES = ("hostile0", "hostile1", "near_touching", "scene")
_HARNESS = r"""
#include <vector>
template <typename S>
static void run(const S* cx, const S* cy, const S* th, const S* ec,
                const S* es, const S* pose, const S* oc, const S* os,
                const S* half, const uint8_t* valid, const S* radius, S ehl,
                S ehw, int K, int T, int M, uint8_t* out, long* headings) {
  const int n = T * M;
  std::vector<S> buf(5 * n + 3 * M);
  std::vector<uint8_t> vb(n);
  const Rows<S> rows{buf.data(), vb.data(), n, M};
  const S r_ego = dhypot(ehl, ehw);
  for (int m = 0; m < M; ++m) {
    rows.ohl(m) = half[2 * m];
    rows.ohw(m) = half[2 * m + 1];
    rows.rad(m) = radius[m];
  }
  for (int i = 0; i < n; ++i) {     // as stage_rows, cos/sin given
    const int m = i / T, t = i % T, j = t * M + m;
    rows.ox(j) = pose[3 * i];
    rows.oy(j) = pose[3 * i + 1];
    rows.oc(j) = oc[j];
    rows.os(j) = os[j];
    rows.reach2(j) = skip_reach2(
        r_ego + row_radius(half[2 * m], half[2 * m + 1], radius[m]),
        pose[3 * i + 2]);
    rows.valid[j] = valid[i];
  }
  for (int k = 0; k < K; ++k) {
    bool hit = false;
    for (int t = 0; t < T && !hit; ++t) {
      const int a = t * K + k;
      hit = step_hits(rows, t, M, cx[a], cy[a], th[a], ehl, ehw,
                      [&](S, S& c, S& s) {
                        c = ec[a];
                        s = es[a];
                        ++*headings;
                      });
    }
    out[k] = hit ? 1 : 0;
  }
}
#define ENTRY(name, S)                                                     \
  extern "C" void name(const S* cx, const S* cy, const S* th, const S* ec, \
                       const S* es, const S* pose, const S* oc,           \
                       const S* os, const S* half, const uint8_t* valid,  \
                       const S* radius, S ehl, S ehw, int K, int T, int M, \
                       uint8_t* out, long* headings) {                     \
    run<S>(cx, cy, th, ec, es, pose, oc, os, half, valid, radius, ehl, ehw, \
           K, T, M, out, headings);                                        \
  }
ENTRY(run_f32, float)
ENTRY(run_f64, double)
"""


@pytest.fixture(scope="module")
def pair_test(tmp_path_factory):
    """The pair test, the skip and the step loop of ``csrc/collision.cu``
    (plain C++ once ``__device__`` is defined away) compiled with g++ into
    a loop over candidates and steps that stages the rows as the kernel
    does, with the plain version's cos/sin."""
    import ctypes
    import shutil
    import subprocess

    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the pair test")
    text = ck.KERNEL_SOURCE.read_text()
    body = text[text.index("// ---- the pair test and the skip"):
                text.index("// ---- end of the part compiled on the CPU")]
    tmp = tmp_path_factory.mktemp("pair_test")
    source = tmp / "pair_test.cpp"
    source.write_text("#include <math.h>\n#include <stdint.h>\n"
                      "#define __device__\n#define __forceinline__ inline\n"
                      + body + _HARNESS)
    lib_path = tmp / "libpair_test.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared",
                    "-fPIC", "-o", str(lib_path), str(source)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, scalar in (("run_f32", ctypes.c_float),
                         ("run_f64", ctypes.c_double)):
        getattr(lib, name).argtypes = [p] * 11 + [scalar, scalar, i, i, i, p,
                                                  p]
    return lib


def _compiled_mask(lib, ops):
    """(mask [K], headings computed) of the g++-compiled step loop on
    single-problem CPU operands, with the cos/sin the plain version
    computes (the same expressions on the same tensors)."""
    import ctypes

    cx, cy, theta, obstacles, ehl, ehw = ops
    (T, K), M = cx.shape, obstacles.pose.shape[0]
    otheta = obstacles.pose[..., 2].T[:, :, None]             # as the plain
    arrays = [cx, cy, theta, torch.cos(theta), torch.sin(theta),
              obstacles.pose, torch.cos(otheta).reshape(T, M),
              torch.sin(otheta).reshape(T, M), obstacles.half_ext,
              obstacles.valid.to(torch.uint8),
              torch.zeros(M, dtype=cx.dtype) if obstacles.radius is None
              else obstacles.radius]
    arrays = [np.ascontiguousarray(a.numpy()) for a in arrays]
    out = np.zeros(K, np.uint8)
    headings = ctypes.c_long(0)
    fn = lib.run_f32 if cx.dtype == torch.float32 else lib.run_f64
    fn(*(a.ctypes.data_as(ctypes.c_void_p) for a in arrays), float(ehl),
       float(ehw), K, T, M, out.ctypes.data_as(ctypes.c_void_p),
       ctypes.byref(headings))
    return out.astype(bool), headings.value


def _fleet_case(name, dtype_name):
    """Fleet-form CPU operands of one of ``SCENES``."""
    from commonroad_rp_tpu_torch.probes import hostile_collision as hc

    td = DTYPES[dtype_name][0]
    nd = np.float32 if dtype_name == "float32" else np.float64
    tensor = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=td)
    if name.startswith("hostile"):
        case = hc.hostile_collision(int(name[-1]), nd)
    elif name == "near_touching":
        case = hc.near_touching_collision(3, nd, F=2, K=300, T=21)
    else:
        scene = _scene(6)
        _, port = _both(scene, dtype_name, polys=False)
        px, py, pt, obstacles, _ = port
        cx = (px.T + WB * torch.cos(pt.T)).contiguous()
        cy = (py.T + WB * torch.sin(pt.T)).contiguous()
        return (cx[None], cy[None], pt.T.contiguous()[None],
                co.ObstacleArrays(pose=obstacles.pose[None],
                                  half_ext=obstacles.half_ext[None],
                                  valid=obstacles.valid[None],
                                  radius=obstacles.radius[None]),
                torch.tensor([HL], dtype=td), torch.tensor([HW], dtype=td))
    return hc.fleet_operands(case, tensor, torch.as_tensor)


@pytest.mark.parametrize("dtype_name", ["float32", "float64"])
@pytest.mark.parametrize("scene", SCENES)
def test_staged_pair_test_equals_reference(pair_test, scene, dtype_name):
    """The kernel's step loop (staged rows, the bounding-circle skip, the
    lazy ego heading, the pair test), compiled with g++, gives
    ``obb_collision_reference``'s mask on every problem: skip boundaries
    and 1 ulp either side, touching boxes and discs, invalid rows, NaN,
    inf, huge and subnormal poses, hostile extents."""
    from commonroad_rp_tpu_torch.probes import hostile_collision as hc

    ops = _fleet_case(scene, dtype_name)
    F, T, K = ops[0].shape
    hits = headings = 0
    for f in range(F):
        one = hc.problem_operands(ops, f)
        # the whole horizon, then each step alone (past a candidate's first
        # hit the horizon's mask sees nothing)
        for t in [None] + list(range(T)):
            if t is not None:
                cx, cy, theta, rows, ehl, ehw = one
                step = lambda a: a[t:t + 1].contiguous()
                row_step = lambda a: a[:, t:t + 1].contiguous()
                one_t = (step(cx), step(cy), step(theta), rows._replace(
                    pose=row_step(rows.pose), valid=row_step(rows.valid)),
                    ehl, ehw)
            else:
                one_t = one
            want = ck.obb_collision_reference(*one_t).numpy()
            got, n_head = _compiled_mask(pair_test, one_t)
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"problem {f} step {t}")
            np.testing.assert_array_equal(ck.obb_collision(*one_t).numpy(),
                                          want)
            if t is not None:
                hits += int(want.sum())
                headings += n_head
    assert 0 < hits < F * T * K, "degenerate test"
    # the skip left candidate-steps without a heading to compute (the
    # near-touching scene has none: every step is near a row)
    assert headings <= F * T * K
    assert scene == "near_touching" or headings < F * T * K


def _pair_hits(ops):
    """[F, T, M, K]: the plain version's verdict on every (step, row) pair
    alone, valid or not (each pair as a problem of one step and one row)."""
    cx, cy, theta, obstacles, ehl, ehw = ops
    F, T, K = cx.shape
    M = obstacles.pose.shape[1]
    n = F * T * M
    ego = lambda a: a[:, :, None].expand(F, T, M, K).reshape(n, 1, K) \
        .contiguous()
    per_pair = lambda a: a[:, None].expand(F, T, M, *a.shape[2:]) \
        .reshape(n, 1, *a.shape[2:]).contiguous()
    ext = lambda e: e[:, None, None].expand(F, T, M).reshape(n).contiguous()
    rows = co.ObstacleArrays(
        pose=obstacles.pose.transpose(1, 2).reshape(n, 1, 1, 3).contiguous(),
        half_ext=per_pair(obstacles.half_ext),
        valid=torch.ones((n, 1, 1), dtype=torch.bool),
        radius=per_pair(obstacles.radius))
    return ck.obb_collision_fleet_reference(
        ego(cx), ego(cy), ego(theta), rows, ext(ehl), ext(ehw)) \
        .reshape(F, T, M, K)


@pytest.mark.parametrize("dtype_name", ["float32", "float64"])
@pytest.mark.parametrize("scene", SCENES)
def test_skipped_pairs_miss_the_full_test(scene, dtype_name):
    """Every pair the skip removes (``far_pairs_reference``, the plain
    version of the kernel's predicate) is a miss of the full test, and the
    skip removes pairs on every scene."""
    ops = _fleet_case(scene, dtype_name)
    far = ck.far_pairs_reference(*ops)
    hits = _pair_hits(ops)
    assert far.any() and hits.any()
    assert not bool((far & hits).any()), \
        torch.nonzero(far & hits)[:10].tolist()


def test_shared_bytes_count_what_a_collision_block_stages():
    """5 values per (step, row) and 3 per row in the operands' type, then a
    valid byte per (step, row); the limit leaves the step groups' static
    flags (256 ints, in whole KB) inside the 227 KB a block may have."""
    for M, T in ((0, 1), (1, 21), (5, 21), (16, 61), (300, 21)):
        for dtype, size in ((torch.float32, 4), (torch.float64, 8)):
            assert ck.shared_bytes(M, T, dtype) \
                == size * (5 * M * T + 3 * M) + M * T
    assert ck.shared_bytes(5, 21, torch.float32) == 2265
    assert ck.shared_bytes(16, 61, torch.float64) == 40400
    assert 256 * 4 <= 227 * 1024 - ck.SHARED_BLOCK_LIMIT == 1024
    assert (ck.max_rows(21, torch.float32), ck.max_rows(21, torch.float64),
            ck.max_rows(61, torch.float64)) == (510, 261, 91)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("fleet", [False, True])
def test_launch_rejects_rows_past_the_shared_memory_limit(fleet, dtype):
    """One row more than a block's shared memory holds raises by shape
    alone, naming the bytes it would need; at the limit the shape passes
    and the device check speaks.  Nothing falls back to the plain
    version."""
    T, K = 21, 64
    M = ck.max_rows(T, dtype)
    assert ck.shared_bytes(M, T, dtype) <= ck.SHARED_BLOCK_LIMIT \
        < ck.shared_bytes(M + 1, T, dtype)
    lead = (3,) if fleet else ()
    meta = lambda *shape, dt=dtype: torch.empty(*lead, *shape, dtype=dt,
                                                device="meta")
    ops = lambda m: (meta(T, K), meta(T, K), meta(T, K), co.ObstacleArrays(
        pose=meta(m, T, 3), half_ext=meta(m, 2),
        valid=meta(m, T, dt=torch.bool), radius=meta(m)))
    call = (lambda m: ck.obb_collision_fleet(*ops(m), meta(), meta())) \
        if fleet else (lambda m: ck.obb_collision(*ops(m), HL, HW))
    wrapper = ck.obb_collision_fleet if fleet else ck.obb_collision
    before = wrapper.launches
    with pytest.raises(ValueError, match=f"{M + 1} obstacle rows over {T} "
                       f"steps .* need {ck.shared_bytes(M + 1, T, dtype)} "
                       "bytes of shared memory per block"):
        call(M + 1)
    with pytest.raises(ValueError, match="unsupported device meta"):
        call(M)
    assert wrapper.launches == before
