"""The dense XLA fleet cycle's kernel (``csrc/dense_rollout.cu``) on the CPU.

The kernel's per-candidate walk (everything between ``// ---- the
per-candidate walk`` and ``// ---- end of the part compiled on the CPU``:
plain C++ once ``__device__`` and ``__forceinline__`` are defined away and
``__ldg`` is a plain load) is compiled with g++ (``-ffp-contract=off``, as
the kernel is built with ``-fmad=false``) into a loop over problems and
candidates, and held to the plain version
``ops.dense_rollout.dense_rollout_reference`` on the first cycle of the
12-problem heterogeneous fleet (three of its members at standstill, in
low-velocity mode), as it starts and with every member whose route is
shorter than the fleet's longest moved 8 m before its route's end, in
float32 and float64.  The wrapper's CPU path and its operand checks are
pinned here too; the kernel itself runs in ``tests/test_torch_gpu.py``.

The two sides differ in the last bits where they should: glibc's
sin/cos/tan/atan2 against PyTorch's vectorized CPU functions, the card's
multiply by a host scalar's reciprocal against the CPU's division, and the
CPU's cumulative sum, which accumulates in double.  So a verdict may flip
only on a candidate whose feasibility, corridor or domain margin is that
small (counted and bounded below; none flips in these cases), costs agree
to a relative 1e-5 (float32; 2.5e-6 measured) or 1e-12 (float64; 1.1e-15)
and poses to 1e-4 m (float32; 3.1e-5 measured) or 1e-12 m (float64;
5.7e-14).
"""

import ctypes
import logging
import shutil
import subprocess

import numpy as np
import pytest
import torch

import chip_smoke
from commonroad_rp_tpu_torch.ops import dense_rollout as dr
from commonroad_rp_tpu_torch.run_fleet import (DT, N_STEPS,
                                               heterogeneous_fleet)

logging.getLogger("RP_LOGGER").setLevel(logging.CRITICAL)

# the most candidates of the 12 x 2754 whose feasibility or corridor verdict
# may differ: those whose margin is within the last bits (see above)
MAX_FLIPS = 2
TOLERANCE = {"float32": dict(cost=1e-5, pose=1e-4),
             "float64": dict(cost=1e-12, pose=1e-12)}

_HARNESS = r"""
template <typename S>
static DenseProblem<S> view(const S* const* cols, const S* scal, int f,
                            int P, double dt) {
  const size_t fp = (size_t)f * P;
  DenseProblem<S> pb;
  pb.col = cols[0] + fp;
  pb.band_lo = cols[1] + fp;
  pb.band_hi = cols[2] + fp;
  pb.theta = cols[3] + fp;
  pb.curv = cols[4] + fp;
  pb.curv_d = cols[5] + fp;
  pb.points = cols[6] + 2 * fp;
  pb.tangent = cols[7] + 2 * fp;
  pb.normal = cols[8] + 2 * fp;
  pb.P = P;
  const S* q = scal + 12 * f;
  pb.wheelbase = q[0];
  pb.wb_rear = q[1];
  pb.a_max = q[2];
  pb.v_switch = q[3];
  pb.kappa_max = q[4];
  pb.v_delta_max = q[5];
  pb.half_len = q[6];
  pb.half_wid = q[7];
  pb.x0_theta = q[8];
  pb.low_vel = q[9] > S(0.5);
  pb.s_last = q[10];
  pb.desired_v = q[11];
  pb.dt = S(dt);
  return pb;
}

template <typename S>
static void rollout(const S* coeffs_lon, const S* coeffs_lat,
                    const int* traj_len, const S* const* cols, const S* scal,
                    double dt, int F, int K, int P, int T, S* cx, S* cy,
                    S* theta, uint8_t* feasible, S* cost, uint8_t* corridor) {
  for (int f = 0; f < F; ++f) {
    const DenseProblem<S> pb = view(cols, scal, f, P, dt);
    for (int k = 0; k < K; ++k) {
      const size_t fk = (size_t)f * K + k;
      const size_t base = (size_t)f * T * K + k;
      PoseWriter<S> poses{cx + base, cy + base, theta + base, K, pb.wb_rear};
      const Verdict<S> v = walk_candidate(pb, coeffs_lon + 6 * fk,
                                          coeffs_lat + 6 * fk, traj_len[fk],
                                          T, poses);
      feasible[fk] = v.feasible;
      cost[fk] = v.cost;
      corridor[fk] = v.corridor;
    }
  }
}

template <typename S>
static void winner(const S* coeffs_lon, const S* coeffs_lat,
                   const int* traj_len, const S* const* cols, const S* scal,
                   double dt, const long long* best, int F, int K, int P,
                   int T, int r, int lookahead, S* out) {
  for (int f = 0; f < F; ++f) {
    const DenseProblem<S> pb = view(cols, scal, f, P, dt);
    const size_t fk = (size_t)f * K + best[f];
    WinnerStates<S> states{out + 12 * f, r, lookahead};
    walk_candidate(pb, coeffs_lon + 6 * fk, coeffs_lat + 6 * fk,
                   traj_len[fk], T, states);
  }
}

#define ENTRY(suffix, S)                                                     \
  extern "C" void rollout_##suffix(                                          \
      const S* cl, const S* ca, const int* tl, const S* const* cols,         \
      const S* scal, double dt, int F, int K, int P, int T, S* cx, S* cy,    \
      S* theta, uint8_t* feasible, S* cost, uint8_t* corridor) {             \
    rollout<S>(cl, ca, tl, cols, scal, dt, F, K, P, T, cx, cy, theta,        \
               feasible, cost, corridor);                                    \
  }                                                                          \
  extern "C" void winner_##suffix(                                           \
      const S* cl, const S* ca, const int* tl, const S* const* cols,         \
      const S* scal, double dt, const long long* best, int F, int K, int P,  \
      int T, int r, int lookahead, S* out) {                                 \
    winner<S>(cl, ca, tl, cols, scal, dt, best, F, K, P, T, r, lookahead,    \
              out);                                                          \
  }
ENTRY(f32, float)
ENTRY(f64, double)
"""


@pytest.fixture(scope="module")
def walk(tmp_path_factory):
    """The kernel's walk compiled with g++ into ``rollout_f32/f64`` (every
    candidate of every problem) and ``winner_f32/f64`` (one candidate a
    problem)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel's walk")
    text = dr.KERNEL_SOURCE.read_text()
    body = text[text.index("// ---- the per-candidate walk"):
                text.index("// ---- end of the part compiled on the CPU")]
    tmp = tmp_path_factory.mktemp("dense_walk")
    source = tmp / "walk.cpp"
    source.write_text(
        "#include <math.h>\n#include <stddef.h>\n#include <stdint.h>\n"
        "#include <algorithm>\nusing std::max;\nusing std::min;\n"
        "#define __device__\n#define __forceinline__ inline\n"
        "#define __ldg(p) (*(p))\n" + body + _HARNESS)
    lib_path = tmp / "libwalk.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared",
                    "-fPIC", "-o", str(lib_path), str(source)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for suffix in ("f32", "f64"):
        getattr(lib, f"rollout_{suffix}").argtypes = \
            [p] * 5 + [d] + [i] * 4 + [p] * 6
        getattr(lib, f"winner_{suffix}").argtypes = \
            [p] * 5 + [d] + [p] + [i] * 6 + [p]
    return lib


@pytest.fixture(scope="module")
def fleet12():
    """The 12-problem heterogeneous fleet (level 3, T = 21) on the CPU: its
    scene and its first cycle's carry."""
    torch.set_num_threads(2)
    scene, carry, _, _ = heterogeneous_fleet(12, 1, device="cpu")
    return scene, carry


def _inputs(fleet12, case, dtype):
    """The first cycle's ``DenseInputs`` of the fleet (``case`` "start" or
    "route_end": every member on a route shorter than the longest moved 8 m
    before its end) in ``dtype``."""
    scene, carry = fleet12
    return chip_smoke.dense_first_cycle(torch, scene, carry, dtype,
                                        route_end=case == "route_end")


def _np(t):
    return np.ascontiguousarray(t.numpy())


def _compiled(lib, inp, best=None, r=1, lookahead=10):
    """The compiled walk on ``inp``: (cx, cy, theta, feasible, cost,
    corridor) as numpy arrays, or with ``best`` [F] the winner rows
    [F, 12]."""
    F, K = inp.traj_len.shape
    P = inp.ref.s.shape[1]
    T = N_STEPS + 1
    nd = np.float32 if inp.coeffs_lon.dtype == torch.float32 else np.float64
    suffix = "f32" if nd is np.float32 else "f64"
    ref = inp.ref
    cols = [_np(t) for t in (ref.s, inp.corridor_lo, inp.corridor_hi,
                             ref.theta, ref.curv, ref.curv_d, ref.points,
                             ref.tangent, ref.normal)]
    col_ptrs = (ctypes.c_void_p * len(cols))(
        *(c.ctypes.data for c in cols))
    scal = np.ascontiguousarray(np.stack(
        [_np(x) for x in inp.veh] + [_np(inp.orientation),
                                     _np(inp.low_vel).astype(nd),
                                     _np(inp.s_last),
                                     _np(inp.desired_speed)], axis=1)
        .astype(nd))
    keep = [_np(inp.coeffs_lon), _np(inp.coeffs_lat), _np(inp.traj_len)]
    args = [a.ctypes.data for a in keep] + [ctypes.cast(col_ptrs,
                                                        ctypes.c_void_p),
                                            scal.ctypes.data, DT]
    if best is not None:
        out = np.zeros((F, 12), nd)
        best = _np(best).astype(np.int64)
        getattr(lib, f"winner_{suffix}")(*args, best.ctypes.data, F, K, P, T,
                                         r, lookahead, out.ctypes.data)
        return out
    poses = [np.zeros((F, T, K), nd) for _ in range(3)]
    feasible = np.zeros((F, K), np.uint8)
    cost = np.zeros((F, K), nd)
    corridor = np.zeros((F, K), np.uint8)
    getattr(lib, f"rollout_{suffix}")(
        *args, F, K, P, T, *(a.ctypes.data for a in (*poses, feasible, cost,
                                                     corridor)))
    return (*poses, feasible.astype(bool), cost, corridor.astype(bool))


@pytest.mark.parametrize("dtype_name", ["float32", "float64"])
@pytest.mark.parametrize("case", ["start", "route_end"])
def test_compiled_walk_equals_plain_version(walk, fleet12, case,
                                            dtype_name):
    """The kernel's walk, compiled with g++, against
    ``dense_rollout_reference`` on the fleet's first cycle: feasibility and
    corridor verdicts equal but for at most ``MAX_FLIPS`` candidates, costs
    and poses within ``TOLERANCE``, and the winner walk's headings equal to
    the compiled pass's and its states to the plain bundle's at the winners."""
    dtype = getattr(torch, dtype_name)
    tol = TOLERANCE[dtype_name]
    inp = _inputs(fleet12, case, dtype)
    want = dr.dense_rollout_reference(inp, DT, N_STEPS)
    cx, cy, theta, feasible, cost, corridor = _compiled(walk, inp)

    flips = int((feasible != want.feasible.numpy()).sum()
                + (corridor != want.corridor.numpy()).sum())
    assert flips <= MAX_FLIPS, f"{flips} flipped verdicts"
    # the case exercises every verdict, and the low-velocity members
    ok = feasible & ~corridor
    assert 0 < ok.sum() < ok.size and corridor.any() and not feasible.all()
    assert bool(inp.low_vel.any()) and bool(ok[inp.low_vel.numpy()].any())
    np.testing.assert_allclose(cost, want.cost.numpy(), rtol=tol["cost"],
                               atol=0)
    for got, ref in ((cx, want.cx), (cy, want.cy), (theta, want.theta)):
        np.testing.assert_allclose(got, ref.numpy(), rtol=0,
                                   atol=tol["pose"])

    # the winners of the plain version's selection (corridor and
    # feasibility alone): the winner walk gives the pass's own values
    masked = torch.where(want.feasible & ~want.corridor, want.cost,
                         torch.full_like(want.cost, np.inf))
    best = torch.argmin(masked, dim=1)
    rows = _compiled(walk, inp, best=best, r=1, lookahead=10)
    f = np.arange(best.shape[0])
    b = best.numpy()
    np.testing.assert_array_equal(rows[:, 6], theta[f, 1, b])
    plain = dr.dense_winner_reference(want, best, 1, 10).numpy()
    np.testing.assert_allclose(rows, plain, rtol=tol["cost"],
                               atol=tol["pose"])
    if case == "route_end":
        # members moved before their route's end: some candidates leave
        # the projection domain there
        short = (inp.s_last < inp.s_last.max() - 1.0).numpy()
        assert not feasible[short].all()


def test_wrapper_runs_the_plain_version_on_the_cpu(fleet12):
    """CPU tensors take the plain version and launch nothing: the wrapper's
    result and winner rows are the reference's, bit for bit."""
    inp = _inputs(fleet12, "start", torch.float32)
    before = (dr.dense_rollout.launches, dr.dense_winner.launches)
    got = dr.dense_rollout(inp, DT, N_STEPS)
    want = dr.dense_rollout_reference(inp, DT, N_STEPS)
    for a, b in zip(got[:6], want[:6]):
        assert torch.equal(a, b)
    best = torch.argmin(want.cost, dim=1)
    assert torch.equal(dr.dense_winner(inp, got, best, DT, N_STEPS, 1, 10),
                       dr.dense_winner_reference(want, best, 1, 10))
    assert (dr.dense_rollout.launches, dr.dense_winner.launches) == before


def _with_rows(inp, P):
    """``inp`` with reference tables and bands of P rows (meta tensors)."""
    F = inp.traj_len.shape[0]
    rows = lambda t: torch.empty((F, P) + tuple(t.shape[2:]), dtype=t.dtype,
                                 device=t.device)
    return inp._replace(ref=type(inp.ref)(*map(rows, inp.ref)),
                        corridor_lo=rows(inp.corridor_lo),
                        corridor_hi=rows(inp.corridor_hi))


@pytest.mark.parametrize("fault", ["dtype", "shape", "strided", "traj_len",
                                   "low_vel", "shared", "device"])
def test_launch_rejects_operands(fleet12, fault):
    """The kernel's operand checks raise ``ValueError`` naming the operand,
    or the shared memory a block's staged tables would need past
    ``SHARED_BLOCK_LIMIT`` (a float32 row stages 12 bytes), before anything
    is built or launched (operands on the meta device, the device check
    last)."""
    inp = _inputs(fleet12, "start", torch.float32)
    meta = lambda t: t.to("meta")
    inp = dr.DenseInputs(*(type(x)(*map(meta, x)) if isinstance(x, tuple)
                           else meta(x) for x in inp))
    bad = {"dtype": inp._replace(s_last=inp.s_last.double()),
           "shape": inp._replace(desired_speed=inp.desired_speed[:-1]),
           "strided": inp._replace(corridor_lo=inp.corridor_lo.t()
                                   .contiguous().t()),
           "traj_len": inp._replace(traj_len=inp.traj_len.long()),
           "low_vel": inp._replace(low_vel=inp.low_vel.float()),
           "shared": _with_rows(inp, dr.SHARED_BLOCK_LIMIT // 12 + 1),
           "device": inp}[fault]
    match = {"dtype": "s_last", "shape": "desired_speed",
             "strided": "corridor_lo", "traj_len": "traj_len",
             "low_vel": "low_vel", "shared": "shared memory",
             "device": "unsupported device"}[fault]
    with pytest.raises(ValueError, match=match):
        dr._operands(bad, "dense_rollout")


def test_shared_bytes_count_what_a_block_stages():
    """A block stages 16 scalars and three [P] columns."""
    assert dr.shared_bytes(512, torch.float32) == 4 * (16 + 3 * 512)
    assert dr.shared_bytes(512, torch.float64) == 8 * (16 + 3 * 512)
