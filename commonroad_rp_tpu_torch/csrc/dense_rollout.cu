// The dense XLA fleet cycle's candidate pass for NVIDIA Hopper (sm_90a): F
// problems' K candidates each rolled out over T steps, checked, costed and
// corridor-tested in one launch (dense_rollout_kernel), and the chosen
// candidate of each problem walked again for the states the selection reads
// (dense_winner_kernel).
//
// Replaces no TPU kernel: the JAX package leaves this path
// (commonroad_rp_tpu/parallel/fleet.py, _single_problem_cycle under
// jax.vmap) to XLA's fusion.  In the port it replaces the plain PyTorch
// passes that composed it over [T, F, K] arrays -- ops/kinematics.py rollout
// (s_last given), ops/cost.py default_cost, ops/collision.py check_corridor
// and the ego-centre lines of _check_collisions_fleet -- which are kept,
// unchanged, as the plain version
// commonroad_rp_tpu_torch/ops/dense_rollout.py::dense_rollout_reference.
// Those passes made some 1,000 memory passes a cycle over intermediates the
// selection never reads; here a candidate's T steps live in registers and
// only the collision kernel's operands leave the thread.
//
// Function, for candidate k of problem f (blockIdx.y = f):
//   * the rollout: the quartic/quintic evaluation (the lateral polynomial
//     over travelled arclength s - s_0 in low-velocity mode), the near-zero
//     clamps, the prefilter, the Werling transform, the reference-table
//     interpolation with numpy's wrap at the table's ends, the standstill
//     heading hold, global curvature, speed and acceleration, the five
//     constraint checks on every active step (t < traj_len), the projection
//     domain bounded by s_last (the route's true end), the Frenet->Cartesian
//     position, and the constant-acceleration extension (enlarge) past
//     traj_len;
//   * the default cost's sums over the T steps and its picks at T/2, T-1;
//   * the corridor test: three probes along the ego box at every step,
//     clamped to s_last, against the band row of the probe's segment;
//   * outputs: the collision kernel's operands cx, cy, theta [F, T, K]
//     (the ego box centre wb_rear_axle ahead of the rear axle, and the
//     heading), written by thread k at [f, t, k] so a warp's stores
//     coalesce; feasible, cost and the corridor mask [F, K].  Nothing else
//     of the bundle is written.
// dense_winner_kernel stages each problem in one warp's block and walks its
// candidate best[f] in one thread through the same walk, and writes, at step
// replan_offset, s, s_dot, s_ddot, d, d_dot, d_ddot, theta_gl, v, x, y,
// kappa_gl, and v at step lookahead: by construction the values the bundle
// holds there.
//
// Design:
//  * A block stages its problem once in dynamic shared memory: the vehicle
//    scalars, the orientation, the low-velocity flag, s_last and the desired
//    speed, then the arclength column and the corridor bands [P] each
//    (ops/dense_rollout.py shared_bytes).  The table's other columns are
//    read where they lie (__ldg): a candidate touches a few neighbouring
//    rows per step.
//  * Every table lookup is a hinted search in shared memory (count_nle_hint:
//    gallop from the previous step's count, bisect the bracket), which
//    returns torch.searchsorted(..., right=True)'s count for every query, a
//    NaN included (it counts as above every row).
//  * One thread walks one candidate's T steps with every value in
//    registers; sin and cos of one heading come from one sincos, and the
//    extension's constant headings reuse the last active step's.  No
//    candidate ends early: every check, the domain test and the corridor
//    test run on every candidate.
//
// What bounds it on the card: about 59 M candidate-steps at fleet1024 (F =
// 1,024, K = 2,754, T = 21), some 200 float operations and eight
// transcendentals each (about 0.15 ms at 67 TFLOP/s), against 0.71 GB of
// pose stores and 0.15 GB of coefficient loads a launch (about 0.27 ms at
// 3.35 TB/s): the bytes, by a little.  chip_smoke.py counts both sides from
// the run's inputs (dense_rollout_bound); the benchmark's yardstick for the
// scoring work alone is at least 12 GFLOP a cycle.
//
// Templated over float and double: float is what the fleet configurations
// state, double serves float64 fleets.  Numerics: built without fast math,
// with IEEE division and square root and without FMA contraction
// (-fmad=false), each expression in the plain version's operation order, so
// every operation rounds as its separate tensor operations do on the card
// (where a division by a host scalar is a multiply by its reciprocal).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// ---- the per-candidate walk (plain C++ once __device__ and __forceinline__
// are defined away and __ldg is a plain load:
// tests/test_torch_dense_rollout.py compiles this part with g++)

__device__ __forceinline__ float dabs(float x) { return fabsf(x); }
__device__ __forceinline__ double dabs(double x) { return fabs(x); }
__device__ __forceinline__ float dtan(float x) { return tanf(x); }
__device__ __forceinline__ double dtan(double x) { return tan(x); }
__device__ __forceinline__ float datan2(float y, float x) {
  return atan2f(y, x);
}
__device__ __forceinline__ double datan2(double y, double x) {
  return atan2(y, x);
}
__device__ __forceinline__ float dcos(float x) { return cosf(x); }
__device__ __forceinline__ double dcos(double x) { return cos(x); }
__device__ __forceinline__ float dtrunc(float x) { return truncf(x); }
__device__ __forceinline__ double dtrunc(double x) { return trunc(x); }
__device__ __forceinline__ float drint(float x) { return rintf(x); }
__device__ __forceinline__ double drint(double x) { return rint(x); }
// sin and cos of one angle: the values of sinf and cosf (sin, cos)
__device__ __forceinline__ void dsincos(float x, float* s, float* c) {
  sincosf(x, s, c);
}
__device__ __forceinline__ void dsincos(double x, double* s, double* c) {
  sincos(x, s, c);
}

// count(!(row > q)) over the rows [lo, hi) of an increasing column, by
// bisection: the rows that pass form a prefix, all of them for a NaN q
template <typename S>
__device__ __forceinline__ int bisect_nle(const S* col, int lo, int hi, S q) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (!(col[mid] > q)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// torch.searchsorted(col, q, right=True) from a hint (any earlier count in
// [0, P], or < 0 for none): gallops from the hint, in the direction the row
// at the hint gives, in steps of 1, 2, 4, ... until the count is bracketed,
// then bisects the bracket.  Every bracket [lo, hi] below keeps lo <= count
// <= hi, since "!(row > q)" holds on a prefix of the rows.
template <typename S>
__device__ __forceinline__ int count_nle_hint(const S* col, int P, S q,
                                              int hint) {
  if (hint < 0) return bisect_nle(col, 0, P, q);
  int lo, hi, step = 1;
  if (hint < P && !(col[hint] > q)) {   // count > hint
    lo = hint + 1;
    for (;;) {
      const int i = lo + step - 1;
      if (i >= P) {
        hi = P;
        break;
      }
      if (!(col[i] > q)) {
        lo = i + 1;
        step <<= 1;
      } else {
        hi = i;
        break;
      }
    }
  } else {                              // count <= hint
    hi = hint;
    for (;;) {
      const int i = hi - step;
      if (i < 0) {
        lo = 0;
        break;
      }
      if (!(col[i] > q)) {
        lo = i + 1;
        break;
      }
      hi = i;
      step <<= 1;
    }
  }
  return bisect_nle(col, lo, hi, q);
}

// One problem as a thread sees it: the staged columns, the table's other
// columns where they lie, and the problem's scalars.
template <typename S>
struct DenseProblem {
  const S* col;       // [P] arclengths
  const S* band_lo;   // [P] corridor bands
  const S* band_hi;
  const S* theta;     // [P] unwrapped orientation
  const S* curv;      // [P]
  const S* curv_d;    // [P]
  const S* points;    // [P, 2]
  const S* tangent;   // [P, 2]
  const S* normal;    // [P, 2]
  int P;
  S wheelbase, wb_rear, a_max, v_switch, kappa_max, v_delta_max, half_len,
      half_wid, x0_theta, desired_v, s_last;
  bool low_vel;
  S dt;
};

// A step's values after the extension (the bundle's arrays at [k, t]), with
// cos/sin of the global heading.
template <typename S>
struct StepState {
  S s, s_dot, s_ddot, d, d_dot, d_ddot, theta_cl, theta_gl, x, y, v, a,
      kappa_gl, e_cos, e_sin;
};

template <typename S>
struct Verdict {
  bool feasible;   // kinematics and projection domain
  bool corridor;   // a corridor probe left its band
  S cost;
};

// the XLA fleet cycle's default cost (ops/cost.py default_cost as
// parallel/fleet.py called it): acceleration weight w_a and the lateral
// target desired_d; no stop target
constexpr double kWa = 5.0, kDesiredD = 0.0;

// torch.minimum: a NaN in either operand gives NaN
template <typename S>
__device__ __forceinline__ S min_nan(S a, S b) {
  return (a != a || a < b) ? a : b;
}

// Candidate k's walk over its T steps (cl, ca its coefficient rows,
// traj_len its valid steps): calls visit(t, state) at every step and
// returns the verdict.  Every expression is the plain version's, in its
// operation order (ops/kinematics.py rollout, ops/cost.py default_cost,
// ops/collision.py _check_corridor_fleet and the ego centres of
// _check_collisions_fleet).
template <typename S, class Visit>
__device__ __forceinline__ Verdict<S> walk_candidate(
    const DenseProblem<S>& pb, const S* cl, const S* ca, int traj_len, int T,
    Visit& visit) {
  const S zero = S(0), one = S(1);
  const S eps = S(1e-5);
  const S two_pi = S(2.0 * 3.14159265358979323846);
  const S dt = pb.dt;
  // a tensor divided by a host scalar is multiplied by its reciprocal on the
  // card (PyTorch's div_true_kernel_cuda)
  const S inv_dt = one / dt, inv_two_pi = one / two_pi;
  const S inv_1e5 = one / S(1e5);
  const int P = pb.P;
  const int last = min(max(traj_len - 1, 0), T - 1);
  const int t_mid = T / 2;

  bool pre_acc = false, pre_vel = false, any_viol = false, domain_ok = true,
       corridor = false;
  bool held = false;
  S hold = zero, s0 = zero, prev_theta = zero, prev_kappa = zero;
  S sum_a = zero, sum_v = zero, sum_d = zero, sum_th = zero, v_mid = zero;
  S cum_x = zero, cum_y = zero;
  int hint = -1, probe_hints[3] = {-1, -1, -1};
  // the last active step's values (the padded zeros when there is none);
  // the extension's headings are constant, so their cos/sin carry over
  S a_last = zero, v_last = zero, x_last = zero, y_last = zero,
    th_last = zero, kappa_last = zero, s_lst = zero, sdot_last = zero,
    sddot_last = zero, d_lst = zero, ddot_last = zero, dddot_last = zero,
    thcl_last = zero;
  S e_cos = one, e_sin = zero, c_cl = one, s_cl = zero;
  StepState<S> st;

  for (int t = 0; t < T; ++t) {
    if (t < traj_len) {
      // ---- polynomials (low-velocity mode: d over travelled s)
      const S tau = S(t) * dt;
      S t1 = tau, t2 = t1 * t1, t3 = t2 * t1, t4 = t2 * t2, t5 = t4 * t1;
      const S s = cl[0] + cl[1] * t1 + cl[2] * t2 + cl[3] * t3 +
                  cl[4] * t4 + cl[5] * t5;
      S s_dot = cl[1] + S(2) * cl[2] * t1 + S(3) * cl[3] * t2 +
                S(4) * cl[4] * t3 + S(5) * cl[5] * t4;
      const S s_ddot = S(2) * cl[2] + S(6) * cl[3] * t1 +
                       S(12) * cl[4] * t2 + S(20) * cl[5] * t3;
      if (t == 0) s0 = s;
      t1 = pb.low_vel ? s - s0 : tau;
      t2 = t1 * t1;
      t3 = t2 * t1;
      t4 = t2 * t2;
      t5 = t4 * t1;
      const S d = ca[0] + ca[1] * t1 + ca[2] * t2 + ca[3] * t3 +
                  ca[4] * t4 + ca[5] * t5;
      S d_dot = ca[1] + S(2) * ca[2] * t1 + S(3) * ca[3] * t2 +
                S(4) * ca[4] * t3 + S(5) * ca[5] * t4;
      const S d_ddot = S(2) * ca[2] + S(6) * ca[3] * t1 +
                       S(12) * ca[4] * t2 + S(20) * ca[5] * t3;
      if (dabs(s_dot) < eps) s_dot = zero;
      if (dabs(d_dot) < eps) d_dot = zero;
      pre_acc = pre_acc || dabs(s_ddot) > pb.a_max;
      pre_vel = pre_vel || s_dot < -eps;

      // ---- Werling transform
      const bool moving = s_dot > S(0.001);
      const S sv_safe = moving ? s_dot : one;
      const S dp_high = moving ? d_dot / sv_safe : zero;
      const S ddot_w = d_ddot - dp_high * s_ddot;
      const S dpp_high = moving ? ddot_w / (sv_safe * sv_safe) : zero;
      const S dp = pb.low_vel ? d_dot : dp_high;
      const S dpp = pb.low_vel ? d_ddot : dpp_high;

      // ---- reference rows: idx = count - 1, -1 from the last row on,
      // numpy's wrap for -1 and past the end
      const int count = count_nle_hint(pb.col, P, s, hint);
      hint = count;
      int idx = count - 1;
      if (s >= pb.col[P - 1]) idx = -1;
      const int lo = idx < 0 ? idx + P : idx;
      const int hi = lo + 1 == P ? 0 : lo + 1;
      const S s_lo = pb.col[lo], s_hi = pb.col[hi];
      const S lam = (s - s_lo) / (s_hi - s_lo);
      const S th_lo = __ldg(pb.theta + lo);
      const S raw = (__ldg(pb.theta + hi) - th_lo) * (s - s_lo) /
                        (s_hi - s_lo) + th_lo;
      const S interp_theta = raw - two_pi * dtrunc(raw * inv_two_pi);

      // ---- orientations, the standstill hold
      const S theta_cl_move = datan2(dp, one);
      const S theta_gl_move = theta_cl_move + interp_theta;
      const bool use_move = moving || pb.low_vel;
      if (use_move) {
        hold = theta_gl_move;
        held = true;
      }
      const S theta_gl = held ? hold : pb.x0_theta;
      const S theta_cl = use_move ? theta_cl_move : theta_gl - interp_theta;

      const S k_lo = __ldg(pb.curv + lo);
      const S k_r = (__ldg(pb.curv + hi) - k_lo) * lam + k_lo;
      const S kd_lo = __ldg(pb.curv_d + lo);
      const S k_r_d = (__ldg(pb.curv_d + hi) - kd_lo) * lam + kd_lo;

      // ---- global curvature, speed, acceleration
      const S one_krd = one - k_r * d;
      dsincos(theta_cl, &s_cl, &c_cl);
      const S tan_t = dtan(theta_cl);
      const S q = c_cl / one_krd;
      const S kappa_gl =
          (dpp + (k_r * dp + k_r_d * d) * tan_t) * c_cl * (q * q) + q * k_r;
      const S v = s_dot * (one_krd / c_cl);
      const S a = s_ddot * one_krd / c_cl +
                  ((s_dot * s_dot) / c_cl) *
                      (one_krd * tan_t * (kappa_gl * one_krd / c_cl - k_r) -
                       (k_r_d * d + k_r * dp));

      // ---- the five constraint checks
      const bool vel_viol = v < -eps;
      const bool kappa_viol = dabs(kappa_gl) > pb.kappa_max;
      const S yaw = (t == 0 ? zero : theta_gl - prev_theta) * inv_dt;
      const S yaw_r = drint(yaw * S(1e5)) * inv_1e5;
      const bool yaw_viol = dabs(yaw_r) > pb.kappa_max * v;
      const S c_st = dcos(datan2(pb.wheelbase * kappa_gl, one));
      const S kd_max = pb.v_delta_max / (pb.wheelbase * (c_st * c_st));
      const bool kd_viol =
          dabs((t == 0 ? zero : kappa_gl - prev_kappa) * inv_dt) > kd_max;
      const bool fast = v > pb.v_switch;
      const S v_safe = fast ? v : one;
      const S a_hi = fast ? pb.a_max * pb.v_switch / v_safe : pb.a_max;
      const bool acc_viol = a < -pb.a_max || a > a_hi;
      any_viol = any_viol || vel_viol || kappa_viol || yaw_viol || kd_viol ||
                 acc_viol;
      prev_theta = theta_gl;
      prev_kappa = kappa_gl;

      // ---- Frenet -> Cartesian over segment clamp(count - 1, 0, P - 2),
      // the projection domain
      const int seg = min(max(count - 1, 0), P - 2);
      const S ds = s - pb.col[seg];
      const S* pt = pb.points + 2 * seg;
      const S* tg = pb.tangent + 2 * seg;
      const S* nm = pb.normal + 2 * seg;
      const S x = __ldg(pt) + ds * __ldg(tg) + d * __ldg(nm);
      const S y = __ldg(pt + 1) + ds * __ldg(tg + 1) + d * __ldg(nm + 1);
      domain_ok = domain_ok && s >= pb.col[0] && s <= pb.s_last &&
                  one_krd > zero && dabs(d) < S(20.0 - 0.1);
      dsincos(theta_gl, &e_sin, &e_cos);

      st = {s, s_dot, s_ddot, d, d_dot, d_ddot, theta_cl, theta_gl, x, y, v,
            a, kappa_gl, e_cos, e_sin};
      if (t == last) {
        a_last = a;
        v_last = v;
        x_last = x;
        y_last = y;
        th_last = theta_gl;
        kappa_last = kappa_gl;
        s_lst = s;
        sdot_last = s_dot;
        sddot_last = s_ddot;
        d_lst = d;
        ddot_last = d_dot;
        dddot_last = d_ddot;
        thcl_last = theta_cl;
      }
    } else {
      // ---- the constant-acceleration extension (enlarge); the prefilter
      // sees the padded zeros of these steps
      pre_acc = pre_acc || dabs(zero) > pb.a_max;
      const S t_rel = S(t - (traj_len - 1)) * dt;
      S v_temp = v_last + t_rel * a_last;
      v_temp = v_temp * S(v_temp >= zero);
      cum_x = cum_x + dt * v_temp * e_cos;
      cum_y = cum_y + dt * v_temp * e_sin;
      st = {s_lst + t_rel * sdot_last,
            sdot_last * S(sdot_last >= zero),
            sddot_last,
            d_lst + t_rel * ddot_last,
            ddot_last,
            dddot_last,
            thcl_last,
            th_last,
            x_last + cum_x,
            y_last + cum_y,
            v_temp,
            a_last,
            kappa_last,
            e_cos,
            e_sin};
    }

    // ---- default cost sums (desired_s unset)
    const S wa = S(kWa) * st.a;
    sum_a = sum_a + wa * wa;
    const S ev = S(5) * (st.v - pb.desired_v);
    sum_v = sum_v + ev * ev;
    const S ed = S(0.25) * (S(kDesiredD) - st.d);
    sum_d = sum_d + ed * ed;
    const S eth = S(0.25) * dabs(st.theta_cl);
    sum_th = sum_th + eth * eth;
    if (t == t_mid) v_mid = st.v;

    // ---- corridor: three probes along the ego box, clamped to s_last
    const S s_center = st.s + pb.wb_rear * c_cl;
    const S d_center = st.d + pb.wb_rear * s_cl;
    const S lat_ext = pb.half_wid * dabs(c_cl) + pb.half_len * dabs(s_cl);
    const S lon_ext = pb.half_len * dabs(c_cl) + pb.half_wid * dabs(s_cl);
    const S d_plus = d_center + lat_ext;
    const S d_minus = d_center - lat_ext;
    const S offsets[3] = {S(0), S(-1), S(1)};
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      const S q = min_nan(s_center + offsets[p] * lon_ext, pb.s_last);
      // each probe starts from its own count of the step before: the three
      // searches are independent chains
      const int c = count_nle_hint(pb.col, P, q, probe_hints[p]);
      probe_hints[p] = c;
      const int row = min(max(c - 1, 0), P - 1);
      corridor = corridor || d_plus > pb.band_hi[row] ||
                 d_minus < pb.band_lo[row];
    }
    visit(t, st);
  }

  // ---- the cost's terminal and mid-horizon terms (st holds step T - 1)
  S cost = sum_a;
  const S e_end = st.v - pb.desired_v, e_mid = v_mid - pb.desired_v;
  cost = cost + (sum_v + S(50) * (e_end * e_end) + S(100) * (e_mid * e_mid));
  const S ed_end = S(20) * (S(kDesiredD) - st.d);
  cost = cost + (sum_d + ed_end * ed_end);
  const S eth_end = S(5) * dabs(st.theta_cl);
  cost = cost + (sum_th + eth_end * eth_end);
  return {!(pre_acc || pre_vel) && !any_viol && domain_ok, corridor, cost};
}

// Writes the collision kernel's operands of one step: the ego box centre and
// heading at [t, k] of the problem's [T, K] pose arrays.
template <typename S>
struct PoseWriter {
  S* cx;
  S* cy;
  S* theta;
  int K;
  S wb_rear;
  __device__ __forceinline__ void operator()(int t, const StepState<S>& st) {
    const size_t i = (size_t)t * K;
    cx[i] = st.x + wb_rear * st.e_cos;
    cy[i] = st.y + wb_rear * st.e_sin;
    theta[i] = st.theta_gl;
  }
};

// The states the selection and the standstill fallback read: at step r
// (s, s_dot, s_ddot, d, d_dot, d_ddot, theta_gl, v, x, y, kappa_gl) and v
// at step lookahead.
template <typename S>
struct WinnerStates {
  S* out;   // [12]
  int r, lookahead;
  __device__ __forceinline__ void operator()(int t, const StepState<S>& st) {
    if (t == r) {
      out[0] = st.s;
      out[1] = st.s_dot;
      out[2] = st.s_ddot;
      out[3] = st.d;
      out[4] = st.d_dot;
      out[5] = st.d_ddot;
      out[6] = st.theta_gl;
      out[7] = st.v;
      out[8] = st.x;
      out[9] = st.y;
      out[10] = st.kappa_gl;
    }
    if (t == lookahead) out[11] = st.v;
  }
};

// ---- end of the part compiled on the CPU

// 128 threads a block (64 and 256 measured no faster on an H100): 96
// registers in float, 198 in double, no spills
constexpr int kThreads = 128;
// the winner kernel: one warp a problem, which stages it for one thread
constexpr int kWinnerThreads = 32;
// staged scalars (SCAL_*), rounded up so the columns stay 16-byte aligned
enum {
  SCAL_WHEELBASE, SCAL_WB_REAR, SCAL_A_MAX, SCAL_V_SWITCH, SCAL_KAPPA_MAX,
  SCAL_V_DELTA_MAX, SCAL_HALF_LEN, SCAL_HALF_WID, SCAL_X0_THETA,
  SCAL_LOW_VEL, SCAL_S_LAST, SCAL_DESIRED_V, SCAL_NUM
};
constexpr int kScalStaged = 16;
// the most shared memory one block may have on sm_90, static and dynamic
constexpr long kSharedPerBlock = 227 * 1024;

// Dynamic shared memory (bytes) of one block: the scalars, then the
// arclength column and the two bands (ops/dense_rollout.py::shared_bytes
// computes the same).
inline long staged_bytes(int P, int size) {
  return (long)size * (kScalStaged + 3L * P);
}

// The operands of both kernels (ops/dense_rollout.py OPERANDS, in order),
// every array contiguous with a leading problem axis F.
template <typename S>
struct Operands {
  const S* coeffs_lon;     // [F, K, 6]
  const S* coeffs_lat;     // [F, K, 6]
  const int* traj_len;     // [F, K]
  const S* ref_s;          // [F, P]
  const S* ref_theta;      // [F, P]
  const S* ref_curv;       // [F, P]
  const S* ref_curv_d;     // [F, P]
  const S* ref_points;     // [F, P, 2]
  const S* ref_tangent;    // [F, P, 2]
  const S* ref_normal;     // [F, P, 2]
  const S* band_lo;        // [F, P]
  const S* band_hi;        // [F, P]
  const S* veh[8];         // [F] each: kinematics.VehicleArrays' order
  const S* orientation;    // [F]
  const uint8_t* low_vel;  // [F] bool
  const S* s_last;         // [F]
  const S* desired_speed;  // [F]
};
constexpr int kOperands = 24;

template <typename S>
Operands<S> unpack(const void* const* ptr) {
  Operands<S> o;
  o.coeffs_lon = static_cast<const S*>(ptr[0]);
  o.coeffs_lat = static_cast<const S*>(ptr[1]);
  o.traj_len = static_cast<const int*>(ptr[2]);
  o.ref_s = static_cast<const S*>(ptr[3]);
  o.ref_theta = static_cast<const S*>(ptr[4]);
  o.ref_curv = static_cast<const S*>(ptr[5]);
  o.ref_curv_d = static_cast<const S*>(ptr[6]);
  o.ref_points = static_cast<const S*>(ptr[7]);
  o.ref_tangent = static_cast<const S*>(ptr[8]);
  o.ref_normal = static_cast<const S*>(ptr[9]);
  o.band_lo = static_cast<const S*>(ptr[10]);
  o.band_hi = static_cast<const S*>(ptr[11]);
  for (int i = 0; i < 8; ++i) o.veh[i] = static_cast<const S*>(ptr[12 + i]);
  o.orientation = static_cast<const S*>(ptr[20]);
  o.low_vel = static_cast<const uint8_t*>(ptr[21]);
  o.s_last = static_cast<const S*>(ptr[22]);
  o.desired_speed = static_cast<const S*>(ptr[23]);
  return o;
}

// Problem f's scalar at slot i, read from the operands.
template <typename S>
__device__ __forceinline__ S problem_scalar(const Operands<S>& o, size_t f,
                                            int i) {
  if (i < 8) return __ldg(o.veh[i] + f);
  switch (i) {
    case SCAL_X0_THETA:
      return __ldg(o.orientation + f);
    case SCAL_LOW_VEL:
      return __ldg(o.low_vel + f) ? S(1) : S(0);
    case SCAL_S_LAST:
      return __ldg(o.s_last + f);
    default:
      return __ldg(o.desired_speed + f);
  }
}

extern __shared__ __align__(16) unsigned char crp_dense_smem[];

// The block's threads stage problem f in shared memory (its scalars, the
// arclength column and the two bands); ends with a barrier.  Returns the
// problem as one thread sees it.
template <typename S>
__device__ __forceinline__ DenseProblem<S> stage_problem(const Operands<S>& o,
                                                         size_t f, int P,
                                                         S dt) {
  S* scal = reinterpret_cast<S*>(crp_dense_smem);
  S* col = scal + kScalStaged;
  S* lo = col + P;
  S* hi = lo + P;
  const size_t fp = f * (size_t)P;
  for (int i = threadIdx.x; i < SCAL_NUM; i += blockDim.x)
    scal[i] = problem_scalar(o, f, i);
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    col[i] = __ldg(o.ref_s + fp + i);
    lo[i] = __ldg(o.band_lo + fp + i);
    hi[i] = __ldg(o.band_hi + fp + i);
  }
  __syncthreads();
  DenseProblem<S> pb;
  pb.col = col;
  pb.band_lo = lo;
  pb.band_hi = hi;
  pb.theta = o.ref_theta + fp;
  pb.curv = o.ref_curv + fp;
  pb.curv_d = o.ref_curv_d + fp;
  pb.points = o.ref_points + 2 * fp;
  pb.tangent = o.ref_tangent + 2 * fp;
  pb.normal = o.ref_normal + 2 * fp;
  pb.P = P;
  pb.wheelbase = scal[SCAL_WHEELBASE];
  pb.wb_rear = scal[SCAL_WB_REAR];
  pb.a_max = scal[SCAL_A_MAX];
  pb.v_switch = scal[SCAL_V_SWITCH];
  pb.kappa_max = scal[SCAL_KAPPA_MAX];
  pb.v_delta_max = scal[SCAL_V_DELTA_MAX];
  pb.half_len = scal[SCAL_HALF_LEN];
  pb.half_wid = scal[SCAL_HALF_WID];
  pb.x0_theta = scal[SCAL_X0_THETA];
  pb.low_vel = scal[SCAL_LOW_VEL] > S(0.5);
  pb.s_last = scal[SCAL_S_LAST];
  pb.desired_v = scal[SCAL_DESIRED_V];
  pb.dt = dt;
  return pb;
}

// candidate fk's coefficient rows
template <typename S>
__device__ __forceinline__ void load_candidate(const Operands<S>& o,
                                               size_t fk, S* cl, S* ca) {
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    cl[i] = __ldg(o.coeffs_lon + fk * 6 + i);
    ca[i] = __ldg(o.coeffs_lat + fk * 6 + i);
  }
}

// Problem f = blockIdx.y, candidate k = blockIdx.x * blockDim.x +
// threadIdx.x.  The block stages its problem, then each thread walks its
// candidate and writes its poses [f, t, k] and its three verdicts [f, k].
template <typename S>
__global__ void __launch_bounds__(kThreads) dense_rollout_kernel(
    Operands<S> o, S dt, int K, int P, int T,
    S* __restrict__ cx, S* __restrict__ cy, S* __restrict__ theta,
    uint8_t* __restrict__ feasible, S* __restrict__ cost,
    uint8_t* __restrict__ corridor) {
  const size_t f = blockIdx.y;
  const DenseProblem<S> pb = stage_problem(o, f, P, dt);
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  const size_t fk = f * (size_t)K + k;
  S cl[6], ca[6];
  load_candidate(o, fk, cl, ca);
  const size_t base = f * (size_t)T * K + k;
  PoseWriter<S> poses{cx + base, cy + base, theta + base, K, pb.wb_rear};
  const Verdict<S> v =
      walk_candidate(pb, cl, ca, __ldg(o.traj_len + fk), T, poses);
  feasible[fk] = v.feasible ? 1 : 0;
  cost[fk] = v.cost;
  corridor[fk] = v.corridor ? 1 : 0;
}

// Problem f = blockIdx.x: a warp stages the problem, then its first thread
// walks candidate best[f] (an index outside [0, K) gives NaN rows) and
// writes its states into out [F, 12].  The staged column keeps the walk's
// searches in shared memory: the walk is one thread's chain of dependent
// loads.
template <typename S>
__global__ void __launch_bounds__(kWinnerThreads) dense_winner_kernel(
    Operands<S> o, S dt, const long long* __restrict__ best,
    int K, int P, int T, int r, int lookahead, S* __restrict__ out) {
  const size_t f = blockIdx.x;
  const DenseProblem<S> pb = stage_problem(o, f, P, dt);
  if (threadIdx.x != 0) return;
  S* row = out + f * 12;
  const long long k = __ldg(best + f);
  if (k < 0 || k >= K) {
    for (int i = 0; i < 12; ++i) row[i] = S(NAN);
    return;
  }
  const size_t fk = f * (size_t)K + k;
  S cl[6], ca[6];
  load_candidate(o, fk, cl, ca);
  WinnerStates<S> states{row, r, lookahead};
  walk_candidate(pb, cl, ca, __ldg(o.traj_len + fk), T, states);
}

// Raises a kernel's dynamic shared-memory limit when a launch needs more
// than the 48 KB a kernel gets unasked (once per size reached); returns a
// CUDA error code, or 0.
template <typename Kernel>
int fit_shared(Kernel kernel, long smem_bytes, int* raised_to) {
  if (smem_bytes > kSharedPerBlock) return (int)cudaErrorInvalidValue;
  if (smem_bytes <= 48 * 1024 || smem_bytes <= *raised_to) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  if (err != cudaSuccess) return (int)err;
  *raised_to = (int)smem_bytes;
  return 0;
}

template <typename S>
int launch_rollout(const void* const* ptr, double dt, int F, int K, int P,
                   int T,
                   void* const* out, void* stream) {
  static int raised_to = 0;
  if (F <= 0 || K <= 0) return 0;
  if (F > 65535 || P < 2 || T < 1) return (int)cudaErrorInvalidConfiguration;
  const long smem = staged_bytes(P, sizeof(S));
  const int rc = fit_shared(dense_rollout_kernel<S>, smem, &raised_to);
  if (rc != 0) return rc;
  const dim3 blocks((K + kThreads - 1) / kThreads, F);
  dense_rollout_kernel<S><<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      unpack<S>(ptr), S(dt), K, P, T,
      static_cast<S*>(out[0]), static_cast<S*>(out[1]),
      static_cast<S*>(out[2]), static_cast<uint8_t*>(out[3]),
      static_cast<S*>(out[4]), static_cast<uint8_t*>(out[5]));
  return (int)cudaGetLastError();
}

template <typename S>
int launch_winner(const void* const* ptr, double dt, const void* best, int F,
                  int K, int P, int T, int r, int lookahead, void* out,
                  void* stream) {
  static int raised_to = 0;
  if (F <= 0) return 0;
  if (P < 2 || T < 1) return (int)cudaErrorInvalidConfiguration;
  const long smem = staged_bytes(P, sizeof(S));
  const int rc = fit_shared(dense_winner_kernel<S>, smem, &raised_to);
  if (rc != 0) return rc;
  dense_winner_kernel<S><<<F, kWinnerThreads, smem, (cudaStream_t)stream>>>(
      unpack<S>(ptr), S(dt),
      static_cast<const long long*>(best), K, P, T, r, lookahead,
      static_cast<S*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// operands: the kOperands pointers of Operands, in order; out: cx, cy,
// theta [F, T, K], feasible [F, K] (bool bytes), cost [F, K], corridor
// [F, K] (bool bytes).  All contiguous, floats in the entry's type.
extern "C" int crp_dense_rollout_f32(const void* const* operands, double dt,
                                     int F, int K, int P, int T,
                                     void* const* out, void* stream) {
  return launch_rollout<float>(operands, dt, F, K, P, T, out, stream);
}

extern "C" int crp_dense_rollout_f64(const void* const* operands, double dt,
                                     int F, int K, int P, int T,
                                     void* const* out, void* stream) {
  return launch_rollout<double>(operands, dt, F, K, P, T, out, stream);
}

// The operands of crp_dense_rollout_*, best [F] (int64) and the two steps;
// out: [F, 12].
extern "C" int crp_dense_winner_f32(const void* const* operands, double dt,
                                    const void* best, int F, int K, int P,
                                    int T, int r, int lookahead, void* out,
                                    void* stream) {
  return launch_winner<float>(operands, dt, best, F, K, P, T, r, lookahead,
                              out, stream);
}

extern "C" int crp_dense_winner_f64(const void* const* operands, double dt,
                                    const void* best, int F, int K, int P,
                                    int T, int r, int lookahead, void* out,
                                    void* stream) {
  return launch_winner<double>(operands, dt, best, F, K, P, T, r, lookahead,
                               out, stream);
}

// Dynamic shared memory (bytes) of one rollout block at P rows of size-byte
// floats.
extern "C" long crp_dense_shared_bytes(int P, int size) {
  return staged_bytes(P, size);
}

// The most dynamic shared memory (bytes) a rollout block may ask for, or -1.
extern "C" long crp_dense_shared_limit() {
  cudaFuncAttributes f32, f64;
  if (cudaFuncGetAttributes(&f32, dense_rollout_kernel<float>) !=
          cudaSuccess ||
      cudaFuncGetAttributes(&f64, dense_rollout_kernel<double>) !=
          cudaSuccess)
    return -1;
  size_t fixed = f32.sharedSizeBytes;
  if (f64.sharedSizeBytes > fixed) fixed = f64.sharedSizeBytes;
  return kSharedPerBlock - (long)fixed;
}
