// Fused candidate scorer for NVIDIA Hopper (sm_90a): one planning problem
// (score_kernel) or a fleet of them in one launch (fleet_score_kernel).
//
// Replaces the TPU kernels of commonroad_rp_tpu/ops/pallas_cycle.py:
//   _scoring_kernel      (launched by _score_candidates_pallas at T <= 32),
//   _scoring_kernel_ps   (the same body with per-step table windows, T > 32),
//   _fleet_scoring_kernel (the same body over a (problem, K-tile) grid,
//                          launched by _score_fleet_pallas),
// all three computing _scoring_body.  The plain PyTorch versions are
// commonroad_rp_tpu_torch/ops/scoring.py::score_candidates_reference and
// ::score_fleet_reference.  The TPU's per-step table windows are a VMEM
// schedule: here every table lookup is a binary search plus a load, so one
// kernel serves both horizons.
//
// Design: one thread per candidate, with a serial loop over the T steps in
// registers (score_one).  Every cross-step quantity of the scorer is a scan
// -- the prefilter, the standstill heading hold, the previous heading and
// curvature of the yaw-rate and curvature-rate checks, the first (step,
// rank) violation, the values saved at the last valid step for the
// constant-acceleration extension with its running position sums, and the
// cost sums -- so one pass suffices: steps at or after traj_len extend from
// the values saved at the last valid step.  Reference-table rows are found by
// binary search (idx = count(s_row <= q) - 1) and read, like the obstacle
// and polygon tables, from global memory through the read-only path.  The
// fleet kernel puts the problem index in blockIdx.y and offsets every
// operand by its problem's stride; all problems share the padded sizes P, M,
// Mp and V (parallel/fleet.py pads them).
//
// What bounds it on the card: compute and latency, not bytes.  Each step runs
// four binary searches (one lookup, three corridor probes), about ten
// transcendentals, and two more per obstacle; the candidates' inputs are
// 14 floats each.  A single problem (K ~ 3.4k, 256 threads per block) fills
// only ~14 blocks of the H100's 132 SMs; the fleet kernel (F * K threads,
// 2.82M for the 1024-problem fleet) fills the card.  Later changes: split a
// candidate's steps across a warp (parallel scans over T) and stage the
// tables and obstacles in shared memory.
//
// Numerics: built without fast math, with IEEE division and square root and
// without FMA contraction (-fmad=false), so each float32 operation rounds as
// the plain version's separate tensor operations do.
//
// trivial_kernel is the launch-overhead probe: it replaces trivial_kernel of
// scripts/t61_overhead_probe.py (:200, launched at :207), a Pallas kernel
// with the scorer's operand family and no compute.  Here it reads the
// scorer's operands (ScorerInputs, ops/scoring.py) and computes
// out[k] = (coeffs_lon[k, 0] + v) + table[0, 0] + obs0 (obs0 = obs[0, 0, 0],
// or 0 without obstacles), one thread per candidate in blocks of 256, and is
// launched through the same library and ctypes route as score_kernel, so the
// probe times the launch path the scorer pays.  The TPU's bf16 pair and band
// stacks have no counterpart in the port, so their terms are not read.  It is
// bound by launch latency: 8 bytes per candidate of traffic.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kCols = 12;      // packed table columns (ops/scoring.py)
constexpr int kObsCols = 7;    // x, y, theta, half_len, half_wid, valid, radius

// scalar slots (ops/scoring.py _S_*)
enum {
  S_WHEELBASE, S_WB_REAR, S_A_MAX, S_V_SWITCH, S_KAPPA_MAX, S_V_DELTA_MAX,
  S_HALF_LEN, S_HALF_WID, S_X0_THETA, S_DT, S_LOW_VEL, S_DESIRED_V,
  S_DESIRED_D, S_W_A, S_REF_S_LAST, S_DESIRED_S, S_TABLE_S0, S_NUM
};

// flag bits (ops/scoring.py _F_*)
constexpr int F_VELOCITY = 1, F_ACCELERATION = 2, F_KAPPA = 4,
              F_KAPPA_DOT = 8, F_YAW_RATE = 16, F_HAS_DESIRED_S = 32,
              F_HAS_DESIRED_V = 64;

constexpr float kEps = 1e-5f;

__device__ __forceinline__ float sign_f(float x) {
  // jnp.sign / torch.sign: -1, 0, +1, NaN for NaN
  if (x > 0.f) return 1.f;
  if (x < 0.f) return -1.f;
  return x;  // 0 or NaN
}

// Cephes atanf construction, term for term as ops/scoring.py::atan_cephes
__device__ __forceinline__ float atan_cephes(float x) {
  const float sign = sign_f(x);
  const float ax = fabsf(x);
  const bool hi = ax > 2.414213562373095f;
  const bool mid = ax > 0.4142135623730950f;
  const float x_hi = -(1.0f / (hi ? ax : 1.0f));
  const float x_mid = (ax - 1.0f) / (ax + 1.0f);
  const float xr = hi ? x_hi : (mid ? x_mid : ax);
  const float y0 = hi ? 1.57079632679489662f
                      : (mid ? 0.785398163397448310f : 0.0f);
  const float z = xr * xr;
  const float poly =
      (((8.05374449538e-2f * z - 1.38776856032e-1f) * z + 1.99777106478e-1f) *
           z -
       3.33329491539e-1f) *
          z * xr +
      xr;
  return sign * (y0 + poly);
}

// count(s_row <= q) over the table's arclength column
__device__ __forceinline__ int count_le(const float* __restrict__ table, int P,
                                        float q) {
  int lo = 0, hi = P;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(table + mid * kCols) <= q) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Scores candidate k of one problem; every pointer is that problem's base.
__device__ __forceinline__ void score_one(
    int k, const float* __restrict__ coeffs_lon,
    const float* __restrict__ coeffs_lat,
    const float* __restrict__ traj_len_in,
    const float* __restrict__ goal_valid_in, const float* __restrict__ table,
    int P, const float* __restrict__ obs, int M,
    const float* __restrict__ poly, int Mp, int V,
    const float* __restrict__ scal, int T, int flags,
    float* __restrict__ out_masked, float* __restrict__ out_kin,
    float* __restrict__ out_reason) {

  const float wheelbase = __ldg(scal + S_WHEELBASE);
  const float wb_rear = __ldg(scal + S_WB_REAR);
  const float a_max = __ldg(scal + S_A_MAX);
  const float v_switch = __ldg(scal + S_V_SWITCH);
  const float kappa_max = __ldg(scal + S_KAPPA_MAX);
  const float v_delta_max = __ldg(scal + S_V_DELTA_MAX);
  const float half_len = __ldg(scal + S_HALF_LEN);
  const float half_wid = __ldg(scal + S_HALF_WID);
  const float x0_theta = __ldg(scal + S_X0_THETA);
  const float dt = __ldg(scal + S_DT);
  const bool low_vel = __ldg(scal + S_LOW_VEL) > 0.5f;
  const float desired_v = __ldg(scal + S_DESIRED_V);
  const float desired_d = __ldg(scal + S_DESIRED_D);
  const float w_a = __ldg(scal + S_W_A);
  const float ref_s_last = __ldg(scal + S_REF_S_LAST);
  const float desired_s = __ldg(scal + S_DESIRED_S);
  const bool has_v = flags & F_HAS_DESIRED_V;
  const bool has_s = flags & F_HAS_DESIRED_S;

  float cl[6], ca[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    cl[i] = __ldg(coeffs_lon + k * 6 + i);
    ca[i] = __ldg(coeffs_lat + k * 6 + i);
  }
  const float traj_len = __ldg(traj_len_in + k);
  const float last = traj_len - 1.0f;

  // scan state
  bool pre_acc = false, pre_vel = false, domain_ok = true, collides = false;
  int first_flat = -1;  // step * 5 + rank of the first violation
  float s0 = 0.f, hold = x0_theta, prev_theta = 0.f, prev_kappa = 0.f;
  // values at the last valid step (0 when there is none, as the masked sum
  // of the TPU kernel gives)
  float a_last = 0.f, v_last = 0.f, th_last = 0.f, x_last = 0.f, y_last = 0.f,
        thcl_last = 0.f, sdot_last = 0.f, s_last = 0.f, d_last = 0.f,
        ddot_last = 0.f;
  float cos_last = 0.f, sin_last = 0.f, cum_x = 0.f, cum_y = 0.f;
  bool ext_started = false;
  float sum_a = 0.f, sum_v = 0.f, sum_s = 0.f, sum_d = 0.f, sum_th = 0.f;
  float v_mid = 0.f;

  const int t_mid = T / 2;
  float s = 0.f, d = 0.f, v = 0.f, a = 0.f, theta_gl = 0.f, theta_cl = 0.f,
        ego_x = 0.f, ego_y = 0.f;

  for (int t = 0; t < T; ++t) {
    const float stepf = (float)t;
    if (stepf < traj_len) {
      // ---- rollout of s and d (low-velocity mode: d over travelled s)
      const float tt = stepf * dt;
      float tau = tt, tau2 = tau * tau, tau3 = tau2 * tau, tau4 = tau2 * tau2,
            tau5 = tau4 * tau;
      s = cl[0] + cl[1] * tau + cl[2] * tau2 + cl[3] * tau3 + cl[4] * tau4 +
          cl[5] * tau5;
      float s_dot = cl[1] + 2.0f * cl[2] * tau + 3.0f * cl[3] * tau2 +
                    4.0f * cl[4] * tau3 + 5.0f * cl[5] * tau4;
      const float s_ddot = 2.0f * cl[2] + 6.0f * cl[3] * tau +
                           12.0f * cl[4] * tau2 + 20.0f * cl[5] * tau3;
      if (t == 0) s0 = s;
      tau = low_vel ? s - s0 : tt;
      tau2 = tau * tau;
      tau3 = tau2 * tau;
      tau4 = tau2 * tau2;
      tau5 = tau4 * tau;
      d = ca[0] + ca[1] * tau + ca[2] * tau2 + ca[3] * tau3 + ca[4] * tau4 +
          ca[5] * tau5;
      float d_dot = ca[1] + 2.0f * ca[2] * tau + 3.0f * ca[3] * tau2 +
                    4.0f * ca[4] * tau3 + 5.0f * ca[5] * tau4;
      const float d_ddot = 2.0f * ca[2] + 6.0f * ca[3] * tau +
                           12.0f * ca[4] * tau2 + 20.0f * ca[5] * tau3;
      if (fabsf(s_dot) < kEps) s_dot = 0.f;
      if (fabsf(d_dot) < kEps) d_dot = 0.f;
      pre_acc |= fabsf(s_ddot) > a_max;
      pre_vel |= s_dot < -kEps;

      // ---- reference-table rows idx, idx + 1
      int idx = (s != s) ? -1 : count_le(table, P, s) - 1;
      idx = min(max(idx, 0), P - 2);
      const float* lo = table + idx * kCols;
      const float* hi = lo + kCols;
      const float lo_s = __ldg(lo + 0), hi_s = __ldg(hi + 0);
      const float lam = (s - lo_s) / (hi_s - lo_s);
      const float lo_th = __ldg(lo + 1);
      const float raw = (__ldg(hi + 1) - lo_th) * lam + lo_th;
      const float two_pi = 6.28318530717958647692f;
      const float interp_theta = raw - two_pi * truncf(raw / two_pi);
      const float lo_k = __ldg(lo + 2);
      const float k_r = (__ldg(hi + 2) - lo_k) * lam + lo_k;
      const float lo_kd = __ldg(lo + 3);
      const float k_r_d = (__ldg(hi + 3) - lo_kd) * lam + lo_kd;
      const float ds = s - lo_s;
      ego_x = __ldg(lo + 6) + ds * __ldg(lo + 8) + d * __ldg(lo + 10);
      ego_y = __ldg(lo + 7) + ds * __ldg(lo + 9) + d * __ldg(lo + 11);

      // ---- Werling transform with the standstill heading hold
      const bool moving = s_dot > 0.001f;
      const float sv_safe = moving ? s_dot : 1.0f;
      const float dp_high = moving ? d_dot / sv_safe : 0.0f;
      const float ddot_w = d_ddot - dp_high * s_ddot;
      const float dpp_high = moving ? ddot_w / (sv_safe * sv_safe) : 0.0f;
      const float dp = low_vel ? d_dot : dp_high;
      const float dpp = low_vel ? d_ddot : dpp_high;
      const float theta_cl_move = atan_cephes(dp);
      const bool use_move = moving || low_vel;
      if (use_move) hold = theta_cl_move + interp_theta;
      theta_gl = hold;
      theta_cl = use_move ? theta_cl_move : theta_gl - interp_theta;

      const float one_krd = 1.0f - k_r * d;
      const float cos_t = cosf(theta_cl);
      const float tan_t = tanf(theta_cl);
      const float q = cos_t / one_krd;
      const float kappa_gl =
          (dpp + (k_r * dp + k_r_d * d) * tan_t) * cos_t * (q * q) + q * k_r;
      v = s_dot * (one_krd / cos_t);
      a = s_ddot * one_krd / cos_t +
          ((s_dot * s_dot) / cos_t) *
              (one_krd * tan_t * (kappa_gl * one_krd / cos_t - k_r) -
               (k_r_d * d + k_r * dp));

      // ---- first (step, rank) constraint violation
      if (first_flat < 0) {
        int rank = -1;
        if ((flags & F_VELOCITY) && v < -kEps) {
          rank = 0;
        } else if ((flags & F_KAPPA) && fabsf(kappa_gl) > kappa_max) {
          rank = 1;
        } else if (flags & F_YAW_RATE) {
          const float yaw = t == 0 ? 0.f : (theta_gl - prev_theta) / dt;
          const float yaw_r = rintf(yaw * 1e5f) / 1e5f;
          if (fabsf(yaw_r) > kappa_max * v) rank = 2;
        }
        if (rank < 0 && (flags & F_KAPPA_DOT)) {
          const float c_st = cosf(atan_cephes(wheelbase * kappa_gl));
          const float kd_max = v_delta_max / (wheelbase * (c_st * c_st));
          const float kd = t == 0 ? 0.f : (kappa_gl - prev_kappa) / dt;
          if (fabsf(kd) > kd_max) rank = 3;
        }
        if (rank < 0 && (flags & F_ACCELERATION)) {
          const bool fast = v > v_switch;
          const float v_safe = fast ? v : 1.0f;
          const float a_hi = fast ? a_max * v_switch / v_safe : a_max;
          if (a < -a_max || a > a_hi) rank = 4;
        }
        if (rank >= 0) first_flat = t * 5 + rank;
      }
      prev_theta = theta_gl;
      prev_kappa = kappa_gl;

      // ---- projection domain
      domain_ok = domain_ok && s >= 0.0f && s <= ref_s_last &&
                  one_krd > 0.0f && fabsf(d) < 19.9f;

      a_last = a;
      v_last = v;
      th_last = theta_gl;
      x_last = ego_x;
      y_last = ego_y;
      thcl_last = theta_cl;
      sdot_last = s_dot;
      s_last = s;
      d_last = d;
      ddot_last = d_dot;
    } else {
      // ---- constant-acceleration extension past the last valid step
      if (!ext_started) {
        cos_last = cosf(th_last);
        sin_last = sinf(th_last);
        ext_started = true;
      }
      const float t_rel = (stepf - last) * dt;
      float v_temp = v_last + t_rel * a_last;
      v_temp = v_temp * (float)(v_temp >= 0.f);
      cum_x = cum_x + dt * v_temp * cos_last;
      cum_y = cum_y + dt * v_temp * sin_last;
      ego_x = x_last + cum_x;
      ego_y = y_last + cum_y;
      v = v_temp;
      a = a_last;
      theta_gl = th_last;
      theta_cl = thcl_last;
      s = s_last + t_rel * sdot_last;
      d = d_last + t_rel * ddot_last;
    }

    // ---- cost sums (DefaultCostFunction)
    const float wa = w_a * a;
    sum_a = sum_a + wa * wa;
    if (has_v) {
      const float e = 5.0f * (v - desired_v);
      sum_v = sum_v + e * e;
    }
    if (has_s) {
      const float e = 0.25f * (desired_s - s);
      sum_s = sum_s + e * e;
    }
    const float ed = 0.25f * (desired_d - d);
    sum_d = sum_d + ed * ed;
    const float eth = 0.25f * fabsf(theta_cl);
    sum_th = sum_th + eth * eth;
    if (t == t_mid) v_mid = v;

    if (collides) continue;

    // ---- corridor band check: three probes along the ego box
    const float cos_cl = cosf(theta_cl);
    const float sin_cl = sinf(theta_cl);
    const float s_center = s + wb_rear * cos_cl;
    const float d_center = d + wb_rear * sin_cl;
    const float lat_ext = half_wid * fabsf(cos_cl) + half_len * fabsf(sin_cl);
    const float lon_ext = half_len * fabsf(cos_cl) + half_wid * fabsf(sin_cl);
    const float d_plus = d_center + lat_ext;
    const float d_minus = d_center - lat_ext;
    const float probes[3] = {s_center - lon_ext, s_center,
                             s_center + lon_ext};
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      float q = probes[p];
      if (q == q) q = fminf(fmaxf(q, 0.0f), ref_s_last);
      const int bidx = (q != q) ? -1 : count_le(table, P, q) - 1;
      float band_lo = 0.f, band_hi = 0.f;
      if (bidx >= 0) {
        band_lo = __ldg(table + bidx * kCols + 4);
        band_hi = __ldg(table + bidx * kCols + 5);
      }
      if (d_plus > band_hi || d_minus < band_lo) collides = true;
    }

    // ---- obstacle OBB / disc SAT at the ego box center
    const float e_cos = cosf(theta_gl);
    const float e_sin = sinf(theta_gl);
    const float ecx = ego_x + wb_rear * e_cos;
    const float ecy = ego_y + wb_rear * e_sin;
    for (int m = 0; m < M && !collides; ++m) {
      const float* o = obs + ((size_t)m * T + t) * kObsCols;
      if (!(__ldg(o + 5) > 0.5f)) continue;
      const float otheta = __ldg(o + 2);
      const float ohl = __ldg(o + 3), ohw = __ldg(o + 4);
      const float radius = __ldg(o + 6);
      const float o_cos = cosf(otheta), o_sin = sinf(otheta);
      const float dx = __ldg(o + 0) - ecx;
      const float dy = __ldg(o + 1) - ecy;
      const float rel_cos = fabsf(e_cos * o_cos + e_sin * o_sin);
      const float rel_sin = fabsf(o_sin * e_cos - o_cos * e_sin);
      const float lx = fabsf(dx * e_cos + dy * e_sin);
      const float ly = fabsf(-dx * e_sin + dy * e_cos);
      bool hit;
      if (radius > 0.0f) {
        const float qx = fmaxf(lx - half_len, 0.0f);
        const float qy = fmaxf(ly - half_wid, 0.0f);
        hit = qx * qx + qy * qy <= radius * radius;
      } else {
        const bool sep =
            lx > half_len + ohl * rel_cos + ohw * rel_sin ||
            ly > half_wid + ohl * rel_sin + ohw * rel_cos ||
            fabsf(dx * o_cos + dy * o_sin) >
                ohl + half_len * rel_cos + half_wid * rel_sin ||
            fabsf(-dx * o_sin + dy * o_cos) >
                ohw + half_len * rel_sin + half_wid * rel_cos;
        hit = !sep;
      }
      if (hit) collides = true;
    }

    // ---- convex-polygon SAT: ego box axes + the piece's edge normals
    const int pc = 2 * V + 1;
    for (int m = 0; m < Mp && !collides; ++m) {
      const float* pv = poly + ((size_t)m * T + t) * pc;
      if (!(__ldg(pv + 2 * V) > 0.5f)) continue;
      float pm_min = 0.f, pm_max = 0.f, pn_min = 0.f, pn_max = 0.f;
      for (int i = 0; i < V; ++i) {
        const float rx = __ldg(pv + 2 * i) - ecx;
        const float ry = __ldg(pv + 2 * i + 1) - ecy;
        const float pm = rx * e_cos + ry * e_sin;
        const float pn = -rx * e_sin + ry * e_cos;
        pm_min = i == 0 ? pm : fminf(pm_min, pm);
        pm_max = i == 0 ? pm : fmaxf(pm_max, pm);
        pn_min = i == 0 ? pn : fminf(pn_min, pn);
        pn_max = i == 0 ? pn : fmaxf(pn_max, pn);
      }
      bool sep = pm_min > half_len || pm_max < -half_len ||
                 pn_min > half_wid || pn_max < -half_wid;
      for (int e = 0; e < V && !sep; ++e) {
        const int e2 = (e + 1) % V;
        const float nx = -(__ldg(pv + 2 * e2 + 1) - __ldg(pv + 2 * e + 1));
        const float ny = __ldg(pv + 2 * e2) - __ldg(pv + 2 * e);
        float lo_p = 0.f, hi_p = 0.f;
        for (int i = 0; i < V; ++i) {
          const float proj = nx * __ldg(pv + 2 * i) + ny * __ldg(pv + 2 * i + 1);
          lo_p = i == 0 ? proj : fminf(lo_p, proj);
          hi_p = i == 0 ? proj : fmaxf(hi_p, proj);
        }
        const float c_proj = nx * ecx + ny * ecy;
        const float r_ego = half_len * fabsf(nx * e_cos + ny * e_sin) +
                            half_wid * fabsf(-nx * e_sin + ny * e_cos);
        sep = c_proj - r_ego > hi_p || c_proj + r_ego < lo_p;
      }
      if (!sep) collides = true;
    }
  }

  // ---- cost: sums plus the terminal and mid-horizon terms (values of the
  // final step are still in s, d, v, theta_cl)
  float cost = sum_a;
  if (has_v) {
    const float ev = v - desired_v;
    const float em = v_mid - desired_v;
    cost = cost + (sum_v + 50.0f * (ev * ev) + 100.0f * (em * em));
  }
  if (has_s) {
    const float es = 20.0f * (desired_s - s);
    cost = cost + (sum_s + es * es);
  }
  const float ed = 20.0f * (desired_d - d);
  cost = cost + (sum_d + ed * ed);
  const float eth = 5.0f * fabsf(theta_cl);
  cost = cost + (sum_th + eth * eth);

  const bool any_viol = first_flat >= 0;
  const bool prefiltered = pre_acc || pre_vel;
  const bool kin_feasible = !prefiltered && !any_viol;
  const bool feasible =
      kin_feasible && domain_ok && __ldg(goal_valid_in + k) > 0.5f;
  float reason = any_viol ? (float)(first_flat % 5) : -1.0f;
  if (prefiltered) reason = pre_acc ? 4.0f : 0.0f;
  if (kin_feasible && !domain_ok) reason = 5.0f;

  const float inf = __int_as_float(0x7f800000);
  out_masked[k] = (feasible && !collides) ? cost : inf;
  out_kin[k] = feasible ? cost : inf;
  out_reason[k] = reason;
}

__global__ void __launch_bounds__(256) score_kernel(
    const float* __restrict__ coeffs_lon, const float* __restrict__ coeffs_lat,
    const float* __restrict__ traj_len, const float* __restrict__ goal_valid,
    const float* __restrict__ table, int P, const float* __restrict__ obs,
    int M, const float* __restrict__ poly, int Mp, int V,
    const float* __restrict__ scal, int K, int T, int flags,
    float* __restrict__ out_masked, float* __restrict__ out_kin,
    float* __restrict__ out_reason) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  score_one(k, coeffs_lon, coeffs_lat, traj_len, goal_valid, table, P, obs, M,
            poly, Mp, V, scal, T, flags, out_masked, out_kin, out_reason);
}

// Problem f = blockIdx.y; operands are [F, ...] stacks with the padded sizes.
__global__ void __launch_bounds__(256) fleet_score_kernel(
    const float* __restrict__ coeffs_lon, const float* __restrict__ coeffs_lat,
    const float* __restrict__ traj_len, const float* __restrict__ goal_valid,
    const float* __restrict__ tables, int P, const float* __restrict__ obs,
    int M, const float* __restrict__ poly, int Mp, int V,
    const float* __restrict__ scal, int K, int T, int flags,
    float* __restrict__ out_masked, float* __restrict__ out_kin,
    float* __restrict__ out_reason) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  const size_t f = blockIdx.y;
  const size_t fk = f * (size_t)K;
  score_one(k, coeffs_lon + fk * 6, coeffs_lat + fk * 6, traj_len + fk,
            goal_valid + fk, tables + f * (size_t)P * kCols, P,
            obs + f * (size_t)M * T * kObsCols, M,
            poly + f * (size_t)Mp * T * (2 * V + 1), Mp, V, scal + f * S_NUM,
            T, flags, out_masked + fk, out_kin + fk, out_reason + fk);
}

__global__ void __launch_bounds__(256) trivial_kernel(
    const float* __restrict__ coeffs_lon, const float* __restrict__ table,
    const float* __restrict__ obs, int M, const float* __restrict__ v, int K,
    float* __restrict__ out) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  const float obs0 = M > 0 ? __ldg(obs) : 0.0f;
  out[k] = (__ldg(coeffs_lon + k * 6) + __ldg(v)) + __ldg(table) + obs0;
}

}  // namespace

// coeffs_lon: [K, 6]; table: [P, 12]; obs: [M, T, 7]; v: [1] on the device;
// out: [K].  All float32, contiguous.
extern "C" int crp_trivial(const float* coeffs_lon, const float* table,
                           const float* obs, int M, const float* v, int K,
                           float* out, void* stream) {
  if (K <= 0) return 0;
  const int threads = 256;
  const int blocks = (K + threads - 1) / threads;
  trivial_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      coeffs_lon, table, obs, M, v, K, out);
  return (int)cudaGetLastError();
}

extern "C" int crp_score_candidates(
    const float* coeffs_lon, const float* coeffs_lat, const float* traj_len,
    const float* goal_valid, const float* table, int P, const float* obs,
    int M, const float* poly, int Mp, int V, const float* scalars, int K,
    int T, int flags, float* out_masked, float* out_kin, float* out_reason,
    void* stream) {
  if (K <= 0) return 0;
  const int threads = 256;
  const int blocks = (K + threads - 1) / threads;
  score_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      coeffs_lon, coeffs_lat, traj_len, goal_valid, table, P, obs, M, poly, Mp,
      V, scalars, K, T, flags, out_masked, out_kin, out_reason);
  return (int)cudaGetLastError();
}

extern "C" int crp_score_fleet(
    const float* coeffs_lon, const float* coeffs_lat, const float* traj_len,
    const float* goal_valid, const float* tables, int P, const float* obs,
    int M, const float* poly, int Mp, int V, const float* scalars, int F,
    int K, int T, int flags, float* out_masked, float* out_kin,
    float* out_reason, void* stream) {
  if (K <= 0 || F <= 0) return 0;
  if (F > 65535) return (int)cudaErrorInvalidConfiguration;
  const int threads = 256;
  const dim3 blocks((K + threads - 1) / threads, F);
  fleet_score_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      coeffs_lon, coeffs_lat, traj_len, goal_valid, tables, P, obs, M, poly,
      Mp, V, scalars, K, T, flags, out_masked, out_kin, out_reason);
  return (int)cudaGetLastError();
}
