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
// schedule: here a table lookup is a search in shared memory, so one kernel
// body serves both horizons.
//
// What bounds it on the card: the instruction count and the latency of
// dependent loads, not bytes (a candidate's operands are 14 floats) and not
// anything a tensor core computes (the body holds no matrix product).  A
// candidate's T steps are a serial scan -- the standstill heading hold, the
// previous heading and curvature of the rate checks, the first violation,
// the values kept at the last valid step for the constant-acceleration
// extension, the cost sums in step order -- so one thread scores one
// candidate, a block serves one problem (blockIdx.y) and walks K-tiles of it,
// and the design spends its effort on what a step costs and on which warps
// run the long scan at all:
//
//  * Staged once per block in shared memory (stage_problem): the 17
//    scalars, the table's arclength column as a dense [P] array and the
//    obstacle rows [M, T] with cos(theta) and sin(theta) computed once per
//    (row, step) -- the per-candidate obstacle loop calls no cosf/sinf.  The
//    table's other columns and the polygon table are read where they lie,
//    through the read-only path: a candidate touches a few neighbouring rows,
//    which stay in L1, and staging them too measured no faster at the
//    fleet's shape (a shared-memory row is 12 words wide, so a warp's loads
//    of one column conflict).
//  * Table rows are found by a hinted search (count_le_hint): s moves a few
//    rows per step and the three corridor probes lie within the ego's extent
//    of it, so the search gallops from the previous count and bisects the
//    bracket it finds.  It returns count(s_row <= q), the integer a full
//    bisection returns, for every q: the table's arclengths increase.
//  * Each transcendental is computed once: cos/sin of the curvilinear and
//    the global heading once per valid step, shared by the Werling transform,
//    the corridor probes and the obstacle tests; the extension reuses the
//    last valid step's four values (its headings are constant).
//  * Work whose result is fixed is not done: a first pass over the two
//    longitudinal derivatives decides the prefilter before anything else,
//    and a prefiltered candidate ends there; a candidate ends at its first
//    constraint violation (its rows are +inf and its reason is that
//    violation's); one that left the projection domain or is goal-filtered
//    skips the collision tests and ends where its valid steps end; the
//    extension of a colliding candidate only sums its cost.  Every exit
//    leaves the three outputs exactly as the full scan would.
//  * The exits alone free few warps: seven candidates in ten of a fleet
//    cycle end at a violation, nearly all at their second step, but a warp's
//    32 neighbours in K rarely all do.  So a block of the fleet kernel first
//    screens its candidates (the prefilter and the checks of the first
//    kScreenSteps steps), queues the survivors in shared memory and runs the
//    whole scan on the queue, in full warps (score_block).
//  * Where the candidates are the regular sampling lattice around each
//    problem's carried state (the fleet scan), fleet_score_kernel<true>
//    builds a candidate's coefficients itself from that state and the
//    level's static grid (the lattice form of the four candidate operands)
//    instead of loading them: the [F, K, 6] coefficient tensors and the tens
//    of elementwise launches that filled them are never made.
//    lattice_candidates_kernel gives the chosen candidates' coefficients
//    from the same function.
//
// Numerics: built without fast math, with IEEE division and square root and
// without FMA contraction (-fmad=false), so each float32 operation rounds as
// the plain version's separate tensor operations do.  Every item above moves
// where a value comes from or whether it is computed, never the arithmetic
// that produces an output.
//
// The constants below (threads and blocks per SM, screen steps, tiles per
// block) are the fastest measured without register spills on an H100.
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
// bound by launch latency: 8 bytes per candidate of traffic.  crp_empty takes
// the same arguments and launches nothing: the floor of the binding itself.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// 128 threads and at least 5 blocks per SM: 96 registers, no spills
constexpr int kThreads = 128;
constexpr int kMinBlocks = 5;
// The fleet kernel's screen: valid steps of the first pass, the most K-tiles
// one block walks, the blocks a launch should have before a block walks more
// than one tile (eight for each of the card's 132 SMs), and the candidates a
// block screens before it scores those that go on.
constexpr int kScreenSteps = 2;
constexpr int kMaxTilesPerBlock = 8;
constexpr int kBlocksWanted = 1056;
constexpr int kQueue = kMaxTilesPerBlock * kThreads;

constexpr int kCols = 12;      // packed table columns (ops/scoring.py)
constexpr int kObsCols = 7;    // x, y, theta, half_len, half_wid, valid, radius
// staged obstacle row: x, y, cos, sin | half_len, half_wid, valid, radius
constexpr int kObsStaged = 8;

// scalar slots (ops/scoring.py _S_*)
enum {
  S_WHEELBASE, S_WB_REAR, S_A_MAX, S_V_SWITCH, S_KAPPA_MAX, S_V_DELTA_MAX,
  S_HALF_LEN, S_HALF_WID, S_X0_THETA, S_DT, S_LOW_VEL, S_DESIRED_V,
  S_DESIRED_D, S_W_A, S_REF_S_LAST, S_DESIRED_S, S_TABLE_S0, S_NUM
};
constexpr int kScalStaged = 20;  // S_NUM rounded up to a multiple of 4

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

// Dynamic shared-memory floats of one block: the scalars, the staged obstacle
// rows and the arclength column (ops/scoring.py::shared_bytes computes the
// same).
inline long staged_floats(int P, int M, int T) {
  return kScalStaged + (long)M * T * kObsStaged + P;
}

// One problem's data as a block sees it.
struct Problem {
  const float* scal;   // shared [S_NUM]
  const float* obs;    // shared [M, T, kObsStaged]
  const float* col;    // shared [P]: the table's arclengths
  const float* rows;   // global [P, kCols]
  const float* poly;   // global [Mp, T, 2V + 1]
};

// The block's threads load one problem into shared memory; ends with a
// barrier.  The obstacle rows' cos/sin are computed here, once per (row,
// step) and block.
__device__ __forceinline__ Problem stage_problem(
    float* smem, const float* __restrict__ table, int P,
    const float* __restrict__ obs, int M, const float* __restrict__ poly,
    const float* __restrict__ scal, int T) {
  float* sh_scal = smem;
  float* sh_obs = sh_scal + kScalStaged;
  float* sh_col = sh_obs + M * T * kObsStaged;
  const int tid = threadIdx.x, nthr = blockDim.x;
  if (tid < S_NUM) sh_scal[tid] = __ldg(scal + tid);
  for (int i = tid; i < M * T; i += nthr) {
    const float* o = obs + (size_t)i * kObsCols;
    const float theta = __ldg(o + 2);
    float* r = sh_obs + i * kObsStaged;
    r[0] = __ldg(o + 0);
    r[1] = __ldg(o + 1);
    r[2] = cosf(theta);
    r[3] = sinf(theta);
    r[4] = __ldg(o + 3);
    r[5] = __ldg(o + 4);
    r[6] = __ldg(o + 5);
    r[7] = __ldg(o + 6);
  }
  for (int i = tid; i < P; i += nthr) sh_col[i] = __ldg(table + i * kCols);
  __syncthreads();
  Problem pb;
  pb.scal = sh_scal;
  pb.obs = sh_obs;
  pb.col = sh_col;
  pb.rows = table;
  pb.poly = poly;
  return pb;
}

// ---- the lattice candidate (compiled on the CPU by the tests with
// __device__ and __forceinline__ defined away and __ldg a plain load)

// grid.linspace(lo, hi, n)[i]: the ramp i / (n - 1) is a multiply by the
// reciprocal, as PyTorch divides by a host scalar on the card; the last
// sample is hi
__device__ __forceinline__ float lattice_target(int i, int n, float lo,
                                                float hi) {
  if (i == n - 1) return hi;
  const float step = (float)i * (1.0f / (float)(n - 1));
  return lo * (1.0f - step) + hi * step;
}

// polynomial.quintic_coeffs toward (p1, 0, 0) over T, term for term
__device__ __forceinline__ void quintic_to_rest(float p0, float v0, float a0,
                                                float p1, float T, float* c) {
  const float T2 = T * T, T3 = T2 * T, T4 = T2 * T2, T5 = T4 * T;
  const float dp = p1 - (p0 + v0 * T + 0.5f * a0 * T2);
  const float dv = (0.0f - (v0 + a0 * T)) * T;
  const float da = (0.0f - a0) * T2;
  c[0] = p0;
  c[1] = v0;
  c[2] = 0.5f * a0;
  c[3] = (10.0f * dp - 4.0f * dv + 0.5f * da) / T3;
  c[4] = (-15.0f * dp + 7.0f * dv - da) / T4;
  c[5] = (6.0f * dp - 3.0f * dv + 0.5f * da) / T5;
}

// Candidate k of one problem's lattice of a sampling level (ops/grid.py):
// the point (it, iv, id) of the (time, longitudinal target, lateral target)
// lattice in _lattice's meshgrid 'ij' order, k = (it * n_lon + iv) *
// (n_d + 1) + id, where id = n_d is the problem's current lateral offset
// x0_lat[0].  The longitudinal target is linspace(lo, hi, n_lon)[iv] (a
// velocity, or a stop position when stopping); the coefficients are
// velocity_keeping_candidates' (quartic lon) or stopping_candidates'
// (quintic lon and the goal-behind flag), each float operation the one the
// PyTorch ops perform on the card, in their order, so that with -fmad=false
// every value is bit for bit theirs.
__device__ __forceinline__ void lattice_candidate(
    int k, const float* x0_lon, const float* x0_lat, float lo, float hi,
    const float* t_values, const float* traj_len, const float* d_values,
    int n_lon, int n_d, bool stopping, bool low_vel, float* cl, float* ca,
    float& n_valid, bool& goal_ok) {
  const int id = k % (n_d + 1);
  const int iv = k / (n_d + 1) % n_lon;
  const int it = k / (n_d + 1) / n_lon;
  const float T = __ldg(t_values + it);
  const float p0 = __ldg(x0_lon), v0 = __ldg(x0_lon + 1),
              a0 = __ldg(x0_lon + 2);
  const float target = lattice_target(iv, n_lon, lo, hi);
  if (stopping) {
    quintic_to_rest(p0, v0, a0, target, T, cl);
  } else {
    // polynomial.quartic_coeffs toward (target, 0)
    const float T2 = T * T, T3 = T2 * T;
    const float dv = target - v0 - a0 * T;
    const float da = 0.0f - a0;
    cl[0] = p0;
    cl[1] = v0;
    cl[2] = 0.5f * a0;
    cl[3] = dv / T2 - da / (3.0f * T);
    cl[4] = da / (4.0f * T2) - dv / (2.0f * T3);
    cl[5] = 0.0f;
  }
  // grid._lateral: over the travelled arclength in low-velocity mode, over
  // T where that is not positive
  float tau = T;
  if (low_vel) {
    const float t2 = T * T, t3 = t2 * T, t4 = t2 * t2, t5 = t4 * T;
    const float s_goal = cl[0] + cl[1] * T + cl[2] * t2 + cl[3] * t3 +
                         cl[4] * t4 + cl[5] * t5 - p0;
    tau = s_goal <= 0.0f ? T : s_goal;
  }
  const float d = id < n_d ? __ldg(d_values + id) : __ldg(x0_lat);
  quintic_to_rest(__ldg(x0_lat), __ldg(x0_lat + 1), __ldg(x0_lat + 2), d, tau,
                  ca);
  n_valid = __ldg(traj_len + it);
  goal_ok = !stopping || p0 < target;
}

// The lattice form of a scorer's four candidate operands (the fleet scan's
// FleetLatticeInputs): in place of coeffs_lon, coeffs_lat, traj_len and
// goal_valid, each problem's carried x0_lon, x0_lat [3] and target bounds
// [2], and the level table that all problems share (ops/scoring.py
// lattice_table: t_values [n_t], the valid steps [n_t], d_values [n_d]).
// The level's sizes ride in the kernel's flags above the check bits
// (ops/scoring.py lattice_flags): bit 7 stopping, bits 8-15 n_t, 16-23 n_lon,
// 24-30 n_d, so that they are kernel parameters and not loads.
struct LevelSizes {
  int n_t, n_lon, n_d;
  bool stopping;
};

__device__ __forceinline__ LevelSizes level_sizes(int flags) {
  return {(flags >> 8) & 255, (flags >> 16) & 255, (flags >> 24) & 127,
          (flags & 128) != 0};
}

// candidate k of one problem's lattice
__device__ __forceinline__ void lattice_operands(
    int k, const float* x0_lon, const float* x0_lat, const float* bounds,
    const float* level, int flags, bool low_vel, float* cl, float* ca,
    float& n_valid, bool& goal_ok) {
  const LevelSizes n = level_sizes(flags);
  lattice_candidate(k, x0_lon, x0_lat, __ldg(bounds), __ldg(bounds + 1),
                    level, level + n.n_t, level + 2 * n.n_t, n.n_lon, n.n_d,
                    n.stopping, low_vel, cl, ca, n_valid, goal_ok);
}

// candidate k's valid steps alone
__device__ __forceinline__ float lattice_steps(int k, const float* level,
                                               int flags) {
  const LevelSizes n = level_sizes(flags);
  return __ldg(level + n.n_t + k / (n.n_d + 1) / n.n_lon);
}

// candidate k's goal flag alone: a stop target behind the carried position
// is filtered
__device__ __forceinline__ bool lattice_goal(int k, const float* x0_lon,
                                             const float* bounds, int flags) {
  const LevelSizes n = level_sizes(flags);
  if (!n.stopping) return true;
  return __ldg(x0_lon) < lattice_target(k / (n.n_d + 1) % n.n_lon, n.n_lon,
                                        __ldg(bounds), __ldg(bounds + 1));
}

// ---- end of the lattice candidate

// count(s_row <= q) over the arclength column, by bisection of [lo, hi]
__device__ __forceinline__ int bisect_le(const float* col, int lo, int hi,
                                         float q) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (col[mid] <= q) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// count(s_row <= q) from a hint (any earlier count in [0, P], or < 0 for
// none): gallops from the hint, in the direction the row at the hint gives,
// in steps of 1, 2, 4, ... until the count is bracketed, then bisects the
// bracket.  The rows' arclengths increase, so "s_row <= q" holds on a prefix
// of the rows and every bracket [lo, hi] below keeps lo <= count <= hi.
__device__ __forceinline__ int count_le_hint(const float* col, int P, float q,
                                             int hint) {
  if (hint < 0) return bisect_le(col, 0, P, q);
  int lo, hi, step = 1;
  if (hint < P && col[hint] <= q) {   // count > hint
    lo = hint + 1;
    for (;;) {
      const int i = lo + step - 1;
      if (i >= P) {
        hi = P;
        break;
      }
      if (col[i] <= q) {
        lo = i + 1;
        step <<= 1;
      } else {
        hi = i;
        break;
      }
    }
  } else {                            // count <= hint
    hi = hint;
    for (;;) {
      const int i = hi - step;
      if (i < 0) {
        lo = 0;
        break;
      }
      if (col[i] <= q) {
        lo = i + 1;
        break;
      }
      hi = i;
      step <<= 1;
    }
  }
  return bisect_le(col, lo, hi, q);
}

// Scores candidate k of one problem; the candidate operands (kLattice: their
// lattice form) and the outputs are that problem's.  kPass 0 is the whole
// scan.  kPass 1 is the screen: the prefilter and the kinematic checks of
// the first kScreenSteps valid steps, nothing else; it writes the outputs of
// a candidate that ends there and returns whether the candidate goes on.
// kPass 2 is the whole scan of a candidate that passed the screen (it is not
// prefiltered).
template <int kPass, bool kLattice>
__device__ __forceinline__ bool score_one(
    int k, const float* __restrict__ coeffs_lon,
    const float* __restrict__ coeffs_lat,
    const float* __restrict__ traj_len_in,
    const float* __restrict__ goal_valid_in, const Problem& pb, int P, int M,
    int Mp, int V, int T, int flags, float* __restrict__ out_masked,
    float* __restrict__ out_kin, float* __restrict__ out_reason) {

  const float* scal = pb.scal;
  const float wheelbase = scal[S_WHEELBASE];
  const float wb_rear = scal[S_WB_REAR];
  const float a_max = scal[S_A_MAX];
  const float kappa_max = scal[S_KAPPA_MAX];
  const float half_len = scal[S_HALF_LEN];
  const float half_wid = scal[S_HALF_WID];
  const float dt = scal[S_DT];
  const bool low_vel = scal[S_LOW_VEL] > 0.5f;
  const float desired_v = scal[S_DESIRED_V];
  const float desired_d = scal[S_DESIRED_D];
  const float w_a = scal[S_W_A];
  const float ref_s_last = scal[S_REF_S_LAST];
  const float desired_s = scal[S_DESIRED_S];
  const bool has_v = flags & F_HAS_DESIRED_V;
  const bool has_s = flags & F_HAS_DESIRED_S;

  // written so that the loaded form compiles to score_kernel's code without
  // a lattice form (compared in its SASS): the lattice form has a branch of
  // its own and the two conditionals; a helper call here moves that code
  float cl[6], ca[6];
  if constexpr (kLattice) {
    float steps;  // both are read alone below
    bool goal;
    lattice_operands(k, coeffs_lon, coeffs_lat, traj_len_in, goal_valid_in,
                     flags, low_vel, cl, ca, steps, goal);
  } else {
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      cl[i] = __ldg(coeffs_lon + k * 6 + i);
      ca[i] = __ldg(coeffs_lat + k * 6 + i);
    }
  }
  const float traj_len = kLattice ? lattice_steps(k, goal_valid_in, flags)
                                  : __ldg(traj_len_in + k);
  const float last = traj_len - 1.0f;
  const bool goal_ok =
      kLattice ? lattice_goal(k, coeffs_lon, traj_len_in, flags)
               : __ldg(goal_valid_in + k) > 0.5f;
  // the valid steps are the t < n_act: (float)t < traj_len
  const int n_act =
      traj_len > 0.f ? (int)fminf(ceilf(traj_len), (float)T) : 0;

  // ---- first pass, the prefilter alone: the two longitudinal derivatives
  // of the valid steps (the expressions of the main pass)
  bool pre_acc = false, pre_vel = false;
  for (int t = 0; kPass != 2 && t < n_act; ++t) {
    const float tau = (float)t * dt;
    const float tau2 = tau * tau, tau3 = tau2 * tau, tau4 = tau2 * tau2;
    const float s_dot = cl[1] + 2.0f * cl[2] * tau + 3.0f * cl[3] * tau2 +
                        4.0f * cl[4] * tau3 + 5.0f * cl[5] * tau4;
    const float s_ddot = 2.0f * cl[2] + 6.0f * cl[3] * tau +
                         12.0f * cl[4] * tau2 + 20.0f * cl[5] * tau3;
    pre_acc |= fabsf(s_ddot) > a_max;
    // the main pass zeroes |s_dot| < kEps first, which this test never sees
    pre_vel |= s_dot < -kEps;
  }
  const bool prefiltered = pre_acc || pre_vel;

  // scan state
  bool domain_ok = true, collides = false;
  int viol_rank = -1;  // rank of the first (step, rank) violation
  float s0 = 0.f, hold = scal[S_X0_THETA], prev_theta = 0.f, prev_kappa = 0.f;
  float cum_x = 0.f, cum_y = 0.f;
  float sum_a = 0.f, sum_v = 0.f, sum_s = 0.f, sum_d = 0.f, sum_th = 0.f;
  float v_mid = 0.f;
  int hint = -1;
  const int t_mid = T / 2;
  // Values of the current step.  After the last valid step they hold that
  // step's (0 when there is none, as the masked sum of the TPU kernel
  // gives) and the extension reads them: its headings are constant, so
  // their cos/sin carry over too (cos 0 = 1, sin 0 = 0 when there is none).
  float s = 0.f, d = 0.f, v = 0.f, a = 0.f, theta_gl = 0.f, theta_cl = 0.f,
        ego_x = 0.f, ego_y = 0.f, s_dot = 0.f, d_dot = 0.f;
  float cos_cl = 1.f, sin_cl = 0.f, e_cos = 1.f, e_sin = 0.f;
  float a_last = 0.f, v_last = 0.f, x_last = 0.f, y_last = 0.f,
        sdot_last = 0.f, s_last = 0.f, d_last = 0.f, ddot_last = 0.f;

  const int t_end = kPass == 1 ? min(n_act, kScreenSteps) : T;
  for (int t = 0; t < t_end && !prefiltered; ++t) {
    const float stepf = (float)t;
    // the collision tests can still change an output
    bool live = kPass != 1 && !collides && domain_ok && goal_ok;
    if (t < n_act) {
      // ---- rollout of s and d (low-velocity mode: d over travelled s)
      const float tt = stepf * dt;
      float tau = tt, tau2 = tau * tau, tau3 = tau2 * tau, tau4 = tau2 * tau2,
            tau5 = tau4 * tau;
      s = cl[0] + cl[1] * tau + cl[2] * tau2 + cl[3] * tau3 + cl[4] * tau4 +
          cl[5] * tau5;
      s_dot = cl[1] + 2.0f * cl[2] * tau + 3.0f * cl[3] * tau2 +
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
      d_dot = ca[1] + 2.0f * ca[2] * tau + 3.0f * ca[3] * tau2 +
              4.0f * ca[4] * tau3 + 5.0f * ca[5] * tau4;
      const float d_ddot = 2.0f * ca[2] + 6.0f * ca[3] * tau +
                           12.0f * ca[4] * tau2 + 20.0f * ca[5] * tau3;
      if (fabsf(s_dot) < kEps) s_dot = 0.f;
      if (fabsf(d_dot) < kEps) d_dot = 0.f;

      // ---- reference-table rows idx, idx + 1
      int idx = -1;
      if (s == s) {
        hint = count_le_hint(pb.col, P, s, hint);
        idx = hint - 1;
      }
      idx = min(max(idx, 0), P - 2);
      const float* lo = pb.rows + idx * kCols;
      const float* hi = lo + kCols;
      const float lo_s = pb.col[idx], hi_s = pb.col[idx + 1];
      const float lam = (s - lo_s) / (hi_s - lo_s);
      const float lo_th = __ldg(lo + 1);
      const float raw = (__ldg(hi + 1) - lo_th) * lam + lo_th;
      const float two_pi = 6.28318530717958647692f;
      const float interp_theta = raw - two_pi * truncf(raw / two_pi);
      const float lo_k = __ldg(lo + 2);
      const float k_r = (__ldg(hi + 2) - lo_k) * lam + lo_k;
      const float lo_kd = __ldg(lo + 3);
      const float k_r_d = (__ldg(hi + 3) - lo_kd) * lam + lo_kd;

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
      cos_cl = cosf(theta_cl);
      const float tan_t = tanf(theta_cl);
      const float q = cos_cl / one_krd;
      const float kappa_gl =
          (dpp + (k_r * dp + k_r_d * d) * tan_t) * cos_cl * (q * q) + q * k_r;
      v = s_dot * (one_krd / cos_cl);
      a = s_ddot * one_krd / cos_cl +
          ((s_dot * s_dot) / cos_cl) *
              (one_krd * tan_t * (kappa_gl * one_krd / cos_cl - k_r) -
               (k_r_d * d + k_r * dp));

      // ---- first (step, rank) constraint violation
      if (viol_rank < 0) {
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
          const float kd_max =
              scal[S_V_DELTA_MAX] / (wheelbase * (c_st * c_st));
          const float kd = t == 0 ? 0.f : (kappa_gl - prev_kappa) / dt;
          if (fabsf(kd) > kd_max) rank = 3;
        }
        if (rank < 0 && (flags & F_ACCELERATION)) {
          const float v_switch = scal[S_V_SWITCH];
          const bool fast = v > v_switch;
          const float v_safe = fast ? v : 1.0f;
          const float a_hi = fast ? a_max * v_switch / v_safe : a_max;
          if (a < -a_max || a > a_hi) rank = 4;
        }
        if (rank >= 0) {
          // both cost rows are +inf from here on and the reason is this one
          viol_rank = rank;
          break;
        }
      }
      prev_theta = theta_gl;
      prev_kappa = kappa_gl;
      if (kPass == 1) continue;

      // ---- projection domain
      domain_ok = domain_ok && s >= 0.0f && s <= ref_s_last &&
                  one_krd > 0.0f && fabsf(d) < 19.9f;
      live = live && domain_ok;

      if (live) {
        const float ds = s - lo_s;
        ego_x = __ldg(lo + 6) + ds * __ldg(lo + 8) +
                d * __ldg(lo + 10);
        ego_y = __ldg(lo + 7) + ds * __ldg(lo + 9) +
                d * __ldg(lo + 11);
        sin_cl = sinf(theta_cl);
        e_cos = cosf(theta_gl);
        e_sin = sinf(theta_gl);
      }
    } else {
      // ---- constant-acceleration extension past the last valid step
      if (t == n_act) {
        // no violation can follow: a candidate out of the domain or
        // goal-filtered has all three outputs fixed
        if (!(domain_ok && goal_ok)) break;
        a_last = a;
        v_last = v;
        x_last = ego_x;
        y_last = ego_y;
        sdot_last = s_dot;
        s_last = s;
        d_last = d;
        ddot_last = d_dot;
      }
      const float t_rel = (stepf - last) * dt;
      float v_temp = v_last + t_rel * a_last;
      v_temp = v_temp * (float)(v_temp >= 0.f);
      if (live) {
        cum_x = cum_x + dt * v_temp * e_cos;
        cum_y = cum_y + dt * v_temp * e_sin;
        ego_x = x_last + cum_x;
        ego_y = y_last + cum_y;
      }
      v = v_temp;
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

    if (!live) continue;

    // ---- corridor band check: three probes along the ego box
    const float s_center = s + wb_rear * cos_cl;
    const float d_center = d + wb_rear * sin_cl;
    const float lat_ext = half_wid * fabsf(cos_cl) + half_len * fabsf(sin_cl);
    const float lon_ext = half_len * fabsf(cos_cl) + half_wid * fabsf(sin_cl);
    const float d_plus = d_center + lat_ext;
    const float d_minus = d_center - lat_ext;
    const float probes[3] = {s_center, s_center - lon_ext,
                             s_center + lon_ext};
    int probe_hint = hint;
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      float q = probes[p];
      float band_lo = 0.f, band_hi = 0.f;
      if (q == q) {
        q = fminf(fmaxf(q, 0.0f), ref_s_last);
        const int c = count_le_hint(pb.col, P, q, probe_hint);
        // the outer probes and the next step start at the center's count
        if (p == 0) probe_hint = hint = c;
        if (c >= 1) {
          band_lo = __ldg(pb.rows + (c - 1) * kCols + 4);
          band_hi = __ldg(pb.rows + (c - 1) * kCols + 5);
        }
      }
      if (d_plus > band_hi || d_minus < band_lo) collides = true;
    }

    // ---- obstacle OBB / disc SAT at the ego box center
    const float ecx = ego_x + wb_rear * e_cos;
    const float ecy = ego_y + wb_rear * e_sin;
    for (int m = 0; m < M && !collides; ++m) {
      const float4* o = reinterpret_cast<const float4*>(
          pb.obs + (m * T + t) * kObsStaged);
      const float4 geo = o[1];  // half_len, half_wid, valid, radius
      if (!(geo.z > 0.5f)) continue;
      const float4 pose = o[0];  // x, y, cos, sin
      const float ohl = geo.x, ohw = geo.y, radius = geo.w;
      const float o_cos = pose.z, o_sin = pose.w;
      const float dx = pose.x - ecx;
      const float dy = pose.y - ecy;
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
      const float* pv = pb.poly + ((size_t)m * T + t) * pc;
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
        const float nx =
            -(__ldg(pv + 2 * e2 + 1) - __ldg(pv + 2 * e + 1));
        const float ny = __ldg(pv + 2 * e2) - __ldg(pv + 2 * e);
        float lo_p = 0.f, hi_p = 0.f;
        for (int i = 0; i < V; ++i) {
          const float proj = nx * __ldg(pv + 2 * i) +
                             ny * __ldg(pv + 2 * i + 1);
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
  // final step are still in s, d, v, theta_cl); read only when the
  // candidate is feasible, which no early exit is
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

  const bool any_viol = viol_rank >= 0;
  const bool kin_feasible = !prefiltered && !any_viol;
  if (kPass == 1 && kin_feasible) return true;
  const bool feasible = kin_feasible && domain_ok && goal_ok;
  float reason = any_viol ? (float)viol_rank : -1.0f;
  if (prefiltered) reason = pre_acc ? 4.0f : 0.0f;
  if (kin_feasible && !domain_ok) reason = 5.0f;

  const float inf = __int_as_float(0x7f800000);
  out_masked[k] = (feasible && !collides) ? cost : inf;
  out_kin[k] = feasible ? cost : inf;
  out_reason[k] = reason;
  return false;
}

extern __shared__ float4 crp_smem[];

// Problem f = blockIdx.y; operands are [F, ...] stacks with the padded sizes
// P, M, Mp and V (parallel/fleet.py pads them); out is [3, F, K].  A block
// stages its problem once and scores a run of whole K-tiles of it, the
// gridDim.x blocks of a problem sharing its tiles evenly.
//
// kScreen (the fleet kernel): most candidates that end early end at their
// first or second step (the rate checks' first steps), but a warp's 32
// neighbours in K rarely all do, so exits alone leave the warps running.
// The block therefore screens its candidates first (score_one pass 1),
// queues those that go on in shared memory, and scores the queue densely
// (pass 2, from step 0): the long scan runs in full warps of candidates that
// need it.  A launch whose blocks all fit the card at once (one problem)
// would only lengthen its one round by the screen, so score_kernel does
// without.
template <bool kScreen, bool kLattice>
__device__ __forceinline__ void score_block(
    const float* __restrict__ coeffs_lon, const float* __restrict__ coeffs_lat,
    const float* __restrict__ traj_len, const float* __restrict__ goal_valid,
    const float* __restrict__ tables, int P, const float* __restrict__ obs,
    int M, const float* __restrict__ poly, int Mp, int V,
    const float* __restrict__ scal, int F, int K, int T, int flags,
    float* __restrict__ out) {
  __shared__ int queue[kScreen ? kQueue : 1];
  __shared__ int n_queued;
  const size_t f = blockIdx.y;
  const size_t fk = f * (size_t)K;
  const size_t row = (size_t)F * K;
  const Problem pb = stage_problem(
      reinterpret_cast<float*>(crp_smem), tables + f * (size_t)P * kCols, P,
      obs + f * (size_t)M * T * kObsCols, M,
      poly + f * (size_t)Mp * T * (2 * V + 1), scal + f * S_NUM, T);
  if constexpr (kLattice) {
    coeffs_lon += f * 3;  // x0_lon
    coeffs_lat += f * 3;  // x0_lat
    traj_len += f * 2;    // bounds; the level table is every problem's
  } else {
    coeffs_lon += fk * 6;
    coeffs_lat += fk * 6;
    traj_len += fk;
    goal_valid += fk;
  }
  float* out_masked = out + fk;
  float* out_kin = out + row + fk;
  float* out_reason = out + 2 * row + fk;

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int tiles = (K + nthr - 1) / nthr;
  const int per_block = (tiles + gridDim.x - 1) / gridDim.x * nthr;
  const int k_begin = blockIdx.x * per_block;
  const int k_end = min(K, k_begin + per_block);
  if (!kScreen) {
    for (int k = k_begin + tid; k < k_end; k += nthr)
      score_one<0, kLattice>(k, coeffs_lon, coeffs_lat, traj_len, goal_valid,
                             pb, P, M, Mp, V, T, flags, out_masked, out_kin,
                             out_reason);
    return;
  }
  // k_end - k_begin <= kQueue: launch_scorer gives a block at most
  // kMaxTilesPerBlock tiles
  if (tid == 0) n_queued = 0;
  __syncthreads();
  for (int k = k_begin + tid; k < k_end; k += nthr)
    if (score_one<1, kLattice>(k, coeffs_lon, coeffs_lat, traj_len,
                               goal_valid, pb, P, M, Mp, V, T, flags,
                               out_masked, out_kin, out_reason))
      queue[atomicAdd(&n_queued, 1)] = k;
  __syncthreads();
  const int n = n_queued;
  // a queued candidate's operands are loaded (or built) again
  for (int i = tid; i < n; i += nthr)
    score_one<2, kLattice>(queue[i], coeffs_lon, coeffs_lat, traj_len,
                           goal_valid, pb, P, M, Mp, V, T, flags, out_masked,
                           out_kin, out_reason);
}

#define CRP_SCORER_PARAMS                                                     \
  const float *__restrict__ coeffs_lon, const float *__restrict__ coeffs_lat, \
      const float *__restrict__ traj_len,                                     \
      const float *__restrict__ goal_valid, const float *__restrict__ tables, \
      int P, const float *__restrict__ obs, int M,                            \
      const float *__restrict__ poly, int Mp, int V,                          \
      const float *__restrict__ scal, int F, int K, int T, int flags,         \
      float *__restrict__ out
#define CRP_SCORER_ARGS                                                      \
  coeffs_lon, coeffs_lat, traj_len, goal_valid, tables, P, obs, M, poly, Mp, \
      V, scal, F, K, T, flags, out

// one planning problem (F = 1), a block per K-tile
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    score_kernel(CRP_SCORER_PARAMS) {
  score_block<false, false>(CRP_SCORER_ARGS);
}

// a fleet of F problems, screened; kLattice: the candidates are built from
// the lattice form of the four candidate operands (the fleet scan), else
// loaded (score_fleet)
template <bool kLattice>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    fleet_score_kernel(CRP_SCORER_PARAMS) {
  score_block<true, kLattice>(CRP_SCORER_ARGS);
}

// The coefficient rows and valid steps of J chosen candidates of each of F
// problems' lattices (x0_lon, x0_lat [F, 3], bounds [F, 2], the level
// table and sizes, each problem's scalar row for its low-velocity mode), one
// thread each: index [F, J] (int64), out [F, J, 13] (coeffs_lon | coeffs_lat
// | valid steps).  An index outside [0, K) gives NaN rows and 0 steps.
__global__ void __launch_bounds__(128) lattice_candidates_kernel(
    const float* __restrict__ x0_lon, const float* __restrict__ x0_lat,
    const float* __restrict__ bounds, const float* __restrict__ level,
    const float* __restrict__ scal, const long long* __restrict__ index,
    int F, int J, int K, int flags, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= F * J) return;
  const int f = i / J;
  const long long k = __ldg(index + i);
  float* o = out + (size_t)i * 13;
  if (k < 0 || k >= K) {
    for (int c = 0; c < 12; ++c) o[c] = __int_as_float(0x7fc00000);
    o[12] = 0.0f;
    return;
  }
  float cl[6], ca[6], n_valid;
  bool goal_ok;
  lattice_operands((int)k, x0_lon + f * 3, x0_lat + f * 3, bounds + f * 2,
                   level, flags, __ldg(scal + f * S_NUM + S_LOW_VEL) > 0.5f,
                   cl, ca, n_valid, goal_ok);
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    o[c] = cl[c];
    o[6 + c] = ca[c];
  }
  o[12] = n_valid;
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

// The most shared memory one block may have on sm_90, static and dynamic
constexpr long kSharedPerBlock = 227 * 1024;

// Launches a scorer kernel (score_kernel, or a fleet_score_kernel when
// fleet) with the dynamic shared memory its sizes need; above 48 KB the
// kernel's limit is raised first, once per size reached (raised_to, one per
// kernel).  args are the kernel's arguments.
template <class Kernel, class... Args>
int launch_scorer(Kernel kernel, int& raised_to, bool fleet, int P, int M,
                  int F, int K, int T, void* stream, Args... args) {
  if (K <= 0 || F <= 0) return 0;
  if (F > 65535 || P < 2) return (int)cudaErrorInvalidConfiguration;
  const long smem_bytes = 4 * staged_floats(P, M, T);
  if (smem_bytes > kSharedPerBlock) return (int)cudaErrorInvalidValue;
  if (smem_bytes > 48 * 1024 && smem_bytes > raised_to) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
    if (err != cudaSuccess) return (int)err;
    raised_to = (int)smem_bytes;
  }
  // a block of the fleet kernel walks several K-tiles once the launch has
  // blocks to spare: its screen then fills its second pass from more
  // candidates, and the problem is staged once for all of them
  const int tiles = (K + kThreads - 1) / kThreads;
  long per_block = 1;
  if (fleet) per_block = (long)F * tiles / kBlocksWanted;
  if (per_block > kMaxTilesPerBlock) per_block = kMaxTilesPerBlock;
  if (per_block < 1) per_block = 1;
  const dim3 blocks((tiles + per_block - 1) / per_block, F);
  kernel<<<blocks, kThreads, smem_bytes, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory (bytes) of one scorer block for these sizes.
extern "C" long crp_score_shared_bytes(int P, int M, int T) {
  return 4 * staged_floats(P, M, T);
}

// The most dynamic shared memory (bytes) a block of any scorer kernel may
// ask for beside its static shared memory (the fleet kernel's queue), which
// is counted in whole KB, or -1.
extern "C" long crp_score_shared_limit() {
  cudaFuncAttributes one, loaded, lattice;
  if (cudaFuncGetAttributes(&one, score_kernel) != cudaSuccess ||
      cudaFuncGetAttributes(&loaded, fleet_score_kernel<false>) !=
          cudaSuccess ||
      cudaFuncGetAttributes(&lattice, fleet_score_kernel<true>) !=
          cudaSuccess)
    return -1;
  size_t fixed = one.sharedSizeBytes;
  if (loaded.sharedSizeBytes > fixed) fixed = loaded.sharedSizeBytes;
  if (lattice.sharedSizeBytes > fixed) fixed = lattice.sharedSizeBytes;
  return kSharedPerBlock - ((long)fixed + 1023) / 1024 * 1024;
}

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

// crp_trivial's arguments, nothing launched
extern "C" int crp_empty(const float*, const float*, const float*, int,
                         const float*, int, float*, void*) {
  return 0;
}

// One problem: the operands of ScorerInputs, out [3, K] (masked, kin,
// reason).
extern "C" int crp_score_candidates(
    const float* coeffs_lon, const float* coeffs_lat, const float* traj_len,
    const float* goal_valid, const float* tables, int P, const float* obs,
    int M, const float* poly, int Mp, int V, const float* scal, int K, int T,
    int flags, float* out, void* stream) {
  static int raised_to = 0;
  const int F = 1;
  return launch_scorer(score_kernel, raised_to, false, P, M, F, K, T, stream,
                       CRP_SCORER_ARGS);
}

// F problems: the operands of FleetScorerInputs, out [3, F, K].
extern "C" int crp_score_fleet(
    const float* coeffs_lon, const float* coeffs_lat, const float* traj_len,
    const float* goal_valid, const float* tables, int P, const float* obs,
    int M, const float* poly, int Mp, int V, const float* scal, int F, int K,
    int T, int flags, float* out, void* stream) {
  static int raised_to = 0;
  return launch_scorer(fleet_score_kernel<false>, raised_to, true, P, M, F,
                       K, T, stream, CRP_SCORER_ARGS);
}

// F problems whose candidates are the lattice of FleetLatticeInputs: the
// per-problem x0_lon, x0_lat [F, 3] and bounds [F, 2] and the level table in
// place of the four candidate operands of crp_score_fleet, the level's sizes
// in flags; out [3, F, K].
extern "C" int crp_score_fleet_lattice(
    const float* x0_lon, const float* x0_lat, const float* bounds,
    const float* level, const float* tables, int P, const float* obs, int M,
    const float* poly, int Mp, int V, const float* scal, int F, int K, int T,
    int flags, float* out, void* stream) {
  static int raised_to = 0;
  return launch_scorer(fleet_score_kernel<true>, raised_to, true, P, M, F, K,
                       T, stream, x0_lon, x0_lat, bounds, level, tables, P,
                       obs, M, poly, Mp, V, scal, F, K, T, flags, out);
}

// The chosen candidates index [F, J] (int64) of the same lattice of K
// candidates (its sizes in flags), with each problem's scalar row scal
// [F, 17]: out [F, J, 13].
extern "C" int crp_lattice_candidates(
    const float* x0_lon, const float* x0_lat, const float* bounds,
    const float* level, const float* scal, const long long* index, int F,
    int J, int K, int flags, float* out, void* stream) {
  if (F <= 0 || J <= 0) return 0;
  const int threads = 128;
  const int blocks = (F * J + threads - 1) / threads;
  lattice_candidates_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      x0_lon, x0_lat, bounds, level, scal, index, F, J, K, flags, out);
  return (int)cudaGetLastError();
}
