// OBB collision mask for NVIDIA Hopper (sm_90a): ego boxes [T, K] against the
// box/disc obstacle group [M, T], one bool per candidate.
//
// Replaces the TPU kernel commonroad_rp_tpu/ops/pallas_kernels.py
// _collision_kernel (launched by obb_collision_pallas), which computes the
// obstacle pass of commonroad_rp_tpu/ops/collision.py::check_collisions
// (:639-671).  The plain PyTorch version is
// commonroad_rp_tpu_torch/ops/collision_kernel.py::obb_collision_reference;
// the port's check_collisions sends its whole box/disc group here.
//
// Function: for candidate k, any step t and obstacle m with valid[m, t]:
//   box rows (radius 0): the four-axis separating-axis test of the ego box
//     (center (cx, cy)[t, k], heading theta[t, k], half extents ehl, ehw)
//     against the obstacle box (pose[m, t], half_ext[m]), with the
//     relative-rotation projection radii of pallas_kernels.py:59-78;
//   disc rows (radius > 0): the exact closest-point test in the ego frame,
//     max(lx - ehl, 0)^2 + max(ly - ehw, 0)^2 <= r^2 (collision.py:662-669).
// The ego centers arrive already shifted wb_rear_axle ahead of the rear axle
// (the caller shifts; this kernel must not shift again).
//
// Two forms: obb_collision_kernel takes one problem ([T, K] poses, host
// scalar ego extents: the conformance level program); the fleet form
// obb_collision_fleet_kernel takes F problems in one launch ([F, T, K] poses,
// [F, M, T] rows, per-problem ego extents [F] on the device: the XLA fleet
// path's check_collisions, jax.vmap of the single-problem pass in
// commonroad_rp_tpu/parallel/fleet.py:138-140) and puts the problem index in
// blockIdx.y.  Its plain version is
// commonroad_rp_tpu_torch/ops/collision_kernel.py::obb_collision_fleet_reference.
//
// Templated over float and double: the float instance is what the TPU kernel
// computes (kernel_dtype float32 with fast_scoring off); the double instance
// serves the float64 conformance path, whose goldens hold to 1e-9.
//
// Design:
//  * A block belongs to one problem and stages its rows once (stage_rows):
//    per (step, row) the position, the heading's cos/sin (computed here, once
//    per block, not per thread), the squared reach of the skip below and
//    valid; per row the half extents and the disc radius.  Dynamic shared
//    memory, ops/collision_kernel.py::shared_bytes bytes (2265 B at the XLA
//    fleet path's M = 5, T = 21 in float; 40400 B at 16 rows x 61 steps in
//    double; above 48 KB after cudaFuncSetAttribute).
//  * An exact bounding-circle skip (far_apart): a pair whose centres lie
//    further apart than (1 + delta) times the sum of the two boxes'
//    circumradii (a disc's radius) cannot collide, and its test is skipped;
//    the ego heading's cos/sin are computed once per step (one sincos), and
//    only once a row of that step survives the skip.  Why it is exact: see
//    Skip.
//  * Each thread owns one candidate and a set of steps; the single-problem
//    form spreads a candidate's steps over kStepGroups warps (32 candidates
//    x 8 step groups a block: the conformance shapes, K = 90-3060, fill more
//    of the card) and ORs their verdicts through shared memory; the fleet
//    form keeps one thread per candidate and every step (8 step groups were
//    slower there), and a block walks kFleetTilesPerBlock K-tiles.  Every
//    thread leaves its loops at its first hit; a step group also stops once
//    another group has found one.
//  * Ego poses are read T-major, so the threads of a warp read neighbouring
//    addresses.  The mask is written as 0/1 bytes straight into the storage
//    of the wrapper's torch.bool tensor: one launch per call.
//
// What bounds it on the card (PERF.md, rows 4 and 4f): the fleet form at the
// XLA fleet path's full width (F = 1024, K = 2754, T = 21: 2.82M threads)
// must read 12 bytes per evaluated candidate-step in float, once (its bytes
// bound); with the obstacle transcendentals staged and 99 % of the live pair
// tests skipped, a step costs its three loads, a few multiplies per row and,
// near a row, one sincos, and the kernel runs at about half that bound: what
// is left is the latency of those loads and the early exits that end the
// threads of a warp at different steps.  The single-problem form at the
// conformance shapes (1-96 blocks) is bound by one block's latency: staging,
// then two or three steps per thread, a few microseconds; its call costs
// more in the wrapper's Python than on the card.
//
// Numerics: built without fast math, with IEEE division and square root and
// without FMA contraction (-fmad=false), so every operation rounds as the
// plain version's separate tensor operations do, in either type.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// sin and cos of one angle through one argument reduction: the same values
// as sinf/cosf (sin/cos) apart, and one call of the slow reduction path for
// large angles instead of two, which keeps the double fleet kernel from
// spilling around it
__device__ __forceinline__ void dsincos(float x, float* s, float* c) {
  sincosf(x, s, c);
}
__device__ __forceinline__ void dsincos(double x, double* s, double* c) {
  sincos(x, s, c);
}

// ---- the pair test and the skip (plain C++ once __device__ is defined away:
// tests/test_torch_collision.py compiles this part with g++)

__device__ __forceinline__ float dabs(float x) { return fabsf(x); }
__device__ __forceinline__ double dabs(double x) { return fabs(x); }
__device__ __forceinline__ float dhypot(float x, float y) {
  return hypotf(x, y);
}
__device__ __forceinline__ double dhypot(double x, double y) {
  return hypot(x, y);
}

// max(x, 0) that keeps a NaN, as torch.clamp(min=0) and jnp.maximum do
template <typename S>
__device__ __forceinline__ S relu_nan(S x) {
  return (x > S(0) || x != x) ? x : S(0);
}

// The skip's slack: a pair is skipped when d > (1 + delta) (R_e + R_o), with
// delta = 2^-8 (a power of two: 1 + delta and its products are exact).
// Why no skipped pair can be a hit of the full test, in float as in double
// (u the unit roundoff, 2^-24 or 2^-53):
//  * exact geometry: boxes inside circles whose centres are d apart have a
//    gap g = d - R_e - R_o >= d delta / (1 + delta) between them; the
//    Minkowski difference of two rectangles has its edge normals (the four
//    SAT axes) at most 90 degrees apart, so one SAT axis sees at least
//    g / sqrt(2), and a disc's closest point on the ego box lies at least g
//    beyond its radius;
//  * rounding: each SAT term (the projection |dx c + dy s| and the radius
//    sum e + o rc + o' rs, with cos/sin within 2 ulp) is within about
//    10 u (|dx| + |dy| + |ehl| + |ehw| + |ohl| + |ohw|) <= 30 u d of its
//    exact value (signed or negative extents only shrink a radius sum), and
//    d^2 > reach^2 computed holds only where d > (1 + delta)(R_e + R_o)
//    (1 - 8 u); against a margin of 2.7e-3 d that leaves a factor of 1000
//    in float;
//  * the skip is left to the full test where these bounds do not hold: a
//    NaN or infinite d^2 (NaN or inf poses, overflow), a non-finite heading
//    (cos/sin NaN: the full test reports a hit), a NaN or infinite reach,
//    and R_e + R_o below kMinRadius, which keeps d^2 and reach^2 normal
//    numbers (no subnormal rounding).
template <typename S>
struct Skip {
  static constexpr S kScale = S(1) + S(1) / S(256);
  static constexpr S kMinRadius = S(1) / S(1048576);  // 2^-20
};

// Circumradius of a row: a disc's radius, else hypot of the half extents.
template <typename S>
__device__ __forceinline__ S row_radius(S ohl, S ohw, S r) {
  return r > S(0) ? r : dhypot(ohl, ohw);
}

// Squared reach of a (step, row) for the skip, or NaN where the skip must
// not be taken (the row's heading not finite, a reach that is NaN, infinite
// or below kMinRadius).  r_sum = R_e + R_o.
template <typename S>
__device__ __forceinline__ S skip_reach2(S r_sum, S o_theta) {
  const S reach = Skip<S>::kScale * r_sum;
  const S reach2 = reach * reach;
  const bool ok = r_sum >= Skip<S>::kMinRadius && isfinite(o_theta) &&
                  isfinite(reach2);
  return ok ? reach2 : S(NAN);
}

// The skip's predicate: the centres (dx, dy) apart lie beyond the reach;
// never for a NaN or infinite d^2 or a NaN reach.
template <typename S>
__device__ __forceinline__ bool far_apart(S dx, S dy, S reach2) {
  const S d2 = dx * dx + dy * dy;
  return d2 > reach2 && isfinite(d2);
}

// The full test of one (step, row) pair: the ego box (heading cos/sin e_c,
// e_s, half extents ehl, ehw) and the row (centre dx, dy from the ego's,
// heading cos/sin o_c, o_s, half extents ohl, ohw, disc radius r).
template <typename S>
__device__ __forceinline__ bool pair_hits(S dx, S dy, S e_c, S e_s, S o_c,
                                          S o_s, S ehl, S ehw, S ohl, S ohw,
                                          S r) {
  const S lx = dabs(dx * e_c + dy * e_s);
  const S ly = dabs(-dx * e_s + dy * e_c);
  if (r > S(0)) {
    const S qx = relu_nan(lx - ehl);
    const S qy = relu_nan(ly - ehw);
    return qx * qx + qy * qy <= r * r;
  }
  const S rel_cos = dabs(e_c * o_c + e_s * o_s);
  const S rel_sin = dabs(o_s * e_c - o_c * e_s);
  const bool sep =
      (lx > ehl + ohl * rel_cos + ohw * rel_sin) ||
      (ly > ehw + ohl * rel_sin + ohw * rel_cos) ||
      (dabs(dx * o_c + dy * o_s) > ohl + ehl * rel_cos + ehw * rel_sin) ||
      (dabs(-dx * o_s + dy * o_c) > ohw + ehl * rel_sin + ehw * rel_cos);
  return !sep;
}

// One problem's rows as a block sees them: in ``s``, five [T * M] planes
// indexed j = t * M + m (a step's rows side by side) -- x, y, cos and sin of
// the heading, the skip's squared reach (skip_reach2; NaN: never skip) --
// then three [M] planes -- half length, half width, disc radius (0 for a
// box); ``valid`` [T * M] bytes.  A base pointer and two sizes, so that few
// registers hold it.
template <typename S>
struct Rows {
  S* s;
  uint8_t* valid;
  int n;   // T * M
  int M;
  __device__ __forceinline__ S& ox(int j) const { return s[j]; }
  __device__ __forceinline__ S& oy(int j) const { return s[n + j]; }
  __device__ __forceinline__ S& oc(int j) const { return s[2 * n + j]; }
  __device__ __forceinline__ S& os(int j) const { return s[3 * n + j]; }
  __device__ __forceinline__ S& reach2(int j) const { return s[4 * n + j]; }
  __device__ __forceinline__ S& ohl(int m) const { return s[5 * n + m]; }
  __device__ __forceinline__ S& ohw(int m) const { return s[5 * n + M + m]; }
  __device__ __forceinline__ S& rad(int m) const {
    return s[5 * n + 2 * M + m];
  }
};

// Does the ego box at (ex, ey, th) hit a valid row of step t?  A first pass
// finds the first valid row that survives the skip (none: the step is done
// without its heading); ``heading`` then gives the ego heading's cos/sin,
// once, and the second pass tests the surviving rows from there on.
template <typename S, typename Heading>
__device__ __forceinline__ bool step_hits(const Rows<S>& rows, int t, int M,
                                          S ex, S ey, S th, S ehl, S ehw,
                                          Heading heading) {
  const bool skip_ok = isfinite(th);
  const auto survives = [&](int j) {
    return rows.valid[j] &&
           !(skip_ok &&
             far_apart(rows.ox(j) - ex, rows.oy(j) - ey, rows.reach2(j)));
  };
  int m = 0;
  while (m < M && !survives(t * M + m)) ++m;
  if (m == M) return false;
  S e_c, e_s;
  heading(th, e_c, e_s);
  for (; m < M; ++m) {
    const int j = t * M + m;
    if (!survives(j)) continue;
    if (pair_hits(rows.ox(j) - ex, rows.oy(j) - ey, e_c, e_s, rows.oc(j),
                  rows.os(j), ehl, ehw, rows.ohl(m), rows.ohw(m),
                  rows.rad(m)))
      return true;
  }
  return false;
}

// ---- end of the part compiled on the CPU

constexpr int kThreads = 256;
// step groups of a block (warps that share a candidate's steps): the
// single-problem form runs 32 candidates x 8 step groups, the fleet form one
// thread per candidate
constexpr int kStepGroups = 8;
constexpr int kFleetStepGroups = 1;
// fleet form: K-tiles a block walks (a problem is staged about 6 times at
// K = 2754; 1 tile per block is as fast, 4 and 11 slower: PERF.md)
constexpr int kFleetTilesPerBlock = 2;
// the most shared memory one block may have on sm_90, static and dynamic
constexpr long kSharedPerBlock = 227 * 1024;

// Dynamic shared memory (bytes) of one block: 5 values per (step, row), 3
// per row, then the valid bytes (ops/collision_kernel.py::shared_bytes
// computes the same).
inline long staged_bytes(int M, int T, int size) {
  return (long)size * (5L * M * T + 3L * M) + (long)M * T;
}

extern __shared__ __align__(16) unsigned char crp_collision_smem[];

// The block's threads load one problem's rows into shared memory; ends with
// a barrier.  pose [M, T, 3], half_ext [M, 2], valid [M, T], radius [M] or
// null: that problem's base; r_ego = hypot(ehl, ehw).
template <typename S>
__device__ __forceinline__ Rows<S> stage_rows(
    const S* __restrict__ pose, const S* __restrict__ half_ext,
    const uint8_t* __restrict__ valid, const S* __restrict__ radius, S r_ego,
    int T, int M) {
  const int n = M * T;
  S* base = reinterpret_cast<S*>(crp_collision_smem);
  const Rows<S> rows{base, reinterpret_cast<uint8_t*>(base + 5 * n + 3 * M),
                     n, M};
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthr = blockDim.x * blockDim.y;
  for (int m = tid; m < M; m += nthr) {
    rows.ohl(m) = __ldg(half_ext + 2 * m);
    rows.ohw(m) = __ldg(half_ext + 2 * m + 1);
    rows.rad(m) = radius != nullptr ? __ldg(radius + m) : S(0);
  }
  for (int i = tid; i < n; i += nthr) {      // i = m * T + t: global order
    const int m = i / T;
    const int j = (i - m * T) * M + m;
    const S* p = pose + 3 * (size_t)i;
    const S theta = __ldg(p + 2);
    const S r = radius != nullptr ? __ldg(radius + m) : S(0);
    const S r_obs = row_radius(__ldg(half_ext + 2 * m),
                               __ldg(half_ext + 2 * m + 1), r);
    rows.ox(j) = __ldg(p);
    rows.oy(j) = __ldg(p + 1);
    dsincos(theta, &rows.os(j), &rows.oc(j));
    rows.reach2(j) = skip_reach2(r_ego + r_obs, theta);
    rows.valid[j] = __ldg(valid + i);
  }
  __syncthreads();
  return rows;
}

// One block's candidates of one problem (every pointer that problem's
// base): threadIdx.x is the candidate within a K-tile of blockDim.x,
// threadIdx.y the step group (steps y, y + blockDim.y, ...); the block walks
// the tiles blockIdx.x, blockIdx.x + gridDim.x, ...
template <typename S>
__device__ __forceinline__ void collide_block(
    const S* __restrict__ cx, const S* __restrict__ cy,
    const S* __restrict__ theta, const S* __restrict__ pose,
    const S* __restrict__ half_ext, const uint8_t* __restrict__ valid,
    const S* __restrict__ radius, S ehl, S ehw, int K, int T, int M,
    uint8_t* __restrict__ out) {
  // hit_tile[lane] = tile + 1 once a step group has found a hit of that
  // candidate: tiles only grow, so nothing is reset between tiles
  __shared__ int hit_tile[kThreads];
  const int W = blockDim.x, G = blockDim.y;
  const int lane = threadIdx.x, group = threadIdx.y;
  volatile int* flag = hit_tile + lane;
  if (group == 0) *flag = 0;
  const Rows<S> rows = stage_rows(pose, half_ext, valid, radius,
                                  dhypot(ehl, ehw), T, M);
  const auto heading = [](S th, S& c, S& s) { dsincos(th, &s, &c); };
  const int tiles = (K + W - 1) / W;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int k = tile * W + lane;
    bool hit = false;
    if (k < K) {
      for (int t = group; t < T; t += G) {
        if (G > 1 && *flag == tile + 1) break;
        const size_t a = (size_t)t * K + k;
        if (step_hits(rows, t, M, cx[a], cy[a], theta[a], ehl, ehw,
                      heading)) {
          hit = true;
          break;
        }
      }
    }
    if (G == 1) {
      if (k < K) out[k] = hit ? 1 : 0;
    } else {
      if (hit) *flag = tile + 1;
      __syncthreads();
      if (group == 0 && k < K) out[k] = *flag == tile + 1 ? 1 : 0;
      __syncthreads();
    }
  }
}

template <typename S>
__global__ void __launch_bounds__(kThreads) obb_collision_kernel(
    const S* __restrict__ cx, const S* __restrict__ cy,
    const S* __restrict__ theta, const S* __restrict__ pose,
    const S* __restrict__ half_ext, const uint8_t* __restrict__ valid,
    const S* __restrict__ radius, S ehl, S ehw, int K, int T, int M,
    uint8_t* __restrict__ out) {
  collide_block<S>(cx, cy, theta, pose, half_ext, valid, radius, ehl, ehw, K,
                   T, M, out);
}

// Fleet form: problem f = blockIdx.y, every operand offset by its problem's
// stride ([F, T, K] poses, [F, M, T, 3] obstacle rows, [F] ego extents read
// from the device); all problems share the padded sizes T and M
// (parallel/fleet.py pads the rows invalid with half extents 1: only valid
// keeps them out).
template <typename S>
__global__ void __launch_bounds__(kThreads) obb_collision_fleet_kernel(
    const S* __restrict__ cx, const S* __restrict__ cy,
    const S* __restrict__ theta, const S* __restrict__ pose,
    const S* __restrict__ half_ext, const uint8_t* __restrict__ valid,
    const S* __restrict__ radius, const S* __restrict__ ehl,
    const S* __restrict__ ehw, int K, int T, int M,
    uint8_t* __restrict__ out) {
  const size_t f = blockIdx.y;
  const size_t tk = f * (size_t)T * K;
  const size_t mt = f * (size_t)M * T;
  collide_block<S>(cx + tk, cy + tk, theta + tk, pose + mt * 3,
                   half_ext + f * (size_t)M * 2, valid + mt,
                   radius != nullptr ? radius + f * (size_t)M : nullptr,
                   __ldg(ehl + f), __ldg(ehw + f), K, T, M,
                   out + f * (size_t)K);
}

// Raises the kernel's dynamic shared-memory limit when a launch needs more
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
int launch_fleet(const void* cx, const void* cy, const void* theta,
                 const void* pose, const void* half_ext, const void* valid,
                 const void* radius, const void* ehl, const void* ehw, int F,
                 int K, int T, int M, void* out, void* stream) {
  static int raised_to = 0;
  if (K <= 0 || F <= 0) return 0;
  if (F > 65535) return (int)cudaErrorInvalidConfiguration;
  const long smem = staged_bytes(M, T, sizeof(S));
  const int rc = fit_shared(obb_collision_fleet_kernel<S>, smem, &raised_to);
  if (rc != 0) return rc;
  const int width = kThreads / kFleetStepGroups;
  const int tiles = (K + width - 1) / width;
  const dim3 blocks((tiles + kFleetTilesPerBlock - 1) / kFleetTilesPerBlock,
                    F);
  obb_collision_fleet_kernel<S>
      <<<blocks, dim3(width, kFleetStepGroups), smem,
         (cudaStream_t)stream>>>(
          static_cast<const S*>(cx), static_cast<const S*>(cy),
          static_cast<const S*>(theta), static_cast<const S*>(pose),
          static_cast<const S*>(half_ext), static_cast<const uint8_t*>(valid),
          static_cast<const S*>(radius), static_cast<const S*>(ehl),
          static_cast<const S*>(ehw), K, T, M, static_cast<uint8_t*>(out));
  return (int)cudaGetLastError();
}

template <typename S>
int launch(const void* cx, const void* cy, const void* theta,
           const void* pose, const void* half_ext, const void* valid,
           const void* radius, S ehl, S ehw, int K, int T, int M, void* out,
           void* stream) {
  static int raised_to = 0;
  if (K <= 0) return 0;
  const long smem = staged_bytes(M, T, sizeof(S));
  const int rc = fit_shared(obb_collision_kernel<S>, smem, &raised_to);
  if (rc != 0) return rc;
  const int width = kThreads / kStepGroups;
  const int blocks = (K + width - 1) / width;
  obb_collision_kernel<S>
      <<<blocks, dim3(width, kStepGroups), smem, (cudaStream_t)stream>>>(
          static_cast<const S*>(cx), static_cast<const S*>(cy),
          static_cast<const S*>(theta), static_cast<const S*>(pose),
          static_cast<const S*>(half_ext), static_cast<const uint8_t*>(valid),
          static_cast<const S*>(radius), ehl, ehw, K, T, M,
          static_cast<uint8_t*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// cx, cy, theta: [T, K]; pose: [M, T, 3]; half_ext: [M, 2]; valid: [M, T]
// (bool bytes); radius: [M] or null; out: [K] bool bytes.  All contiguous.
extern "C" int crp_obb_collision_f32(
    const void* cx, const void* cy, const void* theta, const void* pose,
    const void* half_ext, const void* valid, const void* radius, float ehl,
    float ehw, int K, int T, int M, void* out, void* stream) {
  return launch<float>(cx, cy, theta, pose, half_ext, valid, radius, ehl, ehw,
                       K, T, M, out, stream);
}

extern "C" int crp_obb_collision_f64(
    const void* cx, const void* cy, const void* theta, const void* pose,
    const void* half_ext, const void* valid, const void* radius, double ehl,
    double ehw, int K, int T, int M, void* out, void* stream) {
  return launch<double>(cx, cy, theta, pose, half_ext, valid, radius, ehl,
                        ehw, K, T, M, out, stream);
}

// Fleet form: cx, cy, theta: [F, T, K]; pose: [F, M, T, 3]; half_ext:
// [F, M, 2]; valid: [F, M, T] (bool bytes); radius: [F, M] or null; ehl, ehw:
// [F] (device arrays); out: [F, K] bool bytes.  All contiguous.
extern "C" int crp_obb_collision_fleet_f32(
    const void* cx, const void* cy, const void* theta, const void* pose,
    const void* half_ext, const void* valid, const void* radius,
    const void* ehl, const void* ehw, int F, int K, int T, int M, void* out,
    void* stream) {
  return launch_fleet<float>(cx, cy, theta, pose, half_ext, valid, radius, ehl,
                             ehw, F, K, T, M, out, stream);
}

extern "C" int crp_obb_collision_fleet_f64(
    const void* cx, const void* cy, const void* theta, const void* pose,
    const void* half_ext, const void* valid, const void* radius,
    const void* ehl, const void* ehw, int F, int K, int T, int M, void* out,
    void* stream) {
  return launch_fleet<double>(cx, cy, theta, pose, half_ext, valid, radius,
                              ehl, ehw, F, K, T, M, out, stream);
}

// Dynamic shared memory (bytes) of one block of either form for M rows over
// T steps of ``size``-byte values (4 or 8).
extern "C" long crp_collision_shared_bytes(int M, int T, int size) {
  return staged_bytes(M, T, size);
}

// The most dynamic shared memory (bytes) a block of any collision kernel may
// ask for beside its static shared memory (the step groups' hit flags),
// which is counted in whole KB, or -1.
extern "C" long crp_collision_shared_limit() {
  const void* kernels[] = {(const void*)obb_collision_kernel<float>,
                           (const void*)obb_collision_kernel<double>,
                           (const void*)obb_collision_fleet_kernel<float>,
                           (const void*)obb_collision_fleet_kernel<double>};
  size_t fixed = 0;
  for (const void* kernel : kernels) {
    cudaFuncAttributes attr;
    if (cudaFuncGetAttributes(&attr, kernel) != cudaSuccess) return -1;
    if (attr.sharedSizeBytes > fixed) fixed = attr.sharedSizeBytes;
  }
  return kSharedPerBlock - ((long)fixed + 1023) / 1024 * 1024;
}
