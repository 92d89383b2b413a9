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
// Design: one thread per candidate with a serial loop over the steps and the
// obstacles, leaving both loops at the first hit.  Ego poses are read
// T-major, so the threads of a warp read neighbouring addresses; the
// obstacle rows are the same for every thread of a warp and come through the
// read-only path (__ldg); the table is a few KB.  The output is a uint8 [K]
// mask.
//
// What bounds it on the card: at the conformance shapes (K up to a few
// thousand, T = 21-61, M up to ~16) the launch latency, then the
// transcendentals: two per (t, k) for the ego heading and two per (t, k, m)
// for the obstacle heading, which every thread recomputes.  Bytes are
// negligible (3 values per (t, k) once, the obstacle table from cache).  The
// early exit skips the rest of a colliding candidate.  The fleet form at the
// XLA fleet path's full width (F = 1024, K = 2754: 2.82M threads) fills the
// card; it reads 3 values per (f, t, k), 12 bytes per candidate-step in
// float32, once.  Later work: stage the
// obstacle cos/sin per step in shared memory once per block, and fuse the
// pass into the rollout so the ego poses never leave registers.
//
// Numerics: built without fast math, with IEEE division and square root and
// without FMA contraction (-fmad=false), so every operation rounds as the
// plain version's separate tensor operations do, in either type.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float dcos(float x) { return cosf(x); }
__device__ __forceinline__ double dcos(double x) { return cos(x); }
__device__ __forceinline__ float dsin(float x) { return sinf(x); }
__device__ __forceinline__ double dsin(double x) { return sin(x); }
__device__ __forceinline__ float dabs(float x) { return fabsf(x); }
__device__ __forceinline__ double dabs(double x) { return fabs(x); }

// max(x, 0) that keeps a NaN, as torch.clamp(min=0) and jnp.maximum do
template <typename S>
__device__ __forceinline__ S relu_nan(S x) {
  return (x > S(0) || x != x) ? x : S(0);
}

// Candidate k of one problem against its box/disc rows; every pointer is
// that problem's base.  Leaves both loops at the first hit.
template <typename S>
__device__ __forceinline__ bool candidate_hits(
    int k, const S* __restrict__ cx, const S* __restrict__ cy,
    const S* __restrict__ theta, const S* __restrict__ pose,
    const S* __restrict__ half_ext, const uint8_t* __restrict__ valid,
    const S* __restrict__ radius, S ehl, S ehw, int K, int T, int M) {
  bool hit = false;
  for (int t = 0; t < T && !hit; ++t) {
    const S ex = cx[t * K + k];
    const S ey = cy[t * K + k];
    const S th = theta[t * K + k];
    const S e_cos = dcos(th);
    const S e_sin = dsin(th);
    for (int m = 0; m < M; ++m) {
      if (!__ldg(valid + m * T + t)) continue;
      const S* p = pose + (m * T + t) * 3;
      const S ox = __ldg(p), oy = __ldg(p + 1), ot = __ldg(p + 2);
      const S o_cos = dcos(ot);
      const S o_sin = dsin(ot);
      const S dx = ox - ex;
      const S dy = oy - ey;
      const S lx = dabs(dx * e_cos + dy * e_sin);
      const S ly = dabs(-dx * e_sin + dy * e_cos);
      const S r = radius != nullptr ? __ldg(radius + m) : S(0);
      if (r > S(0)) {
        const S qx = relu_nan(lx - ehl);
        const S qy = relu_nan(ly - ehw);
        hit = qx * qx + qy * qy <= r * r;
      } else {
        const S ohl = __ldg(half_ext + 2 * m);
        const S ohw = __ldg(half_ext + 2 * m + 1);
        const S rel_cos = dabs(e_cos * o_cos + e_sin * o_sin);
        const S rel_sin = dabs(o_sin * e_cos - o_cos * e_sin);
        const bool sep =
            (lx > ehl + ohl * rel_cos + ohw * rel_sin) ||
            (ly > ehw + ohl * rel_sin + ohw * rel_cos) ||
            (dabs(dx * o_cos + dy * o_sin) >
             ohl + ehl * rel_cos + ehw * rel_sin) ||
            (dabs(-dx * o_sin + dy * o_cos) >
             ohw + ehl * rel_sin + ehw * rel_cos);
        hit = !sep;
      }
      if (hit) break;
    }
  }
  return hit;
}

template <typename S>
__global__ void __launch_bounds__(256) obb_collision_kernel(
    const S* __restrict__ cx, const S* __restrict__ cy,
    const S* __restrict__ theta, const S* __restrict__ pose,
    const S* __restrict__ half_ext, const uint8_t* __restrict__ valid,
    const S* __restrict__ radius, S ehl, S ehw, int K, int T, int M,
    uint8_t* __restrict__ out) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  out[k] = candidate_hits<S>(k, cx, cy, theta, pose, half_ext, valid, radius,
                             ehl, ehw, K, T, M) ? 1 : 0;
}

// Fleet form: problem f = blockIdx.y, every operand offset by its problem's
// stride ([F, T, K] poses, [F, M, T, 3] obstacle rows, [F] ego extents read
// from the device); all problems share the padded sizes T and M
// (parallel/fleet.py pads the rows invalid with half extents 1: only valid
// keeps them out).
template <typename S>
__global__ void __launch_bounds__(256) obb_collision_fleet_kernel(
    const S* __restrict__ cx, const S* __restrict__ cy,
    const S* __restrict__ theta, const S* __restrict__ pose,
    const S* __restrict__ half_ext, const uint8_t* __restrict__ valid,
    const S* __restrict__ radius, const S* __restrict__ ehl,
    const S* __restrict__ ehw, int K, int T, int M,
    uint8_t* __restrict__ out) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  const size_t f = blockIdx.y;
  const size_t tk = f * (size_t)T * K;
  const size_t mt = f * (size_t)M * T;
  out[f * (size_t)K + k] =
      candidate_hits<S>(k, cx + tk, cy + tk, theta + tk, pose + mt * 3,
                        half_ext + f * (size_t)M * 2, valid + mt,
                        radius != nullptr ? radius + f * (size_t)M : nullptr,
                        __ldg(ehl + f), __ldg(ehw + f), K, T, M)
          ? 1 : 0;
}

template <typename S>
int launch_fleet(const void* cx, const void* cy, const void* theta,
                 const void* pose, const void* half_ext, const void* valid,
                 const void* radius, const void* ehl, const void* ehw, int F,
                 int K, int T, int M, void* out, void* stream) {
  if (K <= 0 || F <= 0) return 0;
  if (F > 65535) return (int)cudaErrorInvalidConfiguration;
  const int threads = 256;
  const dim3 blocks((K + threads - 1) / threads, F);
  obb_collision_fleet_kernel<S><<<blocks, threads, 0, (cudaStream_t)stream>>>(
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
  if (K <= 0) return 0;
  const int threads = 256;
  const int blocks = (K + threads - 1) / threads;
  obb_collision_kernel<S><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      static_cast<const S*>(cx), static_cast<const S*>(cy),
      static_cast<const S*>(theta), static_cast<const S*>(pose),
      static_cast<const S*>(half_ext), static_cast<const uint8_t*>(valid),
      static_cast<const S*>(radius), ehl, ehw, K, T, M,
      static_cast<uint8_t*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// cx, cy, theta: [T, K]; pose: [M, T, 3]; half_ext: [M, 2]; valid: [M, T]
// (bool bytes); radius: [M] or null; out: [K] uint8.  All contiguous.
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
// [F] (device arrays); out: [F, K] uint8.  All contiguous.
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
