// Fused IRLS statistics for one Gauss-Newton iteration of the dense tracker.
//
// Replaces two TPU kernels of dvo_slam_tpu/ops/pallas_kernels.py:
//  * fused_stats_pallas (kernel body _kernel2), entry point dvo_fused_stats:
//    per pixel the photometric and geometric residuals, the Kinect-sigma
//    occlusion gate, the t-distribution weight from the previous precision
//    (unit weights on the first iteration) and the 12 Jacobian entries; over
//    all pixels the 16x16 Gram matrix of
//      U = [sqrt(w) J_I (6); sqrt(w) J_Z (6); sqrt(w) r_I; sqrt(w) r_Z; mask; 0],
//    then the new 2x2 precision from the Gram's scale terms and
//    sum log1p(r^T P_new r / dof) over the valid pixels.
//    Entry point dvo_fused_stats_batched runs the same four launches for B
//    streams at once (the lockstep multi-stream tracker, where the reference
//    vmaps fused_stats_pallas into a grid-batched pallas_call): launches A
//    and C take a grid (blocks per stream, B), B and D one block per stream,
//    and each block offsets its pointers by its stream index.  A stream's
//    tile partition and fixed-order reduces are those of dvo_fused_stats on
//    that stream's packs, so its outputs are bit-equal to a single-stream
//    call; one call replaces B x 4 launches with 4.
//  * fused_partials_pallas (kernel body _kernel), entry point
//    dvo_fused_partials: the same per-pixel chain and Gram in one pass, plus
//    the per-pixel rows rw [4, N] = (r_I, r_Z, w, mask), channel-major, for a
//    caller that finishes the log-likelihood itself (the pixel-sharded
//    alignment, which needs the precision of the Gram summed over all shards).
//
// What bounds it on the card: device-memory bandwidth.  Each pass reads the
// 64 bytes of sampled + refpack per pixel (the log-likelihood pass reads 28 of
// them), and fused_partials writes 16 bytes of rw per pixel on top; the maths
// is elementwise plus a 16-wide Gram, far below the card's arithmetic rate.
// At 640x480 level 1 (76,800 pixels) one pass moves ~5 MB, which sits in the
// 50 MB L2 cache between the passes.
//
// Design, re-thought for Hopper rather than carried over from the TPU grid:
//  * The TPU kernels carry their sums across a sequential grid; fused_stats
//    also stashes (r_I, r_Z, mask) in VMEM between its two passes.  Here
//    blocks run in no order, so each block writes its own partial Gram
//    (launch A), one block reduces the partials in a fixed order (launch B;
//    for fused_stats it also computes the new precision on the device).
//    fused_stats then RECOMPUTES r_I, r_Z and the mask from the inputs
//    instead of storing them and sums its log1p terms per block (launch C),
//    and one block sums those partials in a fixed order (launch D).
//    fused_partials is launches A and B only, with A writing rw as it goes
//    (a compile-time flag: fused_stats's launches compute what they did
//    before it existed).  There are no float atomics, so two runs are
//    bit-identical.
//  * The Gram runs in double: a product of two float32 entries is exact in
//    double and every sum is a double sum, so the result is the exact Gram
//    of the float32 rows up to double rounding, rounded once to float32.
//    (The plain twin sums in float32; the two differ by the twin's error.)
//  * The per-pixel chain is float32 and the file is built with -fmad=false
//    so that every product and sum rounds as in the plain PyTorch twin (no
//    contraction into fused multiply-adds): rw is bit-equal to the twin's
//    rows, and the in-kernel precision rounds exactly as the host-side one.
//  * The precision never leaves the device: params (fx, fy, dof, first,
//    P00, P01, P11, 0) is a device tensor that the wrapper builds with torch
//    ops, so no value is read back to launch the kernel.
//
// Later work, not done here: the Gram on tensor cores (wgmma in IEEE fp32
// emulation or split fp32) with TMA tile loads; folding the quad gather and
// the depth-buffered bilinear sample into this kernel's prologue so that
// `sampled` never reaches device memory; and the whole iteration's tail
// (precision, 6x6 solve, accept/reject) under one CUDA graph.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;           // threads per block in launches A and C
constexpr int kSubTile = kThreads;      // pixels staged in shared memory at once
constexpr int kSubTiles = 2;            // sub-tiles per block
constexpr int kTile = kSubTile * kSubTiles;  // pixels per block
constexpr int kRows = 16;               // rows of U
constexpr int kPairs = kRows * (kRows + 1) / 2;  // 136 upper-triangle entries
constexpr int kStride = kSubTile + 1;   // padded row stride: no bank conflicts

// variance floors of robust.precision_from_scale, rounded to float32 exactly
// as the PyTorch side rounds the Python constants
__device__ __forceinline__ float sigma_floor_i() { return (float)((0.05 / 255.0) * (0.05 / 255.0)); }
__device__ __forceinline__ float sigma_floor_z() { return (float)(1e-4 * 1e-4); }

struct Params {
  float fx, fy, dof, first, p00, p01, p11;
};

__device__ __forceinline__ Params load_params(const float* __restrict__ params) {
  Params p;
  p.fx = params[0];
  p.fy = params[1];
  p.dof = params[2];
  p.first = params[3];
  p.p00 = params[4];
  p.p01 = params[5];
  p.p11 = params[6];
  return p;
}

// Residual pair and validity of one pixel (the head of _pixel_math).
// refpack channels: i, z, idx, idy, x, y, sel, 0
// sampled channels: i_c, z_c, idx_c, idy_c, zdx_c, zdy_c, valid, z_t
__device__ __forceinline__ void residuals(const float* __restrict__ sampled,
                                          const float* __restrict__ refpack,
                                          int n, int p, float& r_i, float& r_z,
                                          float& maskf) {
  const float i_r = refpack[0 * n + p];
  const float z_r = refpack[1 * n + p];
  const float sel = refpack[6 * n + p];
  const float i_c = sampled[0 * n + p];
  const float z_c = sampled[1 * n + p];
  const float validf = sampled[6 * n + p];
  const float z_t = sampled[7 * n + p];

  r_i = (i_c - i_r) * (float)(1.0 / 255.0);
  r_z = z_c - z_t;
  float sigma = z_r - 0.4f;
  sigma = 0.0012f + 0.0019f * sigma * sigma;
  const bool not_occluded = r_z > -20.0f * sigma;
  const bool mask = (sel > 0.5f) && (validf > 0.5f) && not_occluded;
  maskf = mask ? 1.0f : 0.0f;
  r_i = r_i * maskf;
  r_z = r_z * maskf;
}

__device__ __forceinline__ float mahalanobis(float r_i, float r_z, float p00,
                                             float p01, float p11) {
  return r_i * (p00 * r_i + p01 * r_z) + r_z * (p01 * r_i + p11 * r_z);
}

// The 16 rows of U for one pixel (_pixel_math + _gram_rows); also hands the
// pixel's r_I, r_Z, weight and mask back to the caller (the rw rows).
__device__ __forceinline__ void gram_rows(const float* __restrict__ sampled,
                                          const float* __restrict__ refpack,
                                          int n, int p, const Params& P,
                                          float u[kRows], float& r_i,
                                          float& r_z, float& w, float& maskf) {
  residuals(sampled, refpack, n, p, r_i, r_z, maskf);

  const float d2 = mahalanobis(r_i, r_z, P.p00, P.p01, P.p11);
  const float w_t = (P.dof + 2.0f) / (P.dof + d2);
  w = P.first > 0.0f ? maskf : w_t * maskf;

  const float idx_r = refpack[2 * n + p];
  const float idy_r = refpack[3 * n + p];
  const float z_r = refpack[1 * n + p];
  const float x = refpack[4 * n + p];
  const float y = refpack[5 * n + p];
  const float idx_c = sampled[2 * n + p];
  const float idy_c = sampled[3 * n + p];
  const float zdx_c = sampled[4 * n + p];
  const float zdy_c = sampled[5 * n + p];

  const float g_ix = 0.5f * (idx_c + idx_r) * (P.fx / 255.0f);
  const float g_iy = 0.5f * (idy_c + idy_r) * (P.fy / 255.0f);
  const float g_zx = zdx_c * P.fx;
  const float g_zy = zdy_c * P.fy;

  const float z_safe = fabsf(z_r) > 1e-12f ? z_r : 1e-12f;
  const float iz = 1.0f / z_safe;
  const float iz2 = iz * iz;

  // rows of the 2x6 projection Jacobian Jw and the depth row Jz
  const float jw0[6] = {iz, 0.0f, -x * iz2, -x * y * iz2, 1.0f + x * x * iz2, -y * iz};
  const float jw1[6] = {0.0f, iz, -y * iz2, -(1.0f + y * y * iz2), x * y * iz2, x * iz};
  const float jz[6] = {0.0f, 0.0f, 1.0f, y, -x, 0.0f};

  const float sw = sqrtf(w);
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const float j_i = (g_ix * jw0[k] + g_iy * jw1[k]) * maskf;
    const float j_z = (g_zx * jw0[k] + g_zy * jw1[k] - jz[k]) * maskf;
    u[k] = sw * j_i;
    u[6 + k] = sw * j_z;
  }
  u[12] = sw * r_i;
  u[13] = sw * r_z;
  u[14] = maskf;
  u[15] = 0.0f;
}

// (a, b) of upper-triangle entry t, row-major over a <= b
__device__ __forceinline__ void pair_of(int t, int& a, int& b) {
  a = 0;
  int row_len = kRows;
  while (t >= row_len) {
    t -= row_len;
    ++a;
    --row_len;
  }
  b = a + t;
}

// Launch A: one block per kTile pixels -> its partial Gram [kPairs] (double).
// With kWriteRw (fused_partials) each thread also writes its pixel's
// (r_I, r_Z, w, mask) into rw [4, n]: neighbouring threads, neighbouring
// addresses, one coalesced store per row.  blockIdx.y is the stream of a
// batched launch (0 for one stream): inputs [B, 8, n], params [B, 8],
// partials [B, gridDim.x, kPairs], rw [B, 4, n].
template <bool kWriteRw>
__global__ void __launch_bounds__(kThreads)
gram_partials_kernel(const float* __restrict__ sampled,
                     const float* __restrict__ refpack,
                     const float* __restrict__ params, int n,
                     double* __restrict__ partials, float* __restrict__ rw) {
  __shared__ float us[kRows * kStride];
  const size_t stream = blockIdx.y;
  sampled += stream * 8 * (size_t)n;
  refpack += stream * 8 * (size_t)n;
  params += stream * 8;
  partials += stream * gridDim.x * kPairs;
  if constexpr (kWriteRw) rw += stream * 4 * (size_t)n;
  const Params P = load_params(params);
  const int tid = threadIdx.x;
  int a = 0, b = 0;
  if (tid < kPairs) pair_of(tid, a, b);
  double acc = 0.0;

  for (int s = 0; s < kSubTiles; ++s) {
    const int p = blockIdx.x * kTile + s * kSubTile + tid;
    float u[kRows];
    if (p < n) {
      float r_i, r_z, w, maskf;
      gram_rows(sampled, refpack, n, p, P, u, r_i, r_z, w, maskf);
      if constexpr (kWriteRw) {
        rw[0 * (size_t)n + p] = r_i;
        rw[1 * (size_t)n + p] = r_z;
        rw[2 * (size_t)n + p] = w;
        rw[3 * (size_t)n + p] = maskf;
      }
    } else {
#pragma unroll
      for (int r = 0; r < kRows; ++r) u[r] = 0.0f;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) us[r * kStride + tid] = u[r];
    __syncthreads();
    if (tid < kPairs) {
      const float* ra = us + a * kStride;
      const float* rb = us + b * kStride;
      for (int k = 0; k < kSubTile; ++k) acc += (double)ra[k] * (double)rb[k];
    }
    __syncthreads();
  }
  if (tid < kPairs) partials[(size_t)blockIdx.x * kPairs + tid] = acc;
}

// Launch B: one block per stream (blockIdx.x).  Fixed-order sum of the block
// partials into the full symmetric Gram [16, 16] (float32); with kPrecision
// (fused_stats) then the new precision (_precision_from_scale_sums) into
// prec[3].
template <bool kPrecision>
__global__ void gram_reduce_kernel(const double* __restrict__ partials,
                                   int num_blocks, float* __restrict__ gram,
                                   float* __restrict__ prec) {
  __shared__ float g[kPairs];
  const size_t stream = blockIdx.x;
  partials += stream * num_blocks * kPairs;
  gram += stream * kRows * kRows;
  if constexpr (kPrecision) prec += stream * 3;
  const int tid = threadIdx.x;
  if (tid < kPairs) {
    double s = 0.0;
    for (int blk = 0; blk < num_blocks; ++blk) s += partials[(size_t)blk * kPairs + tid];
    const float v = (float)s;
    int a, b;
    pair_of(tid, a, b);
    gram[a * kRows + b] = v;
    gram[b * kRows + a] = v;
    g[tid] = v;
  }
  __syncthreads();
  if (kPrecision && tid == 0) {
    // upper-triangle index of (a, b), a <= b
    auto at = [](int a, int b) { return a * kRows - a * (a - 1) / 2 + (b - a); };
    const float s00 = g[at(12, 12)];
    const float s01 = g[at(12, 13)];
    const float s11 = g[at(13, 13)];
    const float cnt = g[at(14, 14)];
    const float denom = fmaxf(cnt - 3.0f, 1.0f);
    const float pa = s00 / denom + sigma_floor_i();
    const float pb = s01 / denom;
    const float pc = s11 / denom + sigma_floor_z();
    const float det = fmaxf(pa * pc - pb * pb, 1e-30f);
    prec[0] = pc / det;
    prec[1] = -pb / det;
    prec[2] = pa / det;
  }
}

// Launch C: per block, recompute r_I, r_Z and the mask of its pixels and sum
// log1p(r^T P_new r / dof) over the valid ones (fixed-order tree).
// blockIdx.y is the stream, as in launch A.
__global__ void __launch_bounds__(kThreads)
loglik_partials_kernel(const float* __restrict__ sampled,
                       const float* __restrict__ refpack,
                       const float* __restrict__ params,
                       const float* __restrict__ prec, int n,
                       double* __restrict__ partials) {
  __shared__ double red[kThreads];
  const size_t stream = blockIdx.y;
  sampled += stream * 8 * (size_t)n;
  refpack += stream * 8 * (size_t)n;
  params += stream * 8;
  prec += stream * 3;
  partials += stream * gridDim.x;
  const int tid = threadIdx.x;
  const float dof = params[2];
  const float p00 = prec[0], p01 = prec[1], p11 = prec[2];
  double local = 0.0;
  for (int s = 0; s < kSubTiles; ++s) {
    const int p = blockIdx.x * kTile + s * kSubTile + tid;
    if (p < n) {
      float r_i, r_z, maskf;
      residuals(sampled, refpack, n, p, r_i, r_z, maskf);
      const float d2 = mahalanobis(r_i, r_z, p00, p01, p11);
      if (maskf > 0.5f) local += (double)log1pf(d2 / dof);
    }
  }
  red[tid] = local;
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half >>= 1) {
    if (tid < half) red[tid] += red[tid + half];
    __syncthreads();
  }
  if (tid == 0) partials[blockIdx.x] = red[0];
}

// Launch D: one thread per stream (blockIdx.x), fixed-order sum of the
// log-likelihood partials.
__global__ void loglik_reduce_kernel(const double* __restrict__ partials,
                                     int num_blocks, float* __restrict__ log_sum) {
  const size_t stream = blockIdx.x;
  partials += stream * num_blocks;
  log_sum += stream;
  double s = 0.0;
  for (int blk = 0; blk < num_blocks; ++blk) s += partials[blk];
  log_sum[0] = (float)s;
}

}  // namespace

extern "C" {

// Pixels per block of launches A and C: the wrapper sizes the partial
// buffers as ceil(n / tile) blocks.
int dvo_fused_stats_tile() { return kTile; }
int dvo_fused_stats_pairs() { return kPairs; }

// B streams at once.  sampled, refpack: [B, 8, n] float32, channel-major,
// contiguous.  params: [B, 8] float32, per stream (fx, fy, dof, first, P00,
// P01, P11, 0).  gram_partials: [B, ceil(n / tile), 136] float64 scratch.
// gram: [B, 16, 16] float32 out.  prec: [B, 3] float32 out (the new
// precisions).  ll_partials: [B, ceil(n / tile)] float64 scratch.  log_sum:
// [B] float32 out.  Returns cudaGetLastError() after the four launches on
// `stream`.
int dvo_fused_stats_batched(const float* sampled, const float* refpack,
                            const float* params, int n, int batch,
                            double* gram_partials, float* gram, float* prec,
                            double* ll_partials, float* log_sum, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (n + kTile - 1) / kTile;
  if (n <= 0 || batch <= 0 || batch > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(blocks, batch);
  gram_partials_kernel<false><<<grid, kThreads, 0, st>>>(
      sampled, refpack, params, n, gram_partials, nullptr);
  gram_reduce_kernel<true><<<batch, 160, 0, st>>>(gram_partials, blocks, gram, prec);
  loglik_partials_kernel<<<grid, kThreads, 0, st>>>(sampled, refpack, params,
                                                    prec, n, ll_partials);
  loglik_reduce_kernel<<<batch, 1, 0, st>>>(ll_partials, blocks, log_sum);
  return (int)cudaGetLastError();
}

// One stream: the batched entry point at B = 1, the same four launches.
// sampled, refpack: [8, n]; params: [8]; gram_partials: [ceil(n / tile), 136];
// gram: [16, 16]; prec: [3]; ll_partials: [ceil(n / tile)]; log_sum: [1].
int dvo_fused_stats(const float* sampled, const float* refpack,
                    const float* params, int n, double* gram_partials,
                    float* gram, float* prec, double* ll_partials,
                    float* log_sum, void* stream) {
  return dvo_fused_stats_batched(sampled, refpack, params, n, 1, gram_partials,
                                 gram, prec, ll_partials, log_sum, stream);
}

// Inputs and params as for dvo_fused_stats.
// gram_partials: [ceil(n / tile), 136] float64 scratch.
// gram: [16, 16] float32 out.  rw: [4, n] float32 out (r_I, r_Z, w, mask).
// Returns cudaGetLastError() after the two launches on `stream`.
int dvo_fused_partials(const float* sampled, const float* refpack,
                       const float* params, int n, double* gram_partials,
                       float* gram, float* rw, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (n + kTile - 1) / kTile;
  if (n <= 0) return (int)cudaErrorInvalidValue;
  gram_partials_kernel<true><<<blocks, kThreads, 0, st>>>(
      sampled, refpack, params, n, gram_partials, rw);
  gram_reduce_kernel<false><<<1, 160, 0, st>>>(gram_partials, blocks, gram, nullptr);
  return (int)cudaGetLastError();
}

}  // extern "C"
