// Fused IRLS statistics for one Gauss-Newton iteration of the dense tracker.
//
// Replaces two TPU kernels of dvo_slam_tpu/ops/pallas_kernels.py and the XLA
// code around the first one:
//  * fused_stats_pallas (kernel body _kernel2) together with the rest of the
//    reference's evaluate_fused (dvo_slam_tpu/models/dense_tracker.py:311-339):
//    entry point dvo_warp_fused_stats.  Per pixel: the warp of the reference
//    point by T, the projection, the depth-buffered (or plain) bilinear sample
//    of the current frame's quad table, the photometric and geometric
//    residuals, the Kinect-sigma occlusion gate, the t-distribution weight
//    from the previous precision (unit weights on the first iteration) and
//    the 12 Jacobian entries; over all pixels the 16x16 Gram matrix of
//      U = [sqrt(w) J_I (6); sqrt(w) J_Z (6); sqrt(w) r_I; sqrt(w) r_Z; mask; 0],
//    the new 2x2 precision from the Gram's scale terms,
//    sum log1p(r^T P_new r / dof) over the valid pixels, and the iteration's
//    tail: log det P_new, the log-likelihood, the normal equations A, b and
//    the constraint count.  B streams in one call (the lockstep multi-stream
//    tracker, where the reference vmaps the kernel): every launch takes a grid
//    (blocks per stream, B) and stream b's sums are those of a one-stream
//    call on its inputs, so its outputs are bit-equal to it.
//    Entry points dvo_fused_stats / dvo_fused_stats_batched are the same two
//    launches with the prologue "load the sampled pack" in place of "warp and
//    gather": the direct counterpart of fused_stats_pallas(sampled, ...).
//  * fused_partials_pallas (kernel body _kernel), entry point
//    dvo_fused_partials: the first launch with the "load the sampled pack"
//    prologue, storing the per-pixel rows rw [4, N] = (r_I, r_Z, w, mask) for
//    a caller that finishes the log-likelihood itself (the pixel-sharded
//    alignment, which needs the Gram summed over all shards first).
//
// What bounds it on the card: device-memory bandwidth.  The folded call must
// read channels 0-6 of the refpack and, at each pixel's sample, channels 0-6
// of the quad table's four neighbours (28 of its 32 rows) once: at most 140
// bytes per pixel, 10.8 MB for one stream at 640x480 level 1 (76,800
// pixels), 3.2 us at 3.35 TB/s, less where samples share a column
// (chip_smoke.py counts the distinct columns).  It also writes and reads back a 12-byte
// stash per pixel (0.9 MB per stream, which stays in the 50 MB L2).  The maths
// is elementwise plus a 16-wide Gram, far below the card's arithmetic rate.
// In the tracker loop, though, the host bounds it: the two launches stand
// in for ~90 small PyTorch ops of warp and sample and ~30 of tail, which is
// why the whole evaluation is folded and not the statistics alone.
//
// Design, re-thought for Hopper rather than carried over from the TPU grid:
//  * Two launches per call, whatever B, and nothing read from the host: T,
//    the previous precision and the outputs are device tensors, the scalars
//    (intrinsics, dof, the first-iteration flag) are launch arguments, so a
//    later CUDA graph can capture the call as it is.
//  * Launch 1, one block per 512 pixels: the per-pixel chain in registers
//    (sampled values never reach device memory), the 16 rows of U staged in
//    shared memory, the block's Gram on the FP64 tensor cores
//    (mma.sync.m8n8k4.f64: a product of two float32 entries is exact in
//    double, sums are double; six warps, one per distinct 8x8 tile of the
//    symmetric 16x16 and half of the block's pixels, each with two
//    accumulators), and (r_I, r_Z, mask) stashed per pixel for launch 2, as
//    the Pallas kernel keeps them in VMEM.  The blocks' partial Grams are
//    reduced by the last block to finish (an integer atomic ticket per
//    stream; no float atomics): it sums them in a fixed order (four chains
//    over the blocks) and computes the new precision.
//  * Launch 2: each block sums log1p(r^T P_new r / dof) over its valid pixels
//    from the stash; the last block sums the partials in a fixed order and
//    computes the tail (logdet with the 1e-38 floor, ll, A with its
//    0.5 (A + A^T), b, n) into one packed output buffer.
//  * Every reduction runs in a fixed order, so two runs are bit-identical.
//  * The per-pixel chain and the tail are float32, and the file is built with
//    -fmad=false, so every product and sum rounds as in the plain PyTorch
//    version (no contraction into fused multiply-adds): the stash is
//    bit-equal to the plain version's residuals and mask.
//  * The ticket buffer is allocated once per device and stream by the wrapper
//    (zeros); the last block of each launch resets its stream's ticket.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;                   // threads per block
constexpr int kTile = 512;                      // pixels per block
constexpr int kPerThread = kTile / kThreads;    // pixels per thread
constexpr int kRows = 16;                       // rows of U
constexpr int kPairs = kRows * (kRows + 1) / 2; // 136 upper-triangle entries
constexpr int kStride = kTile + 4;              // 516 = 4 (mod 32): the MMA loads hit 32 banks
constexpr int kMmaWarps = 6;                    // 3 tiles x 2 halves of the block's pixels

// Packed output of one stream, in float32 words.
constexpr int kOutGram = 0;      // [16, 16], symmetric
constexpr int kOutPrec = 256;    // [2, 2], the new precision
constexpr int kOutA = 260;       // [6, 6]
constexpr int kOutB = 296;       // [6]
constexpr int kOutLL = 302;      // log-likelihood
constexpr int kOutLogSum = 303;  // sum log1p(r^T P_new r / dof)
constexpr int kOutN = 304;       // int32: valid constraints
constexpr int kOutStride = 320;

enum Prologue { kSampled = 0, kWarp = 1, kWarpBuffered = 2 };

struct Args {
  const float* sampled;    // [B, 8, n]  (kSampled)
  const float* refpack;    // [B, 8, n]
  const float* quad;       // [B, 32, n] (kWarp, kWarpBuffered)
  const float* T;          // [B, 4, 4]  (kWarp, kWarpBuffered)
  const float* prev;       // warp: P_prev [B, 2, 2]; kSampled: precision3 [B, 3]
  const int* first_flags;  // kSampled: [B]
  int first;               // warp: the first-iteration flag of every stream
  int n, height, width;
  float fx, fy, ox, oy, gx, gy, dof, dof_plus_2, ll_scale, hi_u, hi_v;
  float* rows;             // stash [B, 3, n] or rw [B, 4, n]
  double* gram_partials;   // [B, blocks, 136]
  double* ll_partials;     // [B, blocks]
  unsigned* tickets;       // [B], zero between launches
  float* out;              // [B, kOutStride]
};

// variance floors of robust.precision_from_scale, rounded to float32 exactly
// as the PyTorch side rounds the Python constants
__device__ __forceinline__ float sigma_floor_i() { return (float)((0.05 / 255.0) * (0.05 / 255.0)); }
__device__ __forceinline__ float sigma_floor_z() { return (float)(1e-4 * 1e-4); }

// torch.clamp / clamp_min: NaN passes through
__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float max_nan(float v, float lo) { return v != v ? v : fmaxf(v, lo); }

__device__ __forceinline__ float mahalanobis(float r_i, float r_z, float p00,
                                             float p01, float p11) {
  return r_i * (p00 * r_i + p01 * r_z) + r_z * (p01 * r_i + p11 * r_z);
}

// The warp and the bilinear quad sample of one reference point (x, y, z):
// ops/residuals.warp_and_sample_cm and ops/interp.quad_index /
// combine_quad, op for op.  s = (i, z, idx, idy, zdx, zdy, valid, z_t).
template <bool kBuffered>
__device__ __forceinline__ void warp_sample(const Args& A, const float* __restrict__ quad,
                                            const float t[12], float x, float y, float z,
                                            float s[8]) {
  const int n = A.n;
  const float px = t[0] * x + t[1] * y + t[2] * z + t[3];
  const float py = t[4] * x + t[5] * y + t[6] * z + t[7];
  const float zt = t[8] * x + t[9] * y + t[10] * z + t[11];
  const float z_safe = zt > 1e-12f ? zt : 1e-12f;
  const float u_raw = px / z_safe * A.fx + A.ox;
  const float v_raw = py / z_safe * A.fy + A.oy;

  const bool in_bounds = (u_raw >= 0.0f) && (u_raw < (float)(A.width - 1)) &&
                         (v_raw >= 0.0f) && (v_raw < (float)(A.height - 1));
  const float u = clamp_nan(u_raw, 0.0f, A.hi_u);
  const float v = clamp_nan(v_raw, 0.0f, A.hi_v);
  const float x0 = floorf(u);
  const float y0 = floorf(v);
  const float x1w = u - x0;
  const float y1w = v - y0;
  const float x0w = 1.0f - x1w;
  const float y0w = 1.0f - y1w;
  long long idx = (long long)y0 * A.width + (long long)x0;
  idx = idx < 0 ? 0 : (idx > n - 1 ? n - 1 : idx);

  // neighbours: rows 0-7 the pixel, 8-15 right, 16-23 below, 24-31 below-right;
  // channels 0-6 (i, z, idx, idy, zdx, zdy, valid), channel 7 is never read
  float a[4][7];
  const float* q = quad + idx;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int c = 0; c < 7; ++c) a[k][c] = __ldg(q + (size_t)(8 * k + c) * n);
  }

  bool valid;
  if constexpr (kBuffered) {
    const float z_eps = zt - 0.05f;
    float kw[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) kw[k] = (a[k][6] > 0.5f && a[k][1] > z_eps) ? 1.0f : 0.0f;
    const float w00 = x0w * y0w * kw[0];
    const float w10 = x1w * y0w * kw[1];
    const float w01 = x0w * y1w * kw[2];
    const float w11 = x1w * y1w * kw[3];
    const float wsum = w00 + w10 + w01 + w11;
    const float denom = max_nan(wsum, 1e-6f);
#pragma unroll
    for (int c = 0; c < 6; ++c)
      s[c] = (a[0][c] * w00 + a[1][c] * w10 + a[2][c] * w01 + a[3][c] * w11) / denom;
    valid = in_bounds && (wsum > 1e-6f);
  } else {
#pragma unroll
    for (int c = 0; c < 6; ++c)
      s[c] = (a[0][c] * x0w + a[1][c] * x1w) * y0w + (a[2][c] * x0w + a[3][c] * x1w) * y1w;
    valid = in_bounds && a[0][6] > 0.5f && a[1][6] > 0.5f && a[2][6] > 0.5f && a[3][6] > 0.5f;
  }
  s[6] = (valid && zt > 1e-12f) ? 1.0f : 0.0f;
  s[7] = zt;
}

// The 16 rows of U for one pixel (fused_kernels._pixel_math + _gram_rows)
// from its sampled values s and refpack values r = (i, z, idx, idy, x, y,
// sel); also hands back its r_I, r_Z, weight and mask.
__device__ __forceinline__ void pixel_rows(const Args& A, const float s[8], const float r[7],
                                           float p00, float p01, float p11, bool first,
                                           float u[kRows], float& r_i, float& r_z, float& w,
                                           float& maskf) {
  const float i_r = r[0], z_r = r[1], idx_r = r[2], idy_r = r[3], x = r[4], y = r[5], sel = r[6];
  const float i_c = s[0], z_c = s[1], idx_c = s[2], idy_c = s[3], zdx_c = s[4], zdy_c = s[5];
  const float validf = s[6], z_t = s[7];

  r_i = (i_c - i_r) * (float)(1.0 / 255.0);
  r_z = z_c - z_t;
  float sigma = z_r - 0.4f;
  sigma = 0.0012f + 0.0019f * sigma * sigma;
  const bool not_occluded = r_z > -20.0f * sigma;
  const bool mask = (sel > 0.5f) && (validf > 0.5f) && not_occluded;
  maskf = mask ? 1.0f : 0.0f;
  r_i = r_i * maskf;
  r_z = r_z * maskf;

  const float d2 = mahalanobis(r_i, r_z, p00, p01, p11);
  const float w_t = A.dof_plus_2 / (A.dof + d2);
  w = first ? maskf : w_t * maskf;

  const float g_ix = 0.5f * (idx_c + idx_r) * A.gx;
  const float g_iy = 0.5f * (idy_c + idy_r) * A.gy;
  const float g_zx = zdx_c * A.fx;
  const float g_zy = zdy_c * A.fy;

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

// D (8x8, two doubles a lane) += A (8x4) B (4x8) on the FP64 tensor cores.
// Lane l holds A[l / 4][l % 4], B[l % 4][l / 4], D[l / 4][2 (l % 4) + i].
__device__ __forceinline__ void mma_f64(double& d0, double& d1, double a, double b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};\n"
               : "+d"(d0), "+d"(d1)
               : "d"(a), "d"(b));
}

// Called by every thread of a block after it wrote its partial: true in the
// last block of stream b to finish (which then resets the ticket).
__device__ __forceinline__ bool last_block(unsigned* tickets, int b) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(tickets + b, 1u) == gridDim.x - 1;
  __syncthreads();
  if (last) {
    __threadfence();
    if (threadIdx.x == 0) tickets[b] = 0;
  }
  return last;
}

// Launch 1: one block per kTile pixels of stream blockIdx.y.  kOutRows = 3
// stashes (r_I, r_Z, mask) and finishes with the new precision; 4 writes
// rw = (r_I, r_Z, w, mask) and stops at the Gram (fused_partials).
template <int kPrologue, int kOutRows>
__global__ void __launch_bounds__(kThreads) gram_kernel(const Args A) {
  __shared__ float us[kRows * kStride];
  __shared__ double tiles[2 * 3 * 64];
  __shared__ float g[kPairs];
  const int b = blockIdx.y;
  const int n = A.n;
  const int tid = threadIdx.x;
  const float* refpack = A.refpack + (size_t)b * 8 * n;
  float p00, p01, p11;
  bool first;
  float t[12];
  if constexpr (kPrologue == kSampled) {
    p00 = A.prev[b * 3 + 0];
    p01 = A.prev[b * 3 + 1];
    p11 = A.prev[b * 3 + 2];
    first = A.first_flags[b] > 0;
  } else {
    p00 = A.prev[b * 4 + 0];
    p01 = A.prev[b * 4 + 1];
    p11 = A.prev[b * 4 + 3];
    first = A.first != 0;
#pragma unroll
    for (int k = 0; k < 12; ++k) t[k] = A.T[b * 16 + k];
  }

#pragma unroll
  for (int s = 0; s < kPerThread; ++s) {
    const int col = s * kThreads + tid;
    const int p = blockIdx.x * kTile + col;
    float u[kRows];
    if (p < n) {
      float r[7];
#pragma unroll
      for (int c = 0; c < 7; ++c) r[c] = __ldg(refpack + (size_t)c * n + p);
      float sv[8];
      if constexpr (kPrologue == kSampled) {
        const float* sampled = A.sampled + (size_t)b * 8 * n;
#pragma unroll
        for (int c = 0; c < 8; ++c) sv[c] = __ldg(sampled + (size_t)c * n + p);
      } else {
        warp_sample<kPrologue == kWarpBuffered>(A, A.quad + (size_t)b * 32 * n, t, r[4], r[5],
                                                r[1], sv);
      }
      float r_i, r_z, w, maskf;
      pixel_rows(A, sv, r, p00, p01, p11, first, u, r_i, r_z, w, maskf);
      float* rows = A.rows + (size_t)b * kOutRows * n;
      rows[p] = r_i;
      rows[(size_t)n + p] = r_z;
      if constexpr (kOutRows == 3) {
        rows[2 * (size_t)n + p] = maskf;
      } else {
        rows[2 * (size_t)n + p] = w;
        rows[3 * (size_t)n + p] = maskf;
      }
    } else {
#pragma unroll
      for (int k = 0; k < kRows; ++k) u[k] = 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kRows; ++k) us[k * kStride + col] = u[k];
  }
  __syncthreads();

  // the block's Gram: warp w takes tile w % 3 ((0,0), (0,1), (1,1) of the
  // 8x8 tiles) over half w / 3 of the pixels, in two accumulator chains
  const int warp = tid >> 5;
  if (warp < kMmaWarps) {
    const int lane = tid & 31;
    const int tile = warp % 3;
    const int half = warp / 3;
    const int ti = tile == 2 ? 1 : 0;
    const int tj = tile == 0 ? 0 : 1;
    const float* ra = us + (8 * ti + (lane >> 2)) * kStride + (lane & 3) + half * (kTile / 2);
    const float* rb = us + (8 * tj + (lane >> 2)) * kStride + (lane & 3) + half * (kTile / 2);
    double c0 = 0.0, c1 = 0.0, e0 = 0.0, e1 = 0.0;
#pragma unroll 4
    for (int k = 0; k < kTile / 2; k += 8) {
      mma_f64(c0, c1, (double)ra[k], (double)rb[k]);
      mma_f64(e0, e1, (double)ra[k + 4], (double)rb[k + 4]);
    }
    double* dst = tiles + (half * 3 + tile) * 64 + (lane >> 2) * 8 + 2 * (lane & 3);
    dst[0] = c0 + e0;
    dst[1] = c1 + e1;
  }
  __syncthreads();

  double* partials = A.gram_partials + (size_t)b * gridDim.x * kPairs;
  int pa = 0, pb = 0;
  if (tid < kPairs) {
    pair_of(tid, pa, pb);
    const int e = ((pa >> 3) + (pb >> 3)) * 64 + (pa & 7) * 8 + (pb & 7);
    partials[(size_t)blockIdx.x * kPairs + tid] = tiles[e] + tiles[3 * 64 + e];
  }
  if (!last_block(A.tickets, b)) return;

  // the last block: fixed-order sum of the partials (four chains over the
  // blocks modulo 4, the remainder on the first, so that four loads are in
  // flight), the Gram, the precision
  float* out = A.out + (size_t)b * kOutStride;
  if (tid < kPairs) {
    double acc[4] = {0.0, 0.0, 0.0, 0.0};
    const int blocks = (int)gridDim.x;
    int blk = 0;
    for (; blk + 4 <= blocks; blk += 4) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[c] += __ldcg(partials + (size_t)(blk + c) * kPairs + tid);
    }
    for (; blk < blocks; ++blk) acc[0] += __ldcg(partials + (size_t)blk * kPairs + tid);
    const float v = (float)((acc[0] + acc[1]) + (acc[2] + acc[3]));
    out[kOutGram + pa * kRows + pb] = v;
    out[kOutGram + pb * kRows + pa] = v;
    g[tid] = v;
  }
  if constexpr (kOutRows == 3) {
    __syncthreads();
    if (tid == 0) {
      // upper-triangle index of (a, b), a <= b
      auto at = [](int a, int c) { return a * kRows - a * (a - 1) / 2 + (c - a); };
      const float s00 = g[at(12, 12)];
      const float s01 = g[at(12, 13)];
      const float s11 = g[at(13, 13)];
      const float cnt = g[at(14, 14)];
      const float denom = max_nan(cnt - 3.0f, 1.0f);
      const float qa = s00 / denom + sigma_floor_i();
      const float qb = s01 / denom;
      const float qc = s11 / denom + sigma_floor_z();
      const float det = max_nan(qa * qc - qb * qb, 1e-30f);
      const float off = -qb / det;
      out[kOutPrec + 0] = qc / det;
      out[kOutPrec + 1] = off;
      out[kOutPrec + 2] = off;
      out[kOutPrec + 3] = qa / det;
    }
  }
}

// Launch 2: per block, sum log1p(r^T P_new r / dof) over its valid stashed
// pixels; the last block of each stream sums the partials and writes the
// tail (log_sum, ll, A, b, n) next to launch 1's Gram and precision.
__global__ void __launch_bounds__(kThreads) loglik_kernel(const Args A) {
  __shared__ double red[kThreads];
  __shared__ float a_raw[36];
  const int b = blockIdx.y;
  const int n = A.n;
  const int tid = threadIdx.x;
  float* out = A.out + (size_t)b * kOutStride;
  const float p00 = out[kOutPrec + 0];
  const float p01 = out[kOutPrec + 1];
  const float p10 = out[kOutPrec + 2];
  const float p11 = out[kOutPrec + 3];
  const float* rows = A.rows + (size_t)b * 3 * n;
  double local = 0.0;
#pragma unroll
  for (int s = 0; s < kPerThread; ++s) {
    const int p = blockIdx.x * kTile + s * kThreads + tid;
    if (p < n) {
      const float r_i = rows[p];
      const float r_z = rows[(size_t)n + p];
      const float maskf = rows[2 * (size_t)n + p];
      const float d2 = mahalanobis(r_i, r_z, p00, p01, p11);
      if (maskf > 0.5f) local += (double)log1pf(d2 / A.dof);
    }
  }
  red[tid] = local;
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half >>= 1) {
    if (tid < half) red[tid] += red[tid + half];
    __syncthreads();
  }
  double* partials = A.ll_partials + (size_t)b * gridDim.x;
  if (tid == 0) partials[blockIdx.x] = red[0];
  if (!last_block(A.tickets, b)) return;

  double acc = 0.0;
  for (int blk = tid; blk < (int)gridDim.x; blk += kThreads) acc += __ldcg(partials + blk);
  red[tid] = acc;
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half >>= 1) {
    if (tid < half) red[tid] += red[tid + half];
    __syncthreads();
  }

  // the tail of the reference's evaluate_fused
  const float* gram = out + kOutGram;
  if (tid == 0) {
    const float log_sum = (float)red[0];
    const float nf = gram[14 * kRows + 14];
    const float logdet = logf(max_nan(p00 * p11 - p01 * p10, 1e-38f));
    out[kOutLogSum] = log_sum;
    out[kOutLL] = 0.5f * nf * logdet - A.ll_scale * log_sum;
    reinterpret_cast<int*>(out)[kOutN] = (int)nf;
  }
  if (tid < 36) {
    // A = p00 M00 + p01 (M01 + M01^T) + p11 M11 (assemble_normal_equations)
    const int i = tid / 6, j = tid % 6;
    const float m01_sym = gram[i * kRows + 6 + j] + gram[j * kRows + 6 + i];
    a_raw[tid] = p00 * gram[i * kRows + j] + p01 * m01_sym + p11 * gram[(6 + i) * kRows + 6 + j];
  } else if (tid < 42) {
    const int i = tid - 36;
    const float v0 = gram[i * kRows + 12], v1 = gram[i * kRows + 13];
    const float v2 = gram[(6 + i) * kRows + 12], v3 = gram[(6 + i) * kRows + 13];
    out[kOutB + i] = -(p00 * v0 + p01 * (v1 + v2) + p11 * v3);
  }
  __syncthreads();
  if (tid < 36) {
    const int i = tid / 6, j = tid % 6;
    out[kOutA + tid] = 0.5f * (a_raw[tid] + a_raw[j * 6 + i]);
  }
}

size_t align256(size_t bytes) { return (bytes + 255) & ~(size_t)255; }

// Scratch of one call: [rows region][Gram partials][log-likelihood partials].
struct Workspace {
  size_t gram_offset, ll_offset, bytes;
};

Workspace workspace_layout(int n, int batch, int rows) {
  const size_t blocks = (size_t)(n + kTile - 1) / kTile;
  Workspace w;
  w.gram_offset = align256((size_t)batch * rows * n * sizeof(float));
  w.ll_offset = w.gram_offset + align256((size_t)batch * blocks * kPairs * sizeof(double));
  w.bytes = w.ll_offset + align256((size_t)batch * blocks * sizeof(double));
  return w;
}

void set_workspace(Args& a, void* workspace, int n, int batch, int rows) {
  const Workspace w = workspace_layout(n, batch, rows);
  char* base = static_cast<char*>(workspace);
  if (rows) a.rows = reinterpret_cast<float*>(base);
  a.gram_partials = reinterpret_cast<double*>(base + w.gram_offset);
  a.ll_partials = reinterpret_cast<double*>(base + w.ll_offset);
}

bool bad_shape(int n, int batch) { return n <= 0 || batch <= 0 || batch > 65535; }

dim3 grid_of(int n, int batch) { return dim3((n + kTile - 1) / kTile, batch); }

}  // namespace

extern "C" {

// The packed output's layout, in float32 words:
// {stride, gram, precision, A, b, ll, log_sum, n}.
void dvo_fused_stats_layout(int* fields) {
  const int layout[8] = {kOutStride, kOutGram, kOutPrec, kOutA, kOutB, kOutLL, kOutLogSum, kOutN};
  for (int i = 0; i < 8; ++i) fields[i] = layout[i];
}

// Bytes of scratch a call needs: `rows` = 3 for the statistics entry points
// (the stash), 0 for dvo_fused_partials (whose rw rows are an output).
long long dvo_fused_stats_workspace_bytes(int n, int batch, int rows) {
  return (long long)workspace_layout(n, batch, rows).bytes;
}

// The folded call, B streams: refpack [B, 8, n], quad [B, 32, n] (the
// current frames' quad tables), T [B, 4, 4] and P_prev [B, 2, 2], float32,
// contiguous; n = height * width.  first: the first-iteration flag;
// depth_buffered: the 5 cm depth-buffer rule in the sample.  The scalars are
// the level's intrinsics and gx = fx / 255, gy = fy / 255, dof,
// dof_plus_2 = dof + 2, ll_scale = (dof + 2) / 2, each as the PyTorch side
// rounds it to float32.  workspace: dvo_fused_stats_workspace_bytes(n, B,
// 3) bytes; its first B * 3 * n floats are the stash (r_I, r_Z, mask)
// [B, 3, n] after the call.  tickets: [B] uint32, zero.  out: [B, 320]
// float32 (dvo_fused_stats_layout).  Two launches on `stream`; returns
// cudaGetLastError().
int dvo_warp_fused_stats(const float* refpack, const float* quad, const float* T,
                         const float* P_prev, int n, int height, int width, int batch,
                         int first, int depth_buffered, float fx, float fy, float ox, float oy,
                         float gx, float gy, float dof, float dof_plus_2, float ll_scale,
                         void* workspace, unsigned* tickets, float* out, void* stream) {
  if (bad_shape(n, batch) || (long long)height * width != n) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args a = {};
  a.refpack = refpack;
  a.quad = quad;
  a.T = T;
  a.prev = P_prev;
  a.first = first;
  a.n = n;
  a.height = height;
  a.width = width;
  a.fx = fx; a.fy = fy; a.ox = ox; a.oy = oy; a.gx = gx; a.gy = gy;
  a.dof = dof; a.dof_plus_2 = dof_plus_2; a.ll_scale = ll_scale;
  a.hi_u = (float)((double)width - 1.001);
  a.hi_v = (float)((double)height - 1.001);
  a.tickets = tickets;
  a.out = out;
  set_workspace(a, workspace, n, batch, 3);
  const dim3 grid = grid_of(n, batch);
  if (depth_buffered) {
    gram_kernel<kWarpBuffered, 3><<<grid, kThreads, 0, st>>>(a);
  } else {
    gram_kernel<kWarp, 3><<<grid, kThreads, 0, st>>>(a);
  }
  loglik_kernel<<<grid, kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// The statistics of B streams from their sampled packs: sampled, refpack
// [B, 8, n], precision3 [B, 3] (P00, P01, P11), first_flags [B] int32.  The
// scalars, workspace, tickets and out as for dvo_warp_fused_stats (out's
// tail is computed with the new precision as well).  Two launches.
int dvo_fused_stats_batched(const float* sampled, const float* refpack, const float* precision3,
                            const int* first_flags, int n, int batch, float fx, float fy,
                            float gx, float gy, float dof, float dof_plus_2, float ll_scale,
                            void* workspace, unsigned* tickets, float* out, void* stream) {
  if (bad_shape(n, batch)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args a = {};
  a.sampled = sampled;
  a.refpack = refpack;
  a.prev = precision3;
  a.first_flags = first_flags;
  a.n = n;
  a.fx = fx; a.fy = fy; a.gx = gx; a.gy = gy;
  a.dof = dof; a.dof_plus_2 = dof_plus_2; a.ll_scale = ll_scale;
  a.tickets = tickets;
  a.out = out;
  set_workspace(a, workspace, n, batch, 3);
  const dim3 grid = grid_of(n, batch);
  gram_kernel<kSampled, 3><<<grid, kThreads, 0, st>>>(a);
  loglik_kernel<<<grid, kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// One stream: the batched entry point at B = 1.
int dvo_fused_stats(const float* sampled, const float* refpack, const float* precision3,
                    const int* first_flags, int n, float fx, float fy, float gx, float gy,
                    float dof, float dof_plus_2, float ll_scale, void* workspace,
                    unsigned* tickets, float* out, void* stream) {
  return dvo_fused_stats_batched(sampled, refpack, precision3, first_flags, n, 1, fx, fy, gx, gy,
                                 dof, dof_plus_2, ll_scale, workspace, tickets, out, stream);
}

// One stream's Gram and per-pixel rows from its sampled pack: inputs as for
// dvo_fused_stats; workspace: dvo_fused_stats_workspace_bytes(n, 1, 0)
// bytes; out: [320] float32, of which the Gram [16, 16] is written; rw:
// [4, n] float32 out (r_I, r_Z, w, mask).  One launch.
int dvo_fused_partials(const float* sampled, const float* refpack, const float* precision3,
                       const int* first_flags, int n, float fx, float fy, float gx, float gy,
                       float dof, float dof_plus_2, void* workspace, unsigned* tickets,
                       float* out, float* rw, void* stream) {
  if (bad_shape(n, 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args a = {};
  a.sampled = sampled;
  a.refpack = refpack;
  a.prev = precision3;
  a.first_flags = first_flags;
  a.n = n;
  a.fx = fx; a.fy = fy; a.gx = gx; a.gy = gy;
  a.dof = dof; a.dof_plus_2 = dof_plus_2;
  a.tickets = tickets;
  a.out = out;
  a.rows = rw;
  set_workspace(a, workspace, n, 1, 0);
  gram_kernel<kSampled, 4><<<grid_of(n, 1), kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
