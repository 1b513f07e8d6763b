// Fused IRLS statistics for one Gauss-Newton iteration of the dense tracker,
// and the step kernels around it (the iteration's head and tail: below,
// after the statistics).
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
//  * fused_partials_pallas (kernel body _kernel) together with the rest of
//    the reference's pixel-sharded evaluate
//    (dvo_slam_tpu/parallel/sharded_alignment.py:98-139): three launches
//    around the two all-reduces that the sharded semantics need,
//      1. dvo_warp_fused_partials: one rank's refpack shard [8, n_local]
//         against the WHOLE quad table [32, n].  Per pixel the warp, the
//         depth-buffered sample (always: the sharded path does not read the
//         switch) and the residual/weight/Jacobian chain, in registers; the
//         stash (r_I, r_Z, gate); the shard's Gram, whose 136 sums the last
//         block writes in the layout of the all-reduce (m00, m01, m11, v,
//         scale_sum, n).  The caller all-reduces those 136 floats.
//      2. dvo_sharded_loglik: every block takes the new precision from the
//         reduced sums and sums log1p(r^T P_new r / dof) over its gated
//         stash entries; the last block writes the shard's sum and the
//         precision.  The caller all-reduces that one float.
//      3. dvo_sharded_tail (one block): ll with the sharded path's 1e-30
//         log-determinant floor, A, b and n into the packed output.
//    So an iteration of the sharded path is three launches, two collectives
//    and one host read-back (the solver's `done`), and nothing of the
//    evaluation is read from the host.
//    Entry point dvo_fused_partials is the first launch with the "load the
//    sampled pack" prologue, storing the per-pixel rows rw [4, N] = (r_I,
//    r_Z, w, mask): the direct counterpart of fused_partials_pallas(sampled,
//    ...), on no main path.
//
// What bounds it on the card: device-memory bandwidth.  The folded call must
// read channels 0-6 of the refpack and, at each pixel's sample, channels 0-6
// of the quad table's four neighbours (28 of its 32 rows) once: at most 140
// bytes per pixel, 10.8 MB for one stream at 640x480 level 1 (76,800
// pixels), 3.2 us at 3.35 TB/s, less where samples share a column
// (chip_smoke.py counts the distinct columns).  It also writes and reads back a 12-byte
// stash per pixel (0.9 MB per stream, which stays in the 50 MB L2).  The maths
// is elementwise plus a 16-wide Gram, far below the card's arithmetic rate.
// The folded partials move the same 28 + at most 112 bytes per pixel and
// write the 12-byte stash once: at most 152 bytes per pixel of the shard.
// In the tracker loop, though, the host bounds it: the two launches stand
// in for ~90 small PyTorch ops of warp and sample and ~30 of tail, which is
// why the whole evaluation is folded and not the statistics alone.
//
// Design, re-thought for Hopper rather than carried over from the TPU grid:
//  * Two launches per call of the tracker's evaluation (three for a rank of
//    the sharded one), whatever B, and nothing read from the host: T, the
//    previous precision and the outputs are device tensors, the scalars
//    (intrinsics, dof, the first-iteration flag) are launch arguments, so a
//    later CUDA graph can capture the call as it is.
//  * The tile (pixels per block) is a template parameter (Shape), fixed per
//    entry point when the file is compiled.  The sharded entry
//    (dvo_warp_fused_partials, dvo_sharded_loglik) takes 256 pixels on 256
//    threads, one pixel a thread, in clusters of 8 blocks (Sharded): a block
//    of 512 pixels left a 320x240 level at 150 blocks for 132 SMs, and a
//    rank's quarter of it at 38, each thread working through two pixels' 70
//    loads in turn.  With the smaller tile (29 KB of shared memory; three
//    blocks share an SM)
//        n = 76,800 (320x240)   300 blocks, 38 clusters
//        n = 38,400 (a half)    150 blocks, 19 clusters
//        n = 19,200 (a quarter)  75 blocks, 10 clusters
//        n =  4,800 (80x60)      19 blocks,  3 clusters; a quarter 5 / 1
//    The tracker's evaluation and the sampled-input entries keep 512 pixels
//    on 256 threads without clusters (Wide): on the card the smaller tile
//    was faster for one stream and slower for eight, and a stream of a
//    B-stream call must sum in the order of its one-stream call, so the
//    shape cannot go by B.  (A tile of 128 pixels on 128 threads was
//    measured as well: its rows are staged sooner, but its 600 blocks leave
//    twice the partials.  A choice by the pixel count was not kept either:
//    no path solves a level large enough to sit on its other side.)
//  * More blocks mean more partial Grams for the last block to sum alone,
//    and one SM reads them from the L2 cache at some 50 GB/s (1 KB a
//    partial).  A cluster of 8 blocks therefore gathers its 8 Grams through
//    distributed shared memory: each block stores its 136 sums into the
//    first block's shared memory, one cluster barrier, and the first block
//    adds them in rank order and writes one partial.  (Each block arrives at
//    the cluster's barrier when it starts and waits only when its sums are
//    ready, by when every block of the cluster runs and may be written to.)
//    (The other candidate, no clusters and the last block summing every
//    block's partial, lost: it summed 300 partials in 9 us where the
//    clusters' 38 take 2.)
//  * Launch 1, one block per tile: the per-pixel chain in registers
//    (sampled values never reach device memory), the 16 rows of U staged in
//    shared memory, the block's Gram on the FP64 tensor cores
//    (mma.sync.m8n8k4.f64: a product of two float32 entries is exact in
//    double, sums are double; one warp per distinct 8x8 tile of the
//    symmetric 16x16 and per half of the block's pixels, each with two
//    accumulators), and (r_I, r_Z, mask) stashed per pixel for launch 2, as
//    the Pallas kernel keeps them in VMEM.  A thread starts its 7 refpack
//    loads together, and then its 28 quad loads, before it uses any
//    (tools/kernel_report.py shows the runs of loads in the machine code).
//    The partial Grams are reduced by the last block (or cluster) to finish
//    (an integer atomic ticket per stream; no float atomics): three chunks of
//    68 threads each take every third partial, two entries (16 bytes) a load
//    on eight accumulators, a tree over the accumulators, then the chunks in
//    order; the precision follows.
//  * Launch 2: each block sums log1p(r^T P_new r / dof) over its valid pixels
//    from the stash; the last block sums the partials in a fixed order and
//    computes the tail (logdet with the 1e-38 floor, ll, A with its
//    0.5 (A + A^T), b, n) into one packed output buffer.  In the sharded
//    evaluation its blocks first take the precision from the all-reduced
//    sums, and the tail is launch 3, after the second all-reduce.
//  * Every reduction runs in a fixed order, so two runs are bit-identical.
//  * The per-pixel chain and the tail are float32, and the file is built with
//    -fmad=false, so every product and sum rounds as in the plain PyTorch
//    version (no contraction into fused multiply-adds): the stash is
//    bit-equal to the plain version's residuals and mask.
//  * The ticket buffer is allocated once per device and stream by the wrapper
//    (zeros); the last block of each launch resets its stream's ticket.
//  * Where launch 1 spends its time is read from a diagnostic build
//    (-DDVO_STAMPS), which only tools/partials_probe.py builds and loads.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kRows = 16;                       // rows of U
constexpr int kPairs = kRows * (kRows + 1) / 2; // 136 upper-triangle entries
constexpr int kPairPairs = kPairs / 2;          // 68: the last block's sum takes two entries a load
constexpr int kChains = 8;                      // accumulators per thread of the last block's sum
constexpr int kThreads = 256;                   // threads per block
constexpr int kSplit = 2;                       // halves of a tile's pixels, one MMA warp each
constexpr int kMmaWarps = 3 * kSplit;           // 3 distinct 8x8 tiles x 2 halves
constexpr int kChunks = kThreads / kPairPairs;  // 3 chunks of 68 threads in the last block's sum
constexpr int kMinBlocks = 3;                   // blocks an SM must hold: at most 85 registers
constexpr int kMinTile = 256;                   // the smallest tile: sizes the scratch
constexpr int kMaxCluster = 8;

// One shape of the launches: a block takes kTile pixels; kCluster blocks
// gather their Grams through distributed shared memory.
template <int kTile_, int kCluster_>
struct Shape {
  static constexpr int kTile = kTile_;
  static constexpr int kCluster = kCluster_;
  static constexpr int kPerThread = kTile / kThreads;    // pixels per thread
  static constexpr int kStride = kTile + 4;              // 4 (mod 32): the MMA loads hit 32 banks
  static_assert(kTile % kThreads == 0 && kTile % (16 * kSplit) == 0 && kStride % 32 == 4, "tile");
  static_assert(kTile >= kMinTile && kCluster <= kMaxCluster, "scratch");
};
using Wide = Shape<512, 1>;     // the tracker's evaluation and the sampled-input entries
using Sharded = Shape<256, 8>;  // the sharded evaluation: a rank's shard fills the card

// Packed output of one stream, in float32 words.
constexpr int kOutGram = 0;      // [16, 16], symmetric
constexpr int kOutPrec = 256;    // [2, 2], the new precision
constexpr int kOutA = 260;       // [6, 6]
constexpr int kOutB = 296;       // [6]
constexpr int kOutLL = 302;      // log-likelihood
constexpr int kOutLogSum = 303;  // sum log1p(r^T P_new r / dof)
constexpr int kOutN = 304;       // int32: valid constraints
constexpr int kOutStride = 320;
// The sharded entry points' buffer goes on: the 136 sums of the all-reduce
// (m00, m01, m11 [6, 6], v [4, 6], scale_sum [3], n) and the shard's log sum.
constexpr int kOutPacked = 320;
constexpr int kOutShardLog = kOutPacked + kPairs;  // 456
constexpr int kShardedStride = 464;
constexpr int kPackedScale = 132;                  // scale_sum within the 136 sums
constexpr int kPackedN = 135;

enum Prologue { kSampled = 0, kWarp = 1, kWarpBuffered = 2 };
// What launch 1 leaves: kStats the stash (r_I, r_Z, mask), the Gram and the
// new precision; kRows4 the rows rw = (r_I, r_Z, w, mask) and the Gram;
// kPacked the stash (r_I, r_Z, gate) and the 136 packed sums.
enum Epilogue { kStats = 0, kRows4 = 1, kPacked = 2 };

struct Args {
  const float* sampled;    // [B, 8, n]  (kSampled)
  const float* refpack;    // [B, 8, n]
  const float* quad;       // [B, 32, n] (kWarp, kWarpBuffered)
  const float* T;          // [B, 4, 4]  (kWarp, kWarpBuffered)
  const float* prev;       // warp: P_prev [B, 2, 2]; kSampled: precision3 [B, 3]
  const int* first_flags;  // kSampled: [B]
  int first;               // warp: the first-iteration flag of every stream
  int n, height, width;    // n: pixels of the refpack (a rank's shard in the sharded entry)
  int nq;                  // columns of the quad table (n but for a shard)
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
// The table has A.nq columns whatever the refpack's: a zero-padded column of
// a shard (x = y = z = 0) projects the warp's translation, its index is
// clamped into the table like any other, and its sel = 0 gives mask 0.
template <bool kBuffered>
__device__ __forceinline__ void warp_sample(const Args& A, const float* __restrict__ quad,
                                            const float t[12], float x, float y, float z,
                                            float s[8]) {
  const int n = A.nq;
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

// upper-triangle index of (a, b), a <= b
__device__ __forceinline__ int pair_at(int a, int b) { return a * kRows - a * (a - 1) / 2 + (b - a); }

// (row, column) of U's Gram that entry k of the 136 packed sums holds:
// m00 [6, 6], m01 [6, 6], m11 [6, 6], v [4, 6] (rows J_I r_I, J_I r_Z,
// J_Z r_I, J_Z r_Z), scale_sum [3], n
__device__ __forceinline__ void packed_entry(int k, int& a, int& b) {
  if (k < 36) {
    a = k / 6, b = k % 6;
  } else if (k < 72) {
    a = (k - 36) / 6, b = 6 + (k - 36) % 6;
  } else if (k < 108) {
    a = 6 + (k - 72) / 6, b = 6 + (k - 72) % 6;
  } else if (k < kPackedScale) {
    const int row = (k - 108) / 6;
    a = 6 * (row / 2) + (k - 108) % 6, b = 12 + row % 2;
  } else if (k < kPackedN) {
    a = k == kPackedN - 1 ? 13 : 12, b = k == kPackedScale ? 12 : 13;
  } else {
    a = b = 14;
  }
}

// D (8x8, two doubles a lane) += A (8x4) B (4x8) on the FP64 tensor cores.
// Lane l holds A[l / 4][l % 4], B[l % 4][l / 4], D[l / 4][2 (l % 4) + i].
__device__ __forceinline__ void mma_f64(double& d0, double& d1, double a, double b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};\n"
               : "+d"(d0), "+d"(d1)
               : "d"(a), "d"(b));
}

// The cluster's hardware barrier in its two halves (cluster.sync() is one
// after the other): every thread of every block of the cluster arrives, and
// none passes the wait before all have arrived; what a thread wrote before
// it arrived is visible to every thread that has waited.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// Called by every thread of a block after it wrote its partial: true in the
// last of stream b's `count` such blocks to finish (which then resets the
// ticket).  One thread fences for the block: the barrier before it orders
// the other threads' stores ahead of its fence and ticket, and the barrier
// after it orders its fence ahead of their loads in the last block.
__device__ __forceinline__ bool last_block(unsigned* tickets, int b, unsigned count) {
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(tickets + b, 1u) == count - 1;
    if (last) {
      __threadfence();
      tickets[b] = 0;
    }
  }
  __syncthreads();
  return last;
}

// The new precision from the summed scale terms and the count:
// robust.precision_from_scale(scale_sum / max(n - 3, 1)).  p = (P00, P01, P10, P11).
__device__ __forceinline__ void precision_from_sums(float s00, float s01, float s11, float cnt,
                                                    float p[4]) {
  const float denom = max_nan(cnt - 3.0f, 1.0f);
  const float qa = s00 / denom + sigma_floor_i();
  const float qb = s01 / denom;
  const float qc = s11 / denom + sigma_floor_z();
  const float det = max_nan(qa * qc - qb * qb, 1e-30f);
  const float off = -qb / det;
  p[0] = qc / det;
  p[1] = off;
  p[2] = off;
  p[3] = qa / det;
}

// The iteration's tail (the reference's evaluate_fused, and the tail of its
// sharded evaluate) from the Gram at out + kOutGram, the precision p and
// the log sum: log_sum, ll with the log-determinant floored at
// `logdet_floor`, A with its 0.5 (A + A^T), b and n into `out`.  Every
// thread of a block of at least 64 threads calls it; a_raw: 36 shared floats.
__device__ __forceinline__ void write_tail(float* out, const float p[4], float log_sum,
                                           float ll_scale, float logdet_floor, float* a_raw) {
  const int tid = threadIdx.x;
  const float p00 = p[0], p01 = p[1], p10 = p[2], p11 = p[3];
  const float* gram = out + kOutGram;
  if (tid == 0) {
    const float nf = gram[14 * kRows + 14];
    const float logdet = logf(max_nan(p00 * p11 - p01 * p10, logdet_floor));
    out[kOutLogSum] = log_sum;
    out[kOutLL] = 0.5f * nf * logdet - ll_scale * log_sum;
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

// A block's sum of one double per thread, in a fixed order; red: kThreads
// shared doubles.  The sum is in red[0] after the call.
__device__ __forceinline__ void block_sum(double* red, double value) {
  const int tid = threadIdx.x;
  red[tid] = value;
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half >>= 1) {
    if (tid < half) red[tid] += red[tid + half];
    __syncthreads();
  }
}

// A diagnostic build (-DDVO_STAMPS, tools/partials_probe.py) records where
// launch 1 spends its time: thread 0 of every block of stream 0 writes the
// device's nanosecond timer at six points (start, rows staged, Gram done,
// cluster summed, ticket taken, last block done).  The normal build has none
// of it.
#ifdef DVO_STAMPS
constexpr int kStamps = 8;
__device__ long long* stamp_buffer = nullptr;
__device__ __forceinline__ void stamp(int phase) {
  if (threadIdx.x == 0 && blockIdx.y == 0 && stamp_buffer != nullptr) {
    long long now;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
    stamp_buffer[(size_t)blockIdx.x * kStamps + phase] = now;
  }
}
#define DVO_STAMP(phase) stamp(phase)
#else
#define DVO_STAMP(phase)
#endif

// Launch 1: one block per S::kTile pixels of stream blockIdx.y (the blocks
// that round the grid up to whole clusters take no pixel).
template <class S, int kPrologue, int kEpilogue>
__global__ void __launch_bounds__(kThreads, kMinBlocks) gram_kernel(const Args A) {
  constexpr int kTile = S::kTile, kStride = S::kStride;
  constexpr int kStashRows = kEpilogue == kRows4 ? 4 : 3;
  __shared__ float us[kRows * kStride];
  __shared__ double tiles[kSplit * 3 * 64];
  // a cluster's sums, gathered in its first block; then the chunks' sums of
  // the last block
  __shared__ double2 gathered[(S::kCluster > kChunks ? S::kCluster : kChunks) * kPairPairs];
  __shared__ float g[kPairs];
  // "this block runs": its cluster's first block may be written to once all
  // have arrived (waited for only when the sums are ready)
  if constexpr (S::kCluster > 1) cluster_arrive();
  const int b = blockIdx.y;
  const int n = A.n;
  const int tid = threadIdx.x;
  const float* refpack = A.refpack + (size_t)b * 8 * n;
  float p00, p01, p11;
  bool first;
  float t[12];
  DVO_STAMP(0);
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
  for (int s = 0; s < S::kPerThread; ++s) {
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
        warp_sample<kPrologue == kWarpBuffered>(A, A.quad + (size_t)b * 32 * A.nq, t, r[4], r[5],
                                                r[1], sv);
      }
      float r_i, r_z, w, maskf;
      pixel_rows(A, sv, r, p00, p01, p11, first, u, r_i, r_z, w, maskf);
      float* rows = A.rows + (size_t)b * kStashRows * n;
      rows[p] = r_i;
      rows[(size_t)n + p] = r_z;
      if constexpr (kEpilogue == kStats) {
        rows[2 * (size_t)n + p] = maskf;
      } else if constexpr (kEpilogue == kPacked) {
        // the gate of the sharded log-likelihood is the plain version's and
        // the reference's, weights > 0, not the mask.  The two differ only
        // where r^T P_prev r of a valid pixel is infinite or NaN (a
        // non-finite intensity or precision): its weight is then 0 or NaN.
        rows[2 * (size_t)n + p] = w > 0.0f ? 1.0f : 0.0f;
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
  DVO_STAMP(1);

  // the block's Gram: warp w takes tile w % 3 ((0,0), (0,1), (1,1) of the
  // 8x8 tiles) over part w / 3 of the pixels, in two accumulator chains
  const int warp = tid >> 5;
  if (warp < kMmaWarps) {
    constexpr int kSpan = kTile / kSplit;
    const int lane = tid & 31;
    const int tile = warp % 3;
    const int part = warp / 3;
    const int ti = tile == 2 ? 1 : 0;
    const int tj = tile == 0 ? 0 : 1;
    const float* ra = us + (8 * ti + (lane >> 2)) * kStride + (lane & 3) + part * kSpan;
    const float* rb = us + (8 * tj + (lane >> 2)) * kStride + (lane & 3) + part * kSpan;
    double c0 = 0.0, c1 = 0.0, e0 = 0.0, e1 = 0.0;
#pragma unroll 4
    for (int k = 0; k < kSpan; k += 8) {
      mma_f64(c0, c1, (double)ra[k], (double)rb[k]);
      mma_f64(e0, e1, (double)ra[k + 4], (double)rb[k + 4]);
    }
    double* dst = tiles + (part * 3 + tile) * 64 + (lane >> 2) * 8 + 2 * (lane & 3);
    dst[0] = c0 + e0;
    dst[1] = c1 + e1;
  }
  __syncthreads();
  DVO_STAMP(2);

  // the block's 136 sums, two a thread; each block of a cluster stores its
  // own into the first block's shared memory, which adds them up in rank order
  unsigned count = gridDim.x;      // partials of this stream
  unsigned slot = blockIdx.x;      // this block's
  double2 mine = make_double2(0.0, 0.0);
  if (tid < kPairPairs) {
    double sum[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      int pa, pb;
      pair_of(2 * tid + i, pa, pb);
      const int at = ((pa >> 3) + (pb >> 3)) * 64 + (pa & 7) * 8 + (pb & 7);
      sum[i] = tiles[at];
#pragma unroll
      for (int part = 1; part < kSplit; ++part) sum[i] += tiles[part * 3 * 64 + at];
    }
    mine = make_double2(sum[0], sum[1]);
  }
  if constexpr (S::kCluster > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    const unsigned rank = cluster.block_rank();
    cluster_wait();  // every block of the cluster runs
    if (tid < kPairPairs) cluster.map_shared_rank(gathered, 0)[rank * kPairPairs + tid] = mine;
    cluster_arrive();
    cluster_wait();  // the first block holds every block's sums
    if (rank != 0) return;
    if (tid < kPairPairs) {
      double2 v[S::kCluster];
#pragma unroll
      for (int r = 0; r < S::kCluster; ++r) v[r] = gathered[r * kPairPairs + tid];
      mine = v[0];
#pragma unroll
      for (int r = 1; r < S::kCluster; ++r) {
        mine.x += v[r].x;
        mine.y += v[r].y;
      }
    }
    count = gridDim.x / S::kCluster;
    slot = blockIdx.x / S::kCluster;
  }
  DVO_STAMP(3);
  double2* partials = reinterpret_cast<double2*>(A.gram_partials) + (size_t)b * count * kPairPairs;
  if (tid < kPairPairs) partials[(size_t)slot * kPairPairs + tid] = mine;
  const bool last = last_block(A.tickets, b, count);
  DVO_STAMP(4);
  if (!last) return;

  // the last block: fixed-order sum of the partials.  Thread (chunk, pair of
  // entries) takes the partials chunk, chunk + kChunks, ..., kChains of them
  // in flight on as many accumulators, 16 bytes a load; then the chunks'
  // sums are added in order.
  {
    const int chunk = tid / kPairPairs;
    const int column = tid % kPairPairs;
    if (chunk < kChunks) {
      double2 acc[kChains];
#pragma unroll
      for (int c = 0; c < kChains; ++c) acc[c] = make_double2(0.0, 0.0);
      for (unsigned base = chunk; base < count; base += kChains * kChunks) {
#pragma unroll
        for (int c = 0; c < kChains; ++c) {
          const unsigned at = base + c * kChunks;
          if (at < count) {
            const double2 v = __ldcg(partials + (size_t)at * kPairPairs + column);
            acc[c].x += v.x;
            acc[c].y += v.y;
          }
        }
      }
      static_assert(kChains == 8, "the tree below");
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[c] = make_double2(acc[c].x + acc[c + 4].x, acc[c].y + acc[c + 4].y);
#pragma unroll
      for (int c = 0; c < 2; ++c) acc[c] = make_double2(acc[c].x + acc[c + 2].x, acc[c].y + acc[c + 2].y);
      gathered[chunk * kPairPairs + column] = make_double2(acc[0].x + acc[1].x, acc[0].y + acc[1].y);
    }
    __syncthreads();
    if (tid < kPairPairs) {
      double2 sum = gathered[tid];
#pragma unroll
      for (int c = 1; c < kChunks; ++c) {
        sum.x += gathered[c * kPairPairs + tid].x;
        sum.y += gathered[c * kPairPairs + tid].y;
      }
      g[2 * tid] = (float)sum.x;
      g[2 * tid + 1] = (float)sum.y;
    }
  }
  __syncthreads();
  float* out = A.out + (size_t)b * kOutStride;
  if constexpr (kEpilogue == kPacked) {
    // the sums in the layout of the all-reduce
    for (int k = tid; k < kPairs; k += kThreads) {
      int pa, pb;
      packed_entry(k, pa, pb);
      out[kOutPacked + k] = g[pa <= pb ? pair_at(pa, pb) : pair_at(pb, pa)];
    }
  } else {
    for (int e = tid; e < kPairs; e += kThreads) {
      int pa, pb;
      pair_of(e, pa, pb);
      out[kOutGram + pa * kRows + pb] = g[e];
      out[kOutGram + pb * kRows + pa] = g[e];
    }
    if constexpr (kEpilogue == kStats) {
      if (tid == 0) {
        float p[4];
        precision_from_sums(g[pair_at(12, 12)], g[pair_at(12, 13)], g[pair_at(13, 13)],
                            g[pair_at(14, 14)], p);
#pragma unroll
        for (int k = 0; k < 4; ++k) out[kOutPrec + k] = p[k];
      }
    }
  }
  DVO_STAMP(5);
}

// Launch 2: per block, sum log1p(r^T P_new r / dof) over its gated stashed
// pixels; the last block of each stream sums the partials.  kSharded: the
// precision comes from the all-reduced packed sums (every block computes
// it), and the last block writes the shard's log sum and the precision;
// else the precision is launch 1's and the last block writes the tail
// (log_sum, ll, A, b, n) next to launch 1's Gram.
template <class S, bool kSharded>
__global__ void __launch_bounds__(kThreads) loglik_kernel(const Args A) {
  constexpr int kTile = S::kTile;
  __shared__ double red[kThreads];
  __shared__ float a_raw[36];
  const int b = blockIdx.y;
  const int n = A.n;
  const int tid = threadIdx.x;
  float* out = A.out + (size_t)b * kOutStride;
  float prec[4];
  if constexpr (kSharded) {
    const float* sums = out + kOutPacked;
    precision_from_sums(sums[kPackedScale], sums[kPackedScale + 1], sums[kPackedScale + 2],
                        sums[kPackedN], prec);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) prec[k] = out[kOutPrec + k];
  }
  const float* rows = A.rows + (size_t)b * 3 * n;
  double local = 0.0;
#pragma unroll
  for (int s = 0; s < S::kPerThread; ++s) {
    const int p = blockIdx.x * kTile + s * kThreads + tid;
    if (p < n) {
      const float r_i = rows[p];
      const float r_z = rows[(size_t)n + p];
      const float gate = rows[2 * (size_t)n + p];
      const float d2 = mahalanobis(r_i, r_z, prec[0], prec[1], prec[3]);
      if (gate > 0.5f) local += (double)log1pf(d2 / A.dof);
    }
  }
  block_sum(red, local);
  double* partials = A.ll_partials + (size_t)b * gridDim.x;
  if (tid == 0) partials[blockIdx.x] = red[0];
  if (!last_block(A.tickets, b, gridDim.x)) return;

  double acc = 0.0;
  for (int blk = tid; blk < (int)gridDim.x; blk += kThreads) acc += __ldcg(partials + blk);
  __syncthreads();
  block_sum(red, acc);
  const float log_sum = (float)red[0];
  if constexpr (kSharded) {
    if (tid == 0) out[kOutShardLog] = log_sum;
    if (tid < 4) out[kOutPrec + tid] = prec[tid];
  } else {
    write_tail(out, prec, log_sum, A.ll_scale, 1e-38f, a_raw);
  }
}

// Launch 3 of the sharded evaluation, one block: the all-reduced sums spread
// into the Gram's layout, then the tail with the sharded path's 1e-30 floor.
__global__ void __launch_bounds__(256) sharded_tail_kernel(float* out, float ll_scale) {
  __shared__ float a_raw[36];
  const int tid = threadIdx.x;
  out[kOutGram + tid] = 0.0f;
  __syncthreads();
  if (tid < kPairs) {
    int pa, pb;
    packed_entry(tid, pa, pb);
    out[kOutGram + pa * kRows + pb] = out[kOutPacked + tid];
  }
  __syncthreads();
  float prec[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) prec[k] = out[kOutPrec + k];
  write_tail(out, prec, out[kOutShardLog], ll_scale, 1e-30f, a_raw);
}

size_t align256(size_t bytes) { return (bytes + 255) & ~(size_t)255; }

// Scratch of one call: [rows region][Gram partials][log-likelihood partials],
// sized for the smallest tile, whose grid has the most blocks.
struct Workspace {
  size_t gram_offset, ll_offset, bytes;
};

Workspace workspace_layout(int n, int batch, int rows) {
  size_t blocks = (size_t)(n + kMinTile - 1) / kMinTile;
  blocks = (blocks + kMaxCluster - 1) / kMaxCluster * kMaxCluster;
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

template <class S>
dim3 grid_of(int n, int batch) {
  const int blocks = (n + S::kTile - 1) / S::kTile;
  return dim3((blocks + S::kCluster - 1) / S::kCluster * S::kCluster, batch);
}

// Launch 1 in the shape S.
template <class S, int kPrologue, int kEpilogue>
cudaError_t launch_gram(const Args& a, int batch, cudaStream_t st) {
  const dim3 grid = grid_of<S>(a.n, batch);
  if constexpr (S::kCluster == 1) {
    gram_kernel<S, kPrologue, kEpilogue><<<grid, kThreads, 0, st>>>(a);
    return cudaGetLastError();
  } else {
    cudaLaunchConfig_t config = {};
    config.gridDim = grid;
    config.blockDim = dim3(kThreads);
    config.stream = st;
    cudaLaunchAttribute cluster;
    cluster.id = cudaLaunchAttributeClusterDimension;
    cluster.val.clusterDim.x = S::kCluster;
    cluster.val.clusterDim.y = 1;
    cluster.val.clusterDim.z = 1;
    config.attrs = &cluster;
    config.numAttrs = 1;
    return cudaLaunchKernelEx(&config, gram_kernel<S, kPrologue, kEpilogue>, a);
  }
}

// Launch 2, on the tile of S (clusters play no part in it).
template <class S, bool kSharded>
cudaError_t launch_loglik(const Args& a, int batch, cudaStream_t st) {
  using Tile = Shape<S::kTile, 1>;
  loglik_kernel<Tile, kSharded><<<grid_of<Tile>(a.n, batch), kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

// The launch arguments every entry point shares.
Args common_args(int n, float fx, float fy, float gx, float gy, float dof, float dof_plus_2,
                 float ll_scale, unsigned* tickets, float* out) {
  Args a = {};
  a.n = n;
  a.nq = n;
  a.fx = fx; a.fy = fy; a.gx = gx; a.gy = gy;
  a.dof = dof; a.dof_plus_2 = dof_plus_2; a.ll_scale = ll_scale;
  a.tickets = tickets;
  a.out = out;
  return a;
}

// The level's geometry, for the warp prologues.
void set_level(Args& a, int height, int width, float ox, float oy) {
  a.height = height;
  a.width = width;
  a.ox = ox; a.oy = oy;
  a.hi_u = (float)((double)width - 1.001);
  a.hi_v = (float)((double)height - 1.001);
}

// ---------------------------------------------------------------------------
// The IRLS step around the evaluation (models/dense_tracker._step): the
// step kernels.  They replace no Pallas kernel: the reference leaves this
// glue to XLA, which fuses it into its while body; captured op by op into
// the card's WHILE bodies it was some 258 kernels and 31 copies a step,
// each node a few microseconds that waits on the last.  Now a step is the
// head, kernel 1's two launches and the tail: four kernel nodes.
//  * step_head_kernel: inc = exp_se3(x), T_new = inc T, initial_new =
//    inverse(inc) initial, where kernel 1 reads T.
//  * step_tail_kernel: from the evaluation (n, precision, ll, A, b) and the
//    carry, the prior (A + mu I, b + mu log_se3(initial_new)) with
//    smoothing, the Jacobi-equilibrated Cholesky solve, the termination
//    tests and code, the accept/revert of the nine carried fields,
//    iteration + 1 and done, written straight into the carry's buffers
//    (which may be the carry read: a stream's values are all read before
//    any is written), and the iteration's trace row where one is kept; a
//    level's first step makes its initial carry from the start values.
// What bounds them: latency.  A stream's work is a few hundred dependent
// float32 operations (about 50 of them divisions and square roots) on some
// 200 words, so one warp per stream runs it in its first lane; the others
// exit.  Stream b's arithmetic does not depend on B.
// Arithmetic: every elementwise op rounds as PyTorch's on the card (no
// contraction: -fmad=false; a division by a Python number is a product
// with its reciprocal taken in double and rounded, PyTorch's rule), and
// torch.sum of three terms adds (q0 + q2) + q1 as PyTorch's reduction does.
// Each matrix product, matrix-vector product and dot product (exp/log's
// 3x3, the 4x4 compositions, the Cholesky sums) takes one fixed order: the
// first product rounded, then one fused multiply-add a term, in index
// order.  That is cuBLAS's order for the batched 3x3 and 4x4 products; its
// 2-D products and its matrix-vector and dot kernels take others, which
// differ with B (PERF.md states the gap to the plain step).

constexpr float kSmallAngleSq = (float)1e-2;  // ops/se3._SMALL_ANGLE_SQ
constexpr float kInv6 = (float)(1.0 / 6.0);
constexpr float kInv24 = (float)(1.0 / 24.0);
constexpr float kInv120 = (float)(1.0 / 120.0);
constexpr float kInv720 = (float)(1.0 / 720.0);
constexpr float kTwelfth = (float)(1.0 / 12.0);
constexpr float kPivotFloor = (float)1e-20;  // ops/least_squares._PIVOT_FLOOR

// torch.sum over three terms on the card
__device__ __forceinline__ float sum3(float q0, float q1, float q2) { return (q0 + q2) + q1; }

// sum_k a[k * sa] b[k * sb], k < n (n >= 1, known where it is inlined): the
// first product rounded, then fused multiply-adds in index order
__device__ __forceinline__ float dot(const float* a, int sa, const float* b, int sb, int n) {
  float acc = a[0] * b[0];
#pragma unroll
  for (int k = 1; k < n; ++k) acc = __fmaf_rn(a[k * sa], b[k * sb], acc);
  return acc;
}

// C = A B, row-major N x N
template <int N>
__device__ __forceinline__ void matmul(const float* A, const float* B, float* C) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) C[i * N + j] = dot(A + i * N, 1, B + j, N, N);
  }
}

// hat_so3(w), row-major 3 x 3
__device__ __forceinline__ void hat(const float w[3], float W[9]) {
  W[0] = 0.0f; W[1] = -w[2]; W[2] = w[1];
  W[3] = w[2]; W[4] = 0.0f; W[5] = -w[0];
  W[6] = -w[1]; W[7] = w[0]; W[8] = 0.0f;
}

// ops/se3._exp_coefficients: (a, b, c) of R = I + a W + b W^2, V = I + b W + c W^2
__device__ __forceinline__ void exp_coefficients(float theta_sq, float& a, float& b, float& c) {
  const float safe = max_nan(theta_sq, kSmallAngleSq);
  const float theta = sqrtf(safe);
  const bool small = theta_sq < kSmallAngleSq;
  a = small ? (1.0f - theta_sq * kInv6) + (theta_sq * theta_sq) * kInv120 : sinf(theta) / theta;
  const float sin_half = sinf(0.5f * sqrtf(theta_sq));
  b = theta_sq < (float)1e-12 ? 0.5f - theta_sq * kInv24
                              : (2.0f * sin_half) * sin_half / max_nan(theta_sq, (float)1e-12);
  c = small ? kInv6 - theta_sq * kInv120 : (1.0f - a) / safe;
}

// ops/se3.exp_se3: twist (v, w) -> T, row-major 4 x 4
__device__ __forceinline__ void exp_se3(const float xi[6], float T[16]) {
  const float* w = xi + 3;
  const float theta_sq = sum3(w[0] * w[0], w[1] * w[1], w[2] * w[2]);
  float a, b, c;
  exp_coefficients(theta_sq, a, b, c);
  float W[9], W2[9], R[9], V[9];
  hat(w, W);
  matmul<3>(W, W, W2);
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const float e = k % 4 == 0 ? 1.0f : 0.0f;
    R[k] = (e + a * W[k]) + b * W2[k];
    V[k] = (e + b * W[k]) + c * W2[k];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) T[i * 4 + j] = R[i * 3 + j];
    T[i * 4 + 3] = dot(V + i * 3, 1, xi, 1, 3);
  }
  T[12] = 0.0f; T[13] = 0.0f; T[14] = 0.0f; T[15] = 1.0f;
}

// ops/se3.inverse of a rigid transform: (R^T, -(R^T t))
__device__ __forceinline__ void inverse_se3(const float T[16], float out[16]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) out[i * 4 + j] = T[j * 4 + i];
    out[i * 4 + 3] = -dot(T + i, 4, T + 3, 4, 3);
  }
  out[12] = 0.0f; out[13] = 0.0f; out[14] = 0.0f; out[15] = 1.0f;
}

// ops/se3.log_se3: T -> twist (v, w)
__device__ __forceinline__ void log_se3(const float T[16], float xi[6]) {
  // log_so3
  float w_raw[3];
  w_raw[0] = 0.5f * (T[9] - T[6]);
  w_raw[1] = 0.5f * (T[2] - T[8]);
  w_raw[2] = 0.5f * (T[4] - T[1]);
  const float sin_theta = sqrtf(sum3(w_raw[0] * w_raw[0], w_raw[1] * w_raw[1], w_raw[2] * w_raw[2]));
  const float cos_theta = 0.5f * (((T[0] + T[5]) + T[10]) - 1.0f);
  const float theta = atan2f(sin_theta, cos_theta);
  const float theta_sq0 = theta * theta;
  const float factor = theta_sq0 < kSmallAngleSq ? theta_sq0 * kInv6 + 1.0f
                                                 : theta / max_nan(sin_theta, (float)1e-12);
  float* w = xi + 3;
#pragma unroll
  for (int k = 0; k < 3; ++k) w[k] = factor * w_raw[k];
  // V^-1 = I - W / 2 + d W^2
  const float theta_sq = sum3(w[0] * w[0], w[1] * w[1], w[2] * w[2]);
  float a, b, c;
  exp_coefficients(theta_sq, a, b, c);
  const float safe = max_nan(theta_sq, kSmallAngleSq);
  const float d = theta_sq < kSmallAngleSq ? theta_sq * kInv720 + kTwelfth
                                           : (1.0f - a / (2.0f * b)) / safe;
  float W[9], W2[9], V_inv[9];
  hat(w, W);
  matmul<3>(W, W, W2);
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const float e = k % 4 == 0 ? 1.0f : 0.0f;
    V_inv[k] = (e - 0.5f * W[k]) + d * W2[k];
  }
  const float t[3] = {T[3], T[7], T[11]};
#pragma unroll
  for (int i = 0; i < 3; ++i) xi[i] = dot(V_inv + i * 3, 1, t, 1, 3);
}

// ops/least_squares.solve_ldlt: Jacobi equilibration, then the unrolled
// Cholesky solve with pivots floored at 1e-20 and the empty products left out
__device__ __forceinline__ void solve_ldlt(const float A[36], const float b[6], float x[6]) {
  float d_inv[6], As[36], L[36], y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) d_inv[i] = 1.0f / sqrtf(max_nan(A[i * 7], kPivotFloor));
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j < 6; ++j) As[i * 6 + j] = A[i * 6 + j] * d_inv[i] * d_inv[j];
  }
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float pivot = 0.0f;
#pragma unroll
    for (int k = j; k < 6; ++k) {
      float s = As[k * 6 + j];
      if (j) s = s - dot(L + k * 6, 1, L + j * 6, 1, j);
      if (k == j) {
        pivot = sqrtf(max_nan(s, kPivotFloor));
        L[j * 7] = pivot;
      } else {
        L[k * 6 + j] = s / pivot;
      }
    }
  }
  // L y = b D^-1/2, then L^T x' = y, x = x' D^-1/2
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float r = b[i] * d_inv[i];
    if (i) r = r - dot(L + i * 6, 1, y, 1, i);
    y[i] = r / L[i * 7];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float r = y[i];
    if (i < 5) r = r - dot(L + (i + 1) * 6 + i, 6, x + i + 1, 1, 5 - i);
    x[i] = r / L[i * 7];
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) x[i] = x[i] * d_inv[i];
}

// The carry's fields in models/dense_tracker._Carry's order, each [B, width]
// contiguous: float32 but for n, iteration, termination (int32) and done
// (bool); the evaluation's five fields; the trace's five buffers
// [iterations, B, width].
enum CarryField { kX, kT, kInitial, kIncApplied, kPrecision, kError, kA, kLL, kN, kIteration,
                  kTermination, kDone, kCarryFields };
// the words of field f of one stream
__device__ __forceinline__ int carry_width(int f) {
  switch (f) {
    case kX: return 6;
    case kT: case kInitial: case kIncApplied: return 16;
    case kPrecision: return 4;
    case kA: return 36;
    default: return 1;
  }
}
enum EvalField { kEvN, kEvPrec, kEvLL, kEvA, kEvB, kEvalFields };
constexpr int kTraceFields = 5;  // valid constraints, log-likelihood, precision, increment, information
// termination codes (dense_tracker.TERM_*)
enum Termination { kNone = 0, kIterationsExceeded = 1, kIncrementTooSmall = 2,
                   kLogLikelihoodDecreased = 3, kTooFewConstraints = 4 };

struct StepTailArgs {
  const void* eval[kEvalFields];     // the evaluation's fields, stream b at eval_stride * b
  long long eval_stride[kEvalFields];
  const float* inc;                  // [B, 16] the head's outputs
  const float* T_new;
  const float* initial_new;
  const void* in[kCarryFields];      // the carry read
  void* out[kCarryFields];           // the carry written (may be `in`)
  float* trace[kTraceFields];        // null: no trace
  // start: the level's first step, whose carry read is the level's initial
  // carry: its start values x, T, initial and precision in `in`, inc_applied
  // the head's inc, error +inf, A the identity, ll -inf, n, iteration and
  // termination 0, done false (the other fields of `in` are not read)
  int max_iterations, freeze, smoothing, start;
  float mu, precision;
};

// Head, one warp per stream: inc = exp_se3(x), T_new = inc T, initial_new =
// inverse(inc) initial ([B, 6] / [B, 16] in, [B, 16] out).
__global__ void __launch_bounds__(32) step_head_kernel(const float* __restrict__ x,
                                                       const float* __restrict__ T,
                                                       const float* __restrict__ initial,
                                                       float* inc, float* T_new,
                                                       float* initial_new) {
  if (threadIdx.x) return;
  const size_t b = blockIdx.x;
  float xi[6], e[16], e_inv[16], m[16], p[16];
#pragma unroll
  for (int k = 0; k < 6; ++k) xi[k] = x[b * 6 + k];
  exp_se3(xi, e);
  inverse_se3(e, e_inv);
#pragma unroll
  for (int k = 0; k < 16; ++k) m[k] = T[b * 16 + k];
  matmul<4>(e, m, p);
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    inc[b * 16 + k] = e[k];
    T_new[b * 16 + k] = p[k];
    m[k] = initial[b * 16 + k];
  }
  matmul<4>(e_inv, m, p);
#pragma unroll
  for (int k = 0; k < 16; ++k) initial_new[b * 16 + k] = p[k];
}

// Copy field f of stream b from the carry read to the carry written, where
// they differ.
__device__ __forceinline__ void keep_field(const StepTailArgs& S, int f, size_t b) {
  if (S.in[f] == S.out[f]) return;
  const int width = carry_width(f);
  if (f == kDone) {
    static_cast<bool*>(S.out[f])[b] = static_cast<const bool*>(S.in[f])[b];
  } else {  // four-byte words
    const unsigned* src = static_cast<const unsigned*>(S.in[f]) + b * width;
    unsigned* dst = static_cast<unsigned*>(S.out[f]) + b * width;
    for (int k = 0; k < width; ++k) dst[k] = src[k];
  }
}

// Keep the carry read in fields [0, last) of stream b: leave them where the
// carry written is the carry read, else copy them (the initial carry's
// values where S.start).
__device__ __forceinline__ void keep_fields(const StepTailArgs& S, int last, size_t b) {
  for (int f = 0; f < last; ++f) {
    if (!S.start || f < kError) {
      keep_field(S, f, b);
    } else if (f == kN) {
      static_cast<int*>(S.out[f])[b] = 0;
    } else {  // error, A, ll
      float* dst = static_cast<float*>(S.out[f]) + b * carry_width(f);
      const float inf = __int_as_float(0x7f800000);
      for (int k = 0; k < carry_width(f); ++k)
        dst[k] = f == kError ? inf : f == kLL ? -inf : (k % 7 == 0 ? 1.0f : 0.0f);
    }
  }
}

template <int W>
__device__ __forceinline__ void store(float* dst, const float* v) {
#pragma unroll
  for (int k = 0; k < W; ++k) dst[k] = v[k];
}

template <int W>
__device__ __forceinline__ void load(float* v, const float* src) {
#pragma unroll
  for (int k = 0; k < W; ++k) v[k] = src[k];
}

__device__ __forceinline__ float* out_field(const StepTailArgs& S, int f, size_t b) {
  return static_cast<float*>(S.out[f]) + b * carry_width(f);
}

// Tail, one warp per stream (see above).
__global__ void __launch_bounds__(32) step_tail_kernel(const StepTailArgs S) {
  if (threadIdx.x) return;
  const size_t b = blockIdx.x;
  if (!S.start && S.freeze && static_cast<const bool*>(S.in[kDone])[b]) {
    keep_fields(S, kCarryFields, b);  // a finished stream's carry stays as it was
    return;
  }
  const float error_old = S.start ? __int_as_float(0x7f800000)
                                  : static_cast<const float*>(S.in[kError])[b];
  const int iteration = S.start ? 0 : static_cast<const int*>(S.in[kIteration])[b];

  // the evaluation
  const int n = static_cast<const int*>(S.eval[kEvN])[b * S.eval_stride[kEvN]];
  const float ll = static_cast<const float*>(S.eval[kEvLL])[b * S.eval_stride[kEvLL]];
  float prec[4], A[36], rhs[6];
  load<4>(prec, static_cast<const float*>(S.eval[kEvPrec]) + b * S.eval_stride[kEvPrec]);
  load<36>(A, static_cast<const float*>(S.eval[kEvA]) + b * S.eval_stride[kEvA]);
  load<6>(rhs, static_cast<const float*>(S.eval[kEvB]) + b * S.eval_stride[kEvB]);

  const bool too_few = n < 6;
  const float error = -ll;
  const bool accept = error < error_old;
  const bool reject = too_few || !accept;

  if (S.smoothing) {  // the prior toward the initial guess
    float prior[16], log_prior[6];
    load<16>(prior, S.initial_new + b * 16);
    log_se3(prior, log_prior);
#pragma unroll
    for (int k = 0; k < 36; ++k) A[k] = A[k] + (k % 7 == 0 ? 1.0f : 0.0f) * S.mu;
#pragma unroll
    for (int k = 0; k < 6; ++k) rhs[k] = rhs[k] + log_prior[k] * S.mu;
  }
  float x_new[6];
  solve_ldlt(A, rhs, x_new);

  // torch.amax(|x|) <= precision, NaN-propagating: false where any is NaN
  bool converged = true;
#pragma unroll
  for (int k = 0; k < 6; ++k) converged = converged && fabsf(x_new[k]) <= S.precision;
  const bool exceeded = iteration + 1 >= S.max_iterations;
  const int termination = too_few   ? kTooFewConstraints
                          : !accept ? kLogLikelihoodDecreased
                          : converged ? kIncrementTooSmall
                          : exceeded  ? kIterationsExceeded
                                      : kNone;

  // the trace row of the iteration as executed, at its iteration
  if (S.trace[0] != nullptr && iteration >= 0 && iteration < S.max_iterations) {
    const size_t row = (size_t)iteration * gridDim.x + b;
    S.trace[0][row] = (float)n;
    S.trace[1][row] = ll;
    store<4>(S.trace[2] + row * 4, prec);
    store<6>(S.trace[3] + row * 6, x_new);
    store<36>(S.trace[4] + row * 36, A);
  }

  static_cast<int*>(S.out[kIteration])[b] = iteration + 1;
  static_cast<int*>(S.out[kTermination])[b] = termination;
  static_cast<bool*>(S.out[kDone])[b] = reject || converged || exceeded;
  if (reject) {  // keep the previous estimate and the previous accepted statistics
    keep_fields(S, kIteration, b);
    return;
  }
  store<6>(out_field(S, kX, b), x_new);
  float m[16];
  load<16>(m, S.T_new + b * 16);
  store<16>(out_field(S, kT, b), m);
  load<16>(m, S.initial_new + b * 16);
  store<16>(out_field(S, kInitial, b), m);
  load<16>(m, S.inc + b * 16);
  store<16>(out_field(S, kIncApplied, b), m);
  store<4>(out_field(S, kPrecision, b), prec);
  *out_field(S, kError, b) = error;
  store<36>(out_field(S, kA, b), A);
  *out_field(S, kLL, b) = ll;
  static_cast<int*>(S.out[kN])[b] = n;
}

// ---------------------------------------------------------------------------
// A match's glue (models/dense_tracker's match_start, next_start,
// level_stats, match_result and flatten_result): the glue kernels.  They
// replace no Pallas kernel: the reference leaves this glue to XLA around its
// levels' while loops; captured op by op into the card's match graph it was
// some 356 dependent nodes a match (the setup, a link between two levels, the
// result row), each about a microsecond of card time that waits on the last.
// Now each part is one kernel node that writes the graph's static buffers in
// place.
//  * match_setup_kernel: the first level's start values x = log_se3(guess),
//    T = I, initial = guess, precision = I, with guess = inverse(init) for a
//    warm start and I without one.
//  * match_link_kernel: the next level's start values from a level's final
//    carry: x = log_se3(inc_applied), then T, initial and precision as they
//    are.
//  * match_result_kernel: the flat float32 row [B, 53 + 4 levels]: the pose
//    inverse(T), the information A * INFORMATION_SCALE, -ll plus mu
//    |log_se3(initial)|^2 with smoothing, then each level's selected pixels,
//    valid constraints, iterations and termination.  Block (l, b) counts
//    level l's selected pixels of stream b (refpack row 6 != 0: an exact
//    integer reduction, so its order does not matter) and writes the level's
//    four counts; block (0, b) also writes the stream's first 53 words.
// What bounds them: latency for the setup and the link (a few hundred
// dependent float32 operations a stream, one warp a stream as in the step
// kernels, its first lane computing); for the result, the selection rows
// read once (0.4 MB a stream at levels 3-1 of a 640x480 frame), one block a
// stream and level.  Arithmetic: the step kernels' (the same exp, log and
// inverse, the same fixed order of the small products), so the glue parts
// from the plain glue by a few ulps only where cuBLAS orders a product
// otherwise; torch.sum over six terms adds ((q0 + q4) + q2) + ((q1 + q5) + q3),
// as PyTorch's warp reduction does.

constexpr int kGlueMaxLevels = 8;
constexpr int kCountThreads = 512;
constexpr int kRowBase = 53;  // dense_tracker.FLAT_BASE: T (16), information (36), nll

__device__ __forceinline__ void identity4(float T[16]) {
#pragma unroll
  for (int k = 0; k < 16; ++k) T[k] = k % 5 == 0 ? 1.0f : 0.0f;
}

// Setup, one warp per stream (see above): init [B, 16] or null; x [B, 6],
// T and initial [B, 16], precision [B, 4] out.
__global__ void __launch_bounds__(32) match_setup_kernel(const float* __restrict__ init,
                                                         float* x, float* T, float* initial,
                                                         float* precision) {
  if (threadIdx.x) return;
  const size_t b = blockIdx.x;
  float guess[16], xi[6], eye[16];
  identity4(eye);
  if (init != nullptr) {
    float m[16];
    load<16>(m, init + b * 16);
    inverse_se3(m, guess);
  } else {
    identity4(guess);
  }
  log_se3(guess, xi);
  store<6>(x + b * 6, xi);
  store<16>(T + b * 16, eye);
  store<16>(initial + b * 16, guess);
  const float p[4] = {1.0f, 0.0f, 0.0f, 1.0f};
  store<4>(precision + b * 4, p);
}

// Link, one warp per stream: the carry's inc_applied, T, initial [B, 16] and
// precision [B, 4] in; the next level's x [B, 6], T, initial, precision out.
// Lane 0 takes the log while the other lanes copy the 36 words.
__global__ void __launch_bounds__(32) match_link_kernel(
    const float* __restrict__ inc_applied, const float* __restrict__ T,
    const float* __restrict__ initial, const float* __restrict__ precision, float* x_out,
    float* T_out, float* initial_out, float* precision_out) {
  const size_t b = blockIdx.x;
  const int lane = threadIdx.x;
  if (lane == 0) {
    float m[16], xi[6];
    load<16>(m, inc_applied + b * 16);
    log_se3(m, xi);
    store<6>(x_out + b * 6, xi);
  }
  for (int k = lane; k < 36; k += 32) {
    if (k < 16) T_out[b * 16 + k] = T[b * 16 + k];
    else if (k < 32) initial_out[b * 16 + k - 16] = initial[b * 16 + k - 16];
    else precision_out[b * 4 + k - 32] = precision[b * 4 + k - 32];
  }
}

struct MatchResultArgs {
  // the last level's final carry: T, initial [B, 16], A [B, 36], ll [B]
  const float* T;
  const float* initial;
  const float* A;
  const float* ll;
  // each level's final n, iteration, termination [B] (int32) and its
  // refpack's selection row: stream b's N words at selected + b * sel_stride
  const int* n[kGlueMaxLevels];
  const int* iteration[kGlueMaxLevels];
  const int* termination[kGlueMaxLevels];
  const float* selected[kGlueMaxLevels];
  long long sel_stride[kGlueMaxLevels];
  int pixels[kGlueMaxLevels];
  int levels, smoothing;
  float mu, info_scale;
  float* row;  // [B, 53 + 4 levels]
};

// The stream's first 53 words of the row.
__device__ void write_row_base(const MatchResultArgs& R, size_t b, float* out) {
  float T[16], T_inv[16];
  load<16>(T, R.T + b * 16);
  inverse_se3(T, T_inv);
  store<16>(out, T_inv);
#pragma unroll
  for (int k = 0; k < 36; ++k) out[16 + k] = R.A[b * 36 + k] * R.info_scale;
  float prior = 0.0f;
  if (R.smoothing) {
    float m[16], xi[6], q[6];
    load<16>(m, R.initial + b * 16);
    log_se3(m, xi);
#pragma unroll
    for (int k = 0; k < 6; ++k) q[k] = xi[k] * xi[k];
    prior = R.mu * (((q[0] + q[4]) + q[2]) + ((q[1] + q[5]) + q[3]));
  }
  out[52] = -R.ll[b] + prior;
}

// Result, block (l, b) of kCountThreads threads (see above).
__global__ void __launch_bounds__(kCountThreads) match_result_kernel(const MatchResultArgs R) {
  const int l = blockIdx.x;
  const size_t b = blockIdx.y;
  float* out = R.row + b * (kRowBase + 4 * R.levels);
  if (l == 0 && threadIdx.x == 32) write_row_base(R, b, out);  // beside warp 0's counting
  const float* sel = R.selected[l] + b * R.sel_stride[l];
  const int n = R.pixels[l];
  int count = 0;
  if ((reinterpret_cast<size_t>(sel) & 15) == 0 && n % 4 == 0) {
    const float4* sel4 = reinterpret_cast<const float4*>(sel);
    for (int i = threadIdx.x; i < n / 4; i += kCountThreads) {
      const float4 v = sel4[i];
      count += (v.x != 0.0f) + (v.y != 0.0f) + (v.z != 0.0f) + (v.w != 0.0f);
    }
  } else {
    for (int i = threadIdx.x; i < n; i += kCountThreads) count += sel[i] != 0.0f;
  }
  __shared__ int warps[kCountThreads / 32];
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) count += __shfl_down_sync(0xffffffffu, count, offset);
  if ((threadIdx.x & 31) == 0) warps[threadIdx.x >> 5] = count;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kCountThreads / 32; ++w) total += warps[w];
    float* counts = out + kRowBase + 4 * l;
    counts[0] = (float)total;
    counts[1] = (float)R.n[l][b];
    counts[2] = (float)R.iteration[l][b];
    counts[3] = (float)R.termination[l][b];
  }
}

}  // namespace

extern "C" {

// The packed output's layout, in float32 words: {stride, gram, precision,
// A, b, ll, log_sum, n, the sharded buffer's stride, its 136 sums, its log
// sum}.
void dvo_fused_stats_layout(int* fields) {
  const int layout[11] = {kOutStride, kOutGram, kOutPrec, kOutA, kOutB, kOutLL, kOutLogSum,
                          kOutN, kShardedStride, kOutPacked, kOutShardLog};
  for (int i = 0; i < 11; ++i) fields[i] = layout[i];
}

// Bytes of scratch a call needs: `rows` = 3 for the entry points that stash
// (r_I, r_Z, mask or gate), 0 for dvo_fused_partials (whose rw rows are an
// output).  Enough for either shape.
long long dvo_fused_stats_workspace_bytes(int n, int batch, int rows) {
  return (long long)workspace_layout(n, batch, rows).bytes;
}

#ifdef DVO_STAMPS
// The diagnostic build's stamp buffer: [blocks of launch 1, 8] int64 on the
// device (null: no stamps), and its row width.
int dvo_set_stamps(long long* buffer) {
  return (int)cudaMemcpyToSymbol(stamp_buffer, &buffer, sizeof(buffer));
}
int dvo_stamps_per_block() { return kStamps; }
#endif

// The folded call, B streams: refpack [B, 8, n], quad [B, 32, n] (the
// current frames' quad tables), T [B, 4, 4] and P_prev [B, 2, 2], float32,
// contiguous; n = height * width.  first: the first-iteration flag;
// depth_buffered: the 5 cm depth-buffer rule in the sample.  The scalars are
// the level's intrinsics and gx = fx / 255, gy = fy / 255, dof,
// dof_plus_2 = dof + 2, ll_scale = (dof + 2) / 2, each as the PyTorch side
// rounds it to float32.  workspace: dvo_fused_stats_workspace_bytes(n, B,
// 3) bytes; its first B * 3 * n floats are the stash (r_I, r_Z, mask)
// [B, 3, n] after the call.  tickets: [B] uint32, zero.  out: [B, 320]
// float32 (dvo_fused_stats_layout).  Two launches on `stream`; returns the
// first CUDA error, 0 for none.
int dvo_warp_fused_stats(const float* refpack, const float* quad, const float* T,
                         const float* P_prev, int n, int height, int width, int batch,
                         int first, int depth_buffered, float fx, float fy, float ox, float oy,
                         float gx, float gy, float dof, float dof_plus_2, float ll_scale,
                         void* workspace, unsigned* tickets, float* out, void* stream) {
  if (bad_shape(n, batch) || (long long)height * width != n) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args a = common_args(n, fx, fy, gx, gy, dof, dof_plus_2, ll_scale, tickets, out);
  a.refpack = refpack;
  a.quad = quad;
  a.T = T;
  a.prev = P_prev;
  a.first = first;
  set_level(a, height, width, ox, oy);
  set_workspace(a, workspace, n, batch, 3);
  cudaError_t err = depth_buffered ? launch_gram<Wide, kWarpBuffered, kStats>(a, batch, st)
                                   : launch_gram<Wide, kWarp, kStats>(a, batch, st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_loglik<Wide, false>(a, batch, st);
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
  Args a = common_args(n, fx, fy, gx, gy, dof, dof_plus_2, ll_scale, tickets, out);
  a.sampled = sampled;
  a.refpack = refpack;
  a.prev = precision3;
  a.first_flags = first_flags;
  set_workspace(a, workspace, n, batch, 3);
  cudaError_t err = launch_gram<Wide, kSampled, kStats>(a, batch, st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_loglik<Wide, false>(a, batch, st);
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
  Args a = common_args(n, fx, fy, gx, gy, dof, dof_plus_2, 0.0f, tickets, out);
  a.sampled = sampled;
  a.refpack = refpack;
  a.prev = precision3;
  a.first_flags = first_flags;
  a.rows = rw;
  set_workspace(a, workspace, n, 1, 0);
  return (int)launch_gram<Wide, kSampled, kRows4>(a, 1, st);
}

// Launch 1 of the pixel-sharded evaluation: refpack [8, n_local], one rank's
// column block of the zero-padded refpack; quad [32, n], the WHOLE current
// frame's table, n = height * width; T [4, 4], P_prev [2, 2].  The sample
// is depth-buffered.  Scalars and tickets as for dvo_warp_fused_stats.
// workspace: dvo_fused_stats_workspace_bytes(n_local, 1, 3) bytes, whose
// first 3 * n_local floats are the stash (r_I, r_Z, gate) afterwards.  out:
// [464] float32; this launch writes the shard's 136 sums at words 320-455,
// in the layout of the all-reduce (m00, m01, m11, v, scale_sum, n).
int dvo_warp_fused_partials(const float* refpack, const float* quad, const float* T,
                            const float* P_prev, int n_local, int n, int height, int width,
                            int first, float fx, float fy, float ox, float oy, float gx, float gy,
                            float dof, float dof_plus_2, void* workspace, unsigned* tickets,
                            float* out, void* stream) {
  if (bad_shape(n_local, 1) || n <= 0 || (long long)height * width != n)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args a = common_args(n_local, fx, fy, gx, gy, dof, dof_plus_2, 0.0f, tickets, out);
  a.nq = n;
  a.refpack = refpack;
  a.quad = quad;
  a.T = T;
  a.prev = P_prev;
  a.first = first;
  set_level(a, height, width, ox, oy);
  set_workspace(a, workspace, n_local, 1, 3);
  return (int)launch_gram<Sharded, kWarpBuffered, kPacked>(a, 1, st);
}

// Launch 2 of the pixel-sharded evaluation, after the all-reduce of out's
// 136 sums: the new precision into out (dvo_fused_stats_layout) and the
// shard's sum of log1p(r^T P_new r / dof) over the gated stash entries into
// word 456.  workspace, tickets and out as given to launch 1.
int dvo_sharded_loglik(int n_local, float dof, void* workspace, unsigned* tickets, float* out,
                       void* stream) {
  if (bad_shape(n_local, 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args a = common_args(n_local, 0.0f, 0.0f, 0.0f, 0.0f, dof, 0.0f, 0.0f, tickets, out);
  set_workspace(a, workspace, n_local, 1, 3);
  return (int)launch_loglik<Sharded, true>(a, 1, st);
}

// Launch 3 of the pixel-sharded evaluation, after the all-reduce of the log
// sum: the Gram, ll (log-determinant floor 1e-30), A, b and n into out.
int dvo_sharded_tail(float ll_scale, float* out, void* stream) {
  sharded_tail_kernel<<<1, 256, 0, static_cast<cudaStream_t>(stream)>>>(out, ll_scale);
  return (int)cudaGetLastError();
}

// The step kernels' pointer count (dvo_irls_step_tail's `pointers`).
int dvo_irls_step_pointers() { return kEvalFields + 3 + 2 * kCarryFields + kTraceFields; }

// The head of B streams' IRLS step: x [B, 6], T and initial [B, 4, 4] in;
// inc, T_new, initial_new [B, 4, 4] out; float32, contiguous.  One launch.
int dvo_irls_step_head(const float* x, const float* T, const float* initial, int batch,
                       float* inc, float* T_new, float* initial_new, void* stream) {
  if (bad_shape(1, batch)) return (int)cudaErrorInvalidValue;
  step_head_kernel<<<batch, 32, 0, static_cast<cudaStream_t>(stream)>>>(x, T, initial, inc,
                                                                        T_new, initial_new);
  return (int)cudaGetLastError();
}

// The tail of B streams' IRLS step.  pointers (dvo_irls_step_pointers):
// the evaluation's n (int32), precision [2, 2], ll, A [6, 6], b [6] (stream
// b's at eval_strides[f] * b words; each field contiguous within a
// stream); the head's inc, T_new, initial_new; the carry read and the carry
// written (dense_tracker._Carry's twelve fields, each [B, ...] contiguous;
// the two may be the same buffers); the trace's five buffers [iterations,
// B, ...] or five nulls.  max_iterations: the level's cap (and the trace's
// rows); freeze: a done stream's carry stays; smoothing: the prior with
// weight mu; start: the level's first step (the carry read is the level's
// start values in its x, T, initial and precision, and the head's inc as its
// inc_applied; StepTailArgs); precision: the increment's convergence
// threshold.  One launch.
int dvo_irls_step_tail(void* const* pointers, const long long* eval_strides, int batch,
                       int max_iterations, int freeze, int smoothing, int start, float mu,
                       float precision, void* stream) {
  if (bad_shape(1, batch)) return (int)cudaErrorInvalidValue;
  StepTailArgs S = {};
  int p = 0;
  for (int f = 0; f < kEvalFields; ++f) {
    S.eval[f] = pointers[p++];
    S.eval_stride[f] = eval_strides[f];
  }
  S.inc = static_cast<const float*>(pointers[p++]);
  S.T_new = static_cast<const float*>(pointers[p++]);
  S.initial_new = static_cast<const float*>(pointers[p++]);
  for (int f = 0; f < kCarryFields; ++f) S.in[f] = pointers[p++];
  for (int f = 0; f < kCarryFields; ++f) S.out[f] = pointers[p++];
  for (int f = 0; f < kTraceFields; ++f) S.trace[f] = static_cast<float*>(pointers[p++]);
  S.max_iterations = max_iterations;
  S.freeze = freeze;
  S.smoothing = smoothing;
  S.start = start;
  S.mu = mu;
  S.precision = precision;
  step_tail_kernel<<<batch, 32, 0, static_cast<cudaStream_t>(stream)>>>(S);
  return (int)cudaGetLastError();
}

// The most levels dvo_match_result takes.
int dvo_match_glue_max_levels() { return kGlueMaxLevels; }

// A match's setup for B streams: init [B, 4, 4] (the warm start, result
// space) or null (the identity); x [B, 6], T and initial [B, 4, 4],
// precision [B, 2, 2] out; float32, contiguous.  One launch.
int dvo_match_setup(const float* init, int batch, float* x, float* T, float* initial,
                    float* precision, void* stream) {
  if (bad_shape(1, batch)) return (int)cudaErrorInvalidValue;
  match_setup_kernel<<<batch, 32, 0, static_cast<cudaStream_t>(stream)>>>(init, x, T, initial,
                                                                         precision);
  return (int)cudaGetLastError();
}

// The link between two levels of B streams: a level's final inc_applied, T,
// initial [B, 4, 4] and precision [B, 2, 2] in; the next level's start
// values x [B, 6], T, initial, precision out; float32, contiguous.  One
// launch.
int dvo_match_link(const float* inc_applied, const float* T, const float* initial,
                   const float* precision, int batch, float* x_out, float* T_out,
                   float* initial_out, float* precision_out, void* stream) {
  if (bad_shape(1, batch)) return (int)cudaErrorInvalidValue;
  match_link_kernel<<<batch, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      inc_applied, T, initial, precision, x_out, T_out, initial_out, precision_out);
  return (int)cudaGetLastError();
}

// A match's result row for B streams.  pointers: the last level's final T
// [B, 4, 4], initial [B, 4, 4], A [B, 6, 6] and ll [B] (float32), then for
// each level, coarse to fine, its final n, iteration and termination [B]
// (int32) and its refpack's selection row of stream 0 (float32; stream b's at
// sel_strides[l] * b words, pixels[l] words each).  smoothing: the prior's
// term with weight mu; info_scale: INFORMATION_SCALE as float32.  row: [B, 53
// + 4 levels] float32, contiguous.  One launch.
int dvo_match_result(void* const* pointers, const long long* sel_strides, const int* pixels,
                     int levels, int batch, int smoothing, float mu, float info_scale,
                     float* row, void* stream) {
  if (bad_shape(1, batch) || levels < 1 || levels > kGlueMaxLevels)
    return (int)cudaErrorInvalidValue;
  MatchResultArgs R = {};
  int p = 0;
  R.T = static_cast<const float*>(pointers[p++]);
  R.initial = static_cast<const float*>(pointers[p++]);
  R.A = static_cast<const float*>(pointers[p++]);
  R.ll = static_cast<const float*>(pointers[p++]);
  for (int l = 0; l < levels; ++l) {
    R.n[l] = static_cast<const int*>(pointers[p++]);
    R.iteration[l] = static_cast<const int*>(pointers[p++]);
    R.termination[l] = static_cast<const int*>(pointers[p++]);
    R.selected[l] = static_cast<const float*>(pointers[p++]);
    R.sel_stride[l] = sel_strides[l];
    if (pixels[l] < 1) return (int)cudaErrorInvalidValue;
    R.pixels[l] = pixels[l];
  }
  R.levels = levels;
  R.smoothing = smoothing;
  R.mu = mu;
  R.info_scale = info_scale;
  R.row = row;
  match_result_kernel<<<dim3(levels, batch), kCountThreads, 0, static_cast<cudaStream_t>(stream)>>>(R);
  return (int)cudaGetLastError();
}

}  // extern "C"
