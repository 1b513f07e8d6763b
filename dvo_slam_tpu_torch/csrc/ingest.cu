// Ingest of raw RGB-D frames: u8 intensity and u16 (or int32) depth at
// 1/5000 m become a frame's whole pyramid (kernel A) and the prepared tables
// of the solve range (kernel B), written straight into the frame's two
// arenas.  One frame and the B frames of a rig take the same two launches:
// the rig's on a grid of (blocks, B), stream b's raw frame at b times the
// caller's stride and its outputs at b planes into each of the arenas'
// [B, ...] fields.
//
// Replaces no TPU kernel.  In the reference (and in the port's plain twin,
// ops/pyramid.convert_raw_depth -> build_pyramid -> models/dense_tracker.
// prepare_frame) this is some two hundred small tensor ops a frame, each a
// few microseconds of card work behind tens of microseconds of host issue.
// Both kernels keep the twin's float32 arithmetic and rounding order, so
// every output is bit-equal to it on the card (built with -fmad=false):
//
// * PyTorch's CUDA division by a Python scalar s multiplies by the
//   reciprocal 1 / s taken in double and rounded to float32: the wrapper
//   passes those reciprocals, so the depth is (float)raw * inv_scale (0
//   where raw <= 0) and the refpack's x is ((col - ox) * inv_fx) * z;
// * the 2x2 intensity mean: 0.5*a + 0.5*b along rows, then along columns,
//   level on level (a level-l value is the tree of its 4^l raw pixels in
//   that order);
// * depth and validity of level l: raw pixel (y << l, x << l);
// * central differences with clamped borders, 0.5f * (next - previous);
//   the depth derivatives gated at |d| <= max_derivative and valid only
//   where both neighbours are;
// * refpack x, y: col and row exact, ox and oy cast to float32;
// * the quad table's neighbours at flat index i + 1, i + w and i + w + 1
//   modulo h * w: torch.roll's wrap at the right and bottom border.
//
// What bounds it: device-memory bandwidth.  At 640x480 with 4 levels kernel
// A reads 0.92 MB of raw pixels and writes 26 bytes a pixel at 408,000
// pixels (10.6 MB); kernel B writes 161 bytes a pixel of the solve range
// (100,800 pixels at levels 3..1: 16.2 MB) and reads the level fields
// (about 2.6 MB, the neighbours from L2).  8.3 us at 3.35 TB/s for both, a
// stream; a rig of B streams is B times the work in the same two launches.
//
// Design.  Kernel A: one block per 32x8 tile of a level, all levels in one
// grid, coarse levels' blocks first (their values cost the most).  A block
// computes intensity and depth of its tile and a one-pixel halo (clamped to
// the image, which is the twin's edge padding) into shared memory, each
// value straight from the raw frame, then every thread writes its pixel's
// eight fields.  Kernel B: one thread per pixel of the solve range, levels
// in one grid; it reads the pixel's and its three neighbours' fields and
// writes sel, the refpack's 8 rows and the quad table's 32, each row
// coalesced across the warp.

#include <cuda_runtime.h>

#include <cstdint>

constexpr int kMaxLevels = 8;
constexpr int kTileW = 32;
constexpr int kTileH = 8;
constexpr int kThreads = kTileW * kTileH;
constexpr int kPackThreads = 256;

// the level fields, in the order of the offsets the wrapper passes
enum Field { kIntensity, kDepth, kIdx, kIdy, kZdx, kZdy, kValid, kZvalid, kFields };

// The arenas hold each field as [B, ...]: stream b's plane of a field of
// `pixels` values of `bytes` each lies b planes after the field's offset.
__device__ __forceinline__ long long plane(long long pixels, int bytes) {
  return static_cast<long long>(blockIdx.y) * pixels * bytes;
}

struct PyramidArgs {
  int levels;
  int h[kMaxLevels];
  int w[kMaxLevels];
  int tiles_x[kMaxLevels];
  int block_start[kMaxLevels];  // the level's first block (coarse levels first)
  int blocks[kMaxLevels];
  long long field[kMaxLevels][kFields];  // byte offsets in the reference arena
};

struct PackArgs {
  int last, first;  // the solve range, last <= level <= first
  int write_quad;
  int h[kMaxLevels];
  int w[kMaxLevels];
  int block_start[kMaxLevels];
  int blocks[kMaxLevels];
  long long field[kMaxLevels][kFields];  // reference arena
  long long sel[kMaxLevels];             // reference arena
  long long refpack[kMaxLevels];         // reference arena
  long long quad[kMaxLevels];            // current arena
  float ox[kMaxLevels], oy[kMaxLevels];
  float inv_fx[kMaxLevels], inv_fy[kMaxLevels];
  float intensity_threshold, depth_threshold;
};

namespace {

// Intensity of level L at (y, x): the mean tree of its 4^L raw pixels.
// Levels up to 3 inline (64 loads); deeper ones call, to bound the code.
template <int L>
struct Mean {
  static __device__ __forceinline__ float at(const uint8_t* __restrict__ p, int w0, int y,
                                             int x) {
    const float a00 = Mean<L - 1>::get(p, w0, 2 * y, 2 * x);
    const float a10 = Mean<L - 1>::get(p, w0, 2 * y + 1, 2 * x);
    const float a01 = Mean<L - 1>::get(p, w0, 2 * y, 2 * x + 1);
    const float a11 = Mean<L - 1>::get(p, w0, 2 * y + 1, 2 * x + 1);
    const float r0 = 0.5f * a00 + 0.5f * a10;  // rows first, column 2x
    const float r1 = 0.5f * a01 + 0.5f * a11;  // column 2x + 1
    return 0.5f * r0 + 0.5f * r1;
  }
  static __device__ __noinline__ float called(const uint8_t* __restrict__ p, int w0, int y,
                                              int x) {
    return at(p, w0, y, x);
  }
  static __device__ __forceinline__ float get(const uint8_t* __restrict__ p, int w0, int y,
                                              int x) {
    if constexpr (L <= 3) {
      return at(p, w0, y, x);
    } else {
      return called(p, w0, y, x);
    }
  }
};

template <>
struct Mean<0> {
  static __device__ __forceinline__ float get(const uint8_t* __restrict__ p, int w0, int y,
                                              int x) {
    return static_cast<float>(p[static_cast<long long>(y) * w0 + x]);
  }
};

template <typename D>
__device__ __forceinline__ float depth_of(D raw, float inv_scale) {
  return raw > 0 ? static_cast<float>(raw) * inv_scale : 0.0f;
}

// The tile's intensity and depth with a one-pixel halo, at clamped
// coordinates of level L.
template <int L, typename D>
__device__ __forceinline__ void fill_tile(float (*s_i)[kTileW + 2], float (*s_d)[kTileW + 2],
                                          const uint8_t* __restrict__ raw_i,
                                          const D* __restrict__ raw_d, int w0, float inv_scale,
                                          int y0, int x0, int h, int w) {
  for (int k = threadIdx.x; k < (kTileH + 2) * (kTileW + 2); k += kThreads) {
    const int hy = k / (kTileW + 2);
    const int hx = k - hy * (kTileW + 2);
    const int y = min(max(y0 - 1 + hy, 0), h - 1);
    const int x = min(max(x0 - 1 + hx, 0), w - 1);
    s_i[hy][hx] = Mean<L>::get(raw_i, w0, y, x);
    s_d[hy][hx] = depth_of(raw_d[(static_cast<long long>(y) << L) * w0 + (x << L)], inv_scale);
  }
}

template <typename D>
__global__ void __launch_bounds__(kThreads)
    pyramid_kernel(const uint8_t* __restrict__ raw_i, const D* __restrict__ raw_d,
                   long long stride_i, long long stride_d, int w0, float inv_scale,
                   float max_derivative, char* __restrict__ arena, const PyramidArgs a) {
  __shared__ float s_i[kTileH + 2][kTileW + 2];
  __shared__ float s_d[kTileH + 2][kTileW + 2];
  raw_i += static_cast<long long>(blockIdx.y) * stride_i;
  raw_d += static_cast<long long>(blockIdx.y) * stride_d;
  int level = 0;
  for (int l = 0; l < a.levels; ++l) {
    const int b = static_cast<int>(blockIdx.x) - a.block_start[l];
    if (b >= 0 && b < a.blocks[l]) level = l;
  }
  const int tile = static_cast<int>(blockIdx.x) - a.block_start[level];
  const int h = a.h[level];
  const int w = a.w[level];
  const int y0 = (tile / a.tiles_x[level]) * kTileH;
  const int x0 = (tile % a.tiles_x[level]) * kTileW;
  switch (level) {
    case 0: fill_tile<0>(s_i, s_d, raw_i, raw_d, w0, inv_scale, y0, x0, h, w); break;
    case 1: fill_tile<1>(s_i, s_d, raw_i, raw_d, w0, inv_scale, y0, x0, h, w); break;
    case 2: fill_tile<2>(s_i, s_d, raw_i, raw_d, w0, inv_scale, y0, x0, h, w); break;
    case 3: fill_tile<3>(s_i, s_d, raw_i, raw_d, w0, inv_scale, y0, x0, h, w); break;
    case 4: fill_tile<4>(s_i, s_d, raw_i, raw_d, w0, inv_scale, y0, x0, h, w); break;
    case 5: fill_tile<5>(s_i, s_d, raw_i, raw_d, w0, inv_scale, y0, x0, h, w); break;
    case 6: fill_tile<6>(s_i, s_d, raw_i, raw_d, w0, inv_scale, y0, x0, h, w); break;
    default: fill_tile<7>(s_i, s_d, raw_i, raw_d, w0, inv_scale, y0, x0, h, w); break;
  }
  __syncthreads();
  const int tx = threadIdx.x % kTileW;
  const int ty = threadIdx.x / kTileW;
  const int x = x0 + tx;
  const int y = y0 + ty;
  if (x >= w || y >= h) return;
  const int cy = ty + 1, cx = tx + 1;
  const float idx = 0.5f * (s_i[cy][cx + 1] - s_i[cy][cx - 1]);
  const float idy = 0.5f * (s_i[cy + 1][cx] - s_i[cy - 1][cx]);
  // valid depth is never 0 (raw >= 1), invalid depth is 0
  const float z = s_d[cy][cx];
  const float zl = s_d[cy][cx - 1], zr = s_d[cy][cx + 1];
  const float zu = s_d[cy - 1][cx], zd = s_d[cy + 1][cx];
  const float zdx = 0.5f * (zr - zl);
  const float zdy = 0.5f * (zd - zu);
  bool zdx_ok = zr != 0.0f && zl != 0.0f;
  bool zdy_ok = zd != 0.0f && zu != 0.0f;
  if (max_derivative > 0.0f) {
    zdx_ok = zdx_ok && fabsf(zdx) <= max_derivative;
    zdy_ok = zdy_ok && fabsf(zdy) <= max_derivative;
  }
  const long long i = static_cast<long long>(y) * w + x;
  const long long* f = a.field[level];
  char* const fl = arena + plane(static_cast<long long>(h) * w, 4);
  char* const bl = arena + plane(static_cast<long long>(h) * w, 1);
  reinterpret_cast<float*>(fl + f[kIntensity])[i] = s_i[cy][cx];
  reinterpret_cast<float*>(fl + f[kDepth])[i] = z;
  reinterpret_cast<float*>(fl + f[kIdx])[i] = idx;
  reinterpret_cast<float*>(fl + f[kIdy])[i] = idy;
  reinterpret_cast<float*>(fl + f[kZdx])[i] = zdx_ok ? zdx : 0.0f;
  reinterpret_cast<float*>(fl + f[kZdy])[i] = zdy_ok ? zdy : 0.0f;
  reinterpret_cast<bool*>(bl + f[kValid])[i] = z != 0.0f;
  reinterpret_cast<bool*>(bl + f[kZvalid])[i] = z != 0.0f && zdx_ok && zdy_ok;
}

__global__ void __launch_bounds__(kPackThreads)
    pack_kernel(const char* __restrict__ ref_in, char* __restrict__ ref_out,
                char* __restrict__ cur, const PackArgs a) {
  int level = a.last;
  for (int l = a.last; l <= a.first; ++l) {
    const int b = static_cast<int>(blockIdx.x) - a.block_start[l];
    if (b >= 0 && b < a.blocks[l]) level = l;
  }
  const int w = a.w[level];
  const int n = a.h[level] * w;
  const int i = (static_cast<int>(blockIdx.x) - a.block_start[level]) * kPackThreads +
                static_cast<int>(threadIdx.x);
  if (i >= n) return;
  const long long* f = a.field[level];
  const char* const fl = ref_in + plane(n, 4);
  const float* I = reinterpret_cast<const float*>(fl + f[kIntensity]);
  const float* Z = reinterpret_cast<const float*>(fl + f[kDepth]);
  const float* DX = reinterpret_cast<const float*>(fl + f[kIdx]);
  const float* DY = reinterpret_cast<const float*>(fl + f[kIdy]);
  const float* ZX = reinterpret_cast<const float*>(fl + f[kZdx]);
  const float* ZY = reinterpret_cast<const float*>(fl + f[kZdy]);
  const bool* ZV = reinterpret_cast<const bool*>(ref_in + plane(n, 1) + f[kZvalid]);

  const float c_i = I[i], c_z = Z[i], c_dx = DX[i], c_dy = DY[i];
  const float c_zx = ZX[i], c_zy = ZY[i];
  const float ti = a.intensity_threshold, td = a.depth_threshold;
  const bool grad = fabsf(c_dx) > ti || fabsf(c_dy) > ti || fabsf(c_zx) > td || fabsf(c_zy) > td;
  const bool sel = ZV[i] && grad;
  reinterpret_cast<bool*>(ref_out + plane(n, 1) + a.sel[level])[i] = sel;

  const float col = static_cast<float>(i % w);
  const float row = static_cast<float>(i / w);
  float* rp = reinterpret_cast<float*>(ref_out + plane(8LL * n, 4) + a.refpack[level]);
  rp[i] = c_i;
  rp[n + i] = c_z;
  rp[2 * n + i] = c_dx;
  rp[3 * n + i] = c_dy;
  rp[4 * n + i] = ((col - a.ox[level]) * a.inv_fx[level]) * c_z;
  rp[5 * n + i] = ((row - a.oy[level]) * a.inv_fy[level]) * c_z;
  rp[6 * n + i] = sel ? 1.0f : 0.0f;
  rp[7 * n + i] = 0.0f;
  if (!a.write_quad) return;

  float* q = reinterpret_cast<float*>(cur + plane(32LL * n, 4) + a.quad[level]);
  const int shifts[4] = {0, 1 % n, w % n, (w + 1) % n};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    int j = i + shifts[k];
    if (j >= n) j -= n;
    float* qk = q + static_cast<long long>(8 * k) * n;
    qk[i] = I[j];
    qk[n + i] = Z[j];
    qk[2 * n + i] = DX[j];
    qk[3 * n + i] = DY[j];
    qk[4 * n + i] = ZX[j];
    qk[5 * n + i] = ZY[j];
    qk[6 * n + i] = ZV[j] ? 1.0f : 0.0f;
    qk[7 * n + i] = 0.0f;
  }
}

// Kernel A on `stream`: `batch` frames, frame b of raw_i [h0, w0] u8 at
// b * stride_i values and of raw_d [h0, w0] u16 (depth_i32 0) or int32 (1)
// at b * stride_d; the level fields go to `arena` at a's offsets.
cudaError_t launch_pyramid(const void* raw_i, const void* raw_d, int depth_i32, int batch,
                           long long stride_i, long long stride_d, int w0, float inv_scale,
                           float max_derivative, void* arena, const PyramidArgs& a,
                           cudaStream_t s) {
  int blocks = 0;
  for (int l = 0; l < a.levels; ++l) blocks += a.blocks[l];
  if (blocks == 0) return cudaSuccess;
  const dim3 grid(blocks, batch);
  const uint8_t* pi = static_cast<const uint8_t*>(raw_i);
  char* out = static_cast<char*>(arena);
  if (depth_i32) {
    pyramid_kernel<int32_t><<<grid, kThreads, 0, s>>>(
        pi, static_cast<const int32_t*>(raw_d), stride_i, stride_d, w0, inv_scale,
        max_derivative, out, a);
  } else {
    pyramid_kernel<uint16_t><<<grid, kThreads, 0, s>>>(
        pi, static_cast<const uint16_t*>(raw_d), stride_i, stride_d, w0, inv_scale,
        max_derivative, out, a);
  }
  return cudaGetLastError();
}

// Kernel B on `stream`: reads kernel A's fields in `ref`, writes sel and
// refpack into `ref` and, with b.write_quad, the quad tables into `cur`,
// for each of `batch` frames.
cudaError_t launch_packs(void* ref, void* cur, int batch, const PackArgs& b, cudaStream_t s) {
  int blocks = 0;
  for (int l = b.last; l <= b.first; ++l) blocks += b.blocks[l];
  if (blocks == 0) return cudaSuccess;
  pack_kernel<<<dim3(blocks, batch), kPackThreads, 0, s>>>(
      static_cast<const char*>(ref), static_cast<char*>(ref), static_cast<char*>(cur), b);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The ingest of `batch` frames (1: one frame) on `stream`, no host
// synchronisation: kernel A and, with `b` not null, kernel B.  Frame k's
// raw pixels start stride_i (intensity) and stride_d (depth) values after
// frame k - 1's.  Returns a cudaError_t, 0 when all was queued.
int dvo_ingest(const void* raw_i, const void* raw_d, int depth_i32, int batch,
               long long stride_i, long long stride_d, int w0, float inv_scale,
               float max_derivative, void* ref, const PyramidArgs* a, void* cur,
               const PackArgs* b, void* stream) {
  if (batch < 1 || batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t r = launch_pyramid(raw_i, raw_d, depth_i32, batch, stride_i, stride_d, w0,
                                 inv_scale, max_derivative, ref, *a, s);
  if (r == cudaSuccess && b != nullptr) r = launch_packs(ref, cur, batch, *b, s);
  return static_cast<int>(r);
}

// sizeof the argument blocks, checked against the ctypes structures
int dvo_ingest_sizes(int* pyramid, int* packs) {
  *pyramid = static_cast<int>(sizeof(PyramidArgs));
  *packs = static_cast<int>(sizeof(PackArgs));
  return 0;
}

}  // extern "C"
