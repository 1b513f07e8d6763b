// Identity copy of a contiguous float32 table [C, n] into a buffer of its own.
//
// Replaces the TPU kernel pallas_copy of tools/gather_probe.py (kernel body
// _copy_kernel): the gather probe's `pcopy` variant gives each stream's quad
// table [32, n] a standalone allocation by copying it out of the stacked
// [B, 32, n] table, to test whether a gather's speed depends on the buffer
// it reads (one of B slices of one allocation, or an allocation of its own)
// rather than on the logical shape.
//
// What bounds it on the card: device-memory bandwidth, nothing else.  It
// reads and writes 4 bytes per element; one stream's table at the L1 shape
// (32 x 76,800) is 9.8 MB each way, 5.9 us at 3.35 TB/s when neither side
// is in the L2 cache.
//
// Design: a bulk-TMA copy.  The Pallas kernel walks a sequential grid of
// [C, 3072] blocks.  Here a persistent grid, one block per SM, walks the
// table in 8 KB chunks (block b takes chunks b, b + grid, ...).  One thread
// of each block drives a ring of 8 shared-memory stages with the Tensor
// Memory Accelerator's bulk copies: cp.async.bulk global -> shared completes
// on the stage's mbarrier, then cp.async.bulk shared -> global goes out in a
// bulk group; a stage is refilled once the store that read it has finished
// reading (cp.async.bulk.wait_group.read).  So each SM keeps up to 64 KB of
// loads in flight without spending registers or instructions on addresses.
// The element count's last (C n) % 4 floats are copied one by one, and a
// table whose source or destination is not 16-byte aligned takes a scalar
// grid-stride loop: correctness paths for what the bulk copy cannot take.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kChunk = 8192;   // bytes per stage (a multiple of 16)
constexpr int kStages = 8;
constexpr int kSmem = kChunk * kStages;
constexpr int kScalarThreads = 256;
constexpr long long kScalarMaxBlocks = 4096;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Copies `total` floats; src and dst 16-byte aligned.
__global__ void __launch_bounds__(32) bulk_copy_kernel(const float* __restrict__ src,
                                                      float* __restrict__ dst, long long total) {
  extern __shared__ __align__(128) unsigned char stage[];
  __shared__ __align__(8) unsigned long long full[kStages];

  const long long body = total & ~3LL;  // floats that the bulk copies move
  if (blockIdx.x == 0 && threadIdx.x < total - body) dst[body + threadIdx.x] = src[body + threadIdx.x];
  const long long bytes = body * 4;
  const long long chunks = (bytes + kChunk - 1) / kChunk;
  const long long first = blockIdx.x;
  if (threadIdx.x != 0 || first >= chunks) return;
  const long long mine = (chunks - first + gridDim.x - 1) / gridDim.x;

  for (int s = 0; s < kStages; ++s)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(full + s)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");

  const char* s8 = reinterpret_cast<const char*>(src);
  char* d8 = reinterpret_cast<char*>(dst);
  auto span = [&](long long i, long long& off) {  // local chunk i -> (offset, length)
    off = (first + i * gridDim.x) * kChunk;
    const long long left = bytes - off;
    return static_cast<unsigned>(left < kChunk ? left : kChunk);
  };
  auto load = [&](long long i) {
    long long off;
    const unsigned len = span(i, off);
    const unsigned bar = smem_addr(full + i % kStages);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(len)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        ::"r"(smem_addr(stage + (i % kStages) * kChunk)), "l"(s8 + off), "r"(len), "r"(bar)
        : "memory");
  };

  for (long long i = 0; i < mine && i < kStages; ++i) load(i);
  for (long long i = 0; i < mine; ++i) {
    const int s = static_cast<int>(i % kStages);
    mbar_wait(smem_addr(full + s), static_cast<unsigned>((i / kStages) & 1));
    long long off;
    const unsigned len = span(i, off);
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
                 ::"l"(d8 + off), "r"(smem_addr(stage + s * kChunk)), "r"(len)
                 : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    // refill the stage of the previous chunk once its store has read it
    if (i >= 1 && i - 1 + kStages < mine) {
      asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
      load(i - 1 + kStages);
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Any alignment: one float per thread and step of a grid-stride loop.
__global__ void __launch_bounds__(kScalarThreads)
scalar_copy_kernel(const float* __restrict__ src, float* __restrict__ dst, long long total) {
  const long long stride = (long long)gridDim.x * kScalarThreads;
  for (long long i = (long long)blockIdx.x * kScalarThreads + threadIdx.x; i < total; i += stride)
    dst[i] = src[i];
}

// The bulk kernel's grid on the current device, min(chunks, SMs), into
// *blocks; the SM count and the kernel's shared-memory opt-in are set up
// once per device.
cudaError_t bulk_grid(long long chunks, int* blocks) {
  static int sms[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    int count = 0;
    err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(bulk_copy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    sms[dev] = count;
  }
  *blocks = static_cast<int>(chunks < 1 ? 1 : (chunks < sms[dev] ? chunks : sms[dev]));
  return cudaSuccess;
}

}  // namespace

extern "C" {

// src, dst: `total` contiguous float32 each (a [C, n] table, total = C * n),
// not overlapping.  One launch on `stream`; returns cudaGetLastError() (or
// the error of the one-time device query).
int dvo_table_copy(const float* src, float* dst, long long total, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (total <= 0) return (int)cudaErrorInvalidValue;
  const bool aligned = ((reinterpret_cast<std::uintptr_t>(src) |
                         reinterpret_cast<std::uintptr_t>(dst)) % 16) == 0;
  if (aligned) {
    const long long chunks = ((total & ~3LL) * 4 + kChunk - 1) / kChunk;
    int blocks = 0;
    const cudaError_t err = bulk_grid(chunks, &blocks);
    if (err != cudaSuccess) return (int)err;
    bulk_copy_kernel<<<blocks, 32, kSmem, st>>>(src, dst, total);
  } else {
    long long blocks = (total + kScalarThreads - 1) / kScalarThreads;
    if (blocks > kScalarMaxBlocks) blocks = kScalarMaxBlocks;
    scalar_copy_kernel<<<(unsigned)blocks, kScalarThreads, 0, st>>>(src, dst, total);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
