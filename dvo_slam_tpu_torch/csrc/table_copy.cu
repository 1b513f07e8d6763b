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
// (32 x 76,800) is 9.8 MB each way.
//
// Design: the Pallas kernel walks a sequential grid of [C, 3072] blocks and
// needs n to be a multiple of 3072.  Here every thread copies 16 bytes at a
// time (float4 loads and stores, neighbouring threads on neighbouring
// addresses, so each warp moves 512 contiguous bytes) in a grid-stride loop
// over the whole C * n elements, which the table's contiguity makes one flat
// range.  Any n is allowed: the last (C * n) % 4 elements are copied one by
// one, and a pointer that is not 16-byte aligned takes the scalar loop for
// everything.  There is no shared memory and no synchronisation: a copy
// gains nothing from staging.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 4096;  // grid-stride beyond that

template <bool kVector>
__global__ void __launch_bounds__(kThreads)
table_copy_kernel(const float* __restrict__ src, float* __restrict__ dst,
                  long long total) {
  const long long stride = (long long)gridDim.x * kThreads;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  long long done = 0;
  if constexpr (kVector) {
    const long long vecs = total / 4;
    const float4* __restrict__ s4 = reinterpret_cast<const float4*>(src);
    float4* __restrict__ d4 = reinterpret_cast<float4*>(dst);
    for (long long i = tid; i < vecs; i += stride) d4[i] = s4[i];
    done = vecs * 4;
  }
  for (long long i = done + tid; i < total; i += stride) dst[i] = src[i];
}

}  // namespace

extern "C" {

// src, dst: `total` contiguous float32 each (a [C, n] table, total = C * n),
// not overlapping.  Returns cudaGetLastError() after the one launch on
// `stream`.
int dvo_table_copy(const float* src, float* dst, long long total, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (total <= 0) return (int)cudaErrorInvalidValue;
  const bool vector = ((reinterpret_cast<std::uintptr_t>(src) |
                        reinterpret_cast<std::uintptr_t>(dst)) % 16) == 0;
  const long long work = vector ? (total + 3) / 4 : total;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (vector) {
    table_copy_kernel<true><<<(unsigned)blocks, kThreads, 0, st>>>(src, dst, total);
  } else {
    table_copy_kernel<false><<<(unsigned)blocks, kThreads, 0, st>>>(src, dst, total);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
