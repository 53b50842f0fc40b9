// Eq. (4), two entry points:
//
// plane_or_segments: out = acc | (plane << shift[i / block]) over a flat
// accumulator buffer. Replaces src/repro/kernels/bitplane.py
// `plane_or_segments` (the Pallas `_or_segments_kernel`).
//
// plane_or: out = acc | (plane << shift) over one tensor of any length, with
// one shift and acc and plane of any uint dtypes (the plane widened to 32 bits
// before the shift). Replaces src/repro/kernels/bitplane.py `plane_or` (the
// Pallas `_or_kernel`).
//
// Bound: device-memory bytes. Each element is read twice (acc, plane) and
// written once; the shift table is one int per `block` elements. A thread
// loads one 16-byte word of acc and writes one of the result, so every warp
// instruction moves 512 contiguous bytes; plane_or loads the plane's share
// of the same elements (8 bytes of a uint8 plane beside uint16 acc), and a
// scalar tail covers what is left. Both write a new buffer and leave `acc`
// untouched: the previous stage's views of the accumulator stay valid.
#include <cuda_runtime.h>
#include <stdint.h>

#include "pack.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(256) or_segments_vec(
    const T* __restrict__ acc, const T* __restrict__ plane,
    const int* __restrict__ shifts, T* __restrict__ out, long long n_vec,
    int vecs_per_block) {
  constexpr int V = 16 / sizeof(T);
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n_vec;
       i += (long long)gridDim.x * blockDim.x) {
    const unsigned sh = (unsigned)shifts[i / vecs_per_block];
    const Pack<T, V> a = load_pack<T, V>(acc, i), p = load_pack<T, V>(plane, i);
    Pack<T, V> o;
#pragma unroll
    for (int j = 0; j < V; ++j)
      o.e[j] = (T)((uint32_t)a.e[j] | ((uint32_t)p.e[j] << sh));
    store_pack<T, V>(out, i, o);
  }
}

// Any alignment: one element per thread.
template <typename T>
__global__ void __launch_bounds__(256) or_segments_scalar(
    const T* __restrict__ acc, const T* __restrict__ plane,
    const int* __restrict__ shifts, T* __restrict__ out, long long n, int block) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const unsigned sh = (unsigned)shifts[i / block];
    out[i] = (T)((uint32_t)acc[i] | ((uint32_t)plane[i] << sh));
  }
}

template <typename T>
void launch(const void* acc, const void* plane, const int* shifts, void* out,
            long long n, int block, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const int threads = 256;
  const bool aligned = ((uintptr_t)acc % 16 == 0) && ((uintptr_t)plane % 16 == 0) &&
                       ((uintptr_t)out % 16 == 0) && (block % V == 0);
  if (aligned) {
    const long long n_vec = n / V;
    long long blocks = (n_vec + threads - 1) / threads;
    if (blocks > 132 * 32) blocks = 132 * 32;
    or_segments_vec<T><<<(unsigned)blocks, threads, 0, stream>>>(
        (const T*)acc, (const T*)plane, shifts, (T*)out, n_vec, block / V);
  } else {
    long long blocks = (n + threads - 1) / threads;
    if (blocks > 132 * 32) blocks = 132 * 32;
    or_segments_scalar<T><<<(unsigned)blocks, threads, 0, stream>>>(
        (const T*)acc, (const T*)plane, shifts, (T*)out, n, block);
  }
}

// ---------------------------------------------------------------------------
// plane_or: one tensor, one shift, acc and plane of any uint dtypes
// ---------------------------------------------------------------------------

template <typename TA, typename TP>
__device__ __forceinline__ TA or_shift(TA a, TP p, unsigned shift) {
  return (TA)((uint32_t)a | ((uint32_t)p << shift));
}

// The first n_vec * E elements in packs of E, the tail one element a thread.
template <typename TA, typename TP, int E>
__global__ void __launch_bounds__(256) or_vec(const TA* __restrict__ acc,
                                              const TP* __restrict__ plane,
                                              TA* __restrict__ out, long long n,
                                              long long n_vec, unsigned shift) {
  const long long tid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = tid; i < n_vec; i += stride) {
    const Pack<TA, E> a = load_pack<TA, E>(acc, i);
    const Pack<TP, E> p = load_pack<TP, E>(plane, i);
    Pack<TA, E> o;
#pragma unroll
    for (int j = 0; j < E; ++j) o.e[j] = or_shift(a.e[j], p.e[j], shift);
    store_pack<TA, E>(out, i, o);
  }
  for (long long i = n_vec * E + tid; i < n; i += stride)
    out[i] = or_shift(acc[i], plane[i], shift);
}

template <typename TA, typename TP>
__global__ void __launch_bounds__(256) or_scalar(const TA* __restrict__ acc,
                                                 const TP* __restrict__ plane,
                                                 TA* __restrict__ out, long long n,
                                                 unsigned shift) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    out[i] = or_shift(acc[i], plane[i], shift);
}

template <typename TA, typename TP>
void launch_or(const void* acc, const void* plane, void* out, long long n,
               unsigned shift, cudaStream_t stream) {
  // one 16-byte word of acc and out a thread (the plane's share is
  // E * sizeof(TP) bytes): every warp instruction on acc or out moves 512
  // contiguous bytes
  constexpr int E = 16 / sizeof(TA);
  const int threads = 256;
  const bool aligned = ((uintptr_t)acc % 16 == 0) && ((uintptr_t)plane % 16 == 0) &&
                       ((uintptr_t)out % 16 == 0);
  const long long work = aligned && n >= E ? n / E : n;
  long long blocks = (work + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  if (aligned)
    or_vec<TA, TP, E><<<(unsigned)blocks, threads, 0, stream>>>(
        (const TA*)acc, (const TP*)plane, (TA*)out, n, n / E, shift);
  else
    or_scalar<TA, TP><<<(unsigned)blocks, threads, 0, stream>>>(
        (const TA*)acc, (const TP*)plane, (TA*)out, n, shift);
}

template <typename TA>
int dispatch_plane(const void* acc, const void* plane, void* out, long long n,
                   unsigned shift, int plane_bytes, cudaStream_t s) {
  switch (plane_bytes) {
    case 1: launch_or<TA, uint8_t>(acc, plane, out, n, shift, s); break;
    case 2: launch_or<TA, uint16_t>(acc, plane, out, n, shift, s); break;
    case 4: launch_or<TA, uint32_t>(acc, plane, out, n, shift, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

// n elements of any count; acc_bytes and plane_bytes are 1, 2 or 4
// (uint8/16/32); 0 <= shift < 32.
extern "C" int plane_or(const void* acc, const void* plane, void* out, long long n,
                        int shift, int acc_bytes, int plane_bytes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0) return (int)cudaSuccess;
  if (shift < 0 || shift > 31) return (int)cudaErrorInvalidValue;
  int code;
  switch (acc_bytes) {
    case 1: code = dispatch_plane<uint8_t>(acc, plane, out, n, shift, plane_bytes, s); break;
    case 2: code = dispatch_plane<uint16_t>(acc, plane, out, n, shift, plane_bytes, s); break;
    case 4: code = dispatch_plane<uint32_t>(acc, plane, out, n, shift, plane_bytes, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (code) return code;
  return (int)cudaGetLastError();
}

// n is a multiple of `block`; elem_bytes is 1, 2 or 4 (uint8/16/32).
extern "C" int plane_or_segments(const void* acc, const void* plane, const int* shifts,
                                 void* out, long long n, int block, int elem_bytes,
                                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0) return (int)cudaSuccess;
  switch (elem_bytes) {
    case 1: launch<uint8_t>(acc, plane, shifts, out, n, block, s); break;
    case 2: launch<uint16_t>(acc, plane, shifts, out, n, block, s); break;
    case 4: launch<uint32_t>(acc, plane, shifts, out, n, block, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
