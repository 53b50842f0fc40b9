// Eq. (4) over a flat accumulator buffer: out = acc | (plane << shift[i / block]).
//
// Replaces src/repro/kernels/bitplane.py `plane_or_segments` (the Pallas
// `_or_segments_kernel`). Bound: device-memory bytes. Each element is read
// twice (acc, plane) and written once; the shift table is one int per
// `block` elements. The kernel does one 16-byte load of acc and of plane per
// thread and one 16-byte store, so every warp moves whole 512-byte lines.
// It writes a new buffer and leaves `acc` untouched: the previous stage's
// views of the accumulator stay valid.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
union Vec16 {
  uint4 raw;
  T e[16 / sizeof(T)];
};

template <typename T>
__global__ void __launch_bounds__(256) or_segments_vec(
    const uint4* __restrict__ acc, const uint4* __restrict__ plane,
    const int* __restrict__ shifts, uint4* __restrict__ out, long long n_vec,
    int vecs_per_block) {
  constexpr int V = 16 / sizeof(T);
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n_vec;
       i += (long long)gridDim.x * blockDim.x) {
    const unsigned sh = (unsigned)shifts[i / vecs_per_block];
    Vec16<T> a, p, o;
    a.raw = acc[i];
    p.raw = plane[i];
#pragma unroll
    for (int j = 0; j < V; ++j)
      o.e[j] = (T)((uint32_t)a.e[j] | ((uint32_t)p.e[j] << sh));
    out[i] = o.raw;
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
        (const uint4*)acc, (const uint4*)plane, shifts, (uint4*)out, n_vec, block / V);
  } else {
    long long blocks = (n + threads - 1) / threads;
    if (blocks > 132 * 32) blocks = 132 * 32;
    or_segments_scalar<T><<<(unsigned)blocks, threads, 0, stream>>>(
        (const T*)acc, (const T*)plane, shifts, (T*)out, n, block);
  }
}

}  // namespace

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
