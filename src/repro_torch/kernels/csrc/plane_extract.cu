// Eq. (3), bit division on the server: out = ((q << before) & (2^bits - 1))
// >> (bits - width), the `width`-bit plane that starts `before` bits below the
// top of a `bits`-bit value, over one tensor of any length.
//
// Replaces src/repro/kernels/bitplane.py `plane_extract` (the Pallas
// `_extract_kernel`). The TPU kernel writes q's dtype; this one writes any
// uint dtype, so `split` writes a 2-bit plane straight into uint8 (its
// container) in one pass.
//
// Bound: device-memory bytes: q is read once and the plane written once
// (3 bytes an element for uint16 q and a uint8 plane). A thread moves whole
// 16-byte words of each operand, and a scalar tail covers what is left.
#include <cuda_runtime.h>
#include <stdint.h>

#include "pack.cuh"

namespace {

struct Extract {
  unsigned before, down;
  uint32_t mask;
  template <typename TQ>
  __device__ __forceinline__ uint32_t operator()(TQ q) const {
    return (((uint32_t)q << before) & mask) >> down;
  }
};

template <typename TQ, typename TO, int E>
__global__ void __launch_bounds__(256) extract_vec(const TQ* __restrict__ q,
                                                   TO* __restrict__ out, long long n,
                                                   long long n_vec, Extract f) {
  const long long tid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = tid; i < n_vec; i += stride) {
    const Pack<TQ, E> a = load_pack<TQ, E>(q, i);
    Pack<TO, E> o;
#pragma unroll
    for (int j = 0; j < E; ++j) o.e[j] = (TO)f(a.e[j]);
    store_pack<TO, E>(out, i, o);
  }
  for (long long i = n_vec * E + tid; i < n; i += stride) out[i] = (TO)f(q[i]);
}

template <typename TQ, typename TO>
__global__ void __launch_bounds__(256) extract_scalar(const TQ* __restrict__ q,
                                                      TO* __restrict__ out, long long n,
                                                      Extract f) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    out[i] = (TO)f(q[i]);
}

template <typename TQ, typename TO>
void launch(const void* q, void* out, long long n, Extract f, cudaStream_t stream) {
  // E = 16 / (the smaller element size): each operand's share is whole
  // 16-byte words (for uint16 q and a uint8 plane: two words of q, one of
  // the plane a thread)
  constexpr int E = 16 / (sizeof(TQ) < sizeof(TO) ? sizeof(TQ) : sizeof(TO));
  const int threads = 256;
  const bool aligned = ((uintptr_t)q % 16 == 0) && ((uintptr_t)out % 16 == 0);
  const long long work = aligned && n >= E ? n / E : n;
  long long blocks = (work + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  if (aligned)
    extract_vec<TQ, TO, E><<<(unsigned)blocks, threads, 0, stream>>>(
        (const TQ*)q, (TO*)out, n, n / E, f);
  else
    extract_scalar<TQ, TO><<<(unsigned)blocks, threads, 0, stream>>>(
        (const TQ*)q, (TO*)out, n, f);
}

template <typename TQ>
int dispatch_out(const void* q, void* out, long long n, Extract f, int out_bytes,
                 cudaStream_t s) {
  switch (out_bytes) {
    case 1: launch<TQ, uint8_t>(q, out, n, f, s); break;
    case 2: launch<TQ, uint16_t>(q, out, n, f, s); break;
    case 4: launch<TQ, uint32_t>(q, out, n, f, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

// n elements of any count; q_bytes and out_bytes are 1, 2 or 4 (uint8/16/32);
// 1 <= width, 0 <= before, before + width <= bits <= 32.
extern "C" int plane_extract(const void* q, void* out, long long n, int bits, int before,
                             int width, int q_bytes, int out_bytes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (width < 1 || before < 0 || before + width > bits || bits > 32)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaSuccess;
  const Extract f{(unsigned)before, (unsigned)(bits - width),
                  bits == 32 ? 0xFFFFFFFFu : (1u << bits) - 1u};
  int code;
  switch (q_bytes) {
    case 1: code = dispatch_out<uint8_t>(q, out, n, f, out_bytes, s); break;
    case 2: code = dispatch_out<uint16_t>(q, out, n, f, out_bytes, s); break;
    case 4: code = dispatch_out<uint32_t>(q, out, n, f, out_bytes, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (code) return code;
  return (int)cudaGetLastError();
}
