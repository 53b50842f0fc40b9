// y = x @ (scale * q + offset), accumulated in float32, without a float
// weight buffer in device memory.
//
// Replaces src/repro/kernels/dequant_matmul.py `dequant_matmul` (the Pallas
// `_kernel`) at small M, the GEMV route: below 16 rows of x for (K, N) q,
// below 4 for the K-contiguous view, and for uint32 containers at any M
// (dequant_matmul_mma.cu is the tensor-core route above). At decode M is
// the batch (1-8), so the product does about 2*M operations per weight
// element and is bound by the bytes of q: the whole model's accumulators
// cross device memory once per decode step. The design keeps that one
// pass and nothing else:
//
//  * q in (K, N) layout with N contiguous (`dqmm_cols`): a block owns 32*V
//    consecutive columns and one chunk of K; its 8 warps take every 8th row
//    of the chunk, each thread loads V columns of a row with one 8- or
//    16-byte load, dequantises them in registers and multiplies them into
//    up to 4 rows of x. The warps' sums meet in shared memory. When the
//    column tiles alone cannot fill the card, K is cut into `ksplit` chunks
//    whose partial sums go to a scratch buffer that `sum_splits` adds in a
//    fixed order, so results do not change from run to run.
//  * q as the transposed view of a row-major table, K contiguous
//    (`dqmm_rows`, the tied unembedding `embed.T`): one warp per output
//    column walks the contiguous K axis with 16-byte loads and reduces with
//    shuffles. The view is read in place: no transposed copy is made.
//
// Rounding: the weight is formed as fmul_rn(q, scale) then fadd_rn(., offset),
// two separately rounded float32 operations and no fused multiply-add, which
// is what the plain PyTorch version `q.float() * scale + offset` computes.
// Only the order of the float32 sum over K differs from the plain version.
// scale and offset are read from device memory, so a precision upgrade
// changes values, never the launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;   // warps per block in both kernels
constexpr int MT = 4;      // rows of x per block in dqmm_cols
constexpr int MR = 8;      // rows of x per block in dqmm_rows

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float dq(uint32_t qv, float scale, float offset) {
  return __fadd_rn(__fmul_rn((float)qv, scale), offset);
}

// V elements of q loaded as one 8- or 16-byte word.
template <typename TQ, int V>
union Lanes {
  uint4 u4;
  uint2 u2;
  TQ e[V];
};

// Columns per thread in dqmm_cols: an 8-byte load of uint8, 16 bytes otherwise.
template <typename TQ>
struct ColsVec {
  static constexpr int V = sizeof(TQ) == 1 ? 8 : 16 / sizeof(TQ);
};

template <typename TX, typename TQ, bool VEC>
__global__ void __launch_bounds__(256) dqmm_cols(
    const TX* __restrict__ x, const TQ* __restrict__ q, const float* __restrict__ scale_p,
    const float* __restrict__ offset_p, float* __restrict__ part, int M, int K, int N,
    long long sqk, long long sqn, int k_chunk) {
  constexpr int V = ColsVec<TQ>::V;
  __shared__ float red[WARPS][MT][V][32];
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int n0 = (blockIdx.x * 32 + lane) * V;
  const int m0 = blockIdx.z * MT;
  const int k_begin = blockIdx.y * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  const float scale = *scale_p, offset = *offset_p;

  float acc[MT][V];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < V; ++j) acc[m][j] = 0.f;

  for (int k = k_begin + warp; k < k_end; k += WARPS) {
    const TQ* row = q + (long long)k * sqk;
    float w[V];
    if constexpr (VEC) {
      Lanes<TQ, V> b;
      if (n0 < N) {
        if constexpr (V * sizeof(TQ) == 16)
          b.u4 = *reinterpret_cast<const uint4*>(row + n0);
        else
          b.u2 = *reinterpret_cast<const uint2*>(row + n0);
      } else {
        b.u4 = make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int j = 0; j < V; ++j) w[j] = dq((uint32_t)b.e[j], scale, offset);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int n = n0 + j;
        w[j] = n < N ? dq((uint32_t)row[(long long)n * sqn], scale, offset) : 0.f;
      }
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const float xv = (m0 + m < M) ? to_f(x[(long long)(m0 + m) * K + k]) : 0.f;
#pragma unroll
      for (int j = 0; j < V; ++j) acc[m][j] = fmaf(xv, w[j], acc[m][j]);
    }
  }

#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < V; ++j) red[warp][m][j][lane] = acc[m][j];
  __syncthreads();

  const int tid = warp * 32 + lane;
  for (int e = tid; e < MT * V * 32; e += WARPS * 32) {
    const int m = e / (V * 32), j = (e / 32) % V, l = e % 32;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += red[w][m][j][l];
    const int n = (blockIdx.x * 32 + l) * V + j;
    if (m0 + m < M && n < N)
      part[((long long)blockIdx.y * M + m0 + m) * N + n] = s;
  }
}

__global__ void __launch_bounds__(256) sum_splits(const float* __restrict__ part,
                                                  float* __restrict__ out, int ksplit,
                                                  long long mn) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < mn;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int sp = 0; sp < ksplit; ++sp) s += part[sp * mn + i];
    out[i] = s;
  }
}

template <typename TX, typename TQ, bool VEC>
__global__ void __launch_bounds__(256) dqmm_rows(
    const TX* __restrict__ x, const TQ* __restrict__ q, const float* __restrict__ scale_p,
    const float* __restrict__ offset_p, float* __restrict__ out, int M, int K, int N,
    long long sqn) {
  constexpr int V = 16 / sizeof(TQ);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = blockIdx.x * WARPS + warp;
  const int m0 = blockIdx.y * MR;
  if (n >= N) return;
  const float scale = *scale_p, offset = *offset_p;
  const TQ* col = q + (long long)n * sqn;

  float acc[MR];
#pragma unroll
  for (int m = 0; m < MR; ++m) acc[m] = 0.f;

  for (int k0 = lane * V; k0 < K; k0 += 32 * V) {
    float w[V];
    if constexpr (VEC) {
      Lanes<TQ, V> b;
      b.u4 = *reinterpret_cast<const uint4*>(col + k0);
#pragma unroll
      for (int j = 0; j < V; ++j) w[j] = dq((uint32_t)b.e[j], scale, offset);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j)
        w[j] = (k0 + j < K) ? dq((uint32_t)col[k0 + j], scale, offset) : 0.f;
    }
#pragma unroll
    for (int m = 0; m < MR; ++m) {
      if (m0 + m < M) {
        const TX* xr = x + (long long)(m0 + m) * K + k0;
#pragma unroll
        for (int j = 0; j < V; ++j)
          if (VEC || k0 + j < K) acc[m] = fmaf(to_f(xr[j]), w[j], acc[m]);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < MR; ++m) {
    float s = acc[m];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0 && m0 + m < M) out[(long long)(m0 + m) * N + n] = s;
  }
}

template <typename TX, typename TQ>
int launch(const void* xv, const void* qv, long long sqk, long long sqn, const float* scale,
           const float* offset, float* part, float* out, int M, int K, int N, int ksplit,
           cudaStream_t stream) {
  const TX* x = (const TX*)xv;
  const TQ* q = (const TQ*)qv;
  if (sqk == 1 && K > 1) {
    constexpr int V = 16 / sizeof(TQ);
    const bool vec = (K % V == 0) && (sqn % V == 0) && ((uintptr_t)q % 16 == 0);
    dim3 grid((N + WARPS - 1) / WARPS, (M + MR - 1) / MR);
    if (vec)
      dqmm_rows<TX, TQ, true><<<grid, WARPS * 32, 0, stream>>>(x, q, scale, offset, out, M, K, N, sqn);
    else
      dqmm_rows<TX, TQ, false><<<grid, WARPS * 32, 0, stream>>>(x, q, scale, offset, out, M, K, N, sqn);
    return (int)cudaGetLastError();
  }
  constexpr int V = ColsVec<TQ>::V;
  const int k_chunk = (K + ksplit - 1) / ksplit;
  const int splits = (K + k_chunk - 1) / k_chunk;
  float* dst = splits > 1 ? part : out;
  const bool vec = (sqn == 1) && (N % V == 0) && (sqk % V == 0) &&
                   ((uintptr_t)q % (V * sizeof(TQ)) == 0);
  dim3 grid((N + 32 * V - 1) / (32 * V), splits, (M + MT - 1) / MT);
  dim3 block(32, WARPS);
  if (vec)
    dqmm_cols<TX, TQ, true><<<grid, block, 0, stream>>>(x, q, scale, offset, dst, M, K, N, sqk, sqn, k_chunk);
  else
    dqmm_cols<TX, TQ, false><<<grid, block, 0, stream>>>(x, q, scale, offset, dst, M, K, N, sqk, sqn, k_chunk);
  int err = (int)cudaGetLastError();
  if (err || splits == 1) return err;
  const long long mn = (long long)M * N;
  long long blocks = (mn + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;
  sum_splits<<<(unsigned)blocks, 256, 0, stream>>>(part, out, splits, mn);
  return (int)cudaGetLastError();
}

template <typename TX>
int dispatch_q(const void* x, const void* q, int q_bytes, long long sqk, long long sqn,
               const float* scale, const float* offset, float* part, float* out, int M, int K,
               int N, int ksplit, cudaStream_t s) {
  switch (q_bytes) {
    case 1: return launch<TX, uint8_t>(x, q, sqk, sqn, scale, offset, part, out, M, K, N, ksplit, s);
    case 2: return launch<TX, uint16_t>(x, q, sqk, sqn, scale, offset, part, out, M, K, N, ksplit, s);
    case 4: return launch<TX, uint32_t>(x, q, sqk, sqn, scale, offset, part, out, M, K, N, ksplit, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x: (M, K) row-major, float32 (x_dtype 0) or bfloat16 (x_dtype 1).
// q: (K, N) with element strides (sqk, sqn), uint8/16/32 (q_bytes 1/2/4).
// scale, offset: one float32 each, in device memory.
// part: float32 scratch of ksplit * M * N (unused when ksplit == 1 or q is
// K-contiguous). out: (M, N) float32, row-major.
extern "C" int dequant_matmul(const void* x, int x_dtype, const void* q, int q_bytes,
                              long long sqk, long long sqn, const float* scale,
                              const float* offset, float* part, float* out, int M, int K,
                              int N, int ksplit, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (M <= 0 || N <= 0 || K <= 0 || ksplit <= 0) return (int)cudaErrorInvalidValue;
  switch (x_dtype) {
    case 0: return dispatch_q<float>(x, q, q_bytes, sqk, sqn, scale, offset, part, out, M, K, N, ksplit, s);
    case 1: return dispatch_q<__nv_bfloat16>(x, q, q_bytes, sqk, sqn, scale, offset, part, out, M, K, N, ksplit, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
