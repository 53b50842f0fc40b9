// Ragged batched GQA decode attention: one new query token per slot
// against the slot's KV cache, with an online softmax.
//
// Replaces src/repro/kernels/decode_attention.py `flash_decode` (the Pallas
// `_kernel`). Bound: device-memory bytes. Every cache byte of K and V is read
// once per decode step while the arithmetic is a rank-1 sliver per key, so
// the design reads each (b, kv-head) cache row exactly once: one block per
// (b, kv-head), four warps that take every fourth key, lanes that split the
// head dimension so a warp reads a key row with coalesced loads. Each warp
// keeps its own (max, denominator, accumulator) per query head of the group
// in registers; the four partial states meet in shared memory at the end.
//
// Semantics are the reference's (src/repro/kernels/ref.py flash_decode_ref):
// q is scaled by hd**-0.5 here, not by the caller; a key is valid when
// k_pos >= 0, k_pos <= q_pos and, with a window, k_pos > q_pos - window;
// the softcap applies before the mask; masked scores are -1e30 and still
// enter the softmax, so a free slot (q_pos < 0, every key masked) comes out
// as the finite mean of V, as in the reference; the denominator is guarded
// by 1e-30.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;   // warps per block; each takes every WARPS-th key
constexpr int GMAX = 8;    // query heads per kv head
constexpr int DPL = 8;     // head dims per lane: hd <= 256
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f(float v, float* o) { *o = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* o) { *o = __float2bfloat16(v); }

template <typename T>
__global__ void __launch_bounds__(WARPS * 32) flash_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ k_pos, long long kp_sb, long long kp_ss,
    const int* __restrict__ q_pos, T* __restrict__ out, int H, int Kh, int S, int hd,
    int window, float softcap, float scale) {
  __shared__ float sm_m[WARPS][GMAX], sm_l[WARPS][GMAX];
  __shared__ float sm_acc[WARPS][GMAX][DPL * 32];
  const int b = blockIdx.x / Kh, kh = blockIdx.x % Kh;
  const int G = H / Kh;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int qp = q_pos[b];
  const long long q_base = ((long long)b * H + (long long)kh * G) * hd;
  const long long kv_base = ((long long)b * Kh + kh) * (long long)S * hd;

  float qr[GMAX][DPL], acc[GMAX][DPL], m[GMAX], l[GMAX];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      qr[g][i] = (g < G && d < hd) ? to_f(q[q_base + (long long)g * hd + d]) * scale : 0.f;
      acc[g][i] = 0.f;
    }
  }

  for (int s = warp; s < S; s += WARPS) {
    const int kp = k_pos[b * kp_sb + s * kp_ss];
    const bool valid = kp >= 0 && kp <= qp && (window == 0 || kp > qp - window);
    const T* kr = k + kv_base + (long long)s * hd;
    const T* vr = v + kv_base + (long long)s * hd;
    float kv[DPL], vv[DPL];
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      kv[i] = d < hd ? to_f(kr[d]) : 0.f;
      vv[i] = d < hd ? to_f(vr[d]) : 0.f;
    }
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g < G) {
        float sc = 0.f;
#pragma unroll
        for (int i = 0; i < DPL; ++i) sc = fmaf(qr[g][i], kv[i], sc);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) sc += __shfl_xor_sync(0xffffffffu, sc, o);
        if (softcap != 0.f) sc = tanhf(sc / softcap) * softcap;
        if (!valid) sc = NEG_INF;
        const float m_new = fmaxf(m[g], sc);
        const float p = expf(sc - m_new);
        const float corr = expf(m[g] - m_new);
        l[g] = l[g] * corr + p;
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[g][i] = acc[g][i] * corr + p * vv[i];
        m[g] = m_new;
      }
    }
  }

#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g < G) {
      if (lane == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
#pragma unroll
      for (int i = 0; i < DPL; ++i) sm_acc[warp][g][lane + 32 * i] = acc[g][i];
    }
  }
  __syncthreads();

  for (int e = threadIdx.x; e < G * hd; e += WARPS * 32) {
    const int g = e / hd, d = e % hd;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float c = expf(sm_m[w][g] - mx);
      den += sm_l[w][g] * c;
      num += sm_acc[w][g][d] * c;
    }
    from_f(num / fmaxf(den, 1e-30f), out + q_base + (long long)g * hd + d);
  }
}

}  // namespace

// q: (B, H, hd); k, v: (B, Kh, S, hd), all contiguous and of one dtype,
// float32 (dtype 0) or bfloat16 (dtype 1). k_pos: int32 (B, S) with element
// strides (kp_sb, kp_ss); q_pos: int32 (B,). out: (B, H, hd) in q's dtype.
// scale is hd**-0.5 rounded to float32, as the plain version computes it.
// H % Kh == 0, H / Kh <= 8, hd <= 256.
extern "C" int flash_decode(const void* q, const void* k, const void* v, const int* k_pos,
                            long long kp_sb, long long kp_ss, const int* q_pos, void* out,
                            int B, int H, int Kh, int S, int hd, int window, float softcap,
                            float scale, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B <= 0 || Kh <= 0 || H % Kh || H / Kh > GMAX || hd <= 0 || hd > DPL * 32)
    return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)(B * Kh);
  switch (dtype) {
    case 0:
      flash_decode_kernel<float><<<grid, WARPS * 32, 0, s>>>(
          (const float*)q, (const float*)k, (const float*)v, k_pos, kp_sb, kp_ss, q_pos,
          (float*)out, H, Kh, S, hd, window, softcap, scale);
      break;
    case 1:
      flash_decode_kernel<__nv_bfloat16><<<grid, WARPS * 32, 0, s>>>(
          (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, k_pos,
          kp_sb, kp_ss, q_pos, (__nv_bfloat16*)out, H, Kh, S, hd, window, softcap, scale);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
