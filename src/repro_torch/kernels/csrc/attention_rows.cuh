// Ragged batched GQA attention of query rows against a slot's KV cache,
// with an online softmax: the body that flash_decode (decode_attention.cu,
// one token per slot) and flash_verify (verify_attention.cu, T tokens per
// slot) both instantiate.
//
// A row is one (token t, query head h) pair of a slot. The rows of one
// (slot, kv-head) are numbered t * G + g (G = H / Kh query heads per kv
// head, h = kv_head * G + g) and cut into tiles of R rows (R = 1, 2, 4 or
// 8, the least power of two that holds T * G, at most 8); a block takes
// one (slot, kv-head, tile). Decode is the case T = 1, where one tile
// holds the G heads of the slot's token: R = 1 for olmo's G = 1.
//
// Bound: device-memory bytes. The arithmetic per key is a rank-1 sliver
// per row, so each block reads its (slot, kv-head) cache row once. The
// block copies the cache in tiles of TK keys into shared memory with
// 16-byte asynchronous copies (cp.async), all in flight at once, so a
// tile costs about one memory latency. Four warps then take every fourth
// key of the tile; lanes split the head dimension (DPL = hd / 32 dims a
// lane, a template parameter) and each warp keeps its own (max,
// denominator, accumulator) per row in registers. The four partial states
// meet in shared memory at the end, combined in warp order. The order and
// the arithmetic of every sum do not depend on the tiling: each warp sees
// its keys in the order of the cache, one after another.
//
// Every rounding is spelled out (fmaf, __fmul_rn, no sum left for the
// compiler to contract), so a row's arithmetic is the same in every
// instantiation and whatever the other rows of its block hold: a verify
// row is bit-identical to a decode launch for that row's query and
// position. The spelled-out forms are those nvcc chooses for the plain
// expressions (l * corr + p, acc * corr + p * v), so a one-row loop over
// the keys written without them gives the same bits.
//
// Semantics are the reference's (src/repro/kernels/ref.py
// flash_decode_ref / flash_verify_ref): q is scaled by hd**-0.5 here, not
// by the caller; row j attends a key when k_pos >= 0, k_pos <= q_pos[j],
// q_pos[j] >= 0 and, with a window, k_pos > q_pos[j] - window; the softcap
// applies before the mask; masked scores are -1e30 and still enter the
// softmax, so a masked row comes out as the finite mean of V; the
// denominator is guarded by 1e-30.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn_rows {

constexpr int WARPS = 4;   // warps per block; each takes every WARPS-th key
constexpr int RMAX = 8;    // query rows per block, at most
constexpr int DPL_MAX = 8; // head dims per lane: hd <= 256
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f(float v, float* o) { *o = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* o) { *o = __float2bfloat16(v); }

// Shared memory of a block: one tile of K and V, reused for the partial
// states of the final combine.
constexpr int SMEM_BYTES = 32768;

// Keys a tile holds: K and V of TK keys fill SMEM_BYTES at hd = 32 * DPL.
template <typename T, int DPL>
struct Tile {
  static constexpr int TK = SMEM_BYTES / (2 * 32 * DPL * (int)sizeof(T));
  static_assert(TK % WARPS == 0, "a tile must hold whole rounds of keys");
  static_assert(WARPS * RMAX * 32 * DPL * (int)sizeof(float) <= SMEM_BYTES,
                "the partial states must fit the tile's shared memory");
};

__device__ __forceinline__ void copy16_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Element (b, t, h, d) of q and out lies at b * s_b + t * s_t + h * hd + d;
// q_pos[b, t] at b * qp_sb + t * qp_st; k_pos[b, s] at b * kp_sb + s * kp_ss.
// k and v are contiguous (B, Kh, S, hd).
template <typename T, int DPL, int R>
__global__ void __launch_bounds__(WARPS * 32) attention_rows_kernel(
    const T* __restrict__ q, long long q_sb, long long q_st, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ k_pos, long long kp_sb,
    long long kp_ss, const int* __restrict__ q_pos, long long qp_sb, long long qp_st,
    T* __restrict__ out, long long o_sb, long long o_st, int n_tok, int H, int Kh, int S,
    int hd, int tiles, int window, float softcap, float scale) {
  constexpr int TK = Tile<T, DPL>::TK;
  __shared__ __align__(16) unsigned char smem[SMEM_BYTES];
  __shared__ int sm_kp[TK];
  __shared__ float sm_m[WARPS][R], sm_l[WARPS][R];
  T* sk = reinterpret_cast<T*>(smem);                  // (TK, hd) keys of the tile
  T* sv = sk + TK * 32 * DPL;                          // (TK, hd) values
  const int per_b = Kh * tiles;
  const int b = blockIdx.x / per_b, kh = (blockIdx.x % per_b) / tiles;
  const int row0 = (blockIdx.x % tiles) * R;
  const int G = H / Kh;
  const int nrows = min(R, n_tok * G - row0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long kv_base = ((long long)b * Kh + kh) * (long long)S * hd;
  // whole rows of 16 bytes from 16-byte aligned caches copy as 16-byte chunks
  const bool vec = (hd * (int)sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0;

  // rows past nrows hold q = 0 and q_pos = -1: computed, never written
  float qr[R][DPL], acc[R][DPL], m[R], l[R];
  int qp[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int t = (row0 + j) / G, h = kh * G + (row0 + j) % G;
    const T* qrow = q + (long long)b * q_sb + (long long)t * q_st + (long long)h * hd;
    qp[j] = j < nrows ? q_pos[(long long)b * qp_sb + (long long)t * qp_st] : -1;
    m[j] = NEG_INF;
    l[j] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      qr[j][i] = (j < nrows && d < hd) ? to_f(qrow[d]) * scale : 0.f;
      acc[j][i] = 0.f;
    }
  }

  for (int t0 = 0; t0 < S; t0 += TK) {
    const int nk = min(TK, S - t0);
    const T* gk = k + kv_base + (long long)t0 * hd;
    const T* gv = v + kv_base + (long long)t0 * hd;
    if (vec) {
      constexpr int PER = 16 / (int)sizeof(T);         // elements per chunk
      for (int e = threadIdx.x * PER; e < nk * hd; e += WARPS * 32 * PER) {
        copy16_async(sk + e, gk + e);
        copy16_async(sv + e, gv + e);
      }
    } else {
      for (int e = threadIdx.x; e < nk * hd; e += WARPS * 32) {
        sk[e] = gk[e];
        sv[e] = gv[e];
      }
    }
    for (int e = threadIdx.x; e < nk; e += WARPS * 32)
      sm_kp[e] = k_pos[b * kp_sb + (long long)(t0 + e) * kp_ss];
    wait_async();
    __syncthreads();

#pragma unroll 4
    for (int s = warp; s < nk; s += WARPS) {           // this warp's keys, in order
      const int kp = sm_kp[s];
      float kv[DPL], vv[DPL];
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        kv[i] = d < hd ? to_f(sk[s * hd + d]) : 0.f;
        vv[i] = d < hd ? to_f(sv[s * hd + d]) : 0.f;
      }
      // the R scores in one straight run (no branch between rows), so the
      // rows' shuffle chains overlap
      float sc[R];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        sc[j] = 0.f;
#pragma unroll
        for (int i = 0; i < DPL; ++i) sc[j] = fmaf(qr[j][i], kv[i], sc[j]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
        for (int j = 0; j < R; ++j) sc[j] += __shfl_xor_sync(0xffffffffu, sc[j], o);
      }
      if (softcap != 0.f) {
#pragma unroll
        for (int j = 0; j < R; ++j) sc[j] = tanhf(sc[j] / softcap) * softcap;
      }
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const bool valid = kp >= 0 && kp <= qp[j] && qp[j] >= 0 &&
                           (window == 0 || kp > qp[j] - window);
        const float x = valid ? sc[j] : NEG_INF;
        const float m_new = fmaxf(m[j], x);
        const float p = expf(x - m_new);
        const float corr = expf(m[j] - m_new);
        l[j] = fmaf(l[j], corr, p);
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[j][i] = fmaf(acc[j][i], corr, __fmul_rn(p, vv[i]));
        m[j] = m_new;
      }
    }
    __syncthreads();                                   // the tile is free again
  }

  // the partial states reuse the tile's shared memory
  float(*sm_acc)[R][32 * DPL] = reinterpret_cast<float(*)[R][32 * DPL]>(smem);
#pragma unroll
  for (int j = 0; j < R; ++j) {
    if (j < nrows) {
      if (lane == 0) {
        sm_m[warp][j] = m[j];
        sm_l[warp][j] = l[j];
      }
#pragma unroll
      for (int i = 0; i < DPL; ++i) sm_acc[warp][j][lane + 32 * i] = acc[j][i];
    }
  }
  __syncthreads();

  for (int e = threadIdx.x; e < nrows * hd; e += WARPS * 32) {
    const int j = e / hd, d = e % hd;
    const int t = (row0 + j) / G, h = kh * G + (row0 + j) % G;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, sm_m[w][j]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float c = expf(sm_m[w][j] - mx);
      den = fmaf(sm_l[w][j], c, den);
      num = fmaf(sm_acc[w][j][d], c, num);
    }
    from_f(num / fmaxf(den, 1e-30f),
           out + (long long)b * o_sb + (long long)t * o_st + (long long)h * hd + d);
  }
}

template <typename T, int DPL, int R>
void launch_as(const void* q, long long q_sb, long long q_st, const void* k, const void* v,
               const int* k_pos, long long kp_sb, long long kp_ss, const int* q_pos,
               long long qp_sb, long long qp_st, void* out, long long o_sb, long long o_st,
               unsigned grid, int n_tok, int H, int Kh, int S, int hd, int tiles, int window,
               float softcap, float scale, cudaStream_t stream) {
  attention_rows_kernel<T, DPL, R><<<grid, WARPS * 32, 0, stream>>>(
      (const T*)q, q_sb, q_st, (const T*)k, (const T*)v, k_pos, kp_sb, kp_ss, q_pos, qp_sb,
      qp_st, (T*)out, o_sb, o_st, n_tok, H, Kh, S, hd, tiles, window, softcap, scale);
}

#define ATTN_ROWS_ARGS                                                                    \
  q, q_sb, q_st, k, v, k_pos, kp_sb, kp_ss, q_pos, qp_sb, qp_st, out, o_sb, o_st, grid,   \
      n_tok, H, Kh, S, hd, tiles, window, softcap, scale, stream
#define ATTN_ROWS_PARAMS                                                                  \
  const void *q, long long q_sb, long long q_st, const void *k, const void *v,            \
      const int *k_pos, long long kp_sb, long long kp_ss, const int *q_pos,               \
      long long qp_sb, long long qp_st, void *out, long long o_sb, long long o_st,        \
      unsigned grid, int n_tok, int H, int Kh, int S, int hd, int tiles, int window,      \
      float softcap, float scale, cudaStream_t stream

// rows per block R, then head dims per lane DPL, as template parameters
template <typename T, int DPL>
void launch_rows(int rows, ATTN_ROWS_PARAMS) {
  if (rows == 1) launch_as<T, DPL, 1>(ATTN_ROWS_ARGS);
  else if (rows == 2) launch_as<T, DPL, 2>(ATTN_ROWS_ARGS);
  else if (rows == 4) launch_as<T, DPL, 4>(ATTN_ROWS_ARGS);
  else launch_as<T, DPL, 8>(ATTN_ROWS_ARGS);
}

template <typename T>
void launch_dpl(int rows, ATTN_ROWS_PARAMS) {
  if (hd <= 32) launch_rows<T, 1>(rows, ATTN_ROWS_ARGS);
  else if (hd <= 64) launch_rows<T, 2>(rows, ATTN_ROWS_ARGS);
  else if (hd <= 128) launch_rows<T, 4>(rows, ATTN_ROWS_ARGS);
  else launch_rows<T, 8>(rows, ATTN_ROWS_ARGS);
}

// Launch over B slots of n_tok rows each: dtype 0 is float32, 1 bfloat16.
// Returns cudaGetLastError() after the launch.
inline int launch(const void* q, long long q_sb, long long q_st, const void* k,
                  const void* v, const int* k_pos, long long kp_sb, long long kp_ss,
                  const int* q_pos, long long qp_sb, long long qp_st, void* out,
                  long long o_sb, long long o_st, int B, int n_tok, int H, int Kh, int S,
                  int hd, int window, float softcap, float scale, int dtype,
                  cudaStream_t stream) {
  if (B <= 0 || n_tok <= 0 || Kh <= 0 || H % Kh || hd <= 0 || hd > DPL_MAX * 32)
    return (int)cudaErrorInvalidValue;
  const int n_rows = n_tok * (H / Kh);                 // rows per (slot, kv-head)
  const int rows = n_rows <= 1 ? 1 : n_rows <= 2 ? 2 : n_rows <= 4 ? 4 : RMAX;
  const int tiles = (n_rows + rows - 1) / rows;
  const unsigned grid = (unsigned)(B * Kh * tiles);
  switch (dtype) {
    case 0:
      launch_dpl<float>(rows, ATTN_ROWS_ARGS);
      break;
    case 1:
      launch_dpl<__nv_bfloat16>(rows, ATTN_ROWS_ARGS);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

#undef ATTN_ROWS_ARGS
#undef ATTN_ROWS_PARAMS

}  // namespace attn_rows
