// Ragged batched GQA attention of query rows against a slot's KV cache,
// with an online softmax: the body that flash_decode (decode_attention.cu,
// one token per slot) and flash_verify (verify_attention.cu, T tokens per
// slot) both instantiate.
//
// A row is one (token t, query head h) pair of a slot. The rows of one
// (slot, kv-head) are numbered t * G + g (G = H / Kh query heads per kv
// head, h = kv_head * G + g) and cut into tiles of R rows (R = 1, 2, 4 or
// 8, the least power of two that holds T * G, at most 8); a block takes
// one (slot, kv-head, tile). Decode is the case T = 1, where one tile holds
// the G heads of the slot's token: R = 1 for olmo's G = 1.
//
// Bound: device-memory bytes. The arithmetic per key is a rank-1 sliver
// per row, so each block reads its (slot, kv-head) cache row once. What
// held the first version back was latency, not bytes: a warp took one key
// at a time with its lanes on the head dimension, so every key cost each
// row a chain of 5 dependent shuffles and a serial softmax update, and a
// tile of keys was loaded and waited for before any warp computed on it.
// This version, on CUDA cores only (no tensor cores, no clusters, the
// same grid):
//
// - Staging. Keys are cut into chunks of CHUNK = 32. A copy warp (the
//   block's ninth) hands each chunk's K rows, then its V rows, to the
//   tensor memory accelerator, one copy a chunk half, into a ring of slots
//   in dynamic shared memory (chunk c in slot c % nslot); each half
//   completes an mbarrier when its bytes have landed, and a slot is refilled
//   once the warp that read it arrives on the slot's empty barrier. So the
//   scores of a chunk start as soon as its K has landed, while V and later
//   chunks are still arriving; the copies never stall a compute warp, and
//   no block-wide barrier stands between chunks. All K halves go first, in
//   chunk order. When the whole (slot, kv-head) range fits (S = 160 and 112
//   in bfloat16 at hd = 128: 5 and 4 chunks) every chunk is in flight at
//   once; a longer S, or float32 at hd = 256, cycles through the ring.
//   Rows land with the copy engine's 128-byte swizzle (16-byte unit u of
//   128-byte line L at u ^ (L % 8)), so 32 lanes reading 16 bytes each of
//   32 different rows hit distinct banks. Caches whose rows are not whole
//   128-byte multiples (hd * size % 128: hd = 16 or 32 in bfloat16, say)
//   are copied into the same layout by the copy warp's lanes.
// - Scores, one key per lane. Lane l of the warp owning chunk c takes key
//   32 c + l and computes its full dot product with each of the R rows: q,
//   scaled and in float32, is read from shared memory by broadcast. The
//   chunk's max and its sum of p cost one shuffle tree per row per chunk,
//   not per key. P.V then puts the lanes back on the head dimension (DPL
//   contiguous dims a lane) and adds the chunk's 32 keys in cache order,
//   p reaching every lane by broadcast from shared memory.
// - 8 compute warps a block: chunk c belongs to warp c % 8, so each warp
//   sees its chunks in cache order. The warps' partial (max, denominator,
//   accumulator) states meet in shared memory at the end, combined in warp
//   order. With 5 or 6 chunks in all (the pool's S = 160), warps 4-7 take
//   the fifth and sixth a part of their rows each, so that no SM
//   sub-partition carries two whole chunks while another carries one.
//
// A row's arithmetic depends on S, hd and the dtype and on nothing else:
// how keys split into chunks and warps, the order of every sum (a score is
// 4 partial sums over the dims d % 4, in d order, added as a fixed tree)
// and the order of the combine. It does not depend on B, T, G, R, the
// row's place in its tile, the ring's size, the copy path, which warp
// computes it or the grid, and every rounding is spelled out (fmaf,
// __fmul_rn, __fadd_rn, no sum left for the compiler to contract), so a
// verify row is bit-identical to a decode launch for that row's query and
// position.
//
// Semantics are the reference's (src/repro/kernels/ref.py
// flash_decode_ref / flash_verify_ref): q is scaled by hd**-0.5 here, not
// by the caller; row j attends a key when k_pos >= 0, k_pos <= q_pos[j],
// q_pos[j] >= 0 and, with a window, k_pos > q_pos[j] - window; the softcap
// applies before the mask; masked scores are -1e30 and still enter the
// softmax, so a masked row comes out as the finite mean of V; the
// denominator is guarded by 1e-30.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace attn_rows {
// internal linkage: each library that includes this header keeps its own
// instantiations, and with them its own cudaFuncSetAttribute guards
namespace {

constexpr int WARPS = 8;           // compute warps a block; warp w takes chunks c % 8 == w
constexpr int THREADS = WARPS * 32;           // the compute warps' threads
constexpr int BLOCK = THREADS + 32;           // and one copy warp
constexpr int CHUNK = 32;          // keys a chunk, one a lane
constexpr int NP = 4;              // partial sums of a score, over the dims d % NP
constexpr int ROW = 128;           // bytes of a staged line (the swizzle's span)
constexpr int TILE = CHUNK * ROW;  // bytes of a chunk's rows a line each
constexpr int RMAX = 8;            // query rows per block, at most
constexpr int DPL_MAX = 8;         // head dims per lane in P.V: hd <= 256
constexpr int SMEM_MAX = 232448;   // dynamic shared memory a block may use (227 KB)
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f(float v, float* o) { *o = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* o) { *o = __float2bfloat16(v); }

// N consecutive elements from shared memory as float (N * sizeof(T)
// bytes, aligned to that or to 16 bytes)
__device__ __forceinline__ void split_bf16x2(unsigned w, float* o) {
  o[0] = __uint_as_float(w << 16);
  o[1] = __uint_as_float(w & 0xffff0000u);
}

template <int N>
__device__ __forceinline__ void load_f(const float* p, float* o) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + i);
      o[i] = t.x, o[i + 1] = t.y, o[i + 2] = t.z, o[i + 3] = t.w;
    }
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    o[0] = t.x, o[1] = t.y;
  } else {
    o[0] = p[0];
  }
}

template <int N>
__device__ __forceinline__ void load_f(const __nv_bfloat16* p, float* o) {
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 8) {
      const uint4 t = *reinterpret_cast<const uint4*>(p + i);
      split_bf16x2(t.x, o + i);
      split_bf16x2(t.y, o + i + 2);
      split_bf16x2(t.z, o + i + 4);
      split_bf16x2(t.w, o + i + 6);
    }
  } else if constexpr (N == 4) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    split_bf16x2(t.x, o);
    split_bf16x2(t.y, o + 2);
  } else if constexpr (N == 2) {
    split_bf16x2(*reinterpret_cast<const unsigned*>(p), o);
  } else {
    o[0] = __bfloat162float(p[0]);
  }
}

// N consecutive floats to shared memory (aligned to N * 4 or 16 bytes)
template <int N>
__device__ __forceinline__ void store_f(float* p, const float* o) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4)
      *reinterpret_cast<float4*>(p + i) = make_float4(o[i], o[i + 1], o[i + 2], o[i + 3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(o[0], o[1]);
  } else {
    p[0] = o[0];
  }
}

// Byte offset, within a half slot (K or V of a chunk), of byte `byte` of
// staged row r whose rows are w 128-byte lines each: line L = r * w +
// byte / 128, its 16-byte units swizzled by L % 8 (the layout the copy
// engine's 128-byte swizzle writes).
__device__ __forceinline__ int swz(int r, int byte, int w) {
  const int u = byte >> 4, line = r * w + (u >> 3);
  return line * ROW + (((u & 7) ^ (line & 7)) << 4) + (byte & 15);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// An mbarrier with one expected arrival a phase: a full barrier completes
// when its bytes have landed, an empty barrier when its slot was read.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}

// One chunk's rows (32 keys from key y of cache row z, whole rows) from a
// 4-d tensor map into shared memory, counted on bar; keys past S land as
// zeros.
__device__ __forceinline__ void copy_rows_async(void* dst, const CUtensorMap* map, int y, int z,
                                                uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(y), "r"(z), "r"(smem_u32(bar))
      : "memory");
}

// Order this thread's earlier shared-memory accesses before the copy
// engine's later writes (a slot is refilled after it was read).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Dynamic shared memory of a block with nslot ring slots, from a
// 1024-byte aligned base: the ring (nslot chunks, each the K then the V
// half, 32 rows of at most TILES lines; reused for the warps' partial
// accumulators at the end), scaled q (R, HDP) float32, mbarriers (K full
// and V full a slot,
// then empty a slot and as many unused, for 16-byte alignment), p of each
// warp's chunk (WARPS, R, CHUNK), the warps' max and denominator (WARPS, R)
// each, q positions (R), the chunk each slot holds or is filling (nslot).
template <typename T, int DPL, int R>
struct Geo {
  static constexpr int HDP = 32 * DPL;                       // hd rounded up, zero-padded
  static constexpr int TILES = (HDP * (int)sizeof(T) + ROW - 1) / ROW;   // a half slot's
  static constexpr int HALF = TILES * TILE;
  static constexpr int SLOT = 2 * HALF;
  static constexpr int COMB = WARPS * R * HDP * (int)sizeof(float);
  static constexpr int FIXED =
      (R * HDP + WARPS * R * CHUNK + 2 * WARPS * R) * (int)sizeof(float) + R * (int)sizeof(int);
  __host__ __device__ static constexpr int ring(int nslot) {
    return nslot * SLOT > COMB ? nslot * SLOT : COMB;
  }
  // with 1024 bytes to align the base
  __host__ __device__ static constexpr int bytes(int nslot) {
    return 1024 + ring(nslot) + FIXED + nslot * (4 * (int)sizeof(uint64_t) + (int)sizeof(int));
  }
};

// Element (b, t, h, d) of q and out lies at b * s_b + t * s_t + h * hd + d;
// q_pos[b, t] at b * qp_sb + t * qp_st; k_pos[b, s] at b * kp_sb + s * kp_ss.
// k and v are contiguous (B, Kh, S, hd); tmk and tmv map them for the copy
// engine when `tma` (rows of whole 128-byte multiples), else the copy
// warp's lanes copy them. Chunk c lives in ring slot c % nslot; nslot
// (every chunk, or as many as fit) changes no row's arithmetic.
template <typename T, int DPL, int R>
__global__ void __launch_bounds__(BLOCK, 1) attention_rows_kernel(
    const __grid_constant__ CUtensorMap tmk, const __grid_constant__ CUtensorMap tmv, bool tma,
    const T* __restrict__ q, long long q_sb, long long q_st, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ k_pos, long long kp_sb,
    long long kp_ss, const int* __restrict__ q_pos, long long qp_sb, long long qp_st,
    T* __restrict__ out, long long o_sb, long long o_st, int n_tok, int H, int Kh, int S,
    int hd, int tiles, int window, float softcap, float scale, int nslot) {
  using Gm = Geo<T, DPL, R>;
  constexpr int HDP = Gm::HDP, KU = 16 / (int)sizeof(T);   // dims a 16-byte unit
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ring = smem;
  float* sq = reinterpret_cast<float*>(smem + Gm::ring(nslot));
  uint64_t* full = reinterpret_cast<uint64_t*>(sq + R * HDP);   // (nslot, 2): K, V landed
  uint64_t* empty = full + 2 * nslot;                          // (nslot): slot read
  float* sp = reinterpret_cast<float*>(empty + 2 * nslot);     // 16-byte aligned
  float* sm_m = sp + WARPS * R * CHUNK;
  float* sm_l = sm_m + WARPS * R;
  int* sqp = reinterpret_cast<int*>(sm_l + WARPS * R);
  volatile int* stag = sqp + R;

  const int per_b = Kh * tiles;
  const int b = blockIdx.x / per_b, kh = (blockIdx.x % per_b) / tiles;
  const int row0 = (blockIdx.x % tiles) * R;
  const int G = H / Kh;
  const int nrows = min(R, n_tok * G - row0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nchunks = (S + CHUNK - 1) / CHUNK;
  // 128-byte lines a staged row: hd's own when the copy engine stages the
  // cache, else HDP's (zero-filled past hd by the copy warp)
  const int lines = tma ? hd * (int)sizeof(T) / ROW : Gm::TILES;
  const int dims = min(HDP, lines * ROW / (int)sizeof(T));    // staged dims a row

  // compute warps: q's elements and positions of this block's rows, loaded
  // now and stored once the copies are under way (rows past nrows hold
  // q = 0 and q_pos = -1: computed, never written)
  constexpr int QPT = (R * HDP + THREADS - 1) / THREADS;
  T qv[QPT];              // converted once stored: a wait here would hold barrier 2
  int qpv = -1;
  if (warp < WARPS) {
#pragma unroll
    for (int it = 0; it < QPT; ++it) {
      const int e = threadIdx.x + it * THREADS, j = e / HDP, d = e % HDP;
      from_f(0.f, &qv[it]);
      if (e < R * HDP && j < nrows && d < hd) {
        const int t = (row0 + j) / G, h = kh * G + (row0 + j) % G;
        qv[it] = q[(long long)b * q_sb + (long long)t * q_st + (long long)h * hd + d];
      }
    }
    if (threadIdx.x < nrows) {
      const int t = (row0 + threadIdx.x) / G;
      qpv = q_pos[(long long)b * qp_sb + (long long)t * qp_st];
    }
  }
  if (warp == WARPS) {
    // The copy warp: every chunk in order, K before V, into its slot; a
    // slot is refilled once the warp that read it has arrived on its empty
    // barrier. It sets up the barriers and starts at once: the compute
    // warps wait for its arrival (barrier 2) only before their first wait.
    for (int i = lane; i < nslot; i += 32) {
      mbar_init(full + 2 * i);
      mbar_init(full + 2 * i + 1);
      mbar_init(empty + i);
      stag[i] = -1;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    __syncwarp();
    asm volatile("bar.arrive 2, %0;\n" ::"n"(BLOCK) : "memory");
    const long long zrow = (long long)b * Kh + kh;
    if (tma && lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tmk)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tmv)) : "memory");
    }
    // chunks [c0, c1) into their slots, the K halves first and in chunk
    // order, so the first chunks' K lands first (tiles handed over in
    // parallel arrive together, later on the whole)
    auto issue = [&](int c0, int c1) {
      if (lane == 0)
        for (int c = c0; c < c1; ++c) {
          const int slot = c % nslot;
          stag[slot] = c;
          if (tma) {
            mbar_expect(full + slot * 2, lines * TILE);
            mbar_expect(full + slot * 2 + 1, lines * TILE);
          }
        }
      __syncwarp();
      if (tma) {
        if (lane == 0)
          for (int half = 0; half < 2; ++half)
            for (int c = c0; c < c1; ++c) {
              const int slot = c % nslot;
              copy_rows_async(ring + (slot * 2 + half) * Gm::HALF, half ? &tmv : &tmk,
                              c * CHUNK, (int)zrow, full + slot * 2 + half);
            }
        return;
      }
      // rows of other widths, by the lanes: zeros, then the rows that exist
      for (int half = 0; half < 2; ++half)
        for (int c = c0; c < c1; ++c) {
          const int slot = c % nslot, r0 = c * CHUNK, nk = min(CHUNK, S - r0);
          unsigned char* dst = ring + (slot * 2 + half) * Gm::HALF;
          for (int e = lane; e < Gm::HALF / 16; e += 32)
            *reinterpret_cast<uint4*>(dst + e * 16) = make_uint4(0, 0, 0, 0);
          __syncwarp();
          const T* src = (half ? v : k) + (zrow * S + r0) * hd;
          for (int e = lane; e < nk * hd; e += 32) {
            const int r = e / hd;
            *reinterpret_cast<T*>(dst + swz(r, (e - r * hd) * (int)sizeof(T), lines)) = src[e];
          }
          __syncwarp();
          if (lane == 0) mbar_expect(full + slot * 2 + half, 0);
        }
    };
    const int first = min(nslot, nchunks);
    issue(0, first);
    for (int c = first; c < nchunks; ++c) {
      mbar_wait(empty + c % nslot, (c / nslot - 1) & 1);
      fence_async_shared();
      issue(c, c + 1);
    }
  } else {
    asm volatile("bar.sync 2, %0;\n" ::"n"(BLOCK) : "memory");   // the barriers are set
#pragma unroll
    for (int it = 0; it < QPT; ++it) {
      const int e = threadIdx.x + it * THREADS;
      if (e < R * HDP) sq[e] = __fmul_rn(to_f(qv[it]), scale);
    }
    if (threadIdx.x < R) sqp[threadIdx.x] = qpv;
    // the k position of this lane's key in chunk c (-1 past the cache end)
    auto key_pos = [&](int c) {
      const int s = c * CHUNK + lane;
      return c < nchunks && s < S ? k_pos[b * kp_sb + (long long)s * kp_ss] : -1;
    };
    asm volatile("bar.sync 1, %0;\n" ::"n"(THREADS) : "memory");   // the compute warps

    // Rows [j0, j0 + RR) of chunks c0, c0 + step, ... (each of them its
    // logical warp's, c % WARPS), their states left in sm_* as logical warp
    // lw's once every compute warp is done with the ring.
    float* sm_acc = reinterpret_cast<float*>(ring);    // (WARPS, R, HDP), after the ring
    auto run = [&](auto rows, int c0, int step, int j0, int lw) {
      constexpr int RR = decltype(rows)::value;
      float acc[RR][DPL], m[RR], l[RR];
#pragma unroll
      for (int j = 0; j < RR; ++j) {
        m[j] = NEG_INF;
        l[j] = 0.f;
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[j][i] = 0.f;
      }
      int kp_next = key_pos(c0);
      for (int c = c0; c < nchunks; c += step) {
        const int slot = c % nslot;
        const unsigned parity = (c / nslot) & 1;
        const unsigned char* sk = ring + slot * Gm::SLOT;
        const unsigned char* sv = sk + Gm::HALF;
        const bool exists = c * CHUNK + lane < S;
        const int kp = kp_next;
        kp_next = key_pos(c + step);
        // once the slot's tag names this chunk, its barriers' phases are
        // this chunk's (a warp may come to a slot two fillings late)
        while (stag[slot] != c) {
        }
        mbar_wait(full + slot * 2, parity);            // K landed

        // the scores of this lane's key: NP partial sums over d % NP
        float part[RR][NP];
#pragma unroll
        for (int j = 0; j < RR; ++j)
#pragma unroll
          for (int u = 0; u < NP; ++u) part[j][u] = 0.f;
#pragma unroll 4
        for (int d0 = 0; d0 < dims; d0 += KU) {
          float kf[KU];
          load_f<KU>(reinterpret_cast<const T*>(sk + swz(lane, d0 * (int)sizeof(T), lines)), kf);
#pragma unroll
          for (int j = 0; j < RR; ++j) {
            float qf[KU];
            load_f<KU>(sq + (j0 + j) * HDP + d0, qf);
#pragma unroll
            for (int u = 0; u < KU; ++u) part[j][u % NP] = fmaf(qf[u], kf[u], part[j][u % NP]);
          }
        }
        float x[RR], mc[RR];
#pragma unroll
        for (int j = 0; j < RR; ++j) {
          float sc = __fadd_rn(__fadd_rn(part[j][0], part[j][1]),
                               __fadd_rn(part[j][2], part[j][3]));
          if (softcap != 0.f) sc = __fmul_rn(tanhf(__fdiv_rn(sc, softcap)), softcap);
          const int qp = sqp[j0 + j];
          const bool valid =
              kp >= 0 && kp <= qp && qp >= 0 && (window == 0 || kp > qp - window);
          // a lane past the cache end holds no key: -inf, so p = 0
          x[j] = exists ? (valid ? sc : NEG_INF) : __int_as_float(0xff800000);
          mc[j] = x[j];
        }
        // one max tree and one sum tree a row a chunk; every lane ends with
        // the same bits
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
#pragma unroll
          for (int j = 0; j < RR; ++j)
            mc[j] = fmaxf(mc[j], __shfl_xor_sync(0xffffffffu, mc[j], o));
        float ps[RR], corr[RR];
#pragma unroll
        for (int j = 0; j < RR; ++j) {
          const float m_new = fmaxf(m[j], mc[j]);
          ps[j] = expf(x[j] - m_new);
          corr[j] = expf(m[j] - m_new);
          m[j] = m_new;
          sp[(warp * R + j) * CHUNK + lane] = ps[j];
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
#pragma unroll
          for (int j = 0; j < RR; ++j)
            ps[j] = __fadd_rn(ps[j], __shfl_xor_sync(0xffffffffu, ps[j], o));
#pragma unroll
        for (int j = 0; j < RR; ++j) {
          l[j] = fmaf(l[j], corr[j], ps[j]);
#pragma unroll
          for (int i = 0; i < DPL; ++i) acc[j][i] = __fmul_rn(acc[j][i], corr[j]);
        }
        __syncwarp();                                  // every lane's p is written
        mbar_wait(full + slot * 2 + 1, parity);        // V landed

        // P.V: lanes on DPL contiguous dims, the chunk's keys in cache order
        constexpr int VB = DPL * (int)sizeof(T);        // bytes of a lane's dims
        constexpr int VU = VB < 16 ? VB : 16;           // read at once
#pragma unroll 2
        for (int s0 = 0; s0 < CHUNK; s0 += 4) {
          float vf[4][DPL];
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int i = 0; i < VB; i += VU)
              load_f<VU / (int)sizeof(T)>(
                  reinterpret_cast<const T*>(sv + swz(s0 + u, lane * VB + i, lines)),
                  vf[u] + i / (int)sizeof(T));
#pragma unroll
          for (int j = 0; j < RR; ++j) {
            float pf[4];
            load_f<4>(sp + (warp * R + j) * CHUNK + s0, pf);
#pragma unroll
            for (int u = 0; u < 4; ++u)
#pragma unroll
              for (int i = 0; i < DPL; ++i) acc[j][i] = fmaf(pf[u], vf[u][i], acc[j][i]);
          }
        }
        __syncwarp();                                  // the slot and sp are read
        if (lane == 0 && c + nslot < nchunks) mbar_arrive(empty + slot);
      }
      // the partial states wait in registers until the ring is free
      asm volatile("bar.sync 1, %0;\n" ::"n"(THREADS) : "memory");
#pragma unroll
      for (int j = 0; j < RR; ++j) {
        if (lane == 0) {
          sm_m[lw * R + j0 + j] = m[j];
          sm_l[lw * R + j0 + j] = l[j];
        }
        store_f<DPL>(sm_acc + (lw * R + j0 + j) * HDP + lane * DPL, acc[j]);
      }
    };

    // Chunk c is logical warp c % WARPS's, whose rows no other chunk's
    // arithmetic touches; which warp computes them is free. With 5 or 6
    // chunks, all in the ring at once, the fifth and sixth go to warps 4-7
    // a part of their rows each (4 or 2 parts), so that no SM sub-partition
    // (warp % 4) carries two whole chunks while another carries one.
    const int extra = nslot >= nchunks ? nchunks - 4 : 0;
    const int parts = min(R, extra == 1 ? 4 : extra == 2 ? 2 : 1);
    if (parts == 1 || warp < 4) {
      run(std::integral_constant<int, R>(), warp, WARPS, 0, warp);
    } else if constexpr (R >= 2) {
      const int c = 4 + (warp - 4) / parts, part = (warp - 4) % parts;
      if (parts == 4)
        run(std::integral_constant<int, (R >= 4 ? R / 4 : 1)>(), c, nchunks, part * (R / 4), c);
      else
        run(std::integral_constant<int, R / 2>(), c, nchunks, part * (R / 2), c);
      // this warp's own logical warp has no chunk: its state is empty
      if (warp >= nchunks)
        for (int j = 0; j < R; ++j) {
          if (lane == 0) {
            sm_m[warp * R + j] = NEG_INF;
            sm_l[warp * R + j] = 0.f;
          }
          for (int i = lane; i < HDP; i += 32) sm_acc[(warp * R + j) * HDP + i] = 0.f;
        }
    }
  }
  __syncthreads();

  // the warps' states combined in warp order: a thread takes one row j
  // (BLOCK / R threads a row), computes its weights exp(m_w - max) and
  // denominator, then some of its dims
  static_assert(BLOCK % RMAX == 0, "whole threads a row");
  const float* sm_acc = reinterpret_cast<const float*>(ring);
  constexpr int PER_ROW = BLOCK / R;
  const int j = threadIdx.x / PER_ROW;
  if (j < nrows) {
    float mx = NEG_INF, cw[WARPS], den = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, sm_m[w * R + j]);
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      cw[w] = expf(sm_m[w * R + j] - mx);
      den = fmaf(sm_l[w * R + j], cw[w], den);
    }
    den = fmaxf(den, 1e-30f);
    const int t = (row0 + j) / G, h = kh * G + (row0 + j) % G;
    T* o = out + (long long)b * o_sb + (long long)t * o_st + (long long)h * hd;
    for (int d = threadIdx.x % PER_ROW; d < hd; d += PER_ROW) {
      float num = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) num = fmaf(sm_acc[(w * R + j) * HDP + d], cw[w], num);
      from_f(num / den, o + d);
    }
  }
}

// cuTensorMapEncodeTiled from the driver, looked up once
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A map of a contiguous (rows, S, hd) cache as (128-byte line, line of a
// row, key, cache row), in boxes of a chunk's whole rows, swizzled by 128
// bytes; false when the driver refuses it.
template <typename T>
bool cache_map(CUtensorMap* map, const void* base, int hd, int S, long long rows) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t row = (cuuint64_t)hd * sizeof(T);
  const cuuint32_t lines = (cuuint32_t)(row / ROW);
  const cuuint64_t dims[4] = {ROW / sizeof(T), lines, (cuuint64_t)S, (cuuint64_t)rows};
  const cuuint64_t strides[3] = {ROW, row, (cuuint64_t)S * row};
  const cuuint32_t box[4] = {ROW / (cuuint32_t)sizeof(T), lines, CHUNK, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUtensorMapDataType dt =
      sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  return encode(map, dt, 4, const_cast<void*>(base), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int DPL, int R>
int launch_as(const void* q, long long q_sb, long long q_st, const void* k, const void* v,
              const int* k_pos, long long kp_sb, long long kp_ss, const int* q_pos,
              long long qp_sb, long long qp_st, void* out, long long o_sb, long long o_st,
              unsigned grid, int B, int n_tok, int H, int Kh, int S, int hd, int tiles,
              int window, float softcap, float scale, cudaStream_t stream) {
  using Gm = Geo<T, DPL, R>;
  const int nchunks = (S + CHUNK - 1) / CHUNK;
  // a slot for every chunk when they fit, else as many as fit
  int nslot = nchunks;
  while (nslot > 1 && Gm::bytes(nslot) > SMEM_MAX) --nslot;
  if (Gm::bytes(nslot) > SMEM_MAX) return (int)cudaErrorInvalidValue;
  // the copy engine takes rows of whole 128-byte multiples from 16-byte
  // aligned caches
  CUtensorMap tmk = {}, tmv = {};
  const bool tma = S > 0 && (hd * sizeof(T)) % ROW == 0 &&
                   reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0 &&
                   cache_map<T>(&tmk, k, hd, S, (long long)B * Kh) &&
                   cache_map<T>(&tmv, v, hd, S, (long long)B * Kh);
  auto kernel = attention_rows_kernel<T, DPL, R>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (attr) return (int)attr;
  kernel<<<grid, BLOCK, Gm::bytes(nslot), stream>>>(
      tmk, tmv, tma, (const T*)q, q_sb, q_st, (const T*)k, (const T*)v, k_pos, kp_sb, kp_ss,
      q_pos, qp_sb, qp_st, (T*)out, o_sb, o_st, n_tok, H, Kh, S, hd, tiles, window, softcap,
      scale, nslot);
  return 0;
}

#define ATTN_ROWS_ARGS                                                                    \
  q, q_sb, q_st, k, v, k_pos, kp_sb, kp_ss, q_pos, qp_sb, qp_st, out, o_sb, o_st, grid,   \
      B, n_tok, H, Kh, S, hd, tiles, window, softcap, scale, stream
#define ATTN_ROWS_PARAMS                                                                  \
  const void *q, long long q_sb, long long q_st, const void *k, const void *v,            \
      const int *k_pos, long long kp_sb, long long kp_ss, const int *q_pos,               \
      long long qp_sb, long long qp_st, void *out, long long o_sb, long long o_st,        \
      unsigned grid, int B, int n_tok, int H, int Kh, int S, int hd, int tiles,           \
      int window, float softcap, float scale, cudaStream_t stream

// rows per block R, then head dims per lane DPL, as template parameters
template <typename T, int DPL>
int launch_rows(int rows, ATTN_ROWS_PARAMS) {
  if (rows == 1) return launch_as<T, DPL, 1>(ATTN_ROWS_ARGS);
  if (rows == 2) return launch_as<T, DPL, 2>(ATTN_ROWS_ARGS);
  if (rows == 4) return launch_as<T, DPL, 4>(ATTN_ROWS_ARGS);
  return launch_as<T, DPL, 8>(ATTN_ROWS_ARGS);
}

template <typename T>
int launch_dpl(int rows, ATTN_ROWS_PARAMS) {
  if (hd <= 32) return launch_rows<T, 1>(rows, ATTN_ROWS_ARGS);
  if (hd <= 64) return launch_rows<T, 2>(rows, ATTN_ROWS_ARGS);
  if (hd <= 128) return launch_rows<T, 4>(rows, ATTN_ROWS_ARGS);
  return launch_rows<T, 8>(rows, ATTN_ROWS_ARGS);
}

// Launch over B slots of n_tok rows each: dtype 0 is float32, 1 bfloat16.
// Returns the error of the set-up or cudaGetLastError() after the launch.
inline int launch(const void* q, long long q_sb, long long q_st, const void* k,
                  const void* v, const int* k_pos, long long kp_sb, long long kp_ss,
                  const int* q_pos, long long qp_sb, long long qp_st, void* out,
                  long long o_sb, long long o_st, int B, int n_tok, int H, int Kh, int S,
                  int hd, int window, float softcap, float scale, int dtype,
                  cudaStream_t stream) {
  if (B <= 0 || n_tok <= 0 || Kh <= 0 || H % Kh || hd <= 0 || hd > DPL_MAX * 32 || S < 0)
    return (int)cudaErrorInvalidValue;
  const int n_rows = n_tok * (H / Kh);                 // rows per (slot, kv-head)
  const int rows = n_rows <= 1 ? 1 : n_rows <= 2 ? 2 : n_rows <= 4 ? 4 : RMAX;
  const int tiles = (n_rows + rows - 1) / rows;
  const unsigned grid = (unsigned)(B * Kh * tiles);
  int err;
  switch (dtype) {
    case 0:
      err = launch_dpl<float>(rows, ATTN_ROWS_ARGS);
      break;
    case 1:
      err = launch_dpl<__nv_bfloat16>(rows, ATTN_ROWS_ARGS);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return err ? err : (int)cudaGetLastError();
}

#undef ATTN_ROWS_ARGS
#undef ATTN_ROWS_PARAMS

}  // namespace
}  // namespace attn_rows

