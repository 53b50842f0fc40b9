// y = x @ (scale * q + offset) on the CUDA cores, accumulated in float32,
// without a float weight buffer in device memory: the GEMV route.
//
// Replaces src/repro/kernels/dequant_matmul.py `dequant_matmul` (the Pallas
// `_kernel`) below 16 rows of x (dequant_matmul_mma.cu is the tensor-core
// route from there). At decode M is the batch (1-8): the product does 2*M
// operations per weight and the bytes of q bound it on the H100, so the
// whole model's accumulators cross device memory once per decode step.
//
// The one-pass kernels, for uint8/16 q read with 8-value vector loads
// (`gemv_kn`: (K, N) slices of the stacked layer weights, N contiguous;
// `gemv_kc`: the tied unembedding's transposed view embed.T, K contiguous,
// read in place). Their design:
//
//  * One pass over q at any M < 16. A block holds up to MT (1, 4, 8 or 16)
//    rows of x, staged in shared memory as float32, so every byte of q
//    crosses device memory once a launch. From 16 rows the rows go in groups
//    of 16, one pass a group (only the tests and the timings launch that).
//  * Bytes in flight. (K, N) q: each thread keeps its next 8 steps of q (16
//    bytes each) in flight as cp.async copies into its own slots of a ring
//    in shared memory and reads a slot back once it has landed, with no
//    barrier (32 KB a block, 64 KB an SM at MT <= 4, where two blocks fit);
//    the registers hold only the accumulators. Kept in registers, the same
//    depth capped the bytes in flight once a batch was being consumed.
//    embed.T: each lane keeps two steps of 4 columns (16 bytes each) in
//    registers (`ld.global.nc.L1::no_allocate`), two blocks an SM up to MT
//    = 8. The first copies are issued before x is staged and before scale
//    and offset are read.
//  * One launch, no scratch. A (K, N) block owns 32 columns and one chunk of
//    K; the wrapper's rule (kernels/dequant_matmul.py `gemv_k_chunk`) cuts K
//    into 2 chunks where the column tiles alone would leave the card half
//    empty, and into as many as chunks of at most 4096 rows need (2048 for
//    embed.T), at most 8 (the largest portable cluster; starcoder2-15b's
//    mlp.wo at K = 24,576 takes 6): a function of K, N and the layout
//    only. The chunks of a
//    column tile run as one thread block cluster, and the cluster adds their
//    partial sums in chunk order through distributed shared memory. Clusters
//    of 2: at one block an SM the H100 holds enough of them at once, but
//    fewer clusters of 4 than a 2048 x 2048 weight in 64-column tiles needs
//    (cudaOccupancyMaxActiveClusters), and those ran in two waves. embed.T:
//    a warp owns 4 columns and walks the chunk's K with 8 values a lane a
//    step.
//  * Few instructions per weight. q is centred on c = clamp(rint(-offset /
//    scale)), the accumulator value whose weight is nearest 0 (computed here
//    from scale and offset in device memory: an upgrade changes values,
//    never the launch), and the affine leaves the inner loop:
//
//        y = scale * sum_k x * (q - c) + (offset + scale * c) * sum_k x
//
//    q - c is formed exactly with one byte permute (the value's bits under
//    the exponent of 2^23) and one subtraction of 2^23 + c, then one FMA a
//    row of x: about 2 + M instructions a weight. At M = 8 the FMAs take
//    about as long as the bytes, and the two do not fully overlap.
//
// Truncated views (self-speculation's draft): a plane mask rides as an
// operand, `keep` (one int32 in device memory, null without a mask) and the
// leaf's width `bits`. Each kernel reads it once a block and ANDs the words
// of q with it before they are centred (keep_mask.cuh), so the masked q
// never exists in device memory; a full-width keep changes no bit.
//
// Rounding: q - c is exact. With bfloat16 x each product x * (q - c) is exact
// in float32 (8 + 16 significant bits), with float32 x it rounds once inside
// the FMA; the sums over K round in float32. The order is fixed: a thread
// adds its rows of the chunk in K order, (K, N) lanes meet by a butterfly
// over the 4 rows of a warp and the warps in order, embed.T lanes by a
// butterfly over the warp, the chunks in chunk order; the row sums of x the
// same way. None of it depends on M, so a row's result is bit-equal to the
// same row launched alone, and two launches agree bit for bit. The plain
// version forms each weight as fmul_rn(q, scale) then fadd_rn(., offset);
// against it only float32 rounding differs (far below 1e-4 of max |y|, q
// centred so that the two terms above do not cancel for activations of
// large positive mean).
//
// The general kernels, PR 12's (`general_cols`, `general_rows`), take what
// the vector loads cannot: uint32 q, q whose strides or alignment are not
// multiples of 8 values, and K beyond 8 chunks. They form each weight as two
// rounded operations, as the plain version does, and sum K in one block
// (each row independent of M as well).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "keep_mask.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int KN_COLS = 32;               // (K, N) q: columns a block, 8 a lane
constexpr int KN_LPR = KN_COLS / 8;       // (K, N) q: lanes a row of the tile
constexpr int KN_RPW = 32 / KN_LPR;       // (K, N) q: rows a warp reads a step
constexpr int KN_STEP = WARPS * KN_RPW;   // (K, N) q: rows a block reads a step
constexpr int KN_RING = 8;                // (K, N) q: steps of q in flight a thread
constexpr int X_SLAB = 32768;             // (K, N) q: floats of x staged at a time (128 KB)
constexpr int KC_CW = 4;                  // K-contiguous q: columns a warp
constexpr int KC_COLS = WARPS * KC_CW;    // K-contiguous q: columns a block
constexpr int CHUNK_UNIT = 512;           // a chunk of K is a multiple of this
constexpr int KN_MAX_CHUNK = 4096;        // rows of K a block at most, (K, N) q
constexpr int KC_MAX_CHUNK = 2048;        // rows of K a block at most, K-contiguous q
constexpr int MAX_CHUNKS = 8;             // chunks a cluster at most (portable limit)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

struct Args {
  const void* x;
  const void* q;
  const float* scale;
  const float* offset;
  const int* keep;   // the plane mask's width, or null
  int bits;
  float* out;
  long long sq;   // q's stride along its strided axis: K for (K, N) q, N for embed.T
  int M, K, N, k_chunk;
};

// ---------------------------------------------------------------------------
// the one-pass kernels
// ---------------------------------------------------------------------------

// Eight q values: a 16-byte word of uint16 or an 8-byte word of uint8.
template <typename TQ>
struct Word;
template <>
struct Word<uint16_t> {
  using T = uint4;
};
template <>
struct Word<uint8_t> {
  using T = uint2;
};

// A streaming load: each byte of q is read once, so it is not kept in L1.
// Volatile, so that a batch stays where it is issued, ahead of its use.
__device__ __forceinline__ void ld_stream(uint4& r, const void* p) {
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0,%1,%2,%3}, [%4];"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
      : "l"(p));
}
__device__ __forceinline__ void ld_stream(uint2& r, const void* p) {
  asm volatile("ld.global.nc.L1::no_allocate.v2.u32 {%0,%1}, [%2];" : "=r"(r.x), "=r"(r.y) : "l"(p));
}

template <typename TQ>
__device__ __forceinline__ typename Word<TQ>::T load_q(const TQ* p, bool ok) {
  typename Word<TQ>::T w{};
  if (ok) ld_stream(w, p);
  return w;
}

// The eight values of a word, masked (`wmask`: keep_mask), minus the
// centre, exactly: the value's bits under the exponent of 2^23 (one byte
// permute), less 2^23 + c (`bias`).
template <typename TQ>
__device__ __forceinline__ void centred(const typename Word<TQ>::T& w, float bias,
                                        uint32_t wmask, float (&v)[8]) {
  if constexpr (sizeof(TQ) == 2) {
    const uint32_t u[4] = {w.x & wmask, w.y & wmask, w.z & wmask, w.w & wmask};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __fsub_rn(__uint_as_float(__byte_perm(u[i], 0x4B000000u, 0x7610)), bias);
      v[2 * i + 1] = __fsub_rn(__uint_as_float(__byte_perm(u[i], 0x4B000000u, 0x7632)), bias);
    }
  } else {
    const uint32_t u[2] = {w.x & wmask, w.y & wmask};
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        v[4 * i + b] =
            __fsub_rn(__uint_as_float(__byte_perm(u[i], 0x4B000000u, 0x7540 + b)), bias);
  }
}

// scale, the weight d of q == c (one fused multiply-add), 2^23 + c, and
// the plane mask.
struct Centre {
  float scale, d, bias;
  uint32_t wmask;
};

template <typename TQ>
__device__ __forceinline__ Centre centre(const Args& a) {
  const float scale = *a.scale, offset = *a.offset;
  const float cf =
      fminf(fmaxf(rintf(-offset / scale), 0.f), sizeof(TQ) == 1 ? 255.f : 65535.f);
  return {scale, fmaf(scale, cf, offset), 8388608.f + cf, keep_mask<TQ>(a.keep, a.bits)};
}

// (K, N) q: rows of x staged at a time (the whole chunk but at MT = 16 and
// 4096-row chunks).
template <int MT>
__host__ __device__ constexpr int kn_slab(int k_chunk) {
  return k_chunk < X_SLAB / MT ? k_chunk : X_SLAB / MT;
}

// Shared memory of a one-pass block, in floats. (K, N) q: the ring of q
// words [ring][THREADS][4], x [MT][slab], the warps' row sums [WARPS][MT],
// the warps' sums [WARPS][MT][KN_COLS], the block's partial sums
// [MT][KN_COLS] with the row sums [MT] after them. K-contiguous q: x
// [MT][k_chunk], the warps' row sums, the block's partial sums [MT][KC_COLS]
// and row sums.
template <int MT>
__host__ __device__ constexpr size_t kn_smem_floats(int k_chunk) {
  return (size_t)KN_RING * THREADS * 4 + (size_t)MT * kn_slab<MT>(k_chunk) + WARPS * MT +
         WARPS * MT * KN_COLS + MT * KN_COLS + MT;
}
template <int MT>
__host__ __device__ constexpr size_t kc_smem_floats(int k_chunk) {
  return (size_t)MT * k_chunk + WARPS * MT + MT * KC_COLS + MT;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// One word of q into shared memory without passing through registers;
// zeros when !ok. Each thread waits for its own copies only.
__device__ __forceinline__ void cp_word(void* dst, const uint4* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_word(void* dst, const uint2* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 8 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows m0 .. m0 + MT of x over K rows [k_lo, k_lo + rows) of the block's
// chunk into shared memory as float32 (row m at xs + m * ld), zero past M
// and past K, and each thread's share of the rows' sums: thread t adds the
// 8-value units t, t + 256, ... of a row in K order, the same for every row,
// every MT and every slab of 2048 rows. Up to 8 rows' units are loaded
// before any is used, so a block waits about one trip to L2, not one a row.
// For K-contiguous q the two halves of a unit go 128 floats apart within
// each 256, so that the lanes' float4 reads in `gemv_kc` are consecutive.
template <typename TX, int MT, bool KC>
__device__ __forceinline__ void stage_x(const Args& a, int m0, int k_lo, int rows, int k_end,
                                        int ld, float* xs, float (&sx)[MT]) {
  constexpr int G = MT < 8 ? MT : 8;           // rows a batch of loads
  constexpr int WPU = sizeof(TX) / 2;          // 16-byte words a unit
  const TX* x = (const TX*)a.x;
  const bool aligned = a.K % 8 == 0 && (uintptr_t)x % 16 == 0;
  for (int g = threadIdx.x; g < rows / 8; g += THREADS) {
    const int k = k_lo + g * 8;
    const bool vec = aligned && k + 8 <= k_end;
    float* dst = xs + (KC ? (g / 32) * 256 + (g % 32) * 4 : g * 8);
#pragma unroll
    for (int m1 = 0; m1 < MT; m1 += G) {
      uint4 raw[G][WPU];
#pragma unroll
      for (int i = 0; i < G; ++i) {
        const uint4* p = reinterpret_cast<const uint4*>(x + (long long)(m0 + m1 + i) * a.K + k);
#pragma unroll
        for (int w = 0; w < WPU; ++w)
          raw[i][w] = (vec && m0 + m1 + i < a.M) ? p[w] : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int i = 0; i < G; ++i) {
        const int m = m1 + i, row = m0 + m;
        float v[8];
        if (vec) {
          if constexpr (sizeof(TX) == 2) {
            const uint32_t u[4] = {raw[i][0].x, raw[i][0].y, raw[i][0].z, raw[i][0].w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              v[2 * j] = __uint_as_float(u[j] << 16);
              v[2 * j + 1] = __uint_as_float(u[j] & 0xFFFF0000u);
            }
          } else {
#pragma unroll
            for (int w = 0; w < 2; ++w) {
              v[4 * w] = __uint_as_float(raw[i][w].x), v[4 * w + 1] = __uint_as_float(raw[i][w].y);
              v[4 * w + 2] = __uint_as_float(raw[i][w].z), v[4 * w + 3] = __uint_as_float(raw[i][w].w);
            }
          }
        } else {
          const TX* p = x + (long long)row * a.K + k;
#pragma unroll
          for (int j = 0; j < 8; ++j) v[j] = (row < a.M && k + j < k_end) ? to_f(p[j]) : 0.f;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) sx[m] += v[j];
        *reinterpret_cast<float4*>(dst + m * ld) = make_float4(v[0], v[1], v[2], v[3]);
        *reinterpret_cast<float4*>(dst + m * ld + (KC ? 128 : 4)) =
            make_float4(v[4], v[5], v[6], v[7]);
      }
    }
  }
}

// A warp's share of the row sums, by a butterfly over its lanes; lane 0
// keeps it for the block's sum in warp order.
template <int MT>
__device__ __forceinline__ void warp_row_sums(float (&sx)[MT], float* sxw) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    float s = sx[m];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) sxw[warp * MT + m] = s;
  }
}

// The block's row sums in warp order, after `tile`'s MT x COLS partial sums.
template <int MT, int COLS>
__device__ __forceinline__ void block_row_sums(const float* sxw, float* tile) {
  if (threadIdx.x < MT) {
    float s = sxw[threadIdx.x];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) s += sxw[w * MT + threadIdx.x];
    tile[MT * COLS + threadIdx.x] = s;
  }
}

// y from the block's partial sums: one chunk writes them, several add them
// over the cluster in chunk order (each block a share of the tile, read
// through distributed shared memory) and write them.
template <int MT, int COLS>
__device__ __forceinline__ void finish(const Args& a, const Centre& cn, float* tile, int n0,
                                       int m0) {
  const int rows = min(MT, a.M - m0);
  if (gridDim.y == 1) {
    __syncthreads();
    for (int e = threadIdx.x; e < rows * COLS; e += THREADS) {
      const int m = e / COLS, n = n0 + e % COLS;
      if (n < a.N)
        a.out[(long long)(m0 + m) * a.N + n] = fmaf(cn.scale, tile[e], cn.d * tile[MT * COLS + m]);
    }
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int chunks = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int share = (rows * COLS + chunks - 1) / chunks;
  const int e_end = min(rows * COLS, (rank + 1) * share);
  for (int e = rank * share + threadIdx.x; e < e_end; e += THREADS) {
    const int m = e / COLS, n = n0 + e % COLS;
    const float* t0 = cluster.map_shared_rank(tile, 0);
    float s = t0[e], sx = t0[MT * COLS + m];
    for (int r = 1; r < chunks; ++r) {
      const float* t = cluster.map_shared_rank(tile, r);
      s += t[e];
      sx += t[MT * COLS + m];
    }
    if (n < a.N) a.out[(long long)(m0 + m) * a.N + n] = fmaf(cn.scale, s, cn.d * sx);
  }
  cluster.sync();   // no block leaves while others read its shared memory
}

// (K, N) q, N contiguous: KN_COLS columns and one chunk of K a block. Lane
// l of warp w reads columns 8 (l % KN_LPR) .. + 8 of rows
// r = KN_RPW w + l / KN_LPR, r + KN_STEP, ... of the chunk (a warp reads 8
// rows of 64 bytes a step, the block 64 rows). Each thread keeps its next
// KN_RING steps of q in flight as cp.async copies into its own slots of a
// ring in shared memory, and reads a slot back once its copy has landed.
// Two blocks an SM up to MT = 4; at MT = 8 and 16 the accumulators need
// more than 128 registers a thread.
template <typename TX, typename TQ, int MT>
__global__ void __launch_bounds__(THREADS, MT <= 4 ? 2 : 1) gemv_kn(const Args a) {
  constexpr int R = KN_RING;
  using W = typename Word<TQ>::T;
  extern __shared__ __align__(16) float smem[];
  const int kcp = a.k_chunk, slab = kn_slab<MT>(kcp);
  float* ring = smem;
  float* xs = ring + R * THREADS * 4;
  float* sxw = xs + MT * slab;
  float* red = sxw + WARPS * MT;
  float* tile = red + WARPS * MT * KN_COLS;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * KN_COLS, col = n0 + (lane % KN_LPR) * 8;
  const int r = warp * KN_RPW + lane / KN_LPR;
  const int m0 = blockIdx.z * MT;
  const int k_begin = blockIdx.y * kcp, k_end = min(a.K, k_begin + kcp);
  const int steps = (k_end - k_begin + KN_STEP - 1) / KN_STEP;
  const int rows_left = k_end - k_begin - r;   // step s is in K iff KN_STEP s < rows_left
  const bool col_ok = col < a.N;
  const TQ* qp = (const TQ*)a.q + (long long)(k_begin + r) * a.sq + col;
  const long long qstep = KN_STEP * a.sq;

  auto slot = [&](int s) { return ring + ((s % R) * THREADS + tid) * 4; };
  auto issue = [&](int s) {
    const bool ok = col_ok && s < steps && KN_STEP * s < rows_left;
    cp_word(slot(s), reinterpret_cast<const W*>(ok ? qp + s * qstep : (const TQ*)a.q), ok);
    cp_commit();
  };
#pragma unroll
  for (int s = 0; s < R; ++s) issue(s);
  const Centre cn = centre<TQ>(a);   // its loads go out behind q's

  float acc[MT][8], sx[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    sx[m] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[m][j] = 0.f;
  }
  // x of rows past K is 0 in xs, so their products add nothing
  for (int s0 = 0; s0 < steps; s0 += slab / KN_STEP) {
    if (s0) __syncthreads();   // every warp is done with the last slab
    stage_x<TX, MT, false>(a, m0, k_begin + s0 * KN_STEP, slab, k_end, slab, xs, sx);
    __syncthreads();
    const int s_end = min(steps, s0 + slab / KN_STEP);
    const float* xk = xs + r - s0 * KN_STEP;
    for (int s = s0; s < s_end; ++s) {
      cp_wait<R - 1>();   // step s has landed
      float w[8];
      centred<TQ>(*reinterpret_cast<const W*>(slot(s)), cn.bias, cn.wmask, w);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float xv = xk[m * slab + KN_STEP * s];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[m][j] = fmaf(xv, w[j], acc[m][j]);
      }
      issue(s + R);
    }
  }
  cp_wait<0>();
  warp_row_sums<MT>(sx, sxw);

  // the rows of a warp by a butterfly, then the warps in order
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float v = acc[m][j];
#pragma unroll
      for (int o = KN_LPR; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      acc[m][j] = v;
    }
  if (lane < KN_LPR) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      float* dst = red + (warp * MT + m) * KN_COLS + lane * 8;
      *reinterpret_cast<float4*>(dst) = make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
      *reinterpret_cast<float4*>(dst + 4) =
          make_float4(acc[m][4], acc[m][5], acc[m][6], acc[m][7]);
    }
  }
  __syncthreads();
  for (int e = tid; e < MT * KN_COLS; e += THREADS) {
    float s = red[e];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) s += red[w * MT * KN_COLS + e];
    tile[e] = s;
  }
  block_row_sums<MT, KN_COLS>(sxw, tile);
  finish<MT, KN_COLS>(a, cn, tile, n0, m0);
}

// K-contiguous q (embed.T): 4 columns a warp, one chunk of K a block. Lane
// l reads 8 values of K at 8 l of every 256 of the chunk, for each of its
// warp's 4 columns (a warp reads 512 contiguous bytes of a column a load).
template <typename TX, typename TQ, int MT>
__global__ void __launch_bounds__(THREADS, MT <= 8 ? 2 : 1) gemv_kc(const Args a) {
  using W = typename Word<TQ>::T;
  extern __shared__ __align__(16) float smem[];
  const int kcp = a.k_chunk;
  float* xs = smem;
  float* sxw = xs + MT * kcp;
  float* tile = sxw + WARPS * MT;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * KC_COLS, nw = n0 + warp * KC_CW;
  const int m0 = blockIdx.z * MT;
  const int k_begin = blockIdx.y * kcp, k_end = min(a.K, k_begin + kcp);
  const int steps = ((k_end - k_begin + 255) / 256 + 1) / 2 * 2;   // pairs: x past K is 0
  const int left = k_end - k_begin - lane * 8;   // step t is in K iff 256 t < left
  const TQ* qp = (const TQ*)a.q + (long long)nw * a.sq + k_begin + lane * 8;
  Centre cn;   // loaded behind q's first loads

  W b0[KC_CW], b1[KC_CW];
  auto load = [&](W(&b)[KC_CW], int t) {
#pragma unroll
    for (int c = 0; c < KC_CW; ++c)
      b[c] = load_q<TQ>(qp + c * a.sq + t * 256, nw + c < a.N && 256 * t < left);
  };
  float acc[KC_CW][MT];
#pragma unroll
  for (int c = 0; c < KC_CW; ++c)
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[c][m] = 0.f;
  auto consume = [&](const W(&b)[KC_CW], int t) {
    const float* xk = xs + t * 256 + lane * 4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {   // values 0-3, then 4-7, of the lane's 8
      float xv[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float4 v = *reinterpret_cast<const float4*>(xk + m * kcp + h * 128);
        xv[m][0] = v.x, xv[m][1] = v.y, xv[m][2] = v.z, xv[m][3] = v.w;
      }
#pragma unroll
      for (int c = 0; c < KC_CW; ++c) {
        float w[8];
        centred<TQ>(b[c], cn.bias, cn.wmask, w);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int m = 0; m < MT; ++m) acc[c][m] = fmaf(xv[m][j], w[4 * h + j], acc[c][m]);
      }
    }
  };

  load(b0, 0);
  load(b1, 1);
  cn = centre<TQ>(a);
  float sx[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) sx[m] = 0.f;
  stage_x<TX, MT, true>(a, m0, k_begin, kcp, k_end, kcp, xs, sx);
  warp_row_sums<MT>(sx, sxw);
  __syncthreads();
  for (int t = 0; t < steps; t += 2) {
    consume(b0, t);
    load(b0, t + 2);
    consume(b1, t + 1);
    load(b1, t + 3);
  }

  // a column's lanes by a butterfly over the warp
#pragma unroll
  for (int c = 0; c < KC_CW; ++c)
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      float v = acc[c][m];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane == 0) tile[m * KC_COLS + warp * KC_CW + c] = v;
    }
  block_row_sums<MT, KC_COLS>(sxw, tile);
  finish<MT, KC_COLS>(a, cn, tile, n0, m0);
}

template <typename TX, typename TQ, int MT, bool KC>
int launch_one_pass(const Args& a, cudaStream_t stream) {
  constexpr int COLS = KC ? KC_COLS : KN_COLS;
  void (*kernel)(Args);
  size_t smem_max, smem;
  if constexpr (KC) {
    kernel = gemv_kc<TX, TQ, MT>;
    smem_max = kc_smem_floats<MT>(KC_MAX_CHUNK) * sizeof(float);
    smem = kc_smem_floats<MT>(a.k_chunk) * sizeof(float);
  } else {
    kernel = gemv_kn<TX, TQ, MT>;
    smem_max = kn_smem_floats<MT>(KN_MAX_CHUNK) * sizeof(float);
    smem = kn_smem_floats<MT>(a.k_chunk) * sizeof(float);
  }
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_max);
  if (attr) return (int)attr;
  const int chunks = (a.K + a.k_chunk - 1) / a.k_chunk;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.N + COLS - 1) / COLS, chunks, (a.M + MT - 1) / MT);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = chunks;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  return (int)(err ? err : cudaGetLastError());
}

// Rows of x a block: 1, 4, 8, or 16 (from 16 rows, groups of 16).
template <typename TX, typename TQ, bool KC>
int by_rows(const Args& a, cudaStream_t s) {
  if (a.M == 1) return launch_one_pass<TX, TQ, 1, KC>(a, s);
  if (a.M <= 4) return launch_one_pass<TX, TQ, 4, KC>(a, s);
  if (a.M <= 8) return launch_one_pass<TX, TQ, 8, KC>(a, s);
  return launch_one_pass<TX, TQ, 16, KC>(a, s);
}

template <typename TX>
int one_pass_q(const Args& a, int q_bytes, bool kc, cudaStream_t s) {
  switch (q_bytes * 2 + kc) {
    case 2: return by_rows<TX, uint8_t, false>(a, s);
    case 3: return by_rows<TX, uint8_t, true>(a, s);
    case 4: return by_rows<TX, uint16_t, false>(a, s);
    case 5: return by_rows<TX, uint16_t, true>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// the general kernels (PR 12's): uint32 q, and strides or alignment the
// vector loads cannot take
// ---------------------------------------------------------------------------

constexpr int MT_COLS = 4;   // rows of x a block in general_cols
constexpr int MT_ROWS = 8;   // rows of x a block in general_rows

__device__ __forceinline__ float dq(uint32_t qv, float scale, float offset) {
  return __fadd_rn(__fmul_rn((float)qv, scale), offset);
}

// A block's operands after x and q: the affine, the plane mask and the output.
struct GenArgs {
  const float* scale;
  const float* offset;
  const int* keep;
  int bits;
  float* out;
};

// V elements of q loaded as one 8- or 16-byte word.
template <typename TQ, int V>
union Lanes {
  uint4 u4;
  uint2 u2;
  TQ e[V];
};

// Columns per thread in general_cols: an 8-byte load of uint8, 16 bytes otherwise.
template <typename TQ>
struct ColsVec {
  static constexpr int V = sizeof(TQ) == 1 ? 8 : 16 / sizeof(TQ);
};

// (K, N) q: a block owns 32*V consecutive columns and all of K; its 8 warps
// take every 8th row, each thread V columns of a row, and the warps' sums
// meet in shared memory in warp order.
template <typename TX, typename TQ, bool VEC>
__global__ void __launch_bounds__(256) general_cols(
    const TX* __restrict__ x, const TQ* __restrict__ q, const GenArgs g, int M, int K, int N,
    long long sqk, long long sqn) {
  constexpr int V = ColsVec<TQ>::V;
  __shared__ float red[WARPS][MT_COLS][V][32];
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int n0 = (blockIdx.x * 32 + lane) * V;
  const int m0 = blockIdx.z * MT_COLS;
  const float scale = *g.scale, offset = *g.offset;
  const uint32_t mask = keep_mask<uint32_t>(g.keep, g.bits);
  float* __restrict__ out = g.out;

  float acc[MT_COLS][V];
#pragma unroll
  for (int m = 0; m < MT_COLS; ++m)
#pragma unroll
    for (int j = 0; j < V; ++j) acc[m][j] = 0.f;

  for (int k = warp; k < K; k += WARPS) {
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
      for (int j = 0; j < V; ++j) w[j] = dq((uint32_t)b.e[j] & mask, scale, offset);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int n = n0 + j;
        w[j] = n < N ? dq((uint32_t)row[(long long)n * sqn] & mask, scale, offset) : 0.f;
      }
    }
#pragma unroll
    for (int m = 0; m < MT_COLS; ++m) {
      const float xv = (m0 + m < M) ? to_f(x[(long long)(m0 + m) * K + k]) : 0.f;
#pragma unroll
      for (int j = 0; j < V; ++j) acc[m][j] = fmaf(xv, w[j], acc[m][j]);
    }
  }

#pragma unroll
  for (int m = 0; m < MT_COLS; ++m)
#pragma unroll
    for (int j = 0; j < V; ++j) red[warp][m][j][lane] = acc[m][j];
  __syncthreads();

  const int tid = warp * 32 + lane;
  for (int e = tid; e < MT_COLS * V * 32; e += WARPS * 32) {
    const int m = e / (V * 32), j = (e / 32) % V, l = e % 32;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += red[w][m][j][l];
    const int n = (blockIdx.x * 32 + l) * V + j;
    if (m0 + m < M && n < N) out[(long long)(m0 + m) * N + n] = s;
  }
}

// K-contiguous q: one warp per output column walks K with 16-byte loads
// and reduces with shuffles.
template <typename TX, typename TQ, bool VEC>
__global__ void __launch_bounds__(256) general_rows(
    const TX* __restrict__ x, const TQ* __restrict__ q, const GenArgs g, int M, int K, int N,
    long long sqn) {
  constexpr int V = 16 / sizeof(TQ);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = blockIdx.x * WARPS + warp;
  const int m0 = blockIdx.y * MT_ROWS;
  if (n >= N) return;
  const float scale = *g.scale, offset = *g.offset;
  const uint32_t mask = keep_mask<uint32_t>(g.keep, g.bits);
  float* __restrict__ out = g.out;
  const TQ* col = q + (long long)n * sqn;

  float acc[MT_ROWS];
#pragma unroll
  for (int m = 0; m < MT_ROWS; ++m) acc[m] = 0.f;

  for (int k0 = lane * V; k0 < K; k0 += 32 * V) {
    float w[V];
    if constexpr (VEC) {
      Lanes<TQ, V> b;
      b.u4 = *reinterpret_cast<const uint4*>(col + k0);
#pragma unroll
      for (int j = 0; j < V; ++j) w[j] = dq((uint32_t)b.e[j] & mask, scale, offset);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j)
        w[j] = (k0 + j < K) ? dq((uint32_t)col[k0 + j] & mask, scale, offset) : 0.f;
    }
#pragma unroll
    for (int m = 0; m < MT_ROWS; ++m) {
      if (m0 + m < M) {
        const TX* xr = x + (long long)(m0 + m) * K + k0;
#pragma unroll
        for (int j = 0; j < V; ++j)
          if (VEC || k0 + j < K) acc[m] = fmaf(to_f(xr[j]), w[j], acc[m]);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < MT_ROWS; ++m) {
    float s = acc[m];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0 && m0 + m < M) out[(long long)(m0 + m) * N + n] = s;
  }
}

template <typename TX, typename TQ>
int launch_general(const void* xv, const void* qv, long long sqk, long long sqn,
                   const GenArgs& g, int M, int K, int N, cudaStream_t stream) {
  const TX* x = (const TX*)xv;
  const TQ* q = (const TQ*)qv;
  if (sqk == 1 && K > 1) {
    constexpr int V = 16 / sizeof(TQ);
    const bool vec = (K % V == 0) && (sqn % V == 0) && ((uintptr_t)q % 16 == 0);
    dim3 grid((N + WARPS - 1) / WARPS, (M + MT_ROWS - 1) / MT_ROWS);
    if (vec)
      general_rows<TX, TQ, true><<<grid, WARPS * 32, 0, stream>>>(x, q, g, M, K, N, sqn);
    else
      general_rows<TX, TQ, false><<<grid, WARPS * 32, 0, stream>>>(x, q, g, M, K, N, sqn);
    return (int)cudaGetLastError();
  }
  constexpr int V = ColsVec<TQ>::V;
  const bool vec = (sqn == 1) && (N % V == 0) && (sqk % V == 0) &&
                   ((uintptr_t)q % (V * sizeof(TQ)) == 0);
  dim3 grid((N + 32 * V - 1) / (32 * V), 1, (M + MT_COLS - 1) / MT_COLS);
  dim3 block(32, WARPS);
  if (vec)
    general_cols<TX, TQ, true><<<grid, block, 0, stream>>>(x, q, g, M, K, N, sqk, sqn);
  else
    general_cols<TX, TQ, false><<<grid, block, 0, stream>>>(x, q, g, M, K, N, sqk, sqn);
  return (int)cudaGetLastError();
}

template <typename TX>
int general_q(const void* x, const void* q, int q_bytes, long long sqk, long long sqn,
              const GenArgs& g, int M, int K, int N, cudaStream_t s) {
  switch (q_bytes) {
    case 1: return launch_general<TX, uint8_t>(x, q, sqk, sqn, g, M, K, N, s);
    case 2: return launch_general<TX, uint16_t>(x, q, sqk, sqn, g, M, K, N, s);
    case 4: return launch_general<TX, uint32_t>(x, q, sqk, sqn, g, M, K, N, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Both entry points: x (M, K) row-major, float32 (x_dtype 0) or bfloat16
// (x_dtype 1); q (K, N) with element strides (sqk, sqn); scale and offset
// one float32 each, in device memory; keep null or one int32 in device
// memory, the top bits of `bits` (1 to q's width) that q keeps; out (M, N)
// float32, row-major.

// The one-pass kernels: uint8/16 q (q_bytes 1/2), either N contiguous
// (sqn == 1, kc == 0) with N and sqk multiples of 8, or K contiguous
// (sqk == 1, kc == 1) with K and sqn multiples of 8; q aligned to 8
// values; k_chunk rows of K a block, a multiple of 512 up to 4096 (2048
// for K-contiguous q), at most 8 chunks.
extern "C" int dequant_matmul_gemv(const void* x, int x_dtype, const void* q, int q_bytes,
                                   long long sqk, long long sqn, const float* scale,
                                   const float* offset, const int* keep, int bits, float* out,
                                   int M, int K, int N, int kc, int k_chunk, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (M <= 0 || N <= 0 || K <= 0 || k_chunk <= 0 || k_chunk % CHUNK_UNIT ||
      bits < 1 || bits > 8 * q_bytes ||
      k_chunk > (kc ? KC_MAX_CHUNK : KN_MAX_CHUNK) || (K + k_chunk - 1) / k_chunk > MAX_CHUNKS ||
      (q_bytes != 1 && q_bytes != 2) || (uintptr_t)q % (8 * q_bytes))
    return (int)cudaErrorInvalidValue;
  const bool layout_ok = kc ? (sqk == 1 && K % 8 == 0 && sqn % 8 == 0)
                            : (sqn == 1 && N % 8 == 0 && sqk % 8 == 0);
  if (!layout_ok) return (int)cudaErrorInvalidValue;
  const Args a{x, q, scale, offset, keep, bits, out, kc ? sqn : sqk, M, K, N, k_chunk};
  switch (x_dtype) {
    case 0: return one_pass_q<float>(a, q_bytes, kc != 0, s);
    case 1: return one_pass_q<__nv_bfloat16>(a, q_bytes, kc != 0, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The general kernels: uint8/16/32 q (q_bytes 1/2/4), any strides.
extern "C" int dequant_matmul_general(const void* x, int x_dtype, const void* q, int q_bytes,
                                      long long sqk, long long sqn, const float* scale,
                                      const float* offset, const int* keep, int bits,
                                      float* out, int M, int K, int N, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (M <= 0 || N <= 0 || K <= 0 || bits < 1 || bits > 8 * q_bytes)
    return (int)cudaErrorInvalidValue;
  const GenArgs g{scale, offset, keep, bits, out};
  switch (x_dtype) {
    case 0: return general_q<float>(x, q, q_bytes, sqk, sqn, g, M, K, N, s);
    case 1: return general_q<__nv_bfloat16>(x, q, q_bytes, sqk, sqn, g, M, K, N, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
