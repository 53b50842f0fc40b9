// y = x @ (scale * q + offset) on the tensor cores, from 16 rows of x
// (at every M on the K-contiguous embed.T): the pool's chunk tick at
// M = 64, the prefill at M = 256, the unembedding; the float weight never
// exists in device memory.
//
// Replaces src/repro/kernels/dequant_matmul.py `dequant_matmul` (the Pallas
// `_kernel`) where M is large; dequant_matmul.cu keeps the small-M GEMV.
//
// Bound on the H100: the function reads q and x and writes y once and
// does 2*M*K*N products; at the path's M (64 and 256) its bytes, mostly
// q's, take longer than its products at the bf16 peak, so the bytes bound
// it. A block covers up to 64 rows of x (128 above M = 64), so at M = 64
// each byte of q crosses device memory once and at M = 256 twice. This
// kernel does 2*M*K*N products per byte plane of q and per bf16 term of
// x (2 to 6 passes over uint16 q): at M = 256 with two planes those alone
// take longer at the bf16 peak than the function's bytes.
//
// Exact operands for bf16 tensor cores. An integer in [-256, 256] is exact
// in bf16. The accumulator is centred on c and split by bytes,
//
//     q - c = 256 * (q_hi - c_hi) + (q_lo - c_lo),   each term in [-255, 255],
//
// and each byte plane is multiplied by x with float32 accumulation
// (mma.sync m16n8k16, bf16 in, f32 out):
//
//     y = scale * (256*A_hi + A_lo) + (offset + scale*c) * sum_k x
//
// A uint8 container needs one plane (q - c itself); uint16 needs two;
// uint32 containers stay on the GEMV kernel. A byte becomes a bf16
// without a conversion instruction: a byte permute puts it in the low
// bits of the float 2^23, one subtraction of 2^23 + c's byte is exact,
// and a second permute packs the upper halves of two such floats, their
// bf16 values. x in bfloat16 goes in as it is; x in float32 is split
// exactly into three bf16 terms (hi, the rounded residual, its residual:
// a float32 significand is exactly the sum of three bf16 ones),
// accumulated into the same sums. Every product is exact in float32;
// only the float32 sums round.
//
// Why centred: c is the accumulator value whose weight is nearest 0,
// clamp(rint(-offset / scale)), computed here from the scale and offset in
// device memory (no host sync; an upgrade changes values, never the
// launch). Uncentred (c = 0) the two terms of the epilogue are each as
// large as sum |x| * max|w| and cancel, and for activations of large
// positive mean the float32 rounding of A_hi left errors above 1e-4 of
// max |y|; centred, offset + scale*c is at most half a step of the
// weight grid (formed with one fused multiply-add), no term is much
// larger than y, and the result holds well within 1e-4 of max |y| of the
// plain version (which rounds every weight as fmul_rn(q, scale) +
// offset).
//
// Design: a block owns BM rows of x (64; 128 above M = 64 with bfloat16
// x) and BN = 8192/BM columns of q, and one chunk of K, and runs alone on
// its SM with two groups of eight warps. The converters stream raw q and
// x tiles of BK = 64 rows of K through a cp.async ring in shared memory
// (4 stages with bfloat16 x, 2 with float32; 16-byte copies, or plain
// loads and no ring where shapes or strides do not allow them) and turn
// each stage once into the bf16 byte planes and x terms; the product
// warps, each on a 32 x 32 tile of the output, run the mma.sync products
// of the stage the converters finished before, from ldmatrix fragments.
// Two buffers of converted operands and named barriers (full, empty) let
// one stage's conversion overlap the last one's products. The planes keep
// q's own contiguous axis, so both of the model's layouts are read in
// place with 16-byte loads: (K, N) slices of the stacked layer weights (N
// contiguous; B fragments by ldmatrix.trans) and the tied unembedding's
// transposed view embed.T (K contiguous; ldmatrix); no transposed or
// float copy is made. When the tiles alone cannot fill the card, K is cut
// into up to 4 chunks. The chunks of a tile run as one thread block
// cluster: each leaves its partial products (epilogue included: it is
// linear) in its shared memory, and the cluster adds them in chunk order
// through distributed shared memory, with no scratch buffer in device
// memory, no second launch and no atomics: results do not change from
// run to run.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py, PERF.md):
// near 4x its bytes bound at M = 64; the products and the byte-plane
// conversion, not the loads, limit it.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CONV_WARPS = 8;   // warps that load and convert
constexpr int MMA_WARPS = 8;    // warps that run the products
constexpr int CT = 32 * CONV_WARPS;
constexpr int THREADS = CT + 32 * MMA_WARPS;
constexpr int BK = 64;          // rows of K a pipeline stage
// named barriers (0 is __syncthreads): the converters among themselves,
// and a full and an empty barrier for each of the two plane buffers
constexpr int BAR_CONV = 1, BAR_FULL = 2, BAR_EMPTY = 4;

template <typename TX, typename TQ, int BM, bool KC, bool VEC>
struct Shape {
  static constexpr int BN = 8192 / BM;                      // 128 or 64 columns
  static constexpr int WN = BN / 32;                        // product warps along N
  static constexpr int QB = sizeof(TQ);
  static constexpr int XB = sizeof(TX);
  static constexpr int NPL = QB == 1 ? 1 : 2;               // byte planes of q - c
  static constexpr int XP = XB == 4 ? 3 : 1;                // bf16 terms of x
  static constexpr int STAGES = XB == 2 ? 4 : 2;            // depth of the cp.async ring
  // raw tiles as cp.async writes them (rows padded by 16 bytes where
  // vector reads walk down them)
  static constexpr int RQ_ROW = KC ? BK * QB + 16 : BN * QB;
  static constexpr int RQ = (KC ? BN : BK) * RQ_ROW;
  static constexpr int RX_ROW = BK * XB + 16;
  static constexpr int RAW = RQ + BM * RX_ROW;              // one stage
  // two buffers of converted operands, bf16: q's byte planes ((K, N) q as
  // [p][k][n], embed.T as [p][n][k]) and x's terms [p][m][k]
  static constexpr int LDB = KC ? BK + 8 : BN + 8;
  static constexpr int BC = NPL * (KC ? BN : BK) * LDB * 2;
  static constexpr int LDX = BK + 8;
  static constexpr int XC = XP * BM * LDX * 2;
  static constexpr int RED = (BM * BK / 8 + BM) * 4;        // row sums of x, after the loop
  static_assert(RED <= 2 * BC, "row sums reuse the plane buffers");
  static constexpr int TILE = BM * BN * 4;                  // a chunk's partial products
  static constexpr int LOOP = (VEC ? STAGES * RAW : 0) + 2 * (BC + XC);
  static constexpr int SMEM = LOOP > TILE ? LOOP : TILE;
};

struct Args {
  const void* x;
  const void* q;
  const float* scale;
  const float* offset;
  float* out;
  long long sqk, sqn;
  int M, K, N, k_chunk;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <bool TRANS>
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  if constexpr (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(p)));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// Byte I of w minus a centre, as bf16 bits in the upper half of a float:
// 2^23 + byte by its bits (one byte permute), then one exact subtraction
// of 2^23 + centre (`bias`). The result is an integer in [-255, 255].
template <int I>
__device__ __forceinline__ uint32_t byte_less(uint32_t w, float bias) {
  return __float_as_uint(__uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540 + I)) - bias);
}

// Two such values as bf16x2 (their upper halves, exact): a low, b high.
__device__ __forceinline__ uint32_t pack_hi(uint32_t a, uint32_t b) {
  return __byte_perm(a, b, 0x7632);
}

// Eight q values (in words: 2 uint16 or 4 uint8 each) into bf16 planes:
// uint16 as (high byte - c_hi) and (low byte - c_lo), uint8 as q - c.
template <int QB>
__device__ __forceinline__ void to_planes(const uint32_t (&w)[8 * QB / 4], float bias_hi,
                                          float bias_lo, uint4 (&out)[QB]) {
  if constexpr (QB == 2) {
    uint32_t h[4], l[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      h[i] = pack_hi(byte_less<1>(w[i], bias_hi), byte_less<3>(w[i], bias_hi));
      l[i] = pack_hi(byte_less<0>(w[i], bias_lo), byte_less<2>(w[i], bias_lo));
    }
    out[0] = make_uint4(h[0], h[1], h[2], h[3]);
    out[1] = make_uint4(l[0], l[1], l[2], l[3]);
  } else {
    uint32_t v[4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      v[2 * i] = pack_hi(byte_less<0>(w[i], bias_lo), byte_less<1>(w[i], bias_lo));
      v[2 * i + 1] = pack_hi(byte_less<2>(w[i], bias_lo), byte_less<3>(w[i], bias_lo));
    }
    out[0] = make_uint4(v[0], v[1], v[2], v[3]);
  }
}

__device__ __forceinline__ uint32_t pack_rn(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// One block a SM: warps 0-7 load and convert, warps 8-15 run the products
// of the stage the converters finished before.
template <typename TX, typename TQ, int BM, bool KC, bool VEC>
__global__ void __launch_bounds__(THREADS, 1) dqmm_mma(const Args a) {
  using S = Shape<TX, TQ, BM, KC, VEC>;
  constexpr int BN = S::BN, NPL = S::NPL, XP = S::XP, QB = S::QB, LDB = S::LDB;
  constexpr int STAGES = S::STAGES;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* conv = smem + (VEC ? STAGES * S::RAW : 0);   // 2 x (planes, x terms)

  const TX* __restrict__ x = (const TX*)a.x;
  const TQ* __restrict__ q = (const TQ*)a.q;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.z * BM;
  const int k_begin = blockIdx.y * a.k_chunk;
  const int k_end = min(a.K, k_begin + a.k_chunk);
  const int n_iter = (k_end - k_begin + BK - 1) / BK;

  // the centre: the accumulator value whose weight is nearest 0
  const float scale = *a.scale, offset = *a.offset;
  const float cf = fminf(fmaxf(rintf(-offset / scale), 0.f), NPL == 1 ? 255.f : 65535.f);
  const int c = (int)cf;
  const float d = fmaf(scale, cf, offset);   // the weight of q == c

  // each converter thread's share of the row sums of x: row u / (BK/8)
  constexpr int XU = BM * BK / 8 / CT;
  float sx[XU];
#pragma unroll
  for (int i = 0; i < XU; ++i) sx[i] = 0.f;
  // each product warp: rows wm*32 + [0, 32), columns wn*32 + [0, 32)
  const int pw = warp - CONV_WARPS, wm = pw / S::WN, wn = pw % S::WN;
  float acc[NPL][2][4][4];
#pragma unroll
  for (int p = 0; p < NPL; ++p)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[p][i][j][e] = 0.f;

  if (warp < CONV_WARPS) {
    const float bias_hi = 8388608.f + (float)(c >> 8);
    const float bias_lo = 8388608.f + (float)(NPL == 1 ? c : c & 255);

    // raw tiles of stage `it` into ring slot `slot`, zero-filled past K, M, N
    auto load_stage = [&](int it, int slot) {
      const int k0 = k_begin + it * BK;
      unsigned char* rq = smem + slot * S::RAW;
      unsigned char* rx = rq + S::RQ;
      constexpr int V = 16 / QB;
      if constexpr (KC) {
        constexpr int CPR = BK / V;
        for (int i = tid; i < BN * CPR; i += CT) {
          const int n = i / CPR, k = k0 + (i % CPR) * V;
          const bool ok = n0 + n < a.N && k < k_end;
          cp16(rq + n * S::RQ_ROW + (i % CPR) * 16,
               ok ? q + (long long)(n0 + n) * a.sqn + k : q, ok);
        }
      } else {
        constexpr int CPR = BN / V;
        for (int i = tid; i < BK * CPR; i += CT) {
          const int kk = i / CPR, n = n0 + (i % CPR) * V;
          const bool ok = n < a.N && k0 + kk < k_end;
          cp16(rq + kk * S::RQ_ROW + (i % CPR) * 16,
               ok ? q + (long long)(k0 + kk) * a.sqk + n : q, ok);
        }
      }
      constexpr int XV = 16 / S::XB, XCPR = BK / XV;
      for (int i = tid; i < BM * XCPR; i += CT) {
        const int r = i / XCPR, k = k0 + (i % XCPR) * XV;
        const bool ok = m0 + r < a.M && k < k_end;
        cp16(rx + r * S::RX_ROW + (i % XCPR) * 16, ok ? x + (long long)(m0 + r) * a.K + k : x,
             ok);
      }
    };

    // q of one stage into the bf16 planes: a unit is 8 values along the
    // contiguous axis of both the raw tile and the plane (8 columns of one
    // row of K for (K, N) q, 8 rows of K of one column for embed.T). Past K
    // or N a value reads as c and contributes 0.
    constexpr int UPR = (KC ? BK : BN) / 8;   // units a row of the plane
    auto convert_q = [&](const unsigned char* rq, int k0, __nv_bfloat16* bc) {
#pragma unroll
      for (int i = 0; i < BN * BK / 8 / CT; ++i) {
        const int u = tid + i * CT, row = u / UPR, ug = u % UPR;   // (k, 8 n) or (n, 8 k)
        uint32_t w[2 * QB];
        if constexpr (VEC) {
          const unsigned char* p = rq + row * S::RQ_ROW + ug * 8 * QB;
          if constexpr (QB == 2) {
            const uint4 t = *reinterpret_cast<const uint4*>(p);
            w[0] = t.x, w[1] = t.y, w[2] = t.z, w[3] = t.w;
          } else {
            const uint2 t = *reinterpret_cast<const uint2*>(p);
            w[0] = t.x, w[1] = t.y;
          }
        } else {
#pragma unroll
          for (int j = 0; j < 2 * QB; ++j) w[j] = 0;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int k = k0 + (KC ? ug * 8 + j : row), n = n0 + (KC ? row : ug * 8 + j);
            const uint32_t v = (n < a.N && k < k_end)
                                   ? (uint32_t)q[(long long)k * a.sqk + (long long)n * a.sqn]
                                   : (uint32_t)c;
            w[j * QB / 4] |= v << (8 * QB * j % 32);
          }
        }
        uint4 out[NPL];
        to_planes<QB>(w, bias_hi, bias_lo, out);
#pragma unroll
        for (int p = 0; p < NPL; ++p)
          *reinterpret_cast<uint4*>(bc + (p * (KC ? BN : BK) + row) * LDB + ug * 8) = out[p];
      }
    };

    // x of one stage into its bf16 terms (hi, the rounded residual, its
    // residual for float32 x; x itself for bfloat16), and each thread's
    // share of the row sums (row u / (BK/8), 8 columns) in a fixed order
    auto convert_x = [&](const unsigned char* rx, int k0, __nv_bfloat16* xc) {
#pragma unroll
      for (int i = 0; i < XU; ++i) {
        const int u = tid + i * CT, r = u / (BK / 8), kg = u % (BK / 8);
        float v[8];
        uint32_t t[XP][4];
        if constexpr (VEC && XP == 1) {
          const uint4 raw = *reinterpret_cast<const uint4*>(rx + r * S::RX_ROW + kg * 16);
          t[0][0] = raw.x, t[0][1] = raw.y, t[0][2] = raw.z, t[0][3] = raw.w;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            v[2 * j] = __uint_as_float(t[0][j] << 16);
            v[2 * j + 1] = __uint_as_float(t[0][j] & 0xFFFF0000u);
          }
        } else {
          if constexpr (VEC) {
            const float4* p = reinterpret_cast<const float4*>(rx + r * S::RX_ROW + kg * 32);
            const float4 t0 = p[0], t1 = p[1];
            v[0] = t0.x, v[1] = t0.y, v[2] = t0.z, v[3] = t0.w;
            v[4] = t1.x, v[5] = t1.y, v[6] = t1.z, v[7] = t1.w;
          } else {
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const int k = k0 + kg * 8 + j;
              v[j] = (m0 + r < a.M && k < k_end) ? to_f(x[(long long)(m0 + r) * a.K + k]) : 0.f;
            }
          }
#pragma unroll
          for (int j = 0; j < 8; j += 2) {
            float r0 = v[j], r1 = v[j + 1];
#pragma unroll
            for (int p = 0; p < XP; ++p) {
              const uint32_t b = pack_rn(r0, r1);
              t[p][j / 2] = b;
              r0 -= __uint_as_float(b << 16);
              r1 -= __uint_as_float(b & 0xFFFF0000u);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) sx[i] += v[j];
#pragma unroll
        for (int p = 0; p < XP; ++p)
          *reinterpret_cast<uint4*>(xc + (p * BM + r) * S::LDX + kg * 8) =
              make_uint4(t[p][0], t[p][1], t[p][2], t[p][3]);
      }
    };

    if constexpr (VEC) {
#pragma unroll
      for (int st = 0; st < STAGES - 1; ++st) {
        if (st < n_iter) load_stage(st, st);
        cp_commit();
      }
    }
    for (int it = 0; it < n_iter; ++it) {
      const int k0 = k_begin + it * BK;
      const unsigned char* rq = smem + (it % STAGES) * S::RAW;
      if constexpr (VEC) cp_wait<STAGES - 2>();
      bar_sync(BAR_CONV, CT);   // stage `it` landed; slot it-1 is read by every converter
      if constexpr (VEC) {
        if (it + STAGES - 1 < n_iter) load_stage(it + STAGES - 1, (it + STAGES - 1) % STAGES);
        cp_commit();
      }
      if (it >= 2) bar_sync(BAR_EMPTY + it % 2, THREADS);   // the products of it-2 are done
      __nv_bfloat16* bc = reinterpret_cast<__nv_bfloat16*>(conv + (it % 2) * (S::BC + S::XC));
      convert_q(rq, k0, bc);
      convert_x(rq + S::RQ, k0, bc + S::BC / 2);
      __threadfence_block();
      bar_arrive(BAR_FULL + it % 2, THREADS);
    }
    // match the product warps' releases of the last two buffers
    for (int it = max(n_iter, 2); it < n_iter + 2; ++it) bar_sync(BAR_EMPTY + it % 2, THREADS);
  } else {
    for (int it = 0; it < n_iter; ++it) {
      bar_sync(BAR_FULL + it % 2, THREADS);
      const __nv_bfloat16* bc =
          reinterpret_cast<const __nv_bfloat16*>(conv + (it % 2) * (S::BC + S::XC));
      const __nv_bfloat16* xc = bc + S::BC / 2;
#pragma unroll
      for (int ks = 0; ks < BK; ks += 16) {
        uint32_t b[NPL][2][4];   // per plane, pairs of n8 tiles: (b0, b1) of each
#pragma unroll
        for (int p = 0; p < NPL; ++p)
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            if constexpr (KC)
              ldsm_x4<false>(b[p][jj], bc + (p * BN + wn * 32 + jj * 16 + (lane & 7) +
                                             ((lane >> 4) << 3)) * LDB +
                                                ks + ((lane >> 3) & 1) * 8);
            else
              ldsm_x4<true>(b[p][jj], bc + (p * BK + ks + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                               LDB + wn * 32 + jj * 16 + ((lane >> 4) << 3));
          }
#pragma unroll
        for (int xp = 0; xp < XP; ++xp) {
          uint32_t af[2][4];
#pragma unroll
          for (int i = 0; i < 2; ++i)
            ldsm_x4<false>(af[i], xc + (xp * BM + wm * 32 + i * 16 + (lane & 15)) * S::LDX +
                                      ks + (lane >> 4) * 8);
#pragma unroll
          for (int p = 0; p < NPL; ++p)
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                mma_bf16(acc[p][i][j], af[i], b[p][j / 2][(j & 1) * 2],
                         b[p][j / 2][(j & 1) * 2 + 1]);
        }
      }
      bar_arrive(BAR_EMPTY + it % 2, THREADS);
    }
  }

  // row sums of x over this chunk of K, added in a fixed order, in the
  // plane buffers now that every warp is done with them
  __syncthreads();
  float* red = reinterpret_cast<float*>(conv);   // (BM, BK/8) partial sums
  float* sxs = red + BM * BK / 8;                // (BM,) sums
  if (warp < CONV_WARPS) {
#pragma unroll
    for (int i = 0; i < XU; ++i) red[tid + i * CT] = sx[i];
  }
  __syncthreads();
  if (tid < BM) {
    float s = 0.f;
#pragma unroll
    for (int g = 0; g < BK / 8; ++g) s += red[tid * (BK / 8) + g];
    sxs[tid] = s;
  }
  __syncthreads();

  // One chunk of K: write y. Several: the chunks of a tile form a thread
  // block cluster; each leaves its partial products in its shared memory
  // and block r of the cluster adds the r-th share of the tile over all
  // chunks, in chunk order, through distributed shared memory.
  const bool split = gridDim.y > 1;
  const int g = lane >> 2, t = lane & 3;
  float bias[2][2];
  if (warp >= CONV_WARPS) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) bias[i][h] = d * sxs[wm * 32 + i * 16 + g + h * 8];
  }
  __syncthreads();   // the sums are read: the tile may overwrite them
  float* tile = reinterpret_cast<float*>(smem);
  if (warp >= CONV_WARPS) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wm * 32 + i * 16 + g + h * 8, m = m0 + row;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = wn * 32 + j * 8 + 2 * t + e, n = n0 + col;
            float v = acc[0][i][j][h * 2 + e];
            if constexpr (NPL == 2) v = fmaf(256.f, v, acc[NPL - 1][i][j][h * 2 + e]);
            v = fmaf(scale, v, bias[i][h]);
            if (split)
              tile[row * BN + col] = v;
            else if (m < a.M && n < a.N)
              a.out[(long long)m * a.N + n] = v;
          }
      }
  }
  if (!split) return;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int chunks = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int share = (BM * BN + chunks - 1) / chunks;
  const int e_end = min(BM * BN, (rank + 1) * share);
  for (int e = rank * share + tid; e < e_end; e += THREADS) {
    const int m = m0 + e / BN, n = n0 + e % BN;
    float s = 0.f;
    for (int r = 0; r < chunks; ++r) s += cluster.map_shared_rank(tile, r)[e];
    if (m < a.M && n < a.N) a.out[(long long)m * a.N + n] = s;
  }
  cluster.sync();   // no block leaves while others read its shared memory
}

// K is cut into chunks of a multiple of BK rows so that the (column tile,
// chunk, row tile) grid fills the SMs once, one block a SM, with at least
// 256 rows of K a chunk and at most 4 chunks (one thread block cluster);
// one chunk when the tiles alone fill the card.
template <typename TX, typename TQ, int BM, bool KC, bool VEC>
int launch(Args a, int sms, cudaStream_t stream) {
  using S = Shape<TX, TQ, BM, KC, VEC>;
  const int tiles = ((a.N + S::BN - 1) / S::BN) * ((a.M + BM - 1) / BM);
  const int want = max(1, min(min(sms / tiles, a.K / 256), 4));
  a.k_chunk = ((a.K + want - 1) / want + BK - 1) / BK * BK;
  const int splits = (a.K + a.k_chunk - 1) / a.k_chunk;
  auto kernel = dqmm_mma<TX, TQ, BM, KC, VEC>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
  if (attr) return (int)attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.N + S::BN - 1) / S::BN, splits, (a.M + BM - 1) / BM);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = S::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = splits;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  return (int)(err ? err : cudaGetLastError());
}

// 128-row tiles above M = 64 with bfloat16 x, else 64 rows: float32 x's
// three bf16 terms would not fit 128 rows in shared memory.
template <typename TX, typename TQ, bool KC, bool VEC>
int by_rows(const Args& a, int sms, cudaStream_t s) {
  if (sizeof(TX) == 2 && a.M > 64) return launch<TX, TQ, 128, KC, VEC>(a, sms, s);
  return launch<TX, TQ, 64, KC, VEC>(a, sms, s);
}

template <typename TX, typename TQ>
int by_layout(const Args& a, int sms, cudaStream_t s) {
  constexpr int V = 16 / sizeof(TQ), XV = 16 / sizeof(TX);
  const bool x_vec = a.K % XV == 0 && (uintptr_t)a.x % 16 == 0;
  const bool q_al = (uintptr_t)a.q % 16 == 0;
  if (a.sqk == 1 && a.sqn != 1) {   // K contiguous: embed.T
    if (x_vec && q_al && a.K % V == 0 && a.sqn % V == 0)
      return by_rows<TX, TQ, true, true>(a, sms, s);
    return by_rows<TX, TQ, true, false>(a, sms, s);
  }
  if (x_vec && q_al && a.sqn == 1 && a.N % V == 0 && a.sqk % V == 0)
    return by_rows<TX, TQ, false, true>(a, sms, s);
  return by_rows<TX, TQ, false, false>(a, sms, s);
}

template <typename TX>
int by_q(const Args& a, int q_bytes, int sms, cudaStream_t s) {
  switch (q_bytes) {
    case 1: return by_layout<TX, uint8_t>(a, sms, s);
    case 2: return by_layout<TX, uint16_t>(a, sms, s);
    default: return (int)cudaErrorInvalidValue;   // uint32 stays on the GEMV kernel
  }
}

}  // namespace

// x: (M, K) row-major, float32 (x_dtype 0) or bfloat16 (x_dtype 1).
// q: (K, N) with element strides (sqk, sqn), uint8/16 (q_bytes 1/2).
// scale, offset: one float32 each, in device memory.
// sms: the card's streaming multiprocessors. out: (M, N) float32,
// row-major.
extern "C" int dequant_matmul_mma(const void* x, int x_dtype, const void* q, int q_bytes,
                                  long long sqk, long long sqn, const float* scale,
                                  const float* offset, float* out, int M, int K, int N,
                                  int sms, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (M <= 0 || N <= 0 || K <= 0 || sms <= 0) return (int)cudaErrorInvalidValue;
  const Args a{x, q, scale, offset, out, sqk, sqn, M, K, N, 0};
  switch (x_dtype) {
    case 0: return by_q<float>(a, q_bytes, sms, s);
    case 1: return by_q<__nv_bfloat16>(a, q_bytes, sms, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
