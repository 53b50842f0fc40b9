// Words of up to 16 bytes for the elementwise bit-plane kernels: a thread's
// E elements of one operand, loaded or stored as whole words, so neighbouring
// threads touch neighbouring words.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

template <int BYTES>
struct Word { using type = uint4; };
template <>
struct Word<8> { using type = uint2; };
template <>
struct Word<4> { using type = uint32_t; };

template <typename T, int E>
union Pack {
  using W = typename Word<(E * sizeof(T) < 16 ? E * sizeof(T) : 16)>::type;
  W raw[E * sizeof(T) / sizeof(W)];
  T e[E];
};

// the i-th group of E elements from base (aligned to 16 bytes)
template <typename T, int E>
__device__ __forceinline__ Pack<T, E> load_pack(const T* base, long long i) {
  using P = Pack<T, E>;
  constexpr int R = sizeof(P) / sizeof(typename P::W);
  P p;
  const typename P::W* src = reinterpret_cast<const typename P::W*>(base) + i * R;
#pragma unroll
  for (int k = 0; k < R; ++k) p.raw[k] = src[k];
  return p;
}

template <typename T, int E>
__device__ __forceinline__ void store_pack(T* base, long long i, const Pack<T, E>& p) {
  using P = Pack<T, E>;
  constexpr int R = sizeof(P) / sizeof(typename P::W);
  typename P::W* dst = reinterpret_cast<typename P::W*>(base) + i * R;
#pragma unroll
  for (int k = 0; k < R; ++k) dst[k] = p.raw[k];
}
