// The plane mask of a truncated-precision view (QuantizedTensor.truncate):
// q keeps its top *keep of `bits` bits, (q >> s) << s with s = bits - *keep,
// which is q & (~0 << s). Returned as a 32-bit word of TQ-wide lanes, for
// an AND on the packed words of q before they are centred; all ones
// without keep. A shift of 32 or more clears q, as XLA's full-width shift.
#pragma once
#include <stdint.h>

template <typename TQ>
__device__ __forceinline__ uint32_t keep_mask(const int* keep, int bits) {
  if (keep == nullptr) return 0xFFFFFFFFu;
  const int s = bits - *keep;
  const uint32_t m = s <= 0 ? 0xFFFFFFFFu : s >= 32 ? 0u : 0xFFFFFFFFu << s;
  if constexpr (sizeof(TQ) == 1) return (m & 0xFFu) * 0x01010101u;
  if constexpr (sizeof(TQ) == 2) return (m & 0xFFFFu) * 0x00010001u;
  return m;
}
