// Ragged batched GQA decode attention: one new query token per slot
// against the slot's KV cache, with an online softmax.
//
// Replaces src/repro/kernels/decode_attention.py `flash_decode` (the Pallas
// `_kernel`). Bound: device-memory bytes; every cache byte of K and V is read
// once per decode step. The kernel is attention_rows.cuh's body at one token
// per slot: one block of 8 warps per (slot, kv-head) holds the G query heads
// of the slot's token as its rows (a second block per 8 heads beyond the
// first 8); the slot's keys are staged in chunks of 32 through a ring in
// shared memory, fed by a copy warp through the tensor memory accelerator,
// one key a lane for the scores. flash_verify (verify_attention.cu)
// compiles the same body, so each of its rows is bit-identical to this
// kernel at that row's query and position.
#include "attention_rows.cuh"

// q: (B, H, hd); k, v: (B, Kh, S, hd), all contiguous and of one dtype,
// float32 (dtype 0) or bfloat16 (dtype 1). k_pos: int32 (B, S) with element
// strides (kp_sb, kp_ss); q_pos: int32 (B,). out: (B, H, hd) in q's dtype.
// scale is hd**-0.5 rounded to float32, as the plain version computes it.
// H % Kh == 0, hd <= 256.
extern "C" int flash_decode(const void* q, const void* k, const void* v, const int* k_pos,
                            long long kp_sb, long long kp_ss, const int* q_pos, void* out,
                            int B, int H, int Kh, int S, int hd, int window, float softcap,
                            float scale, int dtype, void* stream) {
  const long long row = (long long)H * hd;
  return attn_rows::launch(q, row, 0, k, v, k_pos, kp_sb, kp_ss, q_pos, 1, 0, out, row, 0,
                           B, 1, H, Kh, S, hd, window, softcap, scale, dtype,
                           (cudaStream_t)stream);
}
