// Ragged batched GQA attention of T query tokens per slot against the
// slot's KV cache: the speculative verify block and the chunked-prefill
// block, each row with its own position (a negative position masks the row).
//
// Replaces src/repro/kernels/verify_attention.py `flash_verify` (the Pallas
// `_kernel`). Bound: device-memory bytes; each block of 8 compute warps
// reads its (slot, kv-head) cache row once, through a ring of 32-key chunks
// that a copy warp fills, for up to 8 rows, each lane scoring one key
// against all of them. The
// Pallas kernel transposes q to (B, Kh, T*G, hd), pads the rows to 8
// sublanes and pads S on the host; here the kernel reads q and writes out in
// their (B, T, H, hd) layout through strides and masks the ragged edge
// itself. The body is attention_rows.cuh's, which flash_decode
// (decode_attention.cu) compiles with the same flags: a row's arithmetic
// depends only on S, hd and the dtype, so every row is bit-identical to a
// flash_decode launch at that row's query and position, and chunked prefill
// and verify equal sequential decode row for row.
#include "attention_rows.cuh"

// q: (B, T, H, hd) with element strides (q_sb, q_st, hd, 1); k, v:
// contiguous (B, Kh, S, hd); all of one dtype, float32 (dtype 0) or bfloat16
// (dtype 1). k_pos: int32 (B, S) with element strides (kp_sb, kp_ss); q_pos:
// int32 (B, T) with element strides (qp_sb, qp_st). out: contiguous
// (B, T, H, hd) in q's dtype. scale is hd**-0.5 rounded to float32.
// H % Kh == 0, hd <= 256.
extern "C" int flash_verify(const void* q, long long q_sb, long long q_st, const void* k,
                            const void* v, const int* k_pos, long long kp_sb,
                            long long kp_ss, const int* q_pos, long long qp_sb,
                            long long qp_st, void* out, int B, int T, int H, int Kh, int S,
                            int hd, int window, float softcap, float scale, int dtype,
                            void* stream) {
  const long long o_st = (long long)H * hd;
  return attn_rows::launch(q, q_sb, q_st, k, v, k_pos, kp_sb, kp_ss, q_pos, qp_sb, qp_st,
                           out, (long long)T * o_st, o_st, B, T, H, Kh, S, hd, window,
                           softcap, scale, dtype, (cudaStream_t)stream);
}
