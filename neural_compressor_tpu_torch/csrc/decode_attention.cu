// B = 1 single-token decode attention with the new row written inside the
// kernel (K16, set_cache_write_mode("kernel")): bf16 rows, or int8 codes it
// quantizes itself, on K5's and K6's split of the keys (csrc/decode_split.cuh,
// design in csrc/decode_split.cu).
//
// Replaces: neural_compressor_tpu/kernels/decode_attention.py
//   _decode_attn_impl / _kernel and _decode_attn_quant_impl / _kernel_q
//   (K16's in-kernel write, set_cache_write_mode("kernel")).
//
// Semantics (bf16): K5's: q [B, H, D] against caches [B, Hkv, T, D];
//   float32 scores times 1/sqrt(D); keys t > pos masked out; softmax;
//   probabilities normalised, then cast to bf16 before the PV product;
//   rep = H/Hkv query heads per KV head; bf16 output; row pos taken from
//   k_new / v_new and stored into the cache. Per-slot positions are an
//   int32 [B] tensor read on the device; at pos >= T all T rows are
//   attended and nothing is stored, as the TPU kernel's mask leaves them.
// Semantics (int8): K6's (s = f32(q . k) * f32(k_scale * 1/sqrt(D)), p =
//   bf16(f32(exp(s - m) / l) * v_scale)) with the new row QUANTIZED by the
//   TPU kernel's own rule, scale = f32(max(amax, 1e-6) * f32(1/127)) and
//   codes clip(rint(x / scale), -127, 127) (not _kv_quant's: amax <= 0 ->
//   1, clip to -128), the codes and scales stored at pos and the quantized
//   row (codes times the new scale) attended there. The TPU kernel rewrote
//   the whole aliased [T, D] block; here only the row is written.
//
// Bound on this card: bytes. Each visited cache row is read once for
//   2*rep*D flops: 2*Hkv*(pos+1)*D*2 bytes of K and V per layer for bf16,
//   2*Hkv*min(pos+1, T)*(D+4) for int8 codes and scales.
//
// Design: K5's launches for bf16 and K6's for int8 (decode_plan(B, H, Hkv,
//   T, D, fmt, k6=True): parts of 128 keys, grid (parts, Hkv*groups, B);
//   scores and part maxima, a third launch of l's part sums past 8 parts,
//   then p, PV and the ordered fold), with the new rows given (Args::kn,
//   vn) and Args::write set:
//   * bf16: every block whose part holds pos copies k_new (launch 1) or
//     v_new (launch 2) into its tile in place of the cache's row pos, so
//     each sum takes the row where K5 takes it from a cache that already
//     holds it: the output equals K5 plus the outside write bit for bit by
//     construction. Launch 1's block of query group 0 stores both rows at
//     pos; nothing in the call reads the cache there.
//   * int8: each launch-1 block whose part holds pos quantizes k_new (and,
//     in query group 0, v_new) in shared memory, scores the row as its codes
//     times the new scale, and leaves the cache's row out of its tiles;
//     group 0's block stores the codes and both scales. The PV blocks read
//     row pos from the cache like any other row: the one whose part holds
//     it stages its tiles only after launch 1 has finished (it is a
//     dependent launch, and the others stage before they wait).
//   The one-block-a-head kernels this replaced ran Hkv*B*ng blocks (32 for
//   a llama2-7b layer), each walking every visited row.
//   Scratch and the argument block come from decode_workspace, cached per
//   plan and device: no per-call allocation but the output.
#include "decode_split.cuh"

using namespace nctt_dsplit;

// K16's in-kernel write: q bf16 [B, H, D]; k_new/v_new bf16 [B, Hkv, D];
// fmt 0: caches bf16 [B, Hkv, T, D] (scales null); fmt 1: int8 codes
// [B, Hkv, T, D] with scales f32 [B, Hkv, T]. Stores each slot's new row at
// pos[b] < T (int8: quantized by the TPU kernel's rule) and attends it; pos
// int32 [B] on the device; out bf16 [B, H, D]; `plan` K5's / K6's argument
// block (decode_attention.decode_workspace of decode_plan with k6).
// 1 <= D <= 256; H % Hkv == 0. Two or three launches on `stream`.
NCTT_API int nctt_decode_attention_write(
    const void* q, const void* kn, const void* vn, void* kc, void* ks,
    void* vc, void* vs, const void* pos, void* out, const void* plan, int B,
    int H, int Hkv, int T, int D, int fmt, float scale, void* stream) {
  Args a;
  if ((fmt != 0 && fmt != 1) ||
      !fill(a, q, kc, vc, ks, vs, pos, out, (const long long*)plan, H, Hkv,
            T, D, fmt ? 1 : 2, scale) ||
      D > 256 || (!a.lsum && a.parts > LSUM_MAX))
    return (int)cudaErrorInvalidValue;
  a.kn = (const __nv_bfloat16*)kn;
  a.vn = (const __nv_bfloat16*)vn;
  a.write = 1;
  // bf16 stages the new rows by the same 16-byte copies as the cache's
  a.vec = a.vec && ((uintptr_t)kn & 15) == 0 && ((uintptr_t)vn & 15) == 0;
  cudaStream_t s = (cudaStream_t)stream;
  return fmt ? dispatch_int8(true, a, B, s) : dispatch_k5(a, B, s);
}
