// Single-token decode attention over a contiguous head-major KV cache with
// each slot's keys split into fixed parts: K7 (batched, bf16 rows or int8 /
// fp8-e4m3 codes), K6 (int8 / fp8 codes with the raw new row) and K5 (bf16
// rows, the B=1 decode of every served model). K16's in-kernel write (its C
// entry in csrc/decode_attention.cu) and K18's attention (csrc/attn_o.cu)
// run K5's and K6's launches too.
//
// Replaces: neural_compressor_tpu/kernels/decode_attention.py
//   _batched_attn_impl / _kernel_batched (K7), bf16 caches and the quant
//   branch (int8 / fp8 codes), _decode_attn_quant_ro_impl /
//   _kernel_q_ro (K6) and _decode_attn_ro_impl / _kernel_ro (K5).
//
// Semantics (as K7): q [B, H, D] against caches [B, Hkv, T, D] that already
//   hold each slot's new row at pos[b] (int32 [B], read on the device: no
//   host sync a layer); s = f32(q . k) [* k_scale] * 1/sqrt(D) (two float32
//   products, in K7's order); keys t > pos[b] masked out (a slot at or past
//   T - 1 attends every row: the engine parks its idle slots on row T - 1);
//   p = exp(s - m) [* v_scale] rounded to bf16 for PV, m the maximum over
//   the slot's whole row; l = sum exp(s - m) unrounded; out = f32(acc) / l,
//   normalised after PV as K7 does; rep = H/Hkv query rows a KV head; bf16
//   out. Quantized caches hold the slot's OWN quantized new row.
// Semantics (as K6): the same walk over codes with the RAW bf16 new row
//   (k_new, v_new [B, Hkv, D]) at pos and scale 1 there, whatever the cache
//   holds at pos; at pos >= T every code row and no raw row; s = f32(q . k)
//   * f32(k_scale * 1/sqrt(D)); p = bf16(f32(exp(s - m) / l) * v_scale),
//   normalised BEFORE the bf16 cast, so l is needed before PV; out =
//   bf16(f32(acc)). int8 and e4m3 codes convert to float64 exactly.
// Semantics (as K5): K6's over a bf16 cache that already holds the new row
//   at pos (the port writes it in place first; the TPU kernel folds the
//   same bf16 row in by a select), scales of 1 and no raw row: s = f32(q .
//   k) * 1/sqrt(D), p = bf16(f32(exp(s - m) / l)), out = bf16(f32(acc)).
//   Its launches are K6's (kernels/decode_attention.py decode_plan with
//   k6, csrc/decode_split_k5.cu), with k_new null.
//
// Bound on this card: bytes. Each visited cache row is read once for
//   2*rep*D flops: 2*Hkv*(pos[b]+1)*D*2 bytes of K and V a slot for bf16,
//   2*Hkv*(pos[b]+1)*(D+4) for codes and scales (K5: bf16 rows, B = 1 in
//   the decode step). The design adds 4 bytes a
//   (query row, key) of float32 scores, written by launch 1 and read by
//   launch 2 (through L2 at the engine's sizes).
//
// Design: the template is K11's split (csrc/paged_attention.cuh) over a
//   cache whose rows are consecutive: no block table. It answers what held
//   the one-block-a-head kernels back: one row in flight a warp behind a
//   float64 shuffle chain a row, only B*Hkv*ng blocks (32 for a B=1
//   llama2-7b layer on 132 SMs; the longest of 8 slots setting the engine
//   step), and a softmax run by one warp a query row.
//   * Parts. kernels/decode_attention.py decode_plan cuts a slot's keys into
//     parts of a fixed number of keys (whole 64-row tiles, 128 keys up to
//     8,192-row caches, longer parts past that so that a slot has at most
//     64), absolute positions that depend on T alone: never on B, rep, pos
//     or the other slots, so a row's terms are summed in the same order
//     whatever shares the launch. The rep query rows of a (slot, KV head)
//     split into ng balanced groups of at most 8 (6 past D 384). Every
//     launch has one block per (part, KV head x group, slot), grid (parts,
//     Hkv*ng, B); a block whose part starts past its slot's last visited
//     row exits at once. A B=1 llama2-7b layer at pos 517 runs 160 blocks.
//   * Staging. A block walks its part in tiles of 64 rows, each one
//     contiguous slab of the cache; every thread issues 16-byte cp.async
//     copies (nctt::cp_async) of the slab into a ring of up to `stages`
//     tiles in shared memory, all of a part's tiles in flight at once
//     where the ring holds them; where a row is not a whole number of
//     16-byte chunks, scalar loads fill the tile and zero its tail. Staged
//     rows are padded to an odd number of 16-byte chunks (bank-conflict
//     free 16-byte reads).
//   * Launch 1: scores and part maxima. Thread (key pair, D segment h)
//     sums one segment of q . k for keys kp and kp + 32 of a tile and
//     every row of its group in float64, elements ascending; segments add
//     in ascending order: no shuffle a key, each element converted to
//     float64 once by exact bit moves and reused across the group's rows.
//     The scores go to the float32 workspace, each row's maximum over the
//     part to pmax [B, H, parts]. K6's raw row (the last visited key when
//     0 <= pos < T) is dotted by one warp a row from k_new.
//   * K6's l (launch 2 needs it whole): sum over the parts in ascending
//     order of each part's sum of exp(s - m), m the row's global maximum;
//     within a part thread j takes keys j, j + NT, ... ascending, lanes add
//     by nctt::warp_sum's butterfly and warps in ascending order. It is
//     the one float64 sum that is not exact, and its order is fixed by the
//     plan. With up to 8 parts (LSUM_MAX) each PV block sums the slot's
//     whole score row itself (L floats from L2, every part's loads issued
//     before any shuffle); with more (the plan's `lsum`) a third small
//     launch sums each part once into lpart and PV adds them.
//   * Launch 2: p, PV and the fold. A block takes each row's global
//     maximum from the part maxima (fmaxf: order-free), forms p for the
//     (row, slot) pairs of a tile from scores and v scales fetched a tile
//     ahead (K7 also the tile's sum of exp by a fixed butterfly over 32
//     slots, tiles added in ascending order: the part's l), stages the V
//     tiles the same way, and thread (column, slot group) sums p * v in
//     float64 over its slots in ascending order, loads ahead of the
//     products; slot groups add in ascending order through the free ring.
//     K6's raw row adds p * v_new after the tiles (its code row at pos is
//     read as zeros). Partials go to part [B, H, parts, D + 1] (acc, then
//     K7's l); the last block of a (slot, KV head, group), by an atomic
//     ticket taken after __threadfence(), folds the parts in ascending
//     order, K7 divides by f32(l), writes bf16 and resets its ticket to 0.
//     A group whose keys lie in one part writes its output directly.
//   * Numerics. Every product is exact in float64 (bf16 x bf16, codes x
//     bf16 q or p: at most 24 bits), so the sums of launch 1 and PV are
//     exact in practice and their order does not show: the kernels and
//     their plain versions (kernels/decode_attention.py) agree bit for
//     bit. The maximum is global before p is rounded: a flash-decoding
//     fold of per-part maxima would round p against the wrong maximum.
//   * Copies: D 128 (single-row groups with the row count at compile time,
//     at 128 or 256 threads as the plan says) and 256; any other D at run
//     time (K7 to 512 with four columns a PV thread). This source holds
//     the C entries and K7's bf16 copies; decode_split_k5.cu K6's kernels
//     over bf16 rows (K5), decode_split_int8.cu and decode_split_fp8.cu
//     the quantized formats, so the build compiles the four in parallel.
//   * Launch latency. Each block issues its first tiles' copies before its
//     other loads (q; the maxima and scores). The PV launch, and K6's part
//     sums, go out as programmatic dependent launches (Hopper's
//     griddepcontrol): once every block of the launch before has allowed
//     it (K6's first thing, K7's after reading their tiles), their blocks
//     take the room it leaves on the SMs, stage their V tiles, and wait
//     for that launch to finish before they read its scores and maxima.
//     The next call's scores launch is an ordinary one, so it never
//     overlaps the reads of this call's scratch. A bulk prefetch of each
//     part's V rows into L2 by the scores blocks measured slower
//     (tools/decode_attn_sweep.py): the two streams contend for DRAM, and
//     PV is bound by its chain of dependent steps, not by its bytes.
//   * K16's write and K18 (their sources say more). K16's bf16 write
//     stages k_new / v_new in place of the cache's row pos and group 0's
//     scores block stores them there: K5's arithmetic over a cache that
//     holds the row, bit for bit by construction. Its int8 write quantizes
//     the row in launch 1 (every block whose part holds pos), scores it as
//     codes times the new scale, and group 0's block stores codes and
//     scales; the PV block holding pos stages its tiles after launch 1 and
//     reads them from the cache. K18's PV stores float32 rows and takes one
//     atomicMax of |o| a block into a word that launch 1 zeroes; one more
//     launch quantizes and projects them.
//   * Host. One argument block (kernels/decode_attention.py
//     decode_workspace: the scratch's addresses and the plan, cached per
//     plan and device) keeps the C entry's arguments as few as the
//     one-launch kernels had. The score rows [B, H, T] float32, the part
//     maxima, the partials, K6's part sums and the zeroed int32 tickets
//     are flat buffers kept per device between calls.
#include "decode_split.cuh"

using namespace nctt_dsplit;

// The arguments of a call; 0 where they are not valid. `plan` holds the
// scratch's addresses and the plan (kernels/decode_attention.py
// decode_workspace), in PlanWord's order.
int nctt_dsplit::fill(Args& a, const void* q, const void* kc, const void* vc,
                      const void* ks, const void* vs, const void* pos,
                      void* out, const long long* plan, int H, int Hkv, int T,
                      int D, int esize, float scale) {
  const int ng = (int)plan[W_NG], part_keys = (int)plan[W_PART_KEYS];
  const int parts = (int)plan[W_PARTS];
  if (D < 1 || D > 512 || Hkv < 1 || H % Hkv || T < 1 || ng < 1 ||
      part_keys < SLOTS || part_keys % SLOTS || parts < 1 ||
      (long long)parts * part_keys < T)
    return 0;
  a.q = (const __nv_bfloat16*)q;
  a.kc = (const uint8_t*)kc;
  a.vc = (const uint8_t*)vc;
  a.ks = (const float*)ks;
  a.vs = (const float*)vs;
  a.kn = a.vn = nullptr;
  a.pos = (const int*)pos;
  a.out = (__nv_bfloat16*)out;
  a.ws = (float*)plan[W_WS];
  a.pmax = (float*)plan[W_PMAX];
  a.part = (double*)plan[W_PART];
  a.lpart = (double*)plan[W_LPART];
  a.tickets = (int*)plan[W_TICKETS];
  a.att = nullptr;
  a.amax = nullptr;
  a.H = H;
  a.Hkv = Hkv;
  a.T = T;
  a.D = D;
  a.ng = ng;
  a.part_keys = part_keys;
  a.parts = parts;
  a.stages = (int)plan[W_STAGES];
  a.threads = (int)plan[W_THREADS];
  a.lsum = (int)plan[W_LSUM];
  a.vec = (D * esize) % 16 == 0 && ((uintptr_t)kc & 15) == 0 &&
          ((uintptr_t)vc & 15) == 0;
  a.write = 0;
  a.scale = scale;
  return 1;
}

// K7. q bf16 [B, H, D]; caches [B, Hkv, T, D] holding each slot's row
// pos[b]: bf16 (code 0; ks/vs null), int8 (code 1) or e4m3 (code 2) with
// scales f32 [B, Hkv, T]; pos int32 [B]; out bf16 [B, H, D]. `plan`,
// thirteen 64-bit words (kernels/decode_attention.py decode_workspace): the
// scratch's addresses, ws f32 [B, H, T] scores, pmax f32 [B, H, parts],
// part f64 [B, H, parts, D + 1], lpart (K6's), tickets int32 [B*Hkv*ng]
// zeroed (each call leaves them zeroed), K18's att and amax (unused here);
// then the plan (decode_plan): ng groups of query rows, parts of part_keys
// keys (a multiple of 64), `parts` of them over T, a ring of `stages`
// tiles, `threads` a block, lsum (K6's). 1 <= D <= 256, or D = 353..384 or
// 481..512; H % Hkv == 0. Two launches on `stream`.
NCTT_API int nctt_batched_decode_attention(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* pos, void* out, const void* plan, int B,
    int H, int Hkv, int T, int D, int code, float scale, void* stream) {
  Args a;
  if (!fill(a, q, k, v, ks, vs, pos, out, (const long long*)plan, H, Hkv, T,
            D, code ? 1 : 2, scale) ||
      (D > 256 && !((D > 352 && D <= 384) || D > 480)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (code) {
    case BF16: return dispatch<BF16, false>(a, B, s);
    case INT8: return dispatch_int8(false, a, B, s);
    case FP8: return dispatch_fp8(false, a, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K5. q bf16 [B, H, D]; caches bf16 [B, Hkv, T, D] holding row pos[b]; pos
// int32 [B] on the device (pos >= T: all T rows); out bf16 [B, H, D].
// `plan` as K6's (decode_plan with k6). 1 <= D <= 256; H % Hkv == 0. Two or
// three launches on `stream`.
NCTT_API int nctt_decode_attention(const void* q, const void* k,
                                   const void* v, const void* pos,
                                   void* out, const void* plan, int B, int H,
                                   int Hkv, int T, int D, float scale,
                                   void* stream) {
  Args a;
  if (!fill(a, q, k, v, nullptr, nullptr, pos, out, (const long long*)plan,
            H, Hkv, T, D, 2, scale) ||
      D > 256 || (!a.lsum && a.parts > LSUM_MAX))
    return (int)cudaErrorInvalidValue;
  return dispatch_k5(a, B, (cudaStream_t)stream);
}

// K6. q bf16 [B, H, D]; k_new/v_new bf16 [B, Hkv, D] (the raw new rows, at
// pos[b]); codes int8 (fp8 = 0) or e4m3 (fp8 = 1) [B, Hkv, T, D]; scales
// f32 [B, Hkv, T]; pos int32 [B] on the device (pos >= T: all T code rows,
// no raw row); out bf16 [B, H, D]. `plan` as K7's, with lpart f64 [B, H,
// parts], the part sums of exp that a third launch writes where lsum is 1.
// 1 <= D <= 256; H % Hkv == 0. Two or three launches on `stream`.
NCTT_API int nctt_decode_attention_quant(
    const void* q, const void* kn, const void* vn, const void* kc,
    const void* ks, const void* vc, const void* vs, const void* pos,
    void* out, const void* plan, int B, int H, int Hkv, int T, int D,
    int fp8, float scale, void* stream) {
  Args a;
  if (!fill(a, q, kc, vc, ks, vs, pos, out, (const long long*)plan, H, Hkv,
            T, D, 1, scale) ||
      D > 256 || (!a.lsum && a.parts > LSUM_MAX))
    return (int)cudaErrorInvalidValue;
  a.kn = (const __nv_bfloat16*)kn;
  a.vn = (const __nv_bfloat16*)vn;
  cudaStream_t s = (cudaStream_t)stream;
  return fp8 ? dispatch_fp8(true, a, B, s) : dispatch_int8(true, a, B, s);
}
