// K6 and K7: one decode step of attention over a block-paged KV cache, for
// Hopper (sm_90a). Replaces the TPU kernels
// src/repro/kernels/paged_attend_decode.py::paged_int8_attend_decode (K6,
// kv_bits = 8 and 4) and ::paged_attend_decode (K7, f32/bf16 arenas), whose
// shared body is _paged_kernel. Each cell finds its physical block through
// the lane's row of the block table and derives its position from (L,
// q_pos, s_cap), so stale cells of a reused block are never read as valid.
//
// K5, K6 and K7 share one body, the split-KV kernel of split_attend.cuh:
// here with its PAGED flag, int8 payloads for K6 and float (f32 or bf16)
// payloads for K7. A split owns a run of the lane's paged blocks
// (kernels/paged_attend_decode.py, plan_kv_splits).
#include "split_attend.cuh"

namespace {

bool bad_plan(int splits, int bps, int nb) {
  return splits < 1 || splits > splitkv::kMaxSplits || bps < 1 ||
         bps > splitkv::kMaxBlocks || (splits - 1) * bps >= nb ||
         splits * bps < nb;
}

}  // namespace

// K6. q_q (B,KV,G,hd) int8; q_scale/q_zp (B,KV,G) f32; k_zp/v_zp (B,KV) f32;
// k_arena/v_arena (N,bs,KV,hd) int8; k_scale/v_scale (N,bs,KV) f32; table
// (B,nb) int32 (-1 = unmapped), nb * bs >= s_cap; q_pos (B,) int32 (-1 =
// idle lane); sm/smo (2,) f32 or null; out (B,KV,G,hd) f32, or, with out_q
// non-null, out null and out_q (B,KV*G*hd) int8 = clip(rint(v / out_scale)
// + out_zp, out_qmin, out_qmax) with out_scale/out_zp (1,) f32. All
// contiguous. kv_bits = 4: arenas are (N,bs,KV,hd/2) split-half nibbles,
// hd % 8 == 0.
// splits x bps blocks cover the nb blocks (splits <= 32, bps <= 256); ws
// holds B*KV*splits*G*(hd+2) f32, counters B*KV zeroed ints (left zeroed).
// Returns cudaGetLastError().
extern "C" int paged_int8_attend_decode(
    const void* q_q, const void* q_scale, const void* q_zp, const void* k_zp,
    const void* v_zp, const void* k_arena, const void* k_scale,
    const void* v_arena, const void* v_scale, const void* table,
    const void* q_pos, const void* sm, const void* smo, void* out,
    void* out_q, const void* out_scale, const void* out_zp, int out_qmin,
    int out_qmax, int batch, int kv, int g, int hd, int nb, int bs,
    int s_cap, int window, float softcap, int sm_qmin, int sm_qmax,
    int smo_qmin, int smo_qmax, int kv_bits, int splits, int bps, void* ws,
    void* counters, void* stream) {
  if (batch <= 0 || kv <= 0) return (int)cudaGetLastError();
  if (bad_plan(splits, bps, nb)) return (int)cudaErrorInvalidValue;
  splitkv::SplitArgs a = splitkv::quant_args(
      q_q, q_scale, q_zp, k_zp, v_zp, k_arena, k_scale, v_arena, v_scale,
      q_pos, sm, smo, out, out_q, out_scale, out_zp, out_qmin, out_qmax,
      batch, kv, g, hd, window, softcap, sm_qmin, sm_qmax, smo_qmin,
      smo_qmax, kv_bits, splits, bps, ws, counters);
  a.table = (const int*)table;
  a.nb = nb;
  a.bs = bs;
  a.s_cap = s_cap;
  return splitkv::launch<true>(a, kv_bits, stream);
}

// K7. q (B,KV,G,hd) f32 with the attention scale folded in; k_arena/v_arena
// (N,bs,KV,hd) f32 (kv_is_bf16 = 0) or bf16 (kv_is_bf16 = 1), 4-byte
// aligned (16-byte aligned rows are copied 16 bytes at a time); out, out_q
// and the rest as in paged_int8_attend_decode. hd % 4 == 0, hd <= 256,
// G <= 8. Returns cudaGetLastError().
extern "C" int paged_attend_decode(
    const void* q, const void* k_arena, const void* v_arena, int kv_is_bf16,
    const void* table, const void* q_pos, const void* sm, const void* smo,
    void* out, void* out_q, const void* out_scale, const void* out_zp,
    int out_qmin, int out_qmax, int batch, int kv, int g, int hd, int nb,
    int bs, int s_cap, int window, float softcap, int sm_qmin, int sm_qmax,
    int smo_qmin, int smo_qmax, int splits, int bps, void* ws,
    void* counters, void* stream) {
  if (batch <= 0 || kv <= 0) return (int)cudaGetLastError();
  if (bad_plan(splits, bps, nb)) return (int)cudaErrorInvalidValue;
  splitkv::SplitArgs a = splitkv::base_args(
      k_arena, v_arena, hd * (kv_is_bf16 ? 2 : 4), q_pos, sm, smo, out,
      out_q, out_scale, out_zp, out_qmin, out_qmax, batch, kv, g, hd,
      window, softcap, sm_qmin, sm_qmax, smo_qmin, smo_qmax, splits, bps,
      ws, counters);
  a.qf = (const float*)q;
  a.table = (const int*)table;
  a.nb = nb;
  a.bs = bs;
  a.s_cap = s_cap;
  if (kv_is_bf16)
    return splitkv::launch_float<__nv_bfloat16>(a, stream);
  return splitkv::launch_float<float>(a, stream);
}
