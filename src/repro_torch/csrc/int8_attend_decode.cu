// K5: one decode step of attention over a dense int8 or int4 KV cache, for
// Hopper (sm_90a). Replaces the TPU kernel
// src/repro/kernels/int8_attend_decode.py::int8_attend_decode (body
// _attend_decode_kernel, kv_bits = 8 and 4). Bound by bytes (the cache
// read). It runs the split-KV body of split_attend.cuh (shared with K6 and
// K7) on int8 payloads without its PAGED flag: split j of a lane owns the
// cells [j * cps, (j + 1) * cps) (kernels/int8_attend_decode.py,
// plan_dense_kv_splits) and reads each cell's validity from its stored
// position, since the cache of a sliding-window layer is a ring that wraps.
#include "split_attend.cuh"

// q_q (B,KV,G,hd) int8; q_scale/q_zp (B,KV,G) f32 (attention scale folded
// into q_scale); k_zp/v_zp (B,KV) f32; k_q/v_q (B,S,KV,hd) int8;
// k_scale/v_scale (B,S,KV) f32; k_pos (B,S) int32; q_pos (B,) int32;
// sm/smo (2,) f32 or null; out (B,KV,G,hd) f32, or out null and out_q
// (B,KV*G*hd) int8 as in paged_int8_attend_decode. All contiguous.
// hd % 4 == 0, hd <= 256, G <= 8; window 0 and softcap 0 mean none. kv_bits = 4: k_q/v_q
// are (B,S,KV,hd/2) split-half nibbles and hd % 8 == 0. splits x cps cells
// cover the S cells, none empty (splits <= 32); ws holds
// B*KV*splits*G*(hd+2) f32, counters B*KV zeroed ints (left zeroed).
// Returns cudaGetLastError().
extern "C" int int8_attend_decode(
    const void* q_q, const void* q_scale, const void* q_zp, const void* k_zp,
    const void* v_zp, const void* k_q, const void* k_scale, const void* v_q,
    const void* v_scale, const void* k_pos, const void* q_pos,
    const void* sm, const void* smo, void* out, void* out_q,
    const void* out_scale, const void* out_zp, int out_qmin, int out_qmax,
    int batch, int kv, int g, int hd, int s_len, int window, float softcap,
    int sm_qmin, int sm_qmax, int smo_qmin, int smo_qmax, int kv_bits,
    int splits, int cps, void* ws, void* counters, void* stream) {
  if (batch <= 0 || kv <= 0) return (int)cudaGetLastError();
  if (splits < 1 || splits > splitkv::kMaxSplits || cps < 1 ||
      (long)(splits - 1) * cps >= s_len || (long)splits * cps < s_len)
    return (int)cudaErrorInvalidValue;
  splitkv::SplitArgs a = splitkv::quant_args(
      q_q, q_scale, q_zp, k_zp, v_zp, k_q, k_scale, v_q, v_scale, q_pos, sm,
      smo, out, out_q, out_scale, out_zp, out_qmin, out_qmax, batch, kv, g,
      hd, window, softcap, sm_qmin, sm_qmax, smo_qmin, smo_qmax, kv_bits,
      splits, cps, ws, counters);
  a.k_pos = (const int*)k_pos;
  a.s_len = s_len;
  return splitkv::launch<false>(a, kv_bits, stream);
}
