// K5: one decode step of attention over a dense int8 KV cache, for Hopper
// (sm_90a). Replaces the TPU kernel
// src/repro/kernels/int8_attend_decode.py::int8_attend_decode (body
// _attend_decode_kernel, kv_bits = 8 and 4). Bound by bytes (the cache
// read); the design is in attend_decode.cuh, shared with the paged kernels.
#include "attend_decode.cuh"

// q_q (B,KV,G,hd) int8; q_scale/q_zp (B,KV,G) f32 (attention scale folded
// into q_scale); k_zp/v_zp (B,KV) f32; k_q/v_q (B,S,KV,hd) int8;
// k_scale/v_scale (B,S,KV) f32; k_pos (B,S) int32; q_pos (B,) int32;
// sm/smo (2,) f32 or null; out (B,KV,G,hd) f32. All contiguous. hd % 4 == 0,
// hd <= 256, G <= 8; window 0 and softcap 0 mean none. kv_bits = 4: k_q/v_q
// are (B,S,KV,hd/2) split-half nibbles and hd % 8 == 0.
// Returns cudaGetLastError().
extern "C" int int8_attend_decode(
    const void* q_q, const void* q_scale, const void* q_zp, const void* k_zp,
    const void* v_zp, const void* k_q, const void* k_scale, const void* v_q,
    const void* v_scale, const void* k_pos, const void* q_pos,
    const void* sm, const void* smo, void* out, int batch, int kv, int g,
    int hd, int s_len, int window, float softcap, int sm_qmin, int sm_qmax,
    int smo_qmin, int smo_qmax, int kv_bits, void* stream) {
  attend::Args a = {};
  a.q = q_q;
  a.q_scale = (const float*)q_scale;
  a.q_zp = (const float*)q_zp;
  a.k_zp = (const float*)k_zp;
  a.v_zp = (const float*)v_zp;
  a.k = k_q;
  a.v = v_q;
  a.k_scale = (const float*)k_scale;
  a.v_scale = (const float*)v_scale;
  a.k_pos = (const int*)k_pos;
  a.q_pos = (const int*)q_pos;
  a.sm = (const float*)sm;
  a.smo = (const float*)smo;
  a.out = (float*)out;
  a.kv = kv;
  a.g = g;
  a.hd = hd;
  a.n_cells = s_len;
  a.window = window;
  a.softcap = softcap;
  a.sm_qmin = (float)sm_qmin;
  a.sm_qmax = (float)sm_qmax;
  a.smo_qmin = (float)smo_qmin;
  a.smo_qmax = (float)smo_qmax;
  if (kv_bits == 4)
    return attend::launch<true, false, int8_t, true>(a, batch, stream);
  return attend::launch<true, false, int8_t>(a, batch, stream);
}
