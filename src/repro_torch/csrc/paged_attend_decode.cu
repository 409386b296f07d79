// K6 and K7: one decode step of attention over a block-paged KV cache, for
// Hopper (sm_90a). Replaces the TPU kernels
// src/repro/kernels/paged_attend_decode.py::paged_int8_attend_decode (K6,
// kv_bits = 8 and 4) and ::paged_attend_decode (K7, f32/bf16 arenas), whose
// shared body is _paged_kernel. Bound by bytes (the arena read); the design is in
// attend_decode.cuh. Each cell finds its physical block through the lane's
// row of the block table and derives its position from (L, q_pos, s_cap),
// so stale cells of a reused block are never read as valid.
#include "attend_decode.cuh"

namespace {

attend::Args paged_args(const void* table, const void* q_pos, const void* sm,
                        const void* smo, void* out, int kv, int g, int hd,
                        int nb, int bs, int s_cap, int window, float softcap,
                        int sm_qmin, int sm_qmax, int smo_qmin,
                        int smo_qmax) {
  attend::Args a = {};
  a.table = (const int*)table;
  a.q_pos = (const int*)q_pos;
  a.sm = (const float*)sm;
  a.smo = (const float*)smo;
  a.out = (float*)out;
  a.kv = kv;
  a.g = g;
  a.hd = hd;
  a.n_cells = nb * bs;
  a.nb = nb;
  a.bs = bs;
  a.s_cap = s_cap;
  a.window = window;
  a.softcap = softcap;
  a.sm_qmin = (float)sm_qmin;
  a.sm_qmax = (float)sm_qmax;
  a.smo_qmin = (float)smo_qmin;
  a.smo_qmax = (float)smo_qmax;
  return a;
}

}  // namespace

// K6. q_q (B,KV,G,hd) int8; q_scale/q_zp (B,KV,G) f32; k_zp/v_zp (B,KV) f32;
// k_arena/v_arena (N,bs,KV,hd) int8; k_scale/v_scale (N,bs,KV) f32; table
// (B,nb) int32 (-1 = unmapped), nb * bs >= s_cap; q_pos (B,) int32 (-1 =
// idle lane); sm/smo (2,) f32 or null; out (B,KV,G,hd) f32. All contiguous.
// kv_bits = 4: arenas are (N,bs,KV,hd/2) split-half nibbles, hd % 8 == 0.
// Returns cudaGetLastError().
extern "C" int paged_int8_attend_decode(
    const void* q_q, const void* q_scale, const void* q_zp, const void* k_zp,
    const void* v_zp, const void* k_arena, const void* k_scale,
    const void* v_arena, const void* v_scale, const void* table,
    const void* q_pos, const void* sm, const void* smo, void* out, int batch,
    int kv, int g, int hd, int nb, int bs, int s_cap, int window,
    float softcap, int sm_qmin, int sm_qmax, int smo_qmin, int smo_qmax,
    int kv_bits, void* stream) {
  attend::Args a = paged_args(table, q_pos, sm, smo, out, kv, g, hd, nb, bs,
                              s_cap, window, softcap, sm_qmin, sm_qmax,
                              smo_qmin, smo_qmax);
  a.q = q_q;
  a.q_scale = (const float*)q_scale;
  a.q_zp = (const float*)q_zp;
  a.k_zp = (const float*)k_zp;
  a.v_zp = (const float*)v_zp;
  a.k = k_arena;
  a.v = v_arena;
  a.k_scale = (const float*)k_scale;
  a.v_scale = (const float*)v_scale;
  if (kv_bits == 4)
    return attend::launch<true, true, int8_t, true>(a, batch, stream);
  return attend::launch<true, true, int8_t>(a, batch, stream);
}

// K7. q (B,KV,G,hd) f32 with the attention scale folded in; k_arena/v_arena
// (N,bs,KV,hd) f32 (kv_is_bf16 = 0) or bf16 (kv_is_bf16 = 1); the rest as
// in paged_int8_attend_decode. Returns cudaGetLastError().
extern "C" int paged_attend_decode(
    const void* q, const void* k_arena, const void* v_arena, int kv_is_bf16,
    const void* table, const void* q_pos, const void* sm, const void* smo,
    void* out, int batch, int kv, int g, int hd, int nb, int bs, int s_cap,
    int window, float softcap, int sm_qmin, int sm_qmax, int smo_qmin,
    int smo_qmax, void* stream) {
  attend::Args a = paged_args(table, q_pos, sm, smo, out, kv, g, hd, nb, bs,
                              s_cap, window, softcap, sm_qmin, sm_qmax,
                              smo_qmin, smo_qmax);
  a.q = q;
  a.k = k_arena;
  a.v = v_arena;
  if (kv_is_bf16)
    return attend::launch<false, true, __nv_bfloat16>(a, batch, stream);
  return attend::launch<false, true, float>(a, batch, stream);
}
