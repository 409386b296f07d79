// One decode step of attention, split-KV (flash-decoding), for Hopper
// (sm_90a): the body that K5, K6 and K7 share. K5
// (int8_attend_decode.cu) reads a dense (B, S, KV, row_bytes) int8 or int4
// cache; K6 (paged_attend_decode.cu, paged_int8_attend_decode) block-paged
// int8 or int4 arenas; K7 (paged_attend_decode.cu, paged_attend_decode)
// block-paged f32 or bf16 arenas. The template parameter KT is the payload
// element: int8_t for the quantized kernels (KV4: split-half nibbles), float
// or __nv_bfloat16 for K7. The flag PAGED chooses how a split finds its
// cells and their validity:
//
//   PAGED: cell L of lane b lives in physical block table[b, L / bs]
//          (clamped at 0) and its position is derived, not read:
//          p = q_pos - ((q_pos - L) mod s_cap) with a floor modulo, valid
//          iff L < s_cap, p >= 0, the block is mapped (and p > q_pos -
//          window), so stale cells of a reused block are never valid.
//   dense: cell c of lane b is row b * S + c of the cache, and its stored
//          position k_pos[b, c] says whether it is valid: k_pos >= 0 and
//          k_pos <= q_pos (and k_pos > q_pos - window). The cache of a
//          sliding-window layer is a ring that wraps, so validity is read
//          from k_pos, never from c. (K5 only: K7 has no dense twin.)
//
// Replaces the bodies of the TPU kernels
// src/repro/kernels/int8_attend_decode.py (_attend_decode_kernel) and
// src/repro/kernels/paged_attend_decode.py (_paged_kernel, quantized and
// float). For lane b, kv head h and the G query heads of that head:
//
//   int8:  s[g,c] = ((dot32 - zq*kcol - zk*qrow) + hd*zq*zk) * q_s * k_s
//   float: s[g,c] = q[g] . k[c]              (attention scale folded in q)
//   s = softcap(s); s = fake_quant_{softmax_in}(s); s = mask(s)
//   online softmax over the cells,
//   int8:  acc += (p*v_s) @ v - z_v * sum(p*v_s);  float: acc += p @ v
//
// Bound by bytes (the cache read), but at the serving shapes there are few
// (lane, kv head) pairs, so one block per pair left most of the card idle
// behind chains of dependent loads. The grid is (splits, KV, B): split j
// of a lane owns a contiguous run of its cells (paged: the blocks [j * span,
// (j + 1) * span); dense: the cells [j * span, (j + 1) * span); the host
// planners plan_kv_splits and plan_dense_kv_splits pick span so the grid
// reaches a wave and a split holds at most 128 cells). A 128-thread block
// (paged: loads its split's block-table entries once and derives one
// floor-modulo position base per block, then) streams its cells through
// two shared-memory stages with cp.async (16 bytes a copy where rows and
// arenas are 16-byte aligned, else 4), so a stage's K and V rows (and,
// int8, scales; dense, positions) are all in flight before any reduction.
// The stages hold 32 cells of 288 bytes (int8, int4; static shared
// memory) or, in dynamic shared memory sized by the row, 32 padded bf16
// rows or 16 padded f32 rows (32 f32 rows of hd 256 would take 130 KB and
// leave one block an SM). int8: q.k is an exact int32 __dp4a over 8
// threads per cell (three shuffles per value), with the reference's float
// corrections; kv_bits = 4 reads split-half nibbles: packed word i holds
// the column quads i and hd/8 + i, sign-extended per byte (__vsub4) before
// the __dp4a.
// float: q (f32, staged once) . k in f32 over the same 8 threads per cell
// and three shuffles, on the bf16 or f32 values as stored. A warp per query
// head then runs the online softmax over a stage's cells (a lane per cell),
// and the threads accumulate p * v (int8: p * v_s * v - z_v * sum) per
// (head, column quad) in the reference's order.
//
// One pass (no softmax_out site): each split writes (m_j, l_j, acc_j) to a
// workspace; the last block of the (lane, head) to arrive (an arrival
// counter behind __threadfence) merges them in split order j = 0..S-1:
// m = max m_j, l = sum l_j e^(m_j - m), out = sum acc_j e^(m_j - m) / l,
// with the max(m, -1e30) guard of the reference. Two passes (softmax_out
// calibrated), two launches from one C call: launch 1 writes each split's
// (m_j, l_j); launch 2 (a programmatic dependent launch, so its loads of
// the payload overlap launch 1) waits for it, then every block merges all
// (m_j, l_j) in split order into the same global (m, l) -- the same
// arithmetic in every block, so every split quantizes p = fq(e^(s - m) / l)
// on one grid, without renormalising -- and the last block sums the
// splits' accumulators in split order. The merge order is fixed and there
// are no float atomics, so repeated calls agree bit for bit. With out_q the
// last block writes each merged value v not as f32 but as the int8
// clip(rint(v / s_o) + z_o, qmin, qmax) on one per-tensor grid, into the
// (B, KV*G*hd) row-major input of the output projection: the quantize of
// peg_quant.cu (K4, the wo_in site) folded into the merge, with the same
// true division and half-to-even rint on the same f32 v, so the bytes are
// K4's on this kernel's f32 output and the f32 output never reaches DRAM.
// Masked cells weigh e^(-1e30 - m): 0 on a live lane, e^0 on an idle one
// (q_pos = -1), where every cell is masked, as in the plain version. The
// workspace (B x KV x S x G x (hd + 2) f32) and the B x KV counters are
// allocated once per device by the wrappers (shared by K5, K6 and K7); the
// kernel leaves the counters at zero. Built with -fmad=false and rintf
// (round half to even).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace splitkv {

constexpr int kThreads = 128;
constexpr int kMaxChunk = 32;        // cells per shared-memory stage
constexpr int kRow = 288;            // bytes per staged int8 row (256 + pad)
constexpr int kMaxSplits = 32;
constexpr int kMaxBlocks = 256;      // paged blocks per split
constexpr int kMaxG = 8;             // query heads per kv head
constexpr int kMaxHd = 256;          // head_dim
constexpr float kNegInf = -1e30f;

enum Pass { ONE_PASS = 0, STATS = 1, EMIT = 2 };

// Cells per stage: 16 for 4-byte (f32) rows, 32 for the rest.
template <typename KT>
constexpr int kChunk = sizeof(KT) == 4 ? 16 : kMaxChunk;

struct SplitArgs {
  const int8_t* q;          // int8 (B,KV,G,hd)
  const float* qf;          // float (B,KV,G,hd) f32, scale folded in
  const float* q_scale;     // int8 (B,KV,G)
  const float* q_zp;        // int8 (B,KV,G)
  const float* k_zp;        // int8 (B,KV)
  const float* v_zp;        // int8 (B,KV)
  const int8_t* k;          // paged (N,bs,KV,row_bytes) / dense (B,S,KV,..)
  const int8_t* v;
  const float* k_scale;     // int8: paged (N,bs,KV) / dense (B,S,KV)
  const float* v_scale;
  const int* table;         // paged (B,nb)
  const int* k_pos;         // dense (B,S)
  const int* q_pos;         // (B,)
  const float* sm;          // softmax_in [scale, zp] or null
  const float* smo;         // softmax_out [scale, zp] or null
  float* out;               // (B,KV,G,hd), or null with out_q
  int8_t* out_q;            // (B,KV*G*hd) int8 emit, or null
  const float* out_scale;   // (1,) the emit's grid (with out_q)
  const float* out_zp;      // (1,)
  float* ws;                // acc (B,KV,S,G,hd) then (m, l) (B,KV,S,G,2)
  int* counters;            // (B,KV)
  int batch, kv, g, hd;
  int nb, bs, s_cap;        // paged
  int s_len;                // dense
  int window, splits;
  int span;                 // per split: paged blocks / dense cells
  int row_bytes;            // bytes of one (cell, head) payload row
  int stride;               // bytes of one staged row (float payloads)
  int vec16;
  float softcap, sm_qmin, sm_qmax, smo_qmin, smo_qmax, out_qmin, out_qmax;
};

__device__ __forceinline__ int warp_sum(int v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float fake_quant(float x, float s, float z,
                                            float qmin, float qmax) {
  const float q = fminf(fmaxf(rintf(x / s) + z, qmin), qmax);
  return (q - z) * s;
}

// The 4 int8 values of one 32-bit word as floats.
__device__ __forceinline__ void unpack4(int w, float* x) {
#pragma unroll
  for (int e = 0; e < 4; ++e) x[e] = (float)(int8_t)(w >> (8 * e));
}

// Split-half nibbles of one packed word -> the int8 words of its low
// (columns 4i..4i+3) and high (hd/2 + 4i..) quads: (v ^ 8) - 8 per byte.
__device__ __forceinline__ int nibbles_lo(int w) {
  return (int)__vsub4(((unsigned)w & 0x0f0f0f0fu) ^ 0x08080808u,
                      0x08080808u);
}
__device__ __forceinline__ int nibbles_hi(int w) {
  return (int)__vsub4((((unsigned)w >> 4) & 0x0f0f0f0fu) ^ 0x08080808u,
                      0x08080808u);
}

// The 4 values of column quad j (columns 4j..4j+3) of a staged float row.
__device__ __forceinline__ void load4(const float* row, int j, float* x) {
  const float4 w = reinterpret_cast<const float4*>(row)[j];
  x[0] = w.x;
  x[1] = w.y;
  x[2] = w.z;
  x[3] = w.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* row, int j,
                                      float* x) {
  const uint2 w = reinterpret_cast<const uint2*>(row)[j];
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&w.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&w.y);
  x[0] = __low2float(lo);
  x[1] = __high2float(lo);
  x[2] = __low2float(hi);
  x[3] = __high2float(hi);
}

// Asynchronous copy of 16 (vec) or 4 bytes.
__device__ __forceinline__ void cp_async(void* smem, const void* gmem,
                                         bool vec) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  if (vec)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(gmem));
}

// The global (m, l) of head g from the splits' (m_j, l_j), in split order.
__device__ __forceinline__ void merge_stats(float (*ml)[kMaxG][2],
                                            int S, int g, float* m,
                                            float* l) {
  float mm = kNegInf;
  for (int j = 0; j < S; ++j) mm = fmaxf(mm, ml[j][g][0]);
  float ll = 0.f;
  for (int j = 0; j < S; ++j) ll += ml[j][g][1] * expf(ml[j][g][0] - mm);
  *m = mm;
  *l = fmaxf(ll, 1e-30f);
}

template <typename KT, bool PAGED, bool KV4, int MG, int PASS>
__global__ void __launch_bounds__(kThreads)
split_attend_kernel(const SplitArgs a) {
  constexpr bool QUANT = std::is_same<KT, int8_t>::value;
  constexpr int CHUNK = kChunk<KT>;
  using Acc = typename std::conditional<QUANT, int, float>::type;
  // K stages [0, 2 * CHUNK) then V stages, one staged row each: static
  // for int8 rows, dynamic (sized by the row) for float ones
  __shared__ __align__(16) int8_t qstage_s[QUANT ? 4 * kMaxChunk * kRow : 16];
  extern __shared__ __align__(16) int8_t fstage_s[];
  int8_t* const stage_s = QUANT ? qstage_s : fstage_s;
  __shared__ float ks_s[2][QUANT ? kMaxChunk : 1];
  __shared__ float vs_s[2][QUANT ? kMaxChunk : 1];
  __shared__ int kpos_s[2][QUANT && !PAGED ? kMaxChunk : 1];
  __shared__ int q_s[QUANT ? kMaxG : 1][QUANT ? kMaxHd / 4 : 1];
  __shared__ __align__(16) float qf_s[QUANT ? 1 : kMaxG][QUANT ? 1 : kMaxHd];
  __shared__ float qs_s[kMaxG], zq_s[kMaxG], qrow_s[kMaxG];
  __shared__ int tbl_s[PAGED ? kMaxBlocks : 1], r0_s[PAGED ? kMaxBlocks : 1];
  __shared__ float s_s[kMaxG][kMaxChunk], pvs_s[kMaxG][kMaxChunk];
  __shared__ float corr_s[kMaxG], pvsum_s[kMaxG], M_s[kMaxG], L_s[kMaxG];
  __shared__ float ml_s[kMaxSplits][kMaxG][2];
  __shared__ int is_last;
  constexpr int kPairs = (MG * kMaxHd / 4 + kThreads - 1) / kThreads;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int G = a.g, hd = a.hd, KV = a.kv, S = a.splits, bs = a.bs;
  const int bh = b * KV + h;
  const int row_bytes = a.row_bytes;
  const int stride = QUANT ? kRow : a.stride;
  const int qp = a.q_pos[b];
  // the split's cells: paged blocks [blk0, blk0 + nblk), dense cells
  // [cell0, cell0 + ncell) of the lane
  const int blk0 = PAGED ? j * a.span : 0;
  const int nblk = PAGED ? min(a.span, a.nb - blk0) : 0;
  const int cell0 = PAGED ? blk0 * bs : j * a.span;
  const int ncell = PAGED ? nblk * bs : min(a.span, a.s_len - cell0);
  const long lane_row0 = (long)b * a.s_len + cell0;   // dense
  const long qrow0 = (long)bh * G;
  const float zk = QUANT ? a.k_zp[bh] : 0.f;
  const float zv = QUANT ? a.v_zp[bh] : 0.f;
  float* ws_ml = a.ws + (size_t)a.batch * KV * S * G * hd;
  auto k_stage = [&](int buf, int c) {
    return stage_s + (buf * CHUNK + c) * stride;
  };
  auto v_stage = [&](int buf, int c) {
    return stage_s + ((2 + buf) * CHUNK + c) * stride;
  };

  if (PASS == STATS)       // launch 2 may start: all of launch 1 is running
    asm volatile("griddepcontrol.launch_dependents;\n" ::);
  // the split's block-table entries and position bases and the queries
  if constexpr (PAGED) {
    for (int i = tid; i < nblk; i += kThreads) {
      tbl_s[i] = a.table[(long)b * a.nb + blk0 + i];
      const int r = (qp - (blk0 + i) * bs) % a.s_cap;   // floor modulo
      r0_s[i] = r < 0 ? r + a.s_cap : r;
    }
  }
  if constexpr (QUANT) {
    for (int i = tid; i < G * hd / 4; i += kThreads)
      q_s[i / (hd / 4)][i % (hd / 4)] =
          reinterpret_cast<const int*>(a.q + qrow0 * hd)[i];
    if (tid < G) {
      qs_s[tid] = a.q_scale[qrow0 + tid];
      zq_s[tid] = a.q_zp[qrow0 + tid];
    }
  } else {
    for (int i = tid; i < G * hd; i += kThreads)
      qf_s[i / hd][i % hd] = a.qf[qrow0 * hd + i];
  }
  __syncthreads();

  // start the loads of stage ch: K (and V) rows (and, int8, scales; dense,
  // positions) of CHUNK cells
  const bool vec = a.vec16;
  const int step = vec ? 16 : 4, ppr = row_bytes / step;
  const int pieces = ppr + (QUANT ? 1 : 0);
  auto fetch = [&](int ch) {
    const int buf = ch & 1, c_first = ch * CHUNK;
    const int n = min(CHUNK, ncell - c_first);
    for (int i = tid; i < n * pieces; i += kThreads) {
      const int c = i / pieces, piece = i - c * pieces;
      const int cl = c_first + c;
      long row;
      if constexpr (PAGED) {
        const int blk = cl / bs;
        const int t = tbl_s[blk];
        row = (long)(t > 0 ? t : 0) * bs + (cl - blk * bs);
      } else {
        row = lane_row0 + cl;
      }
      if constexpr (QUANT) {
        if (piece == ppr) {      // the scales (and positions)
          cp_async(&ks_s[buf][c], a.k_scale + row * KV + h, false);
          if (PASS != STATS)
            cp_async(&vs_s[buf][c], a.v_scale + row * KV + h, false);
          if (!PAGED) cp_async(&kpos_s[buf][c], a.k_pos + row, false);
          continue;
        }
      }
      const long off = (row * KV + h) * row_bytes + piece * step;
      cp_async(k_stage(buf, c) + piece * step, a.k + off, vec);
      if (PASS != STATS)
        cp_async(v_stage(buf, c) + piece * step, a.v + off, vec);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  fetch(0);

  if constexpr (QUANT) {       // row sums of the queries
    for (int g = warp; g < G; g += kThreads / 32) {
      int r = 0;
      for (int w = lane; w < hd / 4; w += 32)
        r = __dp4a(q_s[g][w], 0x01010101, r);
      r = warp_sum(r);
      if (lane == 0) qrow_s[g] = (float)r;
    }
  }
  if (PASS == EMIT) {
    // launch 1 has finished and its (m_j, l_j) are visible: every split's
    // statistics merge into the global (m, l)
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    for (int i = tid; i < S * G; i += kThreads) {
      const float* src = ws_ml + ((size_t)bh * S * G + i) * 2;
      ml_s[i / G][i % G][0] = __ldcg(src);
      ml_s[i / G][i % G][1] = __ldcg(src + 1);
    }
    __syncthreads();
    if (tid < G) merge_stats(ml_s, S, tid, &M_s[tid], &L_s[tid]);
  }

  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  float acc[kPairs][4];
#pragma unroll
  for (int i = 0; i < kPairs; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  const int n_chunks = (ncell + CHUNK - 1) / CHUNK;
  const int grp = tid >> 3, t8 = tid & 7;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int buf = ch & 1;
    const int n = min(CHUNK, ncell - ch * CHUNK);
    if (ch + 1 < n_chunks)
      fetch(ch + 1);
    else
      asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();

    // logits: 8 threads per cell, cells grp (and grp + 16)
#pragma unroll
    for (int it = 0; it < CHUNK / (kThreads / 8); ++it) {
      const int c = grp + it * (kThreads / 8);
      const bool live = c < n;
      Acc d[MG];
      int kc = 0;
#pragma unroll
      for (int g = 0; g < MG; ++g) d[g] = 0;
      if (live) {
        if constexpr (!QUANT) {
          const KT* krow = reinterpret_cast<const KT*>(k_stage(buf, c));
          for (int w = t8; w < hd / 4; w += 8) {
            float kx[4];
            load4(krow, w, kx);
#pragma unroll
            for (int g = 0; g < MG; ++g)
              if (g < G) {
                const float4 qv = reinterpret_cast<const float4*>(qf_s[g])[w];
                d[g] += ((qv.x * kx[0] + qv.y * kx[1]) + qv.z * kx[2]) +
                        qv.w * kx[3];
              }
          }
        } else if (KV4) {
          const int* krow = reinterpret_cast<const int*>(k_stage(buf, c));
          for (int pw = t8; pw < hd / 8; pw += 8) {
            const int lo = nibbles_lo(krow[pw]);
            const int hi = nibbles_hi(krow[pw]);
            kc = __dp4a(hi, 0x01010101, __dp4a(lo, 0x01010101, kc));
#pragma unroll
            for (int g = 0; g < MG; ++g)
              if (g < G)
                d[g] = __dp4a(q_s[g][hd / 8 + pw], hi,
                              __dp4a(q_s[g][pw], lo, d[g]));
          }
        } else {
          const int* krow = reinterpret_cast<const int*>(k_stage(buf, c));
          for (int w = t8; w < hd / 4; w += 8) {
            const int kw = krow[w];
            kc = __dp4a(kw, 0x01010101, kc);
#pragma unroll
            for (int g = 0; g < MG; ++g)
              if (g < G) d[g] = __dp4a(q_s[g][w], kw, d[g]);
          }
        }
      }
#pragma unroll
      for (int off = 4; off > 0; off >>= 1) {
        if (QUANT) kc += __shfl_xor_sync(0xffffffffu, kc, off);
#pragma unroll
        for (int g = 0; g < MG; ++g)
          d[g] += __shfl_xor_sync(0xffffffffu, d[g], off);
      }
      if (live && t8 < G) {
        const int cl = ch * CHUNK + c;
        bool ok;
        if constexpr (PAGED) {
          const int blk = cl / bs;
          int r = r0_s[blk] - (cl - blk * bs);
          if (r < 0) r += a.s_cap;
          const int p = qp - r;
          ok = cell0 + cl < a.s_cap && p >= 0 && tbl_s[blk] >= 0;
          if (a.window > 0) ok = ok && p > qp - a.window;
        } else {
          const int kp = kpos_s[buf][c];
          ok = kp >= 0 && kp <= qp;
          if (a.window > 0) ok = ok && kp > qp - a.window;
        }
        Acc dg = 0;
#pragma unroll
        for (int g = 0; g < MG; ++g)
          if (g == t8) dg = d[g];
        const int g = t8;
        float x;
        if constexpr (QUANT) {
          const float zq = zq_s[g];
          const float acc32 = (((float)dg - zq * (float)kc) -
                               zk * qrow_s[g]) + ((float)hd * zq) * zk;
          x = acc32 * qs_s[g] * ks_s[buf][c];
        } else {
          x = dg;
        }
        if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
        if (a.sm != nullptr)
          x = fake_quant(x, a.sm[0], a.sm[1], a.sm_qmin, a.sm_qmax);
        s_s[g][c] = ok ? x : kNegInf;
      }
    }
    __syncthreads();

    // softmax over the stage: a warp per query head, a lane per cell
#pragma unroll
    for (int gi = 0; gi < 2; ++gi) {
      const int g = warp + 4 * gi;
      if (g >= G) continue;
      const bool in = lane < n;
      const float sv = in ? s_s[g][lane] : -INFINITY;
      float p, corr = 1.f;
      if (PASS == EMIT) {
        p = in ? fake_quant(expf(sv - M_s[g]) / L_s[g], a.smo[0], a.smo[1],
                            a.smo_qmin, a.smo_qmax)
               : 0.f;
      } else {
        const float m_new = fmaxf(fmaxf(m_run[gi], warp_max(sv)), kNegInf);
        p = in ? expf(sv - m_new) : 0.f;
        const float ps = warp_sum(p);
        corr = expf(m_run[gi] - m_new);
        l_run[gi] = l_run[gi] * corr + ps;
        m_run[gi] = m_new;
      }
      if (PASS != STATS) {
        float pv = in ? p : 0.f, pvsum = 0.f;
        if constexpr (QUANT) {
          pv = in ? p * vs_s[buf][lane] : 0.f;
          pvsum = warp_sum(pv);
        }
        pvs_s[g][lane] = pv;
        if (lane == 0) {
          pvsum_s[g] = pvsum;
          corr_s[g] = corr;
        }
      }
    }
    if (PASS != STATS) {
      __syncthreads();
      // acc[g][4w..4w+3] = acc * corr + sum_c pv[c] v[c]
      //                    (int8: - z_v * sum pv)
      const int nq = hd / 4;
#pragma unroll
      for (int i = 0; i < kPairs; ++i) {
        const int pr = tid + i * kThreads;
        if (pr >= G * nq) continue;
        const int g = pr / nq, w = pr - g * nq;
        float dsum[4] = {0.f, 0.f, 0.f, 0.f};
        for (int c = 0; c < n; ++c) {
          float x[4];
          if constexpr (QUANT) {
            const int* vrow = reinterpret_cast<const int*>(v_stage(buf, c));
            const int vw = !KV4 ? vrow[w]
                           : w < hd / 8 ? nibbles_lo(vrow[w])
                                        : nibbles_hi(vrow[w - hd / 8]);
            unpack4(vw, x);
          } else {
            load4(reinterpret_cast<const KT*>(v_stage(buf, c)), w, x);
          }
          const float pv = pvs_s[g][c];
#pragma unroll
          for (int e = 0; e < 4; ++e) dsum[e] += pv * x[e];
        }
        const float corr = corr_s[g], ps = pvsum_s[g];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[i][e] = QUANT ? acc[i][e] * corr + (dsum[e] - zv * ps)
                            : acc[i][e] * corr + dsum[e];
      }
    }
    __syncthreads();               // the stage is free for chunk ch + 2
  }

  // this split's partial
  const size_t part = (size_t)bh * S + j;
  if (PASS != EMIT && lane == 0) {
#pragma unroll
    for (int gi = 0; gi < 2; ++gi) {
      const int g = warp + 4 * gi;
      if (g < G) {
        ws_ml[(part * G + g) * 2] = m_run[gi];
        ws_ml[(part * G + g) * 2 + 1] = l_run[gi];
      }
    }
  }
  if (PASS == STATS) return;
  {
    const int nq = hd / 4;
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      const int pr = tid + i * kThreads;
      if (pr >= G * nq) continue;
      const int g = pr / nq, w = pr - g * nq;
      *reinterpret_cast<float4*>(a.ws + (part * G + g) * hd + 4 * w) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(&a.counters[bh], 1) == S - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  // the last split of (lane, head) merges every split in split order
  if (PASS == ONE_PASS) {
    for (int i = tid; i < S * G; i += kThreads) {
      const float* src = ws_ml + ((size_t)bh * S * G + i) * 2;
      ml_s[i / G][i % G][0] = __ldcg(src);
      ml_s[i / G][i % G][1] = __ldcg(src + 1);
    }
    __syncthreads();
    if (tid < G) {
      merge_stats(ml_s, S, tid, &M_s[tid], &L_s[tid]);
      for (int jj = 0; jj < S; ++jj)       // now each split's weight
        ml_s[jj][tid][0] = expf(ml_s[jj][tid][0] - M_s[tid]);
    }
    __syncthreads();
  }
  const float* acc0 = a.ws + (size_t)bh * S * G * hd;
  const float s_o = a.out_q ? a.out_scale[0] : 1.f;
  const float z_o = a.out_q ? a.out_zp[0] : 0.f;
  for (int i = tid; i < G * hd; i += kThreads) {
    const int g = i / hd, col = i - g * hd;
    float x = 0.f;
#pragma unroll 8
    for (int jj = 0; jj < S; ++jj) {
      const float y = __ldcg(acc0 + ((size_t)jj * G + g) * hd + col);
      x += PASS == ONE_PASS ? y * ml_s[jj][g][0] : y;
    }
    const float v = PASS == ONE_PASS ? x / L_s[g] : x;
    if (a.out_q)
      a.out_q[qrow0 * hd + i] = (int8_t)fminf(
          fmaxf(rintf(v / s_o) + z_o, a.out_qmin), a.out_qmax);
    else
      a.out[qrow0 * hd + i] = v;
  }
  if (tid == 0) a.counters[bh] = 0;
}

// Dynamic shared memory above the default 48 KB must be allowed per kernel
// (the float stages: 66 KB for 32 bf16 or 16 f32 rows of hd 256).
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= (48 << 10)) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <typename KT, bool PAGED, bool KV4, int MG>
int launch_split(const SplitArgs& a, cudaStream_t stream) {
  constexpr bool QUANT = std::is_same<KT, int8_t>::value;
  const int smem = QUANT ? 0 : 4 * kChunk<KT> * a.stride;
  const dim3 grid(a.splits, a.kv, a.batch);
  if (a.smo == nullptr) {
    const auto kernel = split_attend_kernel<KT, PAGED, KV4, MG, ONE_PASS>;
    const cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<grid, kThreads, smem, stream>>>(a);
    return (int)cudaGetLastError();
  }
  const auto stats = split_attend_kernel<KT, PAGED, KV4, MG, STATS>;
  const auto emit = split_attend_kernel<KT, PAGED, KV4, MG, EMIT>;
  cudaError_t e = allow_smem(stats, smem);
  if (e == cudaSuccess) e = allow_smem(emit, smem);
  if (e != cudaSuccess) return (int)e;
  stats<<<grid, kThreads, smem, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // launch 2 with programmatic dependent launch: its blocks load their
  // table entries, queries and payload while launch 1 still runs, and
  // wait (griddepcontrol.wait) only before reading launch 1's statistics
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, emit, a);
}

// The payloads, sites, output (f32 out, or the int8 emit out_q on
// [out_qmin, out_qmax]) and split plan, common to K5, K6 and K7.
inline SplitArgs base_args(const void* k, const void* v, int row_bytes,
                           const void* q_pos, const void* sm,
                           const void* smo, void* out, void* out_q,
                           const void* out_scale, const void* out_zp,
                           int out_qmin, int out_qmax, int batch, int kv,
                           int g, int hd, int window, float softcap,
                           int sm_qmin, int sm_qmax, int smo_qmin,
                           int smo_qmax, int splits, int span, void* ws,
                           void* counters) {
  SplitArgs a = {};
  a.k = (const int8_t*)k;
  a.v = (const int8_t*)v;
  a.q_pos = (const int*)q_pos;
  a.sm = (const float*)sm;
  a.smo = (const float*)smo;
  a.out = (float*)out;
  a.out_q = (int8_t*)out_q;
  a.out_scale = (const float*)out_scale;
  a.out_zp = (const float*)out_zp;
  a.out_qmin = (float)out_qmin;
  a.out_qmax = (float)out_qmax;
  a.ws = (float*)ws;
  a.counters = (int*)counters;
  a.batch = batch;
  a.kv = kv;
  a.g = g;
  a.hd = hd;
  a.window = window;
  a.splits = splits;
  a.span = span;
  a.softcap = softcap;
  a.sm_qmin = (float)sm_qmin;
  a.sm_qmax = (float)sm_qmax;
  a.smo_qmin = (float)smo_qmin;
  a.smo_qmax = (float)smo_qmax;
  a.row_bytes = row_bytes;
  a.stride = ((row_bytes + 15) / 16) * 16 + 16;
  a.vec16 = row_bytes % 16 == 0 && (uintptr_t)k % 16 == 0 &&
            (uintptr_t)v % 16 == 0;
  return a;
}

// The int8 query side of K5 and K6 on top of base_args.
inline SplitArgs quant_args(const void* q_q, const void* q_scale,
                            const void* q_zp, const void* k_zp,
                            const void* v_zp, const void* k, const void* k_scale,
                            const void* v, const void* v_scale,
                            const void* q_pos, const void* sm,
                            const void* smo, void* out, void* out_q,
                            const void* out_scale, const void* out_zp,
                            int out_qmin, int out_qmax, int batch, int kv,
                            int g, int hd, int window, float softcap,
                            int sm_qmin, int sm_qmax, int smo_qmin,
                            int smo_qmax, int kv_bits, int splits, int span,
                            void* ws, void* counters) {
  SplitArgs a = base_args(
      k, v, kv_bits == 4 ? hd / 2 : hd, q_pos, sm, smo, out, out_q,
      out_scale, out_zp, out_qmin, out_qmax, batch, kv, g, hd, window,
      softcap, sm_qmin, sm_qmax, smo_qmin, smo_qmax, splits, span, ws,
      counters);
  a.q = (const int8_t*)q_q;
  a.q_scale = (const float*)q_scale;
  a.q_zp = (const float*)q_zp;
  a.k_zp = (const float*)k_zp;
  a.v_zp = (const float*)v_zp;
  a.k_scale = (const float*)k_scale;
  a.v_scale = (const float*)v_scale;
  return a;
}

// K5 (dense) and K6 (paged): int8 or int4 payloads.
template <bool PAGED>
int launch(const SplitArgs& a, int kv_bits, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (kv_bits == 4)
    return a.g <= 2 ? launch_split<int8_t, PAGED, true, 2>(a, s)
                    : launch_split<int8_t, PAGED, true, kMaxG>(a, s);
  return a.g <= 2 ? launch_split<int8_t, PAGED, false, 2>(a, s)
                  : launch_split<int8_t, PAGED, false, kMaxG>(a, s);
}

// K7: paged f32 or bf16 payloads.
template <typename KT>
int launch_float(const SplitArgs& a, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  return a.g <= 2 ? launch_split<KT, true, false, 2>(a, s)
                  : launch_split<KT, true, false, kMaxG>(a, s);
}

}  // namespace splitkv
