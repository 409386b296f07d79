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
// The stages, in dynamic shared memory, hold 32 cells of 288 bytes (int8,
// int4) or, sized by the row, 32 padded bf16 rows or 16 padded f32 rows
// (32 f32 rows of hd 256 would take 130 KB and leave one block an SM).
// int8: q.k is an exact int32 __dp4a over 8 threads per cell (three
// shuffles per value), with the reference's float corrections; kv_bits = 4
// reads split-half nibbles: packed word i holds the column quads i and
// hd/8 + i, sign-extended per byte (__vsub4) before the __dp4a.
// float: q (f32, staged once) . k in f32 over the same 8 threads per cell
// and three shuffles, on the bf16 or f32 values as stored. A warp per query
// head then runs the online softmax over a stage's cells (a lane per cell),
// and the threads accumulate p * v (int8: p * v_s * v - z_v * sum) per
// (head, column quad) in the reference's order.
//
// G query heads per kv head: up to 16 at hd <= 256, up to 48 at hd <= 128
// (granite's MQA: 48 heads on one kv head; qwen3: 16; recurrentgemma's
// local attention: 10 of hd 256). The block stages
// each chunk of cells once and walks the G heads in tiles of 8 (the 8
// threads of a cell give one head each), so the cache is read once
// whatever G is; warp w runs the online softmax of heads w + 4 i, their
// running (m, l) in its registers. The per-head arithmetic does not
// depend on the tile,
// the warp or the thread that runs it, so a result at G <= 8 is the same
// bits as before the tiles.
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
//
// Partial mode (tensor-parallel serving with the cache's sequence dim cut
// over the ranks): a launch over a rank's cells writes each split's partial
// to the caller's rows part (B, KV, S, G, prow) and merges nothing; the
// ranks gather the rows along the split dim and merge_partials.cu merges
// them in (rank, split) order with the arithmetic above. PART_ONE writes
// (acc_j, m_j, l_j) (prow = hd + 2); PART_STATS launch 1's (m_j, l_j)
// (prow = 2); PART_EMIT launch 2's acc_j (prow = hd) on the global (m, l)
// it is given (ml_in (B, KV, G, 2), merged over every rank's splits). A
// paged rank holds the in-block cells [cell_lo, cell_lo + bs) of blocks of
// bs_full logical cells: its cell c of table column t is the lane's cell
// L = t * bs_full + cell_lo + c, and the position is derived from L as
// above. A dense rank's cells carry their stored positions.
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
constexpr int kMaxG = 48;            // query heads per kv head
constexpr int kTile = 8;             // query heads a cell's 8 threads hold
constexpr int kMidG = 16;            // the widest G at kMaxHd
constexpr int kMaxHd = 256;          // head_dim (G <= kMidG)
constexpr float kNegInf = -1e30f;

enum Pass { ONE_PASS = 0, STATS = 1, EMIT = 2 };
// WHOLE merges in the kernel; the others write partial rows (see above)
enum Mode { WHOLE = 0, PART_ONE = 1, PART_STATS = 2, PART_EMIT = 3 };

// Cells per stage: 16 for 4-byte (f32) rows, 32 for the rest.
template <typename KT>
constexpr int kChunk = sizeof(KT) == 4 ? 16 : kMaxChunk;

// The largest head_dim of an instantiation for MG query heads a kv head:
// the queries (MG x hd) sit in static shared memory (16 x 256 f32: 16 KB;
// 48 x 128: 24 KB).
template <int MG>
constexpr int kHdCap = MG > kMidG ? 128 : kMaxHd;

// The split statistics m_j and l_j of every (split, head) reuse the logit
// and probability rows' shared memory (free before and after the stages).
static_assert(kMaxSplits <= kMaxChunk, "split statistics must fit");

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
  float* part;              // partial mode: (B,KV,S,G,prow) rows, else null
  const float* ml_in;       // PART_EMIT: the global (m, l) (B,KV,G,2)
  int mode, prow;           // Mode; floats a partial row
  int batch, kv, g, hd;
  int nb, bs, s_cap;        // paged (bs: the arena's cells a block)
  int bs_full, cell_lo;     // paged: logical cells a block, first held
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

// The global (m, l) of head g from the splits' (m_j, l_j), in split order
// (split j, head g: m_j at ml_m[j * MG + g], l_j at ml_l[j * MG + g]).
template <int MG>
__device__ __forceinline__ void merge_stats(const float* ml_m,
                                            const float* ml_l, int S, int g,
                                            float* m, float* l) {
  float mm = kNegInf;
  for (int j = 0; j < S; ++j) mm = fmaxf(mm, ml_m[j * MG + g]);
  float ll = 0.f;
  for (int j = 0; j < S; ++j)
    ll += ml_l[j * MG + g] * expf(ml_m[j * MG + g] - mm);
  *m = mm;
  *l = fmaxf(ll, 1e-30f);
}

// The splits' (m_j, l_j) of (lane, kv head) bh from the workspace into
// ml_m / ml_l (see merge_stats).
template <int MG>
__device__ __forceinline__ void load_stats(const float* ws_ml, int bh, int S,
                                           int G, float* ml_m, float* ml_l) {
  for (int i = threadIdx.x; i < S * G; i += blockDim.x) {
    const float* src = ws_ml + ((size_t)bh * S * G + i) * 2;
    ml_m[(i / G) * MG + i % G] = __ldcg(src);
    ml_l[(i / G) * MG + i % G] = __ldcg(src + 1);
  }
}

template <typename KT, bool PAGED, bool KV4, int MG, int PASS>
__global__ void __launch_bounds__(kThreads)
split_attend_kernel(const SplitArgs a) {
  constexpr bool QUANT = std::is_same<KT, int8_t>::value;
  constexpr int CHUNK = kChunk<KT>;
  constexpr int MT = MG < kTile ? MG : kTile;     // heads per logit tile
  // logit tiles: one, known at compile time, up to 8 heads
  constexpr bool ONE_TILE = MG <= kTile;
  constexpr int QROW = kHdCap<MG>;                // queries: a head's row
  constexpr int QW = MG * QROW;                   // query values held
  constexpr int GI = (MG + 3) / 4;                // heads a warp runs
  using Acc = typename std::conditional<QUANT, int, float>::type;
  // K stages [0, 2 * CHUNK) then V stages, one staged row each, in
  // dynamic shared memory (int8: kRow bytes a row; float: sized by it)
  extern __shared__ __align__(16) int8_t stage_s[];
  __shared__ float ks_s[2][QUANT ? kMaxChunk : 1];
  __shared__ float vs_s[2][QUANT ? kMaxChunk : 1];
  __shared__ int kpos_s[2][QUANT && !PAGED ? kMaxChunk : 1];
  // queries, head g's row at g * QROW (int8: hd / 4 words; float: hd f32)
  __shared__ int q_s[QUANT ? QW / 4 : 1];
  __shared__ __align__(16) float qf_s[QUANT ? 1 : QW];
  __shared__ float qs_s[MG], zq_s[MG], qrow_s[MG];
  __shared__ int tbl_s[PAGED ? kMaxBlocks : 1], r0_s[PAGED ? kMaxBlocks : 1];
  // logits s[g][c] and probabilities pv[g][c] of a stage; before and
  // after the stages, the splits' m_j and l_j (see merge_stats)
  __shared__ float s_s[MG * kMaxChunk], pvs_s[MG * kMaxChunk];
  __shared__ float corr_s[MG], pvsum_s[MG], M_s[MG], L_s[MG];
  __shared__ int is_last;
  constexpr int kPairs = (QW / 4 + kThreads - 1) / kThreads;

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
      // floor modulo, from the logical index of the block's first cell
      const int r = (qp - ((blk0 + i) * a.bs_full + a.cell_lo)) % a.s_cap;
      r0_s[i] = r < 0 ? r + a.s_cap : r;
    }
  }
  if constexpr (QUANT) {
    for (int i = tid; i < G * hd / 4; i += kThreads)
      q_s[i / (hd / 4) * (QROW / 4) + i % (hd / 4)] =
          reinterpret_cast<const int*>(a.q + qrow0 * hd)[i];
    if (tid < G) {
      qs_s[tid] = a.q_scale[qrow0 + tid];
      zq_s[tid] = a.q_zp[qrow0 + tid];
    }
  } else {
    for (int i = tid; i < G * hd; i += kThreads)
      qf_s[i / hd * QROW + i % hd] = a.qf[qrow0 * hd + i];
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
        r = __dp4a(q_s[g * (QROW / 4) + w], 0x01010101, r);
      r = warp_sum(r);
      if (lane == 0) qrow_s[g] = (float)r;
    }
  }
  if (PASS == EMIT) {
    // launch 1 has finished and its (m_j, l_j) are visible: every split's
    // statistics merge into the global (m, l)
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    if (a.ml_in != nullptr) {      // partial mode: merged over every rank
      if (tid < G) {
        M_s[tid] = a.ml_in[(qrow0 + tid) * 2];
        L_s[tid] = a.ml_in[(qrow0 + tid) * 2 + 1];
      }
    } else {
      load_stats<MG>(ws_ml, bh, S, G, s_s, pvs_s);
      __syncthreads();
      if (tid < G)
        merge_stats<MG>(s_s, pvs_s, S, tid, &M_s[tid], &L_s[tid]);
    }
  }

  // the running (m, l) of heads warp + 4 gi
  float m_run[GI], l_run[GI];
#pragma unroll
  for (int gi = 0; gi < GI; ++gi) {
    m_run[gi] = kNegInf;
    l_run[gi] = 0.f;
  }
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

    // logits: 8 threads per cell, cells grp (and grp + 16), the G heads
    // in tiles of MT (thread t8 of a cell finishes head g0 + t8)
#pragma unroll
    for (int it = 0; it < CHUNK / (kThreads / 8); ++it) {
      const int c = grp + it * (kThreads / 8);
      const bool live = c < n;
      for (int g0 = 0; g0 < (ONE_TILE ? 1 : G); g0 += MT) {
        Acc d[MT];
        int kc = 0;
#pragma unroll
        for (int g = 0; g < MT; ++g) d[g] = 0;
        if (live) {
          if constexpr (!QUANT) {
            const KT* krow = reinterpret_cast<const KT*>(k_stage(buf, c));
            for (int w = t8; w < hd / 4; w += 8) {
              float kx[4];
              load4(krow, w, kx);
#pragma unroll
              for (int g = 0; g < MT; ++g)
                if (g0 + g < G) {
                  const float4 qv = reinterpret_cast<const float4*>(
                      qf_s + (g0 + g) * QROW)[w];
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
              for (int g = 0; g < MT; ++g)
                if (g0 + g < G) {
                  const int* qrow = q_s + (g0 + g) * (QROW / 4);
                  d[g] = __dp4a(qrow[hd / 8 + pw], hi,
                                __dp4a(qrow[pw], lo, d[g]));
                }
            }
          } else {
            const int* krow = reinterpret_cast<const int*>(k_stage(buf, c));
            for (int w = t8; w < hd / 4; w += 8) {
              const int kw = krow[w];
              kc = __dp4a(kw, 0x01010101, kc);
#pragma unroll
              for (int g = 0; g < MT; ++g)
                if (g0 + g < G)
                  d[g] = __dp4a(q_s[(g0 + g) * (QROW / 4) + w], kw, d[g]);
            }
          }
        }
#pragma unroll
        for (int off = 4; off > 0; off >>= 1) {
          if (QUANT) kc += __shfl_xor_sync(0xffffffffu, kc, off);
#pragma unroll
          for (int g = 0; g < MT; ++g)
            d[g] += __shfl_xor_sync(0xffffffffu, d[g], off);
        }
        if (live && t8 < MT && g0 + t8 < G) {
          const int cl = ch * CHUNK + c;
          bool ok;
          if constexpr (PAGED) {
            const int blk = cl / bs;
            int r = r0_s[blk] - (cl - blk * bs);
            if (r < 0) r += a.s_cap;
            const int p = qp - r;
            const int L = (blk0 + blk) * a.bs_full + a.cell_lo +
                          (cl - blk * bs);
            ok = L < a.s_cap && p >= 0 && tbl_s[blk] >= 0;
            if (a.window > 0) ok = ok && p > qp - a.window;
          } else {
            const int kp = kpos_s[buf][c];
            ok = kp >= 0 && kp <= qp;
            if (a.window > 0) ok = ok && kp > qp - a.window;
          }
          Acc dg = 0;
#pragma unroll
          for (int g = 0; g < MT; ++g)
            if (g == t8) dg = d[g];
          const int g = g0 + t8;
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
          s_s[g * kMaxChunk + c] = ok ? x : kNegInf;
        }
      }
    }
    __syncthreads();

    // softmax over the stage: a warp per query head, a lane per cell
#pragma unroll
    for (int gi = 0; gi < GI; ++gi) {
      const int g = warp + 4 * gi;
      if (g >= G) continue;
      const bool in = lane < n;
      const float sv = in ? s_s[g * kMaxChunk + lane] : -INFINITY;
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
        pvs_s[g * kMaxChunk + lane] = pv;
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
          const float pv = pvs_s[g * kMaxChunk + c];
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
  if (a.part != nullptr) {         // partial mode: the caller's row, no merge
    float* const row0 = a.part + part * G * a.prow;
    if (PASS != EMIT && lane == 0) {
#pragma unroll
      for (int gi = 0; gi < GI; ++gi) {
        const int g = warp + 4 * gi;
        if (g < G) {
          row0[g * a.prow + a.prow - 2] = m_run[gi];
          row0[g * a.prow + a.prow - 1] = l_run[gi];
        }
      }
    }
    if (PASS != STATS) {
      const int nq = hd / 4;
#pragma unroll
      for (int i = 0; i < kPairs; ++i) {
        const int pr = tid + i * kThreads;
        if (pr >= G * nq) continue;
        const int g = pr / nq, w = pr - g * nq;
#pragma unroll
        for (int e = 0; e < 4; ++e) row0[g * a.prow + 4 * w + e] = acc[i][e];
      }
    }
    return;
  }
  if (PASS != EMIT && lane == 0) {
#pragma unroll
    for (int gi = 0; gi < GI; ++gi) {
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
    load_stats<MG>(ws_ml, bh, S, G, s_s, pvs_s);
    __syncthreads();
    if (tid < G) {
      merge_stats<MG>(s_s, pvs_s, S, tid, &M_s[tid], &L_s[tid]);
      for (int jj = 0; jj < S; ++jj)       // now each split's weight
        s_s[jj * MG + tid] = expf(s_s[jj * MG + tid] - M_s[tid]);
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
      x += PASS == ONE_PASS ? y * s_s[jj * MG + g] : y;
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

// Resident blocks an SM at G <= 8 (0: as many as fit). The paged int8
// probability passes and the float kernels run faster at long caches with
// fewer blocks an SM than their shared memory allows: at the 4096-cell
// window (B 4, 4 kv heads, 32 splits: 512 blocks) the emitting K6 takes
// 62.8 us at 5 blocks an SM and 59.5 at 4, K7 on f32 arenas 130.2 at 3
// and 120.2 at 2 (scripts/kernel_ab.py on an H100). These are the counts
// of the layout sized for 8 heads of hd 256 that G <= 8 had before the
// wide-G tiles. The statistics pass and the dense kernels keep theirs.
template <typename KT, bool PAGED, int MG, int PASS>
constexpr int kMaxResident =
    MG > kTile ? 0
    : !std::is_same<KT, int8_t>::value ? 2
    : PAGED && PASS != STATS ? 4 : 0;

// Static and dynamic shared memory above 48 KB in all must be allowed per
// kernel (the float stages alone: 66 KB for 32 bf16 or 16 f32 rows of hd
// 256; the int8 stages, 36 KB, beside the queries and logits of 48 heads).
// Returns the dynamic shared memory to launch ``kernel`` with: ``bytes``,
// or more, so that at most ``blocks`` blocks fit an SM (blocks > 0).
// ``memo`` (per instantiation and pass: {the floor ``blocks`` asks for, or
// -1 before the first launch; the largest size allowed so far}) leaves a
// launch no driver call after the first of its size.
template <typename Kernel>
inline int launch_smem(Kernel kernel, int bytes, int blocks, int* memo) {
  if (memo[0] < 0) {
    int least = 0;
    if (blocks > 0) {
      int dev = 0, per_sm = 0, reserved = 0;
      cudaFuncAttributes fa;
      cudaError_t e = cudaGetDevice(&dev);
      if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(
            &per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
      if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(
            &reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
      if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kernel);
      if (e != cudaSuccess) return -(int)e;
      // (blocks + 1) blocks of this size overflow the SM
      least = per_sm / (blocks + 1) + 1 - reserved - (int)fa.sharedSizeBytes;
    }
    memo[0] = least;
  }
  if (memo[0] > bytes) bytes = memo[0];
  if (bytes > memo[1]) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return -(int)e;
    memo[1] = bytes;
  }
  return bytes;
}

// One launch of pass PASS (a plain launch: a partial EMIT reads its (m, l)
// from ml_in, so griddepcontrol.wait has nothing to wait for).
template <typename KT, bool PAGED, bool KV4, int MG, int PASS>
int launch_pass(const SplitArgs& a, int smem, int* memo,
                cudaStream_t stream) {
  const auto kernel = split_attend_kernel<KT, PAGED, KV4, MG, PASS>;
  const int bytes =
      launch_smem(kernel, smem, kMaxResident<KT, PAGED, MG, PASS>, memo);
  if (bytes < 0) return -bytes;
  kernel<<<dim3(a.splits, a.kv, a.batch), kThreads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename KT, bool PAGED, bool KV4, int MG>
int launch_split(const SplitArgs& a, cudaStream_t stream) {
  constexpr bool QUANT = std::is_same<KT, int8_t>::value;
  if (a.g > MG || a.hd > kHdCap<MG>) return (int)cudaErrorInvalidValue;
  const int smem = 4 * kChunk<KT> * (QUANT ? kRow : a.stride);
  const dim3 grid(a.splits, a.kv, a.batch);
  static int memo[3][2] = {{-1, 0}, {-1, 0}, {-1, 0}};  // per pass (one device)
  if (a.mode == PART_STATS)
    return launch_pass<KT, PAGED, KV4, MG, STATS>(a, smem, memo[STATS],
                                                  stream);
  if (a.mode == PART_EMIT)
    return launch_pass<KT, PAGED, KV4, MG, EMIT>(a, smem, memo[EMIT], stream);
  if (a.smo == nullptr)
    return launch_pass<KT, PAGED, KV4, MG, ONE_PASS>(a, smem, memo[ONE_PASS],
                                                     stream);
  const auto stats = split_attend_kernel<KT, PAGED, KV4, MG, STATS>;
  const auto emit = split_attend_kernel<KT, PAGED, KV4, MG, EMIT>;
  const int s_bytes = launch_smem(
      stats, smem, kMaxResident<KT, PAGED, MG, STATS>, memo[STATS]);
  if (s_bytes < 0) return -s_bytes;
  const int e_bytes = launch_smem(
      emit, smem, kMaxResident<KT, PAGED, MG, EMIT>, memo[EMIT]);
  if (e_bytes < 0) return -e_bytes;
  stats<<<grid, kThreads, s_bytes, stream>>>(a);
  cudaError_t e = cudaGetLastError();
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
  cfg.dynamicSmemBytes = e_bytes;
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

// The instantiation for a.g query heads a kv head: 2, 8, 16 (hd <= 256)
// or 48 (hd <= 128); launch_split refuses a shape past its limits.
template <typename KT, bool PAGED, bool KV4>
int launch_g(const SplitArgs& a, cudaStream_t s) {
  if (a.g <= 2) return launch_split<KT, PAGED, KV4, 2>(a, s);
  if (a.g <= kTile) return launch_split<KT, PAGED, KV4, kTile>(a, s);
  if (a.g <= kMidG) return launch_split<KT, PAGED, KV4, kMidG>(a, s);
  return launch_split<KT, PAGED, KV4, kMaxG>(a, s);
}

// The partial-mode fields of a (mode, part, ml_in) call, checked: mode is
// a Mode; a partial mode takes part (and PART_EMIT ml_in), writes no out
// and uses no workspace; PART_ONE takes no softmax_out site. Returns
// false on a bad combination.
inline bool set_mode(SplitArgs* a, int mode, void* part, const void* ml_in) {
  a->mode = mode;
  a->part = (float*)part;
  a->ml_in = (const float*)ml_in;
  a->prow = mode == PART_ONE ? a->hd + 2 : mode == PART_STATS ? 2 : a->hd;
  if (mode == WHOLE) return part == nullptr && ml_in == nullptr;
  if (mode < WHOLE || mode > PART_EMIT || part == nullptr ||
      a->out != nullptr || a->out_q != nullptr)
    return false;
  if (mode == PART_ONE && a->smo != nullptr) return false;
  if (mode != PART_ONE && a->smo == nullptr) return false;
  return (mode == PART_EMIT) == (ml_in != nullptr);
}

// K5 (dense) and K6 (paged): int8 or int4 payloads.
template <bool PAGED>
int launch(const SplitArgs& a, int kv_bits, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (kv_bits == 4) return launch_g<int8_t, PAGED, true>(a, s);
  return launch_g<int8_t, PAGED, false>(a, s);
}

// K7: paged f32 or bf16 payloads.
template <typename KT>
int launch_float(const SplitArgs& a, void* stream) {
  return launch_g<KT, true, false>(a, (cudaStream_t)stream);
}

}  // namespace splitkv
