// One decode step of attention over an int8 or int4 KV cache, split-KV
// (flash-decoding), for Hopper (sm_90a): the body that K5
// (int8_attend_decode.cu, a dense (B, S, KV, row_bytes) cache) and K6
// (paged_attend_decode.cu, block-paged arenas) share. The template flag
// PAGED chooses how a split finds its cells and their validity:
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
//          from k_pos, never from c.
//
// Replaces the bodies of the TPU kernels
// src/repro/kernels/int8_attend_decode.py (_attend_decode_kernel) and
// src/repro/kernels/paged_attend_decode.py (_paged_kernel, quantized).
// For lane b, kv head h and the G query heads of that head:
//
//   s[g,c] = ((dot32 - zq*kcol - zk*qrow) + hd*zq*zk) * q_s * k_s
//   s = softcap(s); s = fake_quant_{softmax_in}(s); s = mask(s)
//   online softmax over the cells, acc += (p*v_s) @ v - z_v * sum(p*v_s)
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
// two shared-memory stages of 32 cells with cp.async, so a stage's K and V
// rows and scales (and, dense, positions) are all in flight before any
// reduction. q.k is an exact int32 __dp4a over 8 threads per cell (three
// shuffles per value), with the reference's float corrections; a warp per
// query head runs the online softmax over a stage's 32 cells (a lane per
// cell), and the threads then accumulate p * v_s * v - z_v * sum per
// (head, column quad) in the reference's order. kv_bits = 4 reads
// split-half nibbles: packed word i holds the column quads i and hd/8 + i,
// sign-extended per byte (__vsub4) before the __dp4a.
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
// Masked cells
// weigh e^(-1e30 - m): 0 on a live lane, e^0 on an idle one (q_pos = -1),
// where every cell is masked, as in the plain version. The workspace
// (B x KV x S x G x (hd + 2) f32) and the B x KV counters are allocated
// once per device by the wrappers (shared by K5 and K6); the kernel leaves
// the counters at zero.
#pragma once

#include "attend_decode.cuh"

namespace split_attend {

constexpr int kThreads = 128;
constexpr int kChunk = 32;           // cells per shared-memory stage
constexpr int kRow = 288;            // bytes per staged row (256 + pad)
constexpr int kMaxSplits = 32;
constexpr int kMaxBlocks = 256;      // paged blocks per split
using attend::kMaxG;
using attend::kMaxHd;
using attend::kNegInf;

enum Pass { ONE_PASS = 0, STATS = 1, EMIT = 2 };

struct SplitArgs {
  const int8_t* q;          // (B,KV,G,hd)
  const float* q_scale;     // (B,KV,G)
  const float* q_zp;        // (B,KV,G)
  const float* k_zp;        // (B,KV)
  const float* v_zp;        // (B,KV)
  const int8_t* k;          // paged (N,bs,KV,row_bytes) / dense (B,S,KV,..)
  const int8_t* v;
  const float* k_scale;     // paged (N,bs,KV) / dense (B,S,KV)
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
  int vec16;
  float softcap, sm_qmin, sm_qmax, smo_qmin, smo_qmax, out_qmin, out_qmax;
};

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
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

template <bool PAGED, bool KV4, int MG, int PASS>
__global__ void __launch_bounds__(kThreads)
split_attend_kernel(const SplitArgs a) {
  __shared__ __align__(16) int8_t kbuf[2][kChunk][kRow];
  __shared__ __align__(16) int8_t vbuf[2][kChunk][kRow];
  __shared__ float ks_s[2][kChunk], vs_s[2][kChunk];
  __shared__ int kpos_s[2][kChunk];                         // dense
  __shared__ int q_s[kMaxG][kMaxHd / 4];
  __shared__ float qs_s[kMaxG], zq_s[kMaxG], qrow_s[kMaxG];
  __shared__ int tbl_s[PAGED ? kMaxBlocks : 1], r0_s[PAGED ? kMaxBlocks : 1];
  __shared__ float s_s[kMaxG][kChunk], pvs_s[kMaxG][kChunk];
  __shared__ float corr_s[kMaxG], pvsum_s[kMaxG], M_s[kMaxG], L_s[kMaxG];
  __shared__ float ml_s[kMaxSplits][kMaxG][2];
  __shared__ int is_last;
  constexpr int kPairs = (MG * kMaxHd / 4 + kThreads - 1) / kThreads;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int G = a.g, hd = a.hd, KV = a.kv, S = a.splits, bs = a.bs;
  const int bh = b * KV + h;
  const int row_bytes = KV4 ? hd / 2 : hd;
  const int qp = a.q_pos[b];
  // the split's cells: paged blocks [blk0, blk0 + nblk), dense cells
  // [cell0, cell0 + ncell) of the lane
  const int blk0 = PAGED ? j * a.span : 0;
  const int nblk = PAGED ? min(a.span, a.nb - blk0) : 0;
  const int cell0 = PAGED ? blk0 * bs : j * a.span;
  const int ncell = PAGED ? nblk * bs : min(a.span, a.s_len - cell0);
  const long lane_row0 = (long)b * a.s_len + cell0;   // dense
  const long qrow0 = (long)bh * G;
  const float zk = a.k_zp[bh], zv = a.v_zp[bh];
  float* ws_ml = a.ws + (size_t)a.batch * KV * S * G * hd;

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
  for (int i = tid; i < G * hd / 4; i += kThreads)
    q_s[i / (hd / 4)][i % (hd / 4)] =
        reinterpret_cast<const int*>(a.q + qrow0 * hd)[i];
  if (tid < G) {
    qs_s[tid] = a.q_scale[qrow0 + tid];
    zq_s[tid] = a.q_zp[qrow0 + tid];
  }
  __syncthreads();

  // start the loads of stage ch: K (and V) rows and scales (and, dense,
  // positions) of 32 cells
  const bool vec = a.vec16;
  const int step = vec ? 16 : 4, ppr = row_bytes / step;
  auto fetch = [&](int ch) {
    const int buf = ch & 1, c_first = ch * kChunk;
    const int n = min(kChunk, ncell - c_first);
    for (int i = tid; i < n * (ppr + 1); i += kThreads) {
      const int c = i / (ppr + 1), piece = i - c * (ppr + 1);
      const int cl = c_first + c;
      long row;
      if constexpr (PAGED) {
        const int blk = cl / bs;
        const int t = tbl_s[blk];
        row = (long)(t > 0 ? t : 0) * bs + (cl - blk * bs);
      } else {
        row = lane_row0 + cl;
      }
      if (piece == ppr) {        // the scales (and positions)
        cp_async(&ks_s[buf][c], a.k_scale + row * KV + h, false);
        if (PASS != STATS)
          cp_async(&vs_s[buf][c], a.v_scale + row * KV + h, false);
        if (!PAGED) cp_async(&kpos_s[buf][c], a.k_pos + row, false);
      } else {
        const long off = (row * KV + h) * row_bytes + piece * step;
        cp_async(&kbuf[buf][c][piece * step], a.k + off, vec);
        if (PASS != STATS)
          cp_async(&vbuf[buf][c][piece * step], a.v + off, vec);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  fetch(0);

  // row sums of the queries
  for (int g = warp; g < G; g += kThreads / 32) {
    int r = 0;
    for (int w = lane; w < hd / 4; w += 32)
      r = __dp4a(q_s[g][w], 0x01010101, r);
    r = attend::warp_sum(r);
    if (lane == 0) qrow_s[g] = (float)r;
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

  const int n_chunks = (ncell + kChunk - 1) / kChunk;
  const int grp = tid >> 3, t8 = tid & 7;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int buf = ch & 1;
    const int n = min(kChunk, ncell - ch * kChunk);
    if (ch + 1 < n_chunks)
      fetch(ch + 1);
    else
      asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();

    // logits: 8 threads per cell, cells grp and grp + 16
#pragma unroll
    for (int it = 0; it < kChunk / (kThreads / 8); ++it) {
      const int c = grp + it * (kThreads / 8);
      const bool live = c < n;
      int d[MG], kc = 0;
#pragma unroll
      for (int g = 0; g < MG; ++g) d[g] = 0;
      if (live) {
        const int* krow = reinterpret_cast<const int*>(kbuf[buf][c]);
        if (KV4) {
          for (int pw = t8; pw < hd / 8; pw += 8) {
            const int lo = attend::nibbles_lo(krow[pw]);
            const int hi = attend::nibbles_hi(krow[pw]);
            kc = __dp4a(hi, 0x01010101, __dp4a(lo, 0x01010101, kc));
#pragma unroll
            for (int g = 0; g < MG; ++g)
              if (g < G)
                d[g] = __dp4a(q_s[g][hd / 8 + pw], hi,
                              __dp4a(q_s[g][pw], lo, d[g]));
          }
        } else {
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
        kc += __shfl_xor_sync(0xffffffffu, kc, off);
#pragma unroll
        for (int g = 0; g < MG; ++g)
          d[g] += __shfl_xor_sync(0xffffffffu, d[g], off);
      }
      if (live && t8 < G) {
        const int cl = ch * kChunk + c;
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
        int dg = 0;
#pragma unroll
        for (int g = 0; g < MG; ++g)
          if (g == t8) dg = d[g];
        const int g = t8;
        const float zq = zq_s[g];
        const float acc32 = (((float)dg - zq * (float)kc) - zk * qrow_s[g]) +
                            ((float)hd * zq) * zk;
        float x = acc32 * qs_s[g] * ks_s[buf][c];
        if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
        if (a.sm != nullptr)
          x = attend::fake_quant(x, a.sm[0], a.sm[1], a.sm_qmin, a.sm_qmax);
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
        p = in ? attend::fake_quant(expf(sv - M_s[g]) / L_s[g], a.smo[0],
                                    a.smo[1], a.smo_qmin, a.smo_qmax)
               : 0.f;
      } else {
        const float m_new = fmaxf(fmaxf(m_run[gi], warp_max(sv)), kNegInf);
        p = in ? expf(sv - m_new) : 0.f;
        const float ps = attend::warp_sum(p);
        corr = expf(m_run[gi] - m_new);
        l_run[gi] = l_run[gi] * corr + ps;
        m_run[gi] = m_new;
      }
      if (PASS != STATS) {
        const float pv = in ? p * vs_s[buf][lane] : 0.f;
        pvs_s[g][lane] = pv;
        const float pvsum = attend::warp_sum(pv);
        if (lane == 0) {
          pvsum_s[g] = pvsum;
          corr_s[g] = corr;
        }
      }
    }
    if (PASS != STATS) {
      __syncthreads();
      // acc[g][4w..4w+3] = acc * corr + (sum_c pv[c] v[c] - z_v * sum pv)
      const int nq = hd / 4;
#pragma unroll
      for (int i = 0; i < kPairs; ++i) {
        const int pr = tid + i * kThreads;
        if (pr >= G * nq) continue;
        const int g = pr / nq, w = pr - g * nq;
        float dsum[4] = {0.f, 0.f, 0.f, 0.f};
        for (int c = 0; c < n; ++c) {
          const int* vrow = reinterpret_cast<const int*>(vbuf[buf][c]);
          const int vw = !KV4 ? vrow[w]
                         : w < hd / 8 ? attend::nibbles_lo(vrow[w])
                                      : attend::nibbles_hi(vrow[w - hd / 8]);
          float x[4];
          attend::unpack4(vw, x);
          const float pv = pvs_s[g][c];
#pragma unroll
          for (int e = 0; e < 4; ++e) dsum[e] += pv * x[e];
        }
        const float corr = corr_s[g], ps = pvsum_s[g];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[i][e] = acc[i][e] * corr + (dsum[e] - zv * ps);
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

template <bool PAGED, bool KV4, int MG>
int launch_split(const SplitArgs& a, cudaStream_t stream) {
  const dim3 grid(a.splits, a.kv, a.batch);
  if (a.smo == nullptr) {
    split_attend_kernel<PAGED, KV4, MG, ONE_PASS>
        <<<grid, kThreads, 0, stream>>>(a);
    return (int)cudaGetLastError();
  }
  split_attend_kernel<PAGED, KV4, MG, STATS><<<grid, kThreads, 0, stream>>>(a);
  const cudaError_t e = cudaGetLastError();
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
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg,
                                 split_attend_kernel<PAGED, KV4, MG, EMIT>, a);
}

// The int8 query side, the sites and the output (f32 out, or the int8
// emit out_q on [out_qmin, out_qmax]), common to K5 and K6.
inline SplitArgs split_args(const void* q_q, const void* q_scale,
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
  SplitArgs a = {};
  a.q = (const int8_t*)q_q;
  a.q_scale = (const float*)q_scale;
  a.q_zp = (const float*)q_zp;
  a.k_zp = (const float*)k_zp;
  a.v_zp = (const float*)v_zp;
  a.k = (const int8_t*)k;
  a.v = (const int8_t*)v;
  a.k_scale = (const float*)k_scale;
  a.v_scale = (const float*)v_scale;
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
  const int row_bytes = kv_bits == 4 ? hd / 2 : hd;
  a.vec16 = row_bytes % 16 == 0 && (uintptr_t)k % 16 == 0 &&
            (uintptr_t)v % 16 == 0;
  return a;
}

template <bool PAGED>
int launch(const SplitArgs& a, int kv_bits, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (kv_bits == 4)
    return a.g <= 2 ? launch_split<PAGED, true, 2>(a, s)
                    : launch_split<PAGED, true, kMaxG>(a, s);
  return a.g <= 2 ? launch_split<PAGED, false, 2>(a, s)
                  : launch_split<PAGED, false, kMaxG>(a, s);
}

}  // namespace split_attend
