// One decode step of attention against a KV cache, for Hopper (sm_90a): the
// template behind int8_attend_decode.cu (K5) and the K7 kernel of
// paged_attend_decode.cu, and the helpers K6's split-KV kernel there
// shares.
//
// Replaces the TPU kernels src/repro/kernels/int8_attend_decode.py
// (_attend_decode_kernel) and src/repro/kernels/paged_attend_decode.py
// (_paged_kernel, float). For lane b, kv head h and the G query heads of
// that head:
//
//   s[g,c] = ((dot32 - zq*kcol - zk*qrow) + hd*zq*zk) * q_s * k_s   (int8)
//   s[g,c] = q[g] . k[c]                      (float; scale folded into q)
//   s = softcap(s); s = fake_quant_{softmax_in}(s); s = mask(s)
//   online softmax over the cells, acc += (p*v_s) @ v - z_v * sum(p*v_s)
//
// With a calibrated softmax_out site the cells are walked twice: pass 1
// keeps only (m, l), pass 2 recomputes the logits, quantizes
// exp(s - m) / l on the site grid and accumulates without renormalising.
//
// Bound on the H100: bytes. A decode step reads the whole cache once (K
// twice in two-pass mode) and does a few operations per byte, and at the
// serving shapes there are few (lane, head) pairs, so the design is about
// keeping many loads in flight per block. One block of 8 warps per (kv
// head, lane): the G query rows of the head are read once. Each warp is an
// independent worker with its own online softmax (m, l, acc) over every
// 8th group of kUnroll consecutive cells; a lane owns 4 (hd 16..128) or 8
// (hd 256) head_dim columns, so one step issues the K and V words of
// kUnroll cells at once, takes the exact int32 q.k by __dp4a over 4-byte
// words, reduces across the warp with shuffles and needs no barrier. The
// warps' states are combined once at the end (and once between the two
// passes). The float corrections and the online-softmax recurrences follow
// the reference's order, including the max(m_new, -1e30) guard, so an idle
// lane (all cells masked) gives the same output as the plain version.
// Built with -fmad=false and rintf (round half to even). Split-KV over
// more blocks (as K6 does), TMA and wgmma are later work.
//
// 4-bit caches (KV4, the TPU kernels' kv_bits=4 mode): each K/V row is hd/2
// bytes of split-half nibbles, column j in the low nibble of byte j and
// column hd/2 + j in its high nibble, so packed 32-bit word i carries the
// column quads i and hd/8 + i. The lane that loads packed word i owns both
// quads (q words, the two __dp4a's of q.k and the acc columns), which at
// hd = 256 are the same 8 columns a lane owns at 8 bits; at hd = 16 two
// lanes per cell are active. The nibbles are sign-extended per byte
// (__vsub4) into two int8 words, so q.k stays an exact int32 __dp4a and
// kcol comes from the unpacked values; scales, positions, masks and both
// softmax schedules are the 8-bit ones. Half the payload bytes per cell.
//
// Paged caches: cell L of lane b lives in physical block table[b, L / bs]
// (clamped at 0; unmapped blocks are masked). Its position is derived, not
// read: p = q_pos - ((q_pos - L) mod s_cap) with a floor modulo, valid iff
// L < s_cap, p >= 0, table[b, L / bs] >= 0 (and p > q_pos - window).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace attend {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;         // cells per warp per step
constexpr int kMaxG = 8;           // query heads per kv head
constexpr int kMaxHd = 256;        // head_dim
constexpr float kNegInf = -1e30f;

struct Args {
  const void* q;          // int8 (B,KV,G,hd) or f32 (B,KV,G,hd)
  const float* q_scale;   // (B,KV,G)   int8 only
  const float* q_zp;      // (B,KV,G)   int8 only
  const float* k_zp;      // (B,KV)     int8 only
  const float* v_zp;      // (B,KV)     int8 only
  const void* k;          // dense (B,S,KV,hd) / paged (N,bs,KV,hd)
  const void* v;
  const float* k_scale;   // dense (B,S,KV) / paged (N,bs,KV), int8 only
  const float* v_scale;
  const int* k_pos;       // dense (B,S)
  const int* table;       // paged (B,nb)
  const int* q_pos;       // (B,)
  const float* sm;        // softmax_in [scale, zp] or null
  const float* smo;       // softmax_out [scale, zp] or null
  float* out;             // (B,KV,G,hd) f32
  int kv, g, hd;
  int n_cells;            // dense: S; paged: nb * bs
  int nb, bs, s_cap;      // paged only
  int window;             // 0: no sliding window
  float softcap;          // 0: no soft-capping
  float sm_qmin, sm_qmax, smo_qmin, smo_qmax;
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

// The 4 values of word j (columns 4j..4j+3) of one K or V row.
__device__ __forceinline__ void load4(const int8_t* row, int j, float* x) {
  unpack4(reinterpret_cast<const int*>(row)[j], x);
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

// The column quad of this lane's word slot i, and whether the lane owns
// one there: at 8 bits word lane + 32 i of hd / 4; at 4 bits quad lane
// (i = 0) and hd / 8 + lane (i = 1) of the packed word lane < hd / 8.
template <bool KV4>
__device__ __forceinline__ int quad_of(int lane, int i, int hd) {
  return KV4 ? lane + i * (hd / 8) : lane + 32 * i;
}
template <bool KV4>
__device__ __forceinline__ bool owns(int lane, int i, int hd) {
  return KV4 ? lane < hd / 8 : lane + 32 * i < hd / 4;
}
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

// Payload row of cell L of lane b, viewed as (rows, KV, hd), and whether
// the cell is valid for a query at position qp.
template <bool PAGED>
__device__ __forceinline__ long cell(const Args& a, int b, int L, int qp,
                                     bool* valid) {
  if (PAGED) {
    const int t = a.table[(long)b * a.nb + L / a.bs];
    int m = (qp - L) % a.s_cap;
    if (m < 0) m += a.s_cap;                     // floor modulo
    const int p = qp - m;
    bool ok = L < a.s_cap && p >= 0 && t >= 0;
    if (a.window > 0) ok = ok && p > qp - a.window;
    *valid = ok;
    return (long)(t > 0 ? t : 0) * a.bs + L % a.bs;
  }
  const int kp = a.k_pos[(long)b * a.n_cells + L];
  bool ok = kp >= 0 && kp <= qp;
  if (a.window > 0) ok = ok && kp > qp - a.window;
  *valid = ok;
  return (long)b * a.n_cells + L;
}

// QUANT: int8 payloads with per-cell scales (KT = int8_t); otherwise f32 or
// bf16 payloads (KT) and f32 queries with the attention scale folded in.
// KV4 (with QUANT): split-half nibble payloads, rows of hd / 2 bytes.
// MG bounds the query heads per kv head (G <= MG) and NW is the number of
// 4-column words per lane (1 for hd <= 128, 2 up to 256; 2 with KV4); both
// only size the registers.
template <bool QUANT, bool PAGED, typename KT, int MG, int NW,
          bool KV4 = false>
__global__ void __launch_bounds__(kThreads) attend_decode_kernel(const Args a) {
  constexpr int kWords = NW;
  constexpr int kCols = 4 * NW;
  static_assert(!KV4 || (QUANT && NW == 2), "KV4: int8 queries, 2 quads");
  const int h = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int G = a.g, hd = a.hd, KV = a.kv;
  const int row_bytes = KV4 ? hd / 2 : hd;      // payload bytes per row
  const long qrow0 = ((long)b * KV + h) * G;     // row of query head g = 0
  const int qp = a.q_pos[b];
  const bool two_pass = a.smo != nullptr;

  __shared__ float m_s[kWarps][kMaxG], l_s[kWarps][kMaxG];
  __shared__ float acc_s[kMaxG][kMaxHd];

  // this lane's query words (int8: 4 values per int; float: 4 per float4)
  int qw[MG][kWords];
  float qf[MG][kCols];
  float qrow[MG], qs[MG], zq[MG];
  float zk = 0.f, zv = 0.f;
#pragma unroll
  for (int g = 0; g < MG; ++g) {
    int r = 0;
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      const int j = quad_of<KV4>(lane, i, hd);
      qw[g][i] = 0;
      for (int e = 0; e < 4; ++e) qf[g][4 * i + e] = 0.f;
      if (g < G && owns<KV4>(lane, i, hd)) {
        if (QUANT) {
          qw[g][i] = reinterpret_cast<const int*>(
              (const int8_t*)a.q + (qrow0 + g) * hd)[j];
          r = __dp4a(qw[g][i], 0x01010101, r);
        } else {
          load4((const float*)a.q + (qrow0 + g) * hd, j, &qf[g][4 * i]);
        }
      }
    }
    qrow[g] = QUANT ? (float)warp_sum(r) : 0.f;
    qs[g] = (QUANT && g < G) ? a.q_scale[qrow0 + g] : 0.f;
    zq[g] = (QUANT && g < G) ? a.q_zp[qrow0 + g] : 0.f;
  }
  if (QUANT) {
    zk = a.k_zp[(long)b * KV + h];
    zv = a.v_zp[(long)b * KV + h];
  }

  float m[MG], l[MG], acc[MG][kCols];
#pragma unroll
  for (int g = 0; g < MG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[g][c] = 0.f;
  }
  // (m, l) of all warps: between the passes, and for the final combine
  float mg[MG], lg[MG];

  const int n = a.n_cells;
  for (int pass = 0; pass < (two_pass ? 2 : 1); ++pass) {
    const bool emit = !two_pass || pass == 1;
    for (int base = warp * kUnroll; base < n; base += kWarps * kUnroll) {
      // issue the loads of kUnroll cells
      bool in[kUnroll], ok[kUnroll];
      float ks[kUnroll], vs[kUnroll];
      float kx[kUnroll][kCols], vx[kUnroll][kCols];
      int kwd[kUnroll][kWords];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int L = base + u;
        in[u] = L < n;
        const long row = in[u] ? cell<PAGED>(a, b, L, qp, &ok[u]) : 0;
        if (!in[u]) ok[u] = false;
        const long off = (row * KV + h) * row_bytes;
        ks[u] = vs[u] = 1.f;
        if (QUANT && in[u]) {
          ks[u] = a.k_scale[row * KV + h];
          vs[u] = a.v_scale[row * KV + h];
        }
#pragma unroll
        for (int i = 0; i < kWords; ++i) {
          kwd[u][i] = 0;
          for (int e = 0; e < 4; ++e)
            kx[u][4 * i + e] = vx[u][4 * i + e] = 0.f;
        }
        if constexpr (KV4) {   // one packed word: both of the lane's quads
          if (in[u] && lane < hd / 8) {
            const int kp = reinterpret_cast<const int*>(
                (const int8_t*)a.k + off)[lane];
            kwd[u][0] = nibbles_lo(kp);
            kwd[u][1] = nibbles_hi(kp);
            if (emit) {
              const int vp = reinterpret_cast<const int*>(
                  (const int8_t*)a.v + off)[lane];
              unpack4(nibbles_lo(vp), &vx[u][0]);
              unpack4(nibbles_hi(vp), &vx[u][4]);
            }
          }
        } else {
#pragma unroll
          for (int i = 0; i < kWords; ++i) {
            const int j = lane + 32 * i;
            if (in[u] && j < hd / 4) {
              if (QUANT)
                kwd[u][i] = reinterpret_cast<const int*>(
                    (const int8_t*)a.k + off)[j];
              else
                load4((const KT*)a.k + off, j, &kx[u][4 * i]);
              if (emit) load4((const KT*)a.v + off, j, &vx[u][4 * i]);
            }
          }
        }
      }
      // logits of the kUnroll cells (every lane ends with every value)
      float s[kUnroll][MG];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        int kc = 0;
        if (QUANT) {
#pragma unroll
          for (int i = 0; i < kWords; ++i)
            kc = __dp4a(kwd[u][i], 0x01010101, kc);
          kc = warp_sum(kc);
        }
#pragma unroll
        for (int g = 0; g < MG; ++g) {
          if (g >= G) {
            s[u][g] = -INFINITY;
            continue;
          }
          float x;
          if (QUANT) {
            int d = 0;
#pragma unroll
            for (int i = 0; i < kWords; ++i)
              d = __dp4a(qw[g][i], kwd[u][i], d);
            const float acc32 = (((float)warp_sum(d) - zq[g] * (float)kc)
                                 - zk * qrow[g]) +
                                ((float)hd * zq[g]) * zk;
            x = acc32 * qs[g] * ks[u];
          } else {
            float d = 0.f;
#pragma unroll
            for (int c = 0; c < kCols; ++c) d += qf[g][c] * kx[u][c];
            x = warp_sum(d);
          }
          if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
          if (a.sm != nullptr)
            x = fake_quant(x, a.sm[0], a.sm[1], a.sm_qmin, a.sm_qmax);
          // cells past the end do not exist; masked cells weigh exp(-1e30)
          s[u][g] = !in[u] ? -INFINITY : ok[u] ? x : kNegInf;
        }
      }
      // online softmax (pass 1 or one-pass) / quantized probabilities
#pragma unroll
      for (int g = 0; g < MG; ++g) {
        if (g >= G) continue;
        float pv[kUnroll], pvsum = 0.f, corr = 1.f;
        if (pass == 0) {
          float mx = s[0][g];
#pragma unroll
          for (int u = 1; u < kUnroll; ++u) mx = fmaxf(mx, s[u][g]);
          const float m_new = fmaxf(fmaxf(m[g], mx), kNegInf);
          float ps = 0.f;
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const float p = in[u] ? expf(s[u][g] - m_new) : 0.f;
            ps += p;
            pv[u] = p * vs[u];
            pvsum += pv[u];
          }
          corr = expf(m[g] - m_new);
          l[g] = l[g] * corr + ps;
          m[g] = m_new;
        } else {
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            float p = expf(s[u][g] - mg[g]) / lg[g];
            p = fake_quant(p, a.smo[0], a.smo[1], a.smo_qmin, a.smo_qmax);
            pv[u] = in[u] ? p * vs[u] : 0.f;
            pvsum += pv[u];
          }
        }
        if (emit) {
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            float d = 0.f;
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) d += pv[u] * vx[u][c];
            // the reference's order: acc * corr + (p @ V - z_v * sum)
            acc[g][c] = acc[g][c] * corr + (d - zv * pvsum);
          }
        }
      }
    }
    // combine the warps' (m, l): the softmax statistics of all cells
    if (pass == 0) {
      if (lane == 0) {
#pragma unroll
        for (int g = 0; g < MG; ++g) {
          if (g < G) {
            m_s[warp][g] = m[g];
            l_s[warp][g] = l[g];
          }
        }
      }
      __syncthreads();
#pragma unroll
      for (int g = 0; g < MG; ++g) {
        if (g >= G) continue;
        float mm = kNegInf;
        for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, m_s[w][g]);
        float ll = 0.f;
        for (int w = 0; w < kWarps; ++w)
          ll += l_s[w][g] * expf(m_s[w][g] - mm);
        mg[g] = mm;
        lg[g] = fmaxf(ll, 1e-30f);
      }
    }
  }

  // sum the warps' accumulators (rescaled to the common max in one-pass
  // mode) in warp order
  for (int w = 0; w < kWarps; ++w) {
    __syncthreads();
    if (warp == w) {
#pragma unroll
      for (int g = 0; g < MG; ++g) {
        if (g >= G) continue;
        const float scale = two_pass ? 1.f : expf(m[g] - mg[g]);
#pragma unroll
        for (int i = 0; i < kWords; ++i) {
          const int j = quad_of<KV4>(lane, i, hd);
          if (owns<KV4>(lane, i, hd)) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float x = acc[g][4 * i + e] * scale;
              float* dst = &acc_s[g][4 * j + e];
              *dst = w == 0 ? x : *dst + x;
            }
          }
        }
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * hd; i += kThreads) {
    const int g = i / hd;
    const float x = acc_s[g][i % hd];
    a.out[qrow0 * hd + i] = two_pass ? x : x / lg[g];
  }
}

template <bool QUANT, bool PAGED, typename KT, int MG, bool KV4>
inline void launch_g(const Args& a, dim3 grid, cudaStream_t stream) {
  if constexpr (KV4)
    attend_decode_kernel<QUANT, PAGED, KT, MG, 2, true>
        <<<grid, kThreads, 0, stream>>>(a);
  else if (a.hd > 128)
    attend_decode_kernel<QUANT, PAGED, KT, MG, 2>
        <<<grid, kThreads, 0, stream>>>(a);
  else
    attend_decode_kernel<QUANT, PAGED, KT, MG, 1>
        <<<grid, kThreads, 0, stream>>>(a);
}

template <bool QUANT, bool PAGED, typename KT, bool KV4 = false>
inline int launch(const Args& a, int batch, void* stream) {
  if (batch > 0 && a.kv > 0) {
    const dim3 grid(a.kv, batch);
    if (a.g <= 2)
      launch_g<QUANT, PAGED, KT, 2, KV4>(a, grid, (cudaStream_t)stream);
    else
      launch_g<QUANT, PAGED, KT, kMaxG, KV4>(a, grid, (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}

}  // namespace attend
