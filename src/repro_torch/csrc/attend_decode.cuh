// One decode step of attention against a block-paged f32 or bf16 KV cache,
// for Hopper (sm_90a): the one-block-per-(kv head, lane) template behind
// the K7 kernel of paged_attend_decode.cu, and the helpers (warp sums,
// fake-quant, int8 and nibble unpacking) that the split-KV body of K5 and
// K6 (split_attend.cuh) shares.
//
// Replaces the TPU kernel src/repro/kernels/paged_attend_decode.py
// (_paged_kernel, float). For lane b, kv head h and the G query heads of
// that head:
//
//   s[g,c] = q[g] . k[c]                      (scale folded into q)
//   s = softcap(s); s = fake_quant_{softmax_in}(s); s = mask(s)
//   online softmax over the cells, acc += p @ v
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
// kUnroll cells at once, reduces q.k across the warp with shuffles and
// needs no barrier. The warps' states are combined once at the end (and
// once between the two passes). The online-softmax recurrences follow the
// reference's order, including the max(m_new, -1e30) guard, so an idle
// lane (all cells masked) gives the same output as the plain version.
// Built with -fmad=false and rintf (round half to even). K5 ran the int8
// form of this template until it moved onto the split-KV body; K7 moves
// there next.
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
  const float* q;         // (B,KV,G,hd) f32, attention scale folded in
  const void* k;          // (N,bs,KV,hd) f32 or bf16
  const void* v;
  const int* table;       // (B,nb)
  const int* q_pos;       // (B,)
  const float* sm;        // softmax_in [scale, zp] or null
  const float* smo;       // softmax_out [scale, zp] or null
  float* out;             // (B,KV,G,hd) f32
  int kv, g, hd;
  int n_cells;            // nb * bs
  int nb, bs, s_cap;
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

// The 4 values of word j (columns 4j..4j+3) of one row.
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

// Arena row of cell L of lane b, viewed as (rows, KV, hd), and whether the
// cell is valid for a query at position qp.
__device__ __forceinline__ long cell(const Args& a, int b, int L, int qp,
                                     bool* valid) {
  const int t = a.table[(long)b * a.nb + L / a.bs];
  int m = (qp - L) % a.s_cap;
  if (m < 0) m += a.s_cap;                     // floor modulo
  const int p = qp - m;
  bool ok = L < a.s_cap && p >= 0 && t >= 0;
  if (a.window > 0) ok = ok && p > qp - a.window;
  *valid = ok;
  return (long)(t > 0 ? t : 0) * a.bs + L % a.bs;
}

// KT: f32 or bf16 payloads. MG bounds the query heads per kv head (G <=
// MG) and NW is the number of 4-column words per lane (1 for hd <= 128, 2
// up to 256); both only size the registers.
template <typename KT, int MG, int NW>
__global__ void __launch_bounds__(kThreads) attend_decode_kernel(const Args a) {
  constexpr int kCols = 4 * NW;
  const int h = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int G = a.g, hd = a.hd, KV = a.kv;
  const long qrow0 = ((long)b * KV + h) * G;     // row of query head g = 0
  const int qp = a.q_pos[b];
  const bool two_pass = a.smo != nullptr;

  __shared__ float m_s[kWarps][kMaxG], l_s[kWarps][kMaxG];
  __shared__ float acc_s[kMaxG][kMaxHd];

  // this lane's query words (4 values per float4)
  float qf[MG][kCols];
#pragma unroll
  for (int g = 0; g < MG; ++g) {
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      const int j = lane + 32 * i;
      for (int e = 0; e < 4; ++e) qf[g][4 * i + e] = 0.f;
      if (g < G && j < hd / 4) load4(a.q + (qrow0 + g) * hd, j, &qf[g][4 * i]);
    }
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
      float kx[kUnroll][kCols], vx[kUnroll][kCols];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int L = base + u;
        in[u] = L < n;
        const long row = in[u] ? cell(a, b, L, qp, &ok[u]) : 0;
        if (!in[u]) ok[u] = false;
        const long off = (row * KV + h) * hd;
#pragma unroll
        for (int i = 0; i < NW; ++i) {
          for (int e = 0; e < 4; ++e)
            kx[u][4 * i + e] = vx[u][4 * i + e] = 0.f;
          const int j = lane + 32 * i;
          if (in[u] && j < hd / 4) {
            load4((const KT*)a.k + off, j, &kx[u][4 * i]);
            if (emit) load4((const KT*)a.v + off, j, &vx[u][4 * i]);
          }
        }
      }
      // logits of the kUnroll cells (every lane ends with every value)
      float s[kUnroll][MG];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int g = 0; g < MG; ++g) {
          if (g >= G) {
            s[u][g] = -INFINITY;
            continue;
          }
          float d = 0.f;
#pragma unroll
          for (int c = 0; c < kCols; ++c) d += qf[g][c] * kx[u][c];
          float x = warp_sum(d);
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
        float pv[kUnroll], corr = 1.f;
        if (pass == 0) {
          float mx = s[0][g];
#pragma unroll
          for (int u = 1; u < kUnroll; ++u) mx = fmaxf(mx, s[u][g]);
          const float m_new = fmaxf(fmaxf(m[g], mx), kNegInf);
          float ps = 0.f;
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            pv[u] = in[u] ? expf(s[u][g] - m_new) : 0.f;
            ps += pv[u];
          }
          corr = expf(m[g] - m_new);
          l[g] = l[g] * corr + ps;
          m[g] = m_new;
        } else {
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            float p = expf(s[u][g] - mg[g]) / lg[g];
            p = fake_quant(p, a.smo[0], a.smo[1], a.smo_qmin, a.smo_qmax);
            pv[u] = in[u] ? p : 0.f;
          }
        }
        if (emit) {
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            float d = 0.f;
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) d += pv[u] * vx[u][c];
            acc[g][c] = acc[g][c] * corr + d;   // the reference's order
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
        for (int i = 0; i < NW; ++i) {
          const int j = lane + 32 * i;
          if (j < hd / 4) {
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

template <typename KT, int MG>
inline void launch_g(const Args& a, dim3 grid, cudaStream_t stream) {
  if (a.hd > 128)
    attend_decode_kernel<KT, MG, 2><<<grid, kThreads, 0, stream>>>(a);
  else
    attend_decode_kernel<KT, MG, 1><<<grid, kThreads, 0, stream>>>(a);
}

template <typename KT>
inline int launch(const Args& a, int batch, void* stream) {
  if (batch > 0 && a.kv > 0) {
    const dim3 grid(a.kv, batch);
    if (a.g <= 2)
      launch_g<KT, 2>(a, grid, (cudaStream_t)stream);
    else
      launch_g<KT, kMaxG>(a, grid, (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}

}  // namespace attend
