// RMSNorm / LayerNorm fused with quantization, for Hopper (sm_90a).
//
// Replaces the four TPU kernels of src/repro/kernels/fused_ln_quant.py, one
// Pallas body (_norm_quant_kernel) with two switches, kept here as template
// flags:
//   LN = false, RMSNorm:   y = x * rsqrt(mean(x^2) + eps) * (1 + gamma)
//   LN = true,  LayerNorm: y = (x - mu) * rsqrt(mean((x - mu)^2) + eps)
//                              * gamma + beta,  mu = mean(x)
// then q = clip(rint(y / s_g) + z_g, qmin, qmax) with (G,) scales /
// zero-points over contiguous d/G column spans, and
//   EMIT = true:  q as int8            (rms_quantize, ln_quantize)
//   EMIT = false: (q - z_g) * s_g in x's dtype, bf16 rounded to nearest
//                 even at the store    (rms_fake_quant, ln_fake_quant).
//
// Bound on the H100: bytes. A row is read once (f32 or bf16) and written
// once; the arithmetic is a handful of flops per element. At the serving
// shapes there are few rows (4 at decode, 64 in a prefill chunk), so one
// block per row left most of the 132 SMs idle behind a chain of dependent
// loads and barriers. Design:
//
// * A row is cut into C column slices (kernels/fused_ln_quant.py,
//   plan_row_split: a power of two up to 16, so that rows x C reaches about
//   one wave), one block each, and the C blocks of a row form one
//   thread-block cluster (grid (rows * C), cluster (C)).
// * Every thread issues all its loads before any arithmetic: its NV
//   vectors of VEC = 8 columns of x (16-byte loads: 8 bf16 or 2 x 4 f32),
//   of gamma (and beta), and the scale and zero-point of each vector's
//   group (one division per vector; no vector straddles two groups). The
//   row then stays in registers: x is read from memory once. VEC = 1 is
//   the same body for widths or groups that are no multiple of 8 columns,
//   or unaligned pointers.
// * A row statistic is a per-thread sum (the thread's vectors, then their
//   columns, in order), an xor butterfly over the warp, one shared-memory
//   slot per warp and a cluster barrier; then every warp reads all C x W
//   warp sums through distributed shared memory and adds them in a fixed
//   order: warps 0..W-1 of a rank, then ranks 0..C-1. Every block computes
//   the same bits, so all slices normalise by one r. LayerNorm keeps the
//   reference's two reductions (the mean, then the mean of (x - mu)^2) as
//   two such exchanges, not a one-pass Welford update.
// * The emit stores one 8-byte vector per 8 int8 columns (x's dtype in
//   16-byte vectors when EMIT = false). A block leaves only after the whole
//   cluster has read its shared memory (a split arrive/wait barrier around
//   the emit).
//
// Float order follows the reference: ((x - mu) * r) * g + b or
// (x * r) * (1 + g), true division by s_g, half-to-even rint, + z_g,
// clamp. Built without fast math and without FMA contraction, and with no
// float atomics, so only the reduction order and rsqrtf's last bit can
// differ from the plain version, and a repeated call gives the same bits.
// C = 1 skips the exchange through the cluster (a plain block barrier).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxSplit = 16;     // Hopper's largest (non-portable) cluster

struct Params {
  const void* x;          // (rows, d) f32 or bf16
  const float* gamma;     // (d,)
  const float* beta;      // (d,) LayerNorm only
  const float* scale;     // (G,)
  const float* zp;        // (G,)
  void* out;              // (rows, d) int8 or x's dtype
  int d, group_size, split;
  float eps, qmin, qmax;
};

// VEC consecutive columns of x as floats; VEC = 8 is one 16-byte load of
// bf16 or two of f32.
template <int VEC>
__device__ __forceinline__ void load_x(const float* p, float* v) {
  if constexpr (VEC == 8) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
    v[0] = *p;
  }
}
template <int VEC>
__device__ __forceinline__ void load_x(const __nv_bfloat16* p, float* v) {
  if constexpr (VEC == 8) {
    const uint4 w = *reinterpret_cast<const uint4*>(p);
    const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&u[i]);
      v[2 * i] = __low2float(h);
      v[2 * i + 1] = __high2float(h);
    }
  } else {
    v[0] = __bfloat162float(*p);
  }
}

template <int VEC>
__device__ __forceinline__ void store_y(float* p, const float* v) {
  if constexpr (VEC == 8) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    *p = v[0];
  }
}
template <int VEC>
__device__ __forceinline__ void store_y(__nv_bfloat16* p, const float* v) {
  if constexpr (VEC == 8) {
    unsigned u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      u[i] = *reinterpret_cast<const unsigned*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
  } else {
    *p = __float2bfloat16(v[0]);
  }
}
template <int VEC>
__device__ __forceinline__ void store_q(int8_t* p, const float* v) {
  if constexpr (VEC == 8) {
    unsigned u[2] = {0u, 0u};
#pragma unroll
    for (int e = 0; e < 8; ++e)
      u[e >> 2] |= ((unsigned)(int)v[e] & 0xffu) << (8 * (e & 3));
    *reinterpret_cast<uint2*>(p) = make_uint2(u[0], u[1]);
  } else {
    *p = (int8_t)v[0];
  }
}

template <int VEC>
__device__ __forceinline__ void load_f(const float* p, float* v) {
  load_x<VEC>(p, v);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The row sum of the threads' partials t: a butterfly over each warp, one
// slot per warp, then (after a barrier over the cluster, or the block when
// C = 1) every warp adds the C x W warp sums in order: warps of rank 0,
// then of rank 1, ... Every thread of the cluster returns the same bits.
__device__ __forceinline__ float row_sum(float t, float* slot, int split) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  t = warp_sum(t);
  if (lane == 0) slot[warp] = t;
  float v = 0.f;
  if (split > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    if (lane < split * nw)
      v = *cluster.map_shared_rank(slot + lane % nw, lane / nw);
  } else {
    __syncthreads();
    if (lane < nw) v = slot[lane];
  }
  float total = 0.f;
  for (int r = 0; r < split; ++r) {
    float pr = __shfl_sync(0xffffffffu, v, r * nw);
    for (int w = 1; w < nw; ++w) pr += __shfl_sync(0xffffffffu, v, r * nw + w);
    total = r == 0 ? pr : total + pr;
  }
  return total;
}

template <typename T, bool LN, bool EMIT, int VEC, int NV>
__global__ void __launch_bounds__(kMaxThreads)
norm_quant_kernel(const Params p) {
  __shared__ float slot[2][32];
  const int C = p.split, d = p.d;
  const int rank = blockIdx.x % C;        // the block's rank in its cluster
  const long row = blockIdx.x / C;
  const int cols = d / C, col0 = rank * cols, nvec = cols / VEC;
  const T* xr = (const T*)p.x + row * d;

  // every load of the thread's share, before any arithmetic
  float x[NV][VEC], g[NV][VEC], bt[LN ? NV : 1][VEC], s[NV], z[NV];
  bool live[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int v = threadIdx.x + k * blockDim.x;
    live[k] = v < nvec;
    const int c = col0 + v * VEC;
#pragma unroll
    for (int e = 0; e < VEC; ++e) x[k][e] = g[k][e] = bt[LN ? k : 0][e] = 0.f;
    s[k] = 1.f;
    z[k] = 0.f;
    if (live[k]) {
      load_x<VEC>(xr + c, x[k]);
      load_f<VEC>(p.gamma + c, g[k]);
      if (LN) load_f<VEC>(p.beta + c, bt[LN ? k : 0]);
      const int gi = c / p.group_size;    // one division per vector
      s[k] = p.scale[gi];
      z[k] = p.zp[gi];
    }
  }

  float mu = 0.f;
  if (LN) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k)
#pragma unroll
      for (int e = 0; e < VEC; ++e) t += x[k][e];
    mu = row_sum(t, slot[0], C) / (float)d;
  }
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < NV; ++k)
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float v = LN ? x[k][e] - mu : x[k][e];
      ss += live[k] ? v * v : 0.f;
    }
  const float r = rsqrtf(row_sum(ss, slot[1], C) / (float)d + p.eps);
  // the cluster's reads of this block's slots are done once every block
  // has arrived here; wait for that only before leaving
  if (C > 1) asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");

#pragma unroll
  for (int k = 0; k < NV; ++k) {
    if (!live[k]) continue;
    float q[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float y = LN ? (x[k][e] - mu) * r * g[k][e] + bt[LN ? k : 0][e]
                         : x[k][e] * r * (1.f + g[k][e]);
      q[e] = fminf(fmaxf(rintf(y / s[k]) + z[k], p.qmin), p.qmax);
      if (!EMIT) q[e] = (q[e] - z[k]) * s[k];
    }
    const long o = row * d + col0 + (long)(threadIdx.x + k * blockDim.x) * VEC;
    if (EMIT)
      store_q<VEC>((int8_t*)p.out + o, q);
    else
      store_y<VEC>((T*)p.out + o, q);
  }
  if (C > 1) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

template <typename T, bool LN, bool EMIT, int VEC, int NV>
int launch(const Params& p, int rows, int threads, cudaStream_t stream) {
  const auto kernel = norm_quant_kernel<T, LN, EMIT, VEC, NV>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(rows * p.split);
  cfg.blockDim = dim3(threads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  if (p.split > 1) {
    static bool non_portable = false;   // clusters of 9..16 blocks
    if (!non_portable) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (e != cudaSuccess) return (int)e;
      non_portable = true;
    }
    attr[0].id = cudaLaunchAttributeClusterDimension;   // a row's slices
    attr[0].val.clusterDim.x = p.split;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  return (int)cudaLaunchKernelEx(&cfg, kernel, p);
}

template <typename T, bool LN, bool EMIT>
int launch_vec(const Params& p, int rows, int threads, int nv, int vec,
               cudaStream_t s) {
  if (vec == 8) {
    if (nv == 1) return launch<T, LN, EMIT, 8, 1>(p, rows, threads, s);
    if (nv == 2) return launch<T, LN, EMIT, 8, 2>(p, rows, threads, s);
    return launch<T, LN, EMIT, 8, 4>(p, rows, threads, s);
  }
  if (nv == 1) return launch<T, LN, EMIT, 1, 1>(p, rows, threads, s);
  if (nv == 2) return launch<T, LN, EMIT, 1, 2>(p, rows, threads, s);
  return launch<T, LN, EMIT, 1, 4>(p, rows, threads, s);
}

template <typename T, bool LN>
int launch_emit(const Params& p, int rows, int threads, int nv, int vec,
                int emit, cudaStream_t s) {
  return emit ? launch_vec<T, LN, true>(p, rows, threads, nv, vec, s)
              : launch_vec<T, LN, false>(p, rows, threads, nv, vec, s);
}

}  // namespace

// x: (rows, d) f32 (x_is_bf16 = 0) or bf16 (x_is_bf16 = 1), contiguous;
// gamma (d,) f32; beta (d,) f32 (LayerNorm only, else may be null);
// scale/zp (G,) f32 with d % G == 0; out (rows, d): int8 when emit = 1,
// x's dtype when emit = 0. ln = 1: LayerNorm, 0: RMSNorm. The row plan
// (kernels/fused_ln_quant.py): split C (a power of two <= 16) slices of
// d / C columns per row, one cluster of C blocks of `threads` threads (a
// multiple of 32, <= 512, at most 32 / C warps), each thread nv (1, 2 or
// 4) vectors of vec (8 or 1) columns; vec = 8 needs d / C and d / G
// multiples of 8 and x, gamma, beta, out 16-byte aligned. Returns
// cudaGetLastError() (or the launch's error).
extern "C" int norm_quant(const void* x, int x_is_bf16, const void* gamma,
                          const void* beta, const void* scale, const void* zp,
                          void* out, int rows, int d, int groups, float eps,
                          int qmin, int qmax, int split, int threads, int nv,
                          int vec, int ln, int emit, void* stream) {
  if (rows <= 0) return (int)cudaGetLastError();
  if (split < 1 || split > kMaxSplit || (split & (split - 1)) ||
      d % (split * vec) || (d / groups) % vec || threads % 32 ||
      threads > kMaxThreads || threads / 32 * split > 32 ||
      (nv != 1 && nv != 2 && nv != 4) || (vec != 1 && vec != 8) ||
      threads * nv * vec < d / split)
    return (int)cudaErrorInvalidValue;
  Params p = {};
  p.x = x;
  p.gamma = (const float*)gamma;
  p.beta = (const float*)beta;
  p.scale = (const float*)scale;
  p.zp = (const float*)zp;
  p.out = out;
  p.d = d;
  p.group_size = d / groups;
  p.split = split;
  p.eps = eps;
  p.qmin = (float)qmin;
  p.qmax = (float)qmax;
  const cudaStream_t s = (cudaStream_t)stream;
  if (x_is_bf16)
    return ln ? launch_emit<__nv_bfloat16, true>(p, rows, threads, nv, vec,
                                                 emit, s)
              : launch_emit<__nv_bfloat16, false>(p, rows, threads, nv, vec,
                                                  emit, s);
  return ln ? launch_emit<float, true>(p, rows, threads, nv, vec, emit, s)
            : launch_emit<float, false>(p, rows, threads, nv, vec, emit, s);
}
