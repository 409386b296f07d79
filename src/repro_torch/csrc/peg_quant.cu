// Per-embedding-group quantize (paper eq. 5), for Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/peg_quant.py: q =
// clip(rint(x / s_g) + z_g, qmin, qmax) per contiguous group of d/G columns,
//   EMIT = true:  q as int8 (peg_quantize, body _peg_quantize_kernel);
//   EMIT = false: (q - z_g) * s_g in x's dtype, bf16 rounded to nearest even
//                 at the store (peg_fake_quant, body _peg_fakequant_kernel).
//
// Bound on the H100: bytes (4 or 2 bytes read, 1, 2 or 4 written per
// element, a division and a rint). Design: an elementwise pass, 16 bytes of
// x per thread (4 f32 or 8 bf16 elements): where d and the group size are
// multiples of that width and the rows are 16-byte aligned, one 16-byte
// load, the group's (s, z) found once for the vector, and one 4-, 8- or
// 16-byte store; other shapes take the same elements one at a time, the
// group picked by column. True division and half-to-even rint keep the
// reference semantics; the build has no fast math and no FMA contraction,
// so the result equals the plain version exactly. At decode rows the
// wo_in quantize (K4) is folded into the attention merge (split_attend.cuh)
// and this kernel serves prefill and chunk rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float load_f(float v) { return v; }
__device__ __forceinline__ float load_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T store_f(float v);
template <>
__device__ __forceinline__ float store_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 store_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// The quantized value q of v on the grid (s, z), a float on [qmin, qmax].
__device__ __forceinline__ float quant(float v, float s, float z, float qmin,
                                       float qmax) {
  return fminf(fmaxf(rintf(v / s) + z, qmin), qmax);
}

template <typename T, bool EMIT>
__global__ void peg_quant_kernel(const T* __restrict__ x,
                                 const float* __restrict__ scale,
                                 const float* __restrict__ zp,
                                 void* __restrict__ out, long n, int d,
                                 int gs, float qmin, float qmax, int vec) {
  constexpr int V = 16 / sizeof(T);          // elements in 16 bytes of x
  const long base = ((long)blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (base >= n) return;
  if (vec) {  // d and gs multiples of V, 16-byte aligned: one row, one group
    const int g = (int)(base % d / gs);
    const float s = scale[g], z = zp[g];
    alignas(16) T in[V];
    *reinterpret_cast<uint4*>(in) = *reinterpret_cast<const uint4*>(x + base);
    float q[V];
#pragma unroll
    for (int e = 0; e < V; ++e) q[e] = quant(load_f(in[e]), s, z, qmin, qmax);
    if (EMIT) {
      alignas(8) int8_t o[V];
#pragma unroll
      for (int e = 0; e < V; ++e) o[e] = (int8_t)q[e];
      if constexpr (V == 8)
        *reinterpret_cast<uint2*>((int8_t*)out + base) =
            *reinterpret_cast<const uint2*>(o);
      else
        *reinterpret_cast<uint32_t*>((int8_t*)out + base) =
            *reinterpret_cast<const uint32_t*>(o);
    } else {
      alignas(16) T o[V];
#pragma unroll
      for (int e = 0; e < V; ++e) o[e] = store_f<T>((q[e] - z) * s);
      *reinterpret_cast<uint4*>((T*)out + base) =
          *reinterpret_cast<const uint4*>(o);
    }
    return;
  }
  for (long i = base; i < base + V && i < n; ++i) {
    const int g = (int)(i % d / gs);
    const float s = scale[g], z = zp[g];
    const float q = quant(load_f(x[i]), s, z, qmin, qmax);
    if (EMIT)
      ((int8_t*)out)[i] = (int8_t)q;
    else
      ((T*)out)[i] = store_f<T>((q - z) * s);
  }
}

template <typename T>
void launch(const void* x, const void* scale, const void* zp, void* out,
            long n, int d, int gs, float qmin, float qmax, int vec, int emit,
            cudaStream_t s) {
  const int threads = 256;
  const long per_block = 16 / sizeof(T) * (long)threads;
  const long blocks = (n + per_block - 1) / per_block;
  if (emit)
    peg_quant_kernel<T, true><<<blocks, threads, 0, s>>>(
        (const T*)x, (const float*)scale, (const float*)zp, out, n, d, gs,
        qmin, qmax, vec);
  else
    peg_quant_kernel<T, false><<<blocks, threads, 0, s>>>(
        (const T*)x, (const float*)scale, (const float*)zp, out, n, d, gs,
        qmin, qmax, vec);
}

}  // namespace

// x: (rows, d) f32 or bf16, contiguous, n = rows * d; scale/zp (G,) f32 with
// d % G == 0; out (rows, d): int8 when emit = 1, x's dtype when emit = 0.
// vec = 1 only where d and d / G are multiples of the elements in 16 bytes
// of x (4 f32, 8 bf16) and x and out are 16-byte aligned.
// Returns cudaGetLastError().
extern "C" int peg_quant(const void* x, int x_is_bf16, const void* scale,
                         const void* zp, void* out, long n, int d, int groups,
                         int qmin, int qmax, int vec, int emit, void* stream) {
  if (n > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    const int gs = d / groups;
    if (x_is_bf16)
      launch<__nv_bfloat16>(x, scale, zp, out, n, d, gs, (float)qmin,
                            (float)qmax, vec, emit, s);
    else
      launch<float>(x, scale, zp, out, n, d, gs, (float)qmin, (float)qmax,
                    vec, emit, s);
  }
  return (int)cudaGetLastError();
}
