// The merge of split-KV partials gathered from the ranks of a
// tensor-parallel decode step, for Hopper (sm_90a). With a KV cache whose
// sequence dim is cut over the ranks (the reference's default layout,
// kv_seq_shard), K5, K6 and K7 run in partial mode over each rank's cells
// (split_attend.cuh) and the ranks gather their rows along the split dim;
// this kernel merges the P = ranks x splits rows of every (lane, kv head,
// query head) in (rank, split) order with the in-kernel merge's arithmetic
// and order (split_attend.cuh, merge_stats and the last block's sum):
//
//   one pass (rows acc_j, m_j, l_j; prow = hd + 2):
//     m = max(-1e30, max m_j), l = max(sum l_j e^(m_j - m), 1e-30),
//     out = sum acc_j e^(m_j - m) / l          (sums in j order)
//   statistics (rows m_j, l_j; prow = 2): the global (m, l) as above,
//     written to ml_out (B, KV, G, 2) for the second launch of every rank;
//   sum (rows acc_j of the second launch; prow = hd): out = sum acc_j.
//
// With out_q the merged v is written as K4's int8 clip(rint(v / s_o) + z_o,
// qmin, qmax) (true division, half-to-even rintf) into the (B, KV*G*hd)
// input of the output projection, else as f32 to out (B, KV, G, hd). An
// idle lane (every cell masked on every rank, every m_j = -1e30) weighs
// every split by e^0 and gives the mean of all the ranks' cells' V, as
// the whole-cache kernel does. No TPU kernel has this form: the reference
// leaves the cross-device merge to GSPMD. One block per (query head, kv
// head, lane): its thread 0 merges the statistics (P steps, in order) and
// the threads weigh and sum the P rows of each column; the splits'
// weights sit in dynamic shared memory. Built with -fmad=false.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

enum MergeMode { ONE_PASS = 0, STATS = 1, SUM = 2 };

__global__ void __launch_bounds__(kThreads)
merge_partials_kernel(const float* part, int mode, int P, int hd, int prow,
                      float* out, int8_t* out_q, const float* out_scale,
                      const float* out_zp, float qmin, float qmax,
                      float* ml_out) {
  extern __shared__ float w_s[];            // P weights, then l
  const int g = blockIdx.x, G = gridDim.x;
  const size_t bh = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  const float* rows = part + bh * P * G * prow + (size_t)g * prow;
  const size_t stride = (size_t)G * prow;   // from split j to split j + 1
  if (mode != SUM) {
    if (threadIdx.x == 0) {
      float mm = kNegInf;
      for (int j = 0; j < P; ++j)
        mm = fmaxf(mm, rows[j * stride + prow - 2]);
      float ll = 0.f;
      for (int j = 0; j < P; ++j) {
        const float* r = rows + j * stride + prow - 2;
        ll += r[1] * expf(r[0] - mm);
      }
      const float l = fmaxf(ll, 1e-30f);
      if (mode == STATS) {
        ml_out[(bh * G + g) * 2] = mm;
        ml_out[(bh * G + g) * 2 + 1] = l;
      }
      w_s[P] = l;
      w_s[0] = mm;               // the max, until the weights replace it
    }
    if (mode == STATS) return;
    __syncthreads();
    const float mm = w_s[0];
    __syncthreads();
    for (int j = threadIdx.x; j < P; j += blockDim.x)
      w_s[j] = expf(rows[j * stride + prow - 2] - mm);
    __syncthreads();
  }
  const float s_o = out_q ? out_scale[0] : 1.f;
  const float z_o = out_q ? out_zp[0] : 0.f;
  for (int col = threadIdx.x; col < hd; col += blockDim.x) {
    float x = 0.f;
    for (int j = 0; j < P; ++j) {
      const float y = rows[j * stride + col];
      x += mode == ONE_PASS ? y * w_s[j] : y;
    }
    const float v = mode == ONE_PASS ? x / w_s[P] : x;
    const size_t o = (bh * G + g) * hd + col;
    if (out_q)
      out_q[o] = (int8_t)fminf(fmaxf(rintf(v / s_o) + z_o, qmin), qmax);
    else
      out[o] = v;
  }
}

}  // namespace

// part (B,KV,P,G,prow) f32 contiguous, prow = hd + 2 (mode 0, one pass),
// 2 (mode 1, statistics) or hd (mode 2, sum). Mode 1 writes ml_out
// (B,KV,G,2) f32; modes 0 and 2 write out (B,KV,G,hd) f32, or, with out_q
// non-null, out null and out_q (B,KV*G*hd) int8 on the per-tensor grid
// out_scale / out_zp ((1,) f32). 1 <= P <= 4096. Returns
// cudaGetLastError().
extern "C" int merge_partials(const void* part, int mode, int batch, int kv,
                              int p, int g, int hd, void* out, void* out_q,
                              const void* out_scale, const void* out_zp,
                              int qmin, int qmax, void* ml_out,
                              void* stream) {
  if (batch <= 0 || kv <= 0) return (int)cudaGetLastError();
  if (mode < ONE_PASS || mode > SUM || p < 1 || p > 4096 || g < 1 ||
      g > 65535 || kv > 65535 || hd < 1 ||
      (mode == STATS) != (ml_out != nullptr) ||
      (mode != STATS && (out == nullptr) == (out_q == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int prow = mode == ONE_PASS ? hd + 2 : mode == STATS ? 2 : hd;
  merge_partials_kernel<<<dim3(g, kv, batch), kThreads,
                          sizeof(float) * (p + 1), (cudaStream_t)stream>>>(
      (const float*)part, mode, p, hd, prow, (float*)out, (int8_t*)out_q,
      (const float*)out_scale, (const float*)out_zp, (float)qmin,
      (float)qmax, (float*)ml_out);
  return (int)cudaGetLastError();
}
