// rms_norm_fwd: RMSNorm's forward, y = x * rsqrt(mean(x^2) + eps) * w over
// the last dimension, with f32 arithmetic and one rounding to x's dtype,
// plus rstd = rsqrt(mean(x^2) + eps) per row (f32) for the backward.
//
// Replaces no TPU kernel: tpumon/workload/ops/core.py rms_norm is plain jnp,
// which XLA fuses into one pass on the TPU. This is the Hopper counterpart of
// that fusion; the port's plain version (ops/core.py rms_norm_reference) is
// an eager chain of seven f32 passes.
//
// Bound on this card: bytes. x is read once and y written once: at the dense
// cells' [65536, 4096] bf16 that is 1.074 GB, 0.32 ms at 3.35 TB/s; at
// Mixtral's micro-batch [16384, 4096] 0.268 GB, 0.08 ms. The weight (16 KB)
// and rstd (4 bytes a row) are noise. A few flops a byte: far below the
// 295 FLOP/byte line.
//
// Design: TPR threads a row (rms_norm.cuh Layout: 128 at D = 4096, so a
// thread holds 32 values), one row-group a CTA. Each thread reads its part
// of the row once with 16-byte loads and keeps it in registers; the squares
// are summed in f32 (warp shuffles, then shared memory across a row's
// warps in a fixed order), and y = (x * r) * w is written with 16-byte
// stores, in the order of operations of the plain version. Nothing but x,
// y, rstd and the cached weight touches device memory.
#include "rms_norm.cuh"

namespace rmsnorm {

template <typename T, class L>
__global__ void __launch_bounds__(L::THREADS)
    forward_rows(const T* __restrict__ x, const float* __restrict__ w,
                 T* __restrict__ y, float* __restrict__ rstd, int rows, int D,
                 float eps) {
  __shared__ float red[L::ROWS * L::WARPS];
  const int r = threadIdx.x / L::TPR, t = threadIdx.x % L::TPR;
  const int64_t row = int64_t(blockIdx.x) * L::ROWS + r;
  const bool live = row < rows;
  const int nv = D / 8;
  const T* xr = x + row * D;

  float v[L::VECS][8];
  float ss = 0.0f;
#pragma unroll
  for (int k = 0; k < L::VECS; ++k) {
    const int c = k * L::TPR + t;
    if (live && c < nv) {
      Vec<T>::unpack(Vec<T>::fetch(xr + 8 * c), v[k]);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[k][i] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) ss += v[k][i] * v[k][i];
  }
  ss = row_sum<L>(ss, red, r, t);
  if (!live) return;  // after the row sum's barriers
  const float rs = rsqrtf(ss * (1.0f / float(D)) + eps);
  if (t == 0) rstd[row] = rs;
  T* yr = y + row * D;
#pragma unroll
  for (int k = 0; k < L::VECS; ++k) {
    const int c = k * L::TPR + t;
    if (c < nv) {
      float wv[8], out[8];
      load_weight(w + 8 * c, wv);
#pragma unroll
      for (int i = 0; i < 8; ++i) out[i] = (v[k][i] * rs) * wv[i];
      Vec<T>::store(yr + 8 * c, out);
    }
  }
}

template <typename T>
int run(const void* x, const void* w, void* y, void* rstd, int rows, int D,
        float eps, void* stream) {
  return with_layout(D, [&](auto layout) {
    using L = decltype(layout);
    if (rows <= 0) return 0;
    const int grid = (rows + L::ROWS - 1) / L::ROWS;
    forward_rows<T, L><<<grid, L::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<const float*>(w),
        static_cast<T*>(y), static_cast<float*>(rstd), rows, D, eps);
    return int(cudaGetLastError());
  });
}

}  // namespace rmsnorm

// Plain C entry for ctypes: x and y [rows, D] in bf16 (is_f32 = 0) or f32
// (is_f32 = 1), w [D] f32, rstd [rows] f32, all contiguous and 16-byte
// aligned. Returns 0 when launched (or rows == 0), else a cudaError_t value,
// or rmsnorm::WIDTH_ERROR for a width no layout takes.
extern "C" int rms_norm_fwd(const void* x, const void* w, void* y, void* rstd,
                            int rows, int D, int is_f32, float eps,
                            void* stream) {
  if (is_f32) return rmsnorm::run<float>(x, w, y, rstd, rows, D, eps, stream);
  return rmsnorm::run<__nv_bfloat16>(x, w, y, rstd, rows, D, eps, stream);
}
