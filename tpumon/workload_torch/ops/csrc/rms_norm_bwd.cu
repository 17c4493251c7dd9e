// rms_norm_bwd: RMSNorm's backward from the forward's saved rstd r:
//   g = dy * w,  c = sum(g * x) over the row,
//   dx = r * g - x * (r^3 * c / D)   (in x's dtype),
//   dw = sum over rows of dy * (x * r)   (f32).
//
// Replaces no TPU kernel: tpumon/workload/ops/core.py rms_norm is plain jnp,
// and XLA fuses its gradient on the TPU. This is the Hopper counterpart of
// that fusion; the port's plain version is autograd through the eager f32
// chain (a dozen passes), or the closed form ops/core.py
// rms_norm_bwd_reference, which this kernel computes.
//
// Bound on this card: bytes. x and dy are read once and dx written once: at
// the dense cells' [65536, 4096] bf16 that is 1.611 GB, 0.48 ms at 3.35
// TB/s; at Mixtral's micro-batch [16384, 4096] 0.403 GB, 0.12 ms. dw's
// partials (grid x D f32, 8.7 MB at 528 CTAs and D = 4096) are written and
// read once more.
//
// Design: two launches and no atomics, so two runs of a step give the same
// bits.
// - backward_rows: a grid of a few CTAs an SM (the wrapper sizes it) walks
//   the row-groups in a fixed stride; a row's TPR threads load their part
//   of x and dy with 16-byte loads, keep them packed in registers, form
//   c with one row sum, and write dx. Each thread adds dy * (x * r) for
//   the columns it owns into f32 registers across all its rows; at the
//   end a CTA's rows add in a fixed order and it writes one [D] partial.
// - sum_partials: one thread a column and eight partial rows a thread,
//   then the eight in a fixed order: dw [D].
#include "rms_norm.cuh"

namespace rmsnorm {

template <typename T, class L>
__global__ void __launch_bounds__(L::THREADS)
    backward_rows(const T* __restrict__ x, const T* __restrict__ dy,
                  const float* __restrict__ w, const float* __restrict__ rstd,
                  T* __restrict__ dx, float* __restrict__ part, int rows,
                  int D) {
  using V = Vec<T>;
  __shared__ float red[L::ROWS * L::WARPS];
  // Rows 1.. of a CTA hand their dw sums to row 0 here.
  __shared__ float stage[(L::ROWS - 1) * L::WIDTH + 1];
  const int r = threadIdx.x / L::TPR, t = threadIdx.x % L::TPR;
  const int nv = D / 8;
  const float inv_d = 1.0f / float(D);
  const int groups = (rows + L::ROWS - 1) / L::ROWS;

  float acc[L::VECS][8];
#pragma unroll
  for (int k = 0; k < L::VECS; ++k) {
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[k][i] = 0.0f;
  }

  for (int grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    const int64_t row = int64_t(grp) * L::ROWS + r;
    const bool live = row < rows;
    const float rs = live ? rstd[row] : 0.0f;
    typename V::Raw xr[L::VECS], dr[L::VECS];
#pragma unroll
    for (int k = 0; k < L::VECS; ++k) {
      const int col = k * L::TPR + t;
      if (live && col < nv) {
        xr[k] = V::fetch(x + row * D + 8 * col);
        dr[k] = V::fetch(dy + row * D + 8 * col);
      }
    }
    float c = 0.0f;
#pragma unroll
    for (int k = 0; k < L::VECS; ++k) {
      const int col = k * L::TPR + t;
      if (live && col < nv) {
        float xv[8], dv[8], wv[8];
        V::unpack(xr[k], xv);
        V::unpack(dr[k], dv);
        load_weight(w + 8 * col, wv);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          c += (dv[i] * wv[i]) * xv[i];
          acc[k][i] += dv[i] * (xv[i] * rs);
        }
      }
    }
    c = row_sum<L>(c, red, r, t);
    if (live) {
      const float coef = rs * rs * rs * c * inv_d;
#pragma unroll
      for (int k = 0; k < L::VECS; ++k) {
        const int col = k * L::TPR + t;
        if (col < nv) {
          float xv[8], dv[8], wv[8], out[8];
          V::unpack(xr[k], xv);
          V::unpack(dr[k], dv);
          load_weight(w + 8 * col, wv);
#pragma unroll
          for (int i = 0; i < 8; ++i) out[i] = rs * (dv[i] * wv[i]) - xv[i] * coef;
          V::store(dx + row * D + 8 * col, out);
        }
      }
    }
  }

  if constexpr (L::ROWS > 1) {
    if (r > 0) {
#pragma unroll
      for (int k = 0; k < L::VECS; ++k) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          stage[(r - 1) * L::WIDTH + 8 * (k * L::TPR + t) + i] = acc[k][i];
        }
      }
    }
    __syncthreads();
    if (r == 0) {
      for (int q = 1; q < L::ROWS; ++q) {
#pragma unroll
        for (int k = 0; k < L::VECS; ++k) {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            acc[k][i] += stage[(q - 1) * L::WIDTH + 8 * (k * L::TPR + t) + i];
          }
        }
      }
    }
  }
  if (r == 0) {
    float* out = part + int64_t(blockIdx.x) * D;
#pragma unroll
    for (int k = 0; k < L::VECS; ++k) {
      const int col = k * L::TPR + t;
      if (col < nv) Vec<float>::store(out + 8 * col, acc[k]);
    }
  }
}

// dw[col] = sum over p of part[p, col], in the same order on every run.
constexpr int SUM_COLS = 32, SUM_ROWS = 8;

__global__ void __launch_bounds__(SUM_COLS * SUM_ROWS)
    sum_partials(const float* __restrict__ part, float* __restrict__ dw,
                 int parts, int D) {
  __shared__ float s[SUM_ROWS][SUM_COLS + 1];
  const int tx = threadIdx.x % SUM_COLS, ty = threadIdx.x / SUM_COLS;
  const int col = blockIdx.x * SUM_COLS + tx;
  float a = 0.0f;
  if (col < D) {
    for (int p = ty; p < parts; p += SUM_ROWS) a += part[int64_t(p) * D + col];
  }
  s[ty][tx] = a;
  __syncthreads();
  if (ty == 0 && col < D) {
    float total = 0.0f;
#pragma unroll
    for (int q = 0; q < SUM_ROWS; ++q) total += s[q][tx];
    dw[col] = total;
  }
}

template <typename T>
int run(const void* x, const void* dy, const void* w, const void* rstd,
        void* dx, void* part, void* dw, int rows, int D, int grid,
        void* stream) {
  if (grid < 1) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = with_layout(D, [&](auto layout) {
    using L = decltype(layout);
    backward_rows<T, L><<<grid, L::THREADS, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(dy),
        static_cast<const float*>(w), static_cast<const float*>(rstd),
        static_cast<T*>(dx), static_cast<float*>(part), rows, D);
    return int(cudaGetLastError());
  });
  if (err) return err;
  sum_partials<<<(D + SUM_COLS - 1) / SUM_COLS, SUM_COLS * SUM_ROWS, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(dw), grid, D);
  return int(cudaGetLastError());
}

}  // namespace rmsnorm

// Plain C entry for ctypes: x, dy and dx [rows, D] in bf16 (is_f32 = 0) or
// f32 (is_f32 = 1), w [D] f32, rstd [rows] f32, part [grid, D] f32 scratch,
// dw [D] f32, all contiguous and 16-byte aligned; grid >= 1 CTAs walk the
// rows (a CTA with none writes a zero partial). Launches backward_rows, then
// sum_partials. Returns 0 when both launched, else a cudaError_t value, or
// rmsnorm::WIDTH_ERROR for a width no layout takes.
extern "C" int rms_norm_bwd(const void* x, const void* dy, const void* w,
                            const void* rstd, void* dx, void* part, void* dw,
                            int rows, int D, int is_f32, int grid,
                            void* stream) {
  if (is_f32) {
    return rmsnorm::run<float>(x, dy, w, rstd, dx, part, dw, rows, D, grid,
                               stream);
  }
  return rmsnorm::run<__nv_bfloat16>(x, dy, w, rstd, dx, part, dw, rows, D,
                                     grid, stream);
}
