// The pieces of flash_dq.cu, the one flash kernel still on WMMA: tile
// constants, tile loads, warp reductions and one warp-level bf16
// tensor-core product. flash_fwd.cu and flash_dkv.cu are built on wgmma
// and TMA from hopper_common.cuh instead.
//
// Layout and conventions, common to every kernel:
// - q / O / dO / dQ are [B, S, H, D] and k / v / dK / dV are [B, Sk, KV, D],
//   contiguous bf16 (the model's layout; no transposes in the wrapper).
//   lse and delta are [B, H, S] f32.
// - q-head h reads kv-head (h * KV) / H; K/V are never repeated in memory.
// - The mask value is the finite -1e30, never -inf, so a masked logit
//   underflows to exp(x - m) == 0 without forming inf - inf.
// - A CTA has 4 warps. A tile has 64 rows and every warp owns 16 of them:
//   the products a warp issues and the row-wise softmax it then runs touch
//   only its own rows, so they need __syncwarp, not __syncthreads.
//
// Precision: every product is a bf16 x bf16 WMMA (m16n16k16) with f32
// accumulation. The forward's first product is exact (bf16 x bf16 products
// fit f32), the second takes P rounded to bf16 as the TPU kernel does. The
// backward rounds P and dS to bf16 before their products, where the TPU
// kernel keeps them in f32; that costs about 2^-9 relative per element.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace flash {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int BQ = 64;        // q rows per tile
constexpr int BK = 64;        // k rows per tile
constexpr int THREADS = 128;  // 4 warps x 16 rows
constexpr float NEG_BIG = -1e30f;

// Shared-memory row strides. The pads break bank conflicts and keep every
// 16-row slab 32-byte aligned, as wmma::load_matrix_sync requires.
template <int D>
struct Ld {
  static constexpr int H = D + 8;   // bf16 [rows][D] tiles
  static constexpr int S = BK + 4;  // f32 [rows][BK] scores
  static constexpr int P = BK + 8;  // bf16 [rows][BK] probabilities
  static constexpr int A = D + 4;   // f32 [rows][D] accumulators
  static constexpr size_t tile_h = size_t(BQ) * H * 2;
  static constexpr size_t tile_s = size_t(BQ) * S * 4;
  static constexpr size_t tile_p = size_t(BQ) * P * 2;
  static constexpr size_t tile_a = size_t(BQ) * A * 4;
  static_assert(BQ == BK, "the tile carve-up assumes square tiles");
  static_assert(tile_h % 32 == 0 && tile_s % 32 == 0, "32-byte alignment");
  static_assert(tile_p % 32 == 0 && tile_a % 32 == 0, "32-byte alignment");
};

// Bump allocator over the dynamic shared memory; every piece it hands out
// is a multiple of 32 bytes, so every piece stays 32-byte aligned.
struct Carve {
  unsigned char* p;
  template <typename T>
  __device__ T* take(size_t bytes) {
    T* out = reinterpret_cast<T*>(p);
    p += bytes;
    return out;
  }
};

// Copy rows [row0, row0 + R) of a row-strided bf16 array into a shared
// tile [R][D + 8], 16 bytes per thread per step. Rows at or past n_rows
// are zero-filled (the ragged edge).
template <int R, int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int row0,
                                          int n_rows, int64_t row_stride) {
  constexpr int VEC = 8;
  constexpr int PER_ROW = D / VEC;
  for (int i = threadIdx.x; i < R * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW;
    const int c = (i % PER_ROW) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows) {
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * row_stride + c);
    }
    *reinterpret_cast<uint4*>(dst + r * Ld<D>::H + c) = val;
  }
}

// Load R consecutive f32 row values (lse or delta) starting at row0; rows
// at or past n_rows read 0 (they are masked out wherever they are used).
template <int R>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int row0, int n_rows) {
  for (int i = threadIdx.x; i < R; i += THREADS) {
    dst[i] = (row0 + i < n_rows) ? src[row0 + i] : 0.0f;
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// One warp: C[16, 16*NT] (=|+=) A[16, K] . B[K, 16*NT], bf16 operands in
// shared memory, f32 C in shared memory (row-major, stride ldc).
// A row_major: a points at the slab's first row (A[m][k] = a[m*lda + k]).
// A col_major: A[m][k] = a[k*lda + m] (a transposed operand).
// B row_major: B[k][n] = b[k*ldb + n]; B col_major: B[k][n] = b[n*ldb + k].
template <int NT, int K, typename LA, typename LB, bool ACCUM>
__device__ __forceinline__ void warp_gemm(float* c, int ldc, const bf16* a,
                                          int lda, const bf16* b, int ldb) {
  constexpr bool a_row = std::is_same<LA, wmma::row_major>::value;
  constexpr bool b_row = std::is_same<LB, wmma::row_major>::value;
#pragma unroll 1
  for (int nt = 0; nt < NT; ++nt) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    if constexpr (ACCUM) {
      wmma::load_matrix_sync(acc, c + nt * 16, ldc, wmma::mem_row_major);
    } else {
      wmma::fill_fragment(acc, 0.0f);
    }
#pragma unroll
    for (int kk = 0; kk < K; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LA> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> fb;
      wmma::load_matrix_sync(fa, a_row ? a + kk : a + kk * lda, lda);
      wmma::load_matrix_sync(
          fb, b_row ? b + kk * ldb + nt * 16 : b + nt * 16 * ldb + kk, ldb);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(c + nt * 16, acc, ldc, wmma::mem_row_major);
  }
}

// Launch helper: raise the dynamic shared-memory limit, launch, and hand
// back the launch status (a refused launch never runs, and a later
// synchronize would not report it).
template <typename Kernel, typename... Args>
inline int launch(Kernel kernel, dim3 grid, size_t smem, void* stream,
                  Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return int(cudaGetLastError());
}

}  // namespace flash
