// flash_dq: the attention backward's dQ. For each q row it recomputes
// P = exp(s * scale - lse) from the forward's lse, forms dP = dO v^T and
// dS = P * (dP - delta) * scale, and accumulates dQ = dS k.
//
// Replaces two TPU kernels of tpumon/workload/ops/flash_attention.py:
// _dq_kernel_resident (:407) and _dq_kernel_streamed (:441), which differ
// only in whether the K/V band fits a TPU core's scoped VMEM.
//
// Grid (ceil(S/64), B*H): one CTA per (batch, q-head, q-block), looping
// over K/V tiles up to the causal bound, with dQ accumulated in f32 in
// shared memory and written once in q's dtype. delta = rowsum(dO * O)
// minus the lse cotangent comes from the caller (plain torch, as XLA fused
// it outside Pallas on the TPU).
//
// Bound on this card: three products per (q, k) tile pair, so tensor-core
// operations at the training shapes. This version does not pipeline its
// copies and keeps every product's output in shared memory.
#include "flash_common.cuh"

namespace flash {

template <int D>
__global__ void __launch_bounds__(THREADS)
    dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dq, int H, int KV, int S, int Sk, float scale,
              int causal) {
  using L = Ld<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv{smem};
  bf16* sQ = cv.take<bf16>(L::tile_h);
  bf16* sDO = cv.take<bf16>(L::tile_h);
  bf16* sK = cv.take<bf16>(L::tile_h);
  bf16* sV = cv.take<bf16>(L::tile_h);
  float* sS = cv.take<float>(L::tile_s);
  float* sDP = cv.take<float>(L::tile_s);
  bf16* sDS = cv.take<bf16>(L::tile_p);
  float* sAcc = cv.take<float>(L::tile_a);
  float* sLse = cv.take<float>(BQ * 4);
  float* sDelta = cv.take<float>(BQ * 4);

  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int kvh = (h * KV) / H;
  const int64_t q_stride = int64_t(H) * D, kv_stride = int64_t(KV) * D;
  const int64_t q_off = int64_t(b) * S * q_stride + int64_t(h) * D;
  const int64_t kv_off = int64_t(b) * Sk * kv_stride + int64_t(kvh) * D;
  const int64_t row_off = (int64_t(b) * H + h) * S;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16;

  load_tile<BQ, D>(sQ, q + q_off, q0, S, q_stride);
  load_tile<BQ, D>(sDO, dout + q_off, q0, S, q_stride);
  load_rows<BQ>(sLse, lse + row_off, q0, S);
  load_rows<BQ>(sDelta, delta + row_off, q0, S);
  for (int i = threadIdx.x; i < BQ * L::A; i += THREADS) sAcc[i] = 0.0f;

  int n_kb = (Sk + BK - 1) / BK;
  if (causal) n_kb = min(n_kb, (q0 + BQ + BK - 1) / BK);

  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();
    load_tile<BK, D>(sK, k + kv_off, k0, Sk, kv_stride);
    load_tile<BK, D>(sV, v + kv_off, k0, Sk, kv_stride);
    __syncthreads();

    warp_gemm<BK / 16, D, wmma::row_major, wmma::col_major, false>(
        sS + r0 * L::S, L::S, sQ + r0 * L::H, L::H, sK, L::H);
    warp_gemm<BK / 16, D, wmma::row_major, wmma::col_major, false>(
        sDP + r0 * L::S, L::S, sDO + r0 * L::H, L::H, sV, L::H);
    __syncwarp();

    for (int rr = 0; rr < 16; ++rr) {
      const int r = r0 + rr, row = q0 + r;
      const float row_lse = sLse[r], row_delta = sDelta[r];
#pragma unroll
      for (int j = 0; j < BK / 32; ++j) {
        const int c = lane + 32 * j, col = k0 + c;
        const bool live = row < S && col < Sk && (!causal || col <= row);
        const float p = live ? expf(sS[r * L::S + c] * scale - row_lse) : 0.0f;
        const float ds = p * (sDP[r * L::S + c] - row_delta) * scale;
        sDS[r * L::P + c] = __float2bfloat16(ds);
      }
    }
    __syncwarp();

    warp_gemm<D / 16, BK, wmma::row_major, wmma::row_major, true>(
        sAcc + r0 * L::A, L::A, sDS + r0 * L::P, L::P, sK, L::H);
  }
  __syncwarp();

  for (int rr = 0; rr < 16; ++rr) {
    const int r = r0 + rr, row = q0 + r;
    if (row >= S) break;
    bf16* out = dq + (int64_t(b) * S + row) * q_stride + int64_t(h) * D;
    for (int c = lane; c < D; c += 32) {
      out[c] = __float2bfloat16(sAcc[r * L::A + c]);
    }
  }
}

template <int D>
int run(const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* dq, int B, int H, int KV,
        int S, int Sk, float scale, int causal, void* stream) {
  using L = Ld<D>;
  const size_t smem = 4 * L::tile_h + 2 * L::tile_s + L::tile_p + L::tile_a +
                      2 * BQ * 4;
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  return launch(dq_kernel<D>, grid, smem, stream,
                static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
                static_cast<const float*>(lse),
                static_cast<const float*>(delta), static_cast<bf16*>(dq), H,
                KV, S, Sk, scale, causal);
}

}  // namespace flash

// Plain C entry for ctypes. Returns a cudaError_t value (0 = launched).
extern "C" int flash_dq(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dq, int B, int H, int KV, int S, int Sk, int D,
                        float scale, int causal, void* stream) {
  if (D == 128) {
    return flash::run<128>(q, k, v, dout, lse, delta, dq, B, H, KV, S, Sk,
                           scale, causal, stream);
  }
  if (D == 64) {
    return flash::run<64>(q, k, v, dout, lse, delta, dq, B, H, KV, S, Sk,
                          scale, causal, stream);
  }
  return int(cudaErrorInvalidValue);
}
