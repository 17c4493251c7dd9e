// flash_dkv: the attention backward's dK and dV. For one k-block it
// recomputes P = exp(s * scale - lse) and dS = P * (dO v^T - delta) * scale
// for every q row that can see it, and accumulates dV += P^T dO and
// dK += dS^T q over the q-heads of the GQA group.
//
// Replaces _dkv_kernel of tpumon/workload/ops/flash_attention.py (:476).
// On the TPU the group heads and q-blocks are grid dimensions over a
// revisited output block; here blocks run in parallel and in no order, so
// the CTA loops over them itself and keeps the sums on chip. No atomics,
// and the decomposition stays the reference's, so a parity failure points
// at one kernel.
//
// Grid (ceil(Sk/64), B*KV): one CTA per (batch, kv-head, k-block). Under
// causal the q loop starts at the first q-block whose last row reaches the
// k-block (the reference's _qj clamp, :605-614). dK and dV accumulate in
// f32 in shared memory and are written once in k's and v's dtype.
//
// Bound on this card: four products per (q, k) tile pair, so tensor-core
// operations at the training shapes. This version does not pipeline its
// copies; it uses about 187 KB of shared memory at D = 128, so one CTA
// per SM.
#include "flash_common.cuh"

namespace flash {

template <int D>
__global__ void __launch_bounds__(THREADS)
    dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int KV,
               int S, int Sk, float scale, int causal) {
  using L = Ld<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv{smem};
  bf16* sK = cv.take<bf16>(L::tile_h);
  bf16* sV = cv.take<bf16>(L::tile_h);
  bf16* sQ = cv.take<bf16>(L::tile_h);
  bf16* sDO = cv.take<bf16>(L::tile_h);
  float* sS = cv.take<float>(L::tile_s);
  float* sDP = cv.take<float>(L::tile_s);
  bf16* sP = cv.take<bf16>(L::tile_p);
  bf16* sDS = cv.take<bf16>(L::tile_p);
  float* sDK = cv.take<float>(L::tile_a);
  float* sDV = cv.take<float>(L::tile_a);
  float* sLse = cv.take<float>(BQ * 4);
  float* sDelta = cv.take<float>(BQ * 4);

  const int k0 = blockIdx.x * BK;
  const int b = blockIdx.y / KV, kvh = blockIdx.y % KV;
  const int group = H / KV;
  const int64_t q_stride = int64_t(H) * D, kv_stride = int64_t(KV) * D;
  const int64_t kv_off = int64_t(b) * Sk * kv_stride + int64_t(kvh) * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16;

  load_tile<BK, D>(sK, k + kv_off, k0, Sk, kv_stride);
  load_tile<BK, D>(sV, v + kv_off, k0, Sk, kv_stride);
  for (int i = threadIdx.x; i < BK * L::A; i += THREADS) {
    sDK[i] = 0.0f;
    sDV[i] = 0.0f;
  }

  const int n_qb = (S + BQ - 1) / BQ;
  const int qb_lo = causal ? k0 / BQ : 0;

  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;
    const int64_t q_off = int64_t(b) * S * q_stride + int64_t(h) * D;
    const int64_t row_off = (int64_t(b) * H + h) * S;
    for (int qb = qb_lo; qb < n_qb; ++qb) {
      const int q0 = qb * BQ;
      __syncthreads();  // every warp is done with the previous q tiles
      load_tile<BQ, D>(sQ, q + q_off, q0, S, q_stride);
      load_tile<BQ, D>(sDO, dout + q_off, q0, S, q_stride);
      load_rows<BQ>(sLse, lse + row_off, q0, S);
      load_rows<BQ>(sDelta, delta + row_off, q0, S);
      __syncthreads();

      // s and dP for this warp's 16 q rows against the k-block.
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
          const float p =
              live ? expf(sS[r * L::S + c] * scale - row_lse) : 0.0f;
          const float ds = p * (sDP[r * L::S + c] - row_delta) * scale;
          sP[r * L::P + c] = __float2bfloat16(p);
          sDS[r * L::P + c] = __float2bfloat16(ds);
        }
      }
      __syncthreads();  // the transposed products read every warp's rows

      // This warp's 16 k rows: dV += P^T dO, dK += dS^T q.
      warp_gemm<D / 16, BQ, wmma::col_major, wmma::row_major, true>(
          sDV + r0 * L::A, L::A, sP + r0, L::P, sDO, L::H);
      warp_gemm<D / 16, BQ, wmma::col_major, wmma::row_major, true>(
          sDK + r0 * L::A, L::A, sDS + r0, L::P, sQ, L::H);
    }
  }
  __syncwarp();

  for (int rr = 0; rr < 16; ++rr) {
    const int r = r0 + rr, row = k0 + r;
    if (row >= Sk) break;
    const int64_t off = (int64_t(b) * Sk + row) * kv_stride + int64_t(kvh) * D;
    for (int c = lane; c < D; c += 32) {
      dk[off + c] = __float2bfloat16(sDK[r * L::A + c]);
      dv[off + c] = __float2bfloat16(sDV[r * L::A + c]);
    }
  }
}

template <int D>
int run(const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* dk, void* dv, int B, int H,
        int KV, int S, int Sk, float scale, int causal, void* stream) {
  using L = Ld<D>;
  const size_t smem = 4 * L::tile_h + 2 * L::tile_s + 2 * L::tile_p +
                      2 * L::tile_a + 2 * BQ * 4;
  const dim3 grid((Sk + BK - 1) / BK, B * KV);
  return launch(dkv_kernel<D>, grid, smem, stream,
                static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
                static_cast<const float*>(lse),
                static_cast<const float*>(delta), static_cast<bf16*>(dk),
                static_cast<bf16*>(dv), H, KV, S, Sk, scale, causal);
}

}  // namespace flash

// Plain C entry for ctypes. Returns a cudaError_t value (0 = launched).
extern "C" int flash_dkv(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta,
                         void* dk, void* dv, int B, int H, int KV, int S,
                         int Sk, int D, float scale, int causal,
                         void* stream) {
  if (D == 128) {
    return flash::run<128>(q, k, v, dout, lse, delta, dk, dv, B, H, KV, S, Sk,
                           scale, causal, stream);
  }
  if (D == 64) {
    return flash::run<64>(q, k, v, dout, lse, delta, dk, dv, B, H, KV, S, Sk,
                          scale, causal, stream);
  }
  return int(cudaErrorInvalidValue);
}
