// flash_fwd: the attention forward, O = softmax(q k^T / sqrt(D)) v and
// lse = m + log(l) per row.
//
// Replaces two TPU kernels of tpumon/workload/ops/flash_attention.py:
// _fwd_kernel_resident (:199) and _fwd_kernel_streamed (:233). They split
// only because a TPU core's scoped VMEM cannot hold long K/V bands; here
// K/V tiles always stream through shared memory, so one kernel covers both.
//
// Grid (ceil(S/64), B*H): one CTA per (batch, q-head, q-block). The CTA
// loops over 64-row K/V tiles up to the causal bound (the TPU kernel's
// bound, :218) or over all of Sk, with the online-softmax state m, l in
// shared memory and the f32 output accumulator in shared memory.
//
// Bound on this card: at the training shapes (S >= 1024, D = 128) the two
// products dominate and the kernel is bound by tensor-core operations, not
// bytes. This first version issues WMMA from shared memory with no copy
// pipelining, so it runs well below that bound; the ladder up is cp.async
// or TMA double buffering, then wgmma with the accumulator in registers.
#include "flash_common.cuh"

namespace flash {

template <int D>
__global__ void __launch_bounds__(THREADS)
    fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ o,
               float* __restrict__ lse, int H, int KV, int S, int Sk,
               float scale, int causal) {
  using L = Ld<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv{smem};
  bf16* sQ = cv.take<bf16>(L::tile_h);
  bf16* sK = cv.take<bf16>(L::tile_h);
  bf16* sV = cv.take<bf16>(L::tile_h);
  float* sS = cv.take<float>(L::tile_s);
  bf16* sP = cv.take<bf16>(L::tile_p);
  float* sAcc = cv.take<float>(L::tile_a);
  float* sM = cv.take<float>(BQ * 4);
  float* sL = cv.take<float>(BQ * 4);

  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int kvh = (h * KV) / H;
  const int64_t q_stride = int64_t(H) * D, kv_stride = int64_t(KV) * D;
  const bf16* qp = q + int64_t(b) * S * q_stride + int64_t(h) * D;
  const bf16* kp = k + int64_t(b) * Sk * kv_stride + int64_t(kvh) * D;
  const bf16* vp = v + int64_t(b) * Sk * kv_stride + int64_t(kvh) * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16;

  load_tile<BQ, D>(sQ, qp, q0, S, q_stride);
  for (int i = threadIdx.x; i < BQ * L::A; i += THREADS) sAcc[i] = 0.0f;
  for (int i = threadIdx.x; i < BQ; i += THREADS) {
    sM[i] = NEG_BIG;
    sL[i] = 0.0f;
  }

  int n_kb = (Sk + BK - 1) / BK;
  if (causal) n_kb = min(n_kb, (q0 + BQ + BK - 1) / BK);

  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();  // every warp is done with the previous K/V tiles
    load_tile<BK, D>(sK, kp, k0, Sk, kv_stride);
    load_tile<BK, D>(sV, vp, k0, Sk, kv_stride);
    __syncthreads();

    // s = q k^T for this warp's 16 rows.
    warp_gemm<BK / 16, D, wmma::row_major, wmma::col_major, false>(
        sS + r0 * L::S, L::S, sQ + r0 * L::H, L::H, sK, L::H);
    __syncwarp();

    // Online softmax over the warp's rows; each lane owns two columns.
    for (int rr = 0; rr < 16; ++rr) {
      const int r = r0 + rr, row = q0 + r;
      float sv[BK / 32];
      float mx = NEG_BIG;
#pragma unroll
      for (int j = 0; j < BK / 32; ++j) {
        const int c = lane + 32 * j, col = k0 + c;
        const bool live = col < Sk && (!causal || col <= row);
        sv[j] = live ? sS[r * L::S + c] * scale : NEG_BIG;
        mx = fmaxf(mx, sv[j]);
      }
      mx = warp_max(mx);
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, mx);
      const float alpha = expf(m_old - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < BK / 32; ++j) {
        const float p = expf(sv[j] - m_new);
        sP[r * L::P + lane + 32 * j] = __float2bfloat16(p);
        sum += p;
      }
      sum = warp_sum(sum);
      for (int c = lane; c < D; c += 32) sAcc[r * L::A + c] *= alpha;
      __syncwarp();  // every lane has read sM[r] before lane 0 moves it
      if (lane == 0) {
        sM[r] = m_new;
        sL[r] = sL[r] * alpha + sum;
      }
    }
    __syncwarp();

    // acc += bf16(p) v for this warp's rows.
    warp_gemm<D / 16, BK, wmma::row_major, wmma::row_major, true>(
        sAcc + r0 * L::A, L::A, sP + r0 * L::P, L::P, sV, L::H);
  }
  __syncwarp();

  for (int rr = 0; rr < 16; ++rr) {
    const int r = r0 + rr, row = q0 + r;
    if (row >= S) break;
    const float l = sL[r];
    const float inv = 1.0f / l;
    bf16* op = o + (int64_t(b) * S + row) * q_stride + int64_t(h) * D;
    for (int c = lane; c < D; c += 32) {
      op[c] = __float2bfloat16(sAcc[r * L::A + c] * inv);
    }
    if (lane == 0) lse[(int64_t(b) * H + h) * S + row] = sM[r] + logf(l);
  }
}

template <int D>
int run(const void* q, const void* k, const void* v, void* o, void* lse,
        int B, int H, int KV, int S, int Sk, float scale, int causal,
        void* stream) {
  using L = Ld<D>;
  const size_t smem = 3 * L::tile_h + L::tile_s + L::tile_p + L::tile_a +
                      2 * BQ * 4;
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  return launch(fwd_kernel<D>, grid, smem, stream,
                static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                static_cast<const bf16*>(v), static_cast<bf16*>(o),
                static_cast<float*>(lse), H, KV, S, Sk, scale, causal);
}

}  // namespace flash

// Plain C entry for ctypes. Returns a cudaError_t value (0 = launched).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, int B, int H, int KV, int S, int Sk, int D,
                         float scale, int causal, void* stream) {
  if (D == 128) {
    return flash::run<128>(q, k, v, o, lse, B, H, KV, S, Sk, scale, causal,
                           stream);
  }
  if (D == 64) {
    return flash::run<64>(q, k, v, o, lse, B, H, KV, S, Sk, scale, causal,
                          stream);
  }
  return int(cudaErrorInvalidValue);
}
