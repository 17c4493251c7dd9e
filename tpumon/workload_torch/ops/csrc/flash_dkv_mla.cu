// flash_dkv_mla: the attention backward's dK and dV for latent attention
// (DeepSeek-V2's MLA) at its true widths, q and k of DQK = 192 columns, v
// and dO of DV = 128, in one launch. flash_dkv.cu serves q.k widths 64 and
// 128; the wrapper's width table (ops/flash_attention.py, WIDTHS) sends
// every flash_dkv call at q.k width 192 here, v and dO padded to 128.
//
// Replaces _dkv_kernel of tpumon/workload/ops/flash_attention.py (:476) at
// these widths (the JAX package runs no MLA). As there and in flash_dkv.cu
// a CTA owns one k-block and loops over every q row that can see it and
// over the q-heads of its GQA group, keeping both sums on chip: no atomics,
// dK and dV deterministic and written once.
//
// Bound on this card: four products at their true widths, S^T = k q^T and
// dK += dS^T q at 192, dP^T = v dO^T and dV += P^T dO at 128, so
// 2 * B * H * pairs * (2 * 192 + 2 * 128) operations. At the
// deepseek-v2-lite.s4096 cell's shape (B = 16, H = KV = 16, S = 4096,
// causal: 8,390,656 pairs) that is 2.75 TFLOP, 2.78 ms at 989 TFLOP/s
// bf16, against 0.60 ms for its 2.0 GB of bytes: bound by operations.
//
// Why a kernel of its own: flash_dkv.cu's design at 192 would need v and
// dO padded to 192 (two copies of the inputs, a sliced copy of dV), run
// dP^T and dV at 192, and split dK and dV into two launches that each
// recompute S^T: 960 columns of products a (q, k) pair where 640 are
// needed.
//
// Design (one CTA per batch, kv-head and 64-row k-block; 288 threads):
// - Two consumer warpgroups on the same 64 k rows (wgmma's M), split by
//   product and not by rows: warpgroup 0 computes S^T = k q^T and
//   accumulates dV += P^T dO (64 f32 registers of dV), warpgroup 1
//   computes dP^T = v dO^T and accumulates dK += dS^T q (96 of dK). Each
//   does 320 columns of products a pair, the four products once each.
// - P crosses once, in f32, through shared memory: warpgroup 0 forms
//   P^T = exp2(s * scale log2 e - lse log2 e), masked, packs it to bf16
//   for its own dV product and stores the f32 values in its accumulator
//   order; warpgroup 1, whose dP^T accumulator has the same layout, reads
//   exactly its own thread's values back (16-byte loads, no bank
//   conflicts) and forms dS^T = P^T (dP^T - delta) scale, packed to bf16
//   for dK. P and dS are rounded to bf16 once each, from f32, as in
//   flash_dkv.cu. The P buffer is one per ring stage, so the stage's
//   empty barrier (both warpgroups) also frees it: one more barrier a
//   stage (pfull, 128 arrivals) and no other synchronisation.
// - The two warpgroups pipeline against each other: while warpgroup 0
//   does its exp, warpgroup 1's dK product of the last tile runs, and
//   while warpgroup 1 forms dS, warpgroup 0's dV product runs.
// - P^T and dS^T stay in registers as the A operands of dV += P^T dO and
//   dK += dS^T q (dO and q read MN-major through the trans-b flag); S^T
//   and dP^T read k, q, v and dO K-major, as in flash_dkv.cu.
// - Tiles: 64 k rows a CTA, 64 q rows a ring stage (every block_q the
//   wrapper takes streams at 64), so every wgmma of S^T and dP^T has
//   N = 64 and under causal no stage lies wholly above the k-block.
//   Shared memory: k 24 KB, v 16 KB, a stage 56 KB (q 24, dO 16, P 16)
//   and 0.5 KB of lse and delta, three stages: 211 KB, one CTA an SM.
// - The ninth warp is the producer: one lane loads k and v once and
//   streams q and dO tiles with TMA, v and dO at 128 columns; its 32
//   lanes copy the tile's lse (times log2 e) and delta into the stage.
//   Registers: 288 threads put three warps on one of the SM's four
//   register files, so ptxas holds every thread to 168, as at 384; the
//   consumers fit (warpgroup 1: dK 96, dP^T 32 and the packed dS 16).
//   Holding k and v as register A fragments too (48 and 32 registers,
//   which would spare 40 KB of shared-memory reads a tile) spilled 224
//   bytes and serialized the wgmmas, with or without setmaxnreg moving a
//   producer warpgroup's registers to the consumers: ptxas sizes every
//   path by the launch's 168.
// - Causal: the q loop starts at the k-block's own 64 rows; only the
//   diagonal tile (and the S edge) is masked.
//
// What still holds it below its bound (1.75 ms a call at B = 4 against
// 0.695, 40 %, on an H100 at 700 W): within a warpgroup each tile is
// serial (its first product, the exp or dS math, its second product),
// and warpgroup 1 waits for warpgroup 0's P; S^T and dP^T read both
// operands from shared memory at N = 64, and P crosses it in f32, so a
// tile moves about 190 KB through shared memory for its 1,280 cycles of
// products; and the producer waits for both warpgroups before it refills
// a stage. Issuing warpgroup 0's dV and the next tile's S^T as one commit
// group (one wait a tile) left the time where it was (1.727 against 1.748
// ms); the same for warpgroup 1 ran out of registers.
#include "hopper_common.cuh"

namespace dkv {

using namespace hopper;

constexpr int DQK = 192;  // q and k columns (DeepSeek-V2: 128 + 64 rope)
constexpr int DV = 128;   // v and dO columns
constexpr int BK = 64;    // k rows a CTA
constexpr int BQ = 64;    // q rows a ring stage
constexpr int MLA_STAGES = 3;
constexpr int THREADS = 2 * 128 + 32;  // two consumer warpgroups, one warp

struct MlaCfg {
  static constexpr int K_BYTES = BK * DQK * 2;
  static constexpr int V_BYTES = BK * DV * 2;
  static constexpr int Q_BYTES = BQ * DQK * 2;
  static constexpr int DO_BYTES = BQ * DV * 2;
  static constexpr int P_BYTES = BK * BQ * 4;  // f32 P^T, accumulator order
  static constexpr int V_OFF = K_BYTES;
  static constexpr int Q_OFF = V_OFF + V_BYTES;
  static constexpr int DO_OFF = Q_OFF + MLA_STAGES * Q_BYTES;
  static constexpr int P_OFF = DO_OFF + MLA_STAGES * DO_BYTES;
  static constexpr int LSE_OFF = P_OFF + MLA_STAGES * P_BYTES;
  static constexpr int DELTA_OFF = LSE_OFF + MLA_STAGES * BQ * 4;
  static constexpr int BAR_OFF = DELTA_OFF + MLA_STAGES * BQ * 4;
  static constexpr int BYTES = BAR_OFF + (1 + 3 * MLA_STAGES) * 8;
  static constexpr size_t LAUNCH = size_t(BYTES) + 1024;  // 1 KB alignment
  static_assert(K_BYTES % 1024 == 0 && V_BYTES % 1024 == 0 &&
                    Q_BYTES % 1024 == 0 && DO_BYTES % 1024 == 0,
                "1 KB tiles");
  static_assert(LAUNCH <= 232448, "over the 227 KB a block may use");
};

// k16 slice kk of a K-major tile of `rows` rows: box kk / 4, then 32 bytes
// (2 units of 16) a slice.
HOPPER_DEV uint64_t k_slice(uint64_t desc, int rows, int kk) {
  return desc + (kk / 4) * (rows * ROW_BYTES / 16) + (kk % 4) * 2;
}

template <int DQK_, int DV_, int BK_, int BQ_>
__global__ void __launch_bounds__(THREADS, 1)
    dkv_kernel_mla(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v,
                   const __grid_constant__ CUtensorMap map_do,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, int H, int KV, int S, int Sk,
                   float scale, int causal) {
  static_assert(DQK_ == DQK && DV_ == DV && BK_ == BK && BQ_ == BQ,
                "compiled at q.k 192, v 128, 64 x 64 tiles");
  using C = MlaCfg;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_base_1k(smem_raw);
  unsigned char* sK = sm;
  unsigned char* sV = sm + C::V_OFF;
  unsigned char* sQ = sm + C::Q_OFF;
  unsigned char* sDO = sm + C::DO_OFF;
  float4* sP = reinterpret_cast<float4*>(sm + C::P_OFF);
  float* sLse = reinterpret_cast<float*>(sm + C::LSE_OFF);
  float* sDelta = reinterpret_cast<float*>(sm + C::DELTA_OFF);
  uint64_t* full_kv = reinterpret_cast<uint64_t*>(sm + C::BAR_OFF);
  uint64_t* full = full_kv + 1;
  uint64_t* empty = full + MLA_STAGES;
  uint64_t* pfull = empty + MLA_STAGES;

  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV;
  const int k0 = blockIdx.y * BK;  // the heaviest k-blocks come first
  const int group = H / KV;
  const int n_qb = (S + BQ - 1) / BQ;
  const int qb_lo = causal ? k0 / BQ : 0;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
    for (int s = 0; s < MLA_STAGES; ++s) {
      mbar_init(&full[s], 32);  // the producer warp's lanes, one with tx
      mbar_init(&empty[s], 8);  // the consumers' eight warps
      mbar_init(&pfull[s], 128);  // warpgroup 0's threads, P stored
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: the ninth warp streams q, dO, lse and delta ----
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      prefetch_map(&map_q);
      prefetch_map(&map_do);
      mbar_arrive_tx(full_kv, C::K_BYTES + C::V_BYTES);
      tma_load_tile<DQK>(sK, BK, &map_k, full_kv, kvh, k0, b);
      tma_load_tile<DV>(sV, BK, &map_v, full_kv, kvh, k0, b);
    }
    int it = 0;
    for (int g = 0; g < group; ++g) {
      const int h = kvh * group + g;
      const float* lse_h = lse + (int64_t(b) * H + h) * S;
      const float* delta_h = delta + (int64_t(b) * H + h) * S;
      for (int qb = qb_lo; qb < n_qb; ++qb, ++it) {
        const int s = it % MLA_STAGES;
        const int q0 = qb * BQ;
        mbar_wait(&empty[s], ((it / MLA_STAGES) & 1) ^ 1);
        for (int i = lane; i < BQ; i += 32) {
          const bool live = q0 + i < S;
          sLse[s * BQ + i] = live ? lse_h[q0 + i] * LOG2E : 0.0f;
          sDelta[s * BQ + i] = live ? delta_h[q0 + i] : 0.0f;
        }
        if (lane == 0) {
          mbar_arrive_tx(&full[s], C::Q_BYTES + C::DO_BYTES);
          tma_load_tile<DQK>(sQ + s * C::Q_BYTES, BQ, &map_q, &full[s], h, q0,
                             b);
          tma_load_tile<DV>(sDO + s * C::DO_BYTES, BQ, &map_do, &full[s], h,
                            q0, b);
        } else {
          mbar_arrive(&full[s]);
        }
      }
    }
    return;
  }

  // ---- consumers: both warpgroups on the k-block's 64 rows ----
  const int t = threadIdx.x % 128, lane = t % 32;
  const int row0 = k0 + (t / 32) * 16 + lane / 4;  // and +8
  const int cq = (lane % 4) * 2;
  mbar_wait(full_kv, 0);

  if (wg == 0) {
    // S^T = k q^T, P^T, dV += P^T dO.
    const float scale_log2 = scale * LOG2E;
    float acc_dv[DV / 2];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) acc_dv[i] = 0.0f;

    int it = 0;
    for (int g = 0; g < group; ++g) {
      for (int qb = qb_lo; qb < n_qb; ++qb, ++it) {
        const int s = it % MLA_STAGES;
        const int q0 = qb * BQ;
        mbar_wait(&full[s], (it / MLA_STAGES) & 1);
        const unsigned char* sQs = sQ + s * C::Q_BYTES;
        const unsigned char* sDOs = sDO + s * C::DO_BYTES;

        // Zeroed although the first k slice overwrites it: left
        // undefined, ptxas may give it the registers of another array.
        float st[BQ / 2];
#pragma unroll
        for (int i = 0; i < BQ / 2; ++i) st[i] = 0.0f;
        const uint64_t d_k = opaque(desc_sw128(sK, 0, 1024));
        const uint64_t d_q = opaque(desc_sw128(sQs, 0, 1024));
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < DQK / 16; ++kk) {
          wgmma_ss<BQ>(st, k_slice(d_k, BK, kk), k_slice(d_q, BQ, kk), kk > 0);
        }
        wg_commit();
        wg_wait<0>();
        fence_regs(st);

        // Column c of this thread's pairs is q row q0 + c. Each k16 slice
        // is packed to bf16 as soon as it is formed; the f32 values go to
        // the stage's P buffer for warpgroup 1.
        const bool masked = q0 + BQ > S || (causal && q0 < k0 + BK - 1);
        const float* lse_s = sLse + s * BQ;
        float4* sPs = sP + s * (C::P_BYTES / 16);
        uint32_t pa[BQ / 16][4];
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int j = 2 * kk + jj;
            const float2 lse2 =
                *reinterpret_cast<const float2*>(lse_s + 8 * j + cq);
            float p[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int e = i % 2;
              p[i] = ex2(st[4 * j + i] * scale_log2 - (e ? lse2.y : lse2.x));
              if (masked) {
                const int col = q0 + 8 * j + cq + e;
                const int row = row0 + 8 * (i / 2);
                if (col >= S || (causal && col < row)) p[i] = 0.0f;
              }
            }
            pa[kk][2 * jj] = pack_bf16(p[0], p[1]);
            pa[kk][2 * jj + 1] = pack_bf16(p[2], p[3]);
            sPs[j * 128 + t] = make_float4(p[0], p[1], p[2], p[3]);
          }
        }
        mbar_arrive(&pfull[s]);

        // dV += P^T dO: dO is [BQ, DV], read MN-major, 16 q rows a slice.
        wg_fence();
        const uint64_t d_dot = opaque(desc_sw128(sDOs, BQ * ROW_BYTES, 1024));
        fence_regs(acc_dv);
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
          wgmma_rs<DV>(acc_dv, pa[kk], d_dot + kk * 16 * ROW_BYTES / 16, 1);
        }
        wg_commit();
        wg_wait<0>();
        fence_regs(acc_dv);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
      }
    }

    // Epilogue: dV in v's dtype, each row written once.
    const int64_t stride = int64_t(KV) * DV;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = row0 + 8 * hr;
      if (row >= Sk) continue;
      bf16* out = dv + (int64_t(b) * Sk + row) * stride + int64_t(kvh) * DV + cq;
#pragma unroll
      for (int j = 0; j < DV / 8; ++j) {
        *reinterpret_cast<uint32_t*>(out + 8 * j) =
            pack_bf16(acc_dv[4 * j + 2 * hr], acc_dv[4 * j + 2 * hr + 1]);
      }
    }
  } else {
    // dP^T = v dO^T, dS^T, dK += dS^T q.
    float acc_dk[DQK / 2];
#pragma unroll
    for (int i = 0; i < DQK / 2; ++i) acc_dk[i] = 0.0f;

    int it = 0;
    for (int g = 0; g < group; ++g) {
      for (int qb = qb_lo; qb < n_qb; ++qb, ++it) {
        const int s = it % MLA_STAGES;
        const uint32_t parity = (it / MLA_STAGES) & 1;
        mbar_wait(&full[s], parity);
        const unsigned char* sQs = sQ + s * C::Q_BYTES;
        const unsigned char* sDOs = sDO + s * C::DO_BYTES;

        float dpt[BQ / 2];
#pragma unroll
        for (int i = 0; i < BQ / 2; ++i) dpt[i] = 0.0f;
        const uint64_t d_v = opaque(desc_sw128(sV, 0, 1024));
        const uint64_t d_do = opaque(desc_sw128(sDOs, 0, 1024));
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < DV / 16; ++kk) {
          wgmma_ss<BQ>(dpt, k_slice(d_v, BK, kk), k_slice(d_do, BQ, kk),
                       kk > 0);
        }
        wg_commit();
        wg_wait<0>();
        fence_regs(dpt);

        // dS^T = P^T (dP^T - delta) scale, P^T from warpgroup 0 in this
        // thread's own accumulator order.
        mbar_wait(&pfull[s], parity);
        const float* delta_s = sDelta + s * BQ;
        const float4* sPs = sP + s * (C::P_BYTES / 16);
        uint32_t da[BQ / 16][4];
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int j = 2 * kk + jj;
            const float4 p4 = sPs[j * 128 + t];
            const float p[4] = {p4.x, p4.y, p4.z, p4.w};
            const float2 del2 =
                *reinterpret_cast<const float2*>(delta_s + 8 * j + cq);
            float ds[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              ds[i] = p[i] * (dpt[4 * j + i] - (i % 2 ? del2.y : del2.x)) *
                      scale;
            }
            da[kk][2 * jj] = pack_bf16(ds[0], ds[1]);
            da[kk][2 * jj + 1] = pack_bf16(ds[2], ds[3]);
          }
        }

        // dK += dS^T q: q is [BQ, DQK], read MN-major.
        wg_fence();
        const uint64_t d_qt = opaque(desc_sw128(sQs, BQ * ROW_BYTES, 1024));
        fence_regs(acc_dk);
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
          wgmma_rs<DQK>(acc_dk, da[kk], d_qt + kk * 16 * ROW_BYTES / 16, 1);
        }
        wg_commit();
        wg_wait<0>();
        fence_regs(acc_dk);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
      }
    }

    // Epilogue: dK in k's dtype, each row written once.
    const int64_t stride = int64_t(KV) * DQK;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = row0 + 8 * hr;
      if (row >= Sk) continue;
      bf16* out = dk + (int64_t(b) * Sk + row) * stride + int64_t(kvh) * DQK + cq;
#pragma unroll
      for (int j = 0; j < DQK / 8; ++j) {
        *reinterpret_cast<uint32_t*>(out + 8 * j) =
            pack_bf16(acc_dk[4 * j + 2 * hr], acc_dk[4 * j + 2 * hr + 1]);
      }
    }
  }
}

}  // namespace dkv

// Plain C entry for ctypes, with the arguments of flash_dkv.cu's entry and
// v's width beside D. Returns 0 when launched, cudaErrorInvalidValue for
// widths other than (192, 128), else a cudaError_t value,
// hopper::TMAP_ERROR + CUresult when a tensor map is refused, or
// hopper::TILE_ERROR for a (block_q, block_k) pair that is not compiled:
// block_q 64 or 128 (both streamed at 64 rows a stage), block_k 64.
extern "C" int flash_dkv_mla(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv, int B,
                             int H, int KV, int S, int Sk, int D, int Dv,
                             int block_q, int block_k, float scale,
                             int causal, void* stream) {
  using namespace dkv;
  if (D != DQK || Dv != DV) return int(cudaErrorInvalidValue);
  if ((block_q != 64 && block_q != 128) || block_k != BK) {
    return hopper::TILE_ERROR;
  }
  CUtensorMap map_q, map_k, map_v, map_do;
  int err = hopper::make_map(&map_q, q, B, S, H, DQK, BQ);
  if (!err) err = hopper::make_map(&map_do, dout, B, S, H, DV, BQ);
  if (!err) err = hopper::make_map(&map_k, k, B, Sk, KV, DQK, BK);
  if (!err) err = hopper::make_map(&map_v, v, B, Sk, KV, DV, BK);
  if (err) return err;
  const dim3 grid(B * KV, (Sk + BK - 1) / BK);
  return hopper::launch(dkv_kernel_mla<DQK, DV, BK, BQ>, grid, THREADS,
                        MlaCfg::LAUNCH, stream, map_q, map_k, map_v, map_do,
                        static_cast<const float*>(lse),
                        static_cast<const float*>(delta),
                        static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, KV,
                        S, Sk, scale, causal);
}
