// flash_dq: the attention backward's dQ, on Hopper's wgmma with the
// accumulators in registers, fed by TMA through a ring of K/V tiles. For
// each q row it recomputes P = exp(s * scale - lse) from the forward's
// lse, forms dP = dO v^T and dS = P * (dP - delta) * scale, and
// accumulates dQ = dS k. delta = rowsum(dO * O) minus the lse cotangent
// comes from the caller (plain torch, as XLA fused it outside Pallas on
// the TPU).
//
// Replaces two TPU kernels of tpumon/workload/ops/flash_attention.py:
// _dq_kernel_resident (:407) and _dq_kernel_streamed (:441), which differ
// only in whether the K/V band fits a TPU core's scoped VMEM; here K/V
// tiles always stream through shared memory, so one kernel covers both.
//
// Bound on this card: three products, 6 * B * H * pairs * D operations
// over the live (q, k) pairs. At the main path's shape (B=2, S=4096,
// H=16, KV=4, D=128, causal) that is 206.2 GFLOP, 0.209 ms at 989 TFLOP/s
// bf16, against 0.035 ms for its 118.5 MB of bytes: bound by operations.
//
// Design (one CTA per batch, q-head and BQ-row q-block; the tile pair
// BQ x BK, 64 or 128 rows each, is a template parameter that the wrapper
// picks per call, as the reference's block_q / block_k):
// - It is flash_fwd with one more product. The first BQ / 64 warpgroups
//   are consumers, 64 q rows each (wgmma's M), and keep their dQ accumulator
//   (64 x D f32) in registers for the whole k loop. Per k tile they issue
//   S = q k^T and dP = dO v^T (all four operands K-major in shared memory)
//   as one commit group, so they wait once for both; form P and dS on the
//   S and dP registers; pack dS to bf16 in registers, where the
//   accumulator layout already is the A operand of the next product; and
//   issue dQ += dS k, reading the same k tile MN-major through the trans-b
//   flag: no copies, no shared-memory round trip.
// - lse (times log2 e) and delta are per q row and constant over the k
//   loop: each consumer thread reads its two rows once into registers.
// - The last warpgroup is the producer: one of its threads loads the q and dO
//   tiles once, on one barrier, and keeps K and V tiles in flight through
//   a ring of STAGES stages with full/empty mbarriers. K and V share a
//   stage's full barrier: waiting for V between the S and dP issues (to
//   start S while V still arrives) made ptxas serialize every wgmma
//   ("(C7520) ... WG.AR in divergent path": the wait is a loop).
//   At BQ = 128 ptxas fits every thread in 168 registers and setmaxnreg
//   moves the producer's to the consumers; at BQ = 64 a thread may take
//   255 and none move (hopper::Warps).
// - BK k rows a stage. At BK = 64 a consumer thread holds dQ (D / 2), S
//   and dP (32 each) and the packed dS (16): 144 registers at D = 128.
//   BK = 128 holds 224 there (192 at D = 64): past the 168 of a 128-row
//   CTA, where ptxas spilled and serialized every wgmma at both head
//   dims, so the pair 128 x 128 is not compiled; 64 x 128 is. Shared
//   memory at D = 128, BQ = 128, BK = 64: q and dO 64 KB, a stage 32 KB,
//   two stages: 129 KB with the barriers, one CTA per SM.
// - Causal: the k loop ends at the diagonal; only tiles that cross it (or
//   the Sk edge) are masked; the heaviest q-blocks launch first. With
//   BK < BQ the last k tile of a q-block lies wholly above warpgroup 0's
//   rows: that warpgroup skips its products there but still releases the
//   stage. The Sk edge is masked explicitly: a K row past Sk
//   arrives as zeros, so s = 0 and P = 2^-lse, not 0.
// - dQ is stored from registers in q's dtype, each row once (no atomics):
//   bit-for-bit deterministic.
//
// What still holds it above its bound: within a warpgroup each k tile is
// serial (S and dP, then the exp and dS math, then dQ += dS k) with
// nothing of its own in flight; the other warpgroup's products are the
// only overlap.
#include "hopper_common.cuh"

namespace dq {

using namespace hopper;

constexpr int STAGES = 2;

template <int D, int BQ, int BK>
struct Smem {
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;
  static constexpr int DO_OFF = Q_BYTES;
  static constexpr int K_OFF = 2 * Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int BYTES = BAR_OFF + (1 + 2 * STAGES) * 8;
  static constexpr size_t LAUNCH = size_t(BYTES) + 1024;  // 1 KB alignment
  static_assert(Q_BYTES % 1024 == 0 && KV_BYTES % 1024 == 0, "1 KB tiles");
  static_assert(LAUNCH <= 232448, "over the 227 KB a block may use");
};

template <int D, int BQ, int BK>
__global__ void __launch_bounds__(Warps<BQ>::THREADS, 1)
    dq_kernel(const __grid_constant__ CUtensorMap map_q,
              const __grid_constant__ CUtensorMap map_k,
              const __grid_constant__ CUtensorMap map_v,
              const __grid_constant__ CUtensorMap map_do,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dq_out, int H, int KV, int S, int Sk,
              float scale, int causal) {
  static_assert(BK == 64 || BK == 128, "k tiles of 64 or 128 rows");
  using L = Smem<D, BQ, BK>;
  using W = Warps<BQ>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_base_1k(smem_raw);
  unsigned char* sQ = sm;
  unsigned char* sDO = sm + L::DO_OFF;
  unsigned char* sK = sm + L::K_OFF;
  unsigned char* sV = sm + L::V_OFF;
  uint64_t* full_q = reinterpret_cast<uint64_t*>(sm + L::BAR_OFF);
  uint64_t* full = full_q + 1;
  uint64_t* empty = full + STAGES;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int kvh = (h * KV) / H;
  // Under causal the last q-blocks see the most keys: launch them first.
  const int qb = causal ? int(gridDim.y) - 1 - int(blockIdx.y) : blockIdx.y;
  const int q0 = qb * BQ;
  int n_kb = (Sk + BK - 1) / BK;
  if (causal) n_kb = min(n_kb, (q0 + BQ + BK - 1) / BK);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], W::CONSUMER_WARPS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == W::PRODUCER) {
    // ---- producer: one thread issues every copy ----
    producer_regs<W>();
    if (threadIdx.x == W::PRODUCER * 128) {
      prefetch_map(&map_q);
      prefetch_map(&map_do);
      prefetch_map(&map_k);
      prefetch_map(&map_v);
      mbar_arrive_tx(full_q, 2 * L::Q_BYTES);
      tma_load_tile<D>(sQ, BQ, &map_q, full_q, h, q0, b);
      tma_load_tile<D>(sDO, BQ, &map_do, full_q, h, q0, b);
      for (int kb = 0; kb < n_kb; ++kb) {
        const int s = kb % STAGES;
        mbar_wait(&empty[s], ((kb / STAGES) & 1) ^ 1);
        mbar_arrive_tx(&full[s], 2 * L::KV_BYTES);
        tma_load_tile<D>(sK + s * L::KV_BYTES, BK, &map_k, &full[s], kvh,
                         kb * BK, b);
        tma_load_tile<D>(sV + s * L::KV_BYTES, BK, &map_v, &full[s], kvh,
                         kb * BK, b);
      }
    }
  } else {
    // ---- consumers: 64 q rows per warpgroup ----
    consumer_regs<W>();
    const int t = threadIdx.x % 128, lane = t % 32;
    const int row0 = q0 + wg * 64 + (t / 32) * 16 + lane / 4;  // and +8
    const int cq = (lane % 4) * 2;
    const int wg_row_min = q0 + wg * 64;
    const unsigned char* sQw = sQ + wg * 64 * ROW_BYTES;
    const unsigned char* sDOw = sDO + wg * 64 * ROW_BYTES;
    const float scale_log2 = scale * LOG2E;

    // This thread's two rows of lse (in the log2 domain) and delta.
    float lse2[2], del[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = row0 + 8 * hr;
      const int64_t at = (int64_t(b) * H + h) * S + row;
      lse2[hr] = row < S ? lse[at] * LOG2E : 0.0f;
      del[hr] = row < S ? delta[at] : 0.0f;
    }

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;

    mbar_wait(full_q, 0);
    for (int kb = 0; kb < n_kb; ++kb) {
      const int s = kb % STAGES;
      const uint32_t parity = (kb / STAGES) & 1;
      const int k0 = kb * BK;
      const unsigned char* sKs = sK + s * L::KV_BYTES;
      const unsigned char* sVs = sV + s * L::KV_BYTES;
      // The stage is released only after it was filled: an arrival before
      // would count toward the stage's previous fill.
      mbar_wait(&full[s], parity);
      // Under causal a tile wholly above this warpgroup's rows is dead.
      if (!(causal && k0 > wg_row_min + 63)) {
        // S = q k^T and dP = dO v^T: the head dim is the contraction.
        // Zeroed although the first k slice overwrites them: left
        // undefined, ptxas may give both the same registers.
        float sc[BK / 2], dp[BK / 2];
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          sc[i] = 0.0f;
          dp[i] = 0.0f;
        }
        const uint64_t d_q = opaque(desc_sw128(sQw, 0, 1024));
        const uint64_t d_k = opaque(desc_sw128(sKs, 0, 1024));
        const uint64_t d_do = opaque(desc_sw128(sDOw, 0, 1024));
        const uint64_t d_v = opaque(desc_sw128(sVs, 0, 1024));
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          // k16 slice kk: box kk / 4, then 32 bytes (2 units of 16) a slice.
          const int box = kk / 4, slice = (kk % 4) * 2;
          wgmma_ss<BK>(sc, d_q + box * (BQ * ROW_BYTES / 16) + slice,
                       d_k + box * (BK * ROW_BYTES / 16) + slice, kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int box = kk / 4, slice = (kk % 4) * 2;
          wgmma_ss<BK>(dp, d_do + box * (BQ * ROW_BYTES / 16) + slice,
                       d_v + box * (BK * ROW_BYTES / 16) + slice, kk > 0);
        }
        wg_commit();
        wg_wait<0>();
        fence_regs(sc);
        fence_regs(dp);

        // P = exp2(s * scale log2 e - lse log2 e); dS = P (dP - delta)
        // scale, packed to bf16 in the A-operand layout of dQ += dS k.
        const bool masked =
            k0 + BK > Sk || (causal && k0 + BK - 1 > wg_row_min);
        uint32_t da[BK / 16][4];
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          float ds[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int idx = 8 * kk + e, hr = (e % 4) / 2;
            float p = ex2(sc[idx] * scale_log2 - lse2[hr]);
            if (masked) {
              const int col = k0 + 8 * (idx / 4) + cq + (e % 2);
              const int row = row0 + 8 * hr;
              if (col >= Sk || (causal && col > row)) p = 0.0f;
            }
            ds[e] = p * (dp[idx] - del[hr]) * scale;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) da[kk][i] = pack_bf16(ds[2 * i], ds[2 * i + 1]);
        }

        // dQ += dS k: k is [BK, D] with D contiguous, read MN-major.
        const uint64_t d_kt = opaque(desc_sw128(sKs, BK * ROW_BYTES, 1024));
        wg_fence();
        fence_regs(acc);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          wgmma_rs<D>(acc, da[kk], d_kt + kk * 16 * ROW_BYTES / 16, 1);
        }
        wg_commit();
        wg_wait<0>();
        fence_regs(acc);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    // Epilogue: dQ in q's dtype, each row written once.
    const int64_t q_stride = int64_t(H) * D;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = row0 + 8 * hr;
      if (row >= S) continue;
      bf16* out = dq_out + (int64_t(b) * S + row) * q_stride + int64_t(h) * D + cq;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(out + 8 * j) =
            pack_bf16(acc[4 * j + 2 * hr], acc[4 * j + 2 * hr + 1]);
      }
    }
  }
}

template <int D, int BQ, int BK>
int run(const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* dq_out, int B, int H,
        int KV, int S, int Sk, float scale, int causal, void* stream) {
  CUtensorMap map_q, map_k, map_v, map_do;
  int err = make_map(&map_q, q, B, S, H, D, BQ);
  if (!err) err = make_map(&map_do, dout, B, S, H, D, BQ);
  if (!err) err = make_map(&map_k, k, B, Sk, KV, D, BK);
  if (!err) err = make_map(&map_v, v, B, Sk, KV, D, BK);
  if (err) return err;
  const dim3 grid(B * H, (S + BQ - 1) / BQ);
  return launch(dq_kernel<D, BQ, BK>, grid, Warps<BQ>::THREADS,
                Smem<D, BQ, BK>::LAUNCH, stream, map_q, map_k, map_v, map_do,
                static_cast<const float*>(lse), static_cast<const float*>(delta),
                static_cast<bf16*>(dq_out), H, KV, S, Sk, scale, causal);
}

// The compiled tile pairs at head dim D (ops/flash_attention.py COMPILED
// lists the same): every (BQ, BK) in {64, 128}^2 but 128 x 128 at D = 64
// and 128; at D = 192 only 64 x 64. There a consumer thread holds dQ (96),
// S and dP (32 each) and dS (16): past the 168 registers of a 128-row
// CTA; and a 128-row k stage (2 x 48 KB, twice) is over the shared memory.
template <int D>
int dispatch(int block_q, int block_k, const void* q, const void* k,
             const void* v, const void* dout, const void* lse,
             const void* delta, void* dq_out, int B, int H, int KV, int S,
             int Sk, float scale, int causal, void* stream) {
#define DQ_TILE(BQ, BK)                                                    \
  if (block_q == BQ && block_k == BK) {                                    \
    return run<D, BQ, BK>(q, k, v, dout, lse, delta, dq_out, B, H, KV, S,  \
                          Sk, scale, causal, stream);                      \
  }
  DQ_TILE(64, 64)
  if constexpr (D <= 128) {
    DQ_TILE(64, 128)
    DQ_TILE(128, 64)
  }
#undef DQ_TILE
  return TILE_ERROR;
}

}  // namespace dq

// Plain C entry for ctypes. Returns 0 when launched, else a cudaError_t
// value, hopper::TMAP_ERROR + CUresult when a tensor map is refused, or
// hopper::TILE_ERROR for a (block_q, block_k) pair that is not compiled.
extern "C" int flash_dq(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dq, int B, int H, int KV, int S, int Sk, int D,
                        int block_q, int block_k, float scale, int causal,
                        void* stream) {
  if (D == 128) {
    return dq::dispatch<128>(block_q, block_k, q, k, v, dout, lse, delta, dq,
                             B, H, KV, S, Sk, scale, causal, stream);
  }
  if (D == 64) {
    return dq::dispatch<64>(block_q, block_k, q, k, v, dout, lse, delta, dq,
                            B, H, KV, S, Sk, scale, causal, stream);
  }
  if (D == 192) {
    return dq::dispatch<192>(block_q, block_k, q, k, v, dout, lse, delta, dq,
                             B, H, KV, S, Sk, scale, causal, stream);
  }
  return int(cudaErrorInvalidValue);
}
