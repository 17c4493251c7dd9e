// flash_dkv: the attention backward's dK and dV, on Hopper's wgmma with
// the accumulators in registers, fed by TMA through a ring of q/dO tiles.
// For one k-block it recomputes P = exp(s * scale - lse) and
// dS = P * (dO v^T - delta) * scale for every q row that can see it, and
// accumulates dV += P^T dO and dK += dS^T q over the q-heads of the GQA
// group.
//
// Replaces _dkv_kernel of tpumon/workload/ops/flash_attention.py (:476).
// On the TPU the group heads and q-blocks are grid dimensions over a
// revisited output block; here blocks run in parallel and in no order, so
// the CTA loops over them itself and keeps the sums on chip: no atomics,
// dK and dV deterministic and written once.
//
// Bound on this card: four products, 8 * B * H * pairs * D operations over
// the live (q, k) pairs. At the main path's shape (B=2, S=4096, H=16,
// KV=4, D=128, causal) that is 274.9 GFLOP, 0.278 ms at 989 TFLOP/s bf16,
// against 0.020 ms for its 67.4 MB of bytes: bound by operations.
//
// Design (one CTA per batch, kv-head and BK-row k-block; BK, 64 or 128,
// is a template parameter that the wrapper picks per call, as the
// reference's block_k, which is its dK/dV grid's k block):
// - The scores are computed transposed, with the k rows as wgmma's M:
//   S^T = k q^T and dP^T = v dO^T, all four operands K-major in shared
//   memory. The first BK / 64 warpgroups own 64 k rows each, exactly the
//   rows of dK
//   and dV they accumulate, so P^T and dS^T come out in registers as the
//   A operands of dV += P^T dO and dK += dS^T q (dO and q read MN-major
//   through the trans-b flag). No shared-memory transpose and no
//   __syncthreads between the halves of a step.
// - At D = 128 a CTA accumulates one of the two gradients (PART DV or DK:
//   two launches, the DV one without dP^T, delta or v). With dK and dV
//   both in one warpgroup (128 accumulator registers at D = 128) beside
//   S^T and dP^T, ptxas serialized every wgmma and spilled 80 to 290
//   bytes, whatever the setmaxnreg budget and for q tiles of 16 to 64
//   rows; with one of the two it does neither. Split, the DV part holds
//   64 + 32 accumulator registers and the DK part 64 + 16 + 16, at the
//   price of computing S^T twice (five products instead of four). At
//   D = 64 one CTA holds both (PART BOTH: 32 + 32 + 32 + 32).
// - BQ q rows per ring stage, the reference's block_q of this grid, capped
//   by the registers: 64, and 32 for PART DK at D = 128 (a 64-row tile put
//   its accumulators at 128 and spilled 8 bytes). Every block_q the
//   wrapper takes (64 or 128) therefore streams at the cap.
// - Head dims 64 and 128, the widths the reference runs, v as wide as q.
//   DeepSeek-V2's q.k width 192 with v 128 is flash_dkv_mla.cu's.
// - BK = 64 halves the CTA and doubles the grid, for shapes whose 128-row
//   grid leaves SMs idle (few kv heads, short ring stripes).
// - The first warp of the last warpgroup is the producer (its other three
//   warps exit at once). One lane loads k (and v) once and streams q and
//   dO tiles through a ring of STAGES stages with TMA; the warp's 32
//   lanes copy the tile's lse (times log2 e) and delta into the same stage
//   and arrive on its full barrier beside the TMA bytes. lse and delta are
//   per q row, so per column here. At BK = 128 ptxas fits every thread in
//   168 registers and setmaxnreg moves the producer's to the consumers;
//   at BK = 64 a thread may take 255 and none move (hopper::Warps).
// - Shared memory at D = 128: k and v 64 KB, a stage 16 to 32.5 KB, two
//   stages: at most 129 KB, one CTA per SM.
// - Causal: the q loop starts at the first q tile that reaches the
//   k-block; only tiles that cross the diagonal (or the S edge) are
//   masked, and a warpgroup skips a tile that its rows cannot see.
// - Window (window = W > 0, causal; flash_fwd.cu's): the q loop stops
//   after the stage that holds row k0 + BK - 2 + W, a warpgroup skips a
//   stage wholly past its rows' windows, and only stages the window's
//   edge crosses test the extra term. A runtime argument: no
//   instantiation is added.
//
// What still holds it below half its bound: S^T is computed twice at
// D = 128; the products of a step run back to back in each warpgroup with
// the exp and dS math between them and nothing else in flight; and the
// producer waits for both warpgroups before it refills a stage.
#include "hopper_common.cuh"

namespace dkv {

using namespace hopper;

constexpr int STAGES = 2;

// Which gradients a CTA accumulates.
enum Part { BOTH = 0, DV = 1, DK = 2 };

// The most q rows a stage that a part's registers hold.
template <int D, int PART>
constexpr int q_cap() {
  return D == 128 && PART == DK ? 32 : 64;
}

template <int D, int PART, int BK, int BQ_>
struct Cfg {
  static_assert(BK == 64 || BK == 128, "k tiles of 64 or 128 rows");
  static_assert(BQ_ == 32 || BQ_ == 64, "q stages of 32 or 64 rows");
  static_assert(BQ_ <= q_cap<D, PART>(), "over the part's register cap");
  static constexpr bool kDV = PART != DK;  // dV += P^T dO
  static constexpr bool kDK = PART != DV;  // dK += dS^T q, needs dP^T
  static constexpr int BQ = BQ_;
  static constexpr int KV_BYTES = BK * D * 2;
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int V_OFF = KV_BYTES;
  static constexpr int Q_OFF = 2 * KV_BYTES;
  static constexpr int DO_OFF = Q_OFF + STAGES * Q_BYTES;
  static constexpr int LSE_OFF = DO_OFF + STAGES * Q_BYTES;
  static constexpr int DELTA_OFF = LSE_OFF + STAGES * BQ * 4;
  static constexpr int BAR_OFF = DELTA_OFF + STAGES * BQ * 4;
  static constexpr int BYTES = BAR_OFF + (1 + 2 * STAGES) * 8;
  static constexpr size_t LAUNCH = size_t(BYTES) + 1024;  // 1 KB alignment
  static_assert(KV_BYTES % 1024 == 0 && Q_BYTES % 1024 == 0, "1 KB tiles");
  static_assert(LAUNCH <= 232448, "over the 227 KB a block may use");
};

template <int D, int PART, int BK, int BQ_>
__global__ void __launch_bounds__(Warps<BK>::THREADS, 1)
    dkv_kernel(const __grid_constant__ CUtensorMap map_q,
               const __grid_constant__ CUtensorMap map_k,
               const __grid_constant__ CUtensorMap map_v,
               const __grid_constant__ CUtensorMap map_do,
               const float* __restrict__ lse, const float* __restrict__ delta,
               bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int KV,
               int S, int Sk, float scale, int causal, int window) {
  using C = Cfg<D, PART, BK, BQ_>;
  using W = Warps<BK>;
  constexpr int BQ = C::BQ;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_base_1k(smem_raw);
  unsigned char* sK = sm;
  unsigned char* sV = sm + C::V_OFF;
  unsigned char* sQ = sm + C::Q_OFF;
  unsigned char* sDO = sm + C::DO_OFF;
  float* sLse = reinterpret_cast<float*>(sm + C::LSE_OFF);
  float* sDelta = reinterpret_cast<float*>(sm + C::DELTA_OFF);
  uint64_t* full_kv = reinterpret_cast<uint64_t*>(sm + C::BAR_OFF);
  uint64_t* full = full_kv + 1;
  uint64_t* empty = full + STAGES;

  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV;
  const int k0 = blockIdx.y * BK;  // the heaviest k-blocks come first
  const int group = H / KV;
  // Under a window the last q row that sees the k-block is k0 + BK - 2 + W;
  // win is W, or a distance past any sequence without one.
  int n_qb = (S + BQ - 1) / BQ;
  if (window > 0) n_qb = min(n_qb, (k0 + BK - 2 + window) / BQ + 1);
  const int qb_lo = causal ? k0 / BQ : 0;
  const int win = window > 0 ? window : (1 << 30);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 32);  // the producer warp's lanes, one with tx
      mbar_init(&empty[s], W::CONSUMER_WARPS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == W::PRODUCER) {
    // ---- producer: the warpgroup's first warp streams q, dO, lse, delta ----
    producer_regs<W>();
    if (threadIdx.x < W::PRODUCER * 128 + 32) {
      const int lane = threadIdx.x % 32;
      if (lane == 0) {
        prefetch_map(&map_q);
        prefetch_map(&map_do);
        mbar_arrive_tx(full_kv, (C::kDK ? 2 : 1) * C::KV_BYTES);
        tma_load_tile<D>(sK, BK, &map_k, full_kv, kvh, k0, b);
        if (C::kDK) tma_load_tile<D>(sV, BK, &map_v, full_kv, kvh, k0, b);
      }
      int it = 0;
      for (int g = 0; g < group; ++g) {
        const int h = kvh * group + g;
        const float* lse_h = lse + (int64_t(b) * H + h) * S;
        const float* delta_h = delta + (int64_t(b) * H + h) * S;
        for (int qb = qb_lo; qb < n_qb; ++qb, ++it) {
          const int s = it % STAGES;
          const int q0 = qb * BQ;
          mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          for (int i = lane; i < BQ; i += 32) {
            const bool live = q0 + i < S;
            sLse[s * BQ + i] = live ? lse_h[q0 + i] * LOG2E : 0.0f;
            if (C::kDK) sDelta[s * BQ + i] = live ? delta_h[q0 + i] : 0.0f;
          }
          if (lane == 0) {
            mbar_arrive_tx(&full[s], 2 * C::Q_BYTES);
            tma_load_tile<D>(sQ + s * C::Q_BYTES, BQ, &map_q, &full[s], h, q0,
                             b);
            tma_load_tile<D>(sDO + s * C::Q_BYTES, BQ, &map_do, &full[s], h,
                             q0, b);
          } else {
            mbar_arrive(&full[s]);
          }
        }
      }
    }
  } else {
    // ---- consumers: 64 k rows per warpgroup ----
    consumer_regs<W>();
    const int t = threadIdx.x % 128, lane = t % 32;
    const int row0 = k0 + wg * 64 + (t / 32) * 16 + lane / 4;  // and +8
    const int cq = (lane % 4) * 2;
    const int wg_row_min = k0 + wg * 64;
    const unsigned char* sKw = sK + wg * 64 * ROW_BYTES;
    const unsigned char* sVw = sV + wg * 64 * ROW_BYTES;
    const float scale_log2 = scale * LOG2E;

    float acc_dk[D / 2], acc_dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
      acc_dk[i] = 0.0f;
      acc_dv[i] = 0.0f;
    }

    mbar_wait(full_kv, 0);
    int it = 0;
    for (int g = 0; g < group; ++g) {
      for (int qb = qb_lo; qb < n_qb; ++qb, ++it) {
        const int s = it % STAGES;
        const int q0 = qb * BQ;
        mbar_wait(&full[s], (it / STAGES) & 1);
        // Under causal a tile wholly above this warpgroup's rows is dead, as
        // is one wholly past their windows.
        if (!((causal && q0 + BQ - 1 < wg_row_min) ||
              q0 >= wg_row_min + 63 + win)) {
          const unsigned char* sQs = sQ + s * C::Q_BYTES;
          const unsigned char* sDOs = sDO + s * C::Q_BYTES;

          // S^T = k q^T (and dP^T = v dO^T): k rows are M, q rows are N.
          // Zeroed although the first k slice overwrites them: left
          // undefined, ptxas may give both the same registers.
          float st[BQ / 2], dpt[BQ / 2];
#pragma unroll
          for (int i = 0; i < BQ / 2; ++i) {
            st[i] = 0.0f;
            dpt[i] = 0.0f;
          }
          const uint64_t d_k = opaque(desc_sw128(sKw, 0, 1024));
          const uint64_t d_q = opaque(desc_sw128(sQs, 0, 1024));
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            // k16 slice kk: box kk / 4, then 32 bytes (2 units of 16) a slice.
            const int box = kk / 4, slice = (kk % 4) * 2;
            wgmma_ss<BQ>(st, d_k + box * (BK * ROW_BYTES / 16) + slice,
                         d_q + box * (BQ * ROW_BYTES / 16) + slice, kk > 0);
          }
          if constexpr (C::kDK) {
            const uint64_t d_v = opaque(desc_sw128(sVw, 0, 1024));
            const uint64_t d_do = opaque(desc_sw128(sDOs, 0, 1024));
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk) {
              const int box = kk / 4, slice = (kk % 4) * 2;
              wgmma_ss<BQ>(dpt, d_v + box * (BK * ROW_BYTES / 16) + slice,
                           d_do + box * (BQ * ROW_BYTES / 16) + slice, kk > 0);
            }
          }
          wg_commit();
          wg_wait<0>();
          fence_regs(st);
          if constexpr (C::kDK) fence_regs(dpt);

          // P^T = exp2(s * scale log2 e - lse log2 e); dS^T = P^T (dP^T -
          // delta) scale. Column c of this thread's pairs is q row q0 + c.
          // Each k16 slice is packed to bf16 as soon as it is formed.
          const bool masked = q0 + BQ > S ||
                              (causal && q0 < wg_row_min + 63) ||
                              q0 + BQ - 1 >= wg_row_min + win;
          const float* lse_s = sLse + s * BQ;
          const float* delta_s = sDelta + s * BQ;
          uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
          for (int kk = 0; kk < BQ / 16; ++kk) {
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
              const int j = 2 * kk + jj;
              const float2 lse2 =
                  *reinterpret_cast<const float2*>(lse_s + 8 * j + cq);
              float p[4], ds[4];
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int idx = 4 * j + i, e = i % 2;
                p[i] = ex2(st[idx] * scale_log2 - (e ? lse2.y : lse2.x));
                if (masked) {
                  const int col = q0 + 8 * j + cq + e;
                  const int row = row0 + 8 * (i / 2);
                  if (col >= S || (causal && col < row) || col >= row + win) {
                    p[i] = 0.0f;
                  }
                }
              }
              if constexpr (C::kDV) {
                pa[kk][2 * jj] = pack_bf16(p[0], p[1]);
                pa[kk][2 * jj + 1] = pack_bf16(p[2], p[3]);
              }
              if constexpr (C::kDK) {
                const float2 del2 =
                    *reinterpret_cast<const float2*>(delta_s + 8 * j + cq);
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                  ds[i] = p[i] * (dpt[4 * j + i] - (i % 2 ? del2.y : del2.x)) *
                          scale;
                }
                da[kk][2 * jj] = pack_bf16(ds[0], ds[1]);
                da[kk][2 * jj + 1] = pack_bf16(ds[2], ds[3]);
              }
            }
          }

          // dV += P^T dO, dK += dS^T q: dO and q are [BQ, D], read
          // MN-major, 16 q rows a k16 slice.
          wg_fence();
          if constexpr (C::kDV) {
            const uint64_t d_dot = opaque(desc_sw128(sDOs, BQ * ROW_BYTES, 1024));
            fence_regs(acc_dv);
#pragma unroll
            for (int kk = 0; kk < BQ / 16; ++kk) {
              wgmma_rs<D>(acc_dv, pa[kk], d_dot + kk * 16 * ROW_BYTES / 16, 1);
            }
          }
          if constexpr (C::kDK) {
            const uint64_t d_qt = opaque(desc_sw128(sQs, BQ * ROW_BYTES, 1024));
            fence_regs(acc_dk);
#pragma unroll
            for (int kk = 0; kk < BQ / 16; ++kk) {
              wgmma_rs<D>(acc_dk, da[kk], d_qt + kk * 16 * ROW_BYTES / 16, 1);
            }
          }
          wg_commit();
          wg_wait<0>();
          if constexpr (C::kDV) fence_regs(acc_dv);
          if constexpr (C::kDK) fence_regs(acc_dk);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
      }
    }

    // Epilogue: dK and dV in k's and v's dtype, each row written once.
    const int64_t kv_stride = int64_t(KV) * D;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = row0 + 8 * hr;
      if (row >= Sk) continue;
      const int64_t off = (int64_t(b) * Sk + row) * kv_stride +
                          int64_t(kvh) * D + cq;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        if constexpr (C::kDK) {
          *reinterpret_cast<uint32_t*>(dk + off + 8 * j) =
              pack_bf16(acc_dk[4 * j + 2 * hr], acc_dk[4 * j + 2 * hr + 1]);
        }
        if constexpr (C::kDV) {
          *reinterpret_cast<uint32_t*>(dv + off + 8 * j) =
              pack_bf16(acc_dv[4 * j + 2 * hr], acc_dv[4 * j + 2 * hr + 1]);
        }
      }
    }
  }
}

template <int D, int PART, int BK, int BQ>
int run_part(const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* delta, void* dk, void* dv, int B,
             int H, int KV, int S, int Sk, float scale, int causal,
             int window, void* stream) {
  using C = Cfg<D, PART, BK, BQ>;
  CUtensorMap map_q, map_k, map_v, map_do;
  int err = make_map(&map_q, q, B, S, H, D, BQ);
  if (!err) err = make_map(&map_do, dout, B, S, H, D, BQ);
  if (!err) err = make_map(&map_k, k, B, Sk, KV, D, BK);
  if (!err) err = make_map(&map_v, v, B, Sk, KV, D, BK);
  if (err) return err;
  const dim3 grid(B * KV, (Sk + BK - 1) / BK);
  return launch(dkv_kernel<D, PART, BK, BQ>, grid, Warps<BK>::THREADS,
                C::LAUNCH, stream, map_q, map_k, map_v, map_do,
                static_cast<const float*>(lse), static_cast<const float*>(delta),
                static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, KV, S, Sk,
                scale, causal, window);
}

// Every part of one call at k tile BK: at D = 128 the dV part, then the
// dK part, each at its q cap; at D = 64 both gradients in one launch.
template <int D, int BK>
int run(const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* dk, void* dv, int B, int H,
        int KV, int S, int Sk, float scale, int causal, int window,
        void* stream) {
  if constexpr (D == 128) {
    int err = run_part<D, DV, BK, q_cap<D, DV>()>(
        q, k, v, dout, lse, delta, dk, dv, B, H, KV, S, Sk, scale, causal,
        window, stream);
    if (err) return err;
    return run_part<D, DK, BK, q_cap<D, DK>()>(
        q, k, v, dout, lse, delta, dk, dv, B, H, KV, S, Sk, scale, causal,
        window, stream);
  } else {
    return run_part<D, BOTH, BK, q_cap<D, BOTH>()>(
        q, k, v, dout, lse, delta, dk, dv, B, H, KV, S, Sk, scale, causal,
        window, stream);
  }
}

// The compiled tile pairs at head dim D (ops/flash_attention.py COMPILED
// lists the same): block_q 64 or 128, both streamed at the q cap, and
// block_k 64 or 128.
template <int D>
int dispatch(int block_q, int block_k, const void* q, const void* k,
             const void* v, const void* dout, const void* lse,
             const void* delta, void* dk, void* dv, int B, int H, int KV,
             int S, int Sk, float scale, int causal, int window,
             void* stream) {
  if (block_q != 64 && block_q != 128) return TILE_ERROR;
  if (block_k == 64) {
    return run<D, 64>(q, k, v, dout, lse, delta, dk, dv, B, H, KV, S, Sk,
                      scale, causal, window, stream);
  }
  if (block_k == 128) {
    return run<D, 128>(q, k, v, dout, lse, delta, dk, dv, B, H, KV, S, Sk,
                       scale, causal, window, stream);
  }
  return TILE_ERROR;
}

}  // namespace dkv

// Plain C entry for ctypes, with flash_dkv_mla.cu's arguments: v's width
// Dv beside D, which must equal it here, and window (0 for none).
// Returns 0 when launched, cudaErrorInvalidValue for other widths, else a
// cudaError_t value, hopper::TMAP_ERROR + CUresult when a tensor map is
// refused, or hopper::TILE_ERROR for a (block_q, block_k) pair that is
// not compiled.
extern "C" int flash_dkv(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta,
                         void* dk, void* dv, int B, int H, int KV, int S,
                         int Sk, int D, int Dv, int block_q, int block_k,
                         float scale, int causal, int window, void* stream) {
  if (Dv != D) return int(cudaErrorInvalidValue);
  if (D == 128) {
    return dkv::dispatch<128>(block_q, block_k, q, k, v, dout, lse, delta, dk,
                              dv, B, H, KV, S, Sk, scale, causal, window, stream);
  }
  if (D == 64) {
    return dkv::dispatch<64>(block_q, block_k, q, k, v, dout, lse, delta, dk,
                             dv, B, H, KV, S, Sk, scale, causal, window, stream);
  }
  return int(cudaErrorInvalidValue);
}
