// flash_fwd: the attention forward, O = softmax(q k^T / sqrt(D)) v and
// lse = m + log(l) per row, on Hopper's wgmma with the accumulators in
// registers, fed by TMA through a ring of K/V tiles.
//
// Replaces two TPU kernels of tpumon/workload/ops/flash_attention.py:
// _fwd_kernel_resident (:199) and _fwd_kernel_streamed (:233). They split
// only because a TPU core's scoped VMEM cannot hold long K/V bands; here
// K/V tiles always stream through shared memory, so one kernel covers both.
//
// Bound on this card: the two products, 4 * B * H * pairs * D operations
// over the live (q, k) pairs. At the main path's shape (B=2, S=4096,
// H=16, KV=4, D=128, causal: 8.39 M pairs a head) that is 137.4 GFLOP,
// 0.139 ms at 989 TFLOP/s bf16, against 0.017 ms for its 56.6 MB of bytes:
// bound by operations.
//
// Head dims 64, 128 and 192 (DeepSeek-V2's q.k width, 128 + 64 rotary;
// the wrapper pads its v of 128 columns to 192 with zeros).
//
// Design (one CTA per batch, q-head and BQ-row q-block; the tile pair
// BQ x BK, 64 or 128 rows each, is a template parameter that the wrapper
// picks per call, as the reference's block_q / block_k):
// - The first BQ / 64 warpgroups are consumers, 64 q rows each (wgmma's
//   M). Each holds its S tile (64 x BK f32, BK / 2 registers a thread)
//   and its O accumulator (64 x D f32, D / 2 registers) in registers for
//   the whole k loop; the online softmax runs on the S registers (a row
//   sits in a quad of lanes: two shuffles for the max, the sum reduced
//   once at the end), and P is converted to bf16 in registers, where the
//   accumulator layout already is the A operand of the P.V product. V is
//   read transposed through the descriptor's trans-b flag: no copies.
// - The last warpgroup is the producer: one of its threads loads the q
//   tile once and keeps K and V tiles in flight through a ring of STAGES
//   stages with full/empty mbarriers (K and V on separate full barriers,
//   so S = q k^T starts while V is still arriving). At BQ = 128 ptxas
//   fits every thread in 168 registers and setmaxnreg moves the
//   producer's to the consumers; at BQ = 64 a thread may take 255 and
//   none move (hopper::Warps).
// - BQ = 64 halves the CTA and doubles the grid, for shapes whose 128-row
//   grid leaves SMs idle (few heads, short ring stripes).
// - BK = 128: S = q k^T is one m64n128 wgmma per k16 slice, and the tiles
//   of a stage (2 x 32 KB at D = 128) leave room for two stages beside the
//   32 KB q tile: 160 KB of the 227 KB at BQ = 128. A third stage would
//   fit (224 KB) but the consumers, not the copies, are the limit at two.
//   BK = 64 halves the stages and the S registers.
// - Causal: the k loop ends at the diagonal; only tiles that cross it (or
//   the Sk edge) are masked; a warpgroup skips the products of a tile
//   wholly above its rows (which exists only when BK < BQ); the heaviest
//   q-blocks launch first.
// - Window (window = W > 0, causal): key j is live for query i iff
//   i - W < j <= i. The k loop starts at the tile that holds key
//   q0 - W + 1, a warpgroup skips the products of a tile wholly below its
//   rows' windows, and only tiles that the window's edge crosses test the
//   extra term. W is a runtime argument, so no instantiation is added; at
//   W = 0 the loop bounds and the masks are the causal ones. A key below
//   the window is -inf, not NEG_BIG: a row may meet a tile wholly below
//   its window before its first live key, and exp2(-inf - NEG_BIG) is 0.
//   The window's test runs as a pass of its own over S (window_mask in
//   hopper_common.cuh), only on tiles the edge crosses: folded into the
//   causal mask's loop, it made ptxas predicate every tile's softmax
//   (1,480 -> 2,120 instructions at <128, 128, 128>, the forward 20 %
//   slower at window 0 on an H100).
// - Sinks (sink != nullptr): one more logit b_h a q-head, with no value,
//   in the softmax's normaliser: the epilogue takes m' = max(m, b_h) and
//   l' = l 2^(m - m') + 2^(b_h - m') (in the log2 domain), so O and lse
//   come out as the softmax over the keys and the sink, with no pass
//   over O of their own.
// - q, k and v are read as 4-D tensor maps (D, heads, seq, batch) in
//   boxes of 64 columns by BQ or BK rows (D = 128 is two boxes a tile); a
//   box past seq is zero-filled inside its own batch.
//
// What still holds it below half its bound: each consumer warpgroup runs
// its softmax between its two products with nothing of its own in flight
// (no intra-warpgroup overlap of the next S with this softmax, no
// ping-pong schedule between the two warpgroups), and O is stored from
// registers with 4-byte writes rather than through shared memory and TMA.
#include "hopper_common.cuh"

namespace fwd {

using namespace hopper;

constexpr int STAGES = 2;

template <int D, int BQ, int BK>
struct Smem {
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int BYTES = BAR_OFF + (1 + 3 * STAGES) * 8;
  static constexpr size_t LAUNCH = size_t(BYTES) + 1024;  // 1 KB alignment
  static_assert(Q_BYTES % 1024 == 0 && KV_BYTES % 1024 == 0, "1 KB tiles");
  static_assert(LAUNCH <= 232448, "over the 227 KB a block may use");
};

template <int D, int BQ, int BK>
__global__ void __launch_bounds__(Warps<BQ>::THREADS, 1)
    fwd_kernel(const __grid_constant__ CUtensorMap map_q,
               const __grid_constant__ CUtensorMap map_k,
               const __grid_constant__ CUtensorMap map_v,
               bf16* __restrict__ o, float* __restrict__ lse, int H, int KV,
               int S, int Sk, float scale_log2, int causal, int window,
               const float* __restrict__ sink) {
  static_assert(BK == 64 || BK == 128, "k tiles of 64 or 128 rows");
  using L = Smem<D, BQ, BK>;
  using W = Warps<BQ>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_base_1k(smem_raw);
  unsigned char* sQ = sm;
  unsigned char* sK = sm + L::K_OFF;
  unsigned char* sV = sm + L::V_OFF;
  uint64_t* full_q = reinterpret_cast<uint64_t*>(sm + L::BAR_OFF);
  uint64_t* full_k = full_q + 1;
  uint64_t* full_v = full_k + STAGES;
  uint64_t* empty = full_v + STAGES;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int kvh = (h * KV) / H;
  // Under causal the last q-blocks see the most keys: launch them first.
  const int qb = causal ? int(gridDim.y) - 1 - int(blockIdx.y) : blockIdx.y;
  const int q0 = qb * BQ;
  int n_kb = (Sk + BK - 1) / BK;
  if (causal) n_kb = min(n_kb, (q0 + BQ + BK - 1) / BK);
  // Under a window the first k tile holds key q0 - W + 1; win is W, or a
  // distance past any sequence without one.
  const int kb_lo = window > 0 ? max(q0 - window + 1, 0) / BK : 0;
  const int win = window > 0 ? window : (1 << 30);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
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
      prefetch_map(&map_k);
      prefetch_map(&map_v);
      mbar_arrive_tx(full_q, L::Q_BYTES);
      tma_load_tile<D>(sQ, BQ, &map_q, full_q, h, q0, b);
      for (int kb = kb_lo; kb < n_kb; ++kb) {
        const int it = kb - kb_lo;
        const int s = it % STAGES;
        mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        mbar_arrive_tx(&full_k[s], L::KV_BYTES);
        tma_load_tile<D>(sK + s * L::KV_BYTES, BK, &map_k, &full_k[s], kvh,
                         kb * BK, b);
        mbar_arrive_tx(&full_v[s], L::KV_BYTES);
        tma_load_tile<D>(sV + s * L::KV_BYTES, BK, &map_v, &full_v[s], kvh,
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

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
    float m[2] = {NEG_BIG, NEG_BIG};
    float l[2] = {0.0f, 0.0f};  // this thread's share of the row sums

    mbar_wait(full_q, 0);
    for (int kb = kb_lo; kb < n_kb; ++kb) {
      const int it = kb - kb_lo;
      const int s = it % STAGES;
      const uint32_t parity = (it / STAGES) & 1;
      const int k0 = kb * BK;
      const unsigned char* sKs = sK + s * L::KV_BYTES;
      const unsigned char* sVs = sV + s * L::KV_BYTES;

      if ((causal && k0 > wg_row_min + 63) || k0 + BK - 1 + win <= wg_row_min) {
        // A tile wholly above this warpgroup's rows (or wholly below
        // their windows) adds nothing. The
        // stage is released only after it was filled: an arrival before
        // would count toward the stage's previous fill.
        mbar_wait(&full_k[s], parity);
        mbar_wait(&full_v[s], parity);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
        continue;
      }

      // S = q k^T: K-major q and k, the head dim is the contraction.
      float sc[BK / 2];
      const uint64_t dq = opaque(desc_sw128(sQw, 0, 1024));
      const uint64_t dk = opaque(desc_sw128(sKs, 0, 1024));
      mbar_wait(&full_k[s], parity);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        // k16 slice kk: box kk / 4, then 32 bytes (2 units of 16) a slice.
        const int box = kk / 4, slice = (kk % 4) * 2;
        wgmma_ss<BK>(sc, dq + box * (BQ * ROW_BYTES / 16) + slice,
                     dk + box * (BK * ROW_BYTES / 16) + slice, kk > 0);
      }
      wg_commit();
      wg_wait<0>();
      fence_regs(sc);

      // Keys below the window's edge, on tiles it crosses only: a pass of
      // its own, so that the causal tiles' code is the parent design's.
      if (k0 + win <= wg_row_min + 63) window_mask<BK>(sc, k0, row0, cq, win);

      // Online softmax in the log2 domain (scale_log2 = log2(e)/sqrt(D)).
      const bool masked =
          k0 + BK > Sk || (causal && k0 + BK - 1 > wg_row_min);
      float mt[2] = {NEG_BIG, NEG_BIG};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int idx = 4 * j + i, hr = i / 2;
          float x = sc[idx] * scale_log2;
          if (masked) {
            const int col = k0 + 8 * j + cq + (i % 2);
            const int row = row0 + 8 * hr;
            if (col >= Sk || (causal && col > row)) x = NEG_BIG;
          }
          sc[idx] = x;
          mt[hr] = fmaxf(mt[hr], x);
        }
      }
      float alpha[2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const float m_new = fmaxf(m[hr], quad_max(mt[hr]));
        alpha[hr] = ex2(m[hr] - m_new);
        m[hr] = m_new;
      }
      float sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int idx = 0; idx < BK / 2; ++idx) {
        const int hr = (idx % 4) / 2;
        sc[idx] = ex2(sc[idx] - m[hr]);
        sum[hr] += sc[idx];
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) l[hr] = l[hr] * alpha[hr] + sum[hr];
#pragma unroll
      for (int idx = 0; idx < D / 2; ++idx) acc[idx] *= alpha[(idx % 4) / 2];

      // P in bf16, in registers: the A operand of O += P v.
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pa[kk][i] = pack_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);
        }
      }

      // O += P v: v is [BK, D] with D contiguous, read MN-major.
      const uint64_t dv = opaque(desc_sw128(sVs, BK * ROW_BYTES, 1024));
      mbar_wait(&full_v[s], parity);
      wg_fence();
      fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wgmma_rs<D>(acc, pa[kk], dv + kk * 16 * ROW_BYTES / 16, 1);
      }
      wg_commit();
      wg_wait<0>();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    // Epilogue: O = acc / l in q's dtype, lse = (m + log2 l) * ln 2; with
    // a sink, its logit joins m and l first.
    const int64_t q_stride = int64_t(H) * D;
    const float sink2 = sink != nullptr ? sink[h] * LOG2E : 0.0f;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = row0 + 8 * hr;
      float l_row = quad_sum(l[hr]);
      if (row >= S) continue;
      float inv = __fdividef(1.0f, l_row);
      if (sink != nullptr) {
        const float m_new = fmaxf(m[hr], sink2);
        const float keep = ex2(m[hr] - m_new);
        l_row = l_row * keep + ex2(sink2 - m_new);
        inv = __fdividef(keep, l_row);
        m[hr] = m_new;
      }
      bf16* op = o + (int64_t(b) * S + row) * q_stride + int64_t(h) * D + cq;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(op + 8 * j) =
            pack_bf16(acc[4 * j + 2 * hr] * inv, acc[4 * j + 2 * hr + 1] * inv);
      }
      if (cq == 0) {
        lse[(int64_t(b) * H + h) * S + row] = (m[hr] + __log2f(l_row)) * LN2;
      }
    }
  }
}

template <int D, int BQ, int BK>
int run(const void* q, const void* k, const void* v, void* o, void* lse,
        int B, int H, int KV, int S, int Sk, float scale, int causal,
        int window, const float* sink, void* stream) {
  CUtensorMap map_q, map_k, map_v;
  int err = make_map(&map_q, q, B, S, H, D, BQ);
  if (!err) err = make_map(&map_k, k, B, Sk, KV, D, BK);
  if (!err) err = make_map(&map_v, v, B, Sk, KV, D, BK);
  if (err) return err;
  const dim3 grid(B * H, (S + BQ - 1) / BQ);
  return launch(fwd_kernel<D, BQ, BK>, grid, Warps<BQ>::THREADS,
                Smem<D, BQ, BK>::LAUNCH, stream, map_q, map_k, map_v,
                static_cast<bf16*>(o), static_cast<float*>(lse), H, KV, S, Sk,
                scale * LOG2E, causal, window, sink);
}

// The compiled tile pairs at head dim D (ops/flash_attention.py COMPILED
// lists the same): every (BQ, BK) in {64, 128}^2 at D = 64 and 128; at
// D = 192 all but 128 x 128, whose q tile and two stages of K and V
// (48 + 4 x 48 KB) are over the 227 KB of shared memory.
template <int D>
int dispatch(int block_q, int block_k, const void* q, const void* k,
             const void* v, void* o, void* lse, int B, int H, int KV, int S,
             int Sk, float scale, int causal, int window, const float* sink,
             void* stream) {
#define FWD_TILE(BQ, BK)                                                   \
  if (block_q == BQ && block_k == BK) {                                    \
    return run<D, BQ, BK>(q, k, v, o, lse, B, H, KV, S, Sk, scale, causal, \
                          window, sink, stream);                           \
  }
  FWD_TILE(64, 64)
  FWD_TILE(64, 128)
  FWD_TILE(128, 64)
  if constexpr (D <= 128) {
    FWD_TILE(128, 128)
  }
#undef FWD_TILE
  return TILE_ERROR;
}

}  // namespace fwd

// Plain C entry for ctypes: window 0 for none, sink null for none (else
// H f32 logits). Returns 0 when launched, else a cudaError_t value,
// hopper::TMAP_ERROR + CUresult when a tensor map is refused, or
// hopper::TILE_ERROR for a (block_q, block_k) pair that is not compiled.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, int B, int H, int KV, int S, int Sk, int D,
                         int block_q, int block_k, float scale, int causal,
                         int window, const void* sink, void* stream) {
  const float* sinks = static_cast<const float*>(sink);
  if (D == 128) {
    return fwd::dispatch<128>(block_q, block_k, q, k, v, o, lse, B, H, KV, S,
                              Sk, scale, causal, window, sinks, stream);
  }
  if (D == 64) {
    return fwd::dispatch<64>(block_q, block_k, q, k, v, o, lse, B, H, KV, S,
                             Sk, scale, causal, window, sinks, stream);
  }
  if (D == 192) {
    return fwd::dispatch<192>(block_q, block_k, q, k, v, o, lse, B, H, KV, S,
                              Sk, scale, causal, window, sinks, stream);
  }
  return int(cudaErrorInvalidValue);
}
