// Hopper building blocks of flash_fwd.cu, flash_dq.cu and flash_dkv.cu:
// TMA tensor maps and loads, mbarriers, wgmma descriptors and issue,
// register moves between the wgmma accumulator and A-operand layouts, and
// setmaxnreg.
//
// Everything here is hand PTX for sm_90a; no CUTLASS/CuTe headers, so a
// kernel builds in seconds.
//
// Shared-memory tiles. Every bf16 tile of R rows by D columns is stored as
// D/64 boxes of R rows x 64 columns (128 bytes a row), box c holding
// columns [64c, 64c + 64). TMA writes each box with the 128-byte swizzle
// (the 16-byte chunk index of a row XORed with row % 8), and the wgmma
// descriptors read it with the same swizzle. A box is a multiple of 8 rows
// and every box starts on a 1024-byte boundary, so the swizzle pattern
// lines up with the address bits the hardware XORs and the descriptors'
// base offset stays 0.
//
// wgmma fragment layouts (m64nN, one warpgroup of 128 threads, thread t:
// warp w = t / 32, lane l, r = 16w + l / 4, c = l % 4):
// - f32 accumulator d[N/2]: for j in [0, N/8), d[4j], d[4j+1] are row r,
//   columns 8j + 2c and 8j + 2c + 1; d[4j+2], d[4j+3] the same columns of
//   row r + 8. A row lives in the quad of 4 lanes that share l / 4.
// - bf16 A operand in registers, k16 slice kk: a[0] = row r, columns
//   16kk + 2c, +1; a[1] = row r + 8, same columns; a[2] = row r, columns
//   16kk + 8 + 2c, +1; a[3] = row r + 8, same. So the accumulator's
//   d[8kk .. 8kk+7], packed in pairs, is exactly the A operand of slice kk:
//   a product's output feeds the next product without leaving registers.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

using bf16 = __nv_bfloat16;

#define HOPPER_DEV __device__ __forceinline__

constexpr float NEG_BIG = -1e30f;  // the finite mask value of every kernel
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int BOX_COLS = 64;       // bf16 columns of one 128-byte box row
constexpr int ROW_BYTES = 128;

// ---------------------------------------------------------------------------
// Host: tensor maps
// ---------------------------------------------------------------------------

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, fetched through the runtime so
// the library needs no -lcuda. Null if the driver does not have it.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &status) != cudaSuccess ||
        status != cudaDriverEntryPointSuccess) {
      return EncodeTiledFn(nullptr);
    }
    return reinterpret_cast<EncodeTiledFn>(ptr);
  }();
  return fn;
}

// Error code handed back to the wrapper when a tensor map cannot be
// encoded (outside the cudaError_t range the launches return).
constexpr int TMAP_ERROR = 10000;

// Error code handed back when a kernel has no instantiation for the
// requested (block_q, block_k) pair at this head dim: nothing launched.
constexpr int TILE_ERROR = 20000;

// The threads of a CTA whose tile of ROWS rows (64 or 128) is split among
// consumer warpgroups of 64 rows each (wgmma's M), with one producer
// warpgroup after them; one CTA an SM.
// - 128 rows: 384 threads, 168 registers a thread at launch (65,536 / 384
//   rounded down to 8), and ptxas allocates every path within those 168.
//   setmaxnreg then moves registers from the producer (24) to the two
//   consumers (240: 24 * 128 + 240 * 256 = 168 * 384).
// - 64 rows: 256 threads, up to 255 registers a thread, no setmaxnreg.
//   Asking for two CTAs an SM (128 a thread) made ptxas fit the consumer
//   in 128 and spill, whatever setmaxnreg budget followed: ptxas sizes
//   every path by the launch count, not by setmaxnreg.
template <int ROWS>
struct Warps {
  static_assert(ROWS == 64 || ROWS == 128, "tiles of 64 or 128 rows");
  static constexpr int CONSUMERS = ROWS / 64;  // consumer warpgroups
  static constexpr int PRODUCER = CONSUMERS;   // the producer's warpgroup
  static constexpr int THREADS = 128 * (CONSUMERS + 1);
  static constexpr int CONSUMER_WARPS = 4 * CONSUMERS;
  static constexpr bool MOVE_REGS = CONSUMERS == 2;
  static constexpr int PRODUCER_REGS = 24;
  static constexpr int CONSUMER_REGS = 240;
  static_assert(!MOVE_REGS || (PRODUCER_REGS + CONSUMERS * CONSUMER_REGS) *
                                      128 <=
                                  65536 / THREADS / 8 * 8 * THREADS,
                "setmaxnreg budgets over the CTA's launch registers");
};

// A map of a contiguous bf16 [batch, seq, heads, D] array as the 4-D
// tensor (D, heads, seq, batch), innermost first, read in boxes of 64
// columns x box_rows rows of one head and one batch. A box that runs past
// seq is zero-filled inside its own batch: the ragged edge costs no mask
// on the load side. 128-byte swizzle, matching the wgmma descriptors.
inline int make_map(CUtensorMap* map, const void* base, int batch, int seq,
                    int heads, int D, int box_rows) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return TMAP_ERROR;
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(heads),
                              cuuint64_t(seq), cuuint64_t(batch)};
  const cuuint64_t strides[3] = {cuuint64_t(D) * 2,
                                 cuuint64_t(heads) * D * 2,
                                 cuuint64_t(seq) * heads * D * 2};
  const cuuint32_t box[4] = {cuuint32_t(BOX_COLS), 1, cuuint32_t(box_rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : TMAP_ERROR + int(res);
}

// Raise the dynamic shared-memory limit, launch, and hand back the launch
// status (a refused launch never runs, and a later synchronize would not
// report it).
template <typename Kernel, typename... Args>
inline int launch(Kernel kernel, dim3 grid, int threads, size_t smem,
                  void* stream, const Args&... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return int(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Device: shared memory, mbarriers, TMA
// ---------------------------------------------------------------------------

HOPPER_DEV uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The dynamic shared memory rounded up to 1024 bytes (the launch asks for
// 1024 bytes more than the carve-up needs).
HOPPER_DEV unsigned char* smem_base_1k(unsigned char* raw) {
  const uint32_t a = smem_u32(raw);
  return raw + (((a + 1023u) & ~1023u) - a);
}

HOPPER_DEV void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Make the initialised barriers visible to the async proxy (TMA) and to
// every thread; followed by the block's one __syncthreads.
HOPPER_DEV void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

HOPPER_DEV void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// One arrival that also announces `bytes` of TMA traffic to this phase.
HOPPER_DEV void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

HOPPER_DEV bool mbar_try(uint32_t addr, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done != 0;
}

// A wait that lasts this many SM cycles (about 17 s) means the pipeline is
// wedged: the kernel traps, so the launch fails with an error instead of
// holding the card forever.
constexpr long long WAIT_LIMIT_CYCLES = 1ll << 35;

// Block until the phase of parity `parity` has completed.
HOPPER_DEV void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_try(addr, parity)) return;
  const long long start = clock64();
  while (!mbar_try(addr, parity)) {
    if (clock64() - start > WAIT_LIMIT_CYCLES) __trap();
  }
}

// One TMA box (c0 = column, c1 = head, c2 = row, c3 = batch) into shared
// memory; its bytes complete on `bar`.
HOPPER_DEV void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Every box of a [rows, D] tile at row `row` of (head, batch): D / 64 boxes
// of rows x 128 bytes, one after the other.
template <int D>
HOPPER_DEV void tma_load_tile(unsigned char* dst, int rows,
                              const CUtensorMap* map, uint64_t* bar, int head,
                              int row, int batch) {
#pragma unroll
  for (int c = 0; c < D / BOX_COLS; ++c) {
    tma_load(dst + c * rows * ROW_BYTES, map, bar, c * BOX_COLS, head, row,
             batch);
  }
}

HOPPER_DEV void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map))
               : "memory");
}

// ---------------------------------------------------------------------------
// Device: registers
// ---------------------------------------------------------------------------

template <int R>
HOPPER_DEV void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
HOPPER_DEV void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// The producer's and the consumers' setmaxnreg, where Warps moves any.
template <class W>
HOPPER_DEV void producer_regs() {
  if constexpr (W::MOVE_REGS) reg_dealloc<W::PRODUCER_REGS>();
}

template <class W>
HOPPER_DEV void consumer_regs() {
  if constexpr (W::MOVE_REGS) reg_alloc<W::CONSUMER_REGS>();
}

// Two f32 into one register of bf16 pairs, the first in the low half.
HOPPER_DEV uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x in one MUFU op (flushes denormals to zero; the masked -1e30 gives 0).
HOPPER_DEV float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The sliding window's mask on one S tile of a consumer thread (flash_fwd,
// flash_dq): sc holds BK / 2 scores of rows row0 and row0 + 8 at keys k0 +
// 8 j + cq (+ 1), in the accumulator order of a m64nBK wgmma; a key j is
// below row i's window when j + win <= i, and its score becomes -inf.
template <int BK>
HOPPER_DEV void window_mask(float* sc, int k0, int row0, int cq, int win) {
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = k0 + 8 * j + cq + (i % 2);
      if (col + win <= row0 + 8 * (i / 2)) {
        sc[4 * j + i] = __int_as_float(0xff800000);
      }
    }
  }
}

// The max and the sum over the quad of lanes that holds one row.
HOPPER_DEV float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

HOPPER_DEV float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Keep the compiler from moving reads or writes of accumulator registers
// across wgmma issue and wait (the asm below does not tell it when the
// asynchronous product really reads or writes them).
template <int N>
HOPPER_DEV void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// ---------------------------------------------------------------------------
// Device: wgmma
// ---------------------------------------------------------------------------

// Shared-memory matrix descriptor for a 128-byte-swizzled operand.
// K-major (the contraction dim contiguous): sbo = 1024 bytes between 8-row
// groups; lbo unused. MN-major (the output dim contiguous, the transposed
// read of a row-major tile): lbo = bytes between 64-column boxes, sbo =
// 1024 bytes between groups of 8 contraction rows.
HOPPER_DEV uint64_t desc_sw128(const void* p, uint32_t lbo_bytes,
                               uint32_t sbo_bytes) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFFull) >> 4) | (uint64_t((lbo_bytes >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo_bytes >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// The same descriptor, opaque to the compiler. A k-slice's descriptor is
// the tile's plus a constant; without this the compiler hoists every
// slice's descriptor out of the k loop and holds them all in registers
// beside the accumulators, and spills.
HOPPER_DEV uint64_t opaque(uint64_t desc) {
  asm volatile("" : "+l"(desc));
  return desc;
}

HOPPER_DEV void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

HOPPER_DEV void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int PENDING>
HOPPER_DEV void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING) : "memory");
}

// d[64, N] (=|+=) A[64, 16] . B[16, N], both operands in shared memory and
// K-major (no transposes). scale_d = 0 overwrites d, 1 accumulates.
template <int N>
HOPPER_DEV void wgmma_ss(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b,
                         int scale_d) {
  static_assert(N == 32 || N == 64 || N == 128, "instantiated for N = 32, 64, 128");
  if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
  if constexpr (N == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
}

// d[64, N] (=|+=) A[64, 16] . B[16, N], A in registers (bf16 pairs in the
// layout above), B in shared memory MN-major (a row-major [K, N] tile read
// transposed: the trans-b flag, no copy).
template <int N>
HOPPER_DEV void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                         uint64_t desc_b, int scale_d) {
  static_assert(N == 64 || N == 128 || N == 192,
                "instantiated for N = 64, 128 and 192");
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "r"(scale_d));
  }
  if constexpr (N == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "r"(scale_d));
  }
  if constexpr (N == 192) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
        "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "r"(scale_d));
  }
}

}  // namespace hopper
