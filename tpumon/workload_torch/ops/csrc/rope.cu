// rope: the rotary embedding of q and k in one launch. Split halves (x1 the
// first D/2 channels of a head, x2 the last), each pair turned by the
// angle of its token's position:
//   y1 = x1 * cos - x2 * sin,   y2 = x1 * sin + x2 * cos.
// With sin negated the same pass is the gradient of that rotation
// (dx1 = dy1 * cos + dy2 * sin, dx2 = dy2 * cos - dy1 * sin): IEEE negation
// is exact and a two-term sum commutes, so the backward launches this
// kernel again.
//
// Replaces no TPU kernel: tpumon/workload/ops/core.py apply_rope is plain
// jnp, which XLA fuses on the TPU. The port's plain version (ops/core.py
// rope_rotate) is an eager f32 chain of a dozen passes, and this kernel
// gives its bits: every product rounded on its own (__fmul_rn), then the
// subtract or add (__fsub_rn, __fadd_rn), never contracted into an FMA,
// then one round-to-nearest-even to the output dtype, as .to() does.
//
// Bound on this card: bytes. q and k are read once and written once: at
// the dense cells' [16, 4096, 32 + 8, 128] bf16 that is 1.342 GB, 0.40 ms
// at 3.35 TB/s; the cos/sin table ([S, D/2] f32 twice) is read once a CTA
// from L2. A few flops a byte.
//
// Design: a CTA takes TOKENS consecutive tokens (of B * S, position =
// token % S: row i of the table serves position i of the tensor given).
// It first stages those tokens' cos and sin rows in shared memory (sin
// negated for the backward) and each token's row offset into q and k
// (batch, token and head strides in elements, so strided views such as
// DeepSeek's q_pe and k_pe need no copy). Then each thread takes units of
// (token, head of q or k, vector j of the half): one 16-byte load of x1's
// vector j and one of x2's, the matching table values from shared memory,
// and one 16-byte store of each output half into the contiguous
// [B, S, H, D] result. Neighbouring threads take neighbouring vectors of a
// head, so a warp reads and writes whole 32-byte sectors.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rotary {

// The C entry's code for a width the kernel does not take: nothing launched.
constexpr int WIDTH_ERROR = 20001;

// Head widths: multiples of 16 up to 256 (ops/core.py ROPE_MAX_WIDTH), so a
// half-row is whole 16-byte vectors in bf16 and in f32.
constexpr int MAX_WIDTH = 256;
constexpr int TOKENS = 16;   // tokens a CTA
constexpr int THREADS = 256;

// 16 bytes of x: N elements, unpacked to f32 and stored rounded to T.
template <typename T>
struct Vec;

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[N]) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[N]) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
};

template <>
struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* p, float (&v)[N]) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[N]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

// One of q and k: its input, its contiguous output and the input's strides
// in elements (the last dimension is contiguous).
struct Operand {
  const void* x;
  void* out;
  int heads;
  int64_t batch_stride, token_stride, head_stride;
};

// The table's N values from vector j of a staged row (float4s).
template <int N>
__device__ __forceinline__ void table(const float4* row, int j, float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float4 f = row[j * (N / 4) + i];
    v[4 * i] = f.x; v[4 * i + 1] = f.y; v[4 * i + 2] = f.z; v[4 * i + 3] = f.w;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    rotate(Operand q, Operand k, const float* __restrict__ cos_t,
           const float* __restrict__ sin_t, int tokens, int S, int D, int negate) {
  using V = Vec<T>;
  constexpr int N = V::N;
  __shared__ float4 cs[TOKENS * MAX_WIDTH / 8];  // D / 8 float4 a token
  __shared__ float4 sn[TOKENS * MAX_WIDTH / 8];
  __shared__ int64_t offset[2][TOKENS];          // q's and k's row offsets
  const int half = D / 2, quads = half / 4;
  const int64_t t0 = int64_t(blockIdx.x) * TOKENS;
  const int64_t left = int64_t(tokens) - t0;
  const int n = left < TOKENS ? int(left) : TOKENS;  // tokens of this CTA

  for (int i = threadIdx.x; i < n * quads; i += THREADS) {
    const int tok = i / quads, c = i - tok * quads;
    const int64_t row = (t0 + tok) % S;
    const float4 cv = __ldg(reinterpret_cast<const float4*>(cos_t + row * half) + c);
    float4 sv = __ldg(reinterpret_cast<const float4*>(sin_t + row * half) + c);
    if (negate) sv = make_float4(-sv.x, -sv.y, -sv.z, -sv.w);
    cs[i] = cv;
    sn[i] = sv;
  }
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const int64_t b = (t0 + i) / S, s = (t0 + i) - b * S;
    offset[0][i] = b * q.batch_stride + s * q.token_stride;
    offset[1][i] = b * k.batch_stride + s * k.token_stride;
  }
  __syncthreads();

  const int nv = half / N;  // vectors a half-row
  const int heads = q.heads + k.heads;
  const int units = n * heads * nv;
  for (int u = threadIdx.x; u < units; u += THREADS) {
    const int j = u % nv, r = u / nv, h = r % heads, tok = r / heads;
    const bool is_q = h < q.heads;
    const int head = is_q ? h : h - q.heads;
    const T* src = static_cast<const T*>(is_q ? q.x : k.x) + offset[is_q ? 0 : 1][tok]
                   + head * (is_q ? q.head_stride : k.head_stride) + j * N;
    T* dst = static_cast<T*>(is_q ? q.out : k.out)
             + ((t0 + tok) * (is_q ? q.heads : k.heads) + head) * D + j * N;
    float x1[N], x2[N], c[N], s[N], y1[N], y2[N];
    V::load(src, x1);
    V::load(src + half, x2);
    table<N>(cs + tok * quads, j, c);
    table<N>(sn + tok * quads, j, s);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      y1[i] = __fsub_rn(__fmul_rn(x1[i], c[i]), __fmul_rn(x2[i], s[i]));
      y2[i] = __fadd_rn(__fmul_rn(x1[i], s[i]), __fmul_rn(x2[i], c[i]));
    }
    V::store(dst, y1);
    V::store(dst + half, y2);
  }
}

template <typename T>
int run(Operand q, Operand k, const float* cos_t, const float* sin_t, int B,
        int S, int D, int negate, void* stream) {
  if (D < 16 || D % 16 != 0 || D > MAX_WIDTH) return WIDTH_ERROR;
  const int64_t tokens = int64_t(B) * S;
  if (tokens <= 0) return 0;
  const int64_t grid = (tokens + TOKENS - 1) / TOKENS;
  rotate<T><<<unsigned(grid), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      q, k, cos_t, sin_t, int(tokens), S, D, negate);
  return int(cudaGetLastError());
}

}  // namespace rotary

// Plain C entry for ctypes: q [B, S, Hq, D] and k [B, S, Hk, D] in bf16
// (is_f32 = 0) or f32 (is_f32 = 1), each with its batch, token and head
// strides in elements, the last dimension contiguous, every row 16-byte
// aligned; q_out and k_out contiguous of the same shapes; cos_t and sin_t
// [>= S, D / 2] f32, contiguous. negate = 1 turns by -sin (the backward).
// Returns 0 when launched (or B * S == 0), else a cudaError_t value, or
// rotary::WIDTH_ERROR for a width the kernel does not take.
extern "C" int rope(const void* q, const void* k, void* q_out, void* k_out,
                    const void* cos_t, const void* sin_t, int B, int S, int Hq,
                    int Hk, int D, int64_t q_bs, int64_t q_ts, int64_t q_hs,
                    int64_t k_bs, int64_t k_ts, int64_t k_hs, int is_f32,
                    int negate, void* stream) {
  const rotary::Operand qo{q, q_out, Hq, q_bs, q_ts, q_hs};
  const rotary::Operand ko{k, k_out, Hk, k_bs, k_ts, k_hs};
  const float* c = static_cast<const float*>(cos_t);
  const float* s = static_cast<const float*>(sin_t);
  if (is_f32) return rotary::run<float>(qo, ko, c, s, B, S, D, negate, stream);
  return rotary::run<__nv_bfloat16>(qo, ko, c, s, B, S, D, negate, stream);
}
