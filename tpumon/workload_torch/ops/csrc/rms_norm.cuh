// What rms_norm_fwd.cu and rms_norm_bwd.cu share: the row layouts they are
// compiled for, 8-element vector loads and stores, and the row sum.
//
// A row of D elements is cut into D / 8 vectors of 8 (16 bytes in bf16,
// 32 in f32). TPR threads own a row; thread t holds vectors t, t + TPR,
// t + 2 TPR, ... (VECS of them at most), so the threads of a warp touch
// neighbouring 16-byte words at every step. A vector past D / 8 is masked,
// so one layout serves every multiple of 8 up to 8 * TPR * VECS.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rmsnorm {

// The C entries' code for a width no layout takes: nothing launched.
constexpr int WIDTH_ERROR = 20001;

// The widest row a layout takes (ops/core.py MAX_WIDTH says the same).
constexpr int MAX_WIDTH = 8192;

template <int TPR_, int VECS_>
struct Layout {
  static constexpr int TPR = TPR_;    // threads a row
  static constexpr int VECS = VECS_;  // vectors of 8 a thread, at most
  static constexpr int ROWS = TPR >= 128 ? 1 : 128 / TPR;  // rows a CTA
  static constexpr int THREADS = TPR * ROWS;
  static constexpr int WARPS = TPR / 32;  // warps a row
  static constexpr int WIDTH = 8 * TPR * VECS;
  static_assert(TPR % 32 == 0, "whole warps a row");
};

// The layout of the narrowest class that holds D (D % 8 == 0, D <= 8192),
// as a call of f with a Layout value; WIDTH_ERROR for any other width.
template <typename F>
inline int with_layout(int D, F f) {
  if (D <= 0 || D % 8 != 0 || D > MAX_WIDTH) return WIDTH_ERROR;
  if (D <= 256) return f(Layout<32, 1>{});
  if (D <= 512) return f(Layout<32, 2>{});
  if (D <= 1024) return f(Layout<32, 4>{});
  if (D <= 2048) return f(Layout<64, 4>{});
  if (D <= 4096) return f(Layout<128, 4>{});
  return f(Layout<256, 4>{});
}

// Loads of 8 elements as one register word set (Raw: 16 bytes in bf16, 32
// in f32), unpacked to f32 where they are used, and stores of 8 f32 values
// rounded to T.
template <typename T>
struct Vec;

template <>
struct Vec<__nv_bfloat16> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw fetch(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  static __device__ __forceinline__ void unpack(const Raw& raw, float (&v)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&v)[8]) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
};

template <>
struct Vec<float> {
  struct Raw {
    float4 a, b;
  };
  static __device__ __forceinline__ Raw fetch(const float* p) {
    return {reinterpret_cast<const float4*>(p)[0],
            reinterpret_cast<const float4*>(p)[1]};
  }
  static __device__ __forceinline__ void unpack(const Raw& raw, float (&v)[8]) {
    v[0] = raw.a.x; v[1] = raw.a.y; v[2] = raw.a.z; v[3] = raw.a.w;
    v[4] = raw.b.x; v[5] = raw.b.y; v[6] = raw.b.z; v[7] = raw.b.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[8]) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
};

// The f32 weight: [D], read by every row, so through the read-only cache.
__device__ __forceinline__ void load_weight(const float* p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// The sum of v over the TPR threads of row r of this CTA (t: the thread's
// index in its row), returned to all of them. Every thread of the CTA
// calls it together (it may pass __syncthreads). Across warps the partial
// sums add in a fixed order, so a row sums the same way on every run.
template <class L>
__device__ __forceinline__ float row_sum(float v, float* red, int r, int t) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if constexpr (L::WARPS == 1) {
    return v;
  } else {
    float* mine = red + r * L::WARPS;
    if ((t & 31) == 0) mine[t / 32] = v;
    __syncthreads();
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < L::WARPS; ++w) s += mine[w];
    __syncthreads();  // red is free for the next call
    return s;
  }
}

}  // namespace rmsnorm
