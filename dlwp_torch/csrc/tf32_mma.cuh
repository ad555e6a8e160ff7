// Device helpers shared by the tensor-core kernels (overlap_conv.cu,
// fused_conv_pool.cu): cp.async copies into shared memory (also used by
// barotropic_step.cu), the 3xTF32 operand split, the mma.sync TF32
// products and the staging of a slab's weights, sm_90a.
//
// Each .cu file includes this header and is its own shared library, so the
// helpers live in an anonymous namespace, a private copy per library.
// dlwp_torch/kernels/_build.py hashes every csrc/*.cuh into each library's
// name, so an edited header rebuilds every kernel.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int CS = 8;   // input channels per slab (the k8 depth)
constexpr int WR = 76;  // staged weight row: 72 values of one o, padded

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// v = hi + lo: hi is v rounded to TF32 (to nearest, ties away, as
// cvt.rna.tf32.f32 does), lo the exact rest, which the tensor core reads
// as TF32 by dropping its low 13 bits.
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// m16n8k4: the last slab when it holds 4 channels or fewer.
__device__ __forceinline__ void mma4(float (&d)[4], const uint32_t (&a)[4],
                                     uint32_t b0) {
  asm("mma.sync.aligned.m16n8k4.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b0));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage the weights of slab c0 (input channels c0 .. c0 + 7) of output
// channels o0 .. o0 + n_o - 1, read from k (O, C, 3, 3) as it is: ws
// [o - o0][WR], the slab's 8 channels x 9 taps of output channel o, zero
// past O and C. vec: C % 4 == 0 and k 16-byte aligned, so a row's values
// are aligned quads.
__device__ void stage_w(float* ws, const float* k, int O, int C, int o0,
                        int n_o, int c0, bool vec) {
  if (vec) {
    const int nq = min(CS, C - c0) * 9 / 4;
    for (int i = threadIdx.x; i < n_o * 18; i += blockDim.x) {
      const int ol = i / 18, q = i % 18;
      const int o = o0 + ol;
      float* dst = ws + ol * WR + 4 * q;
      if (o < O && q < nq) {
        cp_async16(dst, k + ((size_t)o * C + c0) * 9 + 4 * q);
      } else {
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  } else {
    for (int i = threadIdx.x; i < n_o * 72; i += blockDim.x) {
      const int ol = i / 72, j = i % 72;
      const int o = o0 + ol;
      float* dst = ws + ol * WR + j;
      if (o < O && c0 + j / 9 < C) {
        cp_async4(dst, k + ((size_t)o * C + c0) * 9 + j);
      } else {
        *dst = 0.f;
      }
    }
  }
}

}  // namespace
