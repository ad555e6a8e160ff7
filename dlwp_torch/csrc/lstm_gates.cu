// ConvLSTM gate chain in one elementwise pass, for Hopper (sm_90a).
//
// Replaces: dlwp_tpu/ops/lstm_gates.py, fused_lstm_gates (Pallas kernel
// _gates_kernel; plain reference lstm_gates_reference). With the bias
// already folded into zx:
//     z = zx + zh;  i, f, g, o = split(z, 4) along channels
//     c' = r(f) * c + r(i) * a(g);   h' = r(o) * a(c')
// zx, zh are (B, 4F, H, W) and c, h', c' are (B, F, H, W), all fp32. Gate k
// of element (b, f, h, w) sits at b*4F*HW + (k*F + f)*HW + hw.
//
// Bound on an H100 SXM: pure data movement. Each element reads zx and zh
// four times over (one per gate) and c once, and writes h' and c' once:
// 7 floats per element, 175 MB at the flagship shape (B=64, F=12, 36x144),
// about 0.052 ms at 3.35 TB/s. The arithmetic (a few transcendentals per
// element) is far below the fp32 rate.
//
// Design: one thread per (b, f, hw) element in a grid-stride loop; every
// input is read once and every output written once, coalesced along hw.
// The activations are a runtime enum (linear, tanh, sigmoid, Keras
// hard_sigmoid = clip(0.2x + 0.5, 0, 1)). The fp32 path uses __fmul_rn /
// __fadd_rn so no multiply-add is contracted and the rounding matches the
// plain PyTorch version op for op. With bf16 gates (use_bf16 = 1) it follows
// the rounding points of lstm_gates_reference: z rounds to bf16, every op
// rounds to bf16, and c', h' are stored back as fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

enum Act { LINEAR = 0, TANH = 1, SIGMOID = 2, HARD_SIGMOID = 3 };

__device__ __forceinline__ float bf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// fp32 activation; with `round` every intermediate rounds to bf16 the way
// PyTorch's bf16 ops do (one rounding per op, math in fp32).
__device__ __forceinline__ float act(float x, int kind, bool round) {
  switch (kind) {
    case TANH:
      return round ? bf(tanhf(x)) : tanhf(x);
    case SIGMOID: {
      const float s = 1.f / (1.f + expf(-x));
      return round ? bf(s) : s;
    }
    case HARD_SIGMOID: {
      float t = __fmul_rn(0.2f, x);
      if (round) t = bf(t);
      t = __fadd_rn(t, 0.5f);
      if (round) t = bf(t);
      return fminf(fmaxf(t, 0.f), 1.f);
    }
    default:
      return x;
  }
}

__global__ void lstm_gates_kernel(const float* __restrict__ zx,
                                  const float* __restrict__ zh,
                                  const float* __restrict__ c,
                                  float* __restrict__ h_out,
                                  float* __restrict__ c_out, long long n,
                                  long long fhw, int a_kind, int r_kind,
                                  int use_bf16) {
  const bool rb = use_bf16 != 0;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < n; idx += (long long)gridDim.x * blockDim.x) {
    const long long b = idx / fhw;
    const long long base = idx + 3 * b * fhw;  // b*4*fhw + (idx - b*fhw)
    float zi = zx[base] + zh[base];
    float zf = zx[base + fhw] + zh[base + fhw];
    float zg = zx[base + 2 * fhw] + zh[base + 2 * fhw];
    float zo = zx[base + 3 * fhw] + zh[base + 3 * fhw];
    float cv = c[idx];
    if (rb) {
      zi = bf(zi);
      zf = bf(zf);
      zg = bf(zg);
      zo = bf(zo);
      cv = bf(cv);
    }
    float kept = __fmul_rn(act(zf, r_kind, rb), cv);
    float added = __fmul_rn(act(zi, r_kind, rb), act(zg, a_kind, rb));
    if (rb) {
      kept = bf(kept);
      added = bf(added);
    }
    float c_new = __fadd_rn(kept, added);
    if (rb) c_new = bf(c_new);
    float h_new = __fmul_rn(act(zo, r_kind, rb), act(c_new, a_kind, rb));
    if (rb) h_new = bf(h_new);
    h_out[idx] = h_new;
    c_out[idx] = c_new;
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() after the launch (0 = ok).
extern "C" int dlwp_lstm_gates(const float* zx, const float* zh,
                               const float* c, float* h_out, float* c_out,
                               long long n, long long fhw, int a_kind,
                               int r_kind, int use_bf16, void* stream) {
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  if (blocks < 1) blocks = 1;
  lstm_gates_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      zx, zh, c, h_out, c_out, n, fhw, a_kind, r_kind, use_bf16);
  return (int)cudaGetLastError();
}
