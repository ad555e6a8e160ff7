// Fused cyclic conv3x3 + bias + tanh + 2x2 max-pool, fp32, for Hopper (sm_90a).
//
// Replaces: dlwp_tpu/ops/fused_stages.py, fused_conv_pool (Pallas kernel
// _conv_pool_kernel). Computes
//     y = maxpool2x2(tanh(cyclic_conv2d(x, k, dilation d) + b))
// with zero latitude boundary and periodic longitude, on x (B, C, H, W),
// k (O, C, 3, 3) OIHW, b (O,), y (B, O, H/2, W/2); H and W even. tanh is
// monotone, so the four conv sums of a pooling window are maxed first and
// bias + tanh run once on the pooled value (as the Pallas kernel does).
//
// Bound on an H100 SXM: the flagship encoder stages do 2*B*O*H*W*C*9 flops
// on few bytes (stage 1: 4.59 GFLOP against 42.5 MB, about 108 flop/B), so
// the bound is the fp32 FMA rate (67 TFLOP/s), not memory.
//
// Design (simple, correct first; no tensor cores yet):
// - One block per (sample b, pooled row hp, 32 pooled columns, 32 output
//   channels). 128 threads: threadIdx.x is the pooled column, threadIdx.y
//   picks 8 output channels. Each thread keeps 8 x 4 window sums in
//   registers (8 channels, 4 positions of the 2x2 window).
// - Input channels are staged in chunks of 8 through shared memory: the
//   2 + 2d input rows and 64 + 2d input columns the block reads. Latitude
//   outside [0, H) loads as zero and longitude wraps as (w mod W), both in
//   the load, so nothing is padded in device memory. Columns are stored
//   split by parity so a warp's reads of columns 2*tx + s + dx*d hit
//   consecutive words (no bank conflicts).
// - Weights of the chunk sit in shared memory as [c][tap][o], so a thread
//   reads its 8 channels' weight with two 16-byte broadcast loads.
// - Dynamic shared memory is (8*(2+2d)*(64+2d) + 32*8*9) floats, 22 KB at
//   d = 2; above 48 KB (d >= 7) the launch opts in with
//   cudaFuncSetAttribute.

#include <cuda_runtime.h>

namespace {

constexpr int TX = 32;        // pooled columns per block
constexpr int TY = 4;         // thread rows per block
constexpr int OPT = 8;        // output channels per thread
constexpr int OT = TY * OPT;  // output channels per block
constexpr int CC = 8;         // input channels per shared-memory pass

__global__ void __launch_bounds__(TX * TY)
conv_pool_kernel(const float* __restrict__ x, const float* __restrict__ k,
                 const float* __restrict__ bias, float* __restrict__ y,
                 int C, int H, int W, int O, int dil) {
  extern __shared__ __align__(16) float smem[];
  const int NR = 2 + 2 * dil;   // input rows one pooled row reads
  const int TWH = TX + dil;     // columns per parity plane
  const int TW = 2 * TWH;       // input columns one block reads
  float* xs = smem;             // [CC][NR][2][TWH]
  float* ws = smem + CC * NR * TW;  // [CC][9][OT]

  const int H2 = H / 2, W2 = W / 2;
  const int n_ot = (O + OT - 1) / OT;
  const int b = blockIdx.z / n_ot;
  const int o0 = (blockIdx.z % n_ot) * OT;
  const int hp = blockIdx.y;
  const int wp0 = blockIdx.x * TX;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TX + tx;
  const int row0 = 2 * hp - dil;
  const int col0 = 2 * wp0 - dil;

  float acc[OPT][4];
#pragma unroll
  for (int j = 0; j < OPT; ++j)
#pragma unroll
    for (int p = 0; p < 4; ++p) acc[j][p] = 0.f;

  for (int c0 = 0; c0 < C; c0 += CC) {
    const int cn = min(CC, C - c0);
    __syncthreads();  // the previous chunk has been read
    for (int i = tid; i < cn * NR * TW; i += TX * TY) {
      const int cc = i / (NR * TW);
      const int r = (i / TW) % NR;
      const int col = i % TW;
      const int gr = row0 + r;
      const int gc = ((col0 + col) % W + W) % W;
      const float v =
          (gr >= 0 && gr < H)
              ? x[(((size_t)b * C + c0 + cc) * H + gr) * W + gc]
              : 0.f;
      xs[(cc * NR + r) * TW + (col & 1) * TWH + (col >> 1)] = v;
    }
    for (int i = tid; i < OT * cn * 9; i += TX * TY) {
      const int oo = i % OT;
      const int ct = i / OT;  // cc * 9 + tap
      const int o = o0 + oo;
      ws[ct * OT + oo] = o < O ? k[((size_t)o * C + c0) * 9 + ct] : 0.f;
    }
    __syncthreads();

    for (int cc = 0; cc < cn; ++cc) {
      const float* xc = xs + cc * NR * TW;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          float xv[4];
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int s = 0; s < 2; ++s) {
              const int col = s + dx * dil;
              xv[2 * r + s] = xc[(r + dy * dil) * TW + (col & 1) * TWH + tx +
                                 (col >> 1)];
            }
          const float4* wv = reinterpret_cast<const float4*>(
              ws + (cc * 9 + dy * 3 + dx) * OT + ty * OPT);
#pragma unroll
          for (int q = 0; q < OPT / 4; ++q) {
            const float4 w4 = wv[q];
            const float w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
#pragma unroll
              for (int p = 0; p < 4; ++p)
                acc[4 * q + jj][p] = fmaf(w[jj], xv[p], acc[4 * q + jj][p]);
          }
        }
      }
    }
  }

  const int wp = wp0 + tx;
  if (wp >= W2) return;
#pragma unroll
  for (int j = 0; j < OPT; ++j) {
    const int o = o0 + ty * OPT + j;
    if (o < O) {
      const float m = fmaxf(fmaxf(acc[j][0], acc[j][1]),
                            fmaxf(acc[j][2], acc[j][3]));
      y[(((size_t)b * O + o) * H2 + hp) * W2 + wp] = tanhf(m + bias[o]);
    }
  }
}

}  // namespace

extern "C" int dlwp_fused_conv_pool_smem_bytes(int dil) {
  return (int)sizeof(float) * (CC * (2 + 2 * dil) * 2 * (TX + dil) + CC * 9 * OT);
}

// Launches on `stream`; returns cudaGetLastError() after the launch (0 = ok).
extern "C" int dlwp_fused_conv_pool(const float* x, const float* k,
                                    const float* bias, float* y, int B, int C,
                                    int H, int W, int O, int dil,
                                    void* stream) {
  const int smem = dlwp_fused_conv_pool_smem_bytes(dil);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv_pool_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int n_ot = (O + OT - 1) / OT;
  const dim3 grid((W / 2 + TX - 1) / TX, H / 2, B * n_ot);
  const dim3 block(TX, TY);
  conv_pool_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(x, k, bias, y,
                                                                C, H, W, O, dil);
  return (int)cudaGetLastError();
}
