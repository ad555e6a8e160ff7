// 3x3 cyclic convolution of lat-band shards reading the neighbours' edge
// rows, fp32, for Hopper (sm_90a). Two entry points:
//
//   dlwp_overlap_conv     replaces dlwp_tpu/parallel/pallas_overlap.py,
//                         _overlap_kernel (via _overlap_local): the whole
//                         batch of a shard at once;
//   dlwp_overlap_conv_db  replaces _overlap_kernel_db (via
//                         _overlap_local_db): the same conv, each block
//                         walking the batch in `chunk`-sized pieces through
//                         a two-stage cp.async ring in shared memory.
//
// For every shard s of one card, x_s (B, C, H, W) and kernel k (O, C, 3, 3)
// (passed transposed as kt (C, 3, 3, O)), computes
//     y_s[b, o, h, w] = sum_{c, dy, dx} k[o, c, dy, dx]
//                       * x_s[b, c, h + dy - 1, (w + dx - 1) mod W]
// where row -1 is the northern neighbour's last row and row H the southern
// neighbour's first, zero where there is no neighbour: cyclic_conv2d(x, k,
// lat_mode='zero') of the global field, band by band. Every output sums in
// the same order (input channels ascending, then dy, then dx), so the two
// entry points agree bit for bit.
//
// Bound on an H100 SXM: 2 * B * O * H * W * C * 9 flops against a few bytes
// per flop's worth of data, so the fp32 FMA rate (67 TFLOP/s). At the
// flagship on a lat=2 mesh, B=64: the ConvLSTM recurrent conv (12 -> 48 at
// 36x144) is 3.44 GFLOP, 0.051 ms; tower conv 2 (32 -> 64 at 18x72) 3.06
// GFLOP, 0.046 ms; tower conv 4 (128 -> 64 at 18x72) 12.2 GFLOP, 0.18 ms.
//
// Design (simple, correct first; fp32 FMA on CUDA cores, no tensor cores):
// - The TPU kernel started remote DMAs of the edge rows, computed the
//   interior rows on the MXU while they flew, then the two edge rows; it
//   kept (H, B, C, W) blocks and a (dx, O, 3C) weight matrix with rolled
//   outputs to suit Mosaic's 128-lane tiling. None of that carries over:
//   here a block's three input rows simply come from the neighbour's
//   allocation when they fall outside the shard. The neighbours' rows exist
//   before the launch, so no block waits on another.
// - One launch covers every shard on the card: the kernel parameters hold a
//   table of per-shard input and output pointers and neighbour indices.
// - A block owns one output row h of one shard, 32 columns (threadIdx.x;
//   the ragged tile at W = 72 or 144 is masked, the longitude index wraps
//   as (w + dx - 1) mod W in the load) and 16 output channels (threadIdx.y
//   picks 4). Input channels go through shared memory in slabs of 8: the
//   three input rows of up to 16 samples, 34 columns each, and the slab's
//   weights as [c][tap][o], read as one 16-byte broadcast. Each thread
//   keeps 16 samples x 4 channels of sums in registers.
// - dlwp_overlap_conv: the batch is cut in groups of 16 samples across the
//   grid; a block stages each slab, syncs and computes.
// - dlwp_overlap_conv_db: the grid has no batch dimension; a block walks
//   the batch chunk by chunk (chunks of more than 16 samples in pieces of
//   16), slab by slab. Unit u + 1 is staged with cp.async into the other
//   half of the ring while unit u computes. A chunk past the batch end (the
//   pad of B up to a multiple of chunk) is neither read nor written.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_SHARDS = 64;
constexpr int TW = 32;        // output columns per block
constexpr int TY = 4;         // thread rows per block
constexpr int OPT = 4;        // output channels per thread
constexpr int OT = TY * OPT;  // output channels per block
constexpr int CS = 8;         // input channels per shared-memory slab
constexpr int MAXG = 16;      // samples summed together per thread
constexpr int TWP = TW + 2;   // staged input columns

struct Table {
  const float* x[MAX_SHARDS];
  float* y[MAX_SHARDS];
  int north[MAX_SHARDS];
  int south[MAX_SHARDS];
};

__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }

// Floats of one stage for `ng` samples: input rows, then weights.
__host__ __device__ constexpr int stage_floats(int ng) {
  return ng * CS * 3 * TWP + CS * 9 * OT;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The per-block view of one shard and one output row.
struct Block {
  const float* x;      // this shard
  const float* north;  // neighbours, or nullptr
  const float* south;
  float* y;
  int h, o0, w;        // output row, first channel, this thread's column
  int gcol[2];         // input column of staged columns lane and lane + 32
};

__device__ Block make_block(const Table& t, int s, int h, int W) {
  Block k;
  k.x = t.x[s];
  k.north = t.north[s] >= 0 ? t.x[t.north[s]] : nullptr;
  k.south = t.south[s] >= 0 ? t.x[t.south[s]] : nullptr;
  k.y = t.y[s];
  k.h = h;
  k.o0 = blockIdx.y * OT;
  const int w0 = blockIdx.x * TW;
  k.w = w0 + threadIdx.x;
  for (int i = 0; i < 2; ++i) {
    const int c = (w0 - 1 + (int)threadIdx.x + 32 * i) % W;
    k.gcol[i] = c < 0 ? c + W : c;
  }
  return k;
}

// Stage samples [b0, b0 + ns) and channels [c0, c0 + cn) of the three input
// rows of blk.h into xs ([g][cc][r][col], g stride CS * 3 * TWP) and the
// slab's weights into ws ([cc * 9 + tap][oo]).
template <bool ASYNC>
__device__ void stage(float* xs, float* ws, const Block& blk,
                      const float* __restrict__ kt, int b0, int ns, int c0,
                      int cn, int C, int H, int W, int O) {
  const int lane = threadIdx.x;
  const int nrows = ns * cn * 3;
  for (int q = threadIdx.y; q < nrows; q += TY) {
    const int r = q % 3;
    const int cc = (q / 3) % cn;
    const int g = q / (3 * cn);
    const int gr = blk.h - 1 + r;
    const float* base = gr < 0 ? blk.north : (gr >= H ? blk.south : blk.x);
    const int row = gr < 0 ? H - 1 : (gr >= H ? 0 : gr);
    float* dst = xs + ((g * CS + cc) * 3 + r) * TWP;
    const float* src =
        base ? base + (((size_t)(b0 + g) * C + c0 + cc) * H + row) * W
             : nullptr;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int col = lane + 32 * i;
      if (col >= TWP) break;
      if (!src) {
        dst[col] = 0.f;
      } else if (ASYNC) {
        cp_async4(dst + col, src + blk.gcol[i]);
      } else {
        dst[col] = __ldg(src + blk.gcol[i]);
      }
    }
  }
  for (int i = threadIdx.y * TW + lane; i < cn * 9 * OT; i += TW * TY) {
    const int o = blk.o0 + i % OT;
    const float* src = kt + (size_t)(c0 * 9 + i / OT) * O + o;
    if (o >= O) {
      ws[i] = 0.f;
    } else if (ASYNC) {
      cp_async4(ws + i, src);
    } else {
      ws[i] = __ldg(src);
    }
  }
}

__device__ __forceinline__ void compute(float (&acc)[MAXG][OPT],
                                        const float* xs, const float* ws,
                                        int ns, int cn) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int cc = 0; cc < cn; ++cc) {
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const float4 w4 = *reinterpret_cast<const float4*>(
            ws + (cc * 9 + dy * 3 + dx) * OT + ty * OPT);
        const float* xc = xs + (cc * 3 + dy) * TWP + tx + dx;
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          if (g < ns) {
            const float v = xc[g * CS * 3 * TWP];
            acc[g][0] = fmaf(w4.x, v, acc[g][0]);
            acc[g][1] = fmaf(w4.y, v, acc[g][1]);
            acc[g][2] = fmaf(w4.z, v, acc[g][2]);
            acc[g][3] = fmaf(w4.w, v, acc[g][3]);
          }
        }
      }
    }
  }
}

// Write samples [b0, b0 + ns) of this thread's sums and clear them.
__device__ __forceinline__ void store(float (&acc)[MAXG][OPT],
                                      const Block& blk, int b0, int ns, int H,
                                      int W, int O) {
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
#pragma unroll
    for (int j = 0; j < OPT; ++j) {
      const int o = blk.o0 + threadIdx.y * OPT + j;
      if (g < ns && o < O && blk.w < W) {
        blk.y[(((size_t)(b0 + g) * O + o) * H + blk.h) * W + blk.w] =
            acc[g][j];
      }
      acc[g][j] = 0.f;
    }
  }
}

// grid (W tiles, O tiles, shards * H * groups of MAXG samples); dynamic
// shared memory: one stage of ng = min(B, MAXG) samples.
__global__ void __launch_bounds__(TW* TY)
overlap_kernel(const Table t, const float* __restrict__ kt, int B, int C,
               int H, int W, int O, int ng) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;
  float* ws = smem + ng * CS * 3 * TWP;
  const int n_groups = (B + MAXG - 1) / MAXG;
  const int sh = blockIdx.z / n_groups;
  const int b0 = (blockIdx.z % n_groups) * MAXG;
  const int ns = min(MAXG, B - b0);
  const Block blk = make_block(t, sh / H, sh % H, W);

  float acc[MAXG][OPT];
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
#pragma unroll
    for (int j = 0; j < OPT; ++j) acc[g][j] = 0.f;

  for (int c0 = 0; c0 < C; c0 += CS) {
    const int cn = min(CS, C - c0);
    __syncthreads();  // the previous slab has been read
    stage<false>(xs, ws, blk, kt, b0, ns, c0, cn, C, H, W, O);
    __syncthreads();
    compute(acc, xs, ws, ns, cn);
  }
  store(acc, blk, b0, ns, H, W, O);
}

// grid (W tiles, O tiles, shards * H); dynamic shared memory: two stages of
// ng = min(chunk, MAXG) samples.
__global__ void __launch_bounds__(TW* TY)
overlap_db_kernel(const Table t, const float* __restrict__ kt, int B, int C,
                  int H, int W, int O, int chunk, int ng) {
  extern __shared__ __align__(16) float smem[];
  const Block blk = make_block(t, blockIdx.z / H, blockIdx.z % H, W);
  const int nchunks = (B + chunk - 1) / chunk;
  const int npiece = (chunk + ng - 1) / ng;  // pieces of a chunk
  const int nslab = (C + CS - 1) / CS;
  const int units = nchunks * npiece * nslab;

  float acc[MAXG][OPT];
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
#pragma unroll
    for (int j = 0; j < OPT; ++j) acc[g][j] = 0.f;

  // Unit u: slab u % nslab of piece (u / nslab) % npiece of chunk
  // u / (nslab * npiece). ns <= 0 marks a piece past the batch end.
  auto decode = [&](int u, int& b0, int& ns, int& c0, int& cn) {
    const int k = u % nslab;
    const int jq = u / nslab;
    const int j = jq / npiece;
    b0 = j * chunk + (jq % npiece) * ng;
    ns = min(ng, min((j + 1) * chunk, B) - b0);
    c0 = k * CS;
    cn = min(CS, C - c0);
  };
  auto prefetch = [&](int u) {
    int b0, ns, c0, cn;
    decode(u, b0, ns, c0, cn);
    float* xs = smem + (u & 1) * stage_floats(ng);
    if (ns > 0) {
      stage<true>(xs, xs + ng * CS * 3 * TWP, blk, kt, b0, ns, c0, cn, C, H,
                  W, O);
    }
    cp_async_commit();
  };

  prefetch(0);
  for (int u = 0; u < units; ++u) {
    if (u + 1 < units) {
      prefetch(u + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // unit u has landed for every thread
    int b0, ns, c0, cn;
    decode(u, b0, ns, c0, cn);
    if (ns > 0) {
      const float* xs = smem + (u & 1) * stage_floats(ng);
      compute(acc, xs, xs + ng * CS * 3 * TWP, ns, cn);
      if (c0 + cn == C) store(acc, blk, b0, ns, H, W, O);
    }
    __syncthreads();  // unit u's half of the ring may be refilled
  }
}

Table make_table(const float* const* x, float* const* y, const int* north,
                 const int* south, int n) {
  Table t;
  for (int i = 0; i < n; ++i) {
    t.x[i] = x[i];
    t.y[i] = y[i];
    t.north[i] = north[i];
    t.south[i] = south[i];
  }
  return t;
}

template <typename K>
int set_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

extern "C" int dlwp_overlap_conv_max_shards() { return MAX_SHARDS; }

extern "C" int dlwp_overlap_conv_smem_bytes(int B, int chunk) {
  if (chunk <= 0) return (int)sizeof(float) * stage_floats(imin(B, MAXG));
  return 2 * (int)sizeof(float) * stage_floats(imin(chunk, MAXG));
}

// Both launch on `stream` and return cudaGetLastError() after the launch
// (0 = ok). x, y, north, south: n per-shard entries (host arrays).
extern "C" int dlwp_overlap_conv(const float* const* x, float* const* y,
                                 const int* north, const int* south, int n,
                                 const float* kt, int B, int C, int H, int W,
                                 int O, void* stream) {
  if (n < 1 || n > MAX_SHARDS) return (int)cudaErrorInvalidValue;
  const int ng = imin(B, MAXG);
  const int smem = dlwp_overlap_conv_smem_bytes(B, 0);
  const int err = set_smem(overlap_kernel, smem);
  if (err) return err;
  const dim3 grid((W + TW - 1) / TW, (O + OT - 1) / OT,
                  n * H * ((B + MAXG - 1) / MAXG));
  overlap_kernel<<<grid, dim3(TW, TY), smem, (cudaStream_t)stream>>>(
      make_table(x, y, north, south, n), kt, B, C, H, W, O, ng);
  return (int)cudaGetLastError();
}

extern "C" int dlwp_overlap_conv_db(const float* const* x, float* const* y,
                                    const int* north, const int* south, int n,
                                    const float* kt, int B, int C, int H,
                                    int W, int O, int chunk, void* stream) {
  if (n < 1 || n > MAX_SHARDS || chunk < 1) return (int)cudaErrorInvalidValue;
  const int ng = imin(chunk, MAXG);
  const int smem = dlwp_overlap_conv_smem_bytes(B, chunk);
  const int err = set_smem(overlap_db_kernel, smem);
  if (err) return err;
  const dim3 grid((W + TW - 1) / TW, (O + OT - 1) / OT, n * H);
  overlap_db_kernel<<<grid, dim3(TW, TY), smem, (cudaStream_t)stream>>>(
      make_table(x, y, north, south, n), kt, B, C, H, W, O, chunk, ng);
  return (int)cudaGetLastError();
}
