// The cubed sphere's halo in one pass, for Hopper (sm_90a): DLWP-CS's
// CubeSpherePadding2D.
//
// New with the cube models (the JAX package has no cubed sphere). The
// input is a cube field held as its equatorial faces eq (4, R, n, n) and
// polar faces pol (2, R, n, n), R = batch x channels, the north face in
// storage order (rows reversed). The output is the padded field
// out (6, R, m, m), m = n + 2 pad: every face's interior and its four
// halo strips, each halo cell copied from the neighbouring face's cell
// that the index table names (dlwp_torch/grid/cubed_sphere.py,
// pad_table): table[f][q] names face f' and cell q' as the source of
// padded cell q of face f. The plain PyTorch version is the same gather
// (dlwp_torch/ops/padding.py, cube_pad_plain), so the two agree bit for
// bit.
//
// Bound on an H100 SXM: pure data movement, each input read about once
// and each output written once: 1.67 GB a U-Net step at B = 64 on 48 x 48
// faces, 0.50 ms at 3.35 TB/s.
//
// Design: a block per (chunk of kThreads padded cells, group of planes,
// face): blockIdx.x, .y, .z. Each thread reads its cell's table entry
// once (the source face in the top 4 bits, the cell in the face below)
// and copies that cell for kRows planes of the batch x channel axis,
// their loads issued together; writes are coalesced along the padded
// plane and reads along interior rows. No 64-bit division. The table (6
// m m ints, at most 60 KB) stays in L1/L2.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 4;
constexpr int kFaceShift = 28;

__global__ void __launch_bounds__(kThreads)
cube_pad_kernel(const float* __restrict__ eq, const float* __restrict__ pol,
                const int* __restrict__ table, float* __restrict__ out,
                int rows, int nn, int mm) {
  const int q = blockIdx.x * kThreads + threadIdx.x;
  if (q >= mm) return;
  const int f = blockIdx.z;
  const int s = __ldg(table + f * mm + q);
  const int sf = s >> kFaceShift;
  const float* src =
      (sf < 4 ? eq + static_cast<long long>(sf) * rows * nn
              : pol + static_cast<long long>(sf - 4) * rows * nn) +
      (s & ((1 << kFaceShift) - 1));
  float* dst = out + static_cast<long long>(f) * rows * mm + q;
  for (int r0 = blockIdx.y * kRows; r0 < rows; r0 += gridDim.y * kRows) {
    float v[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k)
      if (r0 + k < rows)
        v[k] = __ldg(src + static_cast<long long>(r0 + k) * nn);
#pragma unroll
    for (int k = 0; k < kRows; ++k)
      if (r0 + k < rows) dst[static_cast<long long>(r0 + k) * mm] = v[k];
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// `table` holds (source face << 28) | (row * n + column) per padded cell.
extern "C" int dlwp_cube_pad(const float* eq, const float* pol,
                             const int* table, float* out, long long rows,
                             int n, int pad, void* stream) {
  const int m = n + 2 * pad;
  long long groups = (rows + kRows - 1) / kRows;
  if (groups > 65535) groups = 65535;
  const dim3 grid(static_cast<unsigned>((m * m + kThreads - 1) / kThreads),
                  static_cast<unsigned>(groups), 6);
  cube_pad_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      eq, pol, table, out, static_cast<int>(rows), n * n, m * m);
  return static_cast<int>(cudaGetLastError());
}
