// sstep_inner.cu — the s sequential corrections of one s-step bundle
// (paper Algorithm 3, lines 9–14) in a single launch, for sm_90a:
//
//     for j = 0 .. s−1, in order:
//         z_j = v[jb:(j+1)b] + (η/b) · G[jb:(j+1)b, :] · u
//         u[jb:(j+1)b] = 1 / (1 + e^{z_j})          (logistic residual)
//
// with G (sb × sb, sb = s·b) strictly lower triangular and u starting at 0.
//
// Replaces: src/repro/kernels/sstep_inner.py, `_inner_kernel` (entry
// `sstep_inner`). That kernel keeps all of G, v and u in on-chip memory for
// the whole loop. A thread block here has 227 KB of shared memory and G is
// 1 MiB at sb = 512, so G cannot be resident; only u is.
//
// What bounds it on this card: neither bytes nor operations but the chain of
// s dependent steps. The bytes are the strict lower block-triangle of G read
// once (at most sb²·4/2 = 512 KiB at sb = 512, 32 KiB at sb = 128 — G was
// just written by the Gram kernel and sits in the 50 MB L2) and each step
// cannot start before the one before it has written its block of u. Each
// step costs one L2 round trip plus a block barrier, so the floor is about
// s such latencies on top of the launch itself.
//
// Design: one thread block (the loop is sequential by construction), u in
// shared memory. At step j each warp takes rows of the b × (j·b) panel of G
// straight from global memory — only columns < j·b, the rest of the row
// multiplies entries of u that are still 0 — with the 32 lanes striding the
// columns (coalesced), reduces with warp shuffles, and lane 0 applies the
// residual and writes u[jb + r] to shared and global memory. One
// __syncthreads() separates the steps. s, b and η/b are runtime arguments:
// one binary serves every schedule. The residual is the two-branch,
// overflow-safe form with expf (no fast-math).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;

__device__ __forceinline__ float logistic_residual(float z) {
  // 1/(1+e^z): for z ≥ 0 as e^{−z}/(1+e^{−z}), else 1/(1+e^{z}) — no overflow.
  if (z >= 0.0f) {
    const float e = expf(-z);
    return e / (1.0f + e);
  }
  return 1.0f / (1.0f + expf(z));
}

__global__ void __launch_bounds__(THREADS)
sstep_inner_kernel(const float* __restrict__ G, const float* __restrict__ v,
                   float* __restrict__ u_out, int s, int b, float eta_over_b) {
  extern __shared__ float u[];  // sb floats
  const int sb = s * b;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int n_warps = blockDim.x / 32;

  for (int c = threadIdx.x; c < sb; c += blockDim.x) u[c] = 0.0f;
  __syncthreads();

  for (int j = 0; j < s; ++j) {
    const int cols = j * b;  // u is filled exactly up to here
    for (int r = warp; r < b; r += n_warps) {
      const int row = cols + r;
      const float* __restrict__ g_row = G + (size_t)row * sb;
      float part = 0.0f;
      for (int c = lane; c < cols; c += 32) part = fmaf(g_row[c], u[c], part);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) part += __shfl_down_sync(0xffffffffu, part, off);
      if (lane == 0) {
        const float z = fmaf(eta_over_b, part, v[row]);
        const float uj = logistic_residual(z);
        u[row] = uj;
        u_out[row] = uj;
      }
    }
    __syncthreads();
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() as an int (0 = launched).
// G (sb, sb) float32 row-major, strictly lower; v (sb,) float32; u (sb,) is
// written in full. sb·4 bytes of dynamic shared memory (the wrapper bounds sb).
extern "C" int sstep_inner_launch(const void* G, const void* v, void* u, int s, int b,
                                  float eta_over_b, void* stream) {
  const size_t smem = (size_t)s * b * sizeof(float);
  sstep_inner_kernel<<<1, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(G), static_cast<const float*>(v), static_cast<float*>(u), s, b,
      eta_over_b);
  return static_cast<int>(cudaGetLastError());
}
