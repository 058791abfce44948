// ell_gram.cu — (G, v) = (tril(Y·Yᵀ, −1), Y·x) straight from the ELL rows of
// an s-bundle Y (sb rows, w padded entries a row, n columns), for sm_90a.
//
// Replaces: src/repro/kernels/ell_gram.py, `_ell_gram_kernel` (entry
// `ell_gram_and_v`). That kernel walks ⌈n/bk⌉ column panels on a sequential
// grid, expands each panel to a dense on-chip tile by comparing against an
// iota (its target has no in-kernel scatter), accumulates G across grid
// steps and masks after the last. None of that is carried over: the contract
// is the (G, v) pair.
//
// Design: direct sparse. For i > j
//     G[i, j] = Σ_{a, a'} [idx_i[a] == idx_j[a']] · val_i[a] · val_j[a'],
// which is exactly Σ_c P[i, c]·P[j, c] with duplicate column ids summed into
// the dense rows P. Duplicates therefore need no special case, and neither
// do pads: a pad is (idx 0, val 0) and adds 0 even where it meets a real
// column 0. The work is sb²/2 · w² compare-and-FMA and does not depend on n
// (47,236 to 3,231,961 on the paper's datasets), where a dense panel in
// shared memory would do sb²/2 · n FMA and re-scatter each panel. The direct
// form is chosen because w² < n on every registered dataset; a panel design
// wins once w² ≫ n (dense rows).
//
// What bounds it on this card: the function itself is bound by bytes — the
// inputs are sb·w·8 bytes (114 KB at sb = 128, w = 111), G is sb²·4 bytes,
// and the multiply-adds that (G, v) needs are only those of matching column
// ids, far fewer. This design is nowhere near that bound: what limits it is
// its own integer compares, ~10⁸ at that shape, almost all of which fail (two
// sparse rows share few columns). A merge of rows sorted by column id would
// do O(w) a pair instead of O(w²). So the design keeps the inner loop on
// registers and shared memory and makes the failing compare cheap:
//   * a block owns an 8 × 8 tile of G and every element of G is written by
//     exactly one thread, so there are no atomics on G, no cross-block
//     reduction, no zero-fill pass, and the sums are taken in the same order
//     on every run;
//   * the block stages its 8 i-rows and 8 j-rows in shared memory, entry
//     major ([a][row]) so that the 8 rows a warp reads side by side fall in
//     8 different banks; w is walked in chunks so any width fits. An entry
//     whose value is 0 (every pad) is staged with a column id that matches
//     nothing (−1 on the i side, −2 on the j side): it could only add 0;
//   * a thread keeps R = 8 entries of row i in registers and streams row j's
//     column ids past them: one shared load and 8 integer compares, OR-ed
//     into one predicate. Only when one of them matches (rare) are the
//     value loaded and the FMAs done;
//   * KS = 4 threads share one (i, j) pair, each taking every fourth
//     register chunk of row i, so that a block has 8 warps to hide the
//     shared-memory latency behind; their 4 partial sums are added in a
//     fixed order through shared memory;
//   * tiles strictly above the diagonal only write their zeros; diagonal
//     tiles also compute v for their 8 rows (a gather of x, one warp per
//     row, shuffle-reduced), so v costs no second launch.
// fp32 FMA throughout: no tensor cores, no TF32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int T = 8;        // tile edge: T×T pairs a block
constexpr int KS = 4;       // threads sharing one pair
constexpr int WC = 128;     // entries of a row staged per chunk
constexpr int R = 8;        // row-i entries held in registers
constexpr int PAIRS = T * T;
constexpr int THREADS = PAIRS * KS;

__global__ void __launch_bounds__(THREADS)
ell_gram_kernel(const int* __restrict__ idx, const float* __restrict__ val,
                const float* __restrict__ x, float* __restrict__ G,
                float* __restrict__ v, int sb, int w) {
  __shared__ int si_idx[WC * T];
  __shared__ float si_val[WC * T];
  __shared__ int sj_idx[WC * T];
  __shared__ float sj_val[WC * T];
  __shared__ float partial[KS][PAIRS];

  const int tid = threadIdx.x;
  const int slice = tid / PAIRS;
  const int pair = tid % PAIRS;
  const int tj = pair % T;
  const int ti = pair / T;
  const int i0 = blockIdx.y * T;
  const int j0 = blockIdx.x * T;
  const int i = i0 + ti;
  const int j = j0 + tj;
  const bool in_range = (i < sb) && (j < sb);

  // A tile with no pair i > j: its last row is not below its first column.
  if (i0 + T - 1 <= j0) {
    if (slice == 0 && in_range) G[(size_t)i * sb + j] = 0.0f;
    return;
  }

  float acc = 0.0f;

  for (int ci = 0; ci < w; ci += WC) {
    const int ni = min(WC, w - ci);
    const int ni_pad = (ni + R - 1) / R * R;
    __syncthreads();  // the previous chunk's readers are done
    for (int e = tid; e < ni_pad * T; e += THREADS) {
      const int a = e / T, r = e % T;
      const int row = i0 + r;
      const size_t g = (size_t)row * w + ci + a;
      const float value = ((a < ni) && (row < sb)) ? val[g] : 0.0f;
      si_idx[e] = (value != 0.0f) ? idx[g] : -1;
      si_val[e] = value;
    }
    for (int cj = 0; cj < w; cj += WC) {
      const int nj = min(WC, w - cj);
      __syncthreads();
      for (int e = tid; e < nj * T; e += THREADS) {
        const int a = e / T, r = e % T;
        const int row = j0 + r;
        const size_t g = (size_t)row * w + cj + a;
        const float value = (row < sb) ? val[g] : 0.0f;
        sj_idx[e] = (value != 0.0f) ? idx[g] : -2;
        sj_val[e] = value;
      }
      __syncthreads();

      for (int a0 = slice * R; a0 < ni_pad; a0 += KS * R) {
        int ri[R];
#pragma unroll
        for (int r = 0; r < R; ++r) ri[r] = si_idx[(a0 + r) * T + ti];
#pragma unroll 4
        for (int ap = 0; ap < nj; ++ap) {
          const int cjx = sj_idx[ap * T + tj];
          bool any = false;
#pragma unroll
          for (int r = 0; r < R; ++r) any |= (ri[r] == cjx);
          if (any) {
            const float vj = sj_val[ap * T + tj];
#pragma unroll
            for (int r = 0; r < R; ++r)
              if (ri[r] == cjx) acc = fmaf(si_val[(a0 + r) * T + ti], vj, acc);
          }
        }
      }
    }
  }

  partial[slice][pair] = acc;
  __syncthreads();
  if (slice == 0 && in_range) {
    float sum = partial[0][pair];
#pragma unroll
    for (int k = 1; k < KS; ++k) sum += partial[k][pair];
    G[(size_t)i * sb + j] = (i > j) ? sum : 0.0f;
  }

  // v for the rows of a diagonal tile: one warp a row
  if (i0 == j0) {
    const int lane = tid % 32;
    const int warp = tid / 32;
    for (int r = warp; r < T; r += THREADS / 32) {
      const int row = i0 + r;
      if (row >= sb) break;
      const size_t base = (size_t)row * w;
      float part = 0.0f;
      for (int a = lane; a < w; a += 32) part = fmaf(val[base + a], x[idx[base + a]], part);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) part += __shfl_down_sync(0xffffffffu, part, off);
      if (lane == 0) v[row] = part;
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() as an int (0 = launched).
// idx (sb, w) int32 row-major, val (sb, w) float32, x (n,) float32 with every
// idx in [0, n); G (sb, sb) and v (sb,) are written in full.
extern "C" int ell_gram_launch(const void* idx, const void* val, const void* x,
                               void* G, void* v, int sb, int w, void* stream) {
  const int tiles = (sb + T - 1) / T;
  dim3 grid(tiles, tiles);
  ell_gram_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), static_cast<const float*>(val),
      static_cast<const float*>(x), static_cast<float*>(G), static_cast<float*>(v), sb, w);
  return static_cast<int>(cudaGetLastError());
}
