// ell_gram_dense.cu — the dense-row route of (G, v) = (tril(Y·Yᵀ, −1), Y·x)
// for an ELL s-bundle Y (sb rows, w padded entries a row, n columns) whose
// rows cover a large share of their n columns, for sm_90a, on the tensor
// cores.
//
// Replaces: src/repro/kernels/ell_gram.py, `_ell_gram_kernel` (entry
// `ell_gram_and_v`), at the bundles that `gram_route` in ell_gram.py sends
// here: w ≥ DENSE_MIN_WIDTH, n ≤ DENSE_RATIO·w, and a densified row fits a
// block's shared memory (the crossover measured on the card, PERF.md).
// The hash probe of ell_gram.cu takes every other bundle. The TPU kernel is
// itself a dense-panel product on the matrix unit; this route is the same
// product on the rows as a whole, without its sequential grid.
//
// What bounds the function on this card: bytes, on paper. At epsilon's
// bundle (128, 2,000, 2,000) the inputs and outputs are 2.1 MB, 0.63 µs at
// the card's memory rate, and the sb²·n/2 ≈ 16 M multiply-adds G needs are
// below that even in fp32 on the CUDA cores. The hash probe spends its time
// on those multiply-adds as 16 M hashed lookups in shared memory; here they
// are a small tile product on the tensor cores, and the route is bound by
// latency: two launches and a small grid (0.023 ms on an H100, ≈ 36× the
// bytes bound, against the hash probe's 0.33 ms; PERF.md).
//
// Design, two launches on the caller's stream (the wrapper allocates one
// workspace with torch.empty; the kernels allocate nothing):
//   * Pass A, `densify_kernel`: one block a row of the workspace image
//     Y_d (sb_pad × n_pad, sb_pad = 64·⌈sb/64⌉, n_pad = 32·⌈n/32⌉). It zeroes
//     the row's image in shared memory (n_pad·4 bytes), adds the row's
//     nonzero entries with shared-memory atomics — ids in any order, a
//     repeated id merged, pads (id 0, value 0) skipped, so no layout flag —
//     writes the image out coalesced (rows ≥ sb and columns ≥ n as zeros),
//     and takes v_i = image · x in a fixed order (a strided loop, a warp
//     shuffle, the warps' sums in order). A thread issues BATCH loads before
//     it uses them: the pass is a few dependent round trips to memory.
//     Block 0 also zeroes the tickets of pass B, so a workspace from
//     torch.empty needs no fill launch.
//   * Pass B, `gram_tiles_kernel`: the 64 × 64 tiles of G on or below the
//     diagonal (3 at sb = 128, 36 at sb = 512), each split along the columns
//     into `splits` ranges of `per` 32-column chunks (`dense_geometry` picks
//     splits ≈ √(2·chunks), at most ⌈132 / tiles⌉, to fill the SMs without
//     a long sum). A block of 4 warps (2 × 2 of 32 × 32) streams its range
//     through a four-stage cp.async ring in shared memory, three chunks in
//     flight ahead of the one it multiplies (rows padded by 4 words: the
//     fragment reads hit 32 banks), and multiplies with mma.sync:
//     fp32 as split-TF32, a = a_hi + a_lo with both parts rounded to TF32
//     (cvt.rna), a·b ≈ a_lo·b_hi + a_hi·b_lo + a_hi·b_hi, which keeps about
//     fp32's precision (plain TF32, 10 bits, is not used); bf16 as
//     m16n8k16 bf16 × bf16 → fp32. With more than one split each block
//     stores its partial tile to the workspace, takes a ticket with one
//     atomic, and the last block of the tile adds the partials in split
//     order, four partials' loads in flight at a time (the sum is a chain of
//     round trips to L2), then writes G's tile (zeros on and above the
//     diagonal) and, off the diagonal, the zeros of the mirror tile. No
//     atomics on G, no zero-fill launch; every element of G is written once.
//
// Determinism. On rows whose column ids are distinct each image entry is
// one atomic add onto zero, each tile product runs in a fixed order, and
// the partials are added in split order whichever block arrives last: two
// launches give bitwise-equal G and v. Where a row repeats an id the order
// of the atomic adds that merge it varies, and so may the last bits.
//
// bf16 mode (`bf16` = 1; the reference's `compute_dtype=bfloat16`): the
// image entry is rounded to bf16 (nearest even) once, after a repeated id is
// merged, as the plain version rounds its dense panel entry; so is x in v.
// Products of two bf16 values are exact in fp32 and the sums stay fp32, so
// the mode differs from its plain versions only in the order of the fp32
// sums, repeated ids included. Each kernel is a template on the mode: one
// source, four instantiations.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int DENSIFY_THREADS = 256;
constexpr int TILE = 64;           // rows and columns of a tile of G
constexpr int KT = 32;             // columns a stage of the ring
constexpr int GRAM_THREADS = 128;  // 4 warps, 2 × 2 of 32 × 32
constexpr int STAGES = 4;          // chunks in flight in pass B's ring
constexpr int BATCH = 8;           // loads a thread of pass A issues before it uses them
constexpr int SUM_AHEAD = 4;       // partial tiles the last block loads at once

// a stage's row pitch in 32-bit words: KT columns + 4 words of padding, so
// the 8 rows × 4 columns a fragment read touches fall in 32 different banks
template <bool BF16>
__host__ __device__ constexpr int pitch_words() { return (BF16 ? KT / 2 : KT) + 4; }

template <bool BF16>
__global__ void __launch_bounds__(DENSIFY_THREADS)
densify_kernel(const int* __restrict__ idx, const float* __restrict__ val,
               const float* __restrict__ x, void* __restrict__ yd, float* __restrict__ v,
               int* __restrict__ tickets, int sb, int w, int n, int n_pad, int n_tickets) {
  extern __shared__ float image[];  // n_pad
  __shared__ float warp_sums[DENSIFY_THREADS / 32];
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  if (row == 0)
    for (int t = tid; t < n_tickets; t += DENSIFY_THREADS) tickets[t] = 0;
  for (int c = tid; c < n_pad; c += DENSIFY_THREADS) image[c] = 0.0f;
  __syncthreads();
  const bool real = row < sb;
  if (real) {  // BATCH entries' loads in flight before their adds
    const size_t base = static_cast<size_t>(row) * w;
    for (int a0 = tid; a0 < w; a0 += BATCH * DENSIFY_THREADS) {
      float value[BATCH];
      int id[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int a = a0 + u * DENSIFY_THREADS;
        value[u] = a < w ? val[base + a] : 0.0f;
        id[u] = a < w ? idx[base + a] : 0;
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u)
        if (value[u] != 0.0f) atomicAdd(&image[id[u]], value[u]);
    }
  }
  __syncthreads();
  float part = 0.0f;
  const size_t out = static_cast<size_t>(row) * n_pad;
  for (int c0 = tid; c0 < n_pad; c0 += BATCH * DENSIFY_THREADS) {
    float xc[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int c = c0 + u * DENSIFY_THREADS;
      xc[u] = real && c < n ? x[c] : 0.0f;
      if constexpr (BF16) xc[u] = __bfloat162float(__float2bfloat16_rn(xc[u]));
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int c = c0 + u * DENSIFY_THREADS;
      if (c >= n_pad) break;
      float entry = image[c];
      if constexpr (BF16) {
        const __nv_bfloat16 rounded = __float2bfloat16_rn(entry);
        static_cast<__nv_bfloat16*>(yd)[out + c] = rounded;
        entry = __bfloat162float(rounded);
      } else {
        static_cast<float*>(yd)[out + c] = entry;
      }
      part = fmaf(entry, xc[u], part);
    }
  }
  if (!real) return;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) part += __shfl_down_sync(0xffffffffu, part, off);
  if ((tid & 31) == 0) warp_sums[tid >> 5] = part;
  __syncthreads();
  if (tid == 0) {
    float sum = 0.0f;
    for (int k = 0; k < DENSIFY_THREADS / 32; ++k) sum += warp_sums[k];
    v[row] = sum;
  }
}

// rows [r0, r0 + TILE) of the image, columns [k0, k0 + KT), into a stage
// panel at pitch_words<BF16>() words a row, 16 bytes a copy (cp.async)
template <bool BF16>
__device__ __forceinline__ void load_panel(uint32_t* panel, const char* yd, int r0, int k0,
                                           int n_pad, int tid) {
  constexpr int ELEM = BF16 ? 2 : 4;
  constexpr int COPIES = KT * ELEM / 16;  // a row's 16-byte copies
  constexpr int P = pitch_words<BF16>();
  for (int e = tid; e < TILE * COPIES; e += GRAM_THREADS) {
    const int r = e / COPIES;
    const int c = e - r * COPIES;
    const size_t src = (static_cast<size_t>(r0 + r) * n_pad + k0) * ELEM + c * 16;
    __pipeline_memcpy_async(panel + r * P + c * 4, yd + src, 16);
  }
}

// f = hi + lo, both rounded to TF32 (nearest, ties away)
__device__ __forceinline__ void split_tf32(float f, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(f));
  const float rest = f - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(rest));
}

// not volatile: independent products may be interleaved by the compiler
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, const uint32_t* b) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[mi][ni] += A-rows · B-rowsᵀ over one stage: the warp's 32 × 32 block,
// 2 m16 × 4 n8 fragments; lane = 4·g + t in mma's fragment layout
template <bool BF16>
__device__ __forceinline__ void stage_product(float (&acc)[2][4][4], const uint32_t* A,
                                              const uint32_t* B, int wm, int wn, int lane) {
  constexpr int P = pitch_words<BF16>();
  const int g = lane >> 2;
  const int t = lane & 3;
  if constexpr (BF16) {
#pragma unroll
    for (int kw = 0; kw < KT / 2; kw += 8) {  // 16 columns = 8 words a step
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const uint32_t* r = A + (wm * 32 + mi * 16 + g) * P + kw + t;
        a[mi][0] = r[0];
        a[mi][1] = r[8 * P];
        a[mi][2] = r[4];
        a[mi][3] = r[8 * P + 4];
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const uint32_t* r = B + (wn * 32 + ni * 8 + g) * P + kw + t;
        b[ni][0] = r[0];
        b[ni][1] = r[4];
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni]);
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < KT; kk += 8) {
      uint32_t ahi[2][4], alo[2][4], bhi[4][2], blo[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const uint32_t* r = A + (wm * 32 + mi * 16 + g) * P + kk + t;
        split_tf32(__uint_as_float(r[0]), ahi[mi][0], alo[mi][0]);
        split_tf32(__uint_as_float(r[8 * P]), ahi[mi][1], alo[mi][1]);
        split_tf32(__uint_as_float(r[4]), ahi[mi][2], alo[mi][2]);
        split_tf32(__uint_as_float(r[8 * P + 4]), ahi[mi][3], alo[mi][3]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const uint32_t* r = B + (wn * 32 + ni * 8 + g) * P + kk + t;
        split_tf32(__uint_as_float(r[0]), bhi[ni][0], blo[ni][0]);
        split_tf32(__uint_as_float(r[4]), bhi[ni][1], blo[ni][1]);
      }
      // the small products first, each pass over the 8 accumulators, so
      // the three products into one accumulator are 8 instructions apart
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_tf32(acc[mi][ni], alo[mi], bhi[ni]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_tf32(acc[mi][ni], ahi[mi], blo[ni]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_tf32(acc[mi][ni], ahi[mi], bhi[ni]);
    }
  }
}

template <bool BF16>
__global__ void __launch_bounds__(GRAM_THREADS)
gram_tiles_kernel(const void* __restrict__ yd, float* __restrict__ G, float* __restrict__ ws,
                  int* __restrict__ tickets, int sb, int n_pad, int per) {
  constexpr int P = pitch_words<BF16>();
  constexpr int PANEL = TILE * P;  // words: a stage holds an i-panel and a j-panel
  extern __shared__ __align__(16) uint32_t ring[];  // STAGES × 2 × PANEL
  __shared__ int last_block;
  // one blockIdx.x for each tile on or below the diagonal, numbered row by row
  const int tile = blockIdx.x;
  int bi = static_cast<int>((sqrtf(8.0f * tile + 1.0f) - 1.0f) * 0.5f);
  while (bi * (bi + 1) / 2 > tile) --bi;
  while ((bi + 1) * (bi + 2) / 2 <= tile) ++bi;
  const int bj = tile - bi * (bi + 1) / 2;
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const int c0 = split * per;
  const int c1 = min(c0 + per, n_pad / KT);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 1;
  const int wn = warp & 1;
  const char* src = static_cast<const char*>(yd);

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.0f;

  // STAGES − 1 chunks in flight ahead of the one multiplied; one commit
  // group a chunk (empty past the range), so a wait counts chunks
  auto load = [&](int c) {
    uint32_t* stage = ring + ((c - c0) % STAGES) * 2 * PANEL;
    load_panel<BF16>(stage, src, bi * TILE, c * KT, n_pad, tid);
    load_panel<BF16>(stage + PANEL, src, bj * TILE, c * KT, n_pad, tid);
  };
#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) {
    if (c0 + k < c1) load(c0 + k);
    __pipeline_commit();
  }
  for (int c = c0; c < c1; ++c) {
    if (c + STAGES - 1 < c1) load(c + STAGES - 1);  // the stage read one chunk ago
    __pipeline_commit();
    __pipeline_wait_prior(STAGES - 1);
    __syncthreads();
    const uint32_t* stage = ring + ((c - c0) % STAGES) * 2 * PANEL;
    stage_product<BF16>(acc, stage, stage + PANEL, wm, wn, lane);
    __syncthreads();  // the stage is read before a later load overwrites it
  }

  if (splits > 1) {
    // the partial tile in fragment order, 32 floats a thread; the last
    // block of the tile adds all of them in split order
    float4* mine = reinterpret_cast<float4*>(ws + (static_cast<size_t>(tile) * splits + split) * TILE * TILE) + tid * 8;
#pragma unroll
    for (int f = 0; f < 8; ++f) {
      const float* a = acc[f >> 2][f & 3];
      mine[f] = make_float4(a[0], a[1], a[2], a[3]);
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) last_block = atomicAdd(&tickets[tile], 1) == splits - 1;
    __syncthreads();
    if (!last_block) return;
    __threadfence();
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.0f;
    // SUM_AHEAD partials' loads in flight at once: the sum is a chain of
    // round trips to L2, one a group, added in split order all the same
    const float4* parts = reinterpret_cast<const float4*>(ws + static_cast<size_t>(tile) * splits * TILE * TILE) + tid * 8;
    for (int s0 = 0; s0 < splits; s0 += SUM_AHEAD) {
      float4 p[SUM_AHEAD][8];
#pragma unroll
      for (int u = 0; u < SUM_AHEAD; ++u)
        if (s0 + u < splits)
#pragma unroll
          for (int f = 0; f < 8; ++f) p[u][f] = __ldcg(parts + static_cast<size_t>(s0 + u) * (TILE * TILE / 4) + f);
#pragma unroll
      for (int u = 0; u < SUM_AHEAD; ++u)
        if (s0 + u < splits)
#pragma unroll
          for (int f = 0; f < 8; ++f) {
            float* a = acc[f >> 2][f & 3];
            a[0] += p[u][f].x;
            a[1] += p[u][f].y;
            a[2] += p[u][f].z;
            a[3] += p[u][f].w;
          }
    }
  }

  // G's tile: (row, col) of fragment register q is (g + 8·(q ≥ 2), 2t + q mod 2)
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = bi * TILE + wm * 32 + mi * 16 + g + (q >> 1) * 8;
        const int j = bj * TILE + wn * 32 + ni * 8 + 2 * t + (q & 1);
        if (i < sb && j < sb) {
          G[static_cast<size_t>(i) * sb + j] = (i > j) ? acc[mi][ni][q] : 0.0f;
          if (bi != bj) G[static_cast<size_t>(j) * sb + i] = 0.0f;  // the mirror tile
        }
      }
}

template <bool BF16>
int launch(const void* idx, const void* val, const void* x, void* G, void* v, void* yd, void* ws,
           void* tickets, int sb, int w, int n, int n_pad, int tiles, int splits, int per,
           int densify_smem, cudaStream_t stream) {
  if (densify_smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        densify_kernel<BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize, densify_smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  constexpr int ring_bytes = STAGES * 2 * TILE * pitch_words<BF16>() * 4;
  if (ring_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gram_tiles_kernel<BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize, ring_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int n_tiles = tiles * (tiles + 1) / 2;
  densify_kernel<BF16><<<tiles * TILE, DENSIFY_THREADS, densify_smem, stream>>>(
      static_cast<const int*>(idx), static_cast<const float*>(val), static_cast<const float*>(x), yd,
      static_cast<float*>(v), static_cast<int*>(tickets), sb, w, n, n_pad, n_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gram_tiles_kernel<BF16><<<dim3(n_tiles, splits), GRAM_THREADS, ring_bytes, stream>>>(
      yd, static_cast<float*>(G), static_cast<float*>(ws), static_cast<int*>(tickets), sb, n_pad, per);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches both passes on `stream` and returns a cudaError_t as an int (0 =
// launched). idx (sb, w) int32 row-major, val (sb, w) float32, x (n,) float32
// with every idx in [0, n); G (sb, sb) and v (sb,) are written in full. The
// workspace — yd, the image (64·tiles × n_pad, float32, or bf16 when bf16 =
// 1), ws, the partial tiles (tiles(tiles + 1)/2 × splits × 64² float32; not
// read when splits = 1), and tickets (tiles(tiles + 1)/2 int32) — and the
// plan (n_pad, tiles = ⌈sb/64⌉, splits, per chunks of 32 columns a split,
// densify_smem = 4·n_pad bytes) are `dense_geometry`'s in ell_gram.py; this
// function trusts them.
extern "C" int ell_gram_dense_launch(const void* idx, const void* val, const void* x, void* G,
                                     void* v, void* yd, void* ws, void* tickets, int sb, int w,
                                     int n, int n_pad, int tiles, int splits, int per, int bf16,
                                     int densify_smem, void* stream) {
  auto fn = bf16 ? launch<true> : launch<false>;
  return fn(idx, val, x, G, v, yd, ws, tickets, sb, w, n, n_pad, tiles, splits, per, densify_smem,
            static_cast<cudaStream_t>(stream));
}
