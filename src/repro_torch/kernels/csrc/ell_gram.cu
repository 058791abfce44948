// ell_gram.cu — (G, v) = (tril(Y·Yᵀ, −1), Y·x) straight from the ELL rows of
// an s-bundle Y (sb rows, w padded entries a row, n columns), for sm_90a.
//
// Replaces: src/repro/kernels/ell_gram.py, `_ell_gram_kernel` (entry
// `ell_gram_and_v`), at the bundles `gram_route` in ell_gram.py sends to the
// hash route: every sparse one (w < DENSE_MIN_WIDTH, or n > DENSE_RATIO·w).
// Rows that cover their columns (epsilon's) go to the dense route,
// ell_gram_dense.cu, a tensor-core tile product. That kernel walks ⌈n/bk⌉
// column panels on a sequential grid, expands each panel to a dense on-chip
// tile by comparing against an iota (its target has no in-kernel scatter),
// accumulates G across grid steps and masks after the last. None of that is
// carried over: the contract is the (G, v) pair.
//
// What bounds the function on this card: bytes. The inputs are sb·w·8 bytes
// (114 KB at sb = 128, w = 111), G is sb²·4 bytes, and the multiply-adds that
// (G, v) needs are only those of column ids that two rows share — far fewer
// than the bytes would allow at the card's fp32 rate. The work of a direct
// sparse design is finding those shared ids.
//
// Design: a per-tile hash probe. For i > j
//     G[i, j] = Σ_a val_i[a] · P_j[idx_i[a]],
// with P_j the dense row j (duplicate column ids summed). A block owns a
// tile × tile square of G (the geometry comes from the launcher's caller,
// `gram_geometry` in ell_gram.py) and
//   * copies the entries of its i-rows and j-rows into shared memory with
//     cp.async: one round trip to memory a pass, every load in flight at
//     once (a chain of dependent loads — value, then id, then x[id] — was
//     what bounded a first version of this design);
//   * turns each j-row into an open-addressing table in shared memory,
//     keyed by column id (empty key −1, which no column id takes), capacity a
//     power of two of at least four times the entries staged (load factor
//     ≤ ¼), in buckets of 4 slots from a Fibonacci hash: an id takes the
//     first free slot from its home bucket on. An insert reads the bucket
//     and claims that slot with atomicCAS on the key (shared-memory atomics
//     are slow, so it reads before it claims and rarely claims twice), the
//     rows interleaved across the lanes; the first entry of an id stores its
//     value, and a repeated id of the same j-row adds its value with
//     atomicAdd after a barrier, merging the row's duplicates into one slot.
//     Entries whose value is 0 — every pad — are never inserted;
//   * compacts each i-row's nonzero entries, in their order, in place (a
//     warp ballot), so no thread walks a pad;
//   * gives each (i, j) pair `ks` threads that split row i's staged entries
//     (every ks-th one); a thread looks each entry up in row j's table, four
//     independent lookups in flight, and on a hit adds val_i · P_j[c] with
//     one fmaf. A lookup reads its home bucket's 4 keys with one 16-byte
//     load and ends there unless the bucket is full: the lanes of a warp
//     step together, so a warp waits for its longest probe chain, and with
//     slot-by-slot probing those chains (not the lookups) set the time;
//     Tables are cap + 4 words apart, so the 8 tables that a quarter warp
//     reads fall in 8 different groups of 4 banks;
//   * walks rows wider than one chunk by j-chunks (a table each) and, inside
//     each, i-chunks, so every w runs in bounded shared memory;
//   * writes every element of G from exactly one thread: the ks partial
//     sums of a pair are added in slice order through shared memory. There
//     are no atomics on G, no zero-fill pass and no second launch. Only
//     tiles on or below the diagonal have a block; an off-diagonal block
//     also writes the zeros of its mirror tile above the diagonal, and a
//     diagonal block computes v for its rows from the compacted entries (a
//     gather of x, one warp a row, shuffle-reduced, i-chunks in order).
// fp32 FMA throughout: no tensor cores, no TF32 — the rows this route takes
// are sparse. On dense rows every lookup hits and the Σ_{i>j} w lookups are a
// product the tensor cores do (0.024 against 0.70 ms on an H100 at (128,
// 2,000, 2,000), PERF.md): `gram_route` sends those bundles to ell_gram_dense.cu.
//
// The work is Σ_{i>j} nnz_i lookups (≈ 0.6·10⁶ at sb = 128, w = 111 on
// rcv1) plus the nonzeros of a tile's j-rows inserted once in each block of
// its column, against the ≈ 10⁸ id compares of an all-pairs match; it does
// not depend on n. On the card the time goes to latency, not to this count:
// a block's cp.async round trip, its atomic inserts and its lookup chains,
// with few blocks to hide them (136 tiles on or below the diagonal at
// sb = 128, tile 8: about one for each of the 132 SMs). `gram_geometry`
// therefore takes 8 × 8 tiles and 8 threads a pair when blocks are few, and
// 16 × 16 tiles, which build each table half as often, when they fill the
// card.
//
// Determinism. On rows whose column ids are distinct (every registered
// dataset and every generator row) each table slot is stored once, by the
// id's only entry, and each sum of G is taken in a fixed order — by
// j-chunk, then by i-chunk, then in the order of row i's entries within each
// of the ks slices, the slices added in order — so two launches give
// bitwise-equal G and v. Where a j-row repeats an id, which of its entries
// stores the value and the order of the atomic adds that merge the others
// vary, and G may vary in the last bits from launch to launch, within
// tolerance.
//
// bf16 mode (`bf16` = 1; the reference's `compute_dtype=bfloat16`): values
// are rounded to bf16 (round to nearest even) — on the j side the table
// value after duplicates are merged, once, when a lookup hits it, so a
// repeated id's summed value is rounded once, as the plain version rounds
// its dense panel entry; on the i side entry by entry as it is staged,
// duplicates unmerged — and so is each gathered x entry of v. Products and
// sums stay fp32, and G and v are fp32. The product of two bf16 values is
// exact in fp32, so on rows with distinct ids the mode differs from its
// plain version only in the order of the fp32 sums. Where
// an i-row repeats an id, the kernel rounds the parts and the plain version
// their sum, up to one bf16 rounding (relative 2⁻⁸) of that entry; so it is
// also where a j-row repeats an id in two chunks (w above one chunk). (The
// reference rounds each part and then their sum.) No registered dataset and
// no generator row repeats an id. The mode is a template parameter: one
// source, two instantiations.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int EMPTY = -1;        // the key of a free slot; no column id is negative
constexpr int BUCKET = 4;        // slots a lookup reads at once (one 16-byte load)
constexpr int LOOKUPS = 4;       // independent lookups a thread keeps in flight
constexpr int MAX_THREADS = 512;

// x as a product operand: rounded to bf16 in the bf16 mode, unchanged in fp32
template <bool BF16>
__device__ __forceinline__ float operand(float x) {
  if constexpr (BF16) return __bfloat162float(__float2bfloat16_rn(x));
  return x;
}

// home bucket of column id c in a table of 2^(32 − shift) buckets
__device__ __forceinline__ int home_bucket(int c, int shift) {
  return static_cast<int>((static_cast<uint32_t>(c) * 2654435761u) >> shift);
}

// the slot of c in the bucket whose keys are k (0–3), BUCKET if c is not
// there, and in `open` whether the bucket has a free slot (c is in no later
// bucket then)
__device__ __forceinline__ int match(const int4& k, int c, bool& open) {
  open = (k.x == EMPTY) | (k.y == EMPTY) | (k.z == EMPTY) | (k.w == EMPTY);
  return k.x == c ? 0 : k.y == c ? 1 : k.z == c ? 2 : k.w == c ? 3 : BUCKET;
}

// rows [r0, r0 + rows) of the (·, w) arrays, entries [a0, a0 + n), into
// shared memory at a row pitch of `pitch`, asynchronously (cp.async): warp
// `warp` of `nwarps` takes rows warp, warp + nwarps, …, its lanes side by side
__device__ __forceinline__ void copy_rows(int* s_idx, float* s_val, const int* idx,
                                          const float* val, int r0, int rows, int a0, int n,
                                          int w, int pitch, int warp, int nwarps, int lane) {
  for (int r = warp; r < rows; r += nwarps) {
    const size_t g = (size_t)(r0 + r) * w + a0;
    for (int a = lane; a < n; a += 32) {
      __pipeline_memcpy_async(&s_idx[r * pitch + a], &idx[g + a], sizeof(int));
      __pipeline_memcpy_async(&s_val[r * pitch + a], &val[g + a], sizeof(float));
    }
  }
}

template <bool BF16>
__global__ void __launch_bounds__(MAX_THREADS)
ell_gram_kernel(const int* __restrict__ idx, const float* __restrict__ val,
                const float* __restrict__ x, float* __restrict__ G,
                float* __restrict__ v, int sb, int w, int tile, int ks, int chunk,
                int cap_log2) {
  // one block for each tile on or below the diagonal, numbered row by row
  const int t = blockIdx.x;
  int bi = static_cast<int>((sqrtf(8.0f * t + 1.0f) - 1.0f) * 0.5f);
  while (bi * (bi + 1) / 2 > t) --bi;
  while ((bi + 1) * (bi + 2) / 2 <= t) ++bi;
  const int bj = t - bi * (bi + 1) / 2;
  const int pairs = tile * tile;
  const int tid = threadIdx.x;
  const int slice = tid / pairs;
  const int pair = tid - slice * pairs;
  const int ti = pair / tile;
  const int tj = pair - ti * tile;
  const int i0 = bi * tile;
  const int j0 = bj * tile;
  const int i = i0 + ti;
  const int j = j0 + tj;
  const bool in_range = (i < sb) && (j < sb);
  const bool diagonal = (bi == bj);

  // the mirror tile above the diagonal has no pair i > j: its zeros
  if (!diagonal && slice == 0 && j0 + ti < sb && i0 + tj < sb) G[(size_t)(j0 + ti) * sb + i0 + tj] = 0.0f;

  const int cap = 1 << cap_log2;  // slots a table: cap / BUCKET buckets of BUCKET
  const int bmask = cap / BUCKET - 1;
  const int shift = 32 - (cap_log2 - 2);
  // row r's table starts 4r banks further on: the 8 tables that a quarter
  // warp reads at one bucket fall in 8 different groups of 4 banks
  const int stride = cap + BUCKET;
  extern __shared__ __align__(16) int smem[];
  int* keys = smem;                                               // tile × stride
  float* tvals = reinterpret_cast<float*>(keys + tile * stride);  // tile × stride
  int* si_idx = reinterpret_cast<int*>(tvals + tile * stride);    // tile × chunk
  float* si_val = reinterpret_cast<float*>(si_idx + tile * chunk);  // tile × chunk
  int* sj_idx = reinterpret_cast<int*>(si_val + tile * chunk);    // tile × chunk
  float* sj_val = reinterpret_cast<float*>(sj_idx + tile * chunk);  // tile × chunk
  int* ni = reinterpret_cast<int*>(sj_val + tile * chunk);        // tile
  float* vacc = reinterpret_cast<float*>(ni + tile);              // tile
  float* partial = vacc + tile;                                   // ks × pairs
  __shared__ int repeated;  // a j-row of this chunk repeats an id

  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int rows_i = min(tile, sb - i0);
  const int rows_j = min(tile, sb - j0);
  const bool live = in_range && (i > j);
  const int* my_keys = keys + tj * stride;
  const float* my_vals = tvals + tj * stride;
  const int* my_idx = si_idx + ti * chunk;
  const float* my_val = si_val + ti * chunk;
  if (diagonal && tid < tile) vacc[tid] = 0.0f;
  float acc = 0.0f;

  for (int cj = 0; cj < w; cj += chunk) {
    const int nj = min(chunk, w - cj);
    for (int ci = 0; ci < w; ci += chunk) {
      const int nic = min(chunk, w - ci);
      __syncthreads();  // the previous pass's readers are done
      // one round trip: this pass's raw i-chunk (and, first in a j-chunk,
      // the raw j-chunk) land in shared memory while the tables are cleared
      copy_rows(si_idx, si_val, idx, val, i0, rows_i, ci, nic, w, chunk, warp, nwarps, lane);
      if (ci == 0) {
        copy_rows(sj_idx, sj_val, idx, val, j0, rows_j, cj, nj, w, chunk, nwarps - 1 - warp, nwarps, lane);
        for (int e = tid; e < tile * stride; e += blockDim.x) keys[e] = EMPTY;
        if (tid == 0) repeated = 0;
      }
      __pipeline_commit();
      __pipeline_wait_prior(0);
      __syncthreads();

      // i-rows: keep the chunk's nonzero entries, in order, one warp a row
      // (in place: a lane writes no further on than the entries its warp
      // has read)
      for (int r = warp; r < rows_i; r += nwarps) {
        int* row_idx = si_idx + r * chunk;
        float* row_val = si_val + r * chunk;
        int count = 0;
        for (int a0 = 0; a0 < nic; a0 += 32) {
          const int a = a0 + lane;
          const float value = (a < nic) ? row_val[a] : 0.0f;
          const int c = (a < nic) ? row_idx[a] : 0;
          const bool nz = value != 0.0f;
          const unsigned ballot = __ballot_sync(0xffffffffu, nz);
          __syncwarp();
          if (nz) {
            const int pos = count + __popc(ballot & ((1u << lane) - 1u));
            row_idx[pos] = c;
            row_val[pos] = operand<BF16>(value);
          }
          count += __popc(ballot);
          __syncwarp();
        }
        if (lane == 0) ni[r] = count;
      }
      if (ci == 0) {
        // j-rows: insert the chunk's nonzero entries, the rows interleaved
        // across the lanes (fewer lanes of a warp race for one bucket). The
        // first entry of an id stores its value; a repeat leaves its slot in
        // sj_idx and adds its value after the next barrier.
        for (int e = tid; e < rows_j * nj; e += blockDim.x) {
          const int r = e % rows_j;
          const int a = e / rows_j;
          const float value = sj_val[r * chunk + a];
          if (value == 0.0f) continue;
          const int c = sj_idx[r * chunk + a];
          int* row_keys = keys + r * stride;
          // the first free slot from the home bucket on: read a bucket, try
          // its first free slot, read again only if another id took it
          int b = home_bucket(c, shift);
          int slot, prev;
          while (true) {
            bool open;
            const int4 kb = *reinterpret_cast<const int4*>(row_keys + b * BUCKET);
            const int m = match(kb, c, open);
            if (m < BUCKET) {  // c is there already
              slot = b * BUCKET + m;
              prev = c;
              break;
            }
            if (!open) {
              b = (b + 1) & bmask;
              continue;
            }
            slot = b * BUCKET + (kb.x == EMPTY ? 0 : kb.y == EMPTY ? 1 : kb.z == EMPTY ? 2 : 3);
            prev = atomicCAS(&row_keys[slot], EMPTY, c);
            if (prev == EMPTY || prev == c) break;
          }
          if (prev == EMPTY) {
            tvals[r * stride + slot] = value;
            sj_idx[r * chunk + a] = EMPTY;
          } else {
            sj_idx[r * chunk + a] = slot;
            repeated = 1;
          }
        }
      }
      __syncthreads();  // the i entries are compacted and every id has a slot
      if (ci == 0 && repeated) {
        for (int e = tid; e < rows_j * nj; e += blockDim.x) {
          const int r = e % rows_j;
          const int a = e / rows_j;
          if (sj_val[r * chunk + a] != 0.0f && sj_idx[r * chunk + a] != EMPTY)
            atomicAdd(&tvals[r * stride + sj_idx[r * chunk + a]], sj_val[r * chunk + a]);
        }
        __syncthreads();
      }

      if (live) {
        // a hit's table value is the j-row's merged value for that id; in
        // the bf16 mode it is rounded here, once
        const int cnt = ni[ti];
        int k = slice;
        for (; k + (LOOKUPS - 1) * ks < cnt; k += LOOKUPS * ks) {
          int c[LOOKUPS], hb[LOOKUPS], m[LOOKUPS];
          float a[LOOKUPS];
          bool open[LOOKUPS];
#pragma unroll
          for (int u = 0; u < LOOKUPS; ++u) {
            c[u] = my_idx[k + u * ks];
            a[u] = my_val[k + u * ks];
            hb[u] = home_bucket(c[u], shift);
          }
          bool full = false;
#pragma unroll
          for (int u = 0; u < LOOKUPS; ++u) {
            m[u] = match(*reinterpret_cast<const int4*>(my_keys + hb[u] * BUCKET), c[u], open[u]);
            full |= (m[u] == BUCKET) && !open[u];
          }
          if (full) {  // a bucket is full and c is not in it: look on
#pragma unroll
            for (int u = 0; u < LOOKUPS; ++u) {
              while ((m[u] == BUCKET) && !open[u]) {
                hb[u] = (hb[u] + 1) & bmask;
                m[u] = match(*reinterpret_cast<const int4*>(my_keys + hb[u] * BUCKET), c[u], open[u]);
              }
            }
          }
#pragma unroll
          for (int u = 0; u < LOOKUPS; ++u)
            if (m[u] < BUCKET) acc = fmaf(a[u], operand<BF16>(my_vals[hb[u] * BUCKET + m[u]]), acc);
        }
        for (; k < cnt; k += ks) {
          const int c1 = my_idx[k];
          int hb1 = home_bucket(c1, shift);
          bool open1;
          int m1 = match(*reinterpret_cast<const int4*>(my_keys + hb1 * BUCKET), c1, open1);
          while ((m1 == BUCKET) && !open1) {
            hb1 = (hb1 + 1) & bmask;
            m1 = match(*reinterpret_cast<const int4*>(my_keys + hb1 * BUCKET), c1, open1);
          }
          if (m1 < BUCKET) acc = fmaf(my_val[k], operand<BF16>(my_vals[hb1 * BUCKET + m1]), acc);
        }
      }

      // v for the rows of a diagonal tile, from their staged entries: one
      // warp a row, each i-chunk once
      if (diagonal && cj == 0) {
        for (int r = warp; r < rows_i; r += nwarps) {
          const int cnt = ni[r];
          float part = 0.0f;
#pragma unroll 4
          for (int k = lane; k < cnt; k += 32)
            part = fmaf(si_val[r * chunk + k], operand<BF16>(x[si_idx[r * chunk + k]]), part);
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) part += __shfl_down_sync(0xffffffffu, part, off);
          if (lane == 0) vacc[r] += part;
        }
      }
    }
  }

  partial[slice * pairs + pair] = acc;
  __syncthreads();
  if (slice == 0 && in_range) {
    float sum = partial[pair];
    for (int s = 1; s < ks; ++s) sum += partial[s * pairs + pair];
    G[(size_t)i * sb + j] = (i > j) ? sum : 0.0f;
  }
  if (diagonal && tid < rows_i) v[i0 + tid] = vacc[tid];
}

}  // namespace

// Launches on `stream` and returns a cudaError_t as an int (0 = launched).
// idx (sb, w) int32 row-major, val (sb, w) float32, x (n,) float32 with every
// idx in [0, n); G (sb, sb) and v (sb,) are written in full. bf16 = 0 is the
// fp32 mode, 1 the bf16 mode. The geometry — tile, ks (threads a pair), chunk
// (entries a pass), cap_log2 (log2 of a table's slots) and the dynamic shared
// memory in bytes — is `gram_geometry`'s in ell_gram.py; this function trusts
// it. The grid is one block of tile²·ks threads for each of the T(T+1)/2
// tiles on or below the diagonal, T = ⌈sb/tile⌉.
extern "C" int ell_gram_launch(const void* idx, const void* val, const void* x,
                               void* G, void* v, int sb, int w, int bf16, int tile, int ks,
                               int chunk, int cap_log2, int smem_bytes, void* stream) {
  auto kernel = bf16 ? ell_gram_kernel<true> : ell_gram_kernel<false>;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int tiles = (sb + tile - 1) / tile;
  kernel<<<tiles * (tiles + 1) / 2, tile * tile * ks, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), static_cast<const float*>(val),
      static_cast<const float*>(x), static_cast<float*>(G), static_cast<float*>(v), sb, w,
      tile, ks, chunk, cap_log2);
  return static_cast<int>(cudaGetLastError());
}
