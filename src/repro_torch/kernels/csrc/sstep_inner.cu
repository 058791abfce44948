// sstep_inner.cu — the s sequential corrections of one s-step bundle
// (paper Algorithm 3, lines 9–14) in a single launch, for sm_90a:
//
//     for j = 0 .. s−1, in order:
//         z_j = v[jb:(j+1)b] + (η/b) · G[jb:(j+1)b, :] · u
//         u[jb:(j+1)b] = 1 / (1 + e^{z_j})          (logistic residual)
//
// with G (sb × sb, sb = s·b) strictly lower triangular and u starting at 0.
//
// Replaces: src/repro/kernels/sstep_inner.py, `_inner_kernel` (:26, entry
// `sstep_inner`, whose pallas_call is at :68). That kernel keeps all of G, v
// and u in on-chip memory for the whole loop. A thread block here has 227 KB
// of shared memory and G is 1 MiB at sb = 512, so G cannot be resident.
//
// What bounds it on this card: neither bytes nor operations but the chain of
// s dependent steps, plus the latency of the first tile of G. Step j reads
// only the columns < j·b of rows [jb, (j+1)b) — G's strict lower block
// triangle, b²·s(s−1)/2 floats, read once (24 KiB at sb = 128, 480 KiB at
// sb = 512) — and cannot start before step j − 1 has written its block of u.
//
// Design: G's panels go to shared memory ahead of the chain, and the chain
// reads only shared memory. The block is one producer warp and `threads`
// consumer threads (the geometry is `inner_geometry` in sstep_inner.py).
//   * The triangle is cut into tiles of b rows × `cols` (≤ 256) columns, in
//     step order: step j's columns [0, j·b) in ⌈j·b/cols⌉ tiles. A ring of
//     `stages` slots in shared memory holds them, each with a "full" and an
//     "empty" mbarrier. The producer warp copies tile k into slot k mod
//     stages by TMA (cp.async.bulk.tensor.2d: one box of up to 256 rows ×
//     cols columns from a tensor map of G made by the launcher, the bytes
//     reported to the slot's full barrier), as soon as the consumers have
//     released the slot's previous tile. Where the whole triangle fits
//     (sb ≤ 256 at b = 32: one tile a step) every tile is requested at
//     kernel start; where it does not (sb = 512 and up, to MAX_SB) the ring
//     keeps up to `stages` tiles ahead of the chain. Where G's rows are not
//     16-byte aligned (sb not a multiple of 4, or G off a 16-byte boundary)
//     the producer warp copies the tiles with loads and stores instead.
//     Designs that had every consumer thread cp.async its own share of the
//     tiles, or the producer make one bulk copy a row, were held up by
//     issuing the copies, which took longer than a step; one TMA box a tile
//     is one request.
//   * A row of a panel belongs to a group of LANES = 8 consecutive consumer
//     lanes; lane q of a group takes the 4-float vectors at columns 4q,
//     4q + 32, … of the row. A step's dependent work is: wait for the tile's
//     full barrier, the shared-memory dot (≤ j·b/32 vectors a lane), a
//     three-level shuffle reduction, one expf and one division, a store of u
//     to shared and global memory, and one barrier of the consumers alone
//     (bar.sync 1). Where a group has one row (b·8 ≤ threads), a step's tiles
//     are summed in one register and reduced once; else each tile's sum is
//     reduced at once and the running sum kept in the row's own slot of u,
//     which no dot reads before the step writes u there.
//   * Lane 0 of a group copies the v entries of its rows to shared memory at
//     start (cp.async); u is never zero-filled: a dot reads only the columns
//     < j·b, which earlier steps wrote, and zeroes the entries of the last
//     vector that lie past them.
// fp32 FMA throughout. s, b and η/b are runtime arguments: one binary
// serves every schedule. The residual is the overflow-safe two-branch form
// with expf (no fast-math), the branch taken as a select.
//
// Determinism: each u entry has one writer, and its dot is summed in a fixed
// order (by tile, by lane in column order, then the shuffle tree), so two
// launches on the same inputs give bitwise-equal u.
//
// bf16 mode (`bf16` = 1; the reference's `compute_dtype=bfloat16`): each
// G entry and each u entry is rounded to bf16 (round to nearest even) as it
// enters the dot, and the products are summed in fp32. The product of two
// bf16 values is exact in fp32, so the mode differs from its plain version
// only in the order of the fp32 sums. G is staged in fp32 (TMA copies bytes,
// it cannot round) and rounded as it is read; u is rounded once, when it is
// written to shared memory, and written to the output in fp32. z, the
// residual and the output u stay fp32. The mode is a template parameter: one
// source, two instantiations.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 1024;  // the consumers and the producer warp
constexpr int PRODUCER = 32;       // threads of the producer warp
constexpr int LANES = 8;           // consumer lanes a row (a sweep's choice; LANES in sstep_inner.py)

__device__ __forceinline__ float logistic_residual(float z) {
  // 1/(1+e^z) in the overflow-safe two-branch form, the branch taken as a
  // select: with e = e^{−|z|}, e/(1+e) for z ≥ 0, else 1/(1+e).
  const float e = expf(-fabsf(z));
  return (z >= 0.0f ? e : 1.0f) / (1.0f + e);
}

// x as a dot operand: rounded to bf16 in the bf16 mode, unchanged in fp32
template <bool BF16>
__device__ __forceinline__ float operand(float x) {
  if constexpr (BF16) return __bfloat162float(__float2bfloat16_rn(x));
  return x;
}

__device__ __forceinline__ uint32_t shared_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void copy4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(shared_address(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void barrier_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(shared_address(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(shared_address(bar)) : "memory");
}

__device__ __forceinline__ void arrive_expecting(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(shared_address(bar)),
               "r"(bytes)
               : "memory");
}

// until the phase of `bar` whose parity is `parity` has completed
__device__ __forceinline__ void wait_phase(uint64_t* bar, uint32_t parity) {
  const uint32_t address = shared_address(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(address), "r"(parity)
        : "memory");
  } while (!done);
}

// one TMA copy of the box of G at (column, row) to shared memory, reported to `bar`
__device__ __forceinline__ void box_copy(float* dst, const CUtensorMap* map, int column, int row,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], "
      "[%4];\n" ::"r"(shared_address(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(column), "r"(row), "r"(shared_address(bar))
      : "memory");
}

// a barrier of the consumer threads alone (the producer warp may have ended)
__device__ __forceinline__ void consumers_sync(int consumers) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(consumers) : "memory");
}

// part + this lane's share of the dot of one tile row with u: columns c0 + 4q,
// c0 + 4q + 4·LANES, … below c0 + width; entries past the panel's end jc
// count as 0 (the tile holds G's entries or zeros there, u not yet u)
template <bool BF16>
__device__ __forceinline__ float tile_dot(const float* g_row, const float* u, int c0, int width, int jc,
                                          int q, float part) {
#pragma unroll 2
  for (int kk = 4 * q; kk < width; kk += 4 * LANES) {
    const float4 g4 = *reinterpret_cast<const float4*>(g_row + kk);
    const int c = c0 + kk;
    float4 u4 = *reinterpret_cast<const float4*>(u + c);  // bf16 mode: already rounded
    u4.y = c + 1 < jc ? u4.y : 0.0f;
    u4.z = c + 2 < jc ? u4.z : 0.0f;
    u4.w = c + 3 < jc ? u4.w : 0.0f;
    part = fmaf(operand<BF16>(g4.x), u4.x, part);
    part = fmaf(operand<BF16>(g4.y), u4.y, part);
    part = fmaf(operand<BF16>(g4.z), u4.z, part);
    part = fmaf(operand<BF16>(g4.w), u4.w, part);
  }
  return part;
}

// the sum of `part` over the LANES lanes of a row's group, in lane 0 of it
__device__ __forceinline__ float group_sum(float part) {
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1) part += __shfl_down_sync(0xffffffffu, part, off, LANES);
  return part;
}

// u[row] = uj: to the output in fp32, and to shared memory as the dot's
// operand (rounded to bf16 once, here, in the bf16 mode)
template <bool BF16>
__device__ __forceinline__ void finish_row(float* u, float* u_out, int row, float uj) {
  u[row] = operand<BF16>(uj);
  u_out[row] = uj;
}

template <bool BF16>
__global__ void __launch_bounds__(MAX_THREADS)
sstep_inner_kernel(const __grid_constant__ CUtensorMap map, const float* __restrict__ G,
                   const float* __restrict__ v, float* __restrict__ u_out, int s, int b,
                   float eta_over_b, int cols, int stages, int tiles, int box_rows) {
  extern __shared__ __align__(128) float smem[];
  const int sb = s * b;
  const int sb4 = (sb + 3) & ~3;
  float* u = smem;                                 // u as a dot operand (bf16-rounded in the bf16 mode)
  float* vs = smem + sb4;                          // v, each entry copied by the thread that reads it
  float* ring = smem + ((2 * sb4 + 31) & ~31);     // stages slots of b rows × cols, 128-byte aligned
  const int stage_floats = (b * cols + 31) & ~31;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * stage_floats);
  uint64_t* empty = full + stages;
  const int consumers = blockDim.x - PRODUCER;

  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      barrier_init(&full[i], box_rows > 0 ? 1 : PRODUCER);
      barrier_init(&empty[i], consumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const int ct = static_cast<int>(threadIdx.x) - PRODUCER;  // consumer index
  const int q = ct % LANES;                                  // lane within the row's group
  const int grp = ct / LANES;
  const int groups = consumers / LANES;
  if (ct >= 0 && q == 0) {
    for (int r = grp; r < b; r += groups)
      for (int j = 0; j < s; ++j) copy4(&vs[j * b + r], &v[j * b + r]);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  __syncthreads();  // the barriers are initialised

  if (ct < 0) {
    // the producer warp: tile k (step j's columns [c0, c0 + cols) ∩ [0, j·b))
    // into ring slot k mod stages, once the consumers have released the
    // slot's previous tile
    const int lane = threadIdx.x;
    int j = 1, c0 = 0, slot = 0;
    uint32_t use = 0;  // how often the slot has been filled before
    for (int k = 0; k < tiles; ++k) {
      if (use > 0) wait_phase(&empty[slot], (use - 1) & 1);
      float* dst = ring + slot * stage_floats;
      if (box_rows > 0) {  // TMA: boxes of box_rows × cols, b/box_rows of them
        if (lane == 0) arrive_expecting(&full[slot], static_cast<uint32_t>(b * cols * 4));
        __syncwarp();
        for (int r = lane * box_rows; r < b; r += PRODUCER * box_rows)
          box_copy(dst + r * cols, &map, c0, j * b + r, &full[slot]);
      } else {  // G's rows not 16-byte aligned: loads and stores, zeros past the panel
        const float* src = G + (size_t)(j * b) * sb + c0;
        const int width = min(cols, j * b - c0);
        for (int r = 0; r < b; ++r)
          for (int c = lane; c < cols; c += PRODUCER)
            dst[r * cols + c] = c < width ? src[(size_t)r * sb + c] : 0.0f;
        arrive(&full[slot]);
      }
      c0 += cols;
      if (c0 >= j * b) {
        ++j;
        c0 = 0;
      }
      if (++slot == stages) {
        slot = 0;
        ++use;
      }
    }
    return;
  }

  // the consumers: the chain of steps
  const int rows_a_group = (b + groups - 1) / groups;  // the same trip count in every group
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");  // this thread's v entries
  for (int i = 0; i < rows_a_group; ++i) {  // step 0 has no panel: z = v
    const int r = grp + i * groups;
    if (q == 0 && r < b) finish_row<BF16>(u, u_out, r, logistic_residual(vs[r]));
  }
  consumers_sync(consumers);

  int slot = 0, k = 0;
  uint32_t use = 0;
  auto next_slot = [&]() {
    if (k + stages < tiles) {  // the producer refills this slot: release it
      __syncwarp();
      if (ct % 32 == 0) arrive(&empty[slot]);
    }
    ++k;
    if (++slot == stages) {
      slot = 0;
      ++use;
    }
  };
  for (int j = 1; j < s; ++j) {
    const int jc = j * b;  // u is filled exactly up to here
    if (rows_a_group == 1) {
      // one row a group: the step's tiles summed in one register, reduced once
      float part = 0.0f;
      for (int c0 = 0; c0 < jc; c0 += cols) {
        wait_phase(&full[slot], use & 1);
        if (grp < b) part = tile_dot<BF16>(ring + slot * stage_floats + grp * cols, u, c0, min(cols, jc - c0), jc, q, part);
        next_slot();
      }
      part = group_sum(part);
      if (q == 0 && grp < b)
        finish_row<BF16>(u, u_out, jc + grp, logistic_residual(fmaf(eta_over_b, part, vs[jc + grp])));
    } else {
      // several rows a group: each tile's sum reduced at once, the running
      // sum kept in the row's own slot of u until the step's last tile
      for (int c0 = 0; c0 < jc; c0 += cols) {
        wait_phase(&full[slot], use & 1);
        const float* tile = ring + slot * stage_floats;
        for (int i = 0; i < rows_a_group; ++i) {
          const int r = grp + i * groups;
          float part = 0.0f;
          if (r < b) part = tile_dot<BF16>(tile + r * cols, u, c0, min(cols, jc - c0), jc, q, part);
          part = group_sum(part);
          if (q == 0 && r < b) {
            const int row = jc + r;
            if (c0 > 0) part = u[row] + part;
            if (c0 + cols < jc) u[row] = part;
            else finish_row<BF16>(u, u_out, row, logistic_residual(fmaf(eta_over_b, part, vs[row])));
          }
        }
        next_slot();
      }
    }
    consumers_sync(consumers);
  }
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime's entry-point query (no link to libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
#endif
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() as an int (0 = launched;
// cudaErrorInvalidValue if G's tensor map cannot be made). G (sb, sb) float32
// row-major, strictly lower; v (sb,) float32; u (sb,) is written in full.
// bf16 = 0 is the fp32 mode, 1 the bf16 mode. The geometry — consumer threads
// (a multiple of 32, at most 992), cols (a multiple of 4, at most 256),
// stages (0 only for s = 1), the number of tiles and the dynamic shared memory
// in bytes — is `inner_geometry`'s in sstep_inner.py; this function trusts it.
// The block has the consumer threads and one producer warp. Tiles come by
// TMA, in boxes of cols columns × the largest divisor of b up to 256 rows
// whose boxes land on 128-byte boundaries, where G's rows are 16-byte aligned
// (sb a multiple of 4, G on a 16-byte boundary) and such a divisor exists;
// else the producer warp copies them with loads and stores.
extern "C" int sstep_inner_launch(const void* G, const void* v, void* u, int s, int b,
                                  float eta_over_b, int bf16, int threads, int cols, int stages,
                                  int tiles, int smem_bytes, void* stream) {
  auto kernel = bf16 ? sstep_inner_kernel<true> : sstep_inner_kernel<false>;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int sb = s * b;
  CUtensorMap map = {};
  int box_rows = 0;  // 0: no TMA
  if (tiles > 0 && sb % 4 == 0 && reinterpret_cast<uintptr_t>(G) % 16 == 0) {
    // boxes of at most 256 rows that divide b and land on 128-byte boundaries
    box_rows = b < 256 ? b : 256;
    while (box_rows > 0 && (b % box_rows != 0 || (box_rows < b && box_rows * cols % 32 != 0))) --box_rows;
  }
  if (box_rows > 0) {
    const EncodeTiled encode = encode_tiled();
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(sb), static_cast<cuuint64_t>(sb)};
    const cuuint64_t row_bytes[1] = {static_cast<cuuint64_t>(sb) * 4};
    const cuuint32_t box[2] = {static_cast<cuuint32_t>(cols), static_cast<cuuint32_t>(box_rows)};
    const cuuint32_t unit[2] = {1, 1};
    if (encode == nullptr ||
        encode(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(G), dims, row_bytes, box, unit,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  kernel<<<1, threads + PRODUCER, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      map, static_cast<const float*>(G), static_cast<const float*>(v), static_cast<float*>(u), s, b,
      eta_over_b, cols, stages, tiles, box_rows);
  return static_cast<int>(cudaGetLastError());
}
