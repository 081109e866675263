// K5 with the tail of each head's slice staged in a thread-block cluster's
// shared memory: a design of the gather-sum kernel measured beside the one
// that ships (salience_detr_torch/csrc/gather_sum.cu), which it does not
// replace.  It is built from this directory alone (chip_smoke.py
// --baseline-csrc, salience_detr_torch/tools/gather_cluster) and computes
// the same function: for each batch b, head h and query q, out[b, h, q] =
// sum_g value[b, idx[b, h, q, g], h, :], G rows of D = 32 channels summed in
// f32 and stored in bf16, bitwise equal to the shipped kernel.
//
// The idea: at the shootout's shape (B=4, H=8, Q=11403, G=64) the shipped
// kernel reads 1.49 GB of 64 B rows from L2 out of a 45.7 MB value tensor;
// one head's (S, D) slice is 1.43 MB, over one block's 227 KB of shared
// memory.  Rows staged in shared memory leave L2 alone.
//
// The design: a cluster of C blocks (C up to 8) owns one (b, h) and one of
// `qsplit` ranges of its queries.  At start the cluster stages the last T
// rows of that head's slice, value[b, S-T:S, h, :], across its blocks'
// shared memory, ceil(T / C) rows a block: one thread issues TMA loads of a
// 2-D tensor map over value viewed as (B*S, H*D) bf16 (boxes of 32 channels
// x up to 256 rows), completing on an mbarrier, and a cluster barrier makes
// every block's rows visible to the others.  Then a warp per query, 64 of
// its indices at a time (prefetched a chunk ahead), their 64 rows in flight
// together: a 64 B row is read by 4 lanes of 16 B each; a row s >= S - T
// from the owning block's shared memory (ld.shared, or ld.shared::cluster
// through distributed shared memory), every other row from global memory.
// The warp's 8 lane groups accumulate in f32 in the shipped kernel's order
// and are summed with shuffles.  An index outside [0, S) is skipped, never
// read.  A final cluster barrier keeps every block's shared memory alive
// while the others may read it.  T = 0 stages nothing.
//
// What the card showed (an H100 at 700 W, PERF.md): on the shootout's
// uniform indices no variant beats the shipped kernel (a staged row saves
// an L2 read only where indices crowd the tail; 1024-thread blocks that
// hold the tail keep 32 warps an SM, where the shipped kernel's small
// blocks keep more), and a row read through distributed shared memory costs
// more than one read from L2.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kHeadDim = 32;                    // channels of a head row, D
constexpr int kRowBytes = kHeadDim * 2;          // 64 B of bf16
constexpr int kLanesPerRow = kHeadDim / 8;       // 8 bf16 (16 B) per lane
constexpr int kRowsPerLoad = 32 / kLanesPerRow;  // rows per warp instruction
constexpr int kChunk = 64;                      // indices whose rows are in flight together
constexpr int kMaxCluster = 8;
constexpr int kMaxBoxRows = 256;                 // TMA box height limit
constexpr int kStageOffset = 128;                // the mbarrier, then the rows

// The staging plan of one block: rows a block holds (ceil(T / C)), the TMA
// box height (even, so that every box starts 128-byte aligned) and the rows
// allocated (whole boxes).
struct Stage {
  int rows, box, alloc;
  __host__ __device__ static Stage of(int T, int C) {
    Stage s;
    s.rows = T > 0 ? (T + C - 1) / C : 0;
    s.box = s.rows >= kMaxBoxRows ? kMaxBoxRows : (s.rows + 1) / 2 * 2;
    s.alloc = s.box > 0 ? (s.rows + s.box - 1) / s.box * s.box : 0;
    return s;
  }
  size_t smem() const { return kStageOffset + static_cast<size_t>(alloc) * kRowBytes; }
};

__device__ __forceinline__ void barrier_wait(uint64_t* bar, unsigned phase) {
  const unsigned b = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  unsigned done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(b), "r"(phase)
        : "memory");
  } while (!done);
}

// 16 bytes of this block's shared memory
__device__ __forceinline__ uint4 load_shared(unsigned at) {
  uint4 v;
  asm("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(at));
  return v;
}

// 16 bytes at the same offset of block `rank`'s shared memory (distributed
// shared memory)
__device__ __forceinline__ uint4 load_cluster(unsigned at, int rank) {
  unsigned remote;
  asm("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(at), "r"(rank));
  uint4 v;
  asm("ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(remote));
  return v;
}

// value (B, S, H, D) bf16 (tmap: the same tensor as (B*S, H*D)), idx (B, H,
// Q, G) int32, out (B, H, Q, D) bf16.  Cluster c = blockIdx.x / C owns (b, h)
// = divmod(c / qsplit, H) and query range c % qsplit; block `rank` holds
// rows S - T + rank * st_rows ... of the tail.  magic = ceil(2^32 / st_rows):
// t / st_rows = (t * magic) >> 32 exactly for t * st_rows <= 2^32.
__global__ void __launch_bounds__(kThreads, 1)
gather_sum_staged_kernel(const __grid_constant__ CUtensorMap tmap, const __nv_bfloat16* __restrict__ value,
                         const int* __restrict__ idx, __nv_bfloat16* __restrict__ out, int S, int H, int Q, int G,
                         int T, int st_rows, int st_box, uint64_t magic, int qsplit) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int c = blockIdx.x / C;
  const int qs = c % qsplit, bh = c / qsplit;
  const int b = bh / H, h = bh % H;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(smem + kStageOffset);
  const int tail0 = S - T;
  const int first = rank * st_rows;
  const int count = max(0, min(st_rows, T - first));

  if (count > 0) {
    if (threadIdx.x == 0) {
      const unsigned bar_s = static_cast<unsigned>(__cvta_generic_to_shared(bar));
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar_s) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      const int boxes = (count + st_box - 1) / st_box;
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar_s),
                   "r"(static_cast<unsigned>(boxes * st_box * kRowBytes))
                   : "memory");
      const int row0 = b * S + tail0 + first;
      for (int k = 0; k < boxes; ++k) {
        const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(stage + k * st_box * kHeadDim));
        asm volatile(
            "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], "
            "[%4];" ::"r"(dst),
            "l"(reinterpret_cast<uint64_t>(&tmap)), "r"(h * kHeadDim), "r"(row0 + k * st_box), "r"(bar_s)
            : "memory");
      }
    }
    __syncthreads();  // the barrier is initialised before anyone waits on it
    barrier_wait(bar, 0);
  }
  // every block's rows are in place and visible to the cluster
  cluster.sync();

  const int lane = threadIdx.x & 31;
  const int part = lane % kLanesPerRow, slot = lane / kLanesPerRow;
  const int per = (Q + qsplit - 1) / qsplit;
  const int q_end = min(Q, (qs + 1) * per);
  const int step = C * kWarps;
  const __nv_bfloat16* rows = value + (static_cast<int64_t>(b) * S * H + h) * kHeadDim + part * 8;
  const int64_t row_stride = static_cast<int64_t>(H) * kHeadDim;
  const unsigned stage_s = static_cast<unsigned>(__cvta_generic_to_shared(stage));
  // lane's two indices of the kChunk at g0 of query q (-1 past G)
  auto load_indices = [&](int q, int g0, int& i0, int& i1) {
    const int* p = idx + (static_cast<int64_t>(bh) * Q + q) * G + g0;
    const int n = G - g0;
    i0 = lane < n ? __ldg(p + lane) : -1;
    i1 = lane + 32 < n ? __ldg(p + lane + 32) : -1;
  };
  int q = qs * per + rank * kWarps + static_cast<int>(threadIdx.x / 32);
  int next0 = -1, next1 = -1;  // the indices of the chunk to come, loaded a chunk ahead
  if (q < q_end && G > 0) load_indices(q, 0, next0, next1);
  for (; q < q_end; q += step) {
    float acc[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = 0.f;
    for (int g0 = 0; g0 < G; g0 += kChunk) {
      const int n = min(kChunk, G - g0);
      const int mine0 = next0, mine1 = next1;
      if (g0 + kChunk < G) {
        load_indices(q, g0 + kChunk, next0, next1);
      } else if (q + step < q_end) {
        load_indices(q + step, 0, next0, next1);
      }
      // the chunk's 64 rows in flight together: load k reads the row at
      // slot k * kRowsPerLoad + slot; a row that is skipped adds +0, which
      // leaves the sum as it is (it is never -0)
      uint4 raw[kChunk / kRowsPerLoad];
#pragma unroll
      for (int k = 0; k < kChunk / kRowsPerLoad; ++k) {
        const int g = k * kRowsPerLoad + slot;
        const int s = __shfl_sync(kFullMask, k < 32 / kRowsPerLoad ? mine0 : mine1, g & 31);
        raw[k] = make_uint4(0u, 0u, 0u, 0u);
        if (g < n && s >= 0 && s < S) {
          const int t = s - tail0;
          if (t < 0) {
            raw[k] = __ldg(reinterpret_cast<const uint4*>(rows + s * row_stride));
          } else {
            const int owner = static_cast<int>((static_cast<uint64_t>(t) * magic) >> 32);
            const unsigned at = stage_s + ((t - owner * st_rows) * kHeadDim + part * 8) * 2;
            raw[k] = owner == rank ? load_shared(at) : load_cluster(at, owner);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kChunk / kRowsPerLoad; ++k) {
        const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw[k]);
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[j] += __bfloat162float(e[j]);
      }
    }
#pragma unroll
    for (int off = kLanesPerRow; off < 32; off <<= 1) {
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] += __shfl_xor_sync(kFullMask, acc[e], off);
    }
    if (slot == 0) {
      uint4 packed;
      __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(&packed);
#pragma unroll
      for (int e = 0; e < 8; ++e) o[e] = __float2bfloat16(acc[e]);
      *reinterpret_cast<uint4*>(out + (static_cast<int64_t>(bh) * Q + q) * kHeadDim + part * 8) = packed;
    }
  }
  // no block exits while another may still read its rows
  cluster.sync();
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, libcuda's entry point, reached through the runtime
// (no link to libcuda)
cudaError_t encode_tiled(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || p == nullptr) return cudaErrorNotSupported;
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

}  // namespace

// value (B, S, H, 32) bf16, 16-byte aligned; idx (B, H, Q, G) int32; out (B,
// H, Q, 32) bf16.  T in [0, S]: the tail rows staged in shared memory;
// cluster 1..8 blocks share them; qsplit >= 1 query ranges per (b, h).
// Returns cudaGetLastError() after the launch; cudaErrorInvalidValue for
// arguments the kernel does not take (D != 32, a block's share of the tail
// past the card's shared memory) and cudaErrorInvalidConfiguration when the
// card can place no cluster of this size (cudaOccupancyMaxActiveClusters is
// 0): the launch is refused, never replaced by another.
extern "C" int gather_sum_staged(const void* value, const void* idx, void* out, int B, int S, int H, int head_dim,
                                 int Q, int G, int T, int cluster, int qsplit, void* stream) {
  if (head_dim != kHeadDim || B < 0 || S <= 0 || H <= 0 || Q < 0 || G < 0 || T < 0 || T > S || cluster < 1 ||
      cluster > kMaxCluster || qsplit < 1 || reinterpret_cast<uintptr_t>(value) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (static_cast<int64_t>(B) * H * Q == 0) return static_cast<int>(cudaSuccess);
  const int64_t blocks = static_cast<int64_t>(B) * H * qsplit * cluster;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const Stage st = Stage::of(T, cluster);
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (st.smem() > static_cast<size_t>(optin)) return static_cast<int>(cudaErrorInvalidValue);

  CUtensorMap tmap = {};
  if (T > 0) {
    EncodeTiled encode = nullptr;
    err = encode_tiled(&encode);
    if (err != cudaSuccess) return static_cast<int>(err);
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(H) * kHeadDim, static_cast<cuuint64_t>(B) * S};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(H) * kRowBytes};
    const cuuint32_t box[2] = {kHeadDim, static_cast<cuuint32_t>(st.box)};
    const cuuint32_t unit[2] = {1, 1};
    const CUresult res = encode(&tmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(value), dims, strides,
                                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (res != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = gather_sum_staged_kernel;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(st.smem()));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(blocks));
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = st.smem();
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attribute[1];
  attribute[0].id = cudaLaunchAttributeClusterDimension;
  attribute[0].val.clusterDim.x = cluster;
  attribute[0].val.clusterDim.y = 1;
  attribute[0].val.clusterDim.z = 1;
  config.attrs = attribute;
  config.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &config);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (clusters == 0) return static_cast<int>(cudaErrorInvalidConfiguration);  // the cluster cannot be placed
  const uint64_t magic = st.rows > 0 ? ((uint64_t{1} << 32) + st.rows - 1) / st.rows : 0;
  err = cudaLaunchKernelEx(&config, kernel, tmap, static_cast<const __nv_bfloat16*>(value),
                           static_cast<const int*>(idx), static_cast<__nv_bfloat16*>(out), S, H, Q, G, T, st.rows,
                           st.box, magic, qsplit);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
