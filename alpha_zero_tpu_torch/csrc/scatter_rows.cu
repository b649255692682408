// Tree-row writers: one row per lane into each of N arrays, in place, in one
// launch. For arrays i = 0..N-1 (1 <= N <= 16), arr_i [B, T_i, *row_i] and
// rows_i [B, *row_i] contiguous and of any one dtype each, and one
// widx i32 [B] that all of them share:
//
//     arr_i[b, widx[b]] = rows_i[b]   for every lane b with 0 <= widx[b] < T_i
//
// and every other byte stays as it was. The kernels move bytes and compute
// nothing, so they are bit-equal to the plain version
// (alpha_zero_tpu_torch/ops/scatter_kernels.py:write_rows_plain, the search's
// former per-array _put_rows) by construction. A descriptor of the set
// (RowSet: destination and source bases, row bytes, T) is built by the C
// entry point and passed to the kernel by value, as a __grid_constant__
// parameter: no copy from the host, no allocation, and a CUDA graph capture
// records it whole.
//
// azt_scatter_rows (K2) replaces the TPU kernel tools/dma_probe.py:44
// (scatter_kernel), which starts one row DMA per lane and waits on it before
// the next. What bounds it on an H100: bytes, and below them the launch. The
// search writes 13 arrays a simulation when it materializes a node (281 B a
// lane at go9: 0.58 MB at B=1024, 0.17 us at 3.35 TB/s) and 2 when it
// expands one (329 B a lane: 0.68 MB, 0.20 us) -- both less than one launch
// costs. So the design puts a whole tree write into one launch, instead of
// one launch (or PyTorch's three kernels) per array, and keeps every row of
// every array in flight at once:
// - one warp per lane, eight lanes per 256-thread block (128 blocks at
//   B=1024, one wave on 132 SMs); the warp reads its lane's widx once (one
//   broadcast load) and a lane whose widx is negative returns, having read
//   nothing else;
// - the lane's rows are cut into 16-byte units of the DESTINATION (the
//   16-byte-aligned windows that the row overlaps; ceil((row + 15) / 16) of
//   them bound it for any alignment), numbered across the N arrays, and the
//   warp's 32 threads take them two at a time: a thread issues the loads of
//   both units before either store, so no thread walks the arrays as a chain
//   of dependent round trips;
// - byte-granular rows with no padding: a unit the row covers whole is one
//   16-byte store; its source is one 16-byte load where source and
//   destination share their alignment modulo 16, else up to five aligned
//   4-byte loads joined by funnel shifts (only words that hold a byte of the
//   row are read, so no load leaves the row's own aligned words). The head
//   and tail units of a row store whole 4-byte words where they can and
//   single bytes at the edges, so no byte outside the row is written: the
//   neighbouring row may belong to another lane of the same launch. That
//   covers go9's 81-byte int8 board, its 1-byte to_play and bool rows and
//   go19's 722- and 724-byte int16 rows alike;
// - the descriptor is copied into shared memory first (one word a thread,
//   while widx is in flight): threads index it by their unit's array, and a
//   kernel parameter indexed per thread is read one distinct address at a
//   time. A unit finds its array by a binary search of the units' prefix
//   sums (4 steps for 16 arrays).
// Measured against other designs in turns on the card (PERF.md, section 6):
// units cut at the source's alignment, so that the row loads need not wait
// for widx, gained 0.3-0.4 us with L2 flushed but lost 0.1-0.5 us warm
// (idle lanes then load their rows too), and in a real move a launch takes
// about its warm time.
//
// azt_scatter_rows_bulk (K3) replaces tools/dma_probe.py:83
// (scatter_kernel_overlap), which starts every DMA of a block before waiting
// on any. Its Hopper counterpart is the bulk-copy (TMA) unit, which needs
// rows made of whole 16-byte units at 16-byte-aligned addresses (the wrapper
// checks and raises); no tree row of any configuration is so made, so K3 is
// a probe kernel, off the main path. Design: a block of four warps, each
// owning two lanes; one elected thread per warp brings its lanes' live rows
// into shared memory by cp.async.bulk global->shared, all of them completing
// on one mbarrier (expect_tx of the sum of their bytes), waits on it, then
// writes them out by cp.async.bulk shared->global into their slots, commits
// them as one bulk group and waits for the group before it exits (the
// staging buffer dies with the block). Nothing is serialised across the
// warps of a block or across blocks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxArrays = 16;
constexpr int kWarp = 32;
constexpr int kLanesPerBlock = 8;  // K2: one warp per lane
constexpr int kBulkWarps = 4;      // K3: warps per block
constexpr int kBulkLanesPerWarp = 2;
constexpr int kBulkLaneBytes = 28 * 1024;  // K3: most row bytes a lane stages

struct RowSet {
  uint64_t dst[kMaxArrays];        // arr_i, byte address
  uint64_t src[kMaxArrays];        // rows_i, byte address
  int64_t row_bytes[kMaxArrays];   // bytes of one row of array i
  int T[kMaxArrays];               // slots of array i
  int unit_end[kMaxArrays];        // K2: prefix sum of each row's unit bound
  int stage_off[kMaxArrays];       // K3: offset of array i's row in a lane's stage
  int n;
  int units;                       // K2: unit_end[n - 1]
};

// ---------------------------------------------------------------------------
// K2
// ---------------------------------------------------------------------------

// One 16-byte destination unit of one row: the unit's bytes [lo, hi) are
// written, taken from v (its four words in destination order).
struct Unit {
  uint4 v;
  char* base;  // the unit's 16-byte-aligned address; nullptr: nothing to write
  int lo, hi;
};

// Loads unit j (numbered across the set's arrays) of lane b, slot w.
__device__ __forceinline__ Unit load_unit(const RowSet& s, int j, int b, int w) {
  Unit out;
  out.base = nullptr;
  out.lo = out.hi = 0;
  if (j >= s.units) return out;
  int i = 0;  // the number of arrays whose units all lie below j
#pragma unroll
  for (int step = kMaxArrays / 2; step >= 1; step >>= 1)
    if (i + step <= s.n && s.unit_end[i + step - 1] <= j) i += step;
  if (w >= s.T[i]) return out;
  const int u = j - (i > 0 ? s.unit_end[i - 1] : 0);
  const uint64_t rb = static_cast<uint64_t>(s.row_bytes[i]);
  const uint64_t d = s.dst[i] + (static_cast<uint64_t>(b) * s.T[i] + w) * rb;
  const uint64_t src = s.src[i] + static_cast<uint64_t>(b) * rb;
  const uint64_t a = (d & ~uint64_t(15)) + 16ull * u;
  const uint64_t lo = a > d ? a : d;
  const uint64_t hi = a + 16 < d + rb ? a + 16 : d + rb;
  if (lo >= hi) return out;
  out.base = reinterpret_cast<char*>(a);
  out.lo = static_cast<int>(lo - a);
  out.hi = static_cast<int>(hi - a);
  const uint64_t q = a + (src - d);  // source address of the unit's byte 0
  if (out.lo == 0 && out.hi == 16 && (q & 15) == 0) {
    out.v = *reinterpret_cast<const uint4*>(q);
    return out;
  }
  // Word k holds source bytes [qw + 4k, qw + 4k + 4), which land on the
  // unit's bytes [4k - sh, 4k - sh + 4); only words with a byte in [lo, hi)
  // are read.
  const uint64_t qw = q & ~uint64_t(3);
  const int sh = static_cast<int>(q & 3);
  uint32_t wd[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const int first = 4 * k - sh;
    wd[k] = (first < out.hi && first + 4 > out.lo)
                ? *reinterpret_cast<const uint32_t*>(qw + 4 * k) : 0u;
  }
  out.v.x = __funnelshift_r(wd[0], wd[1], 8 * sh);
  out.v.y = __funnelshift_r(wd[1], wd[2], 8 * sh);
  out.v.z = __funnelshift_r(wd[2], wd[3], 8 * sh);
  out.v.w = __funnelshift_r(wd[3], wd[4], 8 * sh);
  return out;
}

__device__ __forceinline__ void store_unit(const Unit& u) {
  if (u.base == nullptr) return;
  if (u.lo == 0 && u.hi == 16) {
    *reinterpret_cast<uint4*>(u.base) = u.v;
    return;
  }
  const uint32_t words[4] = {u.v.x, u.v.y, u.v.z, u.v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int lo = u.lo > 4 * k ? u.lo : 4 * k;
    const int hi = u.hi < 4 * k + 4 ? u.hi : 4 * k + 4;
    if (lo >= hi) continue;
    if (lo == 4 * k && hi == 4 * k + 4) {
      *reinterpret_cast<uint32_t*>(u.base + 4 * k) = words[k];
      continue;
    }
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      if (4 * k + p >= lo && 4 * k + p < hi)
        u.base[4 * k + p] = static_cast<char>(words[k] >> (8 * p));
    }
  }
}

__global__ void __launch_bounds__(kLanesPerBlock * kWarp)
write_rows_kernel(const __grid_constant__ RowSet set, const int* __restrict__ widx, int B) {
  // The descriptor in shared memory: threads index it by array, and a
  // kernel parameter indexed per thread is read one address at a time.
  __shared__ RowSet s;
  const int b = blockIdx.x * kLanesPerBlock + threadIdx.x / kWarp;
  const int w = b < B ? widx[b] : -1;  // in flight during the copy
  static_assert(sizeof(RowSet) % 4 == 0, "the descriptor is copied in words");
  for (int k = threadIdx.x; k < static_cast<int>(sizeof(RowSet) / 4); k += blockDim.x)
    reinterpret_cast<uint32_t*>(&s)[k] = reinterpret_cast<const uint32_t*>(&set)[k];
  __syncthreads();
  if (w < 0) return;
  for (int j = threadIdx.x % kWarp; j < s.units; j += 2 * kWarp) {
    const Unit u0 = load_unit(s, j, b, w);
    const Unit u1 = load_unit(s, j + kWarp, b, w);
    store_unit(u0);
    store_unit(u1);
  }
}

// ---------------------------------------------------------------------------
// K3
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__global__ void __launch_bounds__(kBulkWarps * kWarp)
write_rows_bulk_kernel(const __grid_constant__ RowSet s, const int* __restrict__ widx,
                       int B, int lane_bytes) {
  extern __shared__ __align__(16) unsigned char stage[];
  __shared__ __align__(8) uint64_t bar[kBulkWarps];
  if (threadIdx.x % kWarp != 0) return;  // one elected thread per warp copies
  const int warp = threadIdx.x / kWarp;
  const int b0 = (blockIdx.x * kBulkWarps + warp) * kBulkLanesPerWarp;
  int slot[kBulkLanesPerWarp];
  uint32_t tx = 0;
#pragma unroll
  for (int j = 0; j < kBulkLanesPerWarp; ++j) {
    slot[j] = b0 + j < B ? widx[b0 + j] : -1;
    for (int i = 0; i < s.n; ++i)
      if (slot[j] >= 0 && slot[j] < s.T[i]) tx += static_cast<uint32_t>(s.row_bytes[i]);
  }
  if (tx == 0) return;
  const uint32_t mbar = smem_addr(&bar[warp]);
  const uint32_t lanes = smem_addr(stage) +
                         static_cast<uint32_t>(warp * kBulkLanesPerWarp * lane_bytes);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(mbar) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(mbar), "r"(tx) : "memory");
#pragma unroll
  for (int j = 0; j < kBulkLanesPerWarp; ++j) {
    for (int i = 0; i < s.n; ++i) {
      if (slot[j] < 0 || slot[j] >= s.T[i]) continue;
      const uint64_t src = s.src[i] + static_cast<uint64_t>(b0 + j) * s.row_bytes[i];
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n"
          :: "r"(lanes + j * lane_bytes + s.stage_off[i]), "l"(src),
             "r"(static_cast<uint32_t>(s.row_bytes[i])), "r"(mbar)
          : "memory");
    }
  }
  uint32_t ready = 0;
  while (!ready) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ready) : "r"(mbar), "r"(0u) : "memory");
  }
#pragma unroll
  for (int j = 0; j < kBulkLanesPerWarp; ++j) {
    for (int i = 0; i < s.n; ++i) {
      if (slot[j] < 0 || slot[j] >= s.T[i]) continue;
      const uint64_t dst = s.dst[i] +
          (static_cast<uint64_t>(b0 + j) * s.T[i] + slot[j]) * s.row_bytes[i];
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
                   :: "l"(dst), "r"(lanes + j * lane_bytes + s.stage_off[i]),
                      "r"(static_cast<uint32_t>(s.row_bytes[i]))
                   : "memory");
    }
  }
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  // Complete, not only read: the block's shared memory is freed on exit.
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Fills the descriptor; false if the set is empty or too large.
bool make_set(RowSet* s, int n, const uint64_t* dst, const uint64_t* src,
              const int64_t* row_bytes, const int* T) {
  if (n < 1 || n > kMaxArrays) return false;
  *s = RowSet{};
  s->n = n;
  int units = 0, off = 0;
  for (int i = 0; i < n; ++i) {
    if (row_bytes[i] < 0 || row_bytes[i] > (1 << 24) || T[i] < 0) return false;
    s->dst[i] = dst[i];
    s->src[i] = src[i];
    s->row_bytes[i] = row_bytes[i];
    s->T[i] = T[i];
    units += static_cast<int>((row_bytes[i] + 30) / 16);  // ceil((row + 15) / 16)
    s->unit_end[i] = units;
    s->stage_off[i] = off;
    off += static_cast<int>(row_bytes[i]);
  }
  s->units = units;
  return true;
}

}  // namespace

extern "C" int azt_scatter_rows(int n, const uint64_t* dst, const uint64_t* src,
                                const int64_t* row_bytes, const int* T,
                                const void* widx, int B, void* stream) {
  RowSet s;
  if (!make_set(&s, n, dst, src, row_bytes, T)) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (B + kLanesPerBlock - 1) / kLanesPerBlock;
  write_rows_kernel<<<blocks, kLanesPerBlock * kWarp, 0, static_cast<cudaStream_t>(stream)>>>(
      s, static_cast<const int*>(widx), B);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int azt_scatter_rows_bulk(int n, const uint64_t* dst, const uint64_t* src,
                                     const int64_t* row_bytes, const int* T,
                                     const void* widx, int B, void* stream) {
  RowSet s;
  if (!make_set(&s, n, dst, src, row_bytes, T)) return static_cast<int>(cudaErrorInvalidValue);
  int lane_bytes = 0;
  for (int i = 0; i < n; ++i) {
    if (row_bytes[i] % 16) return static_cast<int>(cudaErrorInvalidValue);
    lane_bytes += static_cast<int>(row_bytes[i]);
  }
  if (lane_bytes > kBulkLaneBytes) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = kBulkWarps * kBulkLanesPerWarp * lane_bytes;
  static int opted_in = 48 * 1024;  // dynamic shared memory allowed so far
  if (smem > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        write_rows_bulk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kBulkWarps * kBulkLanesPerWarp * kBulkLaneBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = kBulkWarps * kBulkLanesPerWarp * kBulkLaneBytes;
  }
  const int lanes_per_block = kBulkWarps * kBulkLanesPerWarp;
  const int blocks = (B + lanes_per_block - 1) / lanes_per_block;
  write_rows_bulk_kernel<<<blocks, kBulkWarps * kWarp, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      s, static_cast<const int*>(widx), B, lane_bytes);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* azt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
