// Row scatter, one row per lane, in place: arr[b, widx[b], :] = rows[b, :]
// for every lane b with 0 <= widx[b] < T; every other byte of arr is left
// as it was. arr is f32 [B, T, W] contiguous, rows f32 [B, W], widx i32 [B].
//
// Two kernels compute this one function. Both move bytes and compute
// nothing, so they are bit-equal to the plain version
// (alpha_zero_tpu_torch/ops/scatter_kernels.py:blend_scatter) by
// construction.
//
// What bounds them on an H100: bytes, then launch latency. The function must
// read B rows and write B rows (plus widx): 1.05 MB at go9 (B=1024, W=128),
// 0.31 us at 3.35 TB/s -- less than the few microseconds a launch costs. So
// both kernels are launch-bound at the shapes the search uses; the designs
// keep every row write in flight at once and add no second pass.
//
// azt_scatter_rows replaces the TPU kernel tools/dma_probe.py:scatter_kernel,
// which starts one DMA per row and waits on it before the next. Hopper needs
// no such handshake: ordinary stores are already asynchronous, and the card
// keeps many rows in flight. Design: one warp per lane, eight lanes per
// 256-thread block (128 blocks at B=1024, about one wave on 132 SMs). Each
// warp reads its own widx[b] (no scalar prefetch) and copies the row with
// coalesced 4-byte loads and stores, so any W works, with no padding.
//
// azt_scatter_rows_bulk replaces tools/dma_probe.py:scatter_kernel_overlap,
// which starts all DMAs of a block before waiting on any. Its Hopper
// counterpart is the bulk-copy (TMA) unit: a block stages its lanes' rows in
// shared memory, makes them visible to the async proxy
// (fence.proxy.async.shared::cta, then __syncthreads), and one thread issues
// one cp.async.bulk shared->global copy per live lane, commits them as one
// group and waits for the group before the block exits (the staging buffer
// dies with the block). Bulk copies need 16-byte-aligned addresses and a
// size that is a multiple of 16, so this kernel takes W % 4 == 0 and
// 16-byte-aligned arr and rows only; the wrapper checks and raises. That is
// the counterpart of the TPU kernel's padding of W to a multiple of 128.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kLanesPerBlock = 8;
constexpr int kThreads = kLanesPerBlock * kWarp;

// widx[b] when it names a slot of the lane, else -1 (the lane writes nothing).
__device__ __forceinline__ int live_slot(const int* __restrict__ widx, int b,
                                         int B, int T) {
  if (b >= B) return -1;
  const int w = widx[b];
  return (w >= 0 && w < T) ? w : -1;
}

__global__ void scatter_rows_kernel(float* __restrict__ arr,
                                    const float* __restrict__ rows,
                                    const int* __restrict__ widx, int B, int T,
                                    int W) {
  const int b = blockIdx.x * kLanesPerBlock + threadIdx.x / kWarp;
  const int w = live_slot(widx, b, B, T);
  if (w < 0) return;
  float* dst = arr + (static_cast<size_t>(b) * T + w) * W;
  const float* src = rows + static_cast<size_t>(b) * W;
  for (int i = threadIdx.x % kWarp; i < W; i += kWarp) dst[i] = src[i];
}

__global__ void scatter_rows_bulk_kernel(float* __restrict__ arr,
                                         const float* __restrict__ rows,
                                         const int* __restrict__ widx, int B,
                                         int T, int W) {
  extern __shared__ float4 stage[];  // [kLanesPerBlock][W / 4]
  __shared__ int slot[kLanesPerBlock];
  const int warp = threadIdx.x / kWarp;
  const int tid = threadIdx.x % kWarp;
  const int b0 = blockIdx.x * kLanesPerBlock;
  const int b = b0 + warp;
  const int w4 = W / 4;

  // Warp j stages lane b0 + j's row, 16 bytes a thread, if the lane is live.
  const int w = live_slot(widx, b, B, T);
  if (w >= 0) {
    const float4* src = reinterpret_cast<const float4*>(rows) + static_cast<size_t>(b) * w4;
    float4* dst = stage + warp * w4;
    for (int i = tid; i < w4; i += kWarp) dst[i] = src[i];
  }
  if (tid == 0) slot[warp] = w;
  // Generic-proxy writes to shared memory become visible to the bulk-copy
  // unit only through this fence; without it a copy may read stale bytes.
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  if (threadIdx.x == 0) {
    bool issued = false;
    for (int j = 0; j < kLanesPerBlock; ++j) {
      if (slot[j] < 0) continue;
      float* dst = arr + (static_cast<size_t>(b0 + j) * T + slot[j]) * W;
      const uint32_t src = static_cast<uint32_t>(__cvta_generic_to_shared(stage + j * w4));
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
                   :: "l"(dst), "r"(src), "r"(static_cast<uint32_t>(W) * 4u)
                   : "memory");
      issued = true;
    }
    if (issued) {
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      // Complete, not only read: the block's shared memory is freed on exit.
      asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
    }
  }
}

}  // namespace

extern "C" int azt_scatter_rows(void* arr, const void* rows, const void* widx,
                                int B, int T, int W, void* stream) {
  const int blocks = (B + kLanesPerBlock - 1) / kLanesPerBlock;
  scatter_rows_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(arr), static_cast<const float*>(rows),
      static_cast<const int*>(widx), B, T, W);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int azt_scatter_rows_bulk(void* arr, const void* rows,
                                     const void* widx, int B, int T, int W,
                                     void* stream) {
  const size_t smem = sizeof(float) * kLanesPerBlock * static_cast<size_t>(W);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        scatter_rows_bulk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (B + kLanesPerBlock - 1) / kLanesPerBlock;
  scatter_rows_bulk_kernel<<<blocks, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(arr), static_cast<const float*>(rows),
      static_cast<const int*>(widx), B, T, W);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* azt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
