// Batched PUCT descent from the root of every search tree (MCTS select).
//
// Replaces the TPU kernel alpha_zero_tpu/ops/tree_kernels.py:_select_kernel
// and computes what its plain PyTorch version,
// alpha_zero_tpu_torch/ops/tree_kernels.py:select_leaf_plain, computes, bit
// for bit: the same expression tree per score, IEEE logf/sqrtf/division, no
// multiply-add contraction (the build passes -fmad=false and the scores use
// __fmul_rn/__fadd_rn/__fdiv_rn), and an argmax that keeps the first maximum.
//
// What bounds it on an H100: not bytes. One call must read the six [B, T]
// node vectors and one child_P row [A] per descent step, and write the two
// [B, T] path masks -- 7.5 MB at go9 (B=1024, T=201, A=82), 2.25 us at
// 3.35 TB/s. The time is latency: each lane is a serial chain -- stage its
// tree, then per step score cur's children, wait for cur's child_P row,
// argmax, look up the child -- and the call lasts as long as its deepest
// lane's chain (8 steps on post-search go9 trees). With few warps on an SM
// every dependent instruction costs its full latency, so the design cuts
// the instructions on that chain and spreads the per-slot work of a lane
// over four warps.
//
// Design, one block of four warps per lane (game):
// - Staging: the six [T] vectors and the root's child_P row go to shared
//   memory with 4-byte cp.async, all in flight at once (a lane's rows start
//   only 4-byte aligned, so neither 16-byte copies nor TMA apply).
// - Once per slot, by all four warps: q = W / max(N, 1) (the plain version's
//   q_t, the same bits), 1 + N, max(P, 0), and the slot's pb_c and sqrt(N)
//   for when the descent reaches it, so a step computes no log, square root
//   or q.
// - Child lists: the slots are grouped by parent into a CSR in shared memory
//   (count with shared atomics, block prefix sum, fill); each entry carries
//   (slot, action) and the three values its score needs, so a step reads one
//   16-byte entry per child of cur instead of scanning T slots. Each child
//   writes its score and a (step tag, slot) word at its action in an [A]
//   table that is tagged with the step, never cleared.
// - The descent, on warp 0: as soon as the argmax has found the child, the
//   child's child_P row is copied with cp.async into the other half of a
//   double buffer, so that round trip overlaps the move to the child and the
//   scoring of its children; everything else the next step needs of the
//   child is loaded at once.
// - Argmax, without branches: each thread keeps the first maximum of its
//   actions as an order-preserving uint32 key (-0.0 canonicalised to +0.0,
//   so -0.0 ties +0.0 as in the plain argmax; NaN above everything, as
//   torch.argmax); redux.sync takes the warp's max key, then the smallest
//   action holding it. child and p_sel come from shared memory, with no
//   global read.
// - One launch per call: the block writes every output -- the whole even
//   and odd rows from shared-memory marks, and hit_terminal.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 4;  // per lane; the descent runs on warp 0
constexpr int kThreads = kWarp * kWarps;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSlotUnroll = 2;  // slots a thread has in flight (go9: T <= 2 * 128)
constexpr int kActUnroll = 3;   // actions a thread scores at once (go9: A <= 3 * 32)
constexpr int kSlotBits = 16;   // slot | action << 16; a tag word is (step + 1) << 16 | slot
constexpr unsigned kSlotMask = (1u << kSlotBits) - 1u;
constexpr size_t kDefaultSmem = 48 * 1024;  // more needs the opt-in attribute
constexpr size_t kMaxSmem = 227 * 1024;
constexpr int kMaxDevices = 64;

// Shared memory of one lane in 4-byte words: the child list [T] of 16-byte
// entries; the [A] table of 8-byte (score, tag) entries; N, W, P, parent,
// action, done [T]; the child_P row double buffer [2][A]; pb_c, sqrt(N) and
// the list ends [T]; even and odd marks, one byte per slot each.
__host__ __device__ __forceinline__ size_t lane_words(int T, int A) {
  const size_t t = static_cast<size_t>(T), a = static_cast<size_t>(A);
  return 13 * t + 4 * a + (2 * t + 3) / 4;
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// x as an index in [0, n) when it is exactly one, else -1.
__device__ __forceinline__ int slot_of(float x, int n) {
  const int i = __float2int_rz(x);
  return (i >= 0 && i < n && static_cast<float>(i) == x) ? i : -1;
}

// The uint32 key whose order is the float order of s, with -0.0 == +0.0
// (s + 0.0 is +0.0 for both) and NaN above everything, as in torch.argmax.
__device__ __forceinline__ unsigned order_key(float s) {
  const unsigned u = __float_as_uint(__fadd_rn(s, 0.0f));
  const unsigned key = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return s != s ? 0xffffffffu : key;
}

__global__ void __launch_bounds__(kThreads, 8)
select_leaf_kernel(const float* __restrict__ node_N,
                   const float* __restrict__ node_W,
                   const float* __restrict__ node_P,
                   const float* __restrict__ parent_index,
                   const float* __restrict__ action_from_parent,
                   const float* __restrict__ node_done,
                   const float* __restrict__ child_P, int B, int T, int A,
                   int path_cap, float c_puct_base, float c_puct_init,
                   int* __restrict__ ints, uint8_t* __restrict__ hit,
                   float* __restrict__ masks) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int warp_sums[kWarps];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane_tid = tid % kWarp;
  const int warp = tid / kWarp;

  float4* sList = reinterpret_cast<float4*>(smem);       // [T] child entries by parent
  uint2* sTable = reinterpret_cast<uint2*>(sList + T);   // [A] (score, tag | slot)
  float* sN = reinterpret_cast<float*>(sTable + A);      // [T] each
  float* sW = sN + T;
  float* sP = sW + T;
  float* sPar = sP + T;
  float* sAct = sPar + T;
  float* sDone = sAct + T;
  float* sRow = sDone + T;                               // [2][A]
  float* sPb = sRow + 2 * A;                             // [T] pb_c of each slot
  float* sSq = sPb + T;                                  // [T] sqrt(N)
  int* sEnd = reinterpret_cast<int*>(sSq + T);           // [T] end of each list
  uint8_t* sEven = reinterpret_cast<uint8_t*>(sEnd + T); // [T] path marks
  uint8_t* sOdd = sEven + T;

  // 1. Stage the six [T] vectors and the root's prior row.
  const size_t row = static_cast<size_t>(b) * T;
  const float* lane_child_P = child_P + row * A;
  for (int t = tid; t < T; t += kThreads) {
    cp_async4(sN + t, node_N + row + t);
    cp_async4(sW + t, node_W + row + t);
    cp_async4(sP + t, node_P + row + t);
    cp_async4(sPar + t, parent_index + row + t);
    cp_async4(sAct + t, action_from_parent + row + t);
    cp_async4(sDone + t, node_done + row + t);
  }
  for (int a = tid; a < A; a += kThreads) cp_async4(sRow + a, lane_child_P + a);
  cp_async_commit();
  for (int t = tid; t < T; t += kThreads) sEnd[t] = 0;
  for (int w = tid; w < (2 * T + 3) / 4; w += kThreads) reinterpret_cast<unsigned*>(sEven)[w] = 0u;
  for (int a = tid; a < A; a += kThreads) sTable[a] = make_uint2(0u, 0u);
  cp_async_wait_all();
  __syncthreads();

  // 2. Per slot, in place: N -> 1 + N, W -> -q, P -> max(P, 0); pb_c and
  //    sqrt(N); par -> the listed parent (or -1), act -> slot | action << 16.
  //    A slot is listed when its parent is a slot and its action lies in
  //    [0, A); each listed slot counts one child of its parent. Loads first,
  //    so that a thread's slots overlap their round trips.
  for (int t0 = tid; t0 < T; t0 += kSlotUnroll * kThreads) {
    float n[kSlotUnroll], w[kSlotUnroll], p[kSlotUnroll], par[kSlotUnroll], act[kSlotUnroll];
#pragma unroll
    for (int j = 0; j < kSlotUnroll; ++j) {
      const int t = min(t0 + j * kThreads, T - 1);
      n[j] = sN[t];
      w[j] = sW[t];
      p[j] = sP[t];
      par[j] = sPar[t];
      act[j] = sAct[t];
    }
#pragma unroll
    for (int j = 0; j < kSlotUnroll; ++j) {
      const int t = t0 + j * kThreads;
      if (t >= T) break;
      sPb[t] = __fadd_rn(
          logf(__fdiv_rn(__fadd_rn(__fadd_rn(1.0f, n[j]), c_puct_base), c_puct_base)),
          c_puct_init);
      sSq[t] = sqrtf(n[j]);
      sN[t] = __fadd_rn(1.0f, n[j]);
      sW[t] = -__fdiv_rn(w[j], fmaxf(n[j], 1.0f));
      sP[t] = fmaxf(p[j], 0.0f);
      const int parent = slot_of(par[j], T);
      const int a = __float2int_rz(act[j]);
      const bool listed = parent >= 0 && a >= 0 && a < A;
      reinterpret_cast<int*>(sPar)[t] = listed ? parent : -1;
      reinterpret_cast<unsigned*>(sAct)[t] =
          static_cast<unsigned>(t) | static_cast<unsigned>(a) << kSlotBits;
      if (listed) atomicAdd(&sEnd[parent], 1);
    }
  }
  __syncthreads();

  // 3. Exclusive prefix sum of the counts: each thread scans a chunk, each
  //    warp its threads, then the warps' totals.
  {
    const int chunk = (T + kThreads - 1) / kThreads;
    const int lo = min(tid * chunk, T);
    const int hi = min(lo + chunk, T);
    int count = 0;
    for (int t = lo; t < hi; ++t) count += sEnd[t];
    int incl = count;
    for (int off = 1; off < kWarp; off <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, off);
      if (lane_tid >= off) incl += v;
    }
    if (lane_tid == kWarp - 1) warp_sums[warp] = incl;
    __syncthreads();
    int run = incl - count;
    for (int v = 0; v < warp; ++v) run += warp_sums[v];
    for (int t = lo; t < hi; ++t) {
      const int c = sEnd[t];
      sEnd[t] = run;
      run += c;
    }
  }
  __syncthreads();

  // 4. Fill. Each parent's start moves on to its end, which is the next
  //    parent's start: p's children are [p ? sEnd[p - 1] : 0, sEnd[p]).
  //    A thread issues its atomics before it stores its entries.
  {
    const int* sParent = reinterpret_cast<const int*>(sPar);
    const unsigned* sKey = reinterpret_cast<const unsigned*>(sAct);
    for (int t0 = tid; t0 < T; t0 += kSlotUnroll * kThreads) {
      int parent[kSlotUnroll], k[kSlotUnroll];
#pragma unroll
      for (int j = 0; j < kSlotUnroll; ++j) {
        const int t = t0 + j * kThreads;
        parent[j] = t < T ? sParent[t] : -1;
      }
#pragma unroll
      for (int j = 0; j < kSlotUnroll; ++j) {
        k[j] = parent[j] >= 0 ? atomicAdd(&sEnd[parent[j]], 1) : 0;
      }
#pragma unroll
      for (int j = 0; j < kSlotUnroll; ++j) {
        const int t = t0 + j * kThreads;
        if (parent[j] >= 0) {
          sList[k[j]] = make_float4(__uint_as_float(sKey[t]), sP[t], sN[t], sW[t]);
        }
      }
    }
  }
  __syncthreads();

  // 5. The descent, on warp 0.
  if (warp == 0) {
    int cur = 0;
    float pb_c = sPb[0];
    float sqrt_n = sSq[0];
    int first = 0;  // cur's children are sList[first, last)
    int last = sEnd[0];
    int action = -1;
    int child = -1;
    float p_sel = 0.0f;
    int depth = 0;
    bool stop = false;
    while (!stop && depth < path_cap) {
      const unsigned tag = static_cast<unsigned>(depth + 1) << kSlotBits;
      const float* p_row = sRow + (depth & 1) * A;

      // cur's children: -q + pb_c * max(P, 0) * (sqrt(n) / (1 + N)) at
      // their actions, left to right as in select_leaf_plain.
      for (int k = first + lane_tid; k < last; k += kWarp) {
        const float4 e = sList[k];
        const unsigned key = __float_as_uint(e.x);
        const float u = __fmul_rn(__fmul_rn(pb_c, e.y), __fdiv_rn(sqrt_n, e.z));
        sTable[key >> kSlotBits] =
            make_uint2(__float_as_uint(__fadd_rn(e.w, u)), tag | (key & kSlotMask));
      }
      cp_async_wait_all();  // cur's row
      __syncwarp();

      // Every action's score; each thread keeps the first maximum of its own.
      unsigned best_key = 0u;  // below every score's key
      int best_a = A;
      for (int a0 = lane_tid; a0 < A; a0 += kActUnroll * kWarp) {
        float p[kActUnroll];
        uint2 e[kActUnroll];
#pragma unroll
        for (int j = 0; j < kActUnroll; ++j) {
          const int a = min(a0 + j * kWarp, A - 1);
          p[j] = p_row[a];
          e[j] = sTable[a];
        }
#pragma unroll
        for (int j = 0; j < kActUnroll; ++j) {
          // A fresh action: -0.0 + pb_c * max(p, 0) * (sqrt(n) / 1), where
          // the division by 1 is exact and left out; an illegal one (prior
          // -1) -9999.
          const float fresh =
              __fadd_rn(-0.0f, __fmul_rn(__fmul_rn(pb_c, fmaxf(p[j], 0.0f)), sqrt_n));
          const float s = !(p[j] >= 0.0f)                  ? -9999.0f
                          : (e[j].y & ~kSlotMask) == tag ? __uint_as_float(e[j].x)
                                                           : fresh;
          const unsigned key = order_key(s);
          const int a = a0 + j * kWarp;
          const bool better = a < A && key > best_key;
          best_key = better ? key : best_key;
          best_a = better ? a : best_a;
        }
      }
      const unsigned top = __reduce_max_sync(kFull, best_key);
      action = static_cast<int>(
          __reduce_min_sync(kFull, best_key == top ? static_cast<unsigned>(best_a)
                                                   : static_cast<unsigned>(A)));
      const unsigned entry = sTable[action].y;
      p_sel = p_row[action];
      __syncwarp();  // every thread has read this step's table and row
      child = (entry & ~kSlotMask) == tag ? static_cast<int>(entry & kSlotMask) : -1;
      // All that the next step needs of the child, loaded at once.
      const int c = max(child, 0);
      const float done = sDone[c];
      const float next_pb = sPb[c];
      const float next_sqrt = sSq[c];
      const int next_first = sEnd[max(c - 1, 0)];
      const int next_last = sEnd[c];
      if (lane_tid == 0) ((depth & 1) ? sOdd : sEven)[cur] = 1;
      ++depth;
      // The child's row, before knowing whether the descent goes on: a
      // terminal child wastes the copy, which the wait below the loop covers.
      if (child >= 0 && depth < path_cap) {
        const float* src = lane_child_P + static_cast<size_t>(child) * A;
        float* dst = sRow + (depth & 1) * A;
        for (int a = lane_tid; a < A; a += kWarp) cp_async4(dst + a, src + a);
        cp_async_commit();
      }
      stop = child < 0 || done > 0.5f;
      if (!stop) {
        cur = child;
        pb_c = next_pb;
        sqrt_n = next_sqrt;
        first = child == 0 ? 0 : next_first;
        last = next_last;
      }
    }
    cp_async_wait_all();  // no copy may land after the block has left
    if (lane_tid == 0) {
      ints[b] = cur;
      ints[B + b] = action;
      ints[2 * B + b] = child;
      ints[3 * B + b] = depth;
      reinterpret_cast<float*>(ints)[4 * B + b] = p_sel;
      hit[b] = child >= 0;
    }
  }
  __syncthreads();

  // 6. The whole even/odd rows.
  float* even = masks + row;
  float* odd = masks + static_cast<size_t>(B) * T + row;
  for (int t = tid; t < T; t += kThreads) {
    even[t] = sEven[t] ? 1.0f : 0.0f;
    odd[t] = sOdd[t] ? 1.0f : 0.0f;
  }
}

}  // namespace

// ints: int32 [5, B] -- parent, action, child, depth, and p_sel's float bits;
// hit: bool [B]; masks: f32 [2, B, T] -- even, odd. Returns a cudaError_t.
extern "C" int azt_select_leaf(
    const void* node_N, const void* node_W, const void* node_P,
    const void* parent_index, const void* action_from_parent,
    const void* node_done, const void* child_P, int B, int T, int A,
    int path_cap, float c_puct_base, float c_puct_init, void* ints, void* hit,
    void* masks, int device, void* stream) {
  if (B == 0) return 0;
  const size_t smem = sizeof(float) * lane_words(T, A);
  if (T < 1 || T > static_cast<int>(kSlotMask) || A < 1 || A > static_cast<int>(kSlotMask) ||
      path_cap >= static_cast<int>(kSlotMask) || smem > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);

  // A lane that needs more than the default 48 KB gets the opt-in size, set
  // once per device and size (outside any graph capture: the first call at
  // a size runs before one).
  static size_t opted_in[kMaxDevices] = {};
  if (smem > kDefaultSmem && (device >= kMaxDevices || smem > opted_in[device])) {
    err = cudaFuncSetAttribute(select_leaf_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err == cudaSuccess && device < kMaxDevices) opted_in[device] = smem;
  }
  if (err == cudaSuccess) {
    select_leaf_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(node_N), static_cast<const float*>(node_W),
        static_cast<const float*>(node_P), static_cast<const float*>(parent_index),
        static_cast<const float*>(action_from_parent),
        static_cast<const float*>(node_done), static_cast<const float*>(child_P),
        B, T, A, path_cap, c_puct_base, c_puct_init, static_cast<int*>(ints),
        static_cast<uint8_t*>(hit), static_cast<float*>(masks));
    err = cudaGetLastError();
  }
  if (prev != device) cudaSetDevice(prev);
  return static_cast<int>(err);
}

extern "C" const char* azt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
