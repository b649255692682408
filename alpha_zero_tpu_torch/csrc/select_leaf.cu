// Batched PUCT descent from the root of every search tree (MCTS select).
//
// Replaces the TPU kernel alpha_zero_tpu/ops/tree_kernels.py:_select_kernel
// and computes what alpha_zero_tpu_torch/search/mcts.py:_select_leaf (its
// plain PyTorch version) computes, bit for bit: the same expression tree per
// score, IEEE logf/sqrtf/division, no multiply-add contraction (the build
// passes -fmad=false and the scores use __fmul_rn/__fadd_rn/__fdiv_rn), and
// an argmax that keeps the first maximum.
//
// What bounds it on an H100: not bytes. One call must read the six [B, T]
// node vectors and one child_P row [A] per descent step, and write the two
// [B, T] path masks -- 7-10 MB at go9 (B=1024, T=201, A=82), 2-3 us at
// 3.35 TB/s. The descent itself is a serial chain of dependent steps per
// lane (find cur's children, score, argmax, move to the child), so latency,
// not bandwidth, sets the time.
//
// Design: one warp per lane (game), four lanes per block. The warp stages its
// lane's six [T] vectors in shared memory once, so every descent step reads
// them from shared memory. At each step the 32 threads scan parent_index ==
// cur over the T slots and write each child's score and slot id into a
// shared [A] array at the child's action ((parent, action) pairs are unique,
// so no two threads write one entry). Then they read only cur's child_P row
// from device memory (328 B at go9), score the unvisited actions from it,
// and take a warp argmax. The kernel allocates nothing: the caller zeroes the
// even/odd outputs.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarp = 32;
constexpr int kLanesPerBlock = 4;

__device__ __forceinline__ float puct_u(float pb_c, float prior, float sqrt_n,
                                        float denom) {
  // pb_c * max(P, 0) * (sqrt(n) / denom), left to right as in _select_leaf.
  return __fmul_rn(__fmul_rn(pb_c, fmaxf(prior, 0.0f)), __fdiv_rn(sqrt_n, denom));
}

__global__ void select_leaf_kernel(
    const float* __restrict__ node_N, const float* __restrict__ node_W,
    const float* __restrict__ node_P, const float* __restrict__ parent_index,
    const float* __restrict__ action_from_parent,
    const float* __restrict__ node_done, const float* __restrict__ child_P,
    int B, int T, int A, int path_cap, float c_puct_base, float c_puct_init,
    int* __restrict__ parent_out, int* __restrict__ action_out,
    int* __restrict__ child_out, int* __restrict__ depth_out,
    float* __restrict__ p_sel_out, float* __restrict__ even,
    float* __restrict__ odd) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / kWarp;
  const int tid = threadIdx.x % kWarp;
  const int b = blockIdx.x * kLanesPerBlock + warp;
  if (b >= B) return;  // the whole warp leaves; the block never syncs

  float* sN = smem + warp * (6 * T + 2 * A);
  float* sW = sN + T;
  float* sP = sW + T;
  float* sPar = sP + T;
  float* sAct = sPar + T;
  float* sDone = sAct + T;
  float* sScore = sDone + T;                          // [A] child scores
  int* sChild = reinterpret_cast<int*>(sScore + A);   // [A] child slot or -1

  const size_t row = static_cast<size_t>(b) * T;
  for (int t = tid; t < T; t += kWarp) {
    sN[t] = node_N[row + t];
    sW[t] = node_W[row + t];
    sP[t] = node_P[row + t];
    sPar[t] = parent_index[row + t];
    sAct[t] = action_from_parent[row + t];
    sDone[t] = node_done[row + t];
  }
  __syncwarp();

  const float* lane_child_P = child_P + row * A;
  int cur = 0;
  float n_cur = sN[0];
  int action = -1;
  int child = -1;
  float p_sel = 0.0f;
  int depth = 0;
  bool stop = false;

  while (!stop && depth < path_cap) {
    const float pb_c = __fadd_rn(
        logf(__fdiv_rn(__fadd_rn(__fadd_rn(1.0f, n_cur), c_puct_base), c_puct_base)),
        c_puct_init);
    const float sqrt_n = sqrtf(n_cur);

    for (int a = tid; a < A; a += kWarp) sChild[a] = -1;
    __syncwarp();
    const float cur_f = static_cast<float>(cur);
    for (int t = tid; t < T; t += kWarp) {
      if (sPar[t] == cur_f) {
        const float n = sN[t];
        const float q = __fdiv_rn(sW[t], fmaxf(n, 1.0f));
        const float u = puct_u(pb_c, sP[t], sqrt_n, __fadd_rn(1.0f, n));
        const int a = static_cast<int>(sAct[t]);
        sScore[a] = __fadd_rn(-q, u);
        sChild[a] = t;
      }
    }
    __syncwarp();

    // Score every action; keep the first maximum (jnp/torch argmax).
    const float* p_row = lane_child_P + static_cast<size_t>(cur) * A;
    float best = -INFINITY;
    int best_a = A;
    for (int a = tid; a < A; a += kWarp) {
      const float p = p_row[a];
      float s = -9999.0f;  // illegal (prior -1)
      if (p >= 0.0f) {
        s = sChild[a] >= 0 ? sScore[a]
                           : __fadd_rn(-0.0f, puct_u(pb_c, p, sqrt_n, 1.0f));
      }
      if (s > best) {
        best = s;
        best_a = a;
      }
    }
    for (int off = kWarp / 2; off > 0; off >>= 1) {
      const float other = __shfl_xor_sync(0xffffffffu, best, off);
      const int other_a = __shfl_xor_sync(0xffffffffu, best_a, off);
      if (other > best || (other == best && other_a < best_a)) {
        best = other;
        best_a = other_a;
      }
    }

    action = best_a;
    child = sChild[action];
    p_sel = p_row[action];
    const int child_c = min(max(child, 0), T - 1);
    const bool is_new = child < 0;
    stop = is_new || sDone[child_c] > 0.5f;
    if (tid == 0) (depth % 2 == 0 ? even : odd)[row + cur] = 1.0f;
    if (!stop) {
      cur = child_c;
      n_cur = sN[child_c];
    }
    ++depth;
    __syncwarp();  // every thread is done with sChild/sScore of this step
  }

  if (tid == 0) {
    parent_out[b] = cur;
    action_out[b] = action;
    child_out[b] = child;
    depth_out[b] = depth;
    p_sel_out[b] = p_sel;
  }
}

}  // namespace

extern "C" int azt_select_leaf(
    const void* node_N, const void* node_W, const void* node_P,
    const void* parent_index, const void* action_from_parent,
    const void* node_done, const void* child_P, int B, int T, int A,
    int path_cap, float c_puct_base, float c_puct_init, void* parent_out,
    void* action_out, void* child_out, void* depth_out, void* p_sel_out,
    void* even, void* odd, void* stream) {
  if (B == 0) return 0;
  const size_t smem = sizeof(float) * kLanesPerBlock * (6 * T + 2 * A);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        select_leaf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (B + kLanesPerBlock - 1) / kLanesPerBlock;
  select_leaf_kernel<<<blocks, kLanesPerBlock * kWarp, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(node_N), static_cast<const float*>(node_W),
      static_cast<const float*>(node_P), static_cast<const float*>(parent_index),
      static_cast<const float*>(action_from_parent),
      static_cast<const float*>(node_done), static_cast<const float*>(child_P),
      B, T, A, path_cap, c_puct_base, c_puct_init,
      static_cast<int*>(parent_out), static_cast<int*>(action_out),
      static_cast<int*>(child_out), static_cast<int*>(depth_out),
      static_cast<float*>(p_sel_out), static_cast<float*>(even),
      static_cast<float*>(odd));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* azt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
