// Tromp-Taylor area scoring of a batch of Go boards (K4), in one launch.
//
// For each board b of int8 [B, N, N] (+1 black, -1 white, 0 empty; N <= 32)
// whose mask byte is set (every board when there is no mask), out f32 [3, B]
// gets
//
//     out[0, b] = black stones + empty points whose region touches black only
//     out[1, b] = white stones + empty points whose region touches white only
//     out[2, b] = (out[0, b] - out[1, b]) - komi
//
// and a board outside the mask gets 0 in all three. A region is a connected
// set of empty points; dead stones are not removed. Every count is a small
// integer and komi an x.5 or an integer, so each value is exact in float32,
// and the score is computed with the same two roundings in the same order as
// the plain version (GoEngine.area_counts_plain and GoEngine.score,
// alpha_zero_tpu_torch/envs/go.py): the kernel is bit-equal to it.
//
// K4 replaces no TPU kernel: the JAX package scores in plain XLA. It was added
// because the plain version, run on the card inside every engine step of the
// search, was the largest block of device idle time in both benchmark cells:
// a host read of how many lanes need a score, then ~550-800 small whole-batch
// kernels (label sweeps of ~24 kernels each) with a torch.equal host read
// after every sweep past the first dozen, to decide when the region labels
// have settled. K4 scores only the lanes whose mask is set, decides on the
// card when the regions are complete, and reads nothing back to the host.
//
// What bounds it on an H100: the launch. It reads B * N * N board bytes and B
// mask bytes and writes 12 bytes a lane: 0.34 MB at go9 (B=4096, N=9), 0.1 us
// at 3.35 TB/s, and 0.19 MB at go19 (B=512, N=19). A board's work is a few
// dozen instructions a step over as many steps as its widest region needs, so
// its time is the launch floor (~1.7 us with every lane masked out) plus the
// slowest board's steps.
//
// Design, one warp per board, kBoards boards a block, the board as bitmasks:
// - The warp reads its lane's mask byte (one broadcast load); a lane outside
//   the mask writes its three zeros and leaves, having read nothing else.
// - The board is staged in shared memory by coalesced byte loads, then thread
//   r (r < N) packs row r into three 32-bit masks: empty, black and white
//   points, bit c for column c.
// - Instead of labelling regions, the warp grows two sets of empty points at
//   once: those that reach a black stone through empty points and those that
//   reach a white one. A region touches black exactly when its points are in
//   the first set, so this gives the regions' two touch bits point by point.
//   Each step dilates both sets by one point (shifts within the row,
//   __shfl_up/down_sync for the rows above and below) and keeps the empty
//   points; the warp stops when a vote (__any_sync) finds no thread's rows
//   changed. No round count and no host read: a board takes as many steps as
//   the farthest empty point is from the stones its region touches (4-6 in
//   the median of played positions at go9 and go19; 90 on a 19x19 serpentine
//   region reached from one end).
// - Each thread counts its row with popc (stones of a colour, plus empty
//   points in that colour's set and not the other's), a warp reduction
//   (redux.sync) sums the rows, and thread 0 writes the lane.
// Measured against region labelling by union-find in shared memory (atomicMin
// hooks, one pass, so also no host read), on the card in turns (PERF.md,
// section 6): the union-find took 42 and 124 us a call at go9 B=4096 and
// go19 B=512 (21 and 68 us with path halving), this design 4.6 and 7.9 us.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kBoards = 4;  // boards (warps) a block
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSide = 32;  // a row is one 32-bit mask and one thread
constexpr int8_t kEmpty = 0, kBlack = 1, kWhite = -1;

// x with every point's four neighbours added; thread r holds row r.
__device__ __forceinline__ unsigned grow(unsigned x, int row) {
  unsigned above = __shfl_up_sync(kFull, x, 1);
  unsigned below = __shfl_down_sync(kFull, x, 1);
  if (row == 0) above = 0;
  if (row == kWarp - 1) below = 0;
  return x | (x << 1) | (x >> 1) | above | below;
}

__global__ void __launch_bounds__(kWarp * kBoards)
score_area_kernel(const int8_t* __restrict__ board, const uint8_t* __restrict__ mask,
                  int B, int N, float komi, float* __restrict__ out) {
  __shared__ int8_t staged[kBoards][kMaxSide * kMaxSide];
  const int warp = threadIdx.x / kWarp;
  const int row = threadIdx.x % kWarp;
  const int b = blockIdx.x * kBoards + warp;
  if (b >= B) return;  // the whole warp
  if (mask != nullptr && mask[b] == 0) {
    if (row == 0) {
      out[b] = 0.0f;
      out[B + b] = 0.0f;
      out[2 * B + b] = 0.0f;
    }
    return;
  }
  const int cells = N * N;
  int8_t* stone = staged[warp];
  const int8_t* src = board + static_cast<size_t>(b) * cells;
#pragma unroll 4
  for (int p = row; p < cells; p += kWarp) stone[p] = src[p];
  __syncwarp();

  unsigned empty = 0, black = 0, white = 0;  // rows past N stay 0
  if (row < N) {
    const int8_t* points = stone + row * N;
#pragma unroll 4
    for (int c = 0; c < N; ++c) {
      const int8_t v = points[c];
      empty |= static_cast<unsigned>(v == kEmpty) << c;
      black |= static_cast<unsigned>(v == kBlack) << c;
      white |= static_cast<unsigned>(v == kWhite) << c;
    }
  }

  // Empty points that reach a black (white) stone through empty points.
  unsigned reach_black = grow(black, row) & empty;
  unsigned reach_white = grow(white, row) & empty;
  for (;;) {
    const unsigned next_black = grow(reach_black, row) & empty;
    const unsigned next_white = grow(reach_white, row) & empty;
    const bool changed = next_black != reach_black || next_white != reach_white;
    reach_black = next_black;
    reach_white = next_white;
    if (!__any_sync(kFull, changed)) break;
  }

  int black_area = __popc(black) + __popc(reach_black & ~reach_white);
  int white_area = __popc(white) + __popc(reach_white & ~reach_black);
  black_area = __reduce_add_sync(kFull, black_area);
  white_area = __reduce_add_sync(kFull, white_area);
  if (row == 0) {
    const float fb = static_cast<float>(black_area), fw = static_cast<float>(white_area);
    out[b] = fb;
    out[B + b] = fw;
    out[2 * B + b] = __fsub_rn(__fsub_rn(fb, fw), komi);
  }
}

}  // namespace

// board: int8 [B, N, N]; mask: bool [B] or null (every board); out: f32
// [3, B]. Returns a cudaError_t.
extern "C" int azt_score_area(const void* board, const void* mask, int B, int N,
                              float komi, void* out, void* stream) {
  if (B == 0) return 0;
  if (N < 1 || N > kMaxSide) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (B + kBoards - 1) / kBoards;
  score_area_kernel<<<blocks, kWarp * kBoards, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(board), static_cast<const uint8_t*>(mask), B, N, komi,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* azt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
