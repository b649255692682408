// Eval-mode BatchNorm with its ReLU and residual add, in one pass over NHWC (K5).
//
// For bf16 activations laid out NHWC (channels innermost: P = B * H * W rows of
// C channels) and a BatchNorm's float32 weight, bias, running mean and running
// variance, each variant writes what the plain eval chain on the card computes
// (F.batch_norm in eval mode, torch.relu, the bf16 `+`), bit for bit:
//
//     kNormRelu     out = relu(bn(x))                        (a)
//     kNormAddRelu  out = relu(bn(x) + res)                  (b)
//     kAddNormRelu  sum = x + res; out = relu(bn(sum))       (c), sum written too
//
// where bn(x) = fma(gamma * (x - mean), invstd, beta) with invstd =
// rsqrtf(var + eps), each element in float32 and rounded to bf16 once: the
// bits of PyTorch's eval kernel on NCHW and NHWC memory alike, whose
// multiply-add its compiler contracts into one fma (written out here, since
// every kernel of the repository builds with -fmad=false) and whose invstd is
// CUDA's rsqrtf (measured on the card against the candidate formulas: every
// other order of the operations, or 1 / sqrtf, differs in some elements). A
// sum is bf16 + bf16 in float32 rounded to bf16 once; relu keeps NaN and
// takes everything else at or below zero, -0 too, to +0.
//
// K5 replaces no TPU kernel: the JAX package leaves BatchNorm, ReLU and the
// residual add to XLA, which fuses them into the convolutions' epilogues. It
// was added because on the card the eval net ran them as three separate passes
// over device memory between two convolutions, each conv also wrapped in
// cuDNN's NCHW <-> NHWC transposes: together 55-75% of the net's device time
// in the self-play cells (PERF.md, section 5).
//
// What bounds it on an H100: bytes. Every variant reads each input element once
// and writes each output once: 4 bytes an element for (a), 6 for (b) and 8 for
// (c). At go19_jumbo (B=512, 361 points, 256 channels) an activation is 94.6 MB,
// so (a) takes at least 56 us at 3.35 TB/s.
//
// Design:
// - Loads and stores are 16-byte vectors of 8 channels. A block is a whole
//   number of rows of C / 8 vectors, and the grid stride is a whole number of
//   blocks, so each thread stays on one group of 8 channels for the whole
//   launch: it reads its 8 channels' gamma, mean, beta and variance once and
//   computes their invstd once, in registers. No shared memory.
// - Grid-stride over rows, kUnroll rows in flight a thread (all loads first,
//   then the arithmetic and the stores), with as many blocks as fill every SM
//   at full occupancy, or fewer when P is small: at B=1 the launch is a few
//   blocks, each thread one vector.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Mode : int { kNormRelu = 0, kNormAddRelu = 1, kAddNormRelu = 2 };

constexpr int kVec = 8;           // bf16 channels in a 16-byte vector
constexpr int kMaxThreads = 256;  // a block holds floor(256 / (C / 8)) rows
constexpr int kUnroll = 4;        // rows in flight a thread
constexpr int kMaxGroups = 256;   // C / 8 <= 256: C <= 2048

__device__ __forceinline__ float lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(v)));
}

// A float rounded to bf16 and read back as float.
__device__ __forceinline__ float round_bf16(float v) {
  return __uint_as_float(bf16_bits(v) << 16);
}

__device__ __forceinline__ float relu(float v) {
  return (v > 0.0f || v != v) ? v : 0.0f;
}

__device__ __forceinline__ uint32_t pack(float a, float b) {
  return bf16_bits(a) | (bf16_bits(b) << 16);
}

// One 16-byte vector of 8 bf16 channels as 4 words; each word holds two
// channels, the lower one in its low half.
struct Words {
  uint32_t w[4];
};

__device__ __forceinline__ Words words(uint4 v) { return {{v.x, v.y, v.z, v.w}}; }

template <int kMode>
__global__ void __launch_bounds__(kMaxThreads)
norm_act_kernel(const uint4* __restrict__ x, const uint4* __restrict__ res,
                const float* __restrict__ weight, const float* __restrict__ bias,
                const float* __restrict__ mean, const float* __restrict__ var, float eps,
                long long rows, int groups, int rows_per_block, uint4* __restrict__ out,
                uint4* __restrict__ sum_out) {
  const int g = threadIdx.x % groups;  // this thread's channels: 8g .. 8g + 7
  float gamma[kVec], mu[kVec], invstd[kVec], beta[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const int c = g * kVec + i;
    gamma[i] = weight[c];
    mu[i] = mean[c];
    beta[i] = bias[c];
    invstd[i] = rsqrtf(__fadd_rn(var[c], eps));
  }
  const long long stride = static_cast<long long>(gridDim.x) * rows_per_block;
  for (long long row = static_cast<long long>(blockIdx.x) * rows_per_block + threadIdx.x / groups;
       row < rows; row += kUnroll * stride) {
    uint4 xv[kUnroll], rv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = row + u * stride;
      if (r < rows) {
        xv[u] = x[r * groups + g];
        if (kMode != kNormRelu) rv[u] = res[r * groups + g];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = row + u * stride;
      if (r >= rows) break;
      const Words xw = words(xv[u]);
      const Words rw = kMode == kNormRelu ? Words{} : words(rv[u]);
      Words ow, sw;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float v[2] = {lo(xw.w[k]), hi(xw.w[k])};
        const float rf[2] = {lo(rw.w[k]), hi(rw.w[k])};
        if (kMode == kAddNormRelu) {
          v[0] = round_bf16(__fadd_rn(v[0], rf[0]));
          v[1] = round_bf16(__fadd_rn(v[1], rf[1]));
          sw.w[k] = pack(v[0], v[1]);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 2 * k + h;
          float y = round_bf16(
              __fmaf_rn(__fmul_rn(gamma[i], __fsub_rn(v[h], mu[i])), invstd[i], beta[i]));
          if (kMode == kNormAddRelu) y = round_bf16(__fadd_rn(y, rf[h]));
          v[h] = relu(y);
        }
        ow.w[k] = pack(v[0], v[1]);
      }
      out[r * groups + g] = make_uint4(ow.w[0], ow.w[1], ow.w[2], ow.w[3]);
      if (kMode == kAddNormRelu && sum_out != nullptr)
        sum_out[r * groups + g] = make_uint4(sw.w[0], sw.w[1], sw.w[2], sw.w[3]);
    }
  }
}

// Blocks of `threads` that fill every SM of `device` at the kernel's occupancy.
template <int kMode>
long long resident_blocks(int device, int threads) {
  static int per_sm[64][kMaxThreads + 1] = {};
  static int sms[64] = {};
  if (device < 0 || device >= 64) return 132;
  int& n = per_sm[device][threads];
  if (n == 0 &&
      (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, norm_act_kernel<kMode>, threads, 0) !=
           cudaSuccess || n < 1))
    n = 1;
  int& m = sms[device];
  if (m == 0 &&
      (cudaDeviceGetAttribute(&m, cudaDevAttrMultiProcessorCount, device) != cudaSuccess || m < 1))
    m = 132;
  return static_cast<long long>(n) * m;
}

template <int kMode>
void launch(const void* x, const void* res, const void* weight, const void* bias,
            const void* mean, const void* var, float eps, long long rows, int groups,
            void* out, void* sum_out, int device, cudaStream_t stream) {
  const int rows_per_block = kMaxThreads / groups;
  const int threads = rows_per_block * groups;
  const long long wanted = (rows + rows_per_block - 1) / rows_per_block;
  const long long full = resident_blocks<kMode>(device, threads);
  const int blocks = static_cast<int>(wanted < full ? wanted : full);
  norm_act_kernel<kMode><<<blocks, threads, 0, stream>>>(
      static_cast<const uint4*>(x), static_cast<const uint4*>(res),
      static_cast<const float*>(weight), static_cast<const float*>(bias),
      static_cast<const float*>(mean), static_cast<const float*>(var), eps, rows, groups,
      rows_per_block, static_cast<uint4*>(out), static_cast<uint4*>(sum_out));
}

}  // namespace

// mode: 0 (a), 1 (b) or 2 (c). x, res, out, sum_out: bf16 [rows, C] (NHWC),
// 16-byte aligned; res null for mode 0; sum_out null unless mode 2 keeps the
// sum. weight, bias, mean, var: f32 [C]. C % 8 == 0 and C <= 2048. Returns a
// cudaError_t.
extern "C" int azt_norm_act(int mode, const void* x, const void* res, const void* weight,
                            const void* bias, const void* mean, const void* var, float eps,
                            long long rows, int channels, void* out, void* sum_out, int device,
                            void* stream) {
  if (rows == 0) return 0;
  const int groups = channels / kVec;
  if (channels % kVec != 0 || groups < 1 || groups > kMaxGroups || mode < 0 || mode > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == kNormRelu)
    launch<kNormRelu>(x, res, weight, bias, mean, var, eps, rows, groups, out, sum_out, device, s);
  else if (mode == kNormAddRelu)
    launch<kNormAddRelu>(x, res, weight, bias, mean, var, eps, rows, groups, out, sum_out, device,
                         s);
  else
    launch<kAddNormRelu>(x, res, weight, bias, mean, var, eps, rows, groups, out, sum_out, device,
                         s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* azt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
