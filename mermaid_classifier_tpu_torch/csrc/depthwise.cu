// Stride-1 SAME k x k depthwise convolution plus per-channel bias over NHWC,
// for Hopper (sm_90a).
//
// Replaces the Pallas kernel depthwise_conv_pallas
// (mermaid_classifier_tpu/ops/depthwise.py:65, body _dw_kernel :43):
// out[n, y, x, c] = b[c] + sum over (dy, dx) of
// xpad[n, y + dy, x + dx, c] * w[dy, dx, c], with xpad the input zero-padded
// by p = (k - 1) / 2 on each spatial side. The accumulator is f32 and starts
// at the bias; taps are added in dy-major, dx-minor order as
// acc = fadd_rn(acc, fmul_rn(x, w)), so nvcc cannot contract them to FMAs
// and the result equals the plain PyTorch version
// (ops/depthwise.py:depthwise_conv_reference) bit for bit. x / out are f32 or
// bf16 (bf16 written with round-to-nearest-even); w (k, k, C) and b (C,) are
// f32.
//
// What bounds it on the H100: memory. Each output element needs 2*k*k FLOP
// (50 at k = 5) against one input and one output element of device memory
// (8 bytes at f32, 4 at bf16), below the ~20 FLOP per byte at which the
// f32 CUDA cores, not device memory, would be the limit. The design keeps
// device-memory traffic near one read of the input and one write of the
// output, with the taps' reuse served from shared memory:
//
//   one block per (row tile, 32 channels, map): it stages the tile's output
//   rows plus a p-row halo, p columns of zeros on each side, for its 32
//   channels as f32 in shared memory (each block writes its own zero halo,
//   so the host pads nothing), and the group's k*k taps beside them. One
//   thread per (position, channel): lane = channel, so every warp loads and
//   stores 32 neighbouring channels of one position (NHWC, coalesced), and
//   warps walk the tile's positions.
//
// The rows per tile come from the wrapper (ops/depthwise.py:rows_per_tile),
// which uses the same shared-memory formula as smem_floats below. The 2p
// halo rows of a tile are read again by its neighbour; vector loads and
// cp.async / TMA staging are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTC = 32;  // channels per block (one per lane)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}

// Shared-memory floats of one block with `rows` output rows. The Python
// wrapper (ops/depthwise.py:_smem_floats) uses the same formula.
inline int smem_floats(int rows, int w, int k) {
  const int p = (k - 1) / 2;
  return (rows + 2 * p) * (w + 2 * p) * kTC  // staged input tile with halo
         + k * k * kTC;                       // taps of the channel group
}

// K > 0 fixes the kernel size at compile time (3 and 5, the trunk's), so the
// tap loops unroll; K == 0 takes the runtime k for any other odd size.
template <typename T, int K>
__global__ void __launch_bounds__(kThreads) depthwise_kernel(
    const T* __restrict__ x, T* __restrict__ out, int h, int w, int c,
    int k_rt, const float* __restrict__ wdw, const float* __restrict__ bdw,
    int rows_per_tile) {
  extern __shared__ float smem[];
  const int k = K > 0 ? K : k_rt;
  const int p = (k - 1) / 2;
  const int y0 = blockIdx.x * rows_per_tile;
  const int c0 = blockIdx.y * kTC;
  const int n = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;

  const int th = min(rows_per_tile, h - y0);  // output rows of this tile
  const int xrows = th + 2 * p;
  const int wx = w + 2 * p;
  float* xs = smem;                                      // (xrows, wx, kTC)
  float* taps = xs + (rows_per_tile + 2 * p) * wx * kTC;  // (k*k, kTC)

  // Stage the tile with its zero halo; channels fastest, so consecutive
  // threads read consecutive channels of one position.
  const T* xn = x + (size_t)n * h * w * c;
  for (int i = tid; i < xrows * wx * kTC; i += kThreads) {
    const int ch = i % kTC;
    const int pos = i / kTC;
    const int y = y0 - p + pos / wx;
    const int xx = pos % wx - p;
    const int cg = c0 + ch;
    float v = 0.0f;
    if (cg < c && y >= 0 && y < h && xx >= 0 && xx < w) {
      v = to_f(xn[((size_t)y * w + xx) * c + cg]);
    }
    xs[i] = v;
  }
  for (int i = tid; i < k * k * kTC; i += kThreads) {
    const int cg = c0 + i % kTC;
    taps[i] = cg < c ? wdw[(size_t)(i / kTC) * c + cg] : 0.0f;
  }
  __syncthreads();

  const int cg = c0 + lane;
  if (cg >= c) return;  // no barrier follows
  const float b = bdw[cg];
  T* on = out + (size_t)n * h * w * c;
  for (int pos = warp; pos < th * w; pos += kWarps) {
    const int ty = pos / w, xx = pos % w;
    float acc = b;
#pragma unroll
    for (int dy = 0; dy < k; ++dy) {
      const float* row = xs + ((ty + dy) * wx + xx) * kTC + lane;
      const float* trow = taps + dy * k * kTC + lane;
#pragma unroll
      for (int dx = 0; dx < k; ++dx) {
        acc = __fadd_rn(acc, __fmul_rn(row[dx * kTC], trow[dx * kTC]));
      }
    }
    on[((size_t)(y0 + ty) * w + xx) * c + cg] = from_f<T>(acc);
  }
}

template <typename T, int K>
int launch(const void* xv, void* outv, int n, int h, int w, int c, int k,
           const float* wdw, const float* bdw, int rows_per_tile,
           cudaStream_t st) {
  const size_t smem = sizeof(float) * (size_t)smem_floats(rows_per_tile, w, k);
  cudaError_t err = cudaFuncSetAttribute(
      depthwise_kernel<T, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((h + rows_per_tile - 1) / rows_per_tile, (c + kTC - 1) / kTC, n);
  depthwise_kernel<T, K><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(xv), static_cast<T*>(outv), h, w, c, k, wdw, bdw,
      rows_per_tile);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_k(const void* x, void* out, int n, int h, int w, int c, int k,
             const float* wdw, const float* bdw, int rows_per_tile,
             cudaStream_t st) {
  if (k == 3) return launch<T, 3>(x, out, n, h, w, c, k, wdw, bdw, rows_per_tile, st);
  if (k == 5) return launch<T, 5>(x, out, n, h, w, c, k, wdw, bdw, rows_per_tile, st);
  return launch<T, 0>(x, out, n, h, w, c, k, wdw, bdw, rows_per_tile, st);
}

}  // namespace

extern "C" int mct_depthwise(const void* x, void* out, int act_bf16, int n,
                             int h, int w, int c, int k, const void* wdw,
                             const void* bdw, int rows_per_tile,
                             void* stream) {
  if (n == 0) return 0;
  if (rows_per_tile < 1 || k < 1 || k % 2 == 0) {
    return (int)cudaErrorInvalidValue;
  }
  const float* wf = static_cast<const float*>(wdw);
  const float* bf = static_cast<const float*>(bdw);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (act_bf16) {
    return launch_k<__nv_bfloat16>(x, out, n, h, w, c, k, wf, bf,
                                   rows_per_tile, st);
  }
  return launch_k<float>(x, out, n, h, w, c, k, wf, bf, rows_per_tile, st);
}
