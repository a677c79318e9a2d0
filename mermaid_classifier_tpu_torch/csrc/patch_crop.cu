// Patch crop + normalize for Hopper (sm_90a).
//
// Replaces the Pallas kernel extract_patches_pallas
// (mermaid_classifier_tpu/experiments/pallas_crop.py:72, body _crop_kernel
// :45). For each point p it reads the ps x ps x 3 window of the zero-padded
// uint8 image at starts[p] and writes x * scale[ch] + bias[ch] as f32 or
// bf16, in (P, ps, ps, 3) layout.
//
// Bound on the H100: device memory. Per call it reads P*ps*ps*3 bytes and
// writes P*ps*ps*3*(4 or 2) bytes; there is no arithmetic to speak of.
// Design: one block per (point, band of patch rows); the threads of a block
// walk the contiguous ps*3 bytes of a patch row, so reads and writes are
// coalesced along the row whatever the offset. Arbitrary (unaligned) offsets
// are the plain case here — the Mosaic tile-alignment limit of the TPU
// kernel does not exist on this card. The affine is __fmul_rn then
// __fadd_rn (no FMA contraction) and bf16 is __float2bfloat16_rn, so the
// output equals the plain PyTorch x.float() * scale + bias bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerBlock = 8;
constexpr int kThreads = 256;

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads) crop_kernel(
    const uint8_t* __restrict__ image, int wp3,
    const int* __restrict__ starts, int ps,
    float s0, float s1, float s2, float b0, float b1, float b2,
    OutT* __restrict__ out) {
  const int p = blockIdx.x;
  const int row0 = blockIdx.y * kRowsPerBlock;
  const int r = starts[2 * p];
  const int c = starts[2 * p + 1];
  const int row_len = ps * 3;
  const int row_end = min(row0 + kRowsPerBlock, ps);
  for (int i = row0; i < row_end; ++i) {
    const uint8_t* src = image + (size_t)(r + i) * wp3 + (size_t)c * 3;
    OutT* dst = out + ((size_t)p * ps + i) * row_len;
    for (int j = threadIdx.x; j < row_len; j += kThreads) {
      const int ch = j % 3;
      const float s = ch == 0 ? s0 : (ch == 1 ? s1 : s2);
      const float b = ch == 0 ? b0 : (ch == 1 ? b1 : b2);
      store(dst + j, __fadd_rn(__fmul_rn((float)src[j], s), b));
    }
  }
}

}  // namespace

extern "C" int mct_patch_crop(
    const void* image, int wp, const void* starts, int n_points,
    int patch_size, float s0, float s1, float s2, float b0, float b1,
    float b2, void* out, int out_bf16, void* stream) {
  // Offsets are validated against the padded shape by the caller.
  if (n_points == 0) return 0;
  dim3 grid(n_points, (patch_size + kRowsPerBlock - 1) / kRowsPerBlock);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* img = static_cast<const uint8_t*>(image);
  const int* st_ptr = static_cast<const int*>(starts);
  if (out_bf16) {
    crop_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        img, wp * 3, st_ptr, patch_size, s0, s1, s2, b0, b1, b2,
        static_cast<__nv_bfloat16*>(out));
  } else {
    crop_kernel<float><<<grid, kThreads, 0, st>>>(
        img, wp * 3, st_ptr, patch_size, s0, s1, s2, b0, b1, b2,
        static_cast<float*>(out));
  }
  return (int)cudaGetLastError();
}

extern "C" const char* mct_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
