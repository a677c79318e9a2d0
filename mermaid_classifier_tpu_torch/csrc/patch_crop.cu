// Patch crop + normalize for Hopper (sm_90a).
//
// Replaces the Pallas kernel extract_patches_pallas
// (mermaid_classifier_tpu/experiments/pallas_crop.py:72, body _crop_kernel
// :45). For each point p with start (r, c) it writes
//   out[p, i, j, ch] = x * scale[ch] + bias[ch],
//   x = image[r - pad + i, c - pad + j, ch], 0 outside [0, H) x [0, W),
// as f32 or bf16 in (P, ps, ps, 3) layout. With pad = ps // 2 the raw
// image gives the centered crop of the zero-padded image, so no padded copy
// is built anywhere; with pad = 0 a caller's padded image is cropped as is.
//
// Bound on the H100: device memory. Per call it writes P*ps*ps*3 outputs
// (4 or 2 bytes each) and reads at most the in-image bytes the crops cover;
// there is no arithmetic to speak of. Design:
// - A group is 8 adjacent pixels of one patch row: 24 source bytes, 24
//   outputs. 24 is a multiple of the channel period 3, so a thread's scale
//   and bias pattern is fixed at compile time.
// - The groups are numbered in output order and walked flat, so the output
//   of consecutive groups is contiguous. Each thread takes
//   kGroupsPerThread groups kThreads apart and starts the loads of all of
//   them before it converts any.
// - Loads: the aligned 16-byte words that cover the group's 24 bytes (2 or
//   3 of them), read only where they hold bytes of the image row, then
//   shifted into place in registers (word select, then a funnel shift) and
//   masked to zero for pixels outside the image. A zero pixel still goes
//   through the affine, as the plain version's padded zero does.
// - Stores (vector instance: ps % 8 == 0 and a 16-byte-aligned output):
//   each warp stages its 32 groups' outputs in shared memory and stores
//   them as contiguous 16-byte words, 512 bytes per warp instruction, with
//   the streaming (evict-first) hint: the patches are written once and
//   read once, by the trunk's stem. The scalar instance stores element by
//   element with the row tail masked.
// The affine is __fmul_rn then __fadd_rn (no FMA contraction) and bf16 is
// round-to-nearest-even, so the output equals the plain PyTorch
// x.float() * scale + bias bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPix = 8;                // pixels per group
constexpr int kOut = 3 * kPix;         // bytes in = outputs out per group
constexpr int kGroupsPerThread = 2;

struct Affine {
  float s0, s1, s2, b0, b1, b2;
};

// A group's source words, fetched ahead of their use.
struct Fetch {
  uint4 w[3];       // aligned words from a0 = (address of byte 0) & ~15
  unsigned shift;   // address of byte 0 - a0, 0..15
  unsigned valid;   // bit k: pixel k lies inside the image
};

__device__ __forceinline__ Fetch fetch(const uint8_t* image, int h, int w,
                                       int y, int x0) {
  Fetch f;
  f.w[0] = f.w[1] = f.w[2] = make_uint4(0u, 0u, 0u, 0u);
  f.shift = 0;
  const int lo = max(0, -x0);
  const int hi = min(kPix, w - x0);
  f.valid = (y >= 0 && y < h && lo < hi)
                ? ((1u << hi) - 1u) & ~((1u << lo) - 1u) : 0u;
  if (f.valid) {
    const intptr_t a = reinterpret_cast<intptr_t>(image) +
                       (intptr_t)y * w * 3 + (intptr_t)x0 * 3;
    const intptr_t a0 = a & ~(intptr_t)15;
    const intptr_t first = a + 3 * lo, last = a + 3 * hi;
    f.shift = (unsigned)(a - a0);
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      const intptr_t wa = a0 + 16 * m;
      if (wa < last && wa + 16 > first) {
        f.w[m] = __ldg(reinterpret_cast<const uint4*>(wa));
      }
    }
  }
  return f;
}

// The group's 24 bytes as 6 little-endian words, zero outside the image.
__device__ __forceinline__ void extract(const Fetch& f, uint32_t (&o)[6]) {
  const uint32_t u[12] = {f.w[0].x, f.w[0].y, f.w[0].z, f.w[0].w,
                          f.w[1].x, f.w[1].y, f.w[1].z, f.w[1].w,
                          f.w[2].x, f.w[2].y, f.w[2].z, f.w[2].w};
  const unsigned q = f.shift >> 2, sh = (f.shift & 3u) * 8u;
  uint32_t v[7];
#pragma unroll
  for (int k = 0; k < 7; ++k) {
    v[k] = q == 0 ? u[k] : q == 1 ? u[k + 1] : q == 2 ? u[k + 2] : u[k + 3];
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) o[k] = __funnelshift_r(v[k], v[k + 1], sh);
  if (f.valid != (1u << kPix) - 1u) {
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      uint32_t keep = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        if ((f.valid >> ((4 * k + b) / 3)) & 1u) keep |= 0xffu << (8 * b);
      }
      o[k] &= keep;
    }
  }
}

__device__ __forceinline__ void affine(const uint32_t (&o)[6], const Affine& t,
                                       float (&y)[kOut]) {
#pragma unroll
  for (int j = 0; j < kOut; ++j) {
    const float x = (float)((o[j >> 2] >> (8 * (j & 3))) & 0xffu);
    const float s = j % 3 == 0 ? t.s0 : (j % 3 == 1 ? t.s1 : t.s2);
    const float b = j % 3 == 0 ? t.b0 : (j % 3 == 1 ? t.b1 : t.b2);
    y[j] = __fadd_rn(__fmul_rn(x, s), b);
  }
}

// Outputs as 32-bit words: 24 f32, or 12 pairs of bf16.
template <typename OutT>
struct Words;
template <>
struct Words<float> {
  static constexpr int kCount = kOut;
  __device__ static uint32_t get(const float (&y)[kOut], int k) {
    return __float_as_uint(y[k]);
  }
};
template <>
struct Words<__nv_bfloat16> {
  static constexpr int kCount = kOut / 2;
  __device__ static uint32_t get(const float (&y)[kOut], int k) {
    const __nv_bfloat162 pair = __floats2bfloat162_rn(y[2 * k], y[2 * k + 1]);
    return *reinterpret_cast<const uint32_t*>(&pair);
  }
};

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename OutT, bool kVec>
__global__ void __launch_bounds__(kThreads) crop_kernel(
    const uint8_t* __restrict__ image, int h, int w,
    const int* __restrict__ starts, int ps, int pad, int groups_per_row,
    int n_groups, Affine t, OutT* __restrict__ out) {
  constexpr int kWords = Words<OutT>::kCount;  // 32-bit words per group
  __shared__ uint4 stage[kVec ? kWarps : 1][kVec ? 32 * kWords / 4 : 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int base = blockIdx.x * kThreads * kGroupsPerThread + threadIdx.x;

  Fetch f[kGroupsPerThread] = {};
  int row[kGroupsPerThread], gx[kGroupsPerThread];
#pragma unroll
  for (int k = 0; k < kGroupsPerThread; ++k) {
    const int g = base + k * kThreads;
    row[k] = g / groups_per_row;
    gx[k] = g - row[k] * groups_per_row;
    if (g < n_groups) {
      const int p = row[k] / ps, i = row[k] - p * ps;
      f[k] = fetch(image, h, w, __ldg(starts + 2 * p) - pad + i,
                   __ldg(starts + 2 * p + 1) - pad + gx[k] * kPix);
    }
  }

#pragma unroll
  for (int k = 0; k < kGroupsPerThread; ++k) {
    const int g = base + k * kThreads;
    uint32_t o[6];
    float y[kOut];
    extract(f[k], o);
    affine(o, t, y);
    if constexpr (kVec) {
      // Group g's outputs start at element 24 g (ps % 8 == 0), so the
      // warp's 32 groups are one contiguous run of 32 * 24 outputs.
      if (g < n_groups) {
        uint4* mine = &stage[warp][lane * (kWords / 4)];
#pragma unroll
        for (int m = 0; m < kWords / 4; ++m) {
          mine[m] = make_uint4(Words<OutT>::get(y, 4 * m),
                               Words<OutT>::get(y, 4 * m + 1),
                               Words<OutT>::get(y, 4 * m + 2),
                               Words<OutT>::get(y, 4 * m + 3));
        }
      }
      __syncwarp();
      const int g0 = g - lane;
      const int live = min(32, n_groups - g0);
      uint4* dst = reinterpret_cast<uint4*>(out + (size_t)g0 * kOut);
      for (int e = lane; e < live * (kWords / 4); e += 32) {
        __stcs(dst + e, stage[warp][e]);
      }
      __syncwarp();
    } else if (g < n_groups) {
      const int n_pix = min(kPix, ps - gx[k] * kPix);
      OutT* dst = out + ((size_t)row[k] * ps + gx[k] * kPix) * 3;
#pragma unroll
      for (int j = 0; j < kOut; ++j) {
        if (j < 3 * n_pix) store1(dst + j, y[j]);
      }
    }
  }
}

template <typename OutT>
cudaError_t launch(bool vec, dim3 grid, cudaStream_t stream,
                   const uint8_t* image, int h, int w, const int* starts,
                   int ps, int pad, int gpr, int n_groups, Affine t,
                   OutT* out) {
  if (vec) {
    crop_kernel<OutT, true><<<grid, kThreads, 0, stream>>>(
        image, h, w, starts, ps, pad, gpr, n_groups, t, out);
  } else {
    crop_kernel<OutT, false><<<grid, kThreads, 0, stream>>>(
        image, h, w, starts, ps, pad, gpr, n_groups, t, out);
  }
  return cudaGetLastError();
}

}  // namespace

// The vector instance is taken when every group is whole (ps % 8 == 0) and
// the output is 16-byte aligned; the caller validates the starts against
// the image padded by `pad` on each side.
extern "C" int mct_patch_crop(
    const void* image, int h, int w, const void* starts, int n_points,
    int patch_size, int pad, float s0, float s1, float s2, float b0, float b1,
    float b2, void* out, int out_bf16, void* stream) {
  if (n_points == 0) return 0;
  const int gpr = (patch_size + kPix - 1) / kPix;
  const long long n_groups = (long long)n_points * patch_size * gpr;
  const long long per_block = (long long)kThreads * kGroupsPerThread;
  if (patch_size < 1 || n_groups > 0x7fffffffLL - per_block) {
    return (int)cudaErrorInvalidValue;
  }
  const bool vec = patch_size % kPix == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & 15u) == 0;
  const dim3 grid((unsigned)((n_groups + per_block - 1) / per_block));
  const Affine t{s0, s1, s2, b0, b1, b2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* img = static_cast<const uint8_t*>(image);
  const int* st_ptr = static_cast<const int*>(starts);
  return (int)(out_bf16
      ? launch(vec, grid, st, img, h, w, st_ptr, patch_size, pad, gpr,
               (int)n_groups, t, static_cast<__nv_bfloat16*>(out))
      : launch(vec, grid, st, img, h, w, st_ptr, patch_size, pad, gpr,
               (int)n_groups, t, static_cast<float*>(out)));
}

extern "C" const char* mct_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
