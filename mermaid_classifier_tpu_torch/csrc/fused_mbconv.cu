// One stride-1 MBConv block over BN-folded weights, for Hopper (sm_90a).
//
// Replaces the Pallas kernel fused_mbconv
// (mermaid_classifier_tpu/ops/fused_mbconv.py:424, body _fused_block_kernel
// :265): 1x1 expand + bias + SiLU -> k x k depthwise (zero padding in the
// expanded domain) + bias + SiLU in f32 -> squeeze-excite (f32 spatial mean,
// FC + SiLU, FC + sigmoid) -> m = (d * e) cast to the activation type ->
// 1x1 project + bias (f32 accumulation) -> + residual in f32 -> cast.
// Activations x / out are f32 or bf16; weights and biases are f32.
//
// What bounds it on the H100. Over the 11 fusable blocks of B0 at 224 px and
// 128 patches, the two 1x1 products are 30.4 GMAC (60.9 GFLOP), the depthwise
// convs 3.1 GMAC, and the activations the block must read and write 134 MB in
// bf16. The tensor cores, the CUDA cores and the memory work at once, so a
// block's least time is the longest of its three times, and the 11 blocks
// take at least 0.10 ms in bf16: the depthwise at 67 TFLOP/s (f32 CUDA
// cores) bounds the 56^2, 28^2 and 14^2 k5 blocks, the products at 989
// TFLOP/s the others, and the bytes at 3.35 TB/s none. In f32 the products
// as split TF32 (3 x 60.9 GFLOP at 495 TFLOP/s) bound every block: 0.37 ms.
//
// The design. The TPU kernel keeps a patch's whole expanded map (up to
// 56*56*144) in 16 MB of VMEM. A Hopper block has at most 227 KB of shared
// memory, and the SE global mean couples the whole map, so the block is split
// at that mean into three launches:
//
//   1. expand_dw_kernel, one block per (row tile, 32 mid channels, patch):
//      stages the tile's input rows plus a p-row halo in shared memory (f32),
//      runs the expand as a tensor-core GEMM (M = staged positions in 16-row
//      warp slices, N = the 32 channels, K = Cin, masked to zero past Cin),
//      applies bias + SiLU + the activation-type rounding in the epilogue and
//      stores into a zero-padded map (each block writes its own halo zeros:
//      the expanded map is what is padded). Then the depthwise + bias + SiLU
//      in f32, each lane holding its channel's k*k taps and bias in
//      registers (k 3 and 5; another odd k reads its taps through L1); d
//      goes to an f32 scratch tensor and the tile's per-channel sums to a
//      (P, tiles, Cmid) buffer (no atomics).
//   2. se_kernel, one block per patch: reduces the partial sums, divides by
//      H*W, runs FC + SiLU and FC + sigmoid into e (P, Cmid).
//   3. project_kernel, one block per (64 out channels, 64 positions, patch):
//      stages m = cast_act(d * e) and the weights 32 mid channels at a time
//      in shared memory and runs the product on the tensor cores, each warp
//      a 16 x 32 tile; bias, f32 residual and the cast in the epilogue.
//      Out-channel tiles are the fastest grid index, so the blocks that read
//      one d tile run together and share it through L2.
//
// Both products use warp-level mma.sync. bf16 activations: m16n8k16 with
// bf16 operands (the activations are bf16 values already; the weights are
// rounded once with __float2bfloat16_rn) and f32 accumulation, as the TPU's
// MXU computes it. f32 activations: m16n8k8 TF32 in split precision, each
// operand a = hi + lo with hi = tf32(a), lo = tf32(a - hi), summing
// lo*hi + hi*lo + hi*hi, which keeps f32 accuracy at three times the
// tensor-core work. Fragments are read from the f32 shared-memory tiles and
// converted as they are loaded; row strides are padded so that those reads
// avoid bank conflicts.
//
// Still open: the f32 round trip of d through device memory (0.72 GB
// written and read back per 128-patch B0 chunk), the expand recomputed on
// the 2p halo rows of every tile, wgmma/TMA/cp.async staging, and bf16
// shared-memory tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTC = 32;   // mid channels per pass-1 block
constexpr int kZs = kTC + 1;  // floats per position of the padded map
constexpr int kPM = 64;   // positions per pass-3 block
constexpr int kPN = 64;   // out channels per pass-3 block
constexpr int kPK = 32;   // mid channels per pass-3 reduction step
constexpr int kLoads = 8;  // global loads in flight per thread when staging
constexpr int kR = 4;      // adjacent depthwise outputs per lane
// Pass-1 dynamic shared memory; ops/fused_mbconv.py:_PASS1_SMEM_BUDGET.
constexpr int kPass1SmemBudget = 110 * 1024;
constexpr int kMaxDevices = 64;

template <typename T>
constexpr bool is_bf16 = std::is_same<T, __nv_bfloat16>::value;

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
// Round an f32 value to the activation type and back.
template <typename T> __device__ __forceinline__ float round_act(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ float sigmoid_f(float v) {
  return 1.0f / (1.0f + expf(-v));
}
__device__ __forceinline__ float silu_f(float v) { return v * sigmoid_f(v); }
// SiLU with the fast exponential and division (a few ulp), for the
// per-element epilogues of pass 1.
__device__ __forceinline__ float silu_fast(float v) {
  return __fdividef(v, 1.0f + __expf(-v));
}

// Row strides (floats) of the f32 tiles the fragment loaders read. An A row
// (positions x K) is read in pairs (bf16) or singly (TF32) by lanes
// g = lane / 4 on rows and t = lane % 4 along K; a B tile (K x N, N
// contiguous) is read by t on rows and g on columns. These strides put
// every lane of a load on its own bank.
template <typename T> __host__ __device__ constexpr int a_stride(int k) {
  // bf16: stride = 8 (mod 16); TF32: stride = 4 (mod 8).
  return is_bf16<T> ? ((k + 7) / 16) * 16 + 8 : ((k + 3) / 8) * 8 + 4;
}
template <typename T> __host__ __device__ constexpr int b_stride(int n) {
  return n + (is_bf16<T> ? 4 : 8);  // n is a multiple of 32
}
// K depth of one mma: 16 for bf16, 8 for TF32.
template <typename T> constexpr int kDepth = is_bf16<T> ? 16 : 8;

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// Shared-memory floats pass 1 needs for a tile of `rows` output rows. The
// Python wrapper (ops/fused_mbconv.py:_pass1_smem_floats) uses the same
// formula to choose `rows`; mct_fused_pass1_smem_bytes below lets the card
// tests hold the two against each other.
template <typename T>
__host__ __device__ inline int pass1_smem_floats(int rows, int w, int cin,
                                                 int k) {
  const int p = (k - 1) / 2;
  const int zrows = rows + 2 * p;
  return zrows * w * a_stride<T>(cin)            // staged input rows
         + round_up(cin, 16) * b_stride<T>(kTC)  // expand weights, K padded
         + zrows * (w + 2 * p) * kZs             // padded expanded map
         + kWarps * kTC;                         // partial-sum reduction
}

// Store 16 bytes of activations as f32 at dst (16-byte aligned).
template <typename T> __device__ __forceinline__ void store_vec(float* dst,
                                                                uint4 v);
template <> __device__ __forceinline__ void store_vec<float>(float* dst,
                                                             uint4 v) {
  *reinterpret_cast<uint4*>(dst) = v;
}
template <> __device__ __forceinline__ void store_vec<__nv_bfloat16>(
    float* dst, uint4 v) {
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&v);
  float4* out = reinterpret_cast<float4*>(dst);
  const float2 f0 = __bfloat1622float2(b[0]), f1 = __bfloat1622float2(b[1]);
  const float2 f2 = __bfloat1622float2(b[2]), f3 = __bfloat1622float2(b[3]);
  out[0] = make_float4(f0.x, f0.y, f1.x, f1.y);
  out[1] = make_float4(f2.x, f2.y, f3.x, f3.y);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// v = hi + lo, each a TF32 value.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One warp: c[j] += A (16 x kend) * B (kend x 8) for the NT column tiles j.
// A's rows g and g + 8 of this lane start at a_lo / a_hi (f32, K
// contiguous); columns >= klim read as zero. B is f32 (kend x 8*NT), row
// stride ldb; rows below kend that lie past the true K must hold zeros.
// kend is a multiple of kDepth<T>. The C fragment of tile j: c[j][0..1] at
// row g, columns 8j + 2t + {0, 1}; c[j][2..3] at row g + 8.
template <typename T, int NT>
__device__ __forceinline__ void warp_mma(float (&c)[NT][4],
                                         const float* a_lo, const float* a_hi,
                                         int klim, int kend, const float* b,
                                         int ldb, int lane) {
  const int g = lane >> 2, t = lane & 3;
  if constexpr (is_bf16<T>) {
    for (int k0 = 0; k0 < kend; k0 += 16) {
      uint32_t a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kk = k0 + 2 * t + 8 * (i >> 1);
        const float2 v =
            *reinterpret_cast<const float2*>((i & 1 ? a_hi : a_lo) + kk);
        a[i] = pack_bf16(kk < klim ? v.x : 0.0f, kk + 1 < klim ? v.y : 0.0f);
      }
      const float* b0p = b + (k0 + 2 * t) * ldb + g;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float* bp = b0p + 8 * j;
        mma_bf16(c[j], a, pack_bf16(bp[0], bp[ldb]),
                 pack_bf16(bp[8 * ldb], bp[9 * ldb]));
      }
    }
  } else {
    for (int k0 = 0; k0 < kend; k0 += 8) {
      uint32_t ah[4], al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kk = k0 + t + 4 * (i >> 1);
        const float v = kk < klim ? (i & 1 ? a_hi : a_lo)[kk] : 0.0f;
        split_tf32(v, ah[i], al[i]);
      }
      const float* b0p = b + (k0 + t) * ldb + g;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(b0p[8 * j], bh0, bl0);
        split_tf32(b0p[8 * j + 4 * ldb], bh1, bl1);
        // The tensor core rounds its f32 sums toward zero; summing each
        // 8-deep step from zero and adding it to c on the CUDA cores
        // (round to nearest) keeps that error from growing with K.
        float s[4] = {};
        mma_tf32(s, al, bh0, bh1);
        mma_tf32(s, ah, bl0, bl1);
        mma_tf32(s, ah, bh0, bh1);
#pragma unroll
        for (int i = 0; i < 4; ++i) c[j][i] += s[i];
      }
    }
  }
}

// K: the depthwise kernel size, whose taps each lane holds in registers;
// K = 0 takes the odd size k at run time and reads the taps through L1.
template <typename T, int K>
__global__ void __launch_bounds__(kThreads) expand_dw_kernel(
    const T* __restrict__ x, int h, int w, int cin, int cmid, int k,
    const float* __restrict__ wexp,
    const float* __restrict__ bexp, const float* __restrict__ wdw,
    const float* __restrict__ bdw, float* __restrict__ d,
    float* __restrict__ partial, int rows_per_tile) {
  extern __shared__ __align__(16) float smem[];
  const int kk = K > 0 ? K : k;
  const int p = (kk - 1) / 2;
  const int tile = blockIdx.x;
  const int n_tiles = gridDim.x;
  const int c0 = blockIdx.y * kTC;
  const int n = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;

  const int y0 = tile * rows_per_tile;
  const int th = min(rows_per_tile, h - y0);
  const int zr0 = y0 - p;           // image row of z row 0
  const int zrows = th + 2 * p;
  const int wz = w + 2 * p;
  const int in_lo = max(zr0, 0);
  const int in_hi = min(zr0 + zrows, h);
  const int xst = a_stride<T>(cin);
  const int kpad = round_up(cin, 16);
  constexpr int wst = b_stride<T>(kTC);

  const int max_zrows = rows_per_tile + 2 * p;
  float* xs = smem;                              // (in rows * w, xst)
  float* ws = xs + max_zrows * w * xst;          // (kpad, wst)
  float* zs = ws + kpad * wst;                   // (zrows, wz, kZs)
  float* red = zs + max_zrows * wz * kZs;        // (kWarps, kTC)

  // Stage the tile's in-image input rows (one contiguous NHWC range) and
  // the channel tile's expand weights, zero past Cin and Cmid. Each thread
  // issues kLoads loads before it stores any, so that their latencies
  // overlap; 16-byte loads where the layout allows them (Cin a multiple of
  // the vector, Cmid of 4, aligned bases).
  const T* xsrc = x + ((size_t)n * h + in_lo) * w * cin;
  const int n_x = (in_hi - in_lo) * w * cin;
  constexpr int kV = 16 / sizeof(T);
  if (cin % kV == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0) {
    const uint4* src = reinterpret_cast<const uint4*>(xsrc);
    for (int i0 = tid; i0 < n_x / kV; i0 += kLoads * kThreads) {
      uint4 v[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int i = i0 + u * kThreads;
        if (i < n_x / kV) v[u] = src[i];
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int i = (i0 + u * kThreads) * kV, pos = i / cin;
        if (i < n_x) store_vec<T>(xs + pos * xst + i - pos * cin, v[u]);
      }
    }
  } else {
    for (int i0 = tid; i0 < n_x; i0 += kLoads * kThreads) {
      T v[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int i = i0 + u * kThreads;
        if (i < n_x) v[u] = xsrc[i];
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int i = i0 + u * kThreads, pos = i / cin;
        if (i < n_x) xs[pos * xst + i - pos * cin] = to_f(v[u]);
      }
    }
  }
  if (cmid % 4 == 0 && reinterpret_cast<uintptr_t>(wexp) % 16 == 0) {
    // Thread tid: channels c0 + 4 * (tid % 8) + 0..3 of rows tid / 8 + 32u.
    const int cc = 4 * (tid % 8), c = c0 + cc;
    for (int ci0 = tid / 8; ci0 < kpad; ci0 += kLoads * kThreads / 8) {
      float4 v[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int ci = ci0 + u * kThreads / 8;
        const float* src = wexp + (size_t)ci * cmid + c;
        v[u] = ci < cin && c < cmid ? *reinterpret_cast<const float4*>(src)
                                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int ci = ci0 + u * kThreads / 8;
        if (ci < kpad) *reinterpret_cast<float4*>(ws + ci * wst + cc) = v[u];
      }
    }
  } else {
    const int c = c0 + tid % kTC;  // the same channel for every u
    for (int ci0 = tid / kTC; ci0 < kpad; ci0 += kLoads * kWarps) {
      float v[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int ci = ci0 + u * kWarps;
        v[u] = ci < cin && c < cmid ? wexp[(size_t)ci * cmid + c] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int ci = ci0 + u * kWarps;
        if (ci < kpad) ws[ci * wst + tid % kTC] = v[u];
      }
    }
  }
  // Halo zeros: out-of-image rows, then the side columns of the others.
  const int top = in_lo - zr0, n_out_rows = zrows - (in_hi - in_lo);
  for (int i = tid; i < n_out_rows * wz * kTC; i += kThreads) {
    const int r = i / (wz * kTC), rest = i % (wz * kTC);
    const int zr = r < top ? r : in_hi - zr0 + r - top;
    zs[(zr * wz + rest / kTC) * kZs + rest % kTC] = 0.0f;
  }
  for (int i = tid; i < (in_hi - in_lo) * 2 * p * kTC; i += kThreads) {
    const int r = i / (2 * p * kTC), rest = i % (2 * p * kTC);
    const int col = rest / kTC, zx = col < p ? col : w + col;
    zs[((top + r) * wz + zx) * kZs + rest % kTC] = 0.0f;
  }
  __syncthreads();

  // Expand on the tensor cores, 16 staged positions per warp step; the
  // epilogue writes bias + SiLU, rounded to the activation type, into the
  // padded map (zeros for channels past Cmid).
  const int g = lane >> 2, t = lane & 3;
  const int m_all = (in_hi - in_lo) * w;
  float be[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = c0 + 8 * j + 2 * t + e;
      be[j][e] = c < cmid ? bexp[c] : 0.0f;
    }
  }
  const int kend = round_up(cin, kDepth<T>);
  for (int m0 = warp * 16; m0 < m_all; m0 += kWarps * 16) {
    float acc[4][4] = {};
    warp_mma<T, 4>(acc, xs + min(m0 + g, m_all - 1) * xst,
                   xs + min(m0 + g + 8, m_all - 1) * xst, cin, kend, ws, wst,
                   lane);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + g + 8 * half;
      if (m >= m_all) continue;
      float* dst = zs + ((top + m / w) * wz + m % w + p) * kZs;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cc = 8 * j + 2 * t + e;
          const float z = silu_fast(acc[j][2 * half + e] + be[j][e]);
          dst[cc] = c0 + cc < cmid ? round_act<T>(z) : 0.0f;
        }
      }
    }
  }
  __syncthreads();

  // Depthwise + bias + SiLU over the tile's own rows, f32 accumulation:
  // lane = channel, its taps in registers, warps walk positions.
  const int c = c0 + lane;
  const bool c_ok = c < cmid;
  const float bd = c_ok ? bdw[c] : 0.0f;
  float taps[K > 0 ? K * K : 1];
#pragma unroll
  for (int i = 0; i < K * K; ++i) {
    taps[i] = c_ok ? wdw[(size_t)i * cmid + c] : 0.0f;
  }
  float psum = 0.0f;
  float* dn = d + ((size_t)n * h + y0) * w * cmid + c;
  // kR adjacent outputs of a row per lane: each row of taps reads
  // kR + K - 1 map values once. Outputs past the row end are computed from
  // the next row's values and dropped.
  const int groups = (w + kR - 1) / kR;
  for (int item = warp; item < th * groups; item += kWarps) {
    const int ty = item / groups, x0 = (item - ty * groups) * kR;
    float acc[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) acc[r] = bd;
#pragma unroll
    for (int dy = 0; dy < kk; ++dy) {
      const float* zrow = zs + ((ty + dy) * wz + x0) * kZs + lane;
      if constexpr (K > 0) {
        float zv[kR + K - 1];
#pragma unroll
        for (int i = 0; i < kR + K - 1; ++i) zv[i] = zrow[i * kZs];
#pragma unroll
        for (int dx = 0; dx < K; ++dx) {
#pragma unroll
          for (int r = 0; r < kR; ++r) acc[r] += zv[r + dx] * taps[dy * K + dx];
        }
      } else {
        for (int dx = 0; dx < kk; ++dx) {
          const float tap =
              c_ok ? __ldg(wdw + (size_t)(dy * kk + dx) * cmid + c) : 0.0f;
#pragma unroll
          for (int r = 0; r < kR; ++r) acc[r] += zrow[(r + dx) * kZs] * tap;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const float dv = silu_fast(acc[r]);
      if (c_ok && x0 + r < w) {
        dn[(size_t)(ty * w + x0 + r) * cmid] = dv;
        psum += dv;
      }
    }
  }
  red[warp * kTC + lane] = psum;
  __syncthreads();
  if (tid < kTC && c0 + tid < cmid) {
    float s = 0.0f;
    for (int i = 0; i < kWarps; ++i) s += red[i * kTC + tid];
    partial[((size_t)n * n_tiles + tile) * cmid + c0 + tid] = s;
  }
}

__global__ void __launch_bounds__(kThreads) se_kernel(
    const float* __restrict__ partial, int n_tiles, int cmid, int cse, int hw,
    const float* __restrict__ wse1, const float* __restrict__ bse1,
    const float* __restrict__ wse2, const float* __restrict__ bse2,
    float* __restrict__ e) {
  extern __shared__ float smem[];
  float* s = smem;          // (cmid) spatial mean
  float* r = smem + cmid;   // (cse) reduced
  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  for (int c = tid; c < cmid; c += kThreads) {
    float acc = 0.0f;
    for (int t = 0; t < n_tiles; ++t) {
      acc += partial[((size_t)n * n_tiles + t) * cmid + c];
    }
    s[c] = acc / (float)hw;
  }
  __syncthreads();
  for (int j = warp; j < cse; j += kWarps) {
    float acc = 0.0f;
    for (int c = lane; c < cmid; c += 32) acc += s[c] * wse1[(size_t)c * cse + j];
    for (int off = 16; off > 0; off /= 2) {
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    }
    if (lane == 0) r[j] = silu_f(acc + bse1[j]);
  }
  __syncthreads();
  for (int c = tid; c < cmid; c += kThreads) {
    float acc = 0.0f;
    for (int j = 0; j < cse; ++j) acc += r[j] * wse2[(size_t)j * cmid + c];
    e[(size_t)n * cmid + c] = sigmoid_f(acc + bse2[c]);
  }
}

// Block tile kPM positions x kPN out channels; warp w takes rows
// 16 * (w % 4) and columns 32 * (w / 4).
template <typename T>
__global__ void __launch_bounds__(kThreads, 3) project_kernel(
    const T* __restrict__ x, const float* __restrict__ d,
    const float* __restrict__ e, const float* __restrict__ wproj,
    const float* __restrict__ bproj, T* __restrict__ out, int hw, int cin,
    int cmid, int cout, int residual) {
  constexpr int lda = a_stride<T>(kPK);
  constexpr int ldb = b_stride<T>(kPN);
  __shared__ __align__(16) float as[kPM * lda];  // m tile (positions, K)
  __shared__ float bs[kPK * ldb];                // weights (K, out channels)
  const int co0 = blockIdx.x * kPN;
  const int pos0 = blockIdx.y * kPM;
  const int n = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int g = lane >> 2, t = lane & 3;
  const int wm = 16 * (warp % 4), wn = 32 * (warp / 4);
  const bool active = pos0 + wm < hw && co0 + wn < cout;  // warp-uniform

  float acc[4][4] = {};
  // Staging map: thread tid takes m-tile rows tid / kPK + 8u at column
  // tid % kPK, and weight rows tid / kPN + 4u at column tid % kPN. The next
  // step's loads are issued before this step's products, so that their
  // latency hides behind the tensor-core work.
  constexpr int kAU = kPM * kPK / kThreads, kBU = kPK * kPN / kThreads;
  constexpr int kAR = kThreads / kPK, kBR = kThreads / kPN;
  const int a_col = tid % kPK, a_row = tid / kPK;
  const int b_col = tid % kPN, b_row = tid / kPN;
  const float* dn = d + (size_t)n * hw * cmid;
  const float* en = e + (size_t)n * cmid;
  float av[kAU], bv[kBU], ev;
  auto load = [&](int kc0) {
    const int cm = kc0 + a_col;
    ev = cm < cmid ? en[cm] : 0.0f;
#pragma unroll
    for (int u = 0; u < kAU; ++u) {
      const int gpos = pos0 + a_row + kAR * u;
      av[u] = gpos < hw && cm < cmid ? dn[(size_t)gpos * cmid + cm] : 0.0f;
    }
    const int co = co0 + b_col;
#pragma unroll
    for (int u = 0; u < kBU; ++u) {
      const int cmb = kc0 + b_row + kBR * u;
      bv[u] = cmb < cmid && co < cout ? wproj[(size_t)cmb * cout + co] : 0.0f;
    }
  };
  load(0);
  for (int kc0 = 0; kc0 < cmid; kc0 += kPK) {
#pragma unroll
    for (int u = 0; u < kAU; ++u) {
      as[(a_row + kAR * u) * lda + a_col] = round_act<T>(av[u] * ev);
    }
#pragma unroll
    for (int u = 0; u < kBU; ++u) bs[(b_row + kBR * u) * ldb + b_col] = bv[u];
    __syncthreads();
    if (kc0 + kPK < cmid) load(kc0 + kPK);
    if (active) {
      warp_mma<T, 4>(acc, as + (wm + g) * lda, as + (wm + g + 8) * lda, kPK,
                     kPK, bs + wn, ldb, lane);
    }
    __syncthreads();
  }
  if (!active) return;

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int gpos = pos0 + wm + g + 8 * half;
    if (gpos >= hw) continue;
    const size_t row = (size_t)n * hw + gpos;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int el = 0; el < 2; ++el) {
        const int co = co0 + wn + 8 * j + 2 * t + el;
        if (co >= cout) continue;
        float y = acc[j][2 * half + el] + bproj[co];
        if (residual) y += to_f(x[row * cin + co]);
        out[row * cout + co] = from_f<T>(y);
      }
    }
  }
}

// Raise pass 1's dynamic shared-memory limit to the budget once per kernel
// instance and device.
template <typename Kernel>
cudaError_t allow_pass1_smem(Kernel kernel, bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kPass1SmemBudget);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

template <typename T, int K>
int launch(const void* xv, void* outv, int n, int h, int w, int cin,
           int cmid, int cout, int cse, int k, int residual,
           const float* wexp, const float* bexp, const float* wdw,
           const float* bdw, const float* wse1, const float* bse1,
           const float* wse2, const float* bse2, const float* wproj,
           const float* bproj, float* d, float* partial, float* e,
           int rows_per_tile, cudaStream_t st) {
  static bool smem_set[kMaxDevices] = {};
  const T* x = static_cast<const T*>(xv);
  T* out = static_cast<T*>(outv);
  const int n_tiles = (h + rows_per_tile - 1) / rows_per_tile;
  const size_t smem1 =
      sizeof(float) * (size_t)pass1_smem_floats<T>(rows_per_tile, w, cin, k);
  if (smem1 > (size_t)kPass1SmemBudget) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_pass1_smem(expand_dw_kernel<T, K>, smem_set);
  if (err != cudaSuccess) return (int)err;

  dim3 grid1(n_tiles, (cmid + kTC - 1) / kTC, n);
  expand_dw_kernel<T, K><<<grid1, kThreads, smem1, st>>>(
      x, h, w, cin, cmid, k, wexp, bexp, wdw, bdw, d, partial, rows_per_tile);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const size_t smem2 = sizeof(float) * (size_t)(cmid + cse);
  se_kernel<<<n, kThreads, smem2, st>>>(partial, n_tiles, cmid, cse, h * w,
                                         wse1, bse1, wse2, bse2, e);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  dim3 grid3((cout + kPN - 1) / kPN, (h * w + kPM - 1) / kPM, n);
  project_kernel<T><<<grid3, kThreads, 0, st>>>(
      x, d, e, wproj, bproj, out, h * w, cin, cmid, cout, residual);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mct_fused_mbconv(
    const void* x, void* out, int act_bf16, int n, int h, int w, int cin,
    int cmid, int cout, int cse, int k, int residual, const void* wexp,
    const void* bexp, const void* wdw, const void* bdw, const void* wse1,
    const void* bse1, const void* wse2, const void* bse2, const void* wproj,
    const void* bproj, void* d, void* partial, void* e, int rows_per_tile,
    void* stream) {
  if (n == 0) return 0;
  if (rows_per_tile < 1 || k < 1 || k % 2 == 0) {
    return (int)cudaErrorInvalidValue;
  }
  auto f = [](const void* ptr) { return static_cast<const float*>(ptr); };
  // Taps in registers for EfficientNet's k 3 and 5; any other odd k reads
  // them through L1.
  auto run = act_bf16 ? (k == 3   ? &launch<__nv_bfloat16, 3>
                         : k == 5 ? &launch<__nv_bfloat16, 5>
                                  : &launch<__nv_bfloat16, 0>)
                      : (k == 3   ? &launch<float, 3>
                         : k == 5 ? &launch<float, 5>
                                  : &launch<float, 0>);
  return run(x, out, n, h, w, cin, cmid, cout, cse, k, residual, f(wexp),
             f(bexp), f(wdw), f(bdw), f(wse1), f(bse1), f(wse2), f(bse2),
             f(wproj), f(bproj), static_cast<float*>(d),
             static_cast<float*>(partial), static_cast<float*>(e),
             rows_per_tile, static_cast<cudaStream_t>(stream));
}

// Pass 1's dynamic shared memory in bytes for a tile of `rows` output rows,
// and the budget it must fit; ops/fused_mbconv.py mirrors both to choose
// the rows, and the card tests hold that copy against these.
extern "C" int mct_fused_pass1_smem_bytes(int act_bf16, int rows, int w,
                                          int cin, int k) {
  return (int)sizeof(float) *
         (act_bf16 ? pass1_smem_floats<__nv_bfloat16>(rows, w, cin, k)
                   : pass1_smem_floats<float>(rows, w, cin, k));
}

extern "C" int mct_fused_pass1_smem_budget() { return kPass1SmemBudget; }
