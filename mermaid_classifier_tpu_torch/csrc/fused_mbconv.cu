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
//      Where a tile's rows of all Cin channels overflow the budget even at
//      one row (EfficientNet-B4 and wider: Cin 160 to 448 at 12^2 to 24^2),
//      the Sliced instance streams Cin in slices of kKC channels through a
//      ring of kStages shared-memory stages: 16-byte cp.async copies bring
//      slice s+1's input rows (in the activation type, zero-filled past
//      Cin) and expand-weight rows (f32) while the tensor cores expand
//      slice s, one barrier per slice. The expand accumulates across the
//      slices in the mma registers (up to kMS 16-position steps per warp,
//      so a tile stages at most kSlicedPositions positions), and bias +
//      SiLU + the rounding run once after the last slice. The slices take
//      the whole tile's k steps in the same order, so both instances give
//      the same bits. The Sliced instance is built for EfficientNet's k 3
//      and 5 only, and takes Cin a multiple of the 16-byte vector.
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
// tensor-core work. Fragments are read from the shared-memory tiles (f32,
// or the sliced instance's bf16 input through ldmatrix) and converted as
// they are loaded; row strides are padded so that those reads avoid bank
// conflicts.
//
// Still open: the f32 round trip of d through device memory (0.72 GB
// written and read back per 128-patch B0 chunk), the expand recomputed on
// the 2p halo rows of every tile, wgmma/TMA staging, and, for the whole
// tile, cp.async staging and bf16 shared-memory tiles.

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
// The sliced pass 1 (ops/fused_mbconv.py _KKC, _SLICED_POSITIONS,
// _KSTAGES): input channels per slice, 16-position expand steps per warp,
// staged positions, slices in the ring.
constexpr int kKC = 32;
constexpr int kMS = 4;
constexpr int kSlicedPositions = kWarps * 16 * kMS;
constexpr int kStages = 2;
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
// every lane of a load on its own bank. The sliced instance's bf16 tile
// takes a_stride<bf16>(kKC) = 40 bf16 elements (80 bytes): the eight rows
// of each ldmatrix phase fall on eight distinct 16-byte bank groups.
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

// One stage of the sliced ring for n_pos staged positions: kKC channels of
// each position in the activation type (row stride a_stride<T>(kKC)
// elements), then kKC expand-weight rows in f32. Both parts are whole
// 16-byte vectors, so every stage and part starts 16-byte aligned.
template <typename T>
__host__ __device__ constexpr int sliced_x_floats(int n_pos) {
  return n_pos * a_stride<T>(kKC) * (int)sizeof(T) / 4;
}
template <typename T>
__host__ __device__ constexpr int sliced_stage_floats(int n_pos) {
  return sliced_x_floats<T>(n_pos) + kKC * b_stride<T>(kTC);
}

// Shared-memory floats of pass 1's staged input and expand weights for
// n_pos staged positions: all Cin channels in f32 (weights K padded to 16),
// or the sliced ring.
template <typename T>
__host__ __device__ inline int staged_floats(int n_pos, int cin,
                                             bool sliced) {
  return sliced ? kStages * sliced_stage_floats<T>(n_pos)
                : n_pos * a_stride<T>(cin) + round_up(cin, 16) * b_stride<T>(kTC);
}

// Shared-memory floats pass 1 needs for a tile of `rows` output rows: the
// staged input and weights, the padded expanded map and the partial-sum
// reduction. The Python wrapper (ops/fused_mbconv.py:_pass1_smem_floats)
// uses the same formula to plan the tile; mct_fused_pass1_smem_bytes below
// lets the card tests hold the two against each other.
template <typename T>
__host__ __device__ inline int pass1_smem_floats(int rows, int w, int cin,
                                                 int k, bool sliced) {
  const int p = (k - 1) / 2;
  const int zrows = rows + 2 * p;
  return staged_floats<T>(zrows * w, cin, sliced)
         + zrows * (w + 2 * p) * kZs  // padded expanded map
         + kWarps * kTC;              // partial-sum reduction
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

// The sliced instance's A operand: rows m0 .. m0 + 15 of a bf16 tile (row
// stride xst elements, rows past m_all read as row m_all - 1), columns
// k0 .. k0 + 15, as the m16n8k16 A fragment. ldmatrix.x4 takes matrix i's
// row addresses from lanes 8i .. 8i + 7: rows (lane & 15), column half
// (lane >> 4).
__device__ __forceinline__ void load_a_bf16(uint32_t (&a)[4],
                                            const __nv_bfloat16* xs, int xst,
                                            int m0, int m_all, int k0,
                                            int lane) {
  const int row = min(m0 + (lane & 15), m_all - 1);
  const unsigned s = (unsigned)__cvta_generic_to_shared(
      xs + row * xst + k0 + 8 * (lane >> 4));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(s));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool fill) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  // src-size 0 writes 16 zero bytes and reads nothing.
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(fill ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Issue (not wait for) the copies of slice [kc0, kc0 + kKC) into one ring
// stage: the kKC channels of n_pos staged positions (rows of a contiguous
// NHWC range from xsrc) into xs, row stride a_stride<T>(kKC), and expand-
// weight rows kc0 .. kc0 + kKC of mid channels [c0, c0 + kTC) into ws (row
// stride b_stride), zero-filled past Cin and Cmid. Cin is a multiple of
// the 16-byte vector and Cmid of 4, x and wexp 16-byte aligned (the
// launcher checks), so no vector straddles an edge.
template <typename T>
__device__ __forceinline__ void issue_slice(T* xs, float* ws, const T* xsrc,
                                            int n_pos, int cin,
                                            const float* wexp, int cmid,
                                            int c0, int kc0, int tid) {
  constexpr int kV = 16 / sizeof(T);  // channels per copy
  constexpr int kNV = kKC / kV;       // copies per position
  constexpr int xst = a_stride<T>(kKC);
  for (int i = tid; i < n_pos * kNV; i += kThreads) {
    const int pos = i / kNV, ch = i % kNV * kV;
    const bool ok = kc0 + ch < cin;
    cp_async16(xs + pos * xst + ch,
               ok ? xsrc + (size_t)pos * cin + kc0 + ch : xsrc, ok);
  }
  constexpr int wst = b_stride<T>(kTC);
  constexpr int kWV = kTC / 4;  // copies per weight row
  for (int i = tid; i < kKC * kWV; i += kThreads) {
    const int r = i / kWV, cc = i % kWV * 4;
    const bool ok = kc0 + r < cin && c0 + cc < cmid;
    cp_async16(ws + r * wst + cc,
               ok ? wexp + (size_t)(kc0 + r) * cmid + c0 + cc : wexp, ok);
  }
}

// Stage input channels [kc0, kc0 + kin) of n_pos staged positions (rows of
// a contiguous NHWC range from xsrc) into xs, row stride xst, zero past Cin.
// Each thread issues kLoads loads before it stores any, so that their
// latencies overlap; 16-byte loads where the layout allows them (Cin and kin
// multiples of the vector, an aligned base).
template <typename T>
__device__ __forceinline__ void stage_input(float* xs, int xst, const T* xsrc,
                                            bool aligned, int n_pos, int cin,
                                            int kc0, int kin, int tid) {
  constexpr int kV = 16 / sizeof(T);
  if (cin % kV == 0 && kin % kV == 0 && aligned) {
    const int n_v = n_pos * kin / kV;
    for (int i0 = tid; i0 < n_v; i0 += kLoads * kThreads) {
      uint4 v[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int i = (i0 + u * kThreads) * kV, pos = i / kin, ch = i - pos * kin;
        if (i < n_v * kV) {
          v[u] = kc0 + ch < cin ? *reinterpret_cast<const uint4*>(
                                      xsrc + (size_t)pos * cin + kc0 + ch)
                                : make_uint4(0, 0, 0, 0);
        }
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int i = (i0 + u * kThreads) * kV, pos = i / kin, ch = i - pos * kin;
        if (i < n_v * kV) store_vec<T>(xs + pos * xst + ch, v[u]);
      }
    }
  } else {
    const int n_x = n_pos * kin;
    for (int i0 = tid; i0 < n_x; i0 += kLoads * kThreads) {
      float v[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int i = i0 + u * kThreads, pos = i / kin, ch = i - pos * kin;
        if (i < n_x) {
          v[u] = kc0 + ch < cin ? to_f(xsrc[(size_t)pos * cin + kc0 + ch]) : 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int i = i0 + u * kThreads, pos = i / kin;
        if (i < n_x) xs[pos * xst + i - pos * kin] = v[u];
      }
    }
  }
}

// Stage expand-weight rows [kc0, kc0 + kpad) of mid channels
// [c0, c0 + kTC) into ws (row stride b_stride), zero past Cin and Cmid.
template <typename T>
__device__ __forceinline__ void stage_weights(float* ws, const float* wexp,
                                              int cin, int cmid, int c0,
                                              int kc0, int kpad, int tid) {
  constexpr int wst = b_stride<T>(kTC);
  if (cmid % 4 == 0 && reinterpret_cast<uintptr_t>(wexp) % 16 == 0) {
    // Thread tid: channels c0 + 4 * (tid % 8) + 0..3 of rows tid / 8 + 32u.
    const int cc = 4 * (tid % 8), c = c0 + cc;
    for (int ci0 = tid / 8; ci0 < kpad; ci0 += kLoads * kThreads / 8) {
      float4 v[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int ci = kc0 + ci0 + u * kThreads / 8;
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
        const int ci = kc0 + ci0 + u * kWarps;
        v[u] = ci < cin && c < cmid ? wexp[(size_t)ci * cmid + c] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int ci = ci0 + u * kWarps;
        if (ci < kpad) ws[ci * wst + tid % kTC] = v[u];
      }
    }
  }
}

// The sliced instance's bf16 products of one slice: acc[ms] += A (the 16
// positions of warp step ms, from the bf16 tile xs) * B (kend x kTC, f32
// weights ws rounded to bf16). Each lane loads its B fragments once per
// slice and reuses them over the kMS steps; every acc takes the k steps in
// the whole tile's order.
__device__ __forceinline__ void slice_mma_bf16(float (&acc)[kMS][4][4],
                                               const __nv_bfloat16* xs,
                                               const float* ws, int m_all,
                                               int kend, int warp, int lane) {
  constexpr int xst = a_stride<__nv_bfloat16>(kKC);
  constexpr int wst = b_stride<__nv_bfloat16>(kTC);
  constexpr int kSteps = kKC / 16;
  const int g = lane >> 2, t = lane & 3;
  uint32_t b[kSteps][4][2];
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) {
    const float* bp = ws + (16 * ks + 2 * t) * wst + g;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      b[ks][j][0] = pack_bf16(bp[8 * j], bp[8 * j + wst]);
      b[ks][j][1] = pack_bf16(bp[8 * j + 8 * wst], bp[8 * j + 9 * wst]);
    }
  }
#pragma unroll
  for (int ms = 0; ms < kMS; ++ms) {
    const int m0 = (warp + ms * kWarps) * 16;
    if (m0 >= m_all) continue;  // warp-uniform
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      if (16 * ks >= kend) continue;
      uint32_t a[4];
      load_a_bf16(a, xs, xst, m0, m_all, 16 * ks, lane);
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_bf16(acc[ms][j], a, b[ks][j][0], b[ks][j][1]);
    }
  }
}

// K: the depthwise kernel size, whose taps each lane holds in registers;
// K = 0 takes the odd size k at run time and reads the taps through L1.
// Sliced: stream Cin in slices of kKC channels through the cp.async ring
// (the tile stages at most kSlicedPositions positions); else stage all Cin
// channels at once.
template <typename T, int K, bool Sliced>
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
  const int xst = a_stride<T>(cin);  // the whole tile's input row stride
  const int kpad = round_up(cin, 16);
  constexpr int wst = b_stride<T>(kTC);

  // The whole tile stages its input rows and weights in f32; the sliced
  // tile holds its ring (staged_floats) in their place.
  const int max_zrows = rows_per_tile + 2 * p;
  float* xs = smem;                              // (in rows * w, xst)
  float* ws = xs + max_zrows * w * xst;          // (kpad, wst)
  float* zs = Sliced ? smem + staged_floats<T>(max_zrows * w, cin, true)
                     : ws + kpad * wst;          // (zrows, wz, kZs)
  float* red = zs + max_zrows * wz * kZs;        // (kWarps, kTC)

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

  // The tile's in-image input rows are one contiguous NHWC range.
  const T* xsrc = x + ((size_t)n * h + in_lo) * w * cin;
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int m_all = (in_hi - in_lo) * w;
  const int g = lane >> 2, t = lane & 3;
  float be[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = c0 + 8 * j + 2 * t + e;
      be[j][e] = c < cmid ? bexp[c] : 0.0f;
    }
  }
  // The expand's epilogue for the 16 positions from m0: bias + SiLU,
  // rounded to the activation type, into the padded map (zeros for
  // channels past Cmid).
  auto epilogue = [&](int m0, const float (&acc)[4][4]) {
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
  };

  // Expand on the tensor cores, 16 staged positions per warp step.
  if constexpr (Sliced) {
    // The ring: slice s goes to stage s % kStages, its input rows first,
    // its weights x_floats on. The first kStages - 1 slices are requested
    // before the loop; then each slice's barrier releases the stage that
    // the slice kStages - 1 ahead fills.
    const int n_slices = (cin + kKC - 1) / kKC;
    const int stage_floats = sliced_stage_floats<T>(max_zrows * w);
    const int x_floats = sliced_x_floats<T>(max_zrows * w);
    auto request_slice = [&](int s) {
      float* stage = smem + s % kStages * stage_floats;
      issue_slice<T>(reinterpret_cast<T*>(stage), stage + x_floats, xsrc,
                     m_all, cin, wexp, cmid, c0, s * kKC, tid);
    };
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < n_slices) request_slice(s);
      cp_async_commit();
    }
    float acc[kMS][4][4] = {};
    for (int s = 0; s < n_slices; ++s) {
      // This thread's copies of slice s have landed; past the barrier every
      // thread's have, and slice s - 1's products are done, so its stage
      // can take slice s + kStages - 1, whose copies fly under this slice's
      // products.
      cp_async_wait<kStages - 2>();
      __syncthreads();
      if (s + kStages - 1 < n_slices) request_slice(s + kStages - 1);
      cp_async_commit();
      const float* stage = smem + s % kStages * stage_floats;
      const int klim = min(cin - s * kKC, kKC);
      const int kend = round_up(klim, kDepth<T>);
      if constexpr (is_bf16<T>) {
        slice_mma_bf16(acc, reinterpret_cast<const T*>(stage),
                       stage + x_floats, m_all, kend, warp, lane);
      } else {
        constexpr int sxst = a_stride<T>(kKC);
#pragma unroll
        for (int ms = 0; ms < kMS; ++ms) {
          const int m0 = (warp + ms * kWarps) * 16;
          if (m0 < m_all) {
            warp_mma<T, 4>(acc[ms], stage + min(m0 + g, m_all - 1) * sxst,
                           stage + min(m0 + g + 8, m_all - 1) * sxst, klim,
                           kend, stage + x_floats, wst, lane);
          }
        }
      }
    }
#pragma unroll
    for (int ms = 0; ms < kMS; ++ms) {
      const int m0 = (warp + ms * kWarps) * 16;
      if (m0 < m_all) epilogue(m0, acc[ms]);
    }
  } else {
    stage_input<T>(xs, xst, xsrc, aligned, m_all, cin, 0, cin, tid);
    stage_weights<T>(ws, wexp, cin, cmid, c0, 0, kpad, tid);
    __syncthreads();
    const int kend = round_up(cin, kDepth<T>);
    for (int m0 = warp * 16; m0 < m_all; m0 += kWarps * 16) {
      float acc[4][4] = {};
      warp_mma<T, 4>(acc, xs + min(m0 + g, m_all - 1) * xst,
                     xs + min(m0 + g + 8, m_all - 1) * xst, cin, kend, ws, wst,
                     lane);
      epilogue(m0, acc);
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

template <typename T, int K, bool Sliced>
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
  const size_t smem1 = sizeof(float) * (size_t)pass1_smem_floats<T>(
                                           rows_per_tile, w, cin, k, Sliced);
  if (smem1 > (size_t)kPass1SmemBudget) return (int)cudaErrorInvalidValue;
  // The ring copies whole 16-byte vectors of x and of the expand weights.
  if (Sliced && ((rows_per_tile + k - 1) * w > kSlicedPositions ||
                 cin % (16 / sizeof(T)) != 0 || cmid % 4 != 0 ||
                 reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
                 reinterpret_cast<uintptr_t>(wexp) % 16 != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = allow_pass1_smem(expand_dw_kernel<T, K, Sliced>, smem_set);
  if (err != cudaSuccess) return (int)err;

  dim3 grid1(n_tiles, (cmid + kTC - 1) / kTC, n);
  expand_dw_kernel<T, K, Sliced><<<grid1, kThreads, smem1, st>>>(
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

// The launcher of one activation type and staging: taps in registers for
// EfficientNet's k 3 and 5; any other odd k reads them through L1 on the
// whole tile, and has no sliced launcher (null).
template <typename T, bool Sliced>
auto launcher(int k) -> decltype(&launch<T, 3, Sliced>) {
  if (k == 3) return &launch<T, 3, Sliced>;
  if (k == 5) return &launch<T, 5, Sliced>;
  if constexpr (Sliced) {
    return nullptr;
  } else {
    return &launch<T, 0, Sliced>;
  }
}

}  // namespace

extern "C" int mct_fused_mbconv(
    const void* x, void* out, int act_bf16, int n, int h, int w, int cin,
    int cmid, int cout, int cse, int k, int residual, const void* wexp,
    const void* bexp, const void* wdw, const void* bdw, const void* wse1,
    const void* bse1, const void* wse2, const void* bse2, const void* wproj,
    const void* bproj, void* d, void* partial, void* e, int rows_per_tile,
    int sliced, void* stream) {
  if (n == 0) return 0;
  if (rows_per_tile < 1 || k < 1 || k % 2 == 0) {
    return (int)cudaErrorInvalidValue;
  }
  auto f = [](const void* ptr) { return static_cast<const float*>(ptr); };
  auto run = act_bf16 ? (sliced ? launcher<__nv_bfloat16, true>(k)
                                : launcher<__nv_bfloat16, false>(k))
                      : (sliced ? launcher<float, true>(k)
                                : launcher<float, false>(k));
  if (run == nullptr) return (int)cudaErrorInvalidValue;
  return run(x, out, n, h, w, cin, cmid, cout, cse, k, residual, f(wexp),
             f(bexp), f(wdw), f(bdw), f(wse1), f(bse1), f(wse2), f(bse2),
             f(wproj), f(bproj), static_cast<float*>(d),
             static_cast<float*>(partial), static_cast<float*>(e),
             rows_per_tile, static_cast<cudaStream_t>(stream));
}

// Pass 1's dynamic shared memory in bytes for a tile of `rows` output rows,
// whole or sliced, and the budget it must fit; ops/fused_mbconv.py mirrors
// both to plan the tile, and the card tests hold that copy against these.
extern "C" int mct_fused_pass1_smem_bytes(int act_bf16, int sliced, int rows,
                                          int w, int cin, int k) {
  return (int)sizeof(float) *
         (act_bf16 ? pass1_smem_floats<__nv_bfloat16>(rows, w, cin, k, sliced)
                   : pass1_smem_floats<float>(rows, w, cin, k, sliced));
}

extern "C" int mct_fused_pass1_smem_budget() { return kPass1SmemBudget; }
