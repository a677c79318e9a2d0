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
// The bound on the H100. Each output needs k*k products and k*k sums
// against one input and one output element of device memory (8 bytes f32,
// 4 bf16). Counting a multiply-add as 2 FLOP at the card's 67 TFLOP/s,
// every B0 geometry is bound by bytes at 3.35 TB/s. Keeping the bits costs
// a separate multiply and add per tap (no FMA), which halves the CUDA
// cores' rate to about 33.5 T operations/s; under that rule the bf16 k5
// maps become bound by the arithmetic, about 1.25x above their byte bound
// (28^2 x 240 at 128 maps: 0.036 ms against 0.029 ms). That is the
// practical floor this design aims at.
//
// The design. The n maps are walked as one stack of rows, each map followed
// by 2p zero rows, and one block of 256 threads takes a band of that stack
// for 32 channels (a band may run from one map into the next, so small maps
// are not one block each):
//
//   - Staging keeps device memory busy. The block walks down its band in
//     strips of rows. Input rows are staged in the activation type (bf16
//     stays bf16) into a ring of shared-memory rows, so each input row of
//     the band (its 2p halo rows included) is loaded once; only a band's 2p
//     edge rows are read again by the next band. The next strip's rows are
//     requested with 16-byte cp.async copies (4 f32 or 8 bf16 channels
//     each) before the current strip is computed, so the copies overlap the
//     arithmetic; rows outside a map are zero-filled by the copy itself.
//     Positions and channel vectors are walked with shifts; a row's map and
//     slot take one division per row, none per element.
//   - Taps and bias in registers. Lane = channel, so a thread's channel and
//     its k*k taps are fixed for the block and are loaded once (k 3 and 5;
//     any other odd k reads its taps through L1). Each thread computes
//     kR = 8 adjacent outputs of a row from a window of kR + k - 1 staged
//     inputs per tap row: k (k + 7) / 8 shared-memory loads per output
//     instead of 2 k^2. The sum order per output is unchanged.
//   - Warps store 32 neighbouring channels of one position (coalesced).
//     Channel groups vary fastest in the grid, so the blocks that read and
//     write the other parts of a position's cache lines run at about the
//     same time. The tile's columns are padded with zeros to a multiple of
//     kR plus the halo, and outputs past the row end are not stored.
//   - Any C and any alignment: when x is not 16-byte aligned or C is not a
//     multiple of the vector width, the same kernel stages with scalar
//     loads, 8 per thread in flight before any store (the kVec = false
//     instance). Ragged channel groups are masked.
//
// The band height and the strip height come from the wrapper
// (ops/depthwise.py:tile_plan), which mirrors smem_bytes below;
// mct_depthwise_smem_bytes lets the card tests hold the two equal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTC = 32;   // channels per block (one per lane)
constexpr int kR = 8;     // adjacent outputs of a row per thread
constexpr int kLoads = 8;  // scalar staging loads in flight per thread
constexpr int kSmemMax = 232448;  // 227 KB, what one block may take
constexpr int kMaxDevices = 64;

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

// Columns of a staged row: the map padded to a multiple of kR, plus the
// 2p zero halo.
__host__ __device__ inline int tile_cols(int w, int k) {
  return (w + kR - 1) / kR * kR + (k - 1);
}
// Rows of the ring: the whole band with its halo when one strip covers it,
// else the current strip with its halo plus the next strip in flight.
__host__ __device__ inline int ring_rows(int band, int strip, int k) {
  return (strip >= band ? band : 2 * strip) + (k - 1);
}
// Dynamic shared memory of one block. The Python wrapper
// (ops/depthwise.py:_smem_bytes) uses the same formula.
inline size_t smem_bytes(int item, int band, int strip, int w, int k) {
  return (size_t)ring_rows(band, strip, k) * tile_cols(w, k) * kTC * item;
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

// Stage input rows [a, b) of the stacked maps into their ring slots,
// channels [c0, c0 + kTC), interior columns only (the halo columns stay
// zero). Row v of the stack is row v % hv - p of map v / hv, zero outside
// the map: each map is followed by its own 2p zero rows. 2^tpr_log2
// threads share a row (a power of two at least the row's loads, at most
// kThreads), so narrow rows are staged several at once; the row's map, row
// and slot take one division each per row, the positions and channel
// vectors only shifts.
template <typename T, bool kVec>
__device__ __forceinline__ void stage_rows(
    const T* __restrict__ x, T* tile, int a, int b, int v0, int ring, int n,
    int h, int w, int c, int c0, int hv, int p, int row_elems, int tpr_log2,
    int tid) {
  const int tpr = 1 << tpr_log2;
  const int sub = tid & (tpr - 1);
  for (int v = a + (tid >> tpr_log2); v < b; v += kThreads >> tpr_log2) {
    const int q = v / hv;
    const int r = v - q * hv - p;
    const bool row_ok = q < n && r >= 0 && r < h;
    T* dst = tile + (size_t)((v - v0) % ring) * row_elems + p * kTC;
    const T* src = x + (size_t)(row_ok ? q * h + r : 0) * w * c + c0;
    if constexpr (kVec) {
      constexpr int kV = 16 / sizeof(T);  // channels per 16-byte vector
      constexpr int kNV = kTC / kV;       // vectors per position
      for (int i = sub; i < w * kNV; i += tpr) {
        const int col = i / kNV, ch = (i % kNV) * kV;  // shifts
        const bool ok = row_ok && c0 + ch < c;
        cp_async16(dst + col * kTC + ch, ok ? src + (size_t)col * c + ch : x,
                   ok);
      }
    } else {
      for (int i0 = sub; i0 < w * kTC; i0 += tpr * kLoads) {
        T v[kLoads];
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
          const int i = i0 + u * tpr;
          const int col = i / kTC, ch = i % kTC;  // shifts
          v[u] = row_ok && i < w * kTC && c0 + ch < c
                     ? src[(size_t)col * c + ch]
                     : from_f<T>(0.0f);
        }
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
          if (i0 + u * tpr < w * kTC) dst[i0 + u * tpr] = v[u];
        }
      }
    }
  }
}

// K > 0 fixes the kernel size at compile time (3 and 5, the trunk's), so the
// taps sit in registers; K == 0 takes the run-time k for any other odd size.
// kVec stages with 16-byte cp.async (x 16-byte aligned, C a multiple of the
// vector width), else with scalar loads.
//
// The n maps are walked as one stack of n * hv - 2p output rows, hv = h + 2p
// (a map's rows, then 2p rows that produce nothing); block (g, b) takes
// stack rows [b * band, (b + 1) * band) of channel group g, so a band may
// run from one map into the next. Channel groups vary fastest in the grid,
// so the blocks that share a row's cache lines run at about the same time.
template <typename T, int K, bool kVec>
__global__ void __launch_bounds__(kThreads) depthwise_kernel(
    const T* __restrict__ x, T* __restrict__ out, int n, int h, int w, int c,
    int k_rt, const float* __restrict__ wdw, const float* __restrict__ bdw,
    int band, int strip) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);  // (ring, wt, kTC)
  const int k = K > 0 ? K : k_rt;
  const int p = (k - 1) / 2;
  const int hv = h + 2 * p;
  const int v0 = blockIdx.y * band;
  const int vend = min(v0 + band, n * hv - 2 * p);
  const int c0 = blockIdx.x * kTC;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int wt = tile_cols(w, k);
  const int ring = ring_rows(band, strip, k);
  const int row_elems = wt * kTC;
  const int row_loads = kVec ? w * kTC * (int)sizeof(T) / 16 : w * kTC;
  const int tpr_log2 =
      row_loads >= kThreads ? 31 - __clz(kThreads)
                            : (row_loads > 1 ? 32 - __clz(row_loads - 1) : 0);

  // Zero the halo columns of every ring row once, 16 bytes a store: the
  // left p columns and the wt - p - w on the right.
  {
    constexpr int kNV = kTC * (int)sizeof(T) / 16;  // vectors per position
    const int halo_cols = wt - w;
    for (int i = tid; i < ring * halo_cols * kNV; i += kThreads) {
      const int r = i / (halo_cols * kNV);
      const int j = i - r * halo_cols * kNV;
      const int col = j / kNV < p ? j / kNV : j / kNV + w;
      *reinterpret_cast<uint4*>(tile + (size_t)r * row_elems + col * kTC +
                                (j % kNV) * (16 / (int)sizeof(T))) =
          make_uint4(0, 0, 0, 0);
    }
  }

  const int cg = c0 + lane;
  const bool active = cg < c;
  float taps[K > 0 ? K * K : 1];
  if constexpr (K > 0) {
#pragma unroll
    for (int i = 0; i < K * K; ++i) {
      taps[i] = active ? wdw[(size_t)i * c + cg] : 0.0f;
    }
  }
  const float bias = active ? bdw[cg] : 0.0f;
  // Items are (row, kR-column group) pairs, taken kWarps apart by each warp.
  const int groups = (w + kR - 1) / kR;
  const int dtv = kWarps / groups, dgx = kWarps - dtv * groups;

  // Output rows [vs, ve) read input rows [vs, ve + 2p).
  stage_rows<T, kVec>(x, tile, v0, min(v0 + strip, vend) + 2 * p, v0, ring,
                      n, h, w, c, c0, hv, p, row_elems, tpr_log2, tid);
  cp_async_commit();
  for (int vs = v0; vs < vend; vs += strip) {
    const int ve = min(vs + strip, vend);
    if (ve < vend) {  // request the next strip's new rows, then wait for ours
      stage_rows<T, kVec>(x, tile, ve + 2 * p, min(ve + strip, vend) + 2 * p,
                          v0, ring, n, h, w, c, c0, hv, p, row_elems,
                          tpr_log2, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (active) {
      int tv = warp / groups;  // row of the strip
      int gx = warp - tv * groups;
      int q = (vs + tv) / hv;  // map, row in it, ring slot of its first tap
      int y = vs + tv - q * hv;
      int slot = (vs + tv - v0) % ring;
      while (tv < ve - vs) {
        if (y < h) {  // not one of the 2p rows after a map
          const int x0 = gx * kR;
          float acc[kR];
#pragma unroll
          for (int r = 0; r < kR; ++r) acc[r] = bias;
          const T* col0 = tile + x0 * kTC + lane;
          int s = slot;
          if constexpr (K > 0) {
#pragma unroll
            for (int dy = 0; dy < K; ++dy) {
              const T* row = col0 + (size_t)s * row_elems;
              float v[kR + K - 1];  // the window of kR + K - 1 inputs
#pragma unroll
              for (int i = 0; i < kR + K - 1; ++i) v[i] = to_f(row[i * kTC]);
#pragma unroll
              for (int dx = 0; dx < K; ++dx) {
#pragma unroll
                for (int r = 0; r < kR; ++r) {
                  acc[r] = __fadd_rn(acc[r],
                                     __fmul_rn(v[r + dx], taps[dy * K + dx]));
                }
              }
              if (++s == ring) s = 0;
            }
          } else {
            for (int dy = 0; dy < k; ++dy) {
              const T* row = col0 + (size_t)s * row_elems;
              for (int dx = 0; dx < k; ++dx) {
                const float tap = __ldg(wdw + (size_t)(dy * k + dx) * c + cg);
#pragma unroll
                for (int r = 0; r < kR; ++r) {
                  acc[r] = __fadd_rn(
                      acc[r], __fmul_rn(to_f(row[(r + dx) * kTC]), tap));
                }
              }
              if (++s == ring) s = 0;
            }
          }
          T* o = out + (((size_t)q * h + y) * w + x0) * c + cg;
          if (x0 + kR <= w) {  // a whole group: no masks, pointer steps
#pragma unroll
            for (int r = 0; r < kR; ++r, o += c) *o = from_f<T>(acc[r]);
          } else {
#pragma unroll
            for (int r = 0; r < kR; ++r, o += c) {
              if (x0 + r < w) *o = from_f<T>(acc[r]);
            }
          }
        }
        int d = dtv;  // advance kWarps items
        gx += dgx;
        if (gx >= groups) {
          gx -= groups;
          ++d;
        }
        tv += d;
        y += d;
        slot += d;
        while (y >= hv) {
          y -= hv;
          ++q;
        }
        while (slot >= ring) slot -= ring;
      }
    }
    __syncthreads();  // the next strip's copies overwrite rows read above
  }
}

// Raise the dynamic shared-memory limit to kSmemMax once per kernel
// instance and device.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemMax);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

template <typename T, int K, bool kVec>
int launch(const void* xv, void* outv, int n, int h, int w, int c, int k,
           const float* wdw, const float* bdw, int band, int strip,
           cudaStream_t st) {
  static bool smem_set[kMaxDevices] = {};
  const size_t smem = smem_bytes(sizeof(T), band, strip, w, k);
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(depthwise_kernel<T, K, kVec>, smem_set);
  if (err != cudaSuccess) return (int)err;
  const int rows = n * (h + k - 1) - (k - 1);  // the stack's output rows
  dim3 grid((c + kTC - 1) / kTC, (rows + band - 1) / band);
  depthwise_kernel<T, K, kVec><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(xv), static_cast<T*>(outv), n, h, w, c, k, wdw,
      bdw, band, strip);
  return (int)cudaGetLastError();
}

using Launcher = int (*)(const void*, void*, int, int, int, int, int,
                         const float*, const float*, int, int, cudaStream_t);

template <typename T, bool kVec>
Launcher pick_k(int k) {
  return k == 3 ? &launch<T, 3, kVec>
         : k == 5 ? &launch<T, 5, kVec>
                  : &launch<T, 0, kVec>;
}

}  // namespace

extern "C" int mct_depthwise_smem_bytes(int act_bf16, int band, int strip,
                                        int w, int k) {
  return (int)smem_bytes(act_bf16 ? 2 : 4, band, strip, w, k);
}

extern "C" int mct_depthwise(const void* x, void* out, int act_bf16,
                             int vec_loads, int n, int h, int w, int c, int k,
                             const void* wdw, const void* bdw, int band,
                             int strip, void* stream) {
  if (n == 0) return 0;
  if (band < 1 || strip < 1 || k < 1 || k % 2 == 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int vec = 16 / (act_bf16 ? 2 : 4);
  if (vec_loads && (reinterpret_cast<uintptr_t>(x) % 16 != 0 || c % vec != 0)) {
    return (int)cudaErrorMisalignedAddress;
  }
  Launcher run = act_bf16 ? (vec_loads ? pick_k<__nv_bfloat16, true>(k)
                                       : pick_k<__nv_bfloat16, false>(k))
                          : (vec_loads ? pick_k<float, true>(k)
                                       : pick_k<float, false>(k));
  return run(x, out, n, h, w, c, k, static_cast<const float*>(wdw),
             static_cast<const float*>(bdw), band, strip,
             static_cast<cudaStream_t>(stream));
}
