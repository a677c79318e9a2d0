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
// What bounds it on the H100, and the design. The TPU kernel keeps a patch's
// whole expanded map (up to 56*56*144) in 16 MB of VMEM. A Hopper block has
// at most 227 KB of shared memory, and the SE global mean couples the whole
// map, so the block is split at that mean into three launches:
//
//   1. expand_dw_kernel, one block per (row tile, 32 mid channels, patch):
//      stages the tile's input rows plus a p-row halo in shared memory,
//      computes expand + bias + SiLU for those rows and channels (zeros at
//      out-of-image halo rows and columns: the expanded map is what is
//      padded), runs the depthwise + bias + SiLU in f32, writes d to an f32
//      scratch tensor and the tile's per-channel sums to a (P, tiles, Cmid)
//      buffer — deterministic, no atomics.
//   2. se_kernel, one block per patch: reduces the partial sums, divides by
//      H*W, runs FC + SiLU and FC + sigmoid into e (P, Cmid).
//   3. project_kernel, one block per (64 positions, 32 out channels, patch):
//      forms m = cast_act(d * e) tile by tile in shared memory and runs the
//      project as an f32-accumulating shared-memory tiled loop, then bias,
//      residual and the cast.
//
// Each block writes its own halo zeros: blocks run in no order, so nothing
// may be carried from one block to the next as the TPU grid did. The cost
// of this simple design is one round trip of d (P*H*W*Cmid f32) through
// device memory, and the expand recomputed for the 2p halo rows of every
// tile; both go in later work. The 1x1 products run on the CUDA cores in
// f32 (no tensor cores yet), so the large-Cmid blocks are compute-bound in
// this version and the 56x56 block is bound by the d round trip.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTC = 32;   // mid channels per pass-1 block (one per lane)
constexpr int kTP = 64;   // positions per pass-2 block
constexpr int kTO = 32;   // out channels per pass-2 block (one per lane)
constexpr int kKC = 32;   // mid channels per pass-2 reduction step

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

// Shared-memory floats pass 1 needs for a tile of `rows` output rows. The
// Python wrapper (ops/fused_mbconv.py:_pass1_smem_floats) uses the same
// formula to choose `rows`.
__host__ __device__ inline int pass1_smem_floats(int rows, int w, int cin,
                                                 int k) {
  const int p = (k - 1) / 2;
  const int zrows = rows + 2 * p;
  return zrows * w * cin        // staged input rows
         + cin * kTC            // expand weights of the channel tile
         + zrows * (w + 2 * p) * kTC  // padded expanded map
         + k * k * kTC          // depthwise taps
         + kWarps * kTC;        // partial-sum reduction
}

template <typename T>
__global__ void __launch_bounds__(kThreads) expand_dw_kernel(
    const T* __restrict__ x, int h, int w, int cin, int cmid, int k,
    const float* __restrict__ wexp,
    const float* __restrict__ bexp, const float* __restrict__ wdw,
    const float* __restrict__ bdw, float* __restrict__ d,
    float* __restrict__ partial, int rows_per_tile) {
  extern __shared__ float smem[];
  const int p = (k - 1) / 2;
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

  const int max_zrows = rows_per_tile + 2 * p;
  float* xs = smem;                              // (in rows, w, cin)
  float* ws = xs + max_zrows * w * cin;          // (cin, kTC)
  float* zs = ws + cin * kTC;                    // (zrows, wz, kTC)
  float* taps = zs + max_zrows * wz * kTC;       // (k*k, kTC)
  float* red = taps + k * k * kTC;               // (kWarps, kTC)

  // Stage the tile's in-image input rows: one contiguous NHWC range.
  const T* xsrc = x + ((size_t)n * h + in_lo) * w * cin;
  const int n_x = (in_hi - in_lo) * w * cin;
  for (int i = tid; i < n_x; i += kThreads) xs[i] = to_f(xsrc[i]);
  for (int i = tid; i < cin * kTC; i += kThreads) {
    const int ci = i / kTC, c = c0 + i % kTC;
    ws[i] = c < cmid ? wexp[(size_t)ci * cmid + c] : 0.0f;
  }
  for (int i = tid; i < k * k * kTC; i += kThreads) {
    const int t = i / kTC, c = c0 + i % kTC;
    taps[i] = c < cmid ? wdw[(size_t)t * cmid + c] : 0.0f;
  }
  __syncthreads();

  // Expanded map with its zero halo; lane = channel, warps walk positions.
  const int c = c0 + lane;
  const bool c_ok = c < cmid;
  const float be = c_ok ? bexp[c] : 0.0f;
  for (int pos = warp; pos < zrows * wz; pos += kWarps) {
    const int zr = pos / wz, zx = pos % wz;
    const int y = zr0 + zr, xx = zx - p;
    float z = 0.0f;
    if (c_ok && y >= 0 && y < h && xx >= 0 && xx < w) {
      const float* xrow = xs + ((y - in_lo) * w + xx) * cin;
      float acc = 0.0f;
      for (int ci = 0; ci < cin; ++ci) acc += xrow[ci] * ws[ci * kTC + lane];
      z = round_act<T>(silu_f(acc + be));
    }
    zs[pos * kTC + lane] = z;
  }
  __syncthreads();

  // Depthwise + bias + SiLU over the tile's own rows, f32 accumulation.
  const float bd = c_ok ? bdw[c] : 0.0f;
  float psum = 0.0f;
  for (int pos = warp; pos < th * w; pos += kWarps) {
    const int ty = pos / w, xx = pos % w;
    float acc = bd;
    for (int dy = 0; dy < k; ++dy) {
      const float* zrow = zs + ((ty + dy) * wz + xx) * kTC + lane;
      const float* trow = taps + dy * k * kTC + lane;
      for (int dx = 0; dx < k; ++dx) acc += zrow[dx * kTC] * trow[dx * kTC];
    }
    const float dv = silu_f(acc);
    if (c_ok) {
      d[(((size_t)n * h + y0 + ty) * w + xx) * cmid + c] = dv;
      psum += dv;
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

template <typename T>
__global__ void __launch_bounds__(kThreads) project_kernel(
    const T* __restrict__ x, const float* __restrict__ d,
    const float* __restrict__ e, const float* __restrict__ wproj,
    const float* __restrict__ bproj, T* __restrict__ out, int hw, int cin,
    int cmid, int cout, int residual) {
  __shared__ float ms[kTP][kKC + 1];
  __shared__ float wsm[kKC][kTO];
  const int pos0 = blockIdx.x * kTP;
  const int co0 = blockIdx.y * kTO;
  const int n = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  constexpr int kPer = kTP / kWarps;  // positions per thread

  float acc[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) acc[j] = 0.0f;

  const float* dn = d + (size_t)n * hw * cmid;
  const float* en = e + (size_t)n * cmid;
  for (int kc0 = 0; kc0 < cmid; kc0 += kKC) {
    for (int i = tid; i < kTP * kKC; i += kThreads) {
      const int pos = i / kKC, kk = i % kKC;
      const int gpos = pos0 + pos, cm = kc0 + kk;
      float v = 0.0f;
      if (gpos < hw && cm < cmid) {
        v = round_act<T>(dn[(size_t)gpos * cmid + cm] * en[cm]);
      }
      ms[pos][kk] = v;
    }
    for (int i = tid; i < kKC * kTO; i += kThreads) {
      const int kk = i / kTO, co = co0 + i % kTO, cm = kc0 + kk;
      wsm[kk][i % kTO] =
          (cm < cmid && co < cout) ? wproj[(size_t)cm * cout + co] : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kKC; ++kk) {
      const float wv = wsm[kk][lane];
#pragma unroll
      for (int j = 0; j < kPer; ++j) acc[j] += ms[warp + kWarps * j][kk] * wv;
    }
    __syncthreads();
  }

  const int co = co0 + lane;
  if (co >= cout) return;
  const float b = bproj[co];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int gpos = pos0 + warp + kWarps * j;
    if (gpos >= hw) continue;
    float y = acc[j] + b;
    if (residual) y += to_f(x[((size_t)n * hw + gpos) * cin + co]);
    out[((size_t)n * hw + gpos) * cout + co] = from_f<T>(y);
  }
}

template <typename T>
int launch(const void* xv, void* outv, int n, int h, int w, int cin,
           int cmid, int cout, int cse, int k, int residual,
           const float* wexp, const float* bexp, const float* wdw,
           const float* bdw, const float* wse1, const float* bse1,
           const float* wse2, const float* bse2, const float* wproj,
           const float* bproj, float* d, float* partial, float* e,
           int rows_per_tile, cudaStream_t st) {
  const T* x = static_cast<const T*>(xv);
  T* out = static_cast<T*>(outv);
  const int n_tiles = (h + rows_per_tile - 1) / rows_per_tile;
  const size_t smem1 =
      sizeof(float) * (size_t)pass1_smem_floats(rows_per_tile, w, cin, k);
  cudaError_t err = cudaFuncSetAttribute(
      expand_dw_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem1);
  if (err != cudaSuccess) return (int)err;

  dim3 grid1(n_tiles, (cmid + kTC - 1) / kTC, n);
  expand_dw_kernel<T><<<grid1, kThreads, smem1, st>>>(
      x, h, w, cin, cmid, k, wexp, bexp, wdw, bdw, d, partial,
      rows_per_tile);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const size_t smem2 = sizeof(float) * (size_t)(cmid + cse);
  se_kernel<<<n, kThreads, smem2, st>>>(partial, n_tiles, cmid, cse, h * w,
                                         wse1, bse1, wse2, bse2, e);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  dim3 grid3((h * w + kTP - 1) / kTP, (cout + kTO - 1) / kTO, n);
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
  if (rows_per_tile < 1 || k % 2 == 0) return (int)cudaErrorInvalidValue;
  auto f = [](const void* ptr) { return static_cast<const float*>(ptr); };
  auto run = act_bf16 ? launch<__nv_bfloat16> : launch<float>;
  return run(x, out, n, h, w, cin, cmid, cout, cse, k, residual, f(wexp),
             f(bexp), f(wdw), f(bdw), f(wse1), f(bse1), f(wse2), f(bse2),
             f(wproj), f(bproj), static_cast<float*>(d),
             static_cast<float*>(partial), static_cast<float*>(e),
             rows_per_tile, static_cast<cudaStream_t>(stream));
}
