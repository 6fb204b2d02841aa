// Fused eval-mode MBConv block, v1 pass 1: the squeeze-excite sums.
//
// Replaces the TPU kernel psla_tpu/ops/fused_mbconv.py::_pass1_kernel
// (launched by fused_mbconv_eval). One stride-1 EfficientNet block with
// BatchNorm folded (psla_tpu_torch/ops/fused_mbconv.py holds the wrapper
// and the plain version, pass1_plain):
//
//   e = swish(x @ w1 + b1)              (x itself when there is no expand)
//   d = swish(depthwise_kxk(e) + bd)    SAME: taps outside the map read 0
//   sums[b, c] = sum over the map of d  (the SE mean's sum)
//
// The squeeze-excite MLP that turns sums into the gate runs after this
// launch, in PyTorch; pass 2 (mbconv_pass2.cu) computes e and d again and
// projects. e and d never reach device memory.
//
// Bound on an H100 SXM: operations. Over B2's 19 stride-1 blocks at the
// serving shape (16 clips, 64 x 528 after the stem), chip_smoke.py counts
// 0.40 ms of pass 1's operations at the float32 CUDA-core rate
// (67 TFLOP/s), above the bytes of its inputs and outputs at 3.35 TB/s;
// only the first two blocks (no expand, 16-32 channels) are bound by bytes.
// This design does each block's expand and depthwise again for every
// halo, and a map of one or two tiles gives only 16-32 blocks of threads,
// so it sits far above that bound.
//
// Design. A block of 256 threads owns one tile of `tile` flattened rows of
// one clip, as a grid step of the TPU kernel does, and writes the tile's
// per-channel partial sums; a second small kernel adds them in tile order,
// so a run gives the same bits every time. The TPU kernel reads its tile
// with a halo of m*W + m rows and masks the taps that wrap around a row
// edge; here the block walks its rows in 2-D windows of th x tw output
// pixels (th * tw = 64) with a halo of m rows and m columns, and zero
// activations outside the map give the same taps those masks select. For
// each window and each chunk of 32 expanded channels it
//   1. stages the window's input pixels, 32 input channels at a time, in
//      shared memory and forms the expand product on the CUDA cores (each
//      lane holds one column of w1 in registers), then bias, swish and the
//      row/column zeroing;
//   2. takes the k*k taps for its 64 output pixels (lane = channel);
//   3. adds d of the pixels that lie in the tile into per-channel sums
//      kept in shared memory.
//
// fast = 1 follows the TPU kernel's rounding points: the operands of the
// expand product are rounded to bfloat16 and summed in float32, e is
// rounded to bfloat16, each tap's product is rounded to bfloat16 before its
// float32 sum; d stays float32. No library kernel is called.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kP = 64;         // output pixels of one window (th * tw)
constexpr int kCC = 32;        // expanded channels of one chunk (= lanes)
constexpr int kKC = 32;        // input channels staged at a time

struct Params {
  const float* x;      // [B, H, W, Cin]
  const float* w1;     // [Cin, Ce] or null
  const float* b1;     // [Ce] or null
  const float* wd;     // [k*k, Ce]
  const float* bd;     // [Ce]
  float* partial;      // [B, n_tiles, Ce]
  int h, w, cin, ce, tile, n_tiles, has_expand, th, tw;
};

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float swish(float v) { return v / (1.f + expf(-v)); }

template <int K, bool kFast>
__global__ void __launch_bounds__(kThreads)
pass1_kernel(const Params p) {
  constexpr int m = K / 2;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, t = blockIdx.x;
  const int h = p.h, w = p.w, cin = p.cin, ce = p.ce;
  const int th = p.th, tw = p.tw;
  const int wh = th + 2 * m, ww = tw + 2 * m, nwin = wh * ww;
  const int hw = h * w;

  // Shared memory: the staged input, the window's e chunk, the channel
  // sums and the cross-warp reduction.
  float* xs = smem;                                   // [nwin, kKC]
  float* es = xs + nwin * kKC;                        // [nwin, kCC]
  float* sums = es + nwin * kCC;                      // [Ce]
  float* red = sums + ce;                             // [kWarps, 32]

  const float* xb = p.x + static_cast<size_t>(b) * hw * cin;
  const int g_lo = t * p.tile;
  const int g_hi = min(g_lo + p.tile, hw);
  for (int c = tid; c < ce; c += kThreads) sums[c] = 0.f;

  for (int r0 = g_lo / w; r0 <= (g_hi - 1) / w; r0 += th) {
    for (int q0 = 0; q0 < w; q0 += tw) {
      const int gmin = r0 * w + q0;
      const int gmax = (min(r0 + th, h) - 1) * w + min(q0 + tw, w) - 1;
      if (gmax < g_lo || gmin >= g_hi) continue;  // block-uniform

      for (int c0 = 0; c0 < ce; c0 += kCC) {
        const int c = c0 + lane;
        const bool c_ok = c < ce;

        // 1. e for the window's pixels and this chunk's channels.
        if (p.has_expand) {
          for (int k0 = 0; k0 < cin; k0 += kKC) {
            __syncthreads();  // xs and es are free
            for (int i = tid; i < nwin * kKC; i += kThreads) {
              const int pix = i / kKC, kk = i % kKC;
              const int ir = r0 - m + pix / ww, ic = q0 - m + pix % ww;
              float v = 0.f;
              if (ir >= 0 && ir < h && ic >= 0 && ic < w && k0 + kk < cin)
                v = xb[(static_cast<size_t>(ir) * w + ic) * cin + k0 + kk];
              xs[i] = kFast ? bf16r(v) : v;
            }
            float wreg[kKC];
#pragma unroll
            for (int kk = 0; kk < kKC; ++kk) {
              const float v = (c_ok && k0 + kk < cin)
                                  ? p.w1[static_cast<size_t>(k0 + kk) * ce + c] : 0.f;
              wreg[kk] = kFast ? bf16r(v) : v;
            }
            __syncthreads();
            for (int i = warp; i < nwin; i += kWarps) {
              float acc = k0 == 0 ? 0.f : es[i * kCC + lane];
              const float4* xr = reinterpret_cast<const float4*>(xs + i * kKC);
#pragma unroll
              for (int q = 0; q < kKC / 4; ++q) {
                const float4 a = xr[q];
                acc = fmaf(a.x, wreg[4 * q], acc);
                acc = fmaf(a.y, wreg[4 * q + 1], acc);
                acc = fmaf(a.z, wreg[4 * q + 2], acc);
                acc = fmaf(a.w, wreg[4 * q + 3], acc);
              }
              es[i * kCC + lane] = acc;
            }
          }
          const float b1 = c_ok ? p.b1[c] : 0.f;
          for (int i = warp; i < nwin; i += kWarps) {
            const int ir = r0 - m + i / ww, ic = q0 - m + i % ww;
            const bool in = ir >= 0 && ir < h && ic >= 0 && ic < w && c_ok;
            const float v = swish(es[i * kCC + lane] + b1);
            es[i * kCC + lane] = in ? (kFast ? bf16r(v) : v) : 0.f;
          }
        } else {
          __syncthreads();  // es is free
          for (int i = warp; i < nwin; i += kWarps) {
            const int ir = r0 - m + i / ww, ic = q0 - m + i % ww;
            float v = 0.f;
            if (ir >= 0 && ir < h && ic >= 0 && ic < w && c_ok)
              v = xb[(static_cast<size_t>(ir) * w + ic) * cin + c];
            es[i * kCC + lane] = kFast ? bf16r(v) : v;
          }
        }
        __syncthreads();  // es complete

        // 2. the taps, grouped by column offset as the TPU kernel sums them.
        float wdr[K * K];
#pragma unroll
        for (int j = 0; j < K * K; ++j) {
          const float v = c_ok ? p.wd[static_cast<size_t>(j) * ce + c] : 0.f;
          wdr[j] = kFast ? bf16r(v) : v;
        }
        const float bdc = c_ok ? p.bd[c] : 0.f;
        float psum = 0.f;
        for (int q = warp; q < kP; q += kWarps) {
          const int oy = q / tw, ox = q % tw;
          float acc = 0.f;
#pragma unroll
          for (int dw = 0; dw < K; ++dw) {
            float part = 0.f;
#pragma unroll
            for (int dh = 0; dh < K; ++dh) {
              const float v = es[((oy + dh) * ww + ox + dw) * kCC + lane];
              part += kFast ? bf16r(v * wdr[dh * K + dw]) : v * wdr[dh * K + dw];
            }
            acc += part;
          }
          const float d = swish(acc + bdc);
          const int r = r0 + oy, col = q0 + ox, g = r * w + col;
          const bool in = r < h && col < w && g >= g_lo && g < g_hi && c_ok;
          if (in) psum += d;
        }

        red[warp * 32 + lane] = psum;
        __syncthreads();
        if (warp == 0 && c_ok) {
          float s = 0.f;
#pragma unroll
          for (int i = 0; i < kWarps; ++i) s += red[i * 32 + lane];
          sums[c] += s;
        }
        // the next chunk's first barrier orders red and sums
      }
      __syncthreads();  // the window's buffers are free
    }
  }

  __syncthreads();
  float* dst = p.partial + (static_cast<size_t>(b) * p.n_tiles + t) * ce;
  for (int c = tid; c < ce; c += kThreads) dst[c] = sums[c];
}

// sums[b, c] = sum over t, in tile order, of partial[b, t, c].
__global__ void tile_sum_kernel(const float* __restrict__ partial,
                                float* __restrict__ sums, int n_tiles, int ce) {
  const int b = blockIdx.y;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= ce) return;
  const float* src = partial + static_cast<size_t>(b) * n_tiles * ce + c;
  float s = 0.f;
  for (int t = 0; t < n_tiles; ++t) s += src[static_cast<size_t>(t) * ce];
  sums[static_cast<size_t>(b) * ce + c] = s;
}

// Window shape: th rows of tw = 64 / th columns, th the largest of 8, 4, 2, 1
// that a tile's rows fill.
void window(int tile, int w, int* th, int* tw) {
  const int rows = (tile + w - 1) / w;
  *th = rows >= 8 ? 8 : rows >= 4 ? 4 : rows >= 2 ? 2 : 1;
  *tw = kP / *th;
}

size_t smem_bytes(const Params& p, int k) {
  const int m = k / 2;
  const int nwin = (p.th + 2 * m) * (p.tw + 2 * m);
  const size_t floats = static_cast<size_t>(nwin) * (kCC + kKC) + p.ce + kWarps * 32;
  return floats * sizeof(float);
}

int launch(Params p, int batch, int k, int fast, cudaStream_t stream) {
  if ((k != 3 && k != 5) || batch <= 0 || batch > 65535 || p.h <= 0 || p.w <= 0 ||
      p.tile <= 0 || p.ce <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  window(p.tile, p.w, &p.th, &p.tw);
  const size_t smem = smem_bytes(p, k);
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > static_cast<size_t>(max_smem)) return static_cast<int>(cudaErrorInvalidValue);
  void (*kern)(const Params);
  if (k == 3)
    kern = fast ? pass1_kernel<3, true> : pass1_kernel<3, false>;
  else
    kern = fast ? pass1_kernel<5, true> : pass1_kernel<5, false>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<dim3(p.n_tiles, batch), kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Pass 1: sums [B, Ce] of d over each clip's map; partial [B, n_tiles, Ce]
// is scratch (n_tiles = ceil(H*W / tile)). The wrapper clips tile to the
// map as the JAX function does. Returns the CUDA error of the launches.
int psla_mbconv_pass1_launch(const void* x, const void* w1, const void* b1,
                             const void* wd, const void* bd, void* partial, void* sums,
                             int batch, int h, int w, int cin, int ce, int k, int tile,
                             int fast, int has_expand, void* stream) {
  Params p{};
  p.x = static_cast<const float*>(x);
  p.w1 = static_cast<const float*>(w1);
  p.b1 = static_cast<const float*>(b1);
  p.wd = static_cast<const float*>(wd);
  p.bd = static_cast<const float*>(bd);
  p.partial = static_cast<float*>(partial);
  p.h = h;
  p.w = w;
  p.cin = cin;
  p.ce = ce;
  p.tile = tile;
  p.n_tiles = tile > 0 ? (h * w + tile - 1) / tile : 0;
  p.has_expand = has_expand;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = launch(p, batch, k, fast, s);
  if (err != 0) return err;
  tile_sum_kernel<<<dim3((ce + 255) / 256, batch), 256, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(sums), p.n_tiles, ce);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
