// Fused eval-mode MBConv block, v1 pass 1, for Hopper: the squeeze-excite
// sums.
//
// Replaces the TPU kernel psla_tpu/ops/fused_mbconv.py::_pass1_kernel
// (launched by fused_mbconv_eval). One stride-1 EfficientNet block with
// BatchNorm folded (psla_tpu_torch/ops/fused_mbconv.py holds the wrapper,
// the launch geometry pass1_geometry and the plain version pass1_plain):
//
//   e = swish(x @ w1 + b1)              (x itself when there is no expand)
//   d = swish(depthwise_kxk(e) + bd)    SAME: taps outside the map read 0
//   sums[b, c] = sum over the map of d  (the SE mean's sum)
//
// The squeeze-excite MLP that turns the sums into the gate runs after this
// launch, in PyTorch; pass 2 (mbconv_pass2.cu) computes e and d again with
// the same arithmetic (the halo staging and the taps of mbconv_front.cuh,
// and the same expand loop) and projects. e and d never reach
// device memory. Each channel's sum is independent of the other channels
// and of the JAX function's row tiles, so this kernel picks its own windows
// and slices the expanded channels at no cost in extra products.
//
// Bound on an H100 SXM: operations. Over B2's 19 stride-1 blocks at the
// serving shape (16 clips, 64 x 528 after the stem) chip_smoke.py counts
// 0.4014 ms of pass 1's operations at the float32 CUDA-core rate
// (67 TFLOP/s), above the bytes of its inputs and outputs at 3.35 TB/s;
// only stride-1 blocks 0-1, without expand (16-32 channels), are bound by
// bytes. Nearly all of the operations are the expand product, so the
// design keeps the card's 132 SMs busy with it and reads x once a block.
//
// Design. The grid is windows x slices, as pass 2's. A block of 256 threads
// owns one th x tw window (at most 256 pixels; pass1_geometry picks the one
// with the least work with at most 12.5% of the computed pixels outside the
// map) of one clip and one slice of whole 32-channel chunks of the expanded
// channels; S, the number of slices, is the smallest that gives at least
// two blocks of threads an SM. The block writes its window's per-channel
// sums for its slice to partial [B, windows a clip, Ce], and
// window_sum_kernel adds each clip's windows in window order (no float
// atomics: a run gives the same bits every time).
//
//   0. the window's input pixels with their halo of m = k/2 rows and
//      columns, all Cin channels, are staged once in shared memory with
//      cp.async; pixels outside the map are zero;
//   for each chunk of 32 expanded channels of the slice (w1's chunk [Cin,
//   32] and b1 come in by cp.async during the previous chunk's taps; wd
//   [k*k, 32] and bd likewise, into the other of two buffers):
//   1. the expand e [window + halo, 32] is the register-tiled product of
//      pass 2 (2 pixels x 4 channels a thread); bias, swish, then e is zeroed
//      outside the map (after the swish: swish(b1) != 0, and SAME reads
//      zeros);
//   2. the k*k taps (lane = channel), summed grouped by column offset dw,
//      the TPU kernel's order; each warp adds d of its pixels that lie in
//      the map, in pixel order, into one sum a lane;
//   3. the eight warps' sums go to a [8, 32] table (two of them, by chunk
//      parity), which warp 0 adds in warp order after the next chunk's first
//      barrier and writes to partial: no barrier of their own.
//
// What bounds it as built: as in pass 2, the expand waits on shared memory
// (per 4 input channels a warp's 6 128-bit loads feed 32 FMAs), and the
// blocks whose halo window of x fills shared memory run one block of
// threads an SM, so barriers and staging are not hidden by another block.
//
// fast = 1 keeps the TPU kernel's rounding points: the operands of the
// expand product are rounded to bfloat16 and summed in float32, e is
// rounded to bfloat16, each tap's product is rounded to bfloat16 before
// its float32 sum; d stays float32. No library kernel is called.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mbconv_front.cuh"

namespace {

constexpr int kMaxP = 256;  // output pixels of one window, at most

struct Params {
  const float* x;      // [B, H, W, Cin]
  const float* w1;     // [Cin, Ce] or null
  const float* b1;     // [Ce] or null
  const float* wd;     // [k*k, Ce]
  const float* bd;     // [Ce]
  float* partial;      // [B, nwy * nwx, Ce]
  int h, w, cin, ce, has_expand;
  int th, tw, nwx, nwy;  // window, and windows a clip along W and H
  int slice_len;
  int xs_stride;         // floats
};

// The expand of one chunk: es [nw, kCC] = swish(xs @ w1s + b1s) over the
// halo window of stage_halo, zero outside the map, rounded to bfloat16 when
// kFast. w1s is the chunk's [cin4, kCC] slice of w1, b1s its kCC biases;
// nc of the kCC channels are real. A register-tiled product in rounds of
// 64 halo pixels: a thread holds 2 pixels x 4 channels and per 4 input
// channels loads 2 + 4 float4 for 32 FMAs. Pass 2 (mbconv_pass2.cu, step 1)
// runs the same loop written inline: called as this function there, it
// changed nvcc's register allocation of one of pass 2's instantiations.
template <bool kFast>
__device__ __forceinline__ void expand_chunk(float* es, const float* xs, int xs_ld,
                                             const float* w1s, const float* b1s, int nw,
                                             int ww, int cin4, int y0, int x0, int m, int h,
                                             int w, int nc, int lane, int warp) {
  const int cq = lane & 7, ps = lane >> 3;
  for (int base = 0; base < nw; base += 64) {
    if (base + warp * 4 >= nw) continue;  // warp-uniform
    const int p0 = base + warp * 4 + ps, p1 = p0 + 32;
    const float* x0r = xs + min(p0, nw - 1) * xs_ld;
    const float* x1r = xs + min(p1, nw - 1) * xs_ld;
    const float* wc = w1s + 4 * cq;
    float a0[4] = {0.f, 0.f, 0.f, 0.f}, a1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
    for (int k = 0; k < cin4; k += 4) {
      const float4 u = *reinterpret_cast<const float4*>(x0r + k);
      const float4 v = *reinterpret_cast<const float4*>(x1r + k);
      const float4 w0 = *reinterpret_cast<const float4*>(wc + (k + 0) * kCC);
      const float4 w1 = *reinterpret_cast<const float4*>(wc + (k + 1) * kCC);
      const float4 w2 = *reinterpret_cast<const float4*>(wc + (k + 2) * kCC);
      const float4 w3 = *reinterpret_cast<const float4*>(wc + (k + 3) * kCC);
      fma4(a0, u.x, w0);
      fma4(a1, v.x, w0);
      fma4(a0, u.y, w1);
      fma4(a1, v.y, w1);
      fma4(a0, u.z, w2);
      fma4(a1, v.z, w2);
      fma4(a0, u.w, w3);
      fma4(a1, v.w, w3);
    }
    const int base_y = y0 - m, base_x = x0 - m;
    store_e<kFast>(es, a0, p0, nw, ww, base_y, base_x, h, w, cq, nc, b1s);
    store_e<kFast>(es, a1, p1, nw, ww, base_y, base_x, h, w, cq, nc, b1s);
  }
}

// Shared memory of one block in floats; every part starts 16-byte aligned.
// Mirrored by _p1_smem in psla_tpu_torch/ops/fused_mbconv.py.
__host__ __device__ inline int smem_floats(const Params& p, int k) {
  const int m = k / 2;
  const int nw = (p.th + 2 * m) * (p.tw + 2 * m);
  const int w1 = p.has_expand ? ((p.cin + 3) & ~3) * kCC : 0;
  return nw * p.xs_stride + nw * kCC + w1 + kCC + 2 * (k * k + 1) * kCC +
         2 * kWarps * kCC;
}

template <int K, bool kFast>
__global__ void __launch_bounds__(kThreads, 2)
pass1_kernel(const Params p) {
  constexpr int m = K / 2;
  extern __shared__ float4 smem4[];
  float* const xs = reinterpret_cast<float*>(smem4);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = p.h, w = p.w, cin = p.cin, ce = p.ce;
  const int th = p.th, tw = p.tw, ww = tw + 2 * m, nw = (th + 2 * m) * ww;
  const int P = th * tw;
  const int cin4 = (cin + 3) & ~3;
  const int xsS = p.xs_stride;

  float* const es = xs + nw * xsS;          // [nw, kCC]      e of the chunk
  float* const w1s = es + nw * kCC;         // [cin4, kCC]    w1's chunk (with expand)
  float* const b1s = w1s + (p.has_expand ? cin4 * kCC : 0);  // [kCC]
  float* const wds = b1s + kCC;             // [2][K*K, kCC]  by chunk parity
  float* const bds = wds + 2 * K * K * kCC; // [2][kCC]
  float* const red = bds + 2 * kCC;         // [2][kWarps, kCC] the warps' sums

  const int per_clip = p.nwx * p.nwy;
  const int b = blockIdx.x / per_clip;
  const int wi = blockIdx.x - b * per_clip;
  const int y0 = (wi / p.nwx) * th, x0 = (wi % p.nwx) * tw;
  const int c_lo = blockIdx.y * p.slice_len;
  const int c_hi = min(ce, c_lo + p.slice_len);
  const float* const xb = p.x + static_cast<size_t>(b) * h * w * cin;
  float* const dst = p.partial + (static_cast<size_t>(b) * per_clip + wi) * ce;
  const bool vec = (ce & 3) == 0;  // 16-byte rows of weights

  // 0. the halo window of x, once.
  stage_halo(xs, xsS, xb, nw, ww, y0, x0, m, h, w, cin, cin4, tid);

  // The chunk's w1 and b1, and its wd and bd into buffer `buf`, in flight
  // while other work runs.
  auto stage_front = [&](int c0, int buf) {
    const int nc = min(kCC, c_hi - c0);
    if (p.has_expand) {
      stage(w1s, kCC, p.w1 + c0, ce, cin4, kCC, cin, nc, vec, tid);
      stage(b1s, kCC, p.b1 + c0, 0, 1, kCC, 1, nc, vec, tid);
    }
    stage(wds + buf * K * K * kCC, kCC, p.wd + c0, ce, K * K, kCC, K * K, nc, vec, tid);
    stage(bds + buf * kCC, kCC, p.bd + c0, 0, 1, kCC, 1, nc, vec, tid);
  };
  // Warp 0 adds the warps' sums of the chunk at c0 in warp order.
  auto flush = [&](int c0, int buf) {
    if (warp != 0 || c0 + lane >= c_hi) return;
    const float* r = red + buf * kWarps * kCC + lane;
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) s += r[i * kCC];
    dst[c0 + lane] = s;
  };
  stage_front(c_lo, 0);

  int c0 = c_lo, buf = 0;
  for (; c0 < c_hi; c0 += kCC, buf ^= 1) {
    const int nc = min(kCC, c_hi - c0);
    float* const wdb = wds + buf * K * K * kCC;
    cp_async_wait_all();
    __syncthreads();  // x and the chunk's front are in; es and red[buf] are free
    if (c0 > c_lo) flush(c0 - kCC, buf ^ 1);
    if (kFast) {
      if (c0 == c_lo) {
        for (int pix = warp; pix < nw; pix += kWarps)
          for (int c = lane; c < cin4; c += 32) xs[pix * xsS + c] = bf16r(xs[pix * xsS + c]);
      }
      if (p.has_expand) round_bf16(w1s, cin4 * kCC, tid);
      round_bf16(wdb, K * K * kCC, tid);
      __syncthreads();
    }

    // 1. the expand: e = swish(x @ w1 + b1) on the halo window.
    if (p.has_expand) {
      expand_chunk<kFast>(es, xs, xsS, w1s, b1s, nw, ww, cin4, y0, x0, m, h, w, nc, lane,
                          warp);
    } else {
      // no expand: e is x itself (zero outside the map, rounded when fast)
      for (int i = tid; i < nw * kCC; i += kThreads) {
        const int pix = i / kCC, c = i % kCC;
        es[i] = c < nc ? xs[pix * xsS + c0 + c] : 0.f;
      }
    }
    __syncthreads();  // es complete; w1s, b1s and the other wd/bd buffer free
    if (c0 + kCC < c_hi) stage_front(c0 + kCC, buf ^ 1);  // the next chunk's, in flight

    // 2. the taps, and each warp's sum of d over its pixels in the map.
    float wdr[K * K];
#pragma unroll
    for (int j = 0; j < K * K; ++j) wdr[j] = wdb[j * kCC + lane];
    const float bdc = bds[buf * kCC + lane];
    float psum = 0.f;
    for (int q = warp; q < P; q += kWarps) {
      const int oy = q / tw, ox = q % tw;
      const float d = depthwise_d<K, kFast>(es, wdr, bdc, oy, ox, ww, lane);
      if (y0 + oy < h && x0 + ox < w) psum += d;
    }
    red[(buf * kWarps + warp) * kCC + lane] = psum;
  }
  __syncthreads();  // the last chunk's warp sums are in
  flush(c0 - kCC, buf ^ 1);
}

// sums[b, c] = sum over the clip's windows t, in window order, of
// partial[b, t, c].
__global__ void window_sum_kernel(const float* __restrict__ partial,
                                  float* __restrict__ sums, int windows, int ce) {
  const int b = blockIdx.y;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= ce) return;
  const float* src = partial + static_cast<size_t>(b) * windows * ce + c;
  float s = 0.f;
#pragma unroll 8
  for (int t = 0; t < windows; ++t) s += src[static_cast<size_t>(t) * ce];
  sums[static_cast<size_t>(b) * ce + c] = s;
}

using Kernel = void (*)(const Params);

Kernel pick(int k, int fast) {
  if (k == 3) return fast ? pass1_kernel<3, true> : pass1_kernel<3, false>;
  return fast ? pass1_kernel<5, true> : pass1_kernel<5, false>;
}

}  // namespace

extern "C" {

// sums [B, Ce] of d over each clip's map, with the launch geometry of
// psla_tpu_torch.ops.fused_mbconv.pass1_geometry: window th x tw, S slices
// of slice_len expanded channels, threads (256) and smem bytes. partial
// [B, ceil(H/th) * ceil(W/tw), Ce] is scratch. Returns the CUDA error of
// the launches; cudaErrorInvalidValue for a geometry the kernel cannot run.
int psla_mbconv_pass1_launch(const void* x, const void* w1, const void* b1, const void* wd,
                             const void* bd, void* partial, void* sums, int batch, int h,
                             int w, int cin, int ce, int k, int fast, int has_expand, int th,
                             int tw, int slices, int slice_len, int threads, int smem,
                             void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if ((k != 3 && k != 5) || batch <= 0 || batch > 65535 || h <= 0 || w <= 0 || cin <= 0 ||
      ce <= 0 || th <= 0 || tw <= 0 || th * tw > kMaxP || threads != kThreads ||
      slices <= 0 || slices > 65535 || slice_len <= 0 || slice_len % kCC != 0 ||
      static_cast<long long>(slices) * slice_len < ce ||
      static_cast<long long>(slices - 1) * slice_len >= ce || (!has_expand && ce != cin) ||
      (has_expand && (w1 == nullptr || b1 == nullptr)) || partial == nullptr ||
      sums == nullptr)
    return invalid;
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
  p.has_expand = has_expand;
  p.th = th;
  p.tw = tw;
  p.nwy = (h + th - 1) / th;
  p.nwx = (w + tw - 1) / tw;
  p.slice_len = slice_len;
  p.xs_stride = ((cin + 7) & ~7) + 4;  // / 4 odd: a warp's 4 pixel rows on distinct banks
  const int per_clip = p.nwx * p.nwy;
  const long long grid_x = static_cast<long long>(batch) * per_clip;
  if (grid_x > 2147483647LL || smem != 4 * smem_floats(p, k)) return invalid;
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > max_smem) return invalid;
  const Kernel kern = pick(k, fast);
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  kern<<<dim3(static_cast<unsigned>(grid_x), slices), kThreads, smem, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  window_sum_kernel<<<dim3((ce + 127) / 128, batch), 128, 0, st>>>(
      p.partial, static_cast<float*>(sums), per_clip, ce);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
