// Fused eval-mode MBConv block, v1 pass 2, for Hopper.
//
// Replaces the TPU kernel psla_tpu/ops/fused_mbconv.py::_pass2_kernel
// (launched by fused_mbconv_eval). One stride-1 EfficientNet block with
// BatchNorm folded (psla_tpu_torch/ops/fused_mbconv.py holds the wrapper,
// the launch geometry pass2_geometry and the plain version pass2_plain):
//
//   e = swish(x @ w1 + b1)              (x itself when there is no expand)
//   d = swish(depthwise_kxk(e) + bd)    SAME: taps outside the map read 0
//   out = (d * gate[b]) @ wp + bp (+ x when Cin == Cout)
//
// e and d never reach device memory. Each output pixel's sum runs over the
// expanded channels only, so the output does not depend on the JAX
// function's row tiles, and this kernel picks its own windows. Step 0 (the
// halo staging) and step 2's taps are functions of mbconv_front.cuh, which
// pass 1 (mbconv_pass1.cu) runs too; step 1's loop is pass 1's expand_chunk,
// kept inline here because as a call it changed nvcc's register allocation
// of one of this kernel's instantiations.
//
// Bound on an H100 SXM: operations (the two 1x1 products, in full float32
// on the CUDA cores: 67 TFLOP/s); over B2's 19 stride-1 blocks at the
// serving shape chip_smoke.py counts 0.73 ms. Only blocks without expand
// (16-32 channels) are bound by bytes.
//
// Design. The grid is windows x slices. A block of 256 threads owns one
// th x tw window (th * tw <= 64 pixels, chosen from the map's width so that
// at most 12.5% of the computed pixels lie outside the map) of one clip and
// one slice of the expanded channels; S slices are chosen so that the grid
// has at least two blocks an SM. With S = 1 the block writes the output;
// with S > 1 it writes its [P, Cout] partial product to scratch, and
// slice_sum_kernel adds the S partials in slice order, then bp and the
// residual (no float atomics: a run gives the same bits every time).
//
//   0. the window's input pixels with their halo of m = k/2 rows and
//      columns, all Cin channels, are staged once in shared memory with
//      cp.async (16 bytes a thread when Cin % 4 == 0, else one float);
//      pixels outside the map are zero;
//   for each chunk of 32 expanded channels of the slice (the weights come
//   in by cp.async one phase ahead: w1's chunk [Cin, 32], wd's [k*k, 32],
//   b1, bd and the gate during the last chunk's projection, wp's rows
//   [32, Cout] during this chunk's expand and taps):
//   1. the expand e [window + halo, 32] is a register-tiled product: a
//      thread holds 2 pixels x 4 channels and per 4 input channels loads
//      2 + 4 float4 for 32 FMAs; bias, swish, then e is zeroed outside the
//      map (after the swish: swish(b1) != 0, and SAME reads zeros);
//   2. the k*k taps (lane = channel) are summed grouped by column offset
//      dw, the TPU kernel's order, and the gated d is stored transposed
//      [32, P];
//   3. the projection: a thread holds 4 pixels x TN output channels in
//      registers across all the chunks of its slice, and per expanded
//      channel loads one float4 of d and TN values of wp for 4 * TN FMAs.
//
// What bounds it as built: shared-memory traffic and latency, not the FMA
// rate. A 128-bit shared load costs four wavefronts whatever its broadcast,
// so per 4 input channels a warp's 6 loads of the expand (24 wavefronts)
// feed only 32 FMAs; and with one to three blocks of 8 warps an SM, the
// barriers and the staging latency show. The launch bounds keep TN <= 12
// at two blocks an SM and TN = 2 at three (128 and 80 registers, no
// spills): the 64 x 528 maps with few channels need the occupancy most.
//
// fast = 1 keeps the TPU kernel's rounding points: the operands of both
// 1x1 products and of the taps are rounded to bfloat16 and summed in
// float32, e is rounded to bfloat16, d and the gate stay float32. No
// library kernel is called.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mbconv_front.cuh"

namespace {

constexpr int kMaxP = 64;      // output pixels of one window, at most

struct Params {
  const float* x;      // [B, H, W, Cin]
  const float* w1;     // [Cin, Ce] or null
  const float* b1;     // [Ce] or null
  const float* wd;     // [k*k, Ce]
  const float* bd;     // [Ce]
  const float* gate;   // [B, Ce]
  const float* wp;     // [Ce, Cout]
  const float* bp;     // [Cout]
  float* out;          // [B, H, W, Cout]
  float* partial;      // [S, B*H*W, Cout] when S > 1
  int batch, h, w, cin, ce, cout, has_expand;
  int th, tw, nwx, nwy;      // window, and windows a clip along W and H
  int slices, slice_len;
  int tp, tc;                // projection: pixel groups of 4, channel groups
  int xs_stride, gt_stride, w_stride;  // floats
};

// Shared memory of one block in floats; every part starts 16-byte aligned.
__host__ __device__ inline int smem_floats(const Params& p, int k) {
  const int m = k / 2;
  const int nw = (p.th + 2 * m) * (p.tw + 2 * m);
  const int w1 = p.has_expand ? ((p.cin + 3) & ~3) * kCC : 0;
  return nw * p.xs_stride + nw * kCC + kCC * p.gt_stride + w1 + kCC * p.w_stride +
         (k * k + 3) * kCC;
}

template <int K, bool kFast, int TN>
__global__ void __launch_bounds__(kThreads, TN <= 2 ? 3 : TN <= 12 ? 2 : 1)
pass2_kernel(const Params p) {
  constexpr int m = K / 2;
  extern __shared__ float4 smem4[];
  float* const xs = reinterpret_cast<float*>(smem4);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = p.h, w = p.w, cin = p.cin, ce = p.ce, cout = p.cout;
  const int th = p.th, tw = p.tw, ww = tw + 2 * m, nw = (th + 2 * m) * ww;
  const int P = th * tw, hw = h * w;
  const int cin4 = (cin + 3) & ~3;
  const int xsS = p.xs_stride, gtS = p.gt_stride, wS = p.w_stride;

  float* const es = xs + nw * xsS;        // [nw, kCC]   e of the chunk
  float* const gt = es + nw * kCC;        // [kCC, gtS]  gated d, transposed
  float* const w1s = gt + kCC * gtS;      // [cin4, kCC] w1's chunk (with expand)
  float* const wps = w1s + (p.has_expand ? cin4 * kCC : 0);  // [kCC, wS] wp's rows
  float* const wds = wps + kCC * wS;      // [K*K, kCC]
  float* const b1s = wds + K * K * kCC;   // [kCC]
  float* const bds = b1s + kCC;           // [kCC]
  float* const gs = bds + kCC;            // [kCC]

  const int per_clip = p.nwx * p.nwy;
  const int b = blockIdx.x / per_clip;
  const int wi = blockIdx.x - b * per_clip;
  const int y0 = (wi / p.nwx) * th, x0 = (wi % p.nwx) * tw;
  const int s = blockIdx.y;
  const int c_lo = s * p.slice_len;
  const int c_hi = min(ce, c_lo + p.slice_len);
  const float* const xb = p.x + static_cast<size_t>(b) * hw * cin;
  const bool vec = (ce & 3) == 0 && (cout & 3) == 0;  // 16-byte rows of weights

  // 0. the halo window of x, once.
  stage_halo(xs, xsS, xb, nw, ww, y0, x0, m, h, w, cin, cin4, tid);

  // The chunk's w1, wd, b1, bd and gate, in flight while other work runs.
  auto stage_front = [&](int c0) {
    const int nc = min(kCC, c_hi - c0);
    if (p.has_expand) stage(w1s, kCC, p.w1 + c0, ce, cin4, kCC, cin, nc, vec, tid);
    stage(wds, kCC, p.wd + c0, ce, K * K, kCC, K * K, nc, vec, tid);
    if (p.has_expand) stage(b1s, kCC, p.b1 + c0, 0, 1, kCC, 1, nc, vec, tid);
    else if (tid < kCC) b1s[tid] = 0.f;
    stage(bds, kCC, p.bd + c0, 0, 1, kCC, 1, nc, vec, tid);
    stage(gs, kCC, p.gate + static_cast<size_t>(b) * ce + c0, 0, 1, kCC, 1, nc, vec, tid);
  };
  stage_front(c_lo);

  const bool proj_on = tid < p.tp * p.tc;
  const int pg = proj_on ? tid / p.tc : 0, cg = proj_on ? tid % p.tc : 0;
  float acc[4][TN];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int c0 = c_lo; c0 < c_hi; c0 += kCC) {
    const int nc = min(kCC, c_hi - c0);
    cp_async_wait_all();
    __syncthreads();  // x and the chunk's front weights are in; gt and wps are free
    if (kFast) {
      if (c0 == c_lo) {
        for (int pix = warp; pix < nw; pix += kWarps)
          for (int c = lane; c < cin4; c += 32) xs[pix * xsS + c] = bf16r(xs[pix * xsS + c]);
      }
      if (p.has_expand) round_bf16(w1s, cin4 * kCC, tid);
      round_bf16(wds, K * K * kCC, tid);
      __syncthreads();
    }

    // 1. the expand: e = swish(x @ w1 + b1) on the halo window.
    if (p.has_expand) {
      const int cq = lane & 7, ps = lane >> 3;
      for (int base = 0; base < nw; base += 64) {
        if (base + warp * 4 >= nw) continue;  // warp-uniform
        const int p0 = base + warp * 4 + ps, p1 = p0 + 32;
        const float* x0r = xs + min(p0, nw - 1) * xsS;
        const float* x1r = xs + min(p1, nw - 1) * xsS;
        const float* wc = w1s + 4 * cq;
        float a0[4] = {0.f, 0.f, 0.f, 0.f}, a1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll (TN <= 2 ? 1 : 2)
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
    } else {
      // no expand: e is x itself (zero outside the map, rounded when fast)
      for (int i = tid; i < nw * kCC; i += kThreads) {
        const int pix = i / kCC, c = i % kCC;
        es[i] = c < nc ? xs[pix * xsS + c0 + c] : 0.f;
      }
    }
    __syncthreads();  // es complete

    // 2. wp's rows of the chunk in flight; the taps, gated, into gt.
    stage(wps, wS, p.wp + static_cast<size_t>(c0) * cout, cout, kCC, wS, nc, cout, vec, tid);
    {
      float wdr[K * K];
#pragma unroll
      for (int j = 0; j < K * K; ++j) wdr[j] = wds[j * kCC + lane];
      const float bdc = bds[lane], gc = gs[lane];
      for (int q = warp; q < 4 * p.tp; q += kWarps) {
        float gd = 0.f;
        if (q < P) {
          const int oy = q / tw, ox = q % tw;
          const float d = depthwise_d<K, kFast>(es, wdr, bdc, oy, ox, ww, lane);
          if (y0 + oy < h && x0 + ox < w && lane < nc) gd = d * gc;
        }
        gt[lane * gtS + q] = kFast ? bf16r(gd) : gd;
      }
    }
    cp_async_wait_all();
    __syncthreads();  // gt and wp's rows complete; w1s, wds and the vectors free
    if (c0 + kCC < c_hi) stage_front(c0 + kCC);  // the next chunk's, in flight
    if (kFast) {
      round_bf16(wps, kCC * wS, tid);
      __syncthreads();
    }

    // 3. acc += gt^T @ wp rows, in registers.
    if (proj_on) {
      const float* gp = gt + 4 * pg;
      const float* wq = wps + cg;
#pragma unroll 4
      for (int k = 0; k < kCC; ++k) {
        const float4 g = *reinterpret_cast<const float4*>(gp + k * gtS);
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const float wv = wq[k * wS + j * p.tc];
          acc[0][j] = fmaf(g.x, wv, acc[0][j]);
          acc[1][j] = fmaf(g.y, wv, acc[1][j]);
          acc[2][j] = fmaf(g.z, wv, acc[2][j]);
          acc[3][j] = fmaf(g.w, wv, acc[3][j]);
        }
      }
    }
  }

  if (!proj_on) return;
  const bool direct = p.slices == 1;
  const bool residual = cin == cout;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = 4 * pg + i;
    if (q >= P) continue;
    const int r = y0 + q / tw, col = x0 + q % tw;
    if (r >= h || col >= w) continue;
    const size_t row = static_cast<size_t>(b) * hw + static_cast<size_t>(r) * w + col;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = cg + j * p.tc;
      if (n >= cout) continue;
      float v = acc[i][j];
      if (direct) {
        v += p.bp[n];
        if (residual) v += p.x[row * cin + n];
        p.out[row * cout + n] = v;
      } else {
        p.partial[(static_cast<size_t>(s) * p.batch * hw + row) * cout + n] = v;
      }
    }
  }
}

// out = sum over s, in slice order, of partial[s] + bp (+ x when Cin == Cout).
__global__ void slice_sum_kernel(const float* __restrict__ partial,
                                 const float* __restrict__ bp, const float* __restrict__ x,
                                 float* __restrict__ out, int slices, size_t n, int cout,
                                 int residual) {
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float v = 0.f;
    for (int s = 0; s < slices; ++s) v += partial[static_cast<size_t>(s) * n + i];
    v += bp[i % cout];
    if (residual) v += x[i];
    out[i] = v;
  }
}

using Kernel = void (*)(const Params);

template <int K, bool kFast>
Kernel pick_tn(int tn) {
  switch (tn) {
    case 2: return pass2_kernel<K, kFast, 2>;
    case 4: return pass2_kernel<K, kFast, 4>;
    case 8: return pass2_kernel<K, kFast, 8>;
    case 12: return pass2_kernel<K, kFast, 12>;
    case 16: return pass2_kernel<K, kFast, 16>;
    case 24: return pass2_kernel<K, kFast, 24>;
    default: return nullptr;
  }
}

Kernel pick(int k, int fast, int tn) {
  if (k == 3) return fast ? pick_tn<3, true>(tn) : pick_tn<3, false>(tn);
  return fast ? pick_tn<5, true>(tn) : pick_tn<5, false>(tn);
}

}  // namespace

extern "C" {

// out [B, H, W, Cout] = (d * gate) @ wp + bp (+ x when Cin == Cout), with the
// launch geometry of psla_tpu_torch.ops.fused_mbconv.pass2_geometry: window
// th x tw, S slices of slice_len expanded channels, tc output-channel groups
// of tn channels, threads (256) and smem bytes. partial [S, B*H*W, Cout] is
// scratch when S > 1. Returns the CUDA error of the launches;
// cudaErrorInvalidValue for a geometry the kernel cannot run.
int psla_mbconv_pass2_launch(const void* x, const void* w1, const void* b1, const void* wd,
                             const void* bd, const void* gate, const void* wp,
                             const void* bp, void* out, void* partial, int batch, int h,
                             int w, int cin, int ce, int cout, int k, int fast,
                             int has_expand, int th, int tw, int slices, int slice_len,
                             int tc, int tn, int threads, int smem, void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if ((k != 3 && k != 5) || batch <= 0 || h <= 0 || w <= 0 || cin <= 0 || ce <= 0 ||
      cout <= 0 || th <= 0 || tw <= 0 || th * tw > kMaxP || tc <= 0 || threads != kThreads ||
      slices <= 0 || slices > 65535 || slice_len <= 0 || slice_len % kCC != 0 ||
      static_cast<long long>(slices) * slice_len < ce ||
      static_cast<long long>(slices - 1) * slice_len >= ce || (!has_expand && ce != cin) ||
      (has_expand && (w1 == nullptr || b1 == nullptr)) || (slices > 1 && partial == nullptr))
    return invalid;
  Params p{};
  p.x = static_cast<const float*>(x);
  p.w1 = static_cast<const float*>(w1);
  p.b1 = static_cast<const float*>(b1);
  p.wd = static_cast<const float*>(wd);
  p.bd = static_cast<const float*>(bd);
  p.gate = static_cast<const float*>(gate);
  p.wp = static_cast<const float*>(wp);
  p.bp = static_cast<const float*>(bp);
  p.out = static_cast<float*>(out);
  p.partial = static_cast<float*>(partial);
  p.batch = batch;
  p.h = h;
  p.w = w;
  p.cin = cin;
  p.ce = ce;
  p.cout = cout;
  p.has_expand = has_expand;
  p.th = th;
  p.tw = tw;
  p.nwy = (h + th - 1) / th;
  p.nwx = (w + tw - 1) / tw;
  p.slices = slices;
  p.slice_len = slice_len;
  p.tp = (th * tw + 3) / 4;
  p.tc = tc;
  p.xs_stride = ((cin + 7) & ~7) + 4;  // / 4 odd: a warp's 4 pixel rows on distinct banks
  p.gt_stride = 4 * p.tp + 4;
  p.w_stride = (tc * tn + 3) & ~3;  // 16-byte rows
  const Kernel kern = pick(k, fast, tn);
  const long long grid_x = static_cast<long long>(batch) * p.nwx * p.nwy;
  if (kern == nullptr || p.tp * tc > kThreads || static_cast<long long>(tc) * tn < cout ||
      grid_x > 2147483647LL || smem != 4 * smem_floats(p, k))
    return invalid;
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > max_smem) return invalid;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  kern<<<dim3(static_cast<unsigned>(grid_x), slices), kThreads, smem, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || slices == 1) return static_cast<int>(err);
  const size_t n = static_cast<size_t>(batch) * h * w * cout;
  const size_t blocks = (n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096;
  slice_sum_kernel<<<static_cast<unsigned>(blocks), 256, 0, st>>>(
      p.partial, p.bp, p.x, p.out, slices, n, cout, cin == cout);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
