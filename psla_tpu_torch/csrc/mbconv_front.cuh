// The front of the fused eval-mode MBConv v1 passes, shared by pass 1
// (mbconv_pass1.cu) and pass 2 (mbconv_pass2.cu), so that both stage x,
// round, store e and take the taps with the same code (the expand loop is
// pass 1's expand_chunk; pass 2 keeps the same loop inline):
//
//   e = swish(x @ w1 + b1)              (x itself when there is no expand)
//   d = swish(depthwise_kxk(e) + bd)    SAME: taps outside the map read 0
//
// A block of kThreads threads owns one window of output pixels of one clip
// and walks its expanded channels in chunks of kCC. The halo window of x
// (the window with m = k/2 rows and columns around it, all Cin channels)
// lies in shared memory, one pixel a row; e of one chunk lies beside it as
// [halo pixels, kCC].

#pragma once

#include <cstddef>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kCC = 32;        // expanded channels of one chunk

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float swish(float v) { return v / (1.f + expf(-v)); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void fma4(float* a, float s, const float4 w) {
  a[0] = fmaf(s, w.x, a[0]);
  a[1] = fmaf(s, w.y, a[1]);
  a[2] = fmaf(s, w.z, a[2]);
  a[3] = fmaf(s, w.w, a[3]);
}

// e of one halo pixel and 4 channels: bias, swish, zero outside the map
// (after the swish: SAME pads e, and swish(b1) != 0) or the chunk.
template <bool kFast>
__device__ __forceinline__ void store_e(float* es, const float (&a)[4], int pix, int nw,
                                        int ww, int base_y, int base_x, int h, int w,
                                        int cq, int nc, const float* b1s) {
  if (pix >= nw) return;
  const int ir = base_y + pix / ww, ic = base_x + pix % ww;
  const bool in = ir >= 0 && ir < h && ic >= 0 && ic < w;
  float o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = 4 * cq + i;
    const float v = swish(a[i] + b1s[c]);
    o[i] = (in && c < nc) ? (kFast ? bf16r(v) : v) : 0.f;
  }
  *reinterpret_cast<float4*>(es + pix * kCC + 4 * cq) = make_float4(o[0], o[1], o[2], o[3]);
}

// Copies a [rows, cols] block of floats (source row stride ld) into shared
// memory (row stride dst_ld), zero past rows_ok rows and cols_ok columns.
// vec: 16-byte cp.async (cols, cols_ok, ld, dst_ld and src 16-byte multiples,
// completed by cp_async_wait_all); else plain loads and stores.
__device__ __forceinline__ void stage(float* dst, int dst_ld, const float* src, size_t ld,
                                      int rows, int cols, int rows_ok, int cols_ok,
                                      bool vec, int tid) {
  if (vec) {
    const int q = cols >> 2;
    for (int i = tid; i < rows * q; i += kThreads) {
      const int r = i / q, c = 4 * (i - r * q);
      float* d = dst + r * dst_ld + c;
      if (r < rows_ok && c < cols_ok)
        cp_async16(d, src + r * ld + c);
      else
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int i = tid; i < rows * cols; i += kThreads) {
      const int r = i / cols, c = i - r * cols;
      dst[r * dst_ld + c] = (r < rows_ok && c < cols_ok) ? src[r * ld + c] : 0.f;
    }
  }
}

// Rounds n floats of shared memory to bfloat16 in place.
__device__ __forceinline__ void round_bf16(float* a, int n, int tid) {
  for (int i = tid; i < n; i += kThreads) a[i] = bf16r(a[i]);
}

// The halo window of one clip's x (xb: [h, w, cin]) into xs: the window at
// map position (y0, x0) with m rows and columns around it, nw pixels of ww
// a row, one pixel a row of xs_ld floats; all cin channels, zero-filled to
// cin4 (cin rounded up to 4). Pixels outside the map are zero. 16-byte
// cp.async when cin % 4 == 0 (completed by cp_async_wait_all), else plain
// loads and stores.
__device__ __forceinline__ void stage_halo(float* xs, int xs_ld, const float* xb, int nw,
                                           int ww, int y0, int x0, int m, int h, int w,
                                           int cin, int cin4, int tid) {
  if ((cin & 3) == 0) {
    const int q = cin >> 2;
    for (int i = tid; i < nw * q; i += kThreads) {
      const int pix = i / q, v = i - pix * q;
      const int ir = y0 - m + pix / ww, ic = x0 - m + pix % ww;
      float* dst = xs + pix * xs_ld + 4 * v;
      if (ir >= 0 && ir < h && ic >= 0 && ic < w)
        cp_async16(dst, xb + (static_cast<size_t>(ir) * w + ic) * cin + 4 * v);
      else
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int i = tid; i < nw * cin4; i += kThreads) {
      const int pix = i / cin4, c = i - pix * cin4;
      const int ir = y0 - m + pix / ww, ic = x0 - m + pix % ww;
      float v = 0.f;
      if (ir >= 0 && ir < h && ic >= 0 && ic < w && c < cin)
        v = xb[(static_cast<size_t>(ir) * w + ic) * cin + c];
      xs[pix * xs_ld + c] = v;
    }
  }
}

// d of output pixel (oy, ox) of the window for the lane's channel: the k*k
// taps over es (halo rows of ww pixels), summed grouped by column offset dw
// as the TPU kernel sums them, each tap's product rounded to bfloat16 when
// kFast; then bias and swish.
template <int K, bool kFast>
__device__ __forceinline__ float depthwise_d(const float* es, const float (&wdr)[K * K],
                                             float bdc, int oy, int ox, int ww, int lane) {
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
  return swish(acc + bdc);
}

}  // namespace
