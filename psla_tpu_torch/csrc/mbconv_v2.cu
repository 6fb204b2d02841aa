// Fused eval-mode MBConv block, v2: one cooperative launch per block.
//
// Replaces the TPU kernel psla_tpu/ops/mbconv_vmem.py::_eval_kernel
// (launched by fused_mbconv_eval_v2). One EfficientNet block with BatchNorm
// folded, stride 1 or 2, k 3 or 5, with or without expand
// (psla_tpu_torch/ops/mbconv_vmem.py holds the wrapper and the plain
// version, fused_mbconv_eval_v2_plain):
//
//   e    = swish(x @ w1 + b1)                  (x itself when there is no expand)
//   d    = swish(depthwise_kxk_stride(e) + bd) SAME: taps outside the map read 0
//   gate = sigmoid(swish(mean(d) @ wr + br) @ we + be)   per clip
//   out  = (d * gate) @ wp + bp  (+ x when stride is 1 and Cin == Cout)
//
// Bound on an H100 SXM: operations. At the serving shape (16 clips, B2's 23
// blocks, 64 x 528 after the stem) chip_smoke.py counts ~56 GFLOP against
// ~0.44 GB of block inputs, outputs and weights: ~0.83 ms at the float32
// CUDA-core rate (67 TFLOP/s) against ~0.13 ms at 3.35 TB/s. The first two
// blocks (no expand, 16-32 channels) are bound by bytes.
//
// Design. The TPU kernel holds one clip's whole map in VMEM (up to
// 110 MB); an SM has 228 KB of shared memory, and the squeeze-excite mean
// needs all of a clip's d before any output can be gated. So the kernel is
// one cooperative launch (cudaLaunchCooperativeKernel) of persistent
// blocks, sized from the occupancy query so that all are resident, that
// walk work items in four phases with a grid-wide barrier between phases:
//   A. (expand only) e = swish(x @ w1 + b1) as 64 x 64 output tiles of a
//      product on the CUDA cores, written once to device scratch in the
//      activation type;
//   B. the depthwise taps and swish for (clip, 64 output pixels, 32
//      channels) items; d goes to device scratch, and each item writes its
//      per-channel partial sum (a fixed order of adds inside the item);
//   C. per clip: the mean from the partial sums in item order, and the SE
//      MLP, into a gate in device scratch;
//   D. out = (d * gate) @ wp + bp (+ x), again as 64 x 64 tiles.
// No float atomics: a run gives the same bits every time. e and d cross
// device memory once each (write, then read): at the serving shape that is
// bytes the bound above does not count, which this design accepts because
// operations, not bytes, bound the block. The products run on the CUDA
// cores (no tensor cores yet), and no library kernel is called.
//
// fast = 1 follows the TPU kernel's rounding points: the operands of both
// 1x1 products are rounded to bfloat16 and summed in float32; e and d are
// stored in bfloat16; each tap's product is rounded to bfloat16 before its
// float32 sum; the mean is taken of the bfloat16 d; the gate is rounded to
// bfloat16 and the gated d is a bfloat16 product.

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTM = 64, kTN = 64, kTK = 32;  // product tile and its depth chunk
constexpr int kAP = kTM + 4;                 // row pitch of the A chunk (floats)
constexpr int kPT = 64;                      // output pixels of a depthwise item
constexpr int kCT = 32;                      // channels of a depthwise item (= lanes)

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <class T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}
__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }
__device__ __forceinline__ float swish(float v) { return v / (1.f + expf(-v)); }

template <class TX, class TA>
struct Params {
  const TX* x;                       // [B, H, W, Cin]
  const float *w1, *b1;              // [Cin, Ce], [Ce] (null without expand)
  const float *wd, *bd;              // [k*k, Ce], [Ce]
  const float *wr, *br, *we, *be;    // [Ce, Cse], [Cse], [Cse, Ce], [Ce]
  const float *wp, *bp;              // [Ce, Cout], [Cout]
  TX* out;                           // [B, Ho, Wo, Cout]
  TA* e;                             // [B, H, W, Ce] scratch (expand only)
  TA* d;                             // [B, Ho, Wo, Ce] scratch
  float* partial;                    // [B, n_pt, Ce] scratch
  float* gate;                       // [B, Ce] scratch
  int batch, h, w, cin, ce, cse, cout, stride, ho, wo, lo_h, lo_w, n_pt, has_expand, skip;
};

// One 64 x 64 tile of C = A @ B: A's elements come from load_a(m, k), B is
// row-major [K, N] float32; epi(m, n, sum) receives each in-range sum.
// 16 x 16 threads, 4 x 4 outputs each, K in chunks of 32 through shared
// memory. kRound rounds both operands to bfloat16 (sums stay float32).
template <bool kRound, class LoadA, class Epi>
__device__ __forceinline__ void gemm_tile(int m0, int n0, int M, int N, int K,
                                          const float* __restrict__ B, LoadA load_a,
                                          Epi epi, float* as, float* bs) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kTK) {
    __syncthreads();  // the previous chunk (or item) is consumed
    for (int i = tid; i < kTM * kTK; i += kThreads) {
      const int mm = i / kTK, kk = i % kTK, m = m0 + mm, k = k0 + kk;
      const float v = (m < M && k < K) ? load_a(m, k) : 0.f;
      as[kk * kAP + mm] = kRound ? bf16r(v) : v;
    }
    for (int i = tid; i < kTK * kTN; i += kThreads) {
      const int kk = i / kTN, nn = i % kTN, k = k0 + kk, n = n0 + nn;
      const float v = (k < K && n < N) ? B[static_cast<size_t>(k) * N + n] : 0.f;
      bs[kk * kTN + nn] = kRound ? bf16r(v) : v;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kTK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(as + kk * kAP + ty * 4);
      const float4 b = *reinterpret_cast<const float4*>(bs + kk * kTN + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) epi(m, n, acc[i][j]);
    }
  }
}

template <class TX, class TA, int K>
__global__ void __launch_bounds__(kThreads, 2)
mbconv_v2_kernel(const Params<TX, TA> p) {
  constexpr bool kFast = std::is_same<TA, bf16>::value;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ce = p.ce, cin = p.cin, cout = p.cout;
  const int hw = p.h * p.w, P = p.ho * p.wo;

  // A. e = swish(x @ w1 + b1)
  if (p.has_expand) {
    const int M = p.batch * hw;
    const int tn = (ce + kTN - 1) / kTN;
    const int items = (M + kTM - 1) / kTM * tn;
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      gemm_tile<kFast>(
          it / tn * kTM, it % tn * kTN, M, ce, cin, p.w1,
          [&](int m, int k) { return to_f(p.x[static_cast<size_t>(m) * cin + k]); },
          [&](int m, int n, float s) {
            p.e[static_cast<size_t>(m) * ce + n] = from_f<TA>(swish(s + p.b1[n]));
          },
          smem, smem + kTK * kAP);
    }
    grid.sync();
  }

  // B. d = swish(taps + bd), per-item channel partial sums
  {
    float* red = smem;  // [kWarps, 32]
    const int nct = (ce + kCT - 1) / kCT;
    const int items = p.batch * p.n_pt * nct;
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      const int b = it / (p.n_pt * nct), pt = it / nct % p.n_pt;
      const int c = it % nct * kCT + lane;
      const bool c_ok = c < ce;
      float wdr[K * K];
#pragma unroll
      for (int j = 0; j < K * K; ++j)
        wdr[j] = c_ok ? to_f(from_f<TA>(p.wd[static_cast<size_t>(j) * ce + c])) : 0.f;
      const float bdc = c_ok ? p.bd[c] : 0.f;
      float sum = 0.f;
      for (int q = pt * kPT + warp; q < min(pt * kPT + kPT, P); q += kWarps) {
        const int ih0 = q / p.wo * p.stride - p.lo_h;
        const int iw0 = q % p.wo * p.stride - p.lo_w;
        float acc = 0.f;
#pragma unroll
        for (int dw = 0; dw < K; ++dw) {
#pragma unroll
          for (int dh = 0; dh < K; ++dh) {
            const int ih = ih0 + dh, iw = iw0 + dw;
            float v = 0.f;
            if (c_ok && ih >= 0 && ih < p.h && iw >= 0 && iw < p.w) {
              const size_t pix = (static_cast<size_t>(b) * p.h + ih) * p.w + iw;
              v = p.has_expand ? to_f(p.e[pix * ce + c])
                               : to_f(from_f<TA>(to_f(p.x[pix * cin + c])));
            }
            acc += kFast ? bf16r(v * wdr[dh * K + dw]) : v * wdr[dh * K + dw];
          }
        }
        const TA dq = from_f<TA>(swish(acc + bdc));
        if (c_ok) p.d[(static_cast<size_t>(b) * P + q) * ce + c] = dq;
        sum += to_f(dq);
      }
      __syncthreads();  // red is free
      red[warp * 32 + lane] = sum;
      __syncthreads();
      if (warp == 0 && c_ok) {
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < kWarps; ++i) s += red[i * 32 + lane];
        p.partial[(static_cast<size_t>(b) * p.n_pt + pt) * ce + c] = s;
      }
    }
  }
  grid.sync();

  // C. gate = sigmoid(swish(mean(d) @ wr + br) @ we + be), one clip an item
  {
    float* mean = smem;       // [Ce]
    float* hid = smem + ce;   // [Cse]
    for (int b = blockIdx.x; b < p.batch; b += gridDim.x) {
      __syncthreads();  // the previous item's reads are done
      for (int c = tid; c < ce; c += kThreads) {
        const float* src = p.partial + static_cast<size_t>(b) * p.n_pt * ce + c;
        float s = 0.f;
        for (int t = 0; t < p.n_pt; ++t) s += src[static_cast<size_t>(t) * ce];
        mean[c] = s / static_cast<float>(P);
      }
      __syncthreads();
      for (int j = tid; j < p.cse; j += kThreads) {
        float s = 0.f;
        for (int c = 0; c < ce; ++c) s = fmaf(mean[c], p.wr[static_cast<size_t>(c) * p.cse + j], s);
        hid[j] = swish(s + p.br[j]);
      }
      __syncthreads();
      for (int c = tid; c < ce; c += kThreads) {
        float s = 0.f;
        for (int j = 0; j < p.cse; ++j) s = fmaf(hid[j], p.we[static_cast<size_t>(j) * ce + c], s);
        p.gate[static_cast<size_t>(b) * ce + c] = sigmoid(s + p.be[c]);
      }
    }
  }
  grid.sync();

  // D. out = (d * gate) @ wp + bp (+ x)
  {
    const int M = p.batch * P;
    const int tn = (cout + kTN - 1) / kTN;
    const int items = (M + kTM - 1) / kTM * tn;
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      gemm_tile<kFast>(
          it / tn * kTM, it % tn * kTN, M, cout, ce, p.wp,
          [&](int m, int k) {
            const float g = p.gate[static_cast<size_t>(m / P) * ce + k];
            const float dv = to_f(p.d[static_cast<size_t>(m) * ce + k]);
            return kFast ? bf16r(dv * bf16r(g)) : dv * g;
          },
          [&](int m, int n, float s) {
            float v = s + p.bp[n];
            if (p.skip) v += to_f(p.x[static_cast<size_t>(m) * cin + n]);
            p.out[static_cast<size_t>(m) * cout + n] = from_f<TX>(v);
          },
          smem, smem + kTK * kAP);
    }
  }
}

int same_out(int n, int k, int s, int* lo) {
  const int out = (n + s - 1) / s;
  const int total = std::max((out - 1) * s + k - n, 0);
  *lo = total / 2;
  return out;
}

template <class TX, class TA, int K>
int launch(const void* const* ptrs, const int* dims, cudaStream_t stream) {
  Params<TX, TA> p{};
  p.x = static_cast<const TX*>(ptrs[0]);
  const float** f[] = {&p.w1, &p.b1, &p.wd, &p.bd, &p.wr, &p.br, &p.we, &p.be, &p.wp, &p.bp};
  for (int i = 0; i < 10; ++i) *f[i] = static_cast<const float*>(ptrs[1 + i]);
  p.out = static_cast<TX*>(const_cast<void*>(ptrs[11]));
  p.e = static_cast<TA*>(const_cast<void*>(ptrs[12]));
  p.d = static_cast<TA*>(const_cast<void*>(ptrs[13]));
  p.partial = static_cast<float*>(const_cast<void*>(ptrs[14]));
  p.gate = static_cast<float*>(const_cast<void*>(ptrs[15]));
  p.batch = dims[0];
  p.h = dims[1];
  p.w = dims[2];
  p.cin = dims[3];
  p.ce = dims[4];
  p.cse = dims[5];
  p.cout = dims[6];
  p.stride = dims[8];
  p.has_expand = dims[9];
  p.ho = same_out(p.h, K, p.stride, &p.lo_h);
  p.wo = same_out(p.w, K, p.stride, &p.lo_w);
  p.n_pt = (p.ho * p.wo + kPT - 1) / kPT;
  p.skip = p.stride == 1 && p.cin == p.cout;
  if (p.has_expand && (!p.w1 || !p.b1)) return static_cast<int>(cudaErrorInvalidValue);
  if (!p.has_expand && p.cin != p.ce) return static_cast<int>(cudaErrorInvalidValue);

  auto kern = mbconv_v2_kernel<TX, TA, K>;
  const size_t smem = sizeof(float) * std::max<size_t>(
      {static_cast<size_t>(kTK * kAP + kTK * kTN), static_cast<size_t>(kWarps * 32),
       static_cast<size_t>(p.ce + p.cse)});
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop || per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const long long hw = static_cast<long long>(p.h) * p.w, P = static_cast<long long>(p.ho) * p.wo;
  const long long items = std::max<long long>(
      {(p.batch * hw + kTM - 1) / kTM * ((p.ce + kTN - 1) / kTN),
       static_cast<long long>(p.batch) * p.n_pt * ((p.ce + kCT - 1) / kCT),
       static_cast<long long>(p.batch),
       (p.batch * P + kTM - 1) / kTM * ((p.cout + kTN - 1) / kTN)});
  const int blocks = static_cast<int>(std::min<long long>(per_sm * sms, items));
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kern), dim3(blocks),
                                    dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One block: out [B, Ho, Wo, Cout] in x's type (float32, or bfloat16 when
// x_bf16). e ([B, H, W, Ce], null without expand), d ([B, Ho, Wo, Ce]) are
// scratch in the activation type (bfloat16 when fast, else float32);
// partial ([B, ceil(Ho*Wo / 64), Ce]) and gate ([B, Ce]) are float32
// scratch. Returns the CUDA error of the launch (0 on success).
int psla_mbconv_v2_launch(const void* x, const void* w1, const void* b1, const void* wd,
                          const void* bd, const void* wr, const void* br, const void* we,
                          const void* be, const void* wp, const void* bp, void* out,
                          void* e, void* d, void* partial, void* gate, int batch, int h,
                          int w, int cin, int ce, int cse, int cout, int k, int stride,
                          int fast, int has_expand, int x_bf16, void* stream) {
  if ((k != 3 && k != 5) || (stride != 1 && stride != 2) || batch <= 0 || h <= 0 ||
      w <= 0 || cin <= 0 || ce <= 0 || cse <= 0 || cout <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[] = {x, w1, b1, wd, bd, wr, br, we, be, wp, bp, out, e, d, partial, gate};
  const int dims[] = {batch, h, w, cin, ce, cse, cout, k, stride, has_expand};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    if (fast) return k == 3 ? launch<bf16, bf16, 3>(ptrs, dims, s) : launch<bf16, bf16, 5>(ptrs, dims, s);
    return k == 3 ? launch<bf16, float, 3>(ptrs, dims, s) : launch<bf16, float, 5>(ptrs, dims, s);
  }
  if (fast) return k == 3 ? launch<float, bf16, 3>(ptrs, dims, s) : launch<float, bf16, 5>(ptrs, dims, s);
  return k == 3 ? launch<float, float, 3>(ptrs, dims, s) : launch<float, float, 5>(ptrs, dims, s);
}

}  // extern "C"
