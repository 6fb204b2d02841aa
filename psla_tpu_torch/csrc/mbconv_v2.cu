// Fused eval-mode MBConv block, v2, for Hopper: four phase kernels a block.
//
// Replaces the TPU kernel psla_tpu/ops/mbconv_vmem.py::_eval_kernel
// (launched by fused_mbconv_eval_v2). One EfficientNet block with BatchNorm
// folded, stride 1 or 2, k 3 or 5, with or without expand
// (psla_tpu_torch/ops/mbconv_vmem.py holds the wrapper, the launch geometry
// v2_geometry and the plain version, fused_mbconv_eval_v2_plain):
//
//   e    = swish(x @ w1 + b1)                  (x itself when there is no expand)
//   d    = swish(depthwise_kxk_stride(e) + bd) SAME: taps outside the map read 0
//   gate = sigmoid(swish(mean(d) @ wr + br) @ we + be)   per clip
//   out  = (d * gate) @ wp + bp  (+ x when stride is 1 and Cin == Cout)
//
// Bound on an H100 SXM. At the serving shape (16 clips, B2's 23 blocks,
// 64 x 528 after the stem) chip_smoke.py counts ~56 GFLOP, nearly all of it
// the two 1x1 products, against ~0.44 GB of block inputs, outputs and
// weights: in float32 on the CUDA cores (67 TFLOP/s) the operations bound
// the block (~0.86 ms against ~0.13 ms of bytes); with the products on the
// tensor cores (495 TFLOP/s TF32, 989 bf16) the bytes do, and e and d,
// which cross device memory once each here (~1.4 GB a float32 sweep,
// written and read), add to them.
//
// Design. The TPU kernel holds one clip's whole map in VMEM; an SM has
// 228 KB of shared memory, and the squeeze-excite mean needs all of a
// clip's d before any output can be gated. So the block runs as four
// kernels launched in stream order, each with its own block shape, register
// budget and grid (v2_geometry; the smem functions below mirror it):
//   A. expand (when the block has one): e = swish(x @ w1 + b1) into device
//      scratch in the activation type; a tensor-core product (below);
//   B. depthwise: a block owns one window of output pixels of one clip and
//      32 channels. The window's input with its halo, for stride 1 or 2, is
//      staged once in shared memory with cp.async, so each tap reads shared
//      memory and each input byte crosses device memory about once; the
//      tap weights are held in registers. float32: a warp a pixel, a lane a
//      channel; bf16: a half-warp a pixel, two channels a lane, the taps'
//      products two at a time (__hmul2). Each output writes d; each window
//      writes one channel sum: the pixels q = i (mod 16) summed in order,
//      then the sixteen sums in order;
//   C. squeeze-excite: one block of 512 threads a clip, so no thread walks
//      a long sum alone: groups of threads add runs of the window sums in
//      window order, then the groups in order; the hidden units' sums are
//      split over groups of channels (lanes over the hidden units, so wr is
//      read coalesced), the groups added in order; then the gate, threads
//      over channels;
//   D. project: out = (d * gate) @ wp + bp (+ x), a tensor-core product whose
//      row tiles never span two clips, so a block stages one gate row and
//      gates A as its fragments are read.
// The products (A and D), on the tensor cores because they are nearly all
// of the operations: a block of 32*wm x 8*ni*wn output elements, each warp
// 32 rows x 8*ni columns (the N tile fitted to the channel counts of 16,
// 24, 48, ...), K in chunks of 32, double-buffered (cp.async), so the next
// chunk's loads overlap the current chunk's products; rows, columns and the
// K tail past the matrix are zero-filled in shared memory. Where the tiles
// leave an SM fewer than 16 warps (B2's small maps with Ce of 288-2112 in
// the project), K is cut into up to four runs, one block each, so that more
// blocks fit an SM; gemm_reduce_kernel adds the runs' sums in run order and
// applies the epilogue. No float atomics: a run gives the same bits every
// time. Rows are copied in 16-byte pieces, so the channel counts are
// multiples of 8 (the wrapper pads others with zeros).
//
// fast = 1 follows the TPU kernel's rounding points: the operands of both
// 1x1 products are rounded to bfloat16 and summed in float32
// (mma.sync m16n8k16); e and d are stored in bfloat16; each tap's product is
// rounded to bfloat16 before its float32 sum; the mean is taken of the
// bfloat16 d; the gate is rounded to bfloat16 and the gated d is a bfloat16
// product. fast = 0 takes the products as 3xTF32 (mma.sync m16n8k8): each
// float32 operand is split into big = tf32(a) and small = tf32(a - big), and
// big*small + small*big + big*big are summed in float32 (the dropped
// small*small is below float32's rounding). The tensor cores truncate as
// they add into the sum they are given, so each 8-deep k-step's three
// products start from zero and are added to the float32 sum with
// round-to-nearest: carried through all of K in the mma, the sum missed the
// float32 bar by 3-5% on B2's last two blocks (K = 1248, 2112). No library
// kernel is called.

#include <algorithm>
#include <cstdint>
#include <map>
#include <mutex>
#include <set>
#include <type_traits>
#include <utility>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBK = 32;        // depth of a staged product chunk (elements)
constexpr int kMI = 2;         // m16 tiles a warp holds
constexpr int kMaxWarps = 8;
constexpr int kDwCW = 32;      // channels of a depthwise block (a lane each)
constexpr int kDwThreads = 256;
constexpr int kDwWarps = kDwThreads / 32;
constexpr int kDwMaxP = 128;   // output pixels of a depthwise window, at most
constexpr int kSeThreads = 512;

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

// 16 bytes global -> shared, or 16 zero bytes when !valid (src-size 0).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}
// v = big + small (+ below float32's rounding of the product), both TF32.
__device__ __forceinline__ void split_tf32(float v, uint32_t& big, uint32_t& small) {
  big = tf32(v);
  small = tf32(v - __uint_as_float(big));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ------------------------------------------------------------------ shared memory
// Each mirrors the function of the same name in ops/mbconv_vmem.py.

// The smallest pitch >= n words that is mod modulo 32 (fragment loads on
// distinct banks).
__host__ __device__ constexpr int pitch_words(int n, int mod) {
  return n - n % 32 + mod >= n ? n - n % 32 + mod : n - n % 32 + mod + 32;
}
// Row pitch of a staged A chunk, bytes: bf16 rows 80 bytes; float32 rows
// read as bf16 pairs (float2) 40 words, read as TF32 36 words.
__host__ __device__ constexpr int a_pitch(int a_bytes, bool fast) {
  return a_bytes == 2 ? 80 : 4 * pitch_words(kBK, fast ? 8 : 4);
}
// Row pitch of a staged B chunk [kBK, bn], floats.
__host__ __device__ constexpr int b_pitch(int bn, bool fast) {
  return pitch_words(bn, fast ? 4 : 8);
}
// Chunks of a product in flight: two, one where K fits one chunk.
__host__ __device__ constexpr int gemm_stages(int k) { return k <= kBK ? 1 : 2; }
int gemm_smem(int bm, int bn, int k, int a_bytes, bool fast, bool gate) {
  return gemm_stages(k) * (bm * a_pitch(a_bytes, fast) + kBK * b_pitch(bn, fast) * 4) +
         (gate ? 4 * ((k + kBK - 1) / kBK * kBK) : 0);
}
int dw_smem(int th, int tw, int k, int stride, int e_bytes) {
  const int hh = (th - 1) * stride + k, hw = (tw - 1) * stride + k;
  return hh * hw * kDwCW * e_bytes + 4 * 2 * kDwWarps * kDwCW;
}
int se_smem(int ce, int cse, int wg, int groups) {
  return 4 * (ce + std::max(wg * ce, groups * cse) + cse);
}

// ------------------------------------------------------------------ products

struct GemmParams {
  const void* a;      // [segs * rows, k] of TA
  const float* b;     // [k, n]
  const float* bias;  // [n]
  const float* gate;  // [segs, k] (project) or null
  const void* res;    // [segs * rows, n] of TO (residual) or null
  void* out;          // [segs * rows, n] of TO
  float* part;        // [splits, segs * rows, n] (splits > 1)
  size_t part_stride; // segs * rows * n
  int rows, n, k, tiles_m, tiles_n, wm, wn, splits;
};

template <class T>
__device__ __forceinline__ void store2(T* dst, size_t i, float v0, float v1, bool both,
                                       bool pair) {
  if (both && pair) {
    if constexpr (std::is_same<T, float>::value)
      *reinterpret_cast<float2*>(dst + i) = make_float2(v0, v1);
    else
      *reinterpret_cast<__nv_bfloat162*>(dst + i) = __floats2bfloat162_rn(v0, v1);
  } else {
    dst[i] = from_f<T>(v0);
    if (both) dst[i + 1] = from_f<T>(v1);
  }
}

// C = A @ B on the tensor cores, one output tile a block; kProj: the
// project product (gate on A, bias and residual), else the expand (bias and
// swish). A of type TA (float or bf16) is read from shared memory as it was
// copied, the project's gated as its fragments are read; kFast rounds A and
// B to bfloat16 for m16n8k16, else each is split for 3xTF32 m16n8k8.
// Double-buffered: chunk c+1 is copied (cp.async) while chunk c is summed.
template <class TA, class TO, bool kFast, int NI, bool kProj>
__global__ void __launch_bounds__(kMaxWarps * 32) gemm_kernel(const GemmParams p) {
  extern __shared__ float4 smem4[];
  char* const smem = reinterpret_cast<char*>(smem4);
  constexpr int kAP = a_pitch(sizeof(TA), kFast);
  const int BM = 32 * p.wm, BN = 8 * NI * p.wn;
  const int bp = b_pitch(BN, kFast);
  const int nk = (p.k + kBK - 1) / kBK, stages = gemm_stages(p.k);
  // K split: this block's chunks [c_lo, c_hi) of run `split`
  const int tiles = gridDim.x / p.splits, split = blockIdx.x / tiles;
  const int cps = (nk + p.splits - 1) / p.splits;
  const int c_lo = split * cps, c_hi = min(nk, c_lo + cps);
  char* const As = smem;                                               // [stages][BM, kAP bytes]
  float* const Bs = reinterpret_cast<float*>(smem + stages * BM * kAP);  // [stages][kBK, bp]
  float* const Gs = Bs + stages * kBK * bp;                            // [k rounded up]

  const int nthreads = 32 * p.wm * p.wn;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int tile = blockIdx.x - split * tiles;
  const int tn = tile % p.tiles_n, tmall = tile / p.tiles_n;
  const int seg = tmall / p.tiles_m, r0 = (tmall % p.tiles_m) * BM, n0 = tn * BN;
  const size_t row0 = static_cast<size_t>(seg) * p.rows;
  const TA* const A = static_cast<const TA*>(p.a) + (row0 + r0) * p.k;
  const int rows_ok = min(BM, p.rows - r0);
  const int wr0 = (warp % p.wm) * 32, wc0 = (warp / p.wm) * 8 * NI;

  const int b_kr = tid / (BN / 4), b_v = tid % (BN / 4);  // this thread's first B vector
  const int b_kr_step = nthreads / (BN / 4), b_v_step = nthreads % (BN / 4);
  auto stage = [&](int c, int buf) {
    const int k0 = c * kBK;
    char* const as = As + buf * BM * kAP;
    constexpr int kVA = 16 / sizeof(TA), kVR = kBK / kVA;  // per vector, per row
    for (int i = tid; i < BM * kVR; i += nthreads) {
      const int r = i / kVR, v = i - r * kVR, kk = k0 + v * kVA;
      const bool ok = r < rows_ok && kk < p.k;
      cp_async16(as + r * kAP + v * 16, ok ? A + static_cast<size_t>(r) * p.k + kk : A, ok);
    }
    // B: row kr, vector v of the chunk, stepped without a division
    float* const bs = Bs + buf * kBK * bp;
    for (int kr = b_kr, v = b_v; kr < kBK;) {
      const int kk = k0 + kr, n = n0 + 4 * v;
      const bool ok = kk < p.k && n < p.n;
      cp_async16(bs + kr * bp + 4 * v, ok ? p.b + static_cast<size_t>(kk) * p.n + n : p.b, ok);
      kr += b_kr_step;
      v += b_v_step;
      if (v >= BN / 4) {
        v -= BN / 4;
        ++kr;
      }
    }
  };

  // the run's first chunk in flight; one commit group a chunk
  if (c_lo < c_hi) stage(c_lo, 0);
  cp_async_commit();
  if constexpr (kProj) {  // the clip's gate row, rounded where the TPU kernel rounds it
    const float* gr = p.gate + static_cast<size_t>(seg) * p.k;
    for (int i = tid; i < nk * kBK; i += nthreads)
      Gs[i] = i < p.k ? (kFast ? bf16r(gr[i]) : gr[i]) : 0.f;
  }

  // A element (row r, column kk) of the staged chunk, gated (project) as
  // the TPU kernel gates it.
  auto a_at = [&](const char* as, int r, int kk, int k0) -> float {
    float v = to_f(reinterpret_cast<const TA*>(as + r * kAP)[kk]);
    if constexpr (kProj) v = kFast ? bf16r(v * Gs[k0 + kk]) : v * Gs[k0 + kk];
    return v;
  };
  // Two neighbouring A elements as a bf16 pair.
  auto a_pair = [&](const char* as, int r, int kk, int k0) -> uint32_t {
    if constexpr (std::is_same<TA, float>::value) {
      float2 v = *reinterpret_cast<const float2*>(as + r * kAP + kk * 4);
      if constexpr (kProj) {
        v.x = bf16r(v.x * Gs[k0 + kk]);
        v.y = bf16r(v.y * Gs[k0 + kk + 1]);
      }
      return pack_bf16(v.x, v.y);
    } else {
      const uint32_t w = *reinterpret_cast<const uint32_t*>(as + r * kAP + kk * 2);
      if constexpr (!kProj) return w;
      const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w);
      return pack_bf16(bf16r(__low2float(h) * Gs[k0 + kk]),
                       bf16r(__high2float(h) * Gs[k0 + kk + 1]));
    }
  };

  float acc[kMI][NI][4] = {};
  for (int c = c_lo; c < c_hi; ++c) {
    const int buf = (c - c_lo) & 1;  // buffer 0 alone with one stage (one chunk)
    cp_async_wait<0>();  // chunk c is in ...
    __syncthreads();     // ... for every thread (and the gate row); chunk c-1 is consumed
    if (c + 1 < c_hi) stage(c + 1, buf ^ 1);  // into chunk c-1's buffer
    cp_async_commit();
    const char* const as = As + buf * BM * kAP;
    const float* const bs = Bs + buf * kBK * bp;
    const int k0 = c * kBK;
    // B's fragments of the k-step for all NI n8 tiles, then A's a m16 tile
    // at a time (fewer fragments live at once).
    if constexpr (kFast) {
#pragma unroll
      for (int ks = 0; ks < kBK; ks += 16) {
        uint32_t bfr[NI][2];
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
          const float* bc = bs + (ks + 2 * t) * bp + wc0 + ni * 8 + g;
          bfr[ni][0] = pack_bf16(bc[0], bc[bp]);
          bfr[ni][1] = pack_bf16(bc[8 * bp], bc[9 * bp]);
        }
#pragma unroll
        for (int mi = 0; mi < kMI; ++mi) {
          const int ra = wr0 + mi * 16 + g, ca = ks + 2 * t;
          const uint32_t af[4] = {a_pair(as, ra, ca, k0), a_pair(as, ra + 8, ca, k0),
                                  a_pair(as, ra, ca + 8, k0), a_pair(as, ra + 8, ca + 8, k0)};
#pragma unroll
          for (int ni = 0; ni < NI; ++ni) mma_bf16(acc[mi][ni], af, bfr[ni]);
        }
      }
    } else {
#pragma unroll
      for (int ks = 0; ks < kBK; ks += 8) {
        uint32_t bb[NI][2], bsm[NI][2];
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
          const float* bc = bs + (ks + t) * bp + wc0 + ni * 8 + g;
          split_tf32(bc[0], bb[ni][0], bsm[ni][0]);
          split_tf32(bc[4 * bp], bb[ni][1], bsm[ni][1]);
        }
#pragma unroll
        for (int mi = 0; mi < kMI; ++mi) {
          const int ra = wr0 + mi * 16 + g, ca = ks + t;
          uint32_t ab[4], asm_[4];
          split_tf32(a_at(as, ra, ca, k0), ab[0], asm_[0]);
          split_tf32(a_at(as, ra + 8, ca, k0), ab[1], asm_[1]);
          split_tf32(a_at(as, ra, ca + 4, k0), ab[2], asm_[2]);
          split_tf32(a_at(as, ra + 8, ca + 4, k0), ab[3], asm_[3]);
          // The k-step's three products from zero, then into the float32
          // sum (the tensor cores truncate as they add: see the note
          // above); each pass runs over the NI tiles, so that NI
          // independent products lie between two that depend.
          float step[NI][4] = {};
#pragma unroll
          for (int ni = 0; ni < NI; ++ni) mma_tf32(step[ni], ab, bsm[ni]);
#pragma unroll
          for (int ni = 0; ni < NI; ++ni) mma_tf32(step[ni], asm_, bb[ni]);
#pragma unroll
          for (int ni = 0; ni < NI; ++ni) mma_tf32(step[ni], ab, bb[ni]);
#pragma unroll
          for (int ni = 0; ni < NI; ++ni)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[mi][ni][j] += step[ni][j];
        }
      }
    }
  }

  TO* const out = static_cast<TO*>(p.out);
  const TO* const res = static_cast<const TO*>(p.res);
  const bool pair = (p.n & 1) == 0;
  // a run's sums go to part, added in run order by gemm_reduce_kernel
  float* const part = p.splits > 1 ? p.part + static_cast<size_t>(split) * p.part_stride : nullptr;
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r0 + wr0 + mi * 16 + g + 8 * half;
        const int n = n0 + wc0 + ni * 8 + 2 * t;
        if (r >= p.rows || n >= p.n) continue;
        const bool both = n + 1 < p.n;
        const size_t i = (row0 + r) * p.n + n;
        if (part != nullptr) {
          store2(part, i, acc[mi][ni][2 * half], acc[mi][ni][2 * half + 1], both, pair);
          continue;
        }
        float v0 = acc[mi][ni][2 * half] + p.bias[n];
        float v1 = both ? acc[mi][ni][2 * half + 1] + p.bias[n + 1] : 0.f;
        if constexpr (kProj) {
          if (res != nullptr) {
            v0 += to_f(res[i]);
            if (both) v1 += to_f(res[i + 1]);
          }
        } else {
          v0 = swish(v0);
          v1 = swish(v1);
        }
        store2(out, i, v0, v1, both, pair);
      }
}

// The K split's second pass: out = epilogue(sum over runs, in run order,
// of part + bias): swish (expand), or the residual (project).
template <class TO, bool kProj>
__global__ void __launch_bounds__(256) gemm_reduce_kernel(const GemmParams p) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= p.part_stride) return;
  float v = 0.f;
  for (int sp = 0; sp < p.splits; ++sp) v += p.part[sp * p.part_stride + i];
  v += p.bias[i % p.n];
  if constexpr (kProj) {
    if (p.res != nullptr) v += to_f(static_cast<const TO*>(p.res)[i]);
  } else {
    v = swish(v);
  }
  static_cast<TO*>(p.out)[i] = from_f<TO>(v);
}

// ------------------------------------------------------------------ depthwise

struct DwParams {
  const void* e;     // [B, H, W, Ce] of TE
  const float *wd, *bd;  // [k*k, Ce], [Ce]
  void* d;           // [B, Ho, Wo, Ce] of TD
  float* partial;    // [B, windows, Ce]
  int h, w, ce, ho, wo, stride, lo_h, lo_w, th, tw, nwx, nwin;
};

template <class TE, class TD, int K>
__global__ void __launch_bounds__(kDwThreads) depthwise_kernel(const DwParams p) {
  constexpr bool kFast = std::is_same<TD, bf16>::value;
  extern __shared__ float4 smem4[];
  TE* const xs = reinterpret_cast<TE*>(smem4);  // [hh * hw, kDwCW]
  const int hh = (p.th - 1) * p.stride + K, hw = (p.tw - 1) * p.stride + K;
  float* const red = reinterpret_cast<float*>(xs + hh * hw * kDwCW);  // [2 * kDwWarps, kDwCW]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / p.nwin, win = blockIdx.x - b * p.nwin;
  const int y0 = (win / p.nwx) * p.th, x0 = (win % p.nwx) * p.tw;
  const int c0 = blockIdx.y * kDwCW, c = c0 + lane;
  const bool c_ok = c < p.ce;
  const int iy0 = y0 * p.stride - p.lo_h, ix0 = x0 * p.stride - p.lo_w;
  const TE* const eb = static_cast<const TE*>(p.e) + static_cast<size_t>(b) * p.h * p.w * p.ce;

  // the window's input with its halo, once; zero outside the map (SAME).
  // A thread copies vector v of pixels pix, pix + kStep, ...; the pixel's
  // row and column are stepped without a division.
  {
    constexpr int kV = 16 / sizeof(TE), kVP = kDwCW / kV, kStep = kDwThreads / kVP;
    const int v = tid % kVP, cc = c0 + v * kV;
    int pix = tid / kVP, py = pix / hw, px = pix - py * hw;
    for (; pix < hh * hw; pix += kStep) {
      const int iy = iy0 + py, ix = ix0 + px;
      const bool ok = iy >= 0 && iy < p.h && ix >= 0 && ix < p.w && cc < p.ce;
      cp_async16(xs + pix * kDwCW + v * kV,
                 ok ? eb + (static_cast<size_t>(iy) * p.w + ix) * p.ce + cc : eb, ok);
      for (px += kStep; px >= hw; px -= hw) ++py;
    }
    cp_async_commit();
  }
  TD* const d = static_cast<TD*>(p.d);
  const size_t out0 = static_cast<size_t>(b) * p.ho;
  if constexpr (kFast) {
    // bf16 out: a half-warp a pixel, two channels a lane (float32 input
    // rounded to bf16 as it is read), the taps' bf16 products two at a time
    // (__hmul2 rounds each exact product once, as bf16r(v * w) would)
    const int half = lane >> 4, cl = 2 * (lane & 15), cp = c0 + cl;
    const bool ok0 = cp < p.ce, ok1 = cp + 1 < p.ce;
    __nv_bfloat162 w2[K * K];
#pragma unroll
    for (int j = 0; j < K * K; ++j) {
      const float* wj = p.wd + static_cast<size_t>(j) * p.ce + cp;
      w2[j] = __floats2bfloat162_rn(ok0 ? wj[0] : 0.f, ok1 ? wj[1] : 0.f);
    }
    const float bd0 = ok0 ? p.bd[cp] : 0.f, bd1 = ok1 ? p.bd[cp + 1] : 0.f;
    const bool pair = (p.ce & 1) == 0;
    cp_async_wait<0>();
    __syncthreads();
    // the lane's two channels of staged pixel j, as a bf16 pair
    auto in2 = [&](int j) -> __nv_bfloat162 {
      if constexpr (std::is_same<TE, bf16>::value) {
        return reinterpret_cast<const __nv_bfloat162*>(xs)[(j * kDwCW + cl) / 2];
      } else {
        const float2 v = reinterpret_cast<const float2*>(xs)[(j * kDwCW + cl) / 2];
        return __floats2bfloat162_rn(v.x, v.y);
      }
    };
    float s0 = 0.f, s1 = 0.f;
    const int q0 = 2 * warp + half;
    for (int q = q0, oy = q0 / p.tw, ox = q0 % p.tw; q < p.th * p.tw; q += 2 * kDwWarps) {
      const int gy = y0 + oy, gx = x0 + ox, j0 = oy * p.stride * hw + ox * p.stride;
      for (ox += 2 * kDwWarps; ox >= p.tw; ox -= p.tw) ++oy;  // the next pixel's
      if (gy >= p.ho || gx >= p.wo) continue;  // half-warp-uniform
      float a0 = 0.f, a1 = 0.f;
#pragma unroll
      for (int dw = 0; dw < K; ++dw) {
#pragma unroll
        for (int dh = 0; dh < K; ++dh) {
          const __nv_bfloat162 pr = __hmul2(in2(j0 + dh * hw + dw), w2[dh * K + dw]);
          a0 += __low2float(pr);
          a1 += __high2float(pr);
        }
      }
      const __nv_bfloat162 dq = __floats2bfloat162_rn(swish(a0 + bd0), swish(a1 + bd1));
      bf16* const dst = d + ((out0 + gy) * p.wo + gx) * p.ce + cp;
      if (ok1 && pair) {
        *reinterpret_cast<__nv_bfloat162*>(dst) = dq;
      } else {
        if (ok0) dst[0] = __low2bfloat16(dq);
        if (ok1) dst[1] = __high2bfloat16(dq);
      }
      s0 += __low2float(dq);
      s1 += __high2float(dq);
    }
    red[(2 * warp + half) * kDwCW + cl] = s0;  // pixels q = 2 * warp + half (mod 16)
    red[(2 * warp + half) * kDwCW + cl + 1] = s1;
  } else {
    // float32 out: a warp a pixel, a channel a lane
    float wdr[K * K];
#pragma unroll
    for (int j = 0; j < K * K; ++j) wdr[j] = c_ok ? p.wd[static_cast<size_t>(j) * p.ce + c] : 0.f;
    const float bdc = c_ok ? p.bd[c] : 0.f;
    cp_async_wait<0>();
    __syncthreads();
    float sum[2] = {0.f, 0.f};  // the warp's pixels of even and odd rounds
    for (int q = warp, r = 0, oy = warp / p.tw, ox = warp % p.tw; q < p.th * p.tw;
         q += kDwWarps, r ^= 1) {
      const int gy = y0 + oy, gx = x0 + ox;
      const TE* src = xs + (oy * p.stride * hw + ox * p.stride) * kDwCW + lane;
      for (ox += kDwWarps; ox >= p.tw; ox -= p.tw) ++oy;  // the next pixel's
      if (gy >= p.ho || gx >= p.wo) continue;  // warp-uniform
      float acc = 0.f;
#pragma unroll
      for (int dw = 0; dw < K; ++dw) {
#pragma unroll
        for (int dh = 0; dh < K; ++dh) acc += to_f(src[(dh * hw + dw) * kDwCW]) * wdr[dh * K + dw];
      }
      const TD dq = from_f<TD>(swish(acc + bdc));
      if (c_ok) d[((out0 + gy) * p.wo + gx) * p.ce + c] = dq;
      sum[r] += to_f(dq);
    }
    red[warp * kDwCW + lane] = sum[0];  // pixels q = warp (mod 16)
    red[(warp + kDwWarps) * kDwCW + lane] = sum[1];  // q = warp + 8 (mod 16)
  }
  __syncthreads();
  // the window's sum: row i of red holds the pixels q = i (mod 16), each
  // row in pixel order; the rows are added in order
  if (warp == 0 && c_ok) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < 2 * kDwWarps; ++i) s += red[i * kDwCW + lane];
    p.partial[(static_cast<size_t>(b) * p.nwin + win) * p.ce + c] = s;
  }
}

// ------------------------------------------------------------------ squeeze-excite

struct SeParams {
  const float* partial;  // [B, windows, Ce]
  const float *wr, *br, *we, *be;
  float* gate;           // [B, Ce]
  int nwin, ce, cse, wg, groups, pixels;
};

__global__ void __launch_bounds__(kSeThreads) se_kernel(const SeParams p) {
  extern __shared__ float4 smem4[];
  float* const mean = reinterpret_cast<float*>(smem4);  // [ce]
  float* const buf = mean + p.ce;                       // [max(wg * ce, groups * cse)]
  float* const hid = buf + max(p.wg * p.ce, p.groups * p.cse);  // [cse]
  const int tid = threadIdx.x, nt = blockDim.x, b = blockIdx.x;
  const int ce = p.ce, cse = p.cse;
  const float* const part = p.partial + static_cast<size_t>(b) * p.nwin * ce;

  // the mean: group gi adds windows [gi * run, (gi + 1) * run) in order
  const int run = (p.nwin + p.wg - 1) / p.wg;
  for (int i = tid; i < p.wg * ce; i += nt) {
    const int gi = i / ce, c = i - gi * ce;
    const int lo = gi * run, hi = min(p.nwin, lo + run);
    float s = 0.f;
#pragma unroll 4
    for (int t = lo; t < hi; ++t) s += part[static_cast<size_t>(t) * ce + c];
    buf[i] = s;
  }
  __syncthreads();
  for (int c = tid; c < ce; c += nt) {
    float s = 0.f;
    for (int gi = 0; gi < p.wg; ++gi) s += buf[gi * ce + c];
    mean[c] = s / static_cast<float>(p.pixels);
  }
  __syncthreads();
  // the hidden units: group gi takes channels gi, gi + groups, ...
  for (int i = tid; i < p.groups * cse; i += nt) {
    const int gi = i / cse, j = i - gi * cse;
    float s = 0.f;
#pragma unroll 8
    for (int c = gi; c < ce; c += p.groups) s = fmaf(mean[c], p.wr[static_cast<size_t>(c) * cse + j], s);
    buf[i] = s;
  }
  __syncthreads();
  for (int j = tid; j < cse; j += nt) {
    float s = 0.f;
    for (int gi = 0; gi < p.groups; ++gi) s += buf[gi * cse + j];
    hid[j] = swish(s + p.br[j]);
  }
  __syncthreads();
  for (int c = tid; c < ce; c += nt) {
    float s = 0.f;
#pragma unroll 8
    for (int j = 0; j < cse; ++j) s = fmaf(hid[j], p.we[static_cast<size_t>(j) * ce + c], s);
    p.gate[static_cast<size_t>(b) * ce + c] = sigmoid(s + p.be[c]);
  }
}

// ------------------------------------------------------------------ host

int same_out(int n, int k, int s, int* lo) {
  const int out = (n + s - 1) / s;
  const int total = std::max((out - 1) * s + k - n, 0);
  *lo = total / 2;
  return out;
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);

// The opt-in shared memory limit of each device, and the kernels whose
// dynamic shared memory has been raised to it there: each read or set once.
std::mutex g_smem_mu;
std::map<int, int> g_smem_limit;
std::set<std::pair<int, const void*>> g_smem_raised;

// Launches kern with smem bytes of dynamic shared memory; kInvalid if smem
// is above the device's opt-in limit.
template <class K>
int launch_kernel(K kern, unsigned grid_x, unsigned grid_y, int threads, int smem,
                  cudaStream_t st, const void* params) {
  const void* const fn = reinterpret_cast<const void*>(kern);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  {
    std::lock_guard<std::mutex> lock(g_smem_mu);
    auto limit = g_smem_limit.find(dev);
    if (limit == g_smem_limit.end()) {
      int v = 0;
      err = cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
      if (err != cudaSuccess) return static_cast<int>(err);
      limit = g_smem_limit.emplace(dev, v).first;
    }
    if (smem > limit->second) return kInvalid;
    if (!g_smem_raised.count({dev, fn})) {
      err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, limit->second);
      if (err != cudaSuccess) return static_cast<int>(err);
      g_smem_raised.insert({dev, fn});
    }
  }
  void* args[] = {const_cast<void*>(params)};
  err = cudaLaunchKernel(fn, dim3(grid_x, grid_y), dim3(threads), args, smem, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// geo: wm, wn, ni, tiles_m, tiles_n, splits, smem of one product;
// part: scratch for the runs' sums of a K split.
template <class TA, class TO, bool kFast, bool kProj>
int run_gemm(GemmParams p, int segs, const int* geo, int a_bytes, float* part,
             cudaStream_t st) {
  const int wm = geo[0], wn = geo[1], ni = geo[2], smem = geo[6];
  p.wm = wm;
  p.wn = wn;
  p.tiles_m = geo[3];
  p.tiles_n = geo[4];
  p.splits = geo[5];
  p.part = part;
  p.part_stride = static_cast<size_t>(segs) * p.rows * p.n;
  const int nk = (p.k + kBK - 1) / kBK;
  const int cps = p.splits > 0 ? (nk + p.splits - 1) / p.splits : 0;
  const int bm = 32 * wm, bn = 8 * ni * wn;
  if (wm < 1 || wn < 1 || wm * wn > kMaxWarps || (ni != 1 && ni != 2 && ni != 4) ||
      static_cast<long long>(p.tiles_m) * bm < p.rows || (p.tiles_m - 1) * bm >= p.rows ||
      static_cast<long long>(p.tiles_n) * bn < p.n || (p.tiles_n - 1) * bn >= p.n ||
      p.splits < 1 || (p.splits - 1) * cps >= nk || (p.splits > 1 && part == nullptr) ||
      smem != gemm_smem(bm, bn, p.k, a_bytes, kFast, kProj))
    return kInvalid;
  const long long ctas = static_cast<long long>(segs) * p.tiles_m * p.tiles_n * p.splits;
  if (ctas > 2147483647LL || p.part_stride > 2147483647ULL * 256) return kInvalid;
  auto kern = ni == 1 ? gemm_kernel<TA, TO, kFast, 1, kProj>
              : ni == 2 ? gemm_kernel<TA, TO, kFast, 2, kProj>
                        : gemm_kernel<TA, TO, kFast, 4, kProj>;
  int err = launch_kernel(kern, static_cast<unsigned>(ctas), 1, 32 * wm * wn, smem, st, &p);
  if (err || p.splits == 1) return err;
  return launch_kernel(gemm_reduce_kernel<TO, kProj>,
                       static_cast<unsigned>((p.part_stride + 255) / 256), 1, 256, 0, st, &p);
}

template <class TE, class TD>
int run_depthwise(DwParams p, int k, int batch, int slices, int smem, cudaStream_t st) {
  if (p.th < 1 || p.tw < 1 || p.th * p.tw > kDwMaxP ||
      p.nwin != ((p.ho + p.th - 1) / p.th) * ((p.wo + p.tw - 1) / p.tw) ||
      smem != dw_smem(p.th, p.tw, k, p.stride, sizeof(TE)) ||
      slices > 65535 || static_cast<long long>(batch) * p.nwin > 2147483647LL)
    return kInvalid;
  p.nwx = (p.wo + p.tw - 1) / p.tw;
  auto kern = k == 3 ? depthwise_kernel<TE, TD, 3> : depthwise_kernel<TE, TD, 5>;
  return launch_kernel(kern, static_cast<unsigned>(batch * p.nwin), slices, kDwThreads, smem,
                       st, &p);
}

// The four phases of one block; TX: x and out, TA: e and d.
template <class TX, class TA>
int run(const void* const* ptrs, const int* dims, const int* geo, int phases, cudaStream_t st) {
  constexpr bool kFast = std::is_same<TA, bf16>::value;
  const int batch = dims[0], h = dims[1], w = dims[2], cin = dims[3], ce = dims[4];
  const int cse = dims[5], cout = dims[6], k = dims[7], stride = dims[8];
  const int has_expand = dims[10], residual = dims[12];
  const void* x = ptrs[0];
  const float* f[11];
  for (int i = 1; i <= 10; ++i) f[i] = static_cast<const float*>(ptrs[i]);
  void* out = const_cast<void*>(ptrs[11]);
  void* e = const_cast<void*>(ptrs[12]);
  void* d = const_cast<void*>(ptrs[13]);
  float* partial = static_cast<float*>(const_cast<void*>(ptrs[14]));
  float* gate = static_cast<float*>(const_cast<void*>(ptrs[15]));
  float* part_k = static_cast<float*>(const_cast<void*>(ptrs[16]));
  int lo_h = 0, lo_w = 0;
  const int ho = same_out(h, k, stride, &lo_h), wo = same_out(w, k, stride, &lo_w);
  const int nwin = geo[21];
  if ((has_expand && (!f[1] || !f[2] || !e)) || (!has_expand && cin != ce) || !d ||
      (residual && (stride != 1 || cin != cout)) ||
      !partial || !gate || !out || nwin < 1)
    return kInvalid;
  int err = 0;

  if (has_expand && (phases & 1)) {  // A. e = swish(x @ w1 + b1)
    GemmParams p{};
    p.a = x;
    p.b = f[1];
    p.bias = f[2];
    p.out = e;
    p.rows = batch * h * w;
    p.n = ce;
    p.k = cin;
    err = run_gemm<TX, TA, kFast, false>(p, 1, geo, sizeof(TX), part_k, st);
    if (err) return err;
  }
  if (phases & 2) {  // B. d = swish(taps + bd), window sums
    DwParams p{};
    p.e = has_expand ? e : x;
    p.wd = f[3];
    p.bd = f[4];
    p.d = d;
    p.partial = partial;
    p.h = h;
    p.w = w;
    p.ce = ce;
    p.ho = ho;
    p.wo = wo;
    p.stride = stride;
    p.lo_h = lo_h;
    p.lo_w = lo_w;
    p.th = geo[7];
    p.tw = geo[8];
    p.nwin = nwin;
    const int slices = (ce + kDwCW - 1) / kDwCW;
    err = has_expand || std::is_same<TX, TA>::value
              ? run_depthwise<TA, TA>(p, k, batch, slices, geo[9], st)
              : run_depthwise<TX, TA>(p, k, batch, slices, geo[9], st);
    if (err) return err;
  }
  if (phases & 4) {  // C. the gate, one block a clip
    SeParams p{};
    p.partial = partial;
    p.wr = f[5];
    p.br = f[6];
    p.we = f[7];
    p.be = f[8];
    p.gate = gate;
    p.nwin = nwin;
    p.ce = ce;
    p.cse = cse;
    p.wg = geo[10];
    p.groups = geo[11];
    p.pixels = ho * wo;
    const int threads = geo[12], smem = geo[13];
    if (threads != kSeThreads || p.wg < 1 || p.wg > nwin || p.groups < 1 ||
        smem != se_smem(ce, cse, p.wg, p.groups))
      return kInvalid;
    err = launch_kernel(se_kernel, batch, 1, threads, smem, st, &p);
    if (err) return err;
  }
  if (phases & 8) {  // D. out = (d * gate) @ wp + bp (+ x)
    GemmParams p{};
    p.a = d;
    p.b = f[9];
    p.bias = f[10];
    p.gate = gate;
    p.res = residual ? x : nullptr;
    p.out = out;
    p.rows = ho * wo;
    p.n = cout;
    p.k = ce;
    err = run_gemm<TA, TX, kFast, true>(p, batch, geo + 14, sizeof(TA), part_k, st);
  }
  return err;
}

}  // namespace

extern "C" {

// One block. ptrs: x, w1, b1, wd, bd, wr, br, we, be, wp, bp, out, e, d,
// partial, gate, part (w1, b1 and e null without expand; part null unless
// a product splits K). out [B, Ho, Wo, Cout] in x's type (float32, or
// bfloat16 when x_bf16); e [B, H, W, Ce] and d [B, Ho, Wo, Ce] scratch in
// the activation type (bfloat16 when fast, else float32); partial
// [B, windows, Ce], gate [B, Ce] and part [splits, rows, n] float32
// scratch. dims: batch, h, w, cin, ce, cse, cout, k, stride, fast,
// has_expand, x_bf16, residual (add x to the output: stride 1, Cin ==
// Cout). geo (psla_tpu_torch.ops.mbconv_vmem.v2_geometry): the expand's
// wm, wn, ni, tiles_m, tiles_n, splits, smem; the depthwise th, tw, smem;
// the squeeze-excite's window groups, channel groups, threads, smem; the
// project's seven; windows a clip. phases: a mask of A (1), B (2), C (4)
// and D (8), launched in that order on the stream. Returns the CUDA error
// of the launches; cudaErrorInvalidValue for arguments or a geometry the
// kernels cannot run.
int psla_mbconv_v2_launch(const void* const* ptrs, const int* dims, const int* geo,
                          int phases, void* stream) {
  const int k = dims[7], stride = dims[8];
  if ((k != 3 && k != 5) || (stride != 1 && stride != 2) || dims[0] <= 0 || dims[1] <= 0 ||
      dims[2] <= 0 || dims[3] <= 0 || dims[4] <= 0 || dims[5] <= 0 || dims[6] <= 0 || !ptrs[0])
    return kInvalid;
  // 16-byte copies of rows: channel counts in multiples of 8, aligned arrays
  if (dims[3] % 8 || dims[4] % 8 || dims[6] % 8) return kInvalid;
  for (int i = 0; i < 17; ++i)
    if (!aligned16(ptrs[i])) return kInvalid;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool fast = dims[9] != 0, x_bf16 = dims[11] != 0;
  if (x_bf16) return fast ? run<bf16, bf16>(ptrs, dims, geo, phases, s)
                          : run<bf16, float>(ptrs, dims, geo, phases, s);
  return fast ? run<float, bf16>(ptrs, dims, geo, phases, s)
              : run<float, float>(ptrs, dims, geo, phases, s);
}

}  // extern "C"
