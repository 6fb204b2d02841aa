// Train-mode batch normalization of NCHW float32 activations, with the
// activation that follows it (none or SiLU) fused in: one forward kernel
// and one backward kernel.
//
// Replaces no TPU kernel: the JAX package leaves train-mode BatchNorm and
// SiLU to XLA's fusions. On the H100 the port called cuDNN's NCHW `1C11`
// BatchNorm kernels (`bn_fw_tr_1C11_kernel_NCHW`, `bn_bw_1C11_kernel_new`)
// and PyTorch's elementwise SiLU, ~29% of an audioset_full train step: the
// forward read x twice and wrote y, SiLU read y and wrote z; the backward
// read y and dz and wrote dy, then read x and dy twice and wrote dx; and
// autograd kept y alive for SiLU's backward.
//
//   forward:  mean, var = batch moments of x over (N, H, W), biased
//             z = act((x - mean) * (w * invstd) + b), invstd = 1/sqrt(var + eps)
//             running_mean += m * (mean - running_mean)
//             running_var  += m * (var * n / (n - 1) - running_var)
//   backward: y and act'(y) recomputed from x and the saved [C] mean and
//             invstd; dy = dz * act'(y), xh = (x - mean) * invstd
//             db = sum(dy), dw = sum(dy * xh)
//             dx = w * invstd * (dy - db / n - xh * dw / n)
//
// Bound on an H100 SXM: bytes. The forward has to read x once and write z
// once, 8 B an element; the backward reads x and dz once and writes dx,
// 12 B an element. A B2 train step at batch 100 and T=1056 normalizes
// 2.638 G elements in its 69 BatchNorms: 52.8 GB, 15.8 ms at 3.35 TB/s.
// The operations (~20 flop an element with the SiLU's exp) are far below
// the float32 rate.
//
// Design. One cluster of G blocks per channel (G in 1..16, a thread-block
// cluster of Hopper): block r of the cluster takes the r-th of G equal runs
// of the channel's N * HW elements, read as 16-byte items where HW % 4 == 0
// (else 4-byte items). Each block reduces its run to partial moments; the
// partials are shared over distributed shared memory and every block
// combines them in rank order, so all G blocks hold the same statistics
// and the result does not depend on the schedule (no atomics). Then each
// block applies them to its run. The wrapper (ops/bn_train.py, `geometry`)
// picks G and one of two regimes from the shape alone:
//   * held: where a run fits one block's shared memory (x in the forward, x
//     and dz in the backward), the smallest G whose runs take at most 72 KB,
//     else at most kSmemCap. The run is read from device memory once
//     (cp.async) and the second sweep reads shared memory: 8 and 12 B an
//     element, the bound. For B2 at batch 100 these are the layers at HW
//     132, 528 and 2112, at batch 24 those at HW 376, 1504 and 6000.
//   * streamed: a run too long for any G reads its elements twice from
//     device memory, the second sweep in reverse order so that its first
//     items, the last of the first sweep, may still lie in the 50 MB L2;
//     G = 8 (16 where C * 8 blocks would leave SMs empty): 12 and 20 B an
//     element.
// Numerics stay float32 in and out. The batch moments are Chan's: each
// thread keeps (count, mean, M2) of its elements in float32, merging a
// chunk of up to 16 values at a time (the chunk's mean subtracted before
// squaring); the threads, the warps and the cluster's blocks are combined
// by Chan's pairwise rule in float64. The backward's two sums are float32
// within a chunk and float64 beyond.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;
// The most shared memory a held run may take: two such blocks fit on an
// SM. ops/bn_train.py's SMEM_CAP is the same number.
constexpr int kSmemCap = 110 * 1024;
constexpr int kMaxCluster = 16;

// One item of VW floats: a 16-byte vector or one float.
template <int VW>
__device__ __forceinline__ void load(const float* p, float (&v)[VW]) {
  if constexpr (VW == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    v[0] = *p;
  }
}

template <int VW>
__device__ __forceinline__ void store(float* p, const float (&v)[VW]) {
  if constexpr (VW == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *p = v[0];
  }
}

template <int VW>
__device__ __forceinline__ void copy_async(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (VW == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
  }
}

__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The position of a thread's item in a channel: row (clip) n and item j
// within the row of hwv items, stepped by a fixed stride of items.
struct Cursor {
  int n, j, q, r, hwv;
  __device__ Cursor(int f, int stride, int hwv_) : hwv(hwv_) {
    n = f / hwv;
    j = f - n * hwv;
    q = stride / hwv;
    r = stride - q * hwv;
  }
  __device__ __forceinline__ void next() {
    n += q;
    j += r;
    if (j >= hwv) { j -= hwv; ++n; }
  }
  __device__ __forceinline__ void prev() {
    n -= q;
    j -= r;
    if (j < 0) { j += hwv; --n; }
  }
  // index of the item in the NCHW tensor, in items
  __device__ __forceinline__ size_t at(int ch, int c) const {
    return (static_cast<size_t>(n) * c + ch) * hwv + j;
  }
};

// A block's run of a channel: items [f0, f1), `mine` of them this thread's
// (f0 + tid, f0 + tid + kThreads, ...).
struct Run {
  int f0, f1, mine;
  __device__ Run(int items, int rank, int g) {
    f0 = static_cast<int>(static_cast<long long>(items) * rank / g);
    f1 = static_cast<int>(static_cast<long long>(items) * (rank + 1) / g);
    const int left = f1 - f0 - static_cast<int>(threadIdx.x);
    mine = left > 0 ? (left + kThreads - 1) / kThreads : 0;
  }
  __device__ __forceinline__ int first() const { return f0 + threadIdx.x; }
  __device__ __forceinline__ int last() const { return f0 + threadIdx.x + (mine - 1) * kThreads; }
};

struct Moments {
  float n, mean, m2;
};

// Merge the moments of K values into a thread's moments (Chan).
template <int K>
__device__ __forceinline__ void merge(Moments& a, const float* v) {
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) s += v[k];
  const float mb = s * (1.0f / K);
  float m2b = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float d = v[k] - mb;
    m2b = fmaf(d, d, m2b);
  }
  const float n = a.n + K;
  const float d = mb - a.mean;
  const float f = K / n;
  a.mean = fmaf(d, f, a.mean);
  a.m2 += m2b + d * d * a.n * f;
  a.n = n;
}

__device__ __forceinline__ void chan(double& na, double& ma, double& m2a, double nb, double mb,
                                     double m2b) {
  const double n = na + nb;
  if (nb == 0.0) return;
  const double d = mb - ma, f = nb / n;
  ma += d * f;
  m2a += m2b + d * d * na * f;
  na = n;
}

// This block's moments, in float64, left in part[0..2] (thread 0 writes).
__device__ void block_moments(const Moments& t, double* part) {
  __shared__ double w[3][kWarps];
  double n = t.n, m = t.mean, m2 = t.m2;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const double nb = __shfl_down_sync(0xffffffffu, n, off);
    const double mb = __shfl_down_sync(0xffffffffu, m, off);
    const double m2b = __shfl_down_sync(0xffffffffu, m2, off);
    chan(n, m, m2, nb, mb, m2b);
  }
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) {
    w[0][warp] = n; w[1][warp] = m; w[2][warp] = m2;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    n = w[0][0]; m = w[1][0]; m2 = w[2][0];
    for (int k = 1; k < kWarps; ++k) chan(n, m, m2, w[0][k], w[1][k], w[2][k]);
    part[0] = n; part[1] = m; part[2] = m2;
  }
}

// This block's two sums, in float64, left in part[0..1] (thread 0 writes).
__device__ void block_sums(double a, double b, double* part) {
  __shared__ double w[2][kWarps];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, off);
    b += __shfl_down_sync(0xffffffffu, b, off);
  }
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) {
    w[0][warp] = a; w[1][warp] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    a = 0.0; b = 0.0;
    for (int k = 0; k < kWarps; ++k) { a += w[0][k]; b += w[1][k]; }
    part[0] = a; part[1] = b;
  }
}

// Release this block's shared memory to the cluster's readers; the block
// waits for them (cluster_done) before it exits.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_done() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Offset, in floats, of this thread's k-th item in its block's held run.
template <int VW>
__device__ __forceinline__ size_t slot(int k) {
  return (static_cast<size_t>(k) * kThreads + threadIdx.x) * VW;
}

template <int ACT, bool HELD, int VW>
__global__ void __launch_bounds__(kThreads, 4)
psla_bn_fw_train(const float* __restrict__ x, float* __restrict__ z,
                 const float* __restrict__ weight, const float* __restrict__ bias,
                 float* __restrict__ running_mean, float* __restrict__ running_var,
                 float* __restrict__ save_mean, float* __restrict__ save_invstd, int n, int c,
                 int hwv, double momentum, double eps) {
  extern __shared__ __align__(16) float held[];
  __shared__ double part[3];
  __shared__ float stat[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int g = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int ch = blockIdx.x / g;
  const Run run(n * hwv, rank, g);

  if constexpr (HELD) {
    Cursor cur(run.first(), kThreads, hwv);
    for (int k = 0; k < run.mine; ++k, cur.next()) {
      copy_async<VW>(held + slot<VW>(k), x + cur.at(ch, c) * VW);
    }
    copy_wait();  // each thread reads back only the items it copied
  }

  // sweep 1: the moments of the run
  Moments t{0.f, 0.f, 0.f};
  {
    Cursor cur(run.first(), kThreads, hwv);
    int k = 0;
    for (; k + kUnroll <= run.mine; k += kUnroll) {
      float v[kUnroll][VW];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u, cur.next()) {
        load<VW>(HELD ? held + slot<VW>(k + u) : x + cur.at(ch, c) * VW, v[u]);
      }
      merge<kUnroll * VW>(t, &v[0][0]);
    }
    for (; k < run.mine; ++k, cur.next()) {
      float v[VW];
      load<VW>(HELD ? held + slot<VW>(k) : x + cur.at(ch, c) * VW, v);
      merge<VW>(t, v);
    }
  }
  block_moments(t, part);
  cluster.sync();
  if (threadIdx.x == 0) {
    double cn = 0.0, cm = 0.0, cm2 = 0.0;
    for (int r = 0; r < g; ++r) {
      const double* p = cluster.map_shared_rank(part, r);
      chan(cn, cm, cm2, p[0], p[1], p[2]);
    }
    const double invstd = 1.0 / sqrt(cm2 / cn + eps);
    stat[0] = static_cast<float>(cm);
    stat[1] = static_cast<float>(invstd);
    if (rank == 0) {
      save_mean[ch] = static_cast<float>(cm);
      save_invstd[ch] = static_cast<float>(invstd);
      running_mean[ch] = static_cast<float>((1.0 - momentum) * running_mean[ch] + momentum * cm);
      running_var[ch] = static_cast<float>((1.0 - momentum) * running_var[ch] +
                                           momentum * (cm2 / (cn - 1.0)));
    }
  }
  __syncthreads();
  cluster_arrive();

  // sweep 2, in reverse order: z = act((x - mean) * scale + b)
  const float mean = stat[0];
  const float scale = stat[1] * weight[ch];
  const float b = bias[ch];
  auto apply = [&](float (&v)[VW]) {
#pragma unroll
    for (int e = 0; e < VW; ++e) {
      const float y = fmaf(v[e] - mean, scale, b);
      v[e] = ACT ? y / (1.0f + expf(-y)) : y;
    }
  };
  if (run.mine > 0) {
    Cursor cur(run.last(), kThreads, hwv);
    int k = run.mine - 1;
    for (; k + 1 >= kUnroll; k -= kUnroll) {
      float v[kUnroll][VW];
      size_t at[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u, cur.prev()) {
        at[u] = cur.at(ch, c) * VW;
        load<VW>(HELD ? held + slot<VW>(k - u) : x + at[u], v[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        apply(v[u]);
        store<VW>(z + at[u], v[u]);
      }
    }
    for (; k >= 0; --k, cur.prev()) {
      const size_t at = cur.at(ch, c) * VW;
      float v[VW];
      load<VW>(HELD ? held + slot<VW>(k) : x + at, v);
      apply(v);
      store<VW>(z + at, v);
    }
  }
  cluster_done();
}

template <int ACT, bool HELD, int VW>
__global__ void __launch_bounds__(kThreads, 4)
psla_bn_bw_train(const float* __restrict__ x, const float* __restrict__ dz,
                 const float* __restrict__ weight, const float* __restrict__ bias,
                 const float* __restrict__ save_mean, const float* __restrict__ save_invstd,
                 float* __restrict__ dx, float* __restrict__ dweight, float* __restrict__ dbias,
                 int n, int c, int hwv) {
  extern __shared__ __align__(16) float held[];
  __shared__ double part[2];
  __shared__ float stat[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int g = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int ch = blockIdx.x / g;
  const int items = n * hwv;
  const Run run(items, rank, g);
  // the held run of x, then that of dz, each as long as the longest run
  float* held_dz = held + static_cast<size_t>((items + g - 1) / g) * VW;

  if constexpr (HELD) {
    Cursor cur(run.first(), kThreads, hwv);
    for (int k = 0; k < run.mine; ++k, cur.next()) {
      const size_t at = cur.at(ch, c) * VW;
      copy_async<VW>(held + slot<VW>(k), x + at);
      copy_async<VW>(held_dz + slot<VW>(k), dz + at);
    }
    copy_wait();  // each thread reads back only the items it copied
  }
  // this thread's k-th item of x and dz; returns its offset in the tensor
  auto fetch = [&](int k, const Cursor& cur, float (&xv)[VW], float (&gv)[VW]) {
    const size_t at = cur.at(ch, c) * VW;
    load<VW>(HELD ? held + slot<VW>(k) : x + at, xv);
    load<VW>(HELD ? held_dz + slot<VW>(k) : dz + at, gv);
    return at;
  };

  const float mean = save_mean[ch];
  const float invstd = save_invstd[ch];
  const float scale = invstd * weight[ch];
  const float b = bias[ch];
  // dy and xh of one item, in place of dz and x
  auto grad = [&](float (&xv)[VW], float (&gv)[VW]) {
#pragma unroll
    for (int e = 0; e < VW; ++e) {
      const float d = xv[e] - mean;
      if (ACT) {
        const float y = fmaf(d, scale, b);
        const float s = 1.0f / (1.0f + expf(-y));
        gv[e] *= s * (1.0f + y * (1.0f - s));
      }
      xv[e] = d * invstd;
    }
  };

  // sweep 1: sum(dy) and sum(dy * xh) over the run
  double sdy = 0.0, sdyxh = 0.0;
  {
    Cursor cur(run.first(), kThreads, hwv);
    int k = 0;
    for (; k + kUnroll <= run.mine; k += kUnroll) {
      float xv[kUnroll][VW], gv[kUnroll][VW];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u, cur.next()) fetch(k + u, cur, xv[u], gv[u]);
      float a = 0.f, p = 0.f;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        grad(xv[u], gv[u]);
#pragma unroll
        for (int e = 0; e < VW; ++e) {
          a += gv[u][e];
          p = fmaf(gv[u][e], xv[u][e], p);
        }
      }
      sdy += a;
      sdyxh += p;
    }
    for (; k < run.mine; ++k, cur.next()) {
      float xv[VW], gv[VW];
      fetch(k, cur, xv, gv);
      grad(xv, gv);
      float a = 0.f, p = 0.f;
#pragma unroll
      for (int e = 0; e < VW; ++e) {
        a += gv[e];
        p = fmaf(gv[e], xv[e], p);
      }
      sdy += a;
      sdyxh += p;
    }
  }
  block_sums(sdy, sdyxh, part);
  cluster.sync();
  if (threadIdx.x == 0) {
    double a = 0.0, p = 0.0;
    for (int r = 0; r < g; ++r) {
      const double* q = cluster.map_shared_rank(part, r);
      a += q[0];
      p += q[1];
    }
    const double count = static_cast<double>(items) * VW;
    stat[0] = static_cast<float>(a / count);
    stat[1] = static_cast<float>(p / count);
    if (rank == 0) {
      dbias[ch] = static_cast<float>(a);
      dweight[ch] = static_cast<float>(p);
    }
  }
  __syncthreads();
  cluster_arrive();

  // sweep 2, in reverse order: dx = scale * (dy - mean(dy) - xh * mean(dy * xh))
  const float mdy = stat[0];
  const float mdyxh = stat[1];
  auto apply = [&](float (&xv)[VW], float (&gv)[VW]) {
    grad(xv, gv);
#pragma unroll
    for (int e = 0; e < VW; ++e) gv[e] = scale * (gv[e] - mdy - xv[e] * mdyxh);
  };
  if (run.mine > 0) {
    Cursor cur(run.last(), kThreads, hwv);
    int k = run.mine - 1;
    for (; k + 1 >= kUnroll; k -= kUnroll) {
      float xv[kUnroll][VW], gv[kUnroll][VW];
      size_t at[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u, cur.prev()) at[u] = fetch(k - u, cur, xv[u], gv[u]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        apply(xv[u], gv[u]);
        store<VW>(dx + at[u], gv[u]);
      }
    }
    for (; k >= 0; --k, cur.prev()) {
      float xv[VW], gv[VW];
      const size_t at = fetch(k, cur, xv, gv);
      apply(xv, gv);
      store<VW>(dx + at, gv);
    }
  }
  cluster_done();
}

// Shared memory of a held run, in bytes (0 when streamed); `operands` is 1
// for the forward (x), 2 for the backward (x, dz). ops/bn_train.geometry
// computes the same.
size_t held_bytes(int n, int hwv, int vw, int cluster, int operands) {
  const long long items = static_cast<long long>(n) * hwv;
  return static_cast<size_t>((items + cluster - 1) / cluster) * vw * sizeof(float) * operands;
}

bool valid(int n, int c, int hw, int vw, int cluster, int held, int act, int operands) {
  if (n <= 0 || c <= 0 || hw <= 0 || (vw != 1 && vw != 4) || hw % vw != 0) return false;
  if (static_cast<long long>(n) * hw < 2 || static_cast<long long>(n) * hw > (1LL << 30)) {
    return false;
  }
  if (cluster < 1 || cluster > kMaxCluster || (cluster & (cluster - 1)) != 0) return false;
  if (static_cast<long long>(c) * cluster > 0x7fffffffLL) return false;
  if (act != 0 && act != 1) return false;
  if (held && held_bytes(n, hw / vw, vw, cluster, operands) > kSmemCap) return false;
  return true;
}

// Allows the held runs' shared memory and clusters of 16, then launches
// `blocks` blocks in clusters of `cluster`.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int blocks, int cluster, size_t smem, cudaStream_t stream,
           Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmemCap);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(blocks);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int ACT, bool HELD, int VW>
int fw(const float* x, float* z, const float* weight, const float* bias, float* running_mean,
       float* running_var, float* save_mean, float* save_invstd, int n, int c, int hw,
       int cluster, double momentum, double eps, cudaStream_t stream) {
  const int hwv = hw / VW;
  const size_t smem = HELD ? held_bytes(n, hwv, VW, cluster, 1) : 0;
  return launch(psla_bn_fw_train<ACT, HELD, VW>, c * cluster, cluster, smem, stream, x, z,
                weight, bias, running_mean, running_var, save_mean, save_invstd, n, c, hwv,
                momentum, eps);
}

template <int ACT, bool HELD, int VW>
int bw(const float* x, const float* dz, const float* weight, const float* bias,
       const float* save_mean, const float* save_invstd, float* dx, float* dweight,
       float* dbias, int n, int c, int hw, int cluster, cudaStream_t stream) {
  const int hwv = hw / VW;
  const size_t smem = HELD ? held_bytes(n, hwv, VW, cluster, 2) : 0;
  return launch(psla_bn_bw_train<ACT, HELD, VW>, c * cluster, cluster, smem, stream, x, dz,
                weight, bias, save_mean, save_invstd, dx, dweight, dbias, n, c, hwv);
}

// The eight instantiations of each direction, by (act, held, vw == 4).
using FwFn = decltype(&fw<0, false, 1>);
using BwFn = decltype(&bw<0, false, 1>);
constexpr FwFn kFw[8] = {fw<0, false, 1>, fw<0, false, 4>, fw<0, true, 1>, fw<0, true, 4>,
                         fw<1, false, 1>, fw<1, false, 4>, fw<1, true, 1>, fw<1, true, 4>};
constexpr BwFn kBw[8] = {bw<0, false, 1>, bw<0, false, 4>, bw<0, true, 1>, bw<0, true, 4>,
                         bw<1, false, 1>, bw<1, false, 4>, bw<1, true, 1>, bw<1, true, 4>};

int variant(int act, int held, int vw) { return act * 4 + (held ? 2 : 0) + (vw == 4 ? 1 : 0); }

}  // namespace

extern "C" {

// Forward: z = act(BN(x)) for NCHW float32 x; writes the batch mean and
// invstd ([C]) and updates the running statistics in place. Returns a
// cudaError_t (cudaErrorInvalidValue for a geometry it does not take).
int psla_bn_fw_launch(const void* x, void* z, const void* weight, const void* bias,
                      void* running_mean, void* running_var, void* save_mean,
                      void* save_invstd, int n, int c, int hw, int vw, int cluster, int held,
                      int act, double momentum, double eps, void* stream) {
  if (!valid(n, c, hw, vw, cluster, held, act, 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return kFw[variant(act, held, vw)](
      static_cast<const float*>(x), static_cast<float*>(z), static_cast<const float*>(weight),
      static_cast<const float*>(bias), static_cast<float*>(running_mean),
      static_cast<float*>(running_var), static_cast<float*>(save_mean),
      static_cast<float*>(save_invstd), n, c, hw, cluster, momentum, eps,
      static_cast<cudaStream_t>(stream));
}

// Backward: dx, dweight and dbias from x, dz and the forward's [C] mean
// and invstd. Returns a cudaError_t.
int psla_bn_bw_launch(const void* x, const void* dz, const void* weight, const void* bias,
                      const void* save_mean, const void* save_invstd, void* dx, void* dweight,
                      void* dbias, int n, int c, int hw, int vw, int cluster, int held,
                      int act, void* stream) {
  if (!valid(n, c, hw, vw, cluster, held, act, 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return kBw[variant(act, held, vw)](
      static_cast<const float*>(x), static_cast<const float*>(dz),
      static_cast<const float*>(weight), static_cast<const float*>(bias),
      static_cast<const float*>(save_mean), static_cast<const float*>(save_invstd),
      static_cast<float*>(dx), static_cast<float*>(dweight), static_cast<float*>(dbias), n, c,
      hw, cluster, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
