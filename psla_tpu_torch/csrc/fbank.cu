// Kaldi log-mel filterbank: [B, N] float32 waveforms -> [B, T, n_mels].
//
// Replaces the TPU kernel psla_tpu/frontend/fbank_pallas.py::_fbank_kernel.
// It computes the same function as that kernel and as the 'fft' lowering in
// psla_tpu_torch/frontend/fbank.py, which is its plain version, in that
// lowering's order: for each frame of `window` samples,
//
//   x     = frame - mean(frame)                 (if remove_dc)
//   x[j] -= preemph * x[j-1], x[-1] := x[0]
//   x    *= window                              (a table: any window type)
//   X     = rfft(x zero-padded to nfft)
//   mel   = sum over each mel row's run of bins of weight * |X[k]|^2
//   out   = log(max(mel, FLT_EPSILON)), and 0 for frames >= n_valid
//
// with n_valid = frames(min(length, N)) capped at T, and the time axis
// zero-padded or cut to T.
//
// Bound on an H100 SXM: bytes. At B=16, T=1056 (the serving micro-batch)
// the function moves ~18 MB (the valid frames' samples in, the log-mel
// out): ~5.5 us at 3.35 TB/s. Its operations are fewer: a 512-point real
// FFT (~11.5k flop), the banks' 504 non-zeros and ~3k flop of DC removal,
// pre-emphasis, window, power and log a frame, ~0.23 GFLOP in all: ~3.5 us
// at the 67 TFLOP/s float32 CUDA-core rate.
//
// Design. One block of threads per (tile of kTM frames, clip) stages the
// tile's (kTM-1)*shift + window samples in shared memory once (frame i is
// the slice [i*shift, i*shift + window), so no frame matrix goes to device
// memory). Each warp then takes one frame at a time:
//   1. the mean is a warp reduction; each lane builds its points of the
//      processed, zero-padded frame from the staged samples (pre-emphasis
//      reads the neighbouring sample, the window a table), packed as the
//      complex sequence z[n] = x[2n] + i x[2n+1] of half = nfft/2 points;
//   2. a complex FFT of z in registers: point n = a + L*r lies in lane a,
//      register r (L = min(32, half) lanes, R = half/L registers). An
//      R-point DIF FFT in registers, a twiddle W_half^(a*k2), then an
//      L-point DIF FFT across lanes by xor shuffles. Lane a register r ends
//      with Z[bitrev_R(r) + R*bitrev_L(a)];
//   3. Z goes to shared memory (padded so the bit-reversed stores hit
//      distinct banks); each lane splits Z[k] and Z[half-k] into the real
//      FFT's bin k, k = 0..half, and stores its power;
//   4. each lane sums its mel rows over their runs of bins (the banks'
//      non-zeros only: (first bin, count, offset) and packed weights), takes
//      the log and writes one frame's n_mels values coalesced.
// Precision: steps 1-3 run in float64, from the float32 samples and window
// to each bin's power, which is then rounded to float32 for the mel sums
// (float32 FMA) and the log. A float32 FFT rounds relative to the frame's
// energy, and after pre-emphasis the lowest mel bands of a frame hold
// ~1e-7 of it: there float32 costs up to a few 1e-3 in the log-mel (on an
// H100 the 'fft' lowering, float32 through cuFFT, is 3.7e-3 off the exact
// log-mel on chip_smoke.py's tones). In float64 the kernel stays within
// ~1e-6 of the exact function (its plain version, the 'fft64' lowering).
// float64 runs at half the float32 rate on an H100, and a 64-bit shuffle
// is two; the FFT is a small part of the bound either way. Every twiddle
// is computed in float64 on the host and read from a float64 table
// (fbank_cuda.kernel_tables), so nothing depends on sincos in the kernel.
// The same arithmetic serves every `precision` value. Tiles wholly past
// n_valid only write zeros; frames past n_valid in a tile do no arithmetic.

#include <cfloat>

#include <cuda_runtime.h>

namespace {

constexpr int kTM = 32;                  // frames per block
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxHalf = 256;            // nfft <= 512
constexpr int kMelIters = 4;             // mel rows per lane: lane + 32*j
constexpr int kMaxMels = 32 * kMelIters;

__device__ __forceinline__ double2 cadd(double2 a, double2 b) {
  return make_double2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ double2 csub(double2 a, double2 b) {
  return make_double2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ double2 cmul(double2 a, double2 b) {
  return make_double2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// Shared-memory slot of Z[i]: one slot of padding every 16, so that the
// bit-reversed stores of one register by 16 lanes land in distinct banks.
__device__ __forceinline__ int zslot(int i) { return i + (i >> 4); }

__host__ __device__ constexpr int bitrev(int x, int bits) {
  int y = 0;
  for (int i = 0; i < bits; ++i) y |= ((x >> i) & 1) << (bits - 1 - i);
  return y;
}

__host__ __device__ constexpr int ilog2(int x) { return x <= 1 ? 0 : 1 + ilog2(x / 2); }

// Floats of the per-warp scratch: Z (double2, padded) and the power
// spectrum (float); a multiple of 4 keeps each warp's Z 16-byte aligned.
__host__ __device__ constexpr int zfloats(int half) {
  return 4 * ((half - 1) + ((half - 1) >> 4) + 1);
}
__host__ __device__ constexpr int warp_floats(int half) {
  return (zfloats(half) + half + 1 + 3) / 4 * 4;
}

template <int R>
__global__ void __launch_bounds__(kThreads, 2)
fbank_kernel(const float* __restrict__ wav,         // [B, n]
             const int* __restrict__ lengths,       // [B] or null (all n)
             const float* __restrict__ window,      // [ws]
             const double2* __restrict__ twiddle,   // [half + 1]: W_nfft^k
             const double2* __restrict__ twiddle2,  // [R, L]: W_half^(a*k2)
             const int* __restrict__ mel_runs,      // [n_mels, 3]
             const float* __restrict__ mel_weights,
             float* __restrict__ out,               // [B, target, n_mels]
             int n, int target, int ws, int shift, int log2_l, int n_mels,
             int remove_dc, double preemph, int span) {
  extern __shared__ float4 smem4[];
  float* samples = reinterpret_cast<float*>(smem4);  // [span]
  const int L = 1 << log2_l;
  const int half = R * L;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int a = lane & (L - 1);  // lanes >= L mirror lane a (half < 32)
  float* scratch = samples + span + warp * warp_floats(half);
  double2* zbuf = reinterpret_cast<double2*>(scratch);
  float* pbuf = scratch + zfloats(half);

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kTM;
  const int len = lengths ? min(lengths[b], n) : n;
  int n_valid = len >= ws ? 1 + (len - ws) / shift : 0;
  n_valid = min(n_valid, target);

  float* out_b = out + static_cast<size_t>(b) * target * n_mels;
  if (t0 >= n_valid) {  // the whole tile is padding: zeros, no arithmetic
    for (int i = threadIdx.x; i < kTM * n_mels; i += kThreads) {
      const int t = t0 + i / n_mels;
      if (t < target) out_b[static_cast<size_t>(t) * n_mels + i % n_mels] = 0.f;
    }
    return;
  }

  // Stage the tile's samples. Samples past n are zero; frames that read
  // them are past n_valid and are not computed.
  const float* wav_b = wav + static_cast<size_t>(b) * n;
  const long long base = static_cast<long long>(t0) * shift;
  for (int i = threadIdx.x; i < span; i += kThreads) {
    const long long g = base + i;
    samples[i] = g < n ? wav_b[g] : 0.f;
  }

  __syncthreads();

  for (int f = warp; f < kTM; f += kWarps) {
    const int t = t0 + f;
    if (t >= target) break;
    float* orow = out_b + static_cast<size_t>(t) * n_mels;
    if (t >= n_valid) {
      for (int m = lane; m < n_mels; m += 32) orow[m] = 0.f;
      continue;
    }
    const float* s = samples + f * shift;

    // 1. mean, pre-emphasis, window, packing.
    double mu = 0.0;
    if (remove_dc) {
      double sum = 0.0;
      for (int j = lane; j < ws; j += 32) sum += s[j];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      mu = sum / ws;
    }
    double2 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      double p[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = 2 * (a + L * r) + e;
        double x = 0.0;
        if (j < ws) {
          const double cur = s[j] - mu;
          const double prev = s[j > 0 ? j - 1 : 0] - mu;
          x = (cur - preemph * prev) * __ldg(window + j);
        }
        p[e] = x;
      }
      v[r] = make_double2(p[0], p[1]);
    }

    // 2. complex FFT of half points: R-point DIF in registers (register r
    // then holds bin bitrev_R(r)), the twiddle, L-point DIF across lanes.
#pragma unroll
    for (int h = R / 2; h >= 1; h >>= 1) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r & h) continue;
        const double2 top = v[r], bot = v[r + h];
        v[r] = cadd(top, bot);
        // W_2h^j = W_nfft^(j * half / h)
        v[r + h] = cmul(csub(top, bot), __ldg(twiddle + (r & (h - 1)) * (2 * half / (2 * h))));
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
      v[r] = cmul(v[r], __ldg(twiddle2 + bitrev(r, ilog2(R)) * L + a));
#pragma unroll
    for (int st = 0; st < 5; ++st) {
      if (st >= log2_l) break;
      const int h = (L >> 1) >> st;
      const bool bottom = lane & h;
      // top: v + o; bottom: (o - v) * W_2h^(a mod h), as one form for both
      const double sign = bottom ? -1.0 : 1.0;
      const double2 w = bottom ? __ldg(twiddle + (a & (h - 1)) * (half / h))
                               : make_double2(1.0, 0.0);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const double2 o = make_double2(__shfl_xor_sync(0xffffffffu, v[r].x, h),
                                       __shfl_xor_sync(0xffffffffu, v[r].y, h));
        v[r] = cmul(make_double2(fma(v[r].x, sign, o.x), fma(v[r].y, sign, o.y)), w);
      }
    }

    // 3. Z to shared memory, then the real FFT's bins and their power.
    if (lane < L) {
      const int ra = log2_l ? static_cast<int>(__brev(a) >> (32 - log2_l)) : 0;
#pragma unroll
      for (int r = 0; r < R; ++r) zbuf[zslot(bitrev(r, ilog2(R)) + R * ra)] = v[r];
    }
    __syncwarp();
    for (int k = lane; k <= half; k += 32) {
      const double2 zk = zbuf[zslot(k & (half - 1))];
      const double2 zc = zbuf[zslot((half - k) & (half - 1))];
      const double2 e = make_double2(zk.x + zc.x, zk.y - zc.y);  // Z[k] + conj Z[half-k]
      const double2 d = make_double2(zk.x - zc.x, zk.y + zc.y);  // Z[k] - conj Z[half-k]
      const double2 w = __ldg(twiddle + k);
      // X[k] = (e - i W^k d) / 2
      const double xr = 0.5 * (e.x + (w.x * d.y + w.y * d.x));
      const double xi = 0.5 * (e.y - (w.x * d.x - w.y * d.y));
      pbuf[k] = static_cast<float>(xr * xr + xi * xi);
    }
    __syncwarp();

    // 4. mel rows over their runs of bins, log, coalesced store.
#pragma unroll
    for (int j = 0; j < kMelIters; ++j) {
      const int m = lane + 32 * j;
      if (m >= n_mels) break;
      const int first = __ldg(mel_runs + 3 * m);
      const int count = __ldg(mel_runs + 3 * m + 1);
      const float* wm = mel_weights + __ldg(mel_runs + 3 * m + 2);
      float acc = 0.f;
      for (int i = 0; i < count; ++i) acc = fmaf(pbuf[first + i], __ldg(wm + i), acc);
      orow[m] = logf(fmaxf(acc, FLT_EPSILON));
    }
  }
}

template <int R>
int launch(const void* wav, const void* lengths, const void* window,
           const void* twiddle, const void* twiddle2, const void* mel_runs,
           const void* mel_weights, void* out, int batch, int n, int target,
           int ws, int shift, int log2_l, int n_mels, int remove_dc,
           double preemph, cudaStream_t stream) {
  const int half = R << log2_l;
  const int span = ((kTM - 1) * shift + ws + 3) / 4 * 4;
  const size_t smem = (static_cast<size_t>(span) + kWarps * warp_floats(half)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fbank_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((target + kTM - 1) / kTM, batch);
  fbank_kernel<R><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(wav), static_cast<const int*>(lengths),
      static_cast<const float*>(window), static_cast<const double2*>(twiddle),
      static_cast<const double2*>(twiddle2), static_cast<const int*>(mel_runs),
      static_cast<const float*>(mel_weights), static_cast<float*>(out), n, target,
      ws, shift, log2_l, n_mels, remove_dc, preemph, span);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The tables are fbank_cuda.kernel_tables(config) on the device. Limits the
// wrapper checks before it calls: nfft a power of two in [2, 512] and
// >= ws, n_mels <= 128. Returns the CUDA error of the launch (0 on success).
int psla_fbank_launch(const void* wav, const void* lengths, const void* window,
                      const void* twiddle, const void* twiddle2,
                      const void* mel_runs, const void* mel_weights, void* out,
                      int batch, int n, int target, int ws, int shift, int nfft,
                      int n_mels, int remove_dc, double preemph, void* stream) {
  if (nfft < 2 || nfft > 2 * kMaxHalf || (nfft & (nfft - 1)) || ws < 1 || ws > nfft ||
      shift < 1 || n_mels < 1 || n_mels > kMaxMels)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || target == 0) return 0;
  const int half = nfft / 2;
  const int lanes = half < 32 ? half : 32;
  const int log2_l = ilog2(lanes);
  using Launch = int (*)(const void*, const void*, const void*, const void*, const void*,
                         const void*, const void*, void*, int, int, int, int, int, int,
                         int, int, double, cudaStream_t);
  static const Launch by_regs[] = {launch<1>, launch<2>, launch<4>, launch<8>};
  return by_regs[ilog2(half / lanes)](wav, lengths, window, twiddle, twiddle2, mel_runs,
                                      mel_weights, out, batch, n, target, ws, shift, log2_l,
                                      n_mels, remove_dc, preemph,
                                      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
