// Native polyphase batch resampler for data preparation.
//
// Replaces the reference's per-file `sox -r 16000` shell-outs
// (reference: egs/fsd50k/prep_fsd.py:22-35) with an in-process polyphase
// FIR resampler sharded over a thread pool: decode WAV (channel 0) ->
// upfirdn -> clip [-1, 1] -> PCM16 WAV write.
//
// The FIR taps are DESIGNED ON THE PYTHON SIDE (scipy.signal.firwin with
// resample_poly's defaults, scaled by `up`, float64) and passed in, so
// the filter is bit-identical to the scipy fallback path; this file only
// runs the compute. The output slice matches scipy.signal.resample_poly:
// with an odd symmetric filter of length 2*half_len+1,
//   y[k] = sum_i taps[half_len + k*down - i*up] * x[i],
//   k in [0, ceil(len(x)*up/down)).
// (resample_poly's h pre-pad / n_pre_remove bookkeeping reduces exactly
// to reading the full convolution at offset half_len; verified against
// scipy in tests/test_native.py.)
//
// PCM16 quantization matches psla_tpu/data/wav.py write_wav: clip to
// [-1, 1], scale by 32767, round half-to-even (rint under the default
// rounding mode == numpy.round).

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include "wavio.h"

namespace {

constexpr int kOk = 0;
constexpr int kErrWrite = -8;
constexpr int kErrArgs = -9;
// input file's sample rate differs from the rate the taps were designed
// for — caller should resample this file via its fallback path
constexpr int kErrRateMismatch = -10;

// y[k] = sum_i taps[center + k*down - i*up] * x[i], double accumulation.
void upfirdn_slice(const float* x, int64_t n, const double* taps,
                   int64_t n_taps, int64_t center, int64_t up, int64_t down,
                   int64_t n_out, double* y) {
  for (int64_t k = 0; k < n_out; ++k) {
    const int64_t m = center + k * down;  // position in the upsampled grid
    // need j = m - i*up in [0, n_taps) and i in [0, n)
    int64_t i_lo = (m - (n_taps - 1) + up - 1) / up;  // ceil
    if (i_lo < 0) i_lo = 0;
    int64_t i_hi = m / up;  // floor
    if (i_hi > n - 1) i_hi = n - 1;
    double acc = 0.0;
    for (int64_t i = i_lo; i <= i_hi; ++i) acc += taps[m - i * up] * x[i];
    y[k] = acc;
  }
}

int write_pcm16(const char* path, const double* y, int64_t n, int32_t rate) {
  std::vector<int16_t> pcm(static_cast<size_t>(n));
  for (int64_t i = 0; i < n; ++i) {
    double v = y[i];
    if (v > 1.0) v = 1.0;
    if (v < -1.0) v = -1.0;
    pcm[i] = static_cast<int16_t>(std::rint(v * 32767.0));
  }
  FILE* f = std::fopen(path, "wb");
  if (!f) return kErrWrite;
  const uint32_t data_bytes = static_cast<uint32_t>(n * 2);
  uint8_t hdr[44];
  std::memcpy(hdr, "RIFF", 4);
  uint32_t riff = 36 + data_bytes;
  std::memcpy(hdr + 4, &riff, 4);
  std::memcpy(hdr + 8, "WAVEfmt ", 8);
  uint32_t fmt_size = 16;
  std::memcpy(hdr + 16, &fmt_size, 4);
  uint16_t fmt_tag = 1, channels = 1, block = 2, bits = 16;
  uint32_t byte_rate = static_cast<uint32_t>(rate) * 2;
  uint32_t rate_u = static_cast<uint32_t>(rate);
  std::memcpy(hdr + 20, &fmt_tag, 2);
  std::memcpy(hdr + 22, &channels, 2);
  std::memcpy(hdr + 24, &rate_u, 4);
  std::memcpy(hdr + 28, &byte_rate, 4);
  std::memcpy(hdr + 32, &block, 2);
  std::memcpy(hdr + 34, &bits, 2);
  std::memcpy(hdr + 36, "data", 4);
  std::memcpy(hdr + 40, &data_bytes, 4);
  bool ok = std::fwrite(hdr, 1, 44, f) == 44;
  if (ok && n)
    ok = std::fwrite(pcm.data(), 2, static_cast<size_t>(n), f) ==
         static_cast<size_t>(n);
  std::fclose(f);
  return ok ? kOk : kErrWrite;
}

int resample_one(const char* src, const char* dst, const double* taps,
                 int64_t n_taps, int64_t up, int64_t down, int32_t in_rate_expected,
                 int32_t out_rate) {
  if (up < 1 || down < 1 || n_taps < 1 || n_taps % 2 == 0) return kErrArgs;
  std::vector<float> x;
  int32_t in_rate = 0;
  int rc = pslanative::decode_full(src, &x, &in_rate);
  if (rc != kOk) return rc;
  if (in_rate != in_rate_expected) return kErrRateMismatch;
  const int64_t n = static_cast<int64_t>(x.size());
  if (up == down) {  // passthrough (already at target rate)
    std::vector<double> y(x.begin(), x.end());
    return write_pcm16(dst, y.data(), n, out_rate);
  }
  const int64_t n_out = (n * up + down - 1) / down;
  std::vector<double> y(static_cast<size_t>(n_out));
  upfirdn_slice(x.data(), n, taps, n_taps, (n_taps - 1) / 2, up, down, n_out,
                y.data());
  return write_pcm16(dst, y.data(), n_out, out_rate);
}

}  // namespace

extern "C" {

// Resample a batch of WAV files concurrently. taps: odd-length float64 FIR
// (already scaled by `up`). Returns the number of failures; per-file codes
// in `status`.
int psla_resample_batch(const char** src, const char** dst, int32_t n,
                        const double* taps, int64_t n_taps, int32_t up,
                        int32_t down, int32_t in_rate, int32_t out_rate,
                        int32_t* status, int32_t n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int32_t> next{0};
  std::atomic<int32_t> failures{0};
  auto worker = [&]() {
    for (;;) {
      int32_t i = next.fetch_add(1);
      if (i >= n) return;
      int rc = resample_one(src[i], dst[i], taps, n_taps, up, down, in_rate,
                            out_rate);
      if (status) status[i] = rc;
      if (rc != kOk) failures.fetch_add(1);
    }
  };
  int workers = n_threads < n ? n_threads : n;
  std::vector<std::thread> pool;
  pool.reserve(workers > 1 ? workers - 1 : 0);
  for (int t = 1; t < workers; ++t) pool.emplace_back(worker);
  worker();
  for (auto& th : pool) th.join();
  return failures.load();
}

}  // extern "C"
