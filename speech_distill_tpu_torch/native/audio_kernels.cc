// Native host-side audio kernels of the port's audio front end (own copy
// of speech_distill_tpu/native/audio_kernels.cc).
//
// Resampling (reference utils.py:42-45), percentile volume normalisation
// (audio.py:80-123) and the Kaldi fbank framing run on the host before
// the prompt features go to the device. These C++ implementations match
// the numpy twins in speech_distill_tpu_torch/audio/ bit-close and run
// multi-threaded; Python binds them via ctypes
// (speech_distill_tpu_torch/native/audio.py builds and loads them).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Windowed-sinc polyphase resampler (torchaudio sinc_interp_hann semantics,
// lowpass_filter_width=6, rolloff=0.99). Matches audio/resample.py.
//
// kernels: [new_freq_r, width] precomputed by the caller (shared with the
// numpy path so both use identical filter taps).
// in: [n]; out: [out_len] where out_len = ceil(new * n / orig).
void resample_f32(const float* in, int64_t n, const float* kernels,
                  int64_t n_phases, int64_t kwidth, int64_t orig_r,
                  int64_t half_width, float* out, int64_t out_len,
                  int32_t n_threads) {
  // logical input padded with `half_width` zeros left, half_width+orig right
  const int64_t n_frames = (n + 2 * half_width + orig_r - kwidth) / orig_r + 1;
  auto worker = [&](int64_t f0, int64_t f1) {
    for (int64_t f = f0; f < f1; ++f) {
      const int64_t start = f * orig_r - half_width;  // in unpadded coords
      for (int64_t p = 0; p < n_phases; ++p) {
        const int64_t oi = f * n_phases + p;
        if (oi >= out_len) break;
        const float* kr = kernels + p * kwidth;
        double acc = 0.0;
        const int64_t lo = std::max<int64_t>(0, -start);
        const int64_t hi = std::min<int64_t>(kwidth, n - start);
        for (int64_t t = lo; t < hi; ++t) {
          acc += (double)in[start + t] * (double)kr[t];
        }
        out[oi] = (float)acc;
      }
    }
  };
  if (n_threads <= 1 || n_frames < 256) {
    worker(0, n_frames);
  } else {
    std::vector<std::thread> threads;
    const int64_t chunk = (n_frames + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
      const int64_t a = t * chunk;
      const int64_t b = std::min<int64_t>(n_frames, a + chunk);
      if (a >= b) break;
      threads.emplace_back(worker, a, b);
    }
    for (auto& th : threads) th.join();
  }
}

// Percentile volume normalisation (reference audio.py:80-123 semantics,
// including the quirk that the filtered percentile uses pre-rescale
// magnitudes). In-place on `audio`.
void volume_normalize_f32(float* audio, int64_t n, float coeff) {
  if (n == 0) return;
  std::vector<float> temp(audio, audio + n);
  for (auto& v : temp) v = std::fabs(v);
  std::sort(temp.begin(), temp.end());

  if (temp[n - 1] < 0.1f) {
    const float scaling = std::max(temp[n - 1], 1e-3f);
    for (int64_t i = 0; i < n; ++i) audio[i] = audio[i] / scaling * 0.1f;
  }
  // filter >0.01 from the PRE-rescale magnitudes (reference keeps old temp)
  int64_t lo = std::upper_bound(temp.begin(), temp.end(), 0.01f)
               - temp.begin();
  const int64_t L = n - lo;
  if (L <= 10) return;
  const int64_t a = lo + (int64_t)(0.9 * L);
  const int64_t b = lo + (int64_t)(0.99 * L);
  double sum = 0.0;
  for (int64_t i = a; i < b; ++i) sum += temp[i];
  const double volume = sum / std::max<int64_t>(1, b - a);
  double scale = coeff / volume;
  scale = std::min(10.0, std::max(0.1, scale));
  float maxv = 0.0f;
  for (int64_t i = 0; i < n; ++i) {
    audio[i] = (float)(audio[i] * scale);
    maxv = std::max(maxv, std::fabs(audio[i]));
  }
  if (maxv > 1.0f) {
    for (int64_t i = 0; i < n; ++i) audio[i] /= maxv;
  }
}

// Kaldi-style frame extraction + DC removal + preemphasis + window, the
// host-side part of fbank (audio/fbank.py); FFT stays in numpy (pocketfft).
// in: [n]; window: [win]; out: [n_frames, win].
void fbank_frames_f32(const float* in, int64_t n, const float* window,
                      int64_t win, int64_t hop, float preemph,
                      int32_t remove_dc, float* out, int64_t n_frames) {
  for (int64_t f = 0; f < n_frames; ++f) {
    const float* src = in + f * hop;
    float* dst = out + f * win;
    float mean = 0.0f;
    if (remove_dc) {
      double s = 0.0;
      for (int64_t i = 0; i < win; ++i) s += src[i];
      mean = (float)(s / win);
    }
    float prev = src[0] - mean;
    for (int64_t i = 0; i < win; ++i) {
      const float cur = src[i] - mean;
      const float pre = (i == 0) ? cur : prev;
      dst[i] = (cur - preemph * pre) * window[i];
      prev = cur;
    }
  }
}

}  // extern "C"
