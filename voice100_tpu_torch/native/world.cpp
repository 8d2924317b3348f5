// Native WORLD synthesis (pitch-synchronous overlap-add).
//
// The same algorithm as the jitted JAX synthesizer
// (voice100_tpu/dsp/world/synthesis.py) and its NumPy twin
// (synthesis_np.py): per-sample F0 interpolation, pulse positions from
// wrapped cumulative phase, minimum-phase impulse responses for the
// periodic and aperiodic parts, overlap-add. Exposed as a C ABI for
// ctypes — a dependency-free vocoder back end for native serving
// stacks (the reference gets this from pyworld's C++,
// voice100/vocoder.py:100-101).
//
// FFT: iterative radix-2 Cooley-Tukey (fft sizes here are powers of
// two: out_fft = 2 * fft_size with fft_size 512 or 1024).

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

const double kPi = 3.14159265358979323846;

struct Complex {
  double re = 0.0, im = 0.0;
};

// in-place iterative radix-2 FFT; inverse scales by 1/n
void fft(std::vector<Complex>& a, bool inverse) {
  size_t n = a.size();
  for (size_t i = 1, j = 0; i < n; i++) {
    size_t bit = n >> 1;
    for (; j & bit; bit >>= 1) j ^= bit;
    j ^= bit;
    if (i < j) {
      Complex t = a[i];
      a[i] = a[j];
      a[j] = t;
    }
  }
  for (size_t len = 2; len <= n; len <<= 1) {
    double ang = 2.0 * kPi / (double)len * (inverse ? 1.0 : -1.0);
    double wr = std::cos(ang), wi = std::sin(ang);
    for (size_t i = 0; i < n; i += len) {
      double cur_r = 1.0, cur_i = 0.0;
      for (size_t k = 0; k < len / 2; k++) {
        Complex u = a[i + k];
        Complex v = a[i + k + len / 2];
        double vr = v.re * cur_r - v.im * cur_i;
        double vi = v.re * cur_i + v.im * cur_r;
        a[i + k].re = u.re + vr;
        a[i + k].im = u.im + vi;
        a[i + k + len / 2].re = u.re - vr;
        a[i + k + len / 2].im = u.im - vi;
        double nr = cur_r * wr - cur_i * wi;
        cur_i = cur_r * wi + cur_i * wr;
        cur_r = nr;
      }
    }
  }
  if (inverse) {
    for (auto& c : a) {
      c.re /= (double)n;
      c.im /= (double)n;
    }
  }
}

// real irfft of a half-spectrum (length n/2+1) -> n real samples
void irfft_half(const std::vector<Complex>& half, int n,
                std::vector<double>& out) {
  std::vector<Complex> full(n);
  for (int k = 0; k <= n / 2; k++) full[k] = half[k];
  for (int k = n / 2 + 1; k < n; k++) {
    full[k].re = half[n - k].re;
    full[k].im = -half[n - k].im;
  }
  fft(full, true);
  out.resize(n);
  for (int i = 0; i < n; i++) out[i] = full[i].re;
}

// rfft of n real samples -> half spectrum (n/2+1)
void rfft_real(const std::vector<double>& x, int n,
               std::vector<Complex>& half) {
  std::vector<Complex> full(n);
  for (int i = 0; i < n && i < (int)x.size(); i++) full[i].re = x[i];
  fft(full, false);
  half.assign(full.begin(), full.begin() + n / 2 + 1);
}

// minimum-phase frequency response (zero-padded to out_fft) from a
// half log-power spectrum of size fft_size/2+1
void min_phase_response(const double* log_power_half, int fft_size,
                        int out_fft, std::vector<Complex>& resp) {
  int nh = fft_size / 2 + 1;
  std::vector<Complex> half(nh);
  for (int k = 0; k < nh; k++) half[k].re = 0.5 * log_power_half[k];
  std::vector<double> cep;
  irfft_half(half, fft_size, cep);
  // lifter: c[0], 2*c[1..n/2-1], c[n/2], zeros
  for (int i = 1; i < fft_size / 2; i++) cep[i] *= 2.0;
  for (int i = fft_size / 2 + 1; i < fft_size; i++) cep[i] = 0.0;
  std::vector<Complex> spec;
  rfft_real(cep, fft_size, spec);
  // exp of the complex spectrum
  std::vector<double> ir;
  for (auto& c : spec) {
    double mag = std::exp(c.re);
    double re = mag * std::cos(c.im);
    double im = mag * std::sin(c.im);
    c.re = re;
    c.im = im;
  }
  irfft_half(spec, fft_size, ir);
  // zero-pad the IR to out_fft and transform
  std::vector<double> padded(out_fft, 0.0);
  for (int i = 0; i < fft_size; i++) padded[i] = ir[i];
  rfft_real(padded, out_fft, resp);
}

// xorshift PRNG -> standard normal via Box-Muller (deterministic seed)
struct Rng {
  uint64_t state;
  explicit Rng(uint64_t seed) : state(seed * 6364136223846793005ull + 1) {}
  double uniform() {
    state ^= state << 13;
    state ^= state >> 7;
    state ^= state << 17;
    return (double)(state >> 11) / (double)(1ull << 53);
  }
  double normal() {
    double u1 = uniform(), u2 = uniform();
    if (u1 < 1e-300) u1 = 1e-300;
    return std::sqrt(-2.0 * std::log(u1)) * std::cos(2.0 * kPi * u2);
  }
};

}  // namespace

extern "C" {

// WORLD synthesis. f0 [T], spectrogram [T, nh], aperiodicity [T, nh]
// with nh = fft_size/2+1 (power envelope and amplitude ratio).
// Returns 0 on success; caller frees *out with v100_free.
int v100_world_synthesize(
    const double* f0, const double* spectrogram,
    const double* aperiodicity, int n_frames, int nh, int fs,
    double frame_period_ms, uint64_t seed, float** out, long* out_n) {
  int fft_size = 2 * (nh - 1);
  // power-of-two check (the FFT requires it)
  if (fft_size <= 0 || (fft_size & (fft_size - 1)) != 0) return 1;
  int out_fft = fft_size * 2;
  double hop = fs * frame_period_ms / 1000.0;
  long out_len = (long)std::llround((n_frames - 1) * hop) + 1;

  // per-sample F0 (linear interp; default 200 Hz in unvoiced spans)
  std::vector<double> rate(out_len);
  std::vector<double> f0i(out_len);
  for (long i = 0; i < out_len; i++) {
    double pos = (double)i / hop;
    long fr0 = (long)pos;
    if (fr0 > n_frames - 1) fr0 = n_frames - 1;
    long fr1 = fr0 + 1 < n_frames ? fr0 + 1 : n_frames - 1;
    double w = pos - fr0;
    double a = f0[fr0], b = f0[fr1];
    double v;
    if (a > 0 && b > 0) v = a * (1 - w) + b * w;
    else if (a > 0) v = a;
    else if (b > 0) v = b;
    else v = 0.0;
    f0i[i] = v;
    double r = v > 0 ? v : 200.0;
    if (r < 40.0) r = 40.0;
    if (r > 420.0) r = 420.0;
    rate[i] = r;
  }

  // pulse positions from wrapped cumulative phase
  std::vector<long> pulses;
  double phase = 0.0;
  double prev_wrap = 0.0;
  for (long i = 0; i < out_len; i++) {
    phase += rate[i] / fs;
    double wrap = std::floor(phase);
    if (i == 0 || wrap - prev_wrap >= 1.0) pulses.push_back(i);
    prev_wrap = wrap;
  }

  std::vector<double> acc(out_len + out_fft, 0.0);
  std::vector<double> per_power(nh), ap_power(nh);
  std::vector<Complex> h_per, h_ap, noise_spec;
  std::vector<double> resp, noise(fft_size);
  Rng rng(seed + 1);

  for (size_t p = 0; p < pulses.size(); p++) {
    long pos = pulses[p];
    double frame_pos = (double)pos / hop;
    long pf0 = (long)frame_pos;
    if (pf0 > n_frames - 1) pf0 = n_frames - 1;
    long pf1 = pf0 + 1 < n_frames ? pf0 + 1 : n_frames - 1;
    double w = frame_pos - pf0;
    bool voiced = f0i[pos] > 0.0;
    double period = fs / rate[pos];

    for (int k = 0; k < nh; k++) {
      double sp = spectrogram[pf0 * nh + k] * (1 - w) +
                  spectrogram[pf1 * nh + k] * w;
      double ap = aperiodicity[pf0 * nh + k] * (1 - w) +
                  aperiodicity[pf1 * nh + k] * w;
      if (!voiced) ap = 1.0;
      if (ap < 1e-6) ap = 1e-6;
      if (ap > 1.0 - 1e-12) ap = 1.0 - 1e-12;
      per_power[k] = std::log(sp * (1.0 - ap * ap) + 1e-30);
      ap_power[k] = std::log(sp * ap * ap + 1e-30);
    }

    // periodic: impulse of amplitude sqrt(period) through min-phase IR
    if (voiced) {
      min_phase_response(per_power.data(), fft_size, out_fft, h_per);
      double amp = std::sqrt(period);
      irfft_half(h_per, out_fft, resp);
      for (int i = 0; i < out_fft; i++) {
        long t = pos + i;
        if (t < (long)acc.size()) acc[t] += resp[i] * amp;
      }
    }

    // aperiodic: one period of white noise through min-phase IR
    min_phase_response(ap_power.data(), fft_size, out_fft, h_ap);
    int seg = (int)std::ceil(period);
    if (seg > fft_size) seg = fft_size;
    std::fill(noise.begin(), noise.end(), 0.0);
    for (int i = 0; i < seg; i++) noise[i] = rng.normal();
    std::vector<double> noise_pad(out_fft, 0.0);
    for (int i = 0; i < fft_size; i++) noise_pad[i] = noise[i];
    rfft_real(noise_pad, out_fft, noise_spec);
    for (int k = 0; k < out_fft / 2 + 1; k++) {
      double re = noise_spec[k].re * h_ap[k].re -
                  noise_spec[k].im * h_ap[k].im;
      double im = noise_spec[k].re * h_ap[k].im +
                  noise_spec[k].im * h_ap[k].re;
      noise_spec[k].re = re;
      noise_spec[k].im = im;
    }
    irfft_half(noise_spec, out_fft, resp);
    for (int i = 0; i < out_fft; i++) {
      long t = pos + i;
      if (t < (long)acc.size()) acc[t] += resp[i];
    }
  }

  float* result = (float*)malloc(sizeof(float) * out_len);
  if (!result) return 2;
  for (long i = 0; i < out_len; i++) result[i] = (float)acc[i];
  *out = result;
  *out_n = out_len;
  return 0;
}

}  // extern "C"
