// Native audio decode for the data loader.
//
// The reference leans on torchaudio/sox C++ for file decode and rate
// conversion (voice100/data_modules.py:288,303-314). This library is the
// framework's native equivalent: a self-contained FLAC decoder (the
// corpora this framework targets — LJSpeech/LibriSpeech/Kokoro — ship
// FLAC), a PCM WAV reader, and a windowed-sinc polyphase resampler.
// Exposed as a C ABI consumed via ctypes (no pybind11 in this image).
//
// FLAC support: 8/16/24-bit, all channel assignments (independent,
// left/side, right/side, mid/side), constant/verbatim/fixed/LPC
// subframes, 4-bit and 5-bit Rice partitions with escape codes, wasted
// bits. CRCs are parsed but not verified (decode speed; corrupt corpora
// surface as garbled audio, same as sox).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <atomic>
#include <string>
#include <thread>
#include <vector>

#include <dlfcn.h>

namespace {

struct BitReader {
  const uint8_t* data;
  size_t size;
  size_t byte_pos = 0;
  int bit_pos = 0;  // 0..7, MSB first
  bool error = false;

  BitReader(const uint8_t* d, size_t n) : data(d), size(n) {}

  bool aligned() const { return bit_pos == 0; }

  void align() {
    if (bit_pos != 0) {
      bit_pos = 0;
      byte_pos++;
    }
  }

  uint64_t read_bits(int n) {
    uint64_t v = 0;
    while (n > 0) {
      if (byte_pos >= size) {
        error = true;
        return 0;
      }
      int avail = 8 - bit_pos;
      int take = n < avail ? n : avail;
      int shift = avail - take;
      uint32_t chunk = (data[byte_pos] >> shift) & ((1u << take) - 1);
      v = (v << take) | chunk;
      bit_pos += take;
      if (bit_pos == 8) {
        bit_pos = 0;
        byte_pos++;
      }
      n -= take;
    }
    return v;
  }

  int64_t read_signed(int n) {
    uint64_t v = read_bits(n);
    if (n == 0) return 0;
    uint64_t sign = 1ull << (n - 1);
    return (v & sign) ? (int64_t)(v - (sign << 1)) : (int64_t)v;
  }

  uint32_t read_unary() {
    uint32_t q = 0;
    while (!error && read_bits(1) == 0) {
      q++;
      if (q > 1u << 24) {  // corrupt stream guard
        error = true;
        return 0;
      }
    }
    return q;
  }

  int64_t read_rice(int k) {
    uint32_t q = read_unary();
    uint64_t r = k > 0 ? read_bits(k) : 0;
    uint64_t u = ((uint64_t)q << k) | r;
    return (u & 1) ? -(int64_t)(u >> 1) - 1 : (int64_t)(u >> 1);
  }

  // UTF-8-style coded number used for frame/sample index
  uint64_t read_utf8() {
    uint64_t b0 = read_bits(8);
    if (b0 < 0x80) return b0;
    int n = 0;
    for (uint64_t mask = 0x40; b0 & mask; mask >>= 1) n++;
    uint64_t v = b0 & (0x3Full >> n);
    for (int i = 0; i < n; i++) {
      v = (v << 6) | (read_bits(8) & 0x3F);
    }
    return v;
  }
};

struct StreamInfo {
  uint32_t sample_rate = 0;
  int channels = 0;
  int bits_per_sample = 0;
  uint64_t total_samples = 0;
};

const int kBlockSizes[16] = {0,    192,   576,   1152,  2304, 4608,
                             -1,   -2,    256,   512,   1024, 2048,
                             4096, 8192,  16384, 32768};
const int kSampleRates[16] = {0,     88200, 176400, 192000, 8000,  16000,
                              22050, 24000, 32000,  44100,  48000, 96000,
                              -1,    -2,    -3,     0};

bool decode_residual(BitReader& br, int order, int block_size,
                     std::vector<int64_t>& out) {
  int method = (int)br.read_bits(2);
  if (method > 1) return false;
  int k_bits = method == 0 ? 4 : 5;
  int escape = method == 0 ? 0xF : 0x1F;
  int part_order = (int)br.read_bits(4);
  int partitions = 1 << part_order;
  int samples_per_part = block_size >> part_order;
  if (samples_per_part <= 0) return false;
  int idx = order;
  for (int p = 0; p < partitions; p++) {
    int count = samples_per_part - (p == 0 ? order : 0);
    if (count < 0) return false;
    int k = (int)br.read_bits(k_bits);
    if (k == escape) {
      int raw_bits = (int)br.read_bits(5);
      for (int i = 0; i < count; i++)
        out[idx++] = raw_bits ? br.read_signed(raw_bits) : 0;
    } else {
      for (int i = 0; i < count; i++) out[idx++] = br.read_rice(k);
    }
    if (br.error) return false;
  }
  return idx == block_size;
}

bool decode_subframe(BitReader& br, int block_size, int bps,
                     std::vector<int64_t>& out) {
  if (br.read_bits(1) != 0) return false;  // padding bit
  int type = (int)br.read_bits(6);
  int wasted = 0;
  if (br.read_bits(1)) {  // wasted bits flag: unary count - 1
    wasted = 1 + (int)br.read_unary();
  }
  bps -= wasted;
  out.assign(block_size, 0);

  if (type == 0) {  // constant
    int64_t v = br.read_signed(bps);
    for (int i = 0; i < block_size; i++) out[i] = v;
  } else if (type == 1) {  // verbatim
    for (int i = 0; i < block_size; i++) out[i] = br.read_signed(bps);
  } else if (type >= 8 && type <= 12) {  // fixed, order 0..4
    int order = type - 8;
    for (int i = 0; i < order; i++) out[i] = br.read_signed(bps);
    if (!decode_residual(br, order, block_size, out)) return false;
    // fixed predictors (FLAC spec)
    for (int i = order; i < block_size; i++) {
      switch (order) {
        case 0: break;
        case 1: out[i] += out[i - 1]; break;
        case 2: out[i] += 2 * out[i - 1] - out[i - 2]; break;
        case 3:
          out[i] += 3 * out[i - 1] - 3 * out[i - 2] + out[i - 3];
          break;
        case 4:
          out[i] += 4 * out[i - 1] - 6 * out[i - 2] + 4 * out[i - 3] -
                    out[i - 4];
          break;
      }
    }
  } else if (type >= 32) {  // LPC, order 1..32
    int order = type - 31;
    for (int i = 0; i < order; i++) out[i] = br.read_signed(bps);
    int precision = (int)br.read_bits(4) + 1;
    if (precision == 16) return false;  // invalid per spec
    int shift = (int)br.read_signed(5);
    std::vector<int64_t> coef(order);
    for (int i = 0; i < order; i++) coef[i] = br.read_signed(precision);
    if (!decode_residual(br, order, block_size, out)) return false;
    for (int i = order; i < block_size; i++) {
      int64_t acc = 0;
      for (int j = 0; j < order; j++) acc += coef[j] * out[i - 1 - j];
      out[i] += acc >> shift;
    }
  } else {
    return false;
  }
  if (wasted) {
    for (int i = 0; i < block_size; i++) out[i] <<= wasted;
  }
  return !br.error;
}

}  // namespace

extern "C" {

// Decode a FLAC file. Returns 0 on success; caller frees *out with
// v100_free. Output is interleaved-free: planar [channels][samples].
int v100_read_flac(const char* path, float** out, int* out_channels,
                   long* out_samples, int* out_rate) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  fseek(f, 0, SEEK_END);
  long fsize = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(fsize);
  if (fread(buf.data(), 1, fsize, f) != (size_t)fsize) {
    fclose(f);
    return 2;
  }
  fclose(f);
  if (fsize < 42 || memcmp(buf.data(), "fLaC", 4) != 0) return 3;

  BitReader br(buf.data() + 4, fsize - 4);
  StreamInfo info;
  bool last = false;
  while (!last && !br.error) {
    last = br.read_bits(1);
    int type = (int)br.read_bits(7);
    uint32_t len = (uint32_t)br.read_bits(24);
    if (type == 0) {  // STREAMINFO
      br.read_bits(16);  // min block
      br.read_bits(16);  // max block
      br.read_bits(24);  // min frame
      br.read_bits(24);  // max frame
      info.sample_rate = (uint32_t)br.read_bits(20);
      info.channels = (int)br.read_bits(3) + 1;
      info.bits_per_sample = (int)br.read_bits(5) + 1;
      info.total_samples = br.read_bits(36);
      br.read_bits(64);  // md5 lo
      br.read_bits(64);  // md5 hi
    } else {
      for (uint32_t i = 0; i < len; i++) br.read_bits(8);
    }
  }
  if (br.error || info.channels == 0 || info.sample_rate == 0) return 4;

  int ch = info.channels;
  std::vector<std::vector<float>> channels(ch);
  std::vector<std::vector<int64_t>> sub(ch);

  while (!br.error && br.byte_pos < br.size - 2) {
    // frame header
    uint32_t sync = (uint32_t)br.read_bits(14);
    if (br.error) break;
    if (sync != 0x3FFE) return 5;
    br.read_bits(1);  // reserved
    br.read_bits(1);  // blocking strategy
    int bs_code = (int)br.read_bits(4);
    int sr_code = (int)br.read_bits(4);
    int ch_asgn = (int)br.read_bits(4);
    int ss_code = (int)br.read_bits(3);
    br.read_bits(1);  // reserved
    br.read_utf8();   // frame/sample number

    int block_size = kBlockSizes[bs_code];
    if (block_size == -1) block_size = (int)br.read_bits(8) + 1;
    else if (block_size == -2) block_size = (int)br.read_bits(16) + 1;
    if (block_size <= 0) return 6;

    int sr = kSampleRates[sr_code];
    if (sr == -1) br.read_bits(8);
    else if (sr == -2) br.read_bits(16);
    else if (sr == -3) br.read_bits(16);

    int bps = info.bits_per_sample;
    switch (ss_code) {
      case 1: bps = 8; break;
      case 2: bps = 12; break;
      case 4: bps = 16; break;
      case 5: bps = 20; break;
      case 6: bps = 24; break;
      case 7: bps = 32; break;
      default: break;  // 0: from STREAMINFO
    }
    br.read_bits(8);  // CRC-8 (unverified)

    int n_sub = ch_asgn < 8 ? ch_asgn + 1 : 2;
    if (n_sub != ch) return 7;
    for (int c = 0; c < ch; c++) {
      int sub_bps = bps;
      // side channels carry one extra bit
      if ((ch_asgn == 8 && c == 1) || (ch_asgn == 9 && c == 0) ||
          (ch_asgn == 10 && c == 1))
        sub_bps += 1;
      if (!decode_subframe(br, block_size, sub_bps, sub[c])) return 8;
    }
    br.align();
    br.read_bits(16);  // CRC-16 (unverified)

    // inter-channel reconstruction
    if (ch_asgn == 8) {  // left/side
      for (int i = 0; i < block_size; i++) sub[1][i] = sub[0][i] - sub[1][i];
    } else if (ch_asgn == 9) {  // right/side: side, right
      for (int i = 0; i < block_size; i++) sub[0][i] = sub[0][i] + sub[1][i];
    } else if (ch_asgn == 10) {  // mid/side
      for (int i = 0; i < block_size; i++) {
        int64_t mid = sub[0][i];
        int64_t side = sub[1][i];
        mid = (mid << 1) | (side & 1);
        sub[0][i] = (mid + side) >> 1;
        sub[1][i] = (mid - side) >> 1;
      }
    }

    float scale = 1.0f / (float)(1ll << (info.bits_per_sample - 1));
    for (int c = 0; c < ch; c++)
      for (int i = 0; i < block_size; i++)
        channels[c].push_back((float)sub[c][i] * scale);

    if (info.total_samples &&
        channels[0].size() >= info.total_samples)
      break;
  }

  long n = (long)channels[0].size();
  if (info.total_samples && (long)info.total_samples < n)
    n = (long)info.total_samples;
  float* result = (float*)malloc(sizeof(float) * ch * n);
  if (!result) return 9;
  for (int c = 0; c < ch; c++)
    memcpy(result + c * n, channels[c].data(), sizeof(float) * n);
  *out = result;
  *out_channels = ch;
  *out_samples = n;
  *out_rate = (int)info.sample_rate;
  return 0;
}

// Windowed-sinc polyphase resampler (Hann window, 6 zero crossings,
// rolloff 0.99) — same algorithm family as dsp/resample.py.
int v100_resample(const float* in, long n, int from_rate, int to_rate,
                  float** out, long* out_n) {
  if (from_rate == to_rate) {
    float* res = (float*)malloc(sizeof(float) * n);
    memcpy(res, in, sizeof(float) * n);
    *out = res;
    *out_n = n;
    return 0;
  }
  // reduce by gcd
  long a = from_rate, b = to_rate;
  while (b) {
    long t = a % b;
    a = b;
    b = t;
  }
  long g = a;
  long orig = from_rate / g, target = to_rate / g;
  const int width_zc = 6;
  const double rolloff = 0.99;
  double base = (orig < target ? orig : target) * rolloff;
  int width = (int)((width_zc * orig) / base) + 1;
  long total = (long)((n * target + orig - 1) / orig);
  float* res = (float*)calloc(total, sizeof(float));
  if (!res) return 1;
  for (long i = 0; i < total; i++) {
    double acc = 0.0;
    // output time in input samples: (i * orig) / target
    double t_in = (double)i * orig / target;
    long center = (long)t_in;
    for (long j = center - width; j <= center + width; j++) {
      if (j < 0 || j >= n) continue;
      double x = ((double)j - t_in) * base / orig;
      if (x < -width_zc || x > width_zc) continue;
      const double kPi = 3.14159265358979323846;
      double window = 0.5 * (1.0 + std::cos(kPi * x / width_zc));
      double sinc = x == 0.0 ? 1.0 : std::sin(kPi * x) / (kPi * x);
      acc += in[j] * sinc * window;
    }
    res[i] = (float)(acc * base / orig);
  }
  *out = res;
  *out_n = total;
  return 0;
}

void v100_free(float* p) { free(p); }

}  // extern "C"

// ---------------------------------------------------------------------------
// MP3 decode via the system MPEG audio decoder (libmpg123), loaded with
// dlopen so this library builds and loads even where it is absent. The
// reference plays CommonVoice mp3 clips through torchaudio's sox backend
// (voice100/data_modules.py:303-314); this is the framework's native
// equivalent for the cv_ja corpus. Only the handful of entry points we
// use are declared (the mpg123 C ABI is stable and documented).

namespace {

typedef void mpg123_handle;

struct Mpg123Api {
  void* dso = nullptr;
  int (*init)() = nullptr;  // optional (no-op in modern versions)
  mpg123_handle* (*make)(const char*, int*) = nullptr;
  int (*param)(mpg123_handle*, int, long, double) = nullptr;
  int (*open)(mpg123_handle*, const char*) = nullptr;
  int (*getformat)(mpg123_handle*, long*, int*, int*) = nullptr;
  int (*format_none)(mpg123_handle*) = nullptr;
  int (*format)(mpg123_handle*, long, int, int) = nullptr;
  int (*read)(mpg123_handle*, unsigned char*, size_t, size_t*) = nullptr;
  int (*close)(mpg123_handle*) = nullptr;
  void (*destroy)(mpg123_handle*) = nullptr;
  bool ok = false;
};

// mpg123 public constants (mpg123.h)
const int kMpg123Ok = 0;
const int kMpg123Done = -12;
const int kMpg123NewFormat = -11;
const int kMpg123Flags = 1;            // enum mpg123_parms: MPG123_FLAGS
const long kMpg123Quiet = 0x20;        // MPG123_QUIET
const long kMpg123ForceFloat = 0x400;  // MPG123_FORCE_FLOAT
const int kMpg123EncFloat32 = 0x200;   // MPG123_ENC_FLOAT_32

Mpg123Api& mpg123_api() {
  static Mpg123Api api = [] {
    Mpg123Api a;
    const char* names[] = {"libmpg123.so.0", "libmpg123.so"};
    for (const char* name : names) {
      a.dso = dlopen(name, RTLD_NOW | RTLD_LOCAL);
      if (a.dso) break;
    }
    if (!a.dso) return a;
    a.init = (int (*)())dlsym(a.dso, "mpg123_init");
    a.make =
        (mpg123_handle * (*)(const char*, int*)) dlsym(a.dso, "mpg123_new");
    a.param = (int (*)(mpg123_handle*, int, long, double))dlsym(
        a.dso, "mpg123_param");
    a.open = (int (*)(mpg123_handle*, const char*))dlsym(a.dso,
                                                         "mpg123_open");
    a.getformat = (int (*)(mpg123_handle*, long*, int*, int*))dlsym(
        a.dso, "mpg123_getformat");
    a.format_none =
        (int (*)(mpg123_handle*))dlsym(a.dso, "mpg123_format_none");
    a.format = (int (*)(mpg123_handle*, long, int, int))dlsym(
        a.dso, "mpg123_format");
    a.read = (int (*)(mpg123_handle*, unsigned char*, size_t,
                      size_t*))dlsym(a.dso, "mpg123_read");
    a.close = (int (*)(mpg123_handle*))dlsym(a.dso, "mpg123_close");
    a.destroy = (void (*)(mpg123_handle*))dlsym(a.dso, "mpg123_delete");
    a.ok = a.make && a.param && a.open && a.getformat && a.format_none &&
           a.format && a.read && a.close && a.destroy;
    if (a.ok && a.init) a.init();
    return a;
  }();
  return api;
}

}  // namespace

extern "C" {

// 1 if mp3 decoding is available on this system.
int v100_mp3_available() { return mpg123_api().ok ? 1 : 0; }

// Decode an MP3 file to planar float [channels][samples].
// Returns 0 on success; caller frees *out with v100_free.
int v100_read_mp3(const char* path, float** out, int* out_channels,
                  long* out_samples, int* out_rate) {
  Mpg123Api& api = mpg123_api();
  if (!api.ok) return 100;  // decoder library unavailable
  int err = 0;
  mpg123_handle* h = api.make(nullptr, &err);
  if (!h) return 101;
  api.param(h, kMpg123Flags, kMpg123Quiet | kMpg123ForceFloat, 0.0);
  if (api.open(h, path) != kMpg123Ok) {
    api.destroy(h);
    return 102;
  }
  long rate = 0;
  int channels = 0, encoding = 0;
  if (api.getformat(h, &rate, &channels, &encoding) != kMpg123Ok ||
      channels <= 0 || rate <= 0) {
    api.close(h);
    api.destroy(h);
    return 103;
  }
  // Lock the output format to float32 at the stream's native layout so
  // mid-stream format changes surface as errors instead of surprises.
  api.format_none(h);
  if (api.format(h, rate, channels, kMpg123EncFloat32) != kMpg123Ok) {
    api.close(h);
    api.destroy(h);
    return 104;
  }

  std::vector<float> interleaved;
  std::vector<unsigned char> buf(1 << 16);
  for (;;) {
    size_t done = 0;
    int rc = api.read(h, buf.data(), buf.size(), &done);
    if (done > 0) {
      const float* f = (const float*)buf.data();
      interleaved.insert(interleaved.end(), f, f + done / sizeof(float));
    }
    if (rc == kMpg123Done) break;
    if (rc == kMpg123NewFormat) continue;  // format locked above
    if (rc != kMpg123Ok) {
      api.close(h);
      api.destroy(h);
      return 105;
    }
  }
  api.close(h);
  api.destroy(h);

  long n = (long)(interleaved.size() / channels);
  if (n <= 0) return 106;
  float* result = (float*)malloc(sizeof(float) * channels * n);
  if (!result) return 107;
  for (int c = 0; c < channels; c++)
    for (long i = 0; i < n; i++)
      result[c * n + i] = interleaved[i * channels + c];
  *out = result;
  *out_channels = channels;
  *out_samples = n;
  *out_rate = (int)rate;
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Batch decode executor: the native equivalent of torch DataLoader's
// multi-worker decode (reference voice100/data_modules.py:628-666 runs
// torchaudio/sox decode in worker processes). One ctypes call decodes a
// whole batch of files on a std::thread pool (the GIL is released for
// the duration of the call), each mixed down to the first channel and
// resampled to the target rate — the same policy as dsp/audioio.py.

namespace {

// RIFF/WAVE PCM + float reader matching dsp/wav.py semantics
// (PCM 8/16/24/32 and float32/64; returns planar [ch][n] float32).
int read_wav_file(const char* path, float** out, int* out_channels,
                  long* out_samples, int* out_rate) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  fseek(f, 0, SEEK_END);
  long fsize = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> data(fsize);
  if (fread(data.data(), 1, fsize, f) != (size_t)fsize) {
    fclose(f);
    return 2;
  }
  fclose(f);
  if (fsize < 44 || memcmp(data.data(), "RIFF", 4) != 0 ||
      memcmp(data.data() + 8, "WAVE", 4) != 0)
    return 3;
  long pos = 12;
  int audio_format = 0, channels = 0, bits = 0, rate = 0;
  const uint8_t* raw = nullptr;
  size_t raw_size = 0;
  while (pos + 8 <= fsize) {
    uint32_t size;
    memcpy(&size, data.data() + pos + 4, 4);
    const uint8_t* body = data.data() + pos + 8;
    if (memcmp(data.data() + pos, "fmt ", 4) == 0 && size >= 16 &&
        pos + 8 + 16 <= fsize) {
      uint16_t fmt16, ch16, block16, bits16;
      uint32_t rate32, byterate32;
      memcpy(&fmt16, body, 2);
      memcpy(&ch16, body + 2, 2);
      memcpy(&rate32, body + 4, 4);
      memcpy(&byterate32, body + 8, 4);
      memcpy(&block16, body + 12, 2);
      memcpy(&bits16, body + 14, 2);
      audio_format = fmt16;
      channels = ch16;
      rate = (int)rate32;
      bits = bits16;
      if (audio_format == 0xFFFE) audio_format = 1;  // extensible -> PCM
    } else if (memcmp(data.data() + pos, "data", 4) == 0) {
      raw = body;
      raw_size = size;
      if (pos + 8 + (long)size > fsize) raw_size = fsize - pos - 8;
    }
    pos += 8 + size + (size & 1);
  }
  if (!raw || channels <= 0 || rate <= 0) return 4;

  long frames;
  std::vector<float> interleaved;
  if (audio_format == 3 && bits == 32) {
    frames = (long)(raw_size / 4 / channels);
    interleaved.assign((const float*)raw,
                       (const float*)raw + frames * channels);
  } else if (audio_format == 3 && bits == 64) {
    frames = (long)(raw_size / 8 / channels);
    const double* d = (const double*)raw;
    interleaved.resize(frames * channels);
    for (long i = 0; i < frames * channels; i++)
      interleaved[i] = (float)d[i];
  } else if (audio_format == 1 && bits == 16) {
    frames = (long)(raw_size / 2 / channels);
    const int16_t* d = (const int16_t*)raw;
    interleaved.resize(frames * channels);
    for (long i = 0; i < frames * channels; i++)
      interleaved[i] = d[i] / 32768.0f;
  } else if (audio_format == 1 && bits == 32) {
    frames = (long)(raw_size / 4 / channels);
    const int32_t* d = (const int32_t*)raw;
    interleaved.resize(frames * channels);
    for (long i = 0; i < frames * channels; i++)
      interleaved[i] = (float)(d[i] / 2147483648.0);
  } else if (audio_format == 1 && bits == 8) {
    frames = (long)(raw_size / channels);
    interleaved.resize(frames * channels);
    for (long i = 0; i < frames * channels; i++)
      interleaved[i] = (raw[i] - 128.0f) / 128.0f;
  } else if (audio_format == 1 && bits == 24) {
    frames = (long)(raw_size / 3 / channels);
    interleaved.resize(frames * channels);
    for (long i = 0; i < frames * channels; i++) {
      int32_t v = raw[3 * i] | (raw[3 * i + 1] << 8) |
                  (raw[3 * i + 2] << 16);
      if (v >= (1 << 23)) v -= (1 << 24);
      interleaved[i] = v / (float)(1 << 23);
    }
  } else {
    return 5;
  }

  float* result = (float*)malloc(sizeof(float) * channels * frames);
  if (!result) return 6;
  for (int c = 0; c < channels; c++)
    for (long i = 0; i < frames; i++)
      result[c * frames + i] = interleaved[i * channels + c];
  *out = result;
  *out_channels = channels;
  *out_samples = frames;
  *out_rate = rate;
  return 0;
}

bool ends_with(const std::string& s, const char* suffix) {
  size_t n = strlen(suffix);
  if (s.size() < n) return false;
  for (size_t i = 0; i < n; i++) {
    char a = s[s.size() - n + i];
    if (a >= 'A' && a <= 'Z') a += 'a' - 'A';
    if (a != suffix[i]) return false;
  }
  return true;
}

}  // namespace

extern "C" {

int v100_read_flac(const char*, float**, int*, long*, int*);
int v100_read_mp3(const char*, float**, int*, long*, int*);
int v100_resample(const float*, long, int, int, float**, long*);

// Decode any supported file -> planar float [channels][samples].
int v100_read_audio(const char* path, float** out, int* out_channels,
                    long* out_samples, int* out_rate) {
  std::string p(path);
  if (ends_with(p, ".wav"))
    return read_wav_file(path, out, out_channels, out_samples, out_rate);
  if (ends_with(p, ".flac"))
    return v100_read_flac(path, out, out_channels, out_samples, out_rate);
  if (ends_with(p, ".mp3"))
    return v100_read_mp3(path, out, out_channels, out_samples, out_rate);
  return 200;  // unsupported extension
}

// Decode a batch of files on a thread pool: first channel, resampled
// to target_rate. outputs[i] receives a malloc'd float buffer (caller
// frees each with v100_free), out_lens[i] its length; rc[i] per-file
// status (0 = ok). Returns the number of failures.
int v100_read_audio_batch(const char** paths, int n, int target_rate,
                          int n_threads, float** outputs, long* out_lens,
                          int* rcs) {
  if (n_threads <= 0) {
    n_threads = (int)std::thread::hardware_concurrency();
    if (n_threads <= 0) n_threads = 4;
  }
  if (n_threads > n) n_threads = n;
  std::atomic<int> next(0), failures(0);

  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      float* planar = nullptr;
      int channels = 0, rate = 0;
      long samples = 0;
      int rc = v100_read_audio(paths[i], &planar, &channels, &samples,
                               &rate);
      if (rc != 0) {
        rcs[i] = rc;
        outputs[i] = nullptr;
        out_lens[i] = 0;
        failures.fetch_add(1);
        continue;
      }
      // first channel (sox remix 1 policy, dsp/audioio.py)
      float* mono = planar;
      if (rate != target_rate) {
        float* resampled = nullptr;
        long out_n = 0;
        rc = v100_resample(mono, samples, rate, target_rate, &resampled,
                           &out_n);
        free(planar);
        if (rc != 0) {
          rcs[i] = 300 + rc;
          outputs[i] = nullptr;
          out_lens[i] = 0;
          failures.fetch_add(1);
          continue;
        }
        outputs[i] = resampled;
        out_lens[i] = out_n;
      } else if (channels > 1) {
        float* copy = (float*)malloc(sizeof(float) * samples);
        memcpy(copy, mono, sizeof(float) * samples);
        free(planar);
        outputs[i] = copy;
        out_lens[i] = samples;
      } else {
        outputs[i] = planar;
        out_lens[i] = samples;
      }
      rcs[i] = 0;
    }
  };

  std::vector<std::thread> pool;
  for (int t = 0; t < n_threads; t++) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return failures.load();
}

}  // extern "C"
