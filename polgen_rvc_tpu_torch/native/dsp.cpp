// Host-side streaming effects engine (pedalboard-equivalent capability).
//
// Implements the reference mixdown chain (audio_processing.py:76-103):
//   HighpassFilter -> Compressor -> NoiseGate -> Reverb (freeverb) ->
//   LowShelfFilter -> HighShelfFilter -> Chorus
// as stateful stereo processors so audio can stream through in chunks with
// state carried across calls (reset=False semantics, audio_processing.py:105-109).
//
// The PyTorch port's copy of polgen_rvc_tpu/native/dsp.cpp, code unchanged,
// so that both packages give the same bits. polgen_rvc_tpu_torch.native
// builds it at first use (g++ -O2 -shared -fPIC -std=c++17) into
// build/native/ and binds its C ABI through ctypes. The port's high-pass
// stays on scipy (ops/filters.py): the filtfilt entry points below are
// built but not called.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr float kPi = 3.14159265358979323846f;

// ---------------------------------------------------------------------------
// biquad (RBJ cookbook forms)
// ---------------------------------------------------------------------------

struct Biquad {
  double b0 = 1, b1 = 0, b2 = 0, a1 = 0, a2 = 0;
  double z1[2] = {0, 0}, z2[2] = {0, 0};

  void highpass(double fs, double fc, double q) {
    double w = 2 * kPi * fc / fs, cw = std::cos(w), sw = std::sin(w);
    double alpha = sw / (2 * q);
    double a0 = 1 + alpha;
    b0 = (1 + cw) / 2 / a0;
    b1 = -(1 + cw) / a0;
    b2 = (1 + cw) / 2 / a0;
    a1 = (-2 * cw) / a0;
    a2 = (1 - alpha) / a0;
  }

  void shelf(double fs, double fc, double gain_db, double q, bool high) {
    double A = std::pow(10.0, gain_db / 40.0);
    double w = 2 * kPi * fc / fs, cw = std::cos(w), sw = std::sin(w);
    double alpha = sw / (2 * q);
    double two_sqrtA_alpha = 2 * std::sqrt(A) * alpha;
    double a0;
    if (!high) {  // low shelf
      a0 = (A + 1) + (A - 1) * cw + two_sqrtA_alpha;
      b0 = A * ((A + 1) - (A - 1) * cw + two_sqrtA_alpha) / a0;
      b1 = 2 * A * ((A - 1) - (A + 1) * cw) / a0;
      b2 = A * ((A + 1) - (A - 1) * cw - two_sqrtA_alpha) / a0;
      a1 = -2 * ((A - 1) + (A + 1) * cw) / a0;
      a2 = ((A + 1) + (A - 1) * cw - two_sqrtA_alpha) / a0;
    } else {  // high shelf
      a0 = (A + 1) - (A - 1) * cw + two_sqrtA_alpha;
      b0 = A * ((A + 1) + (A - 1) * cw + two_sqrtA_alpha) / a0;
      b1 = -2 * A * ((A - 1) + (A + 1) * cw) / a0;
      b2 = A * ((A + 1) + (A - 1) * cw - two_sqrtA_alpha) / a0;
      a1 = 2 * ((A - 1) - (A + 1) * cw) / a0;
      a2 = ((A + 1) - (A - 1) * cw - two_sqrtA_alpha) / a0;
    }
  }

  inline float tick(int ch, float x) {
    // transposed direct form II
    double y = b0 * x + z1[ch];
    z1[ch] = b1 * x - a1 * y + z2[ch];
    z2[ch] = b2 * x - a2 * y;
    return static_cast<float>(y);
  }

  void process(float* L, float* R, int64_t n) {
    for (int64_t i = 0; i < n; i++) {
      L[i] = tick(0, L[i]);
      R[i] = tick(1, R[i]);
    }
  }
};

// ---------------------------------------------------------------------------
// envelope-follower dynamics (compressor / noise gate)
// ---------------------------------------------------------------------------

struct Dynamics {
  double threshold_db, ratio, attack_coeff, release_coeff;
  double env_db = -120.0;  // smoothed level estimate
  bool gate;               // gate mode: attenuate BELOW threshold

  void init(double fs, double thr_db, double r, double attack_ms,
            double release_ms, bool is_gate) {
    threshold_db = thr_db;
    ratio = r < 1.0 ? 1.0 : r;
    attack_coeff = std::exp(-1.0 / (fs * attack_ms * 1e-3 + 1e-9));
    release_coeff = std::exp(-1.0 / (fs * release_ms * 1e-3 + 1e-9));
    gate = is_gate;
  }

  void process(float* L, float* R, int64_t n) {
    for (int64_t i = 0; i < n; i++) {
      double level = std::fmax(std::fabs(L[i]), std::fabs(R[i]));
      double level_db = 20.0 * std::log10(level + 1e-9);
      double coeff = level_db > env_db ? attack_coeff : release_coeff;
      env_db = coeff * env_db + (1.0 - coeff) * level_db;
      double gain_db = 0.0;
      if (!gate) {
        if (env_db > threshold_db)
          gain_db = (threshold_db - env_db) * (1.0 - 1.0 / ratio);
      } else {
        if (env_db < threshold_db)
          gain_db = (env_db - threshold_db) * (ratio - 1.0);
        if (gain_db < -80.0) gain_db = -80.0;
      }
      float g = static_cast<float>(std::pow(10.0, gain_db / 20.0));
      L[i] *= g;
      R[i] *= g;
    }
  }
};

// ---------------------------------------------------------------------------
// freeverb (Schroeder/Moorer: 8 lowpass-feedback combs + 4 allpasses / ch)
// ---------------------------------------------------------------------------

struct Comb {
  std::vector<float> buf;
  size_t idx = 0;
  float feedback = 0, damp = 0, filterstore = 0;

  void init(int size) { buf.assign(size, 0.0f); idx = 0; filterstore = 0; }
  inline float tick(float input) {
    float out = buf[idx];
    filterstore = out * (1 - damp) + filterstore * damp;
    buf[idx] = input + filterstore * feedback;
    if (++idx >= buf.size()) idx = 0;
    return out;
  }
};

struct Allpass {
  std::vector<float> buf;
  size_t idx = 0;
  float feedback = 0.5f;

  void init(int size) { buf.assign(size, 0.0f); idx = 0; }
  inline float tick(float input) {
    float bufout = buf[idx];
    float out = -input + bufout;
    buf[idx] = input + bufout * feedback;
    if (++idx >= buf.size()) idx = 0;
    return out;
  }
};

struct Freeverb {
  static constexpr int kNumCombs = 8;
  static constexpr int kNumAllpasses = 4;
  static constexpr int kStereoSpread = 23;
  Comb combL[kNumCombs], combR[kNumCombs];
  Allpass apL[kNumAllpasses], apR[kNumAllpasses];
  float wet1 = 0, wet2 = 0, dry = 0, gain = 0.015f;

  void init(double fs, float room_size, float damping, float wet_level,
            float dry_level, float width) {
    static const int comb_sizes[kNumCombs] = {1116, 1188, 1277, 1356,
                                              1422, 1491, 1557, 1617};
    static const int ap_sizes[kNumAllpasses] = {556, 441, 341, 225};
    double scale = fs / 44100.0;  // tunings are for 44.1k
    for (int i = 0; i < kNumCombs; i++) {
      combL[i].init(std::max(1, (int)std::lround(comb_sizes[i] * scale)));
      combR[i].init(std::max(1, (int)std::lround((comb_sizes[i] + kStereoSpread) * scale)));
      combL[i].feedback = combR[i].feedback = room_size * 0.28f + 0.7f;
      combL[i].damp = combR[i].damp = damping * 0.4f;
    }
    for (int i = 0; i < kNumAllpasses; i++) {
      apL[i].init(std::max(1, (int)std::lround(ap_sizes[i] * scale)));
      apR[i].init(std::max(1, (int)std::lround((ap_sizes[i] + kStereoSpread) * scale)));
    }
    float wet = wet_level * 3.0f;
    wet1 = wet * (width / 2.0f + 0.5f);
    wet2 = wet * ((1.0f - width) / 2.0f);
    dry = dry_level * 2.0f;
  }

  void process(float* L, float* R, int64_t n) {
    for (int64_t i = 0; i < n; i++) {
      float input = (L[i] + R[i]) * gain;
      float outL = 0, outR = 0;
      for (int c = 0; c < kNumCombs; c++) {
        outL += combL[c].tick(input);
        outR += combR[c].tick(input);
      }
      for (int a = 0; a < kNumAllpasses; a++) {
        outL = apL[a].tick(outL);
        outR = apR[a].tick(outR);
      }
      float l = outL * wet1 + outR * wet2 + L[i] * dry;
      float r = outR * wet1 + outL * wet2 + R[i] * dry;
      L[i] = l;
      R[i] = r;
    }
  }
};

// ---------------------------------------------------------------------------
// chorus: LFO-modulated fractional delay with feedback
// ---------------------------------------------------------------------------

struct Chorus {
  std::vector<float> bufL, bufR;
  size_t idx = 0;
  double fs = 48000, phase = 0;
  float rate_hz = 1, depth = 0.25f, centre_delay_ms = 7, feedback = 0, mix = 0.5f;

  void init(double sample_rate, float rate, float dep, float centre_ms,
            float fb, float m) {
    fs = sample_rate;
    rate_hz = rate;
    depth = dep;
    centre_delay_ms = centre_ms;
    feedback = fb;
    mix = m;
    // max delay: centre + modulation swing + headroom
    int max_delay = (int)(fs * (centre_ms * 2.0 + 5.0) * 1e-3) + 4;
    bufL.assign(max_delay, 0.0f);
    bufR.assign(max_delay, 0.0f);
    idx = 0;
    phase = 0;
  }

  inline float read(const std::vector<float>& buf, double delay_samps) {
    double pos = (double)idx - delay_samps;
    double size = (double)buf.size();
    while (pos < 0) pos += size;
    size_t i0 = (size_t)pos;
    double frac = pos - (double)i0;
    size_t i1 = (i0 + 1) % buf.size();
    return (float)(buf[i0] * (1.0 - frac) + buf[i1] * frac);
  }

  void process(float* L, float* R, int64_t n) {
    double centre = centre_delay_ms * 1e-3 * fs;
    double inc = 2 * kPi * rate_hz / fs;
    for (int64_t i = 0; i < n; i++) {
      double lfo = std::sin(phase);
      double lfoR = std::sin(phase + kPi / 2);  // quadrature for stereo
      phase += inc;
      if (phase > 2 * kPi) phase -= 2 * kPi;
      double dL = centre * (1.0 + depth * 0.5 * lfo);
      double dR = centre * (1.0 + depth * 0.5 * lfoR);
      float tapL = read(bufL, dL);
      float tapR = read(bufR, dR);
      bufL[idx] = L[i] + tapL * feedback;
      bufR[idx] = R[i] + tapR * feedback;
      if (++idx >= bufL.size()) idx = 0;
      L[i] = L[i] * (1 - mix) + tapL * mix;
      R[i] = R[i] * (1 - mix) + tapR * mix;
    }
  }
};

// ---------------------------------------------------------------------------
// the chain
// ---------------------------------------------------------------------------

struct EffectChain {
  Biquad highpass, low_shelf, high_shelf;
  Dynamics compressor, noise_gate;
  Freeverb reverb;
  Chorus chorus;
  bool use_reverb = true, use_chorus = true;
};

}  // namespace

extern "C" {

EffectChain* polgen_chain_create(
    double fs,
    // reverb
    float room_size, float wet, float dry, float damping, float width,
    // shelves
    float low_shelf_gain_db, float high_shelf_gain_db,
    // compressor
    float comp_ratio, float comp_threshold_db,
    // gate
    float gate_threshold_db, float gate_ratio, float gate_attack_ms,
    float gate_release_ms,
    // chorus
    float chorus_rate_hz, float chorus_depth, float chorus_centre_delay_ms,
    float chorus_feedback, float chorus_mix) {
  auto* c = new EffectChain();
  c->highpass.highpass(fs, 50.0, 0.70710678);  // pedalboard default cutoff
  c->low_shelf.shelf(fs, 440.0, low_shelf_gain_db, 0.70710678, false);
  c->high_shelf.shelf(fs, 440.0, high_shelf_gain_db, 0.70710678, true);
  c->compressor.init(fs, comp_threshold_db, comp_ratio, 1.0, 100.0, false);
  c->noise_gate.init(fs, gate_threshold_db, gate_ratio, gate_attack_ms,
                     gate_release_ms, true);
  c->reverb.init(fs, room_size, damping, wet, dry, width);
  c->chorus.init(fs, chorus_rate_hz, chorus_depth, chorus_centre_delay_ms,
                 chorus_feedback, chorus_mix);
  return c;
}

// in-place on planar stereo buffers; safe to call repeatedly (streaming)
void polgen_chain_process(EffectChain* c, float* L, float* R, int64_t n) {
  c->highpass.process(L, R, n);
  c->compressor.process(L, R, n);
  c->noise_gate.process(L, R, n);
  c->reverb.process(L, R, n);
  c->low_shelf.process(L, R, n);
  c->high_shelf.process(L, R, n);
  c->chorus.process(L, R, n);
}

void polgen_chain_destroy(EffectChain* c) { delete c; }

// ---------------------------------------------------------------------
// zero-phase IIR filtering: scipy.signal.filtfilt semantics
// (odd edge extension, lfilter_zi initial conditions, forward-backward
// direct-form-II-transposed in double). The engine's 48 Hz high-pass
// (reference pipeline.py:19-22, 329) runs here instead of scipy — the
// Python loop-free scipy path still costs ~60 ms on a 3-min song.
// ---------------------------------------------------------------------

static void polgen_lfilter(const double* b, const double* a, int order,
                           const double* x, int64_t n, const double* zi,
                           double* y) {
  double z[32];
  for (int i = 0; i < order; i++) z[i] = zi[i];
  for (int64_t i = 0; i < n; i++) {
    const double xi = x[i];
    const double yi = b[0] * xi + z[0];
    for (int j = 0; j < order - 1; j++)
      z[j] = b[j + 1] * xi + z[j + 1] - a[j + 1] * yi;
    z[order - 1] = b[order] * xi - a[order] * yi;
    y[i] = yi;
  }
}

// filtfilt core into caller-provided scratch; result (in original order)
// lands at ext[padlen .. padlen+n) REVERSED — see polgen_filtfilt.
static int filtfilt_core(const double* x, int64_t n, const double* b,
                         const double* a, int order, const double* zi_unit,
                         int64_t padlen, double* ext, double* y) {
  const int64_t m = n + 2 * padlen;
  // odd extension: 2*x[0] - x[padlen..1], x, 2*x[n-1] - x[n-2..n-1-padlen]
  for (int64_t i = 0; i < padlen; i++) ext[i] = 2.0 * x[0] - x[padlen - i];
  for (int64_t i = 0; i < n; i++) ext[padlen + i] = x[i];
  for (int64_t i = 0; i < padlen; i++)
    ext[padlen + n + i] = 2.0 * x[n - 1] - x[n - 2 - i];

  double zi[32];
  for (int i = 0; i < order; i++) zi[i] = zi_unit[i] * ext[0];
  polgen_lfilter(b, a, order, ext, m, zi, y);
  // reverse in place
  for (int64_t i = 0, j = m - 1; i < j; i++, j--) {
    const double t = y[i]; y[i] = y[j]; y[j] = t;
  }
  for (int i = 0; i < order; i++) zi[i] = zi_unit[i] * y[0];
  polgen_lfilter(b, a, order, y, m, zi, ext);  // reuse ext as output
  return 0;
}

// x: n samples; b, a: order+1 normalized (a[0]=1) coefficients;
// zi_unit: `order` steady-state values from scipy.signal.lfilter_zi;
// padlen: edge extension length (scipy default 3*(order+1)).
// Returns 0 on success, -1 if n <= padlen (caller falls back to scipy).
int polgen_filtfilt(const double* x, int64_t n, const double* b,
                    const double* a, int order, const double* zi_unit,
                    int64_t padlen, double* out) {
  if (n <= padlen || order >= 32) return -1;
  const int64_t m = n + 2 * padlen;
  double* ext = new double[m];
  double* y = new double[m];
  filtfilt_core(x, n, b, a, order, zi_unit, padlen, ext, y);
  for (int64_t i = 0; i < n; i++) out[i] = ext[m - 1 - padlen - i];
  delete[] ext;
  delete[] y;
  return 0;
}

// Fused conversion head: filtfilt -> float32 -> reflect pad by t_pad ->
// int16 quantize against the padded signal's own max, in one pass.
// out_f32:  n filtered float32 samples (chunk planning input)
// out_i16:  >= n + 2*t_pad int16 samples (tail left untouched — callers
//           pass a zeroed bucket-sized array)
// out_inv_scale: the dequantization factor (float32 of 1/scale)
// Mirrors exactly: filtfilt(...).astype(f32); np.pad(reflect, t_pad);
// np.round(padded * (32767/absmax)).astype(i16) with numpy's f32
// promotion and round-half-even. Returns 0, or -1 on fallback cases.
int polgen_filtfilt_pad_quant(const double* x, int64_t n, const double* b,
                              const double* a, int order,
                              const double* zi_unit, int64_t padlen,
                              int64_t t_pad, float* out_f32,
                              int16_t* out_i16, float* out_inv_scale) {
  if (n <= padlen || order >= 32 || t_pad >= n) return -1;
  const int64_t m = n + 2 * padlen;
  double* ext = new double[m];
  double* y = new double[m];
  filtfilt_core(x, n, b, a, order, zi_unit, padlen, ext, y);
  float amax = 0.0f;
  for (int64_t i = 0; i < n; i++) {
    const float v = (float)ext[m - 1 - padlen - i];
    out_f32[i] = v;
    const float av = v < 0 ? -v : v;
    if (av > amax) amax = av;
  }
  delete[] ext;
  delete[] y;
  // reflect padding repeats interior samples: absmax(padded) == absmax
  const double scale_d = amax > 0 ? 32767.0 / (double)amax : 1.0;
  const float scale = (float)scale_d;
  const int64_t total = n + 2 * t_pad;
  for (int64_t i = 0; i < total; i++) {
    const int64_t j = i - t_pad;
    const int64_t src = j < 0 ? -j : (j >= n ? 2 * n - 2 - j : j);
    out_i16[i] = (int16_t)rintf(out_f32[src] * scale);
  }
  *out_inv_scale = (float)(1.0 / scale_d);
  return 0;
}

}  // extern "C"
