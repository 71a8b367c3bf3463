// First-party FLAC codec (decode + encode), C ABI for ctypes.
//
// Replaces the libsndfile/ffmpeg dependency for .flac in/out (reference
// codec boundary: audio_processing.py:37-40 via pydub, my_utils.py via
// soundfile). Decoder covers the full streamable subset used by common
// encoders (constant/verbatim/fixed/LPC subframes, rice methods 0/1, all
// channel decorrelations, wasted bits). Encoder emits fixed-blocksize
// frames with fixed predictors (order 0-4) + single-partition rice — valid,
// lossless, moderately compressed.
//
// The PyTorch port's copy of polgen_rvc_tpu/native/flac_codec.cpp, code
// unchanged, so that both packages write the same bytes.
// polgen_rvc_tpu_torch.native builds it at first use (g++ -O2 -shared -fPIC
// -std=c++17) into build/native/; native/flac.py binds it.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// bit reader
// ---------------------------------------------------------------------------

struct BitReader {
  const uint8_t* data;
  size_t size;
  size_t byte_pos = 0;
  int bit_pos = 0;  // 0..7, MSB first
  bool error = false;

  uint64_t read_bits(int n) {
    uint64_t v = 0;
    while (n > 0) {
      if (byte_pos >= size) { error = true; return 0; }
      int avail = 8 - bit_pos;
      int take = n < avail ? n : avail;
      int shift = avail - take;
      uint8_t bits = (data[byte_pos] >> shift) & ((1u << take) - 1);
      v = (v << take) | bits;
      bit_pos += take;
      n -= take;
      if (bit_pos == 8) { bit_pos = 0; byte_pos++; }
    }
    return v;
  }

  int64_t read_signed(int n) {
    uint64_t v = read_bits(n);
    if (n > 0 && (v >> (n - 1)) & 1) return (int64_t)v - ((int64_t)1 << n);
    return (int64_t)v;
  }

  uint32_t read_unary() {
    uint32_t q = 0;
    while (!error && read_bits(1) == 0) q++;
    return q;
  }

  void align() { if (bit_pos) { bit_pos = 0; byte_pos++; } }
};

// rice: unary quotient + k-bit remainder, zigzag to signed
inline int64_t rice_decode(BitReader& br, int k) {
  uint32_t q = br.read_unary();
  uint64_t r = k ? br.read_bits(k) : 0;
  uint64_t u = ((uint64_t)q << k) | r;
  return (int64_t)(u >> 1) ^ -(int64_t)(u & 1);
}

// ---------------------------------------------------------------------------
// decoder
// ---------------------------------------------------------------------------

struct StreamInfo {
  uint32_t sample_rate = 0;
  int channels = 0, bits = 0;
  uint64_t total_samples = 0;
};

bool read_utf8_coded(BitReader& br, uint64_t* out) {
  uint32_t b0 = (uint32_t)br.read_bits(8);
  int extra;
  uint64_t v;
  if ((b0 & 0x80) == 0) { *out = b0; return true; }
  else if ((b0 & 0xE0) == 0xC0) { extra = 1; v = b0 & 0x1F; }
  else if ((b0 & 0xF0) == 0xE0) { extra = 2; v = b0 & 0x0F; }
  else if ((b0 & 0xF8) == 0xF0) { extra = 3; v = b0 & 0x07; }
  else if ((b0 & 0xFC) == 0xF8) { extra = 4; v = b0 & 0x03; }
  else if ((b0 & 0xFE) == 0xFC) { extra = 5; v = b0 & 0x01; }
  else if (b0 == 0xFE) { extra = 6; v = 0; }
  else return false;
  for (int i = 0; i < extra; i++) {
    uint32_t b = (uint32_t)br.read_bits(8);
    if ((b & 0xC0) != 0x80) return false;
    v = (v << 6) | (b & 0x3F);
  }
  *out = v;
  return true;
}

bool decode_residual(BitReader& br, int order, int block, int64_t* res) {
  int method = (int)br.read_bits(2);
  if (method > 1) return false;
  int plen = method == 0 ? 4 : 5;
  int escape = method == 0 ? 15 : 31;
  int porder = (int)br.read_bits(4);
  int nparts = 1 << porder;
  int idx = order;
  for (int p = 0; p < nparts; p++) {
    int n = (block >> porder) - (p == 0 ? order : 0);
    if (n < 0) return false;
    int k = (int)br.read_bits(plen);
    if (k == escape) {
      int bits = (int)br.read_bits(5);
      for (int i = 0; i < n; i++) res[idx++] = br.read_signed(bits);
    } else {
      for (int i = 0; i < n; i++) res[idx++] = rice_decode(br, k);
    }
    if (br.error) return false;
  }
  return true;
}

static const int kFixedOrders[5][4] = {
    {}, {1}, {2, -1}, {3, -3, 1}, {4, -6, 4, -1}};

bool decode_subframe(BitReader& br, int block, int bits, int64_t* out) {
  if (br.read_bits(1) != 0) return false;  // padding bit
  int type = (int)br.read_bits(6);
  int wasted = 0;
  if (br.read_bits(1)) {  // wasted bits flag: unary count - 1
    wasted = 1 + (int)br.read_unary();
  }
  int eff_bits = bits - wasted;

  if (type == 0) {  // constant
    int64_t v = br.read_signed(eff_bits);
    for (int i = 0; i < block; i++) out[i] = v;
  } else if (type == 1) {  // verbatim
    for (int i = 0; i < block; i++) out[i] = br.read_signed(eff_bits);
  } else if (type >= 8 && type <= 12) {  // fixed, order 0-4
    int order = type - 8;
    for (int i = 0; i < order; i++) out[i] = br.read_signed(eff_bits);
    if (!decode_residual(br, order, block, out)) return false;
    for (int i = order; i < block; i++) {
      int64_t pred = 0;
      const int* c = kFixedOrders[order];
      for (int j = 0; j < order; j++) pred += (int64_t)c[j] * out[i - 1 - j];
      out[i] += pred;
    }
  } else if (type >= 32) {  // LPC, order 1-32
    int order = type - 31;
    for (int i = 0; i < order; i++) out[i] = br.read_signed(eff_bits);
    int precision = (int)br.read_bits(4) + 1;
    if (precision == 16) return false;  // invalid
    int shift = (int)br.read_signed(5);
    std::vector<int64_t> coef(order);
    for (int i = 0; i < order; i++) coef[i] = br.read_signed(precision);
    if (!decode_residual(br, order, block, out)) return false;
    for (int i = order; i < block; i++) {
      int64_t pred = 0;
      for (int j = 0; j < order; j++) pred += coef[j] * out[i - 1 - j];
      out[i] += pred >> shift;
    }
  } else {
    return false;
  }
  if (wasted) for (int i = 0; i < block; i++) out[i] <<= wasted;
  return !br.error;
}

static const int kBlockSizes[16] = {0, 192, 576, 1152, 2304, 4608, -1, -2,
                                    256, 512, 1024, 2048, 4096, 8192, 16384, 32768};
static const int kSampleRates[12] = {0, 88200, 176400, 192000, 8000, 16000,
                                     22050, 24000, 32000, 44100, 48000, 96000};

}  // namespace

extern "C" {

// Decode a FLAC byte stream. On success returns 0 and fills out params;
// caller then calls polgen_flac_read into a preallocated buffer.
// Simple two-pass C ABI: first probe (samples/channels/rate), then decode.
int polgen_flac_probe(const uint8_t* data, int64_t size, int64_t* total_samples,
                      int32_t* channels, int32_t* sample_rate, int32_t* bits) {
  if (size < 42 || memcmp(data, "fLaC", 4) != 0) return -1;
  size_t pos = 4;
  bool last = false;
  StreamInfo si;
  bool have_si = false;
  while (!last && pos + 4 <= (size_t)size) {
    uint8_t hdr = data[pos];
    last = hdr & 0x80;
    int type = hdr & 0x7F;
    uint32_t len = (data[pos + 1] << 16) | (data[pos + 2] << 8) | data[pos + 3];
    pos += 4;
    if (pos + len > (size_t)size) return -1;  // truncated metadata block
    if (type == 0 && len >= 34) {
      const uint8_t* p = data + pos;
      si.sample_rate = (p[10] << 12) | (p[11] << 4) | (p[12] >> 4);
      si.channels = ((p[12] >> 1) & 0x7) + 1;
      si.bits = (((p[12] & 1) << 4) | (p[13] >> 4)) + 1;
      si.total_samples = ((uint64_t)(p[13] & 0x0F) << 32) | ((uint64_t)p[14] << 24) |
                         (p[15] << 16) | (p[16] << 8) | p[17];
      have_si = true;
    }
    pos += len;
  }
  if (!have_si) return -2;
  *total_samples = (int64_t)si.total_samples;
  *channels = si.channels;
  *sample_rate = (int32_t)si.sample_rate;
  *bits = si.bits;
  return (int)pos;  // offset of first frame
}

// Decode all frames into out (interleaved float32, total_samples*channels).
int polgen_flac_read(const uint8_t* data, int64_t size, int64_t frame_offset,
                     int32_t channels, int32_t bits, float* out,
                     int64_t max_samples) {
  BitReader br{data, (size_t)size};
  br.byte_pos = (size_t)frame_offset;
  int64_t written = 0;
  double scale = 1.0 / (double)((int64_t)1 << (bits - 1));
  std::vector<std::vector<int64_t>> ch(channels);

  while (br.byte_pos + 2 < br.size && written < max_samples) {
    // frame sync
    uint32_t sync = (uint32_t)br.read_bits(14);
    if (br.error) break;
    if (sync != 0x3FFE) return -3;
    br.read_bits(1);  // reserved
    br.read_bits(1);  // blocking strategy
    int bs_code = (int)br.read_bits(4);
    int sr_code = (int)br.read_bits(4);
    int ch_code = (int)br.read_bits(4);
    int sz_code = (int)br.read_bits(3);
    br.read_bits(1);  // reserved
    uint64_t frame_no;
    if (!read_utf8_coded(br, &frame_no)) return -4;
    int block;
    if (kBlockSizes[bs_code] == -1) block = (int)br.read_bits(8) + 1;
    else if (kBlockSizes[bs_code] == -2) block = (int)br.read_bits(16) + 1;
    else block = kBlockSizes[bs_code];
    if (sr_code == 12) br.read_bits(8);
    else if (sr_code == 13 || sr_code == 14) br.read_bits(16);
    br.read_bits(8);  // CRC-8 (not verified)

    int nch = channels;
    bool left_side = false, right_side = false, mid_side = false;
    if (ch_code <= 7) nch = ch_code + 1;
    else if (ch_code == 8) { nch = 2; left_side = true; }
    else if (ch_code == 9) { nch = 2; right_side = true; }
    else if (ch_code == 10) { nch = 2; mid_side = true; }
    else return -5;
    // The per-frame channel assignment must agree with STREAMINFO (which
    // sized `ch` and the caller's out buffer); a corrupt/crafted frame must
    // not index past them.
    if (nch != channels) return -5;

    for (int c = 0; c < nch; c++) {
      ch[c].assign(block, 0);
      int sub_bits = bits;
      if ((left_side && c == 1) || (right_side && c == 0) || (mid_side && c == 1))
        sub_bits += 1;  // side channel carries one extra bit
      if (!decode_subframe(br, block, sub_bits, ch[c].data())) return -6;
    }
    br.align();
    br.read_bits(16);  // CRC-16 (not verified)
    if (br.error) return -7;

    // undo decorrelation
    if (left_side) {
      for (int i = 0; i < block; i++) ch[1][i] = ch[0][i] - ch[1][i];
    } else if (right_side) {
      for (int i = 0; i < block; i++) ch[0][i] = ch[0][i] + ch[1][i];
    } else if (mid_side) {
      for (int i = 0; i < block; i++) {
        int64_t side = ch[1][i];
        int64_t mid = (ch[0][i] << 1) | (side & 1);
        ch[0][i] = (mid + side) >> 1;
        ch[1][i] = (mid - side) >> 1;
      }
    }

    for (int i = 0; i < block && written < max_samples; i++, written++) {
      for (int c = 0; c < channels; c++) {
        out[written * channels + c] = (float)(ch[c][i] * scale);
      }
    }
  }
  return (int)(written > 0 ? 0 : -8);
}

// ---------------------------------------------------------------------------
// encoder
// ---------------------------------------------------------------------------

namespace {

struct BitWriter {
  std::vector<uint8_t> bytes;
  uint64_t acc = 0;
  int nbits = 0;

  void write(uint64_t v, int n) {
    acc = (acc << n) | (v & (((uint64_t)1 << n) - 1));
    nbits += n;
    while (nbits >= 8) {
      bytes.push_back((uint8_t)(acc >> (nbits - 8)));
      nbits -= 8;
    }
  }
  void align() { if (nbits) write(0, 8 - nbits); }
};

uint8_t crc8(const uint8_t* d, size_t n) {
  uint8_t crc = 0;
  for (size_t i = 0; i < n; i++) {
    crc ^= d[i];
    for (int b = 0; b < 8; b++)
      crc = (crc & 0x80) ? (uint8_t)((crc << 1) ^ 0x07) : (uint8_t)(crc << 1);
  }
  return crc;
}

uint16_t crc16(const uint8_t* d, size_t n) {
  uint16_t crc = 0;
  for (size_t i = 0; i < n; i++) {
    crc ^= (uint16_t)d[i] << 8;
    for (int b = 0; b < 8; b++)
      crc = (crc & 0x8000) ? (uint16_t)((crc << 1) ^ 0x8005) : (uint16_t)(crc << 1);
  }
  return crc;
}

void write_utf8_coded(BitWriter& bw, uint64_t v) {
  if (v < 0x80) { bw.write(v, 8); return; }
  int extra = v < 0x800 ? 1 : v < 0x10000 ? 2 : v < 0x200000 ? 3 :
              v < 0x4000000 ? 4 : 5;
  static const uint8_t lead[6] = {0, 0xC0, 0xE0, 0xF0, 0xF8, 0xFC};
  bw.write(lead[extra] | (v >> (6 * extra)), 8);
  for (int i = extra - 1; i >= 0; i--) bw.write(0x80 | ((v >> (6 * i)) & 0x3F), 8);
}

int best_rice_param(const int64_t* res, int n) {
  if (n == 0) return 0;
  uint64_t sum = 0;
  for (int i = 0; i < n; i++) sum += (uint64_t)((res[i] >> 63) ^ (res[i] << 1));
  double mean = (double)sum / n;
  int k = 0;
  while ((1ull << (k + 1)) < mean + 1 && k < 30) k++;
  return k;
}

void rice_encode(BitWriter& bw, int64_t v, int k) {
  uint64_t u = (uint64_t)((v >> 63) ^ (v << 1));  // zigzag
  uint64_t q = u >> k;
  for (uint64_t i = 0; i < q; i++) bw.write(0, 1);
  bw.write(1, 1);
  if (k) bw.write(u, k);
}

}  // namespace

// Encode interleaved float32 -> FLAC bytes. Returns byte count (or <0).
// Caller provides out buffer; call with out=null to get an upper bound.
int64_t polgen_flac_encode(const float* samples, int64_t n_samples,
                           int32_t channels, int32_t sample_rate,
                           uint8_t* out, int64_t out_cap) {
  const int bits = 16;
  const int block_size = 4096;
  // worst case: verbatim-ish: header + 17 bits/sample
  int64_t bound = 128 + n_samples * channels * 3 + (n_samples / block_size + 1) * 32;
  if (!out) return bound;

  std::vector<uint8_t> file;
  file.insert(file.end(), {'f', 'L', 'a', 'C'});
  // STREAMINFO (last metadata block)
  uint8_t si[38] = {0};
  si[0] = 0x80;  // last, type 0
  si[3] = 34;
  si[4] = (block_size >> 8) & 0xFF; si[5] = block_size & 0xFF;
  si[6] = si[4]; si[7] = si[5];
  // min/max frame size unknown (0)
  si[14] = (uint8_t)(sample_rate >> 12);
  si[15] = (uint8_t)(sample_rate >> 4);
  si[16] = (uint8_t)(((sample_rate & 0xF) << 4) | (((channels - 1) & 0x7) << 1) |
                     (((bits - 1) >> 4) & 1));
  si[17] = (uint8_t)((((bits - 1) & 0xF) << 4) | ((n_samples >> 32) & 0xF));
  si[18] = (uint8_t)(n_samples >> 24);
  si[19] = (uint8_t)(n_samples >> 16);
  si[20] = (uint8_t)(n_samples >> 8);
  si[21] = (uint8_t)(n_samples);
  // MD5 left zero (unknown)
  file.insert(file.end(), si, si + 38);

  std::vector<int64_t> chan, res;
  uint64_t frame_no = 0;
  for (int64_t start = 0; start < n_samples; start += block_size, frame_no++) {
    int block = (int)((n_samples - start) < block_size ? (n_samples - start)
                                                       : block_size);
    BitWriter bw;
    bw.write(0x3FFE, 14);
    bw.write(0, 1);  // reserved
    bw.write(0, 1);  // fixed blocksize strategy
    int bs_code = block == 4096 ? 12 : 7;  // 7 => 16-bit block size follows
    bw.write(bs_code, 4);
    int sr_code = sample_rate == 44100 ? 9 : sample_rate == 48000 ? 10 :
                  sample_rate == 32000 ? 8 : sample_rate == 16000 ? 5 : 0;
    bw.write(sr_code, 4);
    bw.write(channels - 1, 4);  // independent channels
    bw.write(4, 3);             // 16-bit sample size
    bw.write(0, 1);
    write_utf8_coded(bw, frame_no);
    if (bs_code == 7) bw.write(block - 1, 16);
    bw.align();
    bw.bytes.push_back(crc8(bw.bytes.data(), bw.bytes.size()));

    BitWriter body;
    for (int c = 0; c < channels; c++) {
      chan.assign(block, 0);
      for (int i = 0; i < block; i++) {
        float v = samples[(start + i) * channels + c];
        if (v > 1.0f) v = 1.0f;
        if (v < -1.0f) v = -1.0f;
        long q = lround(v * 32767.0);
        chan[i] = q;
      }
      // choose fixed order 0..2 minimizing |residual| sum
      int best_order = 0;
      uint64_t best_cost = ~0ull;
      std::vector<int64_t> best_res;
      for (int order = 0; order <= 2; order++) {
        if (block <= order) break;
        res.assign(block - order, 0);
        for (int i = order; i < block; i++) {
          int64_t pred = 0;
          const int* cf = kFixedOrders[order];
          for (int j = 0; j < order; j++) pred += (int64_t)cf[j] * chan[i - 1 - j];
          res[i - order] = chan[i] - pred;
        }
        uint64_t cost = 0;
        for (auto r : res) cost += (uint64_t)(r < 0 ? -r : r);
        if (cost < best_cost) { best_cost = cost; best_order = order; best_res = res; }
      }
      body.write(0, 1);
      body.write(8 + best_order, 6);  // fixed subframe
      body.write(0, 1);               // no wasted bits
      for (int i = 0; i < best_order; i++) body.write((uint64_t)chan[i], 16);
      // residual: method 0, partition order 0
      body.write(0, 2);
      body.write(0, 4);
      int k = best_rice_param(best_res.data(), (int)best_res.size());
      if (k > 14) k = 14;
      body.write(k, 4);
      for (auto r : best_res) rice_encode(body, r, k);
    }
    body.align();
    // frame = header + body + crc16(all)
    std::vector<uint8_t> frame(bw.bytes);
    frame.insert(frame.end(), body.bytes.begin(), body.bytes.end());
    uint16_t c16 = crc16(frame.data(), frame.size());
    frame.push_back((uint8_t)(c16 >> 8));
    frame.push_back((uint8_t)c16);
    file.insert(file.end(), frame.begin(), frame.end());
  }

  if ((int64_t)file.size() > out_cap) return -1;
  memcpy(out, file.data(), file.size());
  return (int64_t)file.size();
}

}  // extern "C"
