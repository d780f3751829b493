// Native OD4 envelope codec — the hot ingest path.
//
// Native equivalent of libcluon's envelope decoder (the reference's whole
// comm stack is native C++: reference src/cluon-complete-build.hpp:6868-6957
// framing, :5684-5840 proto decode). The Python codec in tpuslam.io.proto is
// the semantics reference; this library does the bulk work for .rec scanning
// and high-rate ingest: frame resynchronization, envelope header decode
// (dataType / senderStamp / sampleTimeStamp / payload span), and batched
// decode of the seven SLAM ingest message types straight into float arrays
// ready for jax.device_put.
//
// Build: make (g++ -O3 -shared -fPIC). Loaded via ctypes from
// tpuslam/native/codec.py with a pure-Python fallback.

#include <cstdint>
#include <cstring>

namespace {

constexpr uint8_t kMagic0 = 0x0D;
constexpr uint8_t kMagic1 = 0xA4;

inline bool read_varint(const uint8_t* buf, int64_t n, int64_t& pos,
                        uint64_t& out) {
  uint64_t result = 0;
  int shift = 0;
  while (pos < n && shift <= 63) {
    uint8_t b = buf[pos++];
    result |= static_cast<uint64_t>(b & 0x7F) << shift;
    if (!(b & 0x80)) {
      out = result;
      return true;
    }
    shift += 7;
  }
  return false;
}

inline int64_t zigzag_decode(uint64_t v) {
  return static_cast<int64_t>(v >> 1) ^ -static_cast<int64_t>(v & 1);
}

// Skip one proto field of the given wire type. Returns false on malformed.
inline bool skip_field(const uint8_t* buf, int64_t n, int64_t& pos,
                       uint32_t wire_type) {
  uint64_t tmp;
  switch (wire_type) {
    case 0: return read_varint(buf, n, pos, tmp);
    case 1: pos += 8; return pos <= n;
    case 5: pos += 4; return pos <= n;
    case 2:
      if (!read_varint(buf, n, pos, tmp)) return false;
      pos += static_cast<int64_t>(tmp);
      return pos <= n;
    default: return false;
  }
}

}  // namespace

extern "C" {

// Scan framed envelopes. Fills payload offsets/lengths (payload = the
// proto-encoded Envelope, magic+length header excluded). Returns count.
int64_t od4_scan(const uint8_t* buf, int64_t n, int64_t* offsets,
                 int64_t* lengths, int64_t max_frames) {
  int64_t count = 0;
  int64_t pos = 0;
  while (pos + 5 <= n && count < max_frames) {
    if (buf[pos] == kMagic0 && buf[pos + 1] == kMagic1) {
      int64_t len = static_cast<int64_t>(buf[pos + 2]) |
                    (static_cast<int64_t>(buf[pos + 3]) << 8) |
                    (static_cast<int64_t>(buf[pos + 4]) << 16);
      if (pos + 5 + len > n) break;  // incomplete tail
      offsets[count] = pos + 5;
      lengths[count] = len;
      ++count;
      pos += 5 + len;
    } else {
      ++pos;  // resynchronize on magic
    }
  }
  return count;
}

// Decode one Envelope's header fields. Returns 1 on success.
// sample_us out param gets seconds*1e6+microseconds of sampleTimeStamp.
static int decode_envelope_header(const uint8_t* buf, int64_t n,
                                  int32_t* data_type, uint32_t* sender_stamp,
                                  int64_t* sample_us, int64_t* payload_off,
                                  int64_t* payload_len) {
  int64_t pos = 0;
  *data_type = 0;
  *sender_stamp = 0;
  *sample_us = 0;
  *payload_off = 0;
  *payload_len = 0;
  while (pos < n) {
    uint64_t key;
    if (!read_varint(buf, n, pos, key)) return 0;
    uint32_t fid = static_cast<uint32_t>(key >> 3);
    uint32_t wt = static_cast<uint32_t>(key & 0x7);
    if (fid == 1 && wt == 0) {  // dataType (zigzag)
      uint64_t v;
      if (!read_varint(buf, n, pos, v)) return 0;
      *data_type = static_cast<int32_t>(zigzag_decode(v));
    } else if (fid == 2 && wt == 2) {  // serializedData
      uint64_t len;
      if (!read_varint(buf, n, pos, len)) return 0;
      *payload_off = pos;
      *payload_len = static_cast<int64_t>(len);
      pos += static_cast<int64_t>(len);
      if (pos > n) return 0;
    } else if (fid == 5 && wt == 2) {  // sampleTimeStamp (nested TimeStamp)
      uint64_t len;
      if (!read_varint(buf, n, pos, len)) return 0;
      int64_t end = pos + static_cast<int64_t>(len);
      if (end > n) return 0;
      int64_t secs = 0, micros = 0;
      while (pos < end) {
        uint64_t k2;
        if (!read_varint(buf, end, pos, k2)) return 0;
        uint64_t v;
        if ((k2 >> 3) == 1 && (k2 & 7) == 0) {
          if (!read_varint(buf, end, pos, v)) return 0;
          secs = zigzag_decode(v);
        } else if ((k2 >> 3) == 2 && (k2 & 7) == 0) {
          if (!read_varint(buf, end, pos, v)) return 0;
          micros = zigzag_decode(v);
        } else if (!skip_field(buf, end, pos, k2 & 7)) {
          return 0;
        }
      }
      *sample_us = secs * 1000000 + micros;
    } else if (fid == 6 && wt == 0) {  // senderStamp
      uint64_t v;
      if (!read_varint(buf, n, pos, v)) return 0;
      *sender_stamp = static_cast<uint32_t>(v);
    } else if (!skip_field(buf, n, pos, wt)) {
      return 0;
    }
  }
  return 1;
}

// Bulk header decode over a whole buffer of framed envelopes.
int64_t od4_decode_headers(const uint8_t* buf, int64_t n, int64_t max_frames,
                           int32_t* data_types, uint32_t* sender_stamps,
                           int64_t* sample_us, int64_t* payload_off,
                           int64_t* payload_len) {
  int64_t count = 0;
  int64_t pos = 0;
  while (pos + 5 <= n && count < max_frames) {
    if (buf[pos] == kMagic0 && buf[pos + 1] == kMagic1) {
      int64_t len = static_cast<int64_t>(buf[pos + 2]) |
                    (static_cast<int64_t>(buf[pos + 3]) << 8) |
                    (static_cast<int64_t>(buf[pos + 4]) << 16);
      if (pos + 5 + len > n) break;
      int64_t off, plen;
      if (decode_envelope_header(buf + pos + 5, len, &data_types[count],
                                 &sender_stamps[count], &sample_us[count],
                                 &off, &plen)) {
        payload_off[count] = pos + 5 + off;
        payload_len[count] = plen;
        ++count;
      }
      pos += 5 + len;
    } else {
      ++pos;
    }
  }
  return count;
}

// Batched decode of cone-ingest payloads into arrays.
// kind: 1133=ObjectDirection (objectId, azimuth, zenith)
//       1134=ObjectDistance (objectId, distance)
//       1131=ObjectType (objectId, type)
// For each payload i: parse fields into out_id[i] and out_f[i*2], out_f[i*2+1]
// (unused slots left 0). Returns number decoded.
int64_t od4_decode_cones(const uint8_t* buf, const int64_t* payload_off,
                         const int64_t* payload_len, int64_t count,
                         int32_t kind, uint32_t* out_id, float* out_f) {
  int64_t ok = 0;
  for (int64_t i = 0; i < count; ++i) {
    const uint8_t* p = buf + payload_off[i];
    int64_t n = payload_len[i];
    int64_t pos = 0;
    out_id[i] = 0;
    out_f[2 * i] = 0.f;
    out_f[2 * i + 1] = 0.f;
    bool good = true;
    while (pos < n && good) {
      uint64_t key;
      if (!read_varint(p, n, pos, key)) { good = false; break; }
      uint32_t fid = static_cast<uint32_t>(key >> 3);
      uint32_t wt = static_cast<uint32_t>(key & 7);
      if (fid == 1 && wt == 0) {  // objectId (uint32 varint)
        uint64_t v;
        if (!read_varint(p, n, pos, v)) { good = false; break; }
        out_id[i] = static_cast<uint32_t>(v);
      } else if (wt == 5 && (fid == 2 || fid == 3)) {  // float fields
        if (pos + 4 > n) { good = false; break; }
        float f;
        std::memcpy(&f, p + pos, 4);
        pos += 4;
        out_f[2 * i + (fid - 2)] = f;
      } else if (fid == 2 && wt == 0 && kind == 1131) {  // ObjectType.type
        uint64_t v;
        if (!read_varint(p, n, pos, v)) { good = false; break; }
        out_f[2 * i] = static_cast<float>(v);
      } else if (!skip_field(p, n, pos, wt)) {
        good = false;
      }
    }
    if (good) ++ok;
  }
  return ok;
}

}  // extern "C"
