// ptio: native EXR/BMP IO for tpu-pathtrace.
//
// The reference vendors two single-header native IO libraries (tinyexr,
// stb_image_write) driven from C++ (include/OutputBuffer.h). This is the
// framework's native equivalent: a small C++ library implementing the
// OpenEXR 2.0 single-part scanline format (FLOAT channels; NONE/ZIPS/ZIP
// compression with the spec's two-plane reorder + delta predictor around
// zlib) and 24-bit bottom-up BGR BMP. Exposed as a C ABI consumed from
// Python via ctypes (pathtrace_tpu_torch/io/native.py); the pure-Python
// implementation in io/exr.py is the format oracle and fallback. This is
// the PyTorch port's own copy of pathtrace_tpu/native/ptio.cpp.
//
// Byte-compatibility contract: for identical inputs this writer must
// produce files the Python reader parses to identical arrays and vice
// versa (tests/test_torch_native_io.py).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include <zlib.h>

namespace {

constexpr int32_t kMagic = 20000630;
constexpr int32_t kPixelTypeFloat = 2;

enum Compression : uint8_t { kNone = 0, kZips = 1, kZip = 3 };

int lines_per_chunk(uint8_t comp) { return comp == kZip ? 16 : 1; }

void put_bytes(std::vector<uint8_t>& out, const void* data, size_t n) {
  const uint8_t* p = static_cast<const uint8_t*>(data);
  out.insert(out.end(), p, p + n);
}

template <typename T>
void put(std::vector<uint8_t>& out, T v) {
  put_bytes(out, &v, sizeof(T));  // little-endian hosts only (x86/ARM/TPU VM)
}

void put_str(std::vector<uint8_t>& out, const char* s) {
  put_bytes(out, s, std::strlen(s) + 1);
}

void put_attr(std::vector<uint8_t>& out, const char* name, const char* type,
              const std::vector<uint8_t>& value) {
  put_str(out, name);
  put_str(out, type);
  put<int32_t>(out, static_cast<int32_t>(value.size()));
  put_bytes(out, value.data(), value.size());
}

// OpenEXR zip: split bytes into two interleaved planes, delta-encode,
// deflate. (ImfZip.cpp semantics.)
std::vector<uint8_t> zip_encode(const uint8_t* data, size_t n) {
  std::vector<uint8_t> tmp(n);
  const size_t half = (n + 1) / 2;
  size_t j = 0;
  for (size_t i = 0; i < n; i += 2) tmp[j++] = data[i];
  for (size_t i = 1; i < n; i += 2) tmp[j++] = data[i];
  (void)half;
  uint8_t prev = tmp.empty() ? 0 : tmp[0];
  for (size_t i = 1; i < n; i++) {
    const uint8_t cur = tmp[i];
    tmp[i] = static_cast<uint8_t>(static_cast<int>(cur) - static_cast<int>(prev) + 128 + 256);
    prev = cur;
  }
  uLongf bound = compressBound(static_cast<uLong>(n));
  std::vector<uint8_t> out(bound);
  if (compress2(out.data(), &bound, tmp.data(), static_cast<uLong>(n),
                Z_DEFAULT_COMPRESSION) != Z_OK) {
    return {};
  }
  out.resize(bound);
  return out;
}

bool zip_decode(const uint8_t* data, size_t n, uint8_t* out, size_t out_n) {
  std::vector<uint8_t> tmp(out_n);
  uLongf dest_len = static_cast<uLongf>(out_n);
  if (uncompress(tmp.data(), &dest_len, data, static_cast<uLong>(n)) != Z_OK ||
      dest_len != out_n) {
    return false;
  }
  // un-predict
  for (size_t i = 1; i < out_n; i++) {
    tmp[i] = static_cast<uint8_t>(static_cast<int>(tmp[i]) + static_cast<int>(tmp[i - 1]) - 128);
  }
  // un-interleave
  const size_t half = (out_n + 1) / 2;
  size_t a = 0, b = half;
  for (size_t i = 0; i < out_n; i++) {
    out[i] = (i % 2 == 0) ? tmp[a++] : tmp[b++];
  }
  return true;
}

struct Reader {
  const uint8_t* p;
  size_t n;
  size_t pos = 0;
  bool ok = true;

  template <typename T>
  T get() {
    T v{};
    if (pos + sizeof(T) > n) { ok = false; return v; }
    std::memcpy(&v, p + pos, sizeof(T));
    pos += sizeof(T);
    return v;
  }
  std::string get_str() {
    std::string s;
    while (pos < n && p[pos] != 0) s.push_back(static_cast<char>(p[pos++]));
    if (pos < n) pos++; else ok = false;
    return s;
  }
  void skip(size_t k) { pos = pos + k <= n ? pos + k : (ok = false, n); }
};

bool read_file(const char* path, std::vector<uint8_t>& buf) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long sz = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (sz < 0) { std::fclose(f); return false; }
  buf.resize(static_cast<size_t>(sz));
  size_t rd = buf.empty() ? 0 : std::fread(buf.data(), 1, buf.size(), f);
  std::fclose(f);
  return rd == buf.size();
}

}  // namespace

extern "C" {

// Write an EXR of float channels. names must be pre-sorted alphabetically
// (the caller guarantees spec compliance); planes[i] is H*W floats.
// compression: 0 none, 1 zips, 3 zip. Returns 0 on success.
int ptio_write_exr(const char* path, int width, int height, int n_channels,
                   const char* const* names, const float* const* planes,
                   int compression) {
  if (width <= 0 || height <= 0 || n_channels <= 0) return 1;
  const uint8_t comp = static_cast<uint8_t>(compression);
  if (comp != kNone && comp != kZips && comp != kZip) return 2;

  std::vector<uint8_t> header;
  {
    std::vector<uint8_t> chlist;
    for (int c = 0; c < n_channels; c++) {
      put_str(chlist, names[c]);
      put<int32_t>(chlist, kPixelTypeFloat);
      put<uint32_t>(chlist, 0);  // pLinear + reserved
      put<int32_t>(chlist, 1);
      put<int32_t>(chlist, 1);
    }
    chlist.push_back(0);
    put_attr(header, "channels", "chlist", chlist);

    std::vector<uint8_t> v1{comp};
    put_attr(header, "compression", "compression", v1);

    std::vector<uint8_t> box;
    put<int32_t>(box, 0); put<int32_t>(box, 0);
    put<int32_t>(box, width - 1); put<int32_t>(box, height - 1);
    put_attr(header, "dataWindow", "box2i", box);
    put_attr(header, "displayWindow", "box2i", box);

    std::vector<uint8_t> lo{0};
    put_attr(header, "lineOrder", "lineOrder", lo);

    std::vector<uint8_t> par; put<float>(par, 1.0f);
    put_attr(header, "pixelAspectRatio", "float", par);
    std::vector<uint8_t> swc; put<float>(swc, 0.0f); put<float>(swc, 0.0f);
    put_attr(header, "screenWindowCenter", "v2f", swc);
    std::vector<uint8_t> sww; put<float>(sww, 1.0f);
    put_attr(header, "screenWindowWidth", "float", sww);
    header.push_back(0);
  }

  const int lpc = lines_per_chunk(comp);
  const int n_chunks = (height + lpc - 1) / lpc;
  const size_t row_bytes = static_cast<size_t>(width) * 4;

  std::vector<std::vector<uint8_t>> chunks;
  chunks.reserve(n_chunks);
  std::vector<uint8_t> raw;
  for (int y0 = 0; y0 < height; y0 += lpc) {
    const int ny = y0 + lpc <= height ? lpc : height - y0;
    raw.clear();
    raw.reserve(static_cast<size_t>(ny) * n_channels * row_bytes);
    for (int y = y0; y < y0 + ny; y++) {
      for (int c = 0; c < n_channels; c++) {
        put_bytes(raw, planes[c] + static_cast<size_t>(y) * width, row_bytes);
      }
    }
    if (comp == kNone) {
      chunks.push_back(raw);
    } else {
      std::vector<uint8_t> z = zip_encode(raw.data(), raw.size());
      // Spec: store raw when compression doesn't shrink.
      chunks.push_back((z.empty() || z.size() >= raw.size()) ? raw : std::move(z));
    }
  }

  FILE* f = std::fopen(path, "wb");
  if (!f) return 3;
  std::vector<uint8_t> pre;
  put<int32_t>(pre, kMagic);
  put<int32_t>(pre, 2);
  std::fwrite(pre.data(), 1, pre.size(), f);
  std::fwrite(header.data(), 1, header.size(), f);

  uint64_t offset = pre.size() + header.size() + 8ull * n_chunks;
  for (const auto& ch : chunks) {
    std::fwrite(&offset, 8, 1, f);
    offset += 8 + ch.size();
  }
  for (int i = 0; i < n_chunks; i++) {
    int32_t y = i * lpc;
    int32_t sz = static_cast<int32_t>(chunks[i].size());
    std::fwrite(&y, 4, 1, f);
    std::fwrite(&sz, 4, 1, f);
    std::fwrite(chunks[i].data(), 1, chunks[i].size(), f);
  }
  std::fclose(f);
  return 0;
}

// Probe an EXR: fills width/height/channel count and channel names
// (newline-joined, header order) into names_buf. Returns 0 on success.
int ptio_read_exr_header(const char* path, int* width, int* height,
                         int* n_channels, char* names_buf, int names_cap) {
  std::vector<uint8_t> buf;
  if (!read_file(path, buf)) return 3;
  Reader r{buf.data(), buf.size()};
  if (r.get<int32_t>() != kMagic) return 4;
  int32_t version = r.get<int32_t>();
  if (version & 0x200) return 5;  // multi-part unsupported

  std::string names;
  int nc = 0;
  int w = -1, h = -1;
  while (r.ok) {
    if (r.pos < r.n && buf[r.pos] == 0) { r.pos++; break; }
    std::string name = r.get_str();
    std::string type = r.get_str();
    int32_t size = r.get<int32_t>();
    if (!r.ok) return 6;
    if (name == "channels") {
      size_t end = r.pos + size;
      while (r.pos < end && buf[r.pos] != 0) {
        std::string cname = r.get_str();
        r.skip(16);
        if (!names.empty()) names.push_back('\n');
        names += cname;
        nc++;
      }
      r.pos = end;
    } else if (name == "dataWindow") {
      int32_t xmin = r.get<int32_t>(), ymin = r.get<int32_t>();
      int32_t xmax = r.get<int32_t>(), ymax = r.get<int32_t>();
      w = xmax - xmin + 1;
      h = ymax - ymin + 1;
    } else {
      r.skip(size);
    }
  }
  if (!r.ok || w < 0 || nc == 0) return 6;
  *width = w;
  *height = h;
  *n_channels = nc;
  if (static_cast<int>(names.size()) + 1 > names_cap) return 7;
  std::memcpy(names_buf, names.c_str(), names.size() + 1);
  return 0;
}

// Read all channels (header order) into out[c * H*W + y*W + x] as f32.
// Supports FLOAT/HALF/UINT channels, NONE/ZIPS/ZIP compression.
int ptio_read_exr(const char* path, float* out) {
  std::vector<uint8_t> buf;
  if (!read_file(path, buf)) return 3;
  Reader r{buf.data(), buf.size()};
  if (r.get<int32_t>() != kMagic) return 4;
  if (r.get<int32_t>() & 0x200) return 5;

  struct Chan { std::string name; int32_t type; };
  std::vector<Chan> chans;
  uint8_t comp = kNone;
  int w = -1, h = -1, ymin = 0;
  while (r.ok) {
    if (r.pos < r.n && buf[r.pos] == 0) { r.pos++; break; }
    std::string name = r.get_str();
    std::string type = r.get_str();
    int32_t size = r.get<int32_t>();
    if (!r.ok) return 6;
    if (name == "channels") {
      size_t end = r.pos + size;
      while (r.pos < end && buf[r.pos] != 0) {
        Chan c;
        c.name = r.get_str();
        c.type = r.get<int32_t>();
        r.skip(12);
        chans.push_back(c);
      }
      r.pos = end;
    } else if (name == "compression") {
      comp = buf[r.pos];
      r.skip(size);
    } else if (name == "dataWindow") {
      int32_t xmin = r.get<int32_t>(); ymin = r.get<int32_t>();
      int32_t xmax = r.get<int32_t>(); int32_t ymax = r.get<int32_t>();
      w = xmax - xmin + 1;
      h = ymax - ymin + 1;
    } else {
      r.skip(size);
    }
  }
  if (!r.ok || w < 0 || chans.empty()) return 6;
  if (comp != kNone && comp != kZips && comp != kZip) return 2;

  size_t bytes_per_px = 0;
  for (const auto& c : chans) {
    bytes_per_px += c.type == 1 ? 2 : 4;
  }
  const int lpc = lines_per_chunk(comp);
  const int n_chunks = (h + lpc - 1) / lpc;
  std::vector<uint64_t> offsets(n_chunks);
  for (int i = 0; i < n_chunks; i++) offsets[i] = r.get<uint64_t>();
  if (!r.ok) return 6;

  const size_t plane = static_cast<size_t>(w) * h;
  std::vector<uint8_t> decoded;
  for (int i = 0; i < n_chunks; i++) {
    Reader cr{buf.data(), buf.size()};
    cr.pos = offsets[i];
    int32_t y = cr.get<int32_t>();
    int32_t size = cr.get<int32_t>();
    if (!cr.ok || cr.pos + size > cr.n) return 6;
    const int ny = (y - ymin) + lpc <= h ? lpc : h - (y - ymin);
    const size_t expected = bytes_per_px * w * ny;
    const uint8_t* data = buf.data() + cr.pos;
    if (comp != kNone && static_cast<size_t>(size) != expected) {
      decoded.resize(expected);
      if (!zip_decode(data, size, decoded.data(), expected)) return 8;
      data = decoded.data();
    }
    size_t dpos = 0;
    for (int row = y - ymin; row < y - ymin + ny; row++) {
      for (size_t c = 0; c < chans.size(); c++) {
        float* dst = out + c * plane + static_cast<size_t>(row) * w;
        if (chans[c].type == 2) {  // FLOAT
          std::memcpy(dst, data + dpos, static_cast<size_t>(w) * 4);
          dpos += static_cast<size_t>(w) * 4;
        } else if (chans[c].type == 1) {  // HALF
          for (int x = 0; x < w; x++) {
            uint16_t hbits;
            std::memcpy(&hbits, data + dpos + 2 * x, 2);
            const uint32_t sign = (hbits >> 15) & 1;
            const uint32_t exp = (hbits >> 10) & 0x1F;
            const uint32_t man = hbits & 0x3FF;
            uint32_t fbits;
            if (exp == 0) {
              if (man == 0) {
                fbits = sign << 31;
              } else {
                int e = -1;
                uint32_t m = man;
                while (!(m & 0x400)) { m <<= 1; e++; }
                m &= 0x3FF;
                fbits = (sign << 31) | ((127 - 15 - e) << 23) | (m << 13);
              }
            } else if (exp == 31) {
              fbits = (sign << 31) | 0x7F800000u | (man << 13);
            } else {
              fbits = (sign << 31) | ((exp - 15 + 127) << 23) | (man << 13);
            }
            std::memcpy(dst + x, &fbits, 4);
          }
          dpos += static_cast<size_t>(w) * 2;
        } else {  // UINT
          for (int x = 0; x < w; x++) {
            uint32_t u;
            std::memcpy(&u, data + dpos + 4 * x, 4);
            dst[x] = static_cast<float>(u);
          }
          dpos += static_cast<size_t>(w) * 4;
        }
      }
    }
  }
  return 0;
}

// 24-bit bottom-up BGR BMP (the layout stb_image_write produces).
// rgb: H*W*3 top-down RGB bytes.
int ptio_write_bmp(const char* path, int width, int height,
                   const uint8_t* rgb) {
  if (width <= 0 || height <= 0) return 1;
  const int row_size = (width * 3 + 3) & ~3;
  const int data_size = row_size * height;
  const int header_size = 14 + 40;

  FILE* f = std::fopen(path, "wb");
  if (!f) return 3;
  std::vector<uint8_t> hdr;
  put_bytes(hdr, "BM", 2);
  put<uint32_t>(hdr, header_size + data_size);
  put<uint32_t>(hdr, 0);
  put<uint32_t>(hdr, header_size);
  put<uint32_t>(hdr, 40);
  put<int32_t>(hdr, width);
  put<int32_t>(hdr, height);
  put<uint16_t>(hdr, 1);
  put<uint16_t>(hdr, 24);
  put<uint32_t>(hdr, 0);
  put<uint32_t>(hdr, data_size);
  put<int32_t>(hdr, 2835);
  put<int32_t>(hdr, 2835);
  put<uint32_t>(hdr, 0);
  put<uint32_t>(hdr, 0);
  std::fwrite(hdr.data(), 1, hdr.size(), f);

  std::vector<uint8_t> row(row_size, 0);
  for (int y = height - 1; y >= 0; y--) {
    const uint8_t* src = rgb + static_cast<size_t>(y) * width * 3;
    for (int x = 0; x < width; x++) {
      row[x * 3 + 0] = src[x * 3 + 2];
      row[x * 3 + 1] = src[x * 3 + 1];
      row[x * 3 + 2] = src[x * 3 + 0];
    }
    std::fwrite(row.data(), 1, row.size(), f);
  }
  std::fclose(f);
  return 0;
}

}  // extern "C"
