// Native host-side frame decoding for the data loader.
//
// The reference leans on OpenCV's C++ internals for its host pixel work;
// our device pipeline replaced those, and this small library covers the
// remaining host-side hot path: decoding raw depth frames into the batch
// buffer without holding the Python GIL and with a real thread pool.
//
//   * msra_decode_batch: MSRA .bin tiles (6x int32 header + f32 payload,
//     reference: utils.py:253-260) embedded into zeroed 320x240 canvases,
//     plus the center-of-mass fallback (reference: datasets.py:208-211)
//     computed in the same pass over the pixels.
//   * nyu_pack_batch: NYU RGB-packed PNG planes -> depth in mm with the
//     reference's float32 rounding semantics ((g/255*256 + b/255)*255,
//     reference: datasets.py:809-810).
//
//   * png_decode_depth_batch: FULL native PNG decode (zlib inflate +
//     row unfilter) of the datasets' two frame formats — NYU 8-bit RGB
//     with depth packed in (G,B), and ICVL/HAND17 16-bit grayscale —
//     straight into the f32 depth batch buffer, no PIL in the hot path.
//
// Exposed with a C ABI for ctypes (no pybind11 in this environment).
// Build: g++ -O3 -march=native -shared -fPIC -o libframe_ops.so frame_ops.cpp -lpthread -lz

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include <zlib.h>

namespace {

struct MsraResult {
  int status;  // 0 ok, nonzero errno-ish
};

void decode_one_msra(const char* path, int frame_h, int frame_w, float* out_frame,
                     double* out_com, int* status) {
  std::memset(out_frame, 0, sizeof(float) * frame_h * frame_w);
  *status = 1;
  FILE* f = std::fopen(path, "rb");
  if (!f) return;
  int32_t hdr[6];
  if (std::fread(hdr, sizeof(int32_t), 6, f) != 6) {
    std::fclose(f);
    return;
  }
  const int left = hdr[2], top = hdr[3], right = hdr[4], bottom = hdr[5];
  const int th = bottom - top, tw = right - left;
  if (th <= 0 || tw <= 0 || top < 0 || left < 0 || bottom > frame_h || right > frame_w) {
    std::fclose(f);
    return;
  }
  std::vector<float> tile((size_t)th * tw);
  if (std::fread(tile.data(), sizeof(float), tile.size(), f) != tile.size()) {
    std::fclose(f);
    return;
  }
  std::fclose(f);

  // embed + center-of-mass over positive support in one pass
  double sum_r = 0.0, sum_c = 0.0, sum_v = 0.0;
  int64_t count = 0;
  for (int r = 0; r < th; ++r) {
    float* dst = out_frame + (size_t)(top + r) * frame_w + left;
    const float* src = tile.data() + (size_t)r * tw;
    for (int c = 0; c < tw; ++c) {
      const float v = src[c];
      dst[c] = v;
      if (v > 0.0f) {
        sum_r += (double)(top + r);
        sum_c += (double)(left + c);
        sum_v += (double)v;
        ++count;
      }
    }
  }
  if (count == 0) return;
  out_com[0] = sum_c / (double)count;  // u
  out_com[1] = sum_r / (double)count;  // v
  out_com[2] = sum_v / (double)count;  // mean depth
  *status = 0;
}

template <typename Fn>
void parallel_for(int n, int num_threads, Fn&& fn) {
  if (num_threads <= 1 || n <= 1) {
    for (int i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int> next(0);
  auto worker = [&]() {
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) return;
      fn(i);
    }
  };
  std::vector<std::thread> pool;
  const int t = std::min(num_threads, n);
  pool.reserve(t);
  for (int i = 0; i < t; ++i) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}

// ---- minimal PNG decoder (non-interlaced IHDR/IDAT/IEND, zlib via -lz) ----

inline uint32_t be32(const uint8_t* p) {
  return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) | ((uint32_t)p[2] << 8) | p[3];
}

inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = p > a ? p - a : a - p;
  const int pb = p > b ? p - b : b - p;
  const int pc = p > c ? p - c : c - p;
  if (pa <= pb && pa <= pc) return (uint8_t)a;
  if (pb <= pc) return (uint8_t)b;
  return (uint8_t)c;
}

// Decode one PNG file into `out` depth floats.
// mode 0: expect 8-bit RGB/RGBA -> (g/255*256 + b/255)*255   (NYU packing)
// mode 1: expect 16-bit grayscale -> (v/65535)*65535          (plt.imread)
// Returns 0 on success; nonzero = caller should fall back to the PIL path.
int decode_one_png(const char* path, int mode, int exp_h, int exp_w, float* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  std::fseek(f, 0, SEEK_END);
  const long fsize = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (fsize < 45) { std::fclose(f); return 2; }
  std::vector<uint8_t> buf((size_t)fsize);
  if (std::fread(buf.data(), 1, buf.size(), f) != buf.size()) { std::fclose(f); return 3; }
  std::fclose(f);

  static const uint8_t sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (std::memcmp(buf.data(), sig, 8) != 0) return 4;

  uint32_t w = 0, h = 0;
  int bitdepth = 0, colortype = -1, interlace = 0;
  std::vector<uint8_t> idat;
  size_t off = 8;
  while (off + 12 <= buf.size()) {
    const uint32_t len = be32(&buf[off]);
    const uint8_t* type = &buf[off + 4];
    const uint8_t* data = &buf[off + 8];
    if (off + 12 + len > buf.size()) return 5;
    if (!std::memcmp(type, "IHDR", 4)) {
      if (len < 13) return 6;
      w = be32(data);
      h = be32(data + 4);
      bitdepth = data[8];
      colortype = data[9];
      interlace = data[12];
    } else if (!std::memcmp(type, "IDAT", 4)) {
      idat.insert(idat.end(), data, data + len);
    } else if (!std::memcmp(type, "IEND", 4)) {
      break;
    }
    off += 12 + len;
  }
  if (interlace != 0 || w == 0 || h == 0) return 7;
  if ((int)h != exp_h || (int)w != exp_w) return 8;

  int bpp;  // bytes per pixel
  if (mode == 0 && bitdepth == 8 && (colortype == 2 || colortype == 6)) {
    bpp = colortype == 2 ? 3 : 4;
  } else if (mode == 1 && bitdepth == 16 && colortype == 0) {
    bpp = 2;
  } else {
    return 9;
  }

  const size_t rowbytes = (size_t)w * bpp;
  std::vector<uint8_t> raw((rowbytes + 1) * h);
  uLongf dlen = (uLongf)raw.size();
  if (uncompress(raw.data(), &dlen, idat.data(), (uLong)idat.size()) != Z_OK ||
      dlen != raw.size()) {
    return 10;
  }

  // unfilter in place row by row, then transform to depth floats
  std::vector<uint8_t> prev(rowbytes, 0);
  for (uint32_t y = 0; y < h; ++y) {
    uint8_t* row = &raw[(rowbytes + 1) * y];
    const uint8_t filt = row[0];
    uint8_t* cur = row + 1;
    switch (filt) {
      case 0:
        break;
      case 1:
        for (size_t i = bpp; i < rowbytes; ++i) cur[i] = (uint8_t)(cur[i] + cur[i - bpp]);
        break;
      case 2:
        for (size_t i = 0; i < rowbytes; ++i) cur[i] = (uint8_t)(cur[i] + prev[i]);
        break;
      case 3:
        for (size_t i = 0; i < (size_t)bpp; ++i) cur[i] = (uint8_t)(cur[i] + prev[i] / 2);
        for (size_t i = bpp; i < rowbytes; ++i)
          cur[i] = (uint8_t)(cur[i] + ((cur[i - bpp] + prev[i]) >> 1));
        break;
      case 4:
        for (size_t i = 0; i < (size_t)bpp; ++i)
          cur[i] = (uint8_t)(cur[i] + paeth(0, prev[i], 0));
        for (size_t i = bpp; i < rowbytes; ++i)
          cur[i] = (uint8_t)(cur[i] + paeth(cur[i - bpp], prev[i], prev[i - bpp]));
        break;
      default:
        return 11;
    }
    std::memcpy(prev.data(), cur, rowbytes);

    float* dst = out + (size_t)y * w;
    if (mode == 0) {
      for (uint32_t x = 0; x < w; ++x) {
        const float g = (float)cur[(size_t)x * bpp + 1] / 255.0f;
        const float b = (float)cur[(size_t)x * bpp + 2] / 255.0f;
        dst[x] = (g * 256.0f + b) * 255.0f;
      }
    } else {
      for (uint32_t x = 0; x < w; ++x) {
        const uint16_t v =
            (uint16_t)(((uint16_t)cur[(size_t)x * 2] << 8) | cur[(size_t)x * 2 + 1]);
        dst[x] = ((float)v / 65535.0f) * 65535.0f;
      }
    }
  }
  return 0;
}

}  // namespace

extern "C" {

// Full PNG decode of dataset depth frames. paths: n C strings; mode 0 = NYU
// RGB-packed depth, mode 1 = 16-bit grayscale (ICVL/HAND17); out: [n, h, w]
// f32; out_status: [n] i32, 0 = ok (nonzero -> caller falls back to PIL).
void png_decode_depth_batch(const char** paths, int n, int mode, int h, int w,
                            float* out, int* out_status, int num_threads) {
  parallel_for(n, num_threads, [&](int i) {
    out_status[i] = decode_one_png(paths[i], mode, h, w, out + (size_t)i * h * w);
  });
}

// paths: n C strings; out_frames: [n, frame_h, frame_w] f32;
// out_coms: [n, 3] f64; out_status: [n] i32 (0 = ok).
void msra_decode_batch(const char** paths, int n, int frame_h, int frame_w,
                       float* out_frames, double* out_coms, int* out_status,
                       int num_threads) {
  parallel_for(n, num_threads, [&](int i) {
    decode_one_msra(paths[i], frame_h, frame_w,
                    out_frames + (size_t)i * frame_h * frame_w,
                    out_coms + (size_t)i * 3, out_status + i);
  });
}

// rgb: [n, h, w, 3] u8 (decoded PNG planes); out: [n, h, w] f32.
// Replicates (g/255*256 + b/255)*255 in float32 exactly.
void nyu_pack_batch(const uint8_t* rgb, int n, int h, int w, float* out,
                    int num_threads) {
  const size_t px = (size_t)h * w;
  parallel_for(n, num_threads, [&](int i) {
    const uint8_t* src = rgb + (size_t)i * px * 3;
    float* dst = out + (size_t)i * px;
    for (size_t p = 0; p < px; ++p) {
      const float g = (float)src[p * 3 + 1] / 255.0f;
      const float b = (float)src[p * 3 + 2] / 255.0f;
      dst[p] = (g * 256.0f + b) * 255.0f;
    }
  });
}

// raw16: [n, h, w] u16 (decoded 16-bit PNG); out: [n, h, w] f32.
// Replicates plt.imread*65535 float32 rounding: (x/65535)*65535 in f32.
void png16_scale_batch(const uint16_t* raw16, int n, int h, int w, float* out,
                       int num_threads) {
  const size_t px = (size_t)h * w;
  parallel_for(n, num_threads, [&](int i) {
    const uint16_t* src = raw16 + (size_t)i * px;
    float* dst = out + (size_t)i * px;
    for (size_t p = 0; p < px; ++p) {
      dst[p] = ((float)src[p] / 65535.0f) * 65535.0f;
    }
  });
}

}  // extern "C"
