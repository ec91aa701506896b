// Native ENVI BSQ reader/writer for super_resolution_tpu.
//
// The counterpart of the reference's C++ data loader
// (src/hyperspectral/hyperspectral_data_loader.cpp:37-118): streamed binary
// reads of band-sequential float32 cubes with optional byte swapping, cropped
// reads (seek-based, never materializing the full cube), and multithreaded
// per-band decoding so multi-GB hyperspectral cubes saturate storage
// bandwidth while the host feeds the accelerator. Exposed to Python via a
// plain C ABI (ctypes; no pybind11 in this environment).
//
// Build: g++ -O3 -march=native -shared -fPIC -std=c++17 -pthread \
//        envi_loader.cpp -o libsr_envi.so

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

inline void SwapBytes32(uint32_t* data, size_t count) {
  for (size_t i = 0; i < count; ++i) {
#if defined(__GNUC__)
    data[i] = __builtin_bswap32(data[i]);
#else
    uint32_t v = data[i];
    data[i] = ((v & 0xFF) << 24) | ((v & 0xFF00) << 8) | ((v >> 8) & 0xFF00) |
              ((v >> 24) & 0xFF);
#endif
  }
}

// Reads the cropped region of one band into out (row-major [rows x cols] of
// the crop). Returns 0 on success.
int ReadBandCrop(const char* path, int64_t header_offset, int64_t rows,
                 int64_t cols, int64_t band, int64_t r0, int64_t r1,
                 int64_t c0, int64_t c1, bool big_endian, float* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  const int64_t crop_cols = c1 - c0;
  const int64_t band_offset = header_offset + band * rows * cols * 4;
  int status = 0;
  for (int64_t r = r0; r < r1; ++r) {
    const int64_t offset = band_offset + (r * cols + c0) * 4;
    if (std::fseek(f, static_cast<long>(offset), SEEK_SET) != 0) {
      status = 2;
      break;
    }
    float* dst = out + (r - r0) * crop_cols;
    if (std::fread(dst, 4, crop_cols, f) != static_cast<size_t>(crop_cols)) {
      status = 3;
      break;
    }
    if (big_endian) {
      SwapBytes32(reinterpret_cast<uint32_t*>(dst), crop_cols);
    }
  }
  std::fclose(f);
  return status;
}

}  // namespace

extern "C" {

// Reads a cropped [b1-b0, r1-r0, c1-c0] float32 sub-cube from a BSQ file into
// `out` (caller-allocated, C-contiguous). Bands are read by a thread pool.
// Returns 0 on success, nonzero error code otherwise.
int sr_envi_read_bsq(const char* path, int64_t header_offset, int64_t bands,
                     int64_t rows, int64_t cols, int64_t b0, int64_t b1,
                     int64_t r0, int64_t r1, int64_t c0, int64_t c1,
                     int big_endian, int num_threads, float* out) {
  if (b0 < 0 || b1 > bands || r0 < 0 || r1 > rows || c0 < 0 || c1 > cols ||
      b0 >= b1 || r0 >= r1 || c0 >= c1) {
    return 10;
  }
  const int64_t crop_bands = b1 - b0;
  const int64_t band_pixels = (r1 - r0) * (c1 - c0);
  if (num_threads < 1) num_threads = 1;
  if (num_threads > crop_bands) num_threads = static_cast<int>(crop_bands);

  std::vector<int> statuses(crop_bands, 0);
  std::vector<std::thread> workers;
  workers.reserve(num_threads);
  for (int t = 0; t < num_threads; ++t) {
    workers.emplace_back([&, t]() {
      for (int64_t i = t; i < crop_bands; i += num_threads) {
        statuses[i] = ReadBandCrop(path, header_offset, rows, cols, b0 + i, r0,
                                   r1, c0, c1, big_endian != 0,
                                   out + i * band_pixels);
      }
    });
  }
  for (auto& w : workers) w.join();
  for (int s : statuses) {
    if (s != 0) return s;
  }
  return 0;
}

// Writes a C-contiguous [bands, rows, cols] float32 cube as BSQ. Returns 0 on
// success.
int sr_envi_write_bsq(const char* path, int64_t bands, int64_t rows,
                      int64_t cols, int big_endian, const float* data) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return 1;
  const int64_t total = bands * rows * cols;
  int status = 0;
  if (big_endian) {
    constexpr int64_t kChunk = 1 << 20;
    std::vector<uint32_t> buffer(kChunk);
    for (int64_t i = 0; i < total; i += kChunk) {
      const int64_t n = (total - i < kChunk) ? (total - i) : kChunk;
      std::memcpy(buffer.data(), data + i, n * 4);
      SwapBytes32(buffer.data(), n);
      if (std::fwrite(buffer.data(), 4, n, f) != static_cast<size_t>(n)) {
        status = 3;
        break;
      }
    }
  } else {
    if (std::fwrite(data, 4, total, f) != static_cast<size_t>(total)) {
      status = 3;
    }
  }
  std::fclose(f);
  return status;
}

}  // extern "C"
