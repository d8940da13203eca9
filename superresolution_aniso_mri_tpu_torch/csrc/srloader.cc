// srloader: native data-loader runtime of the PyTorch port (the JAX
// package's native/srloader.cc, the same code).
//
// The reference feeds its trainers through torch's native DataLoader
// machinery (C++ worker pool under datasets/* Dataset classes). This is
// the framework's own native equivalent: a small C++ runtime for the
// host-side data path —
//   * NIfTI-1 (.nii / .nii.gz) decode straight to float32 via zlib
//     (reference ingest: datasets/common.py:209-241 read_nifty),
//   * a thread-pool directory ingest (N volumes decoded in parallel),
//   * a threaded channel-interleaving gather that assembles
//     [B, H, W, C] triplet batches from per-slice pointers (the memcpy
//     half of datasets/common_brains.py:241-267 __getitem__ +
//     default_collate; index RNG stays in Python for seed parity).
//
// Exposed through a plain C ABI for ctypes
// (superresolution_aniso_mri_tpu_torch/data/native_loader.py); the Python
// implementations remain as the behavioural reference and fallback.
//
// Built at first use by ops/_build.py into the package's _build/
// (g++ -O3 -std=c++17 -fPIC -Wall -Wextra -shared srloader.cc -lz -pthread)

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <exception>
#include <new>
#include <string>
#include <thread>
#include <vector>

#include <zlib.h>

extern "C" {

typedef struct {
  int32_t ndim;       // number of dims (1..7)
  int32_t sform;      // 1 when affine[] is valid (sform_code > 0)
  int64_t dims[8];    // shape in [z, y, x]-style reversed order
  double spacing[3];  // (z, y, x) — pixdim[1..3] reversed, like
                      // GetSpacing()[::-1] in the Python reader
  double affine[12];  // srow_x/y/z rows (3 x 4)
  float* data;        // C-contiguous float32, reversed-dim order
  int64_t count;      // total element count
  char err[256];      // non-empty on failure
} SrlImage;

int srl_version(void) { return 1; }

static void set_err(SrlImage* im, const char* path, const char* msg) {
  snprintf(im->err, sizeof(im->err), "%s: %s", path, msg);
}

static inline uint16_t bswap16(uint16_t v) { return __builtin_bswap16(v); }
static inline uint32_t bswap32(uint32_t v) { return __builtin_bswap32(v); }
static inline uint64_t bswap64(uint64_t v) { return __builtin_bswap64(v); }

static int16_t rd_i16(const unsigned char* p, bool swap) {
  uint16_t v;
  memcpy(&v, p, 2);
  if (swap) v = bswap16(v);
  int16_t out;
  memcpy(&out, &v, 2);
  return out;
}

static int32_t rd_i32(const unsigned char* p, bool swap) {
  uint32_t v;
  memcpy(&v, p, 4);
  if (swap) v = bswap32(v);
  int32_t out;
  memcpy(&out, &v, 4);
  return out;
}

static float rd_f32(const unsigned char* p, bool swap) {
  uint32_t v;
  memcpy(&v, p, 4);
  if (swap) v = bswap32(v);
  float out;
  memcpy(&out, &v, 4);
  return out;
}

// Convert a raw NIfTI voxel buffer to float32 (with byte swap when the
// header is opposite-endian). `code` is the NIfTI datatype code.
static bool convert_to_f32(const unsigned char* raw, int64_t n, int code,
                           bool swap, float* out) {
  switch (code) {
    case 2: {  // uint8
      for (int64_t i = 0; i < n; ++i) out[i] = (float)raw[i];
      return true;
    }
    case 256: {  // int8
      const int8_t* p = (const int8_t*)raw;
      for (int64_t i = 0; i < n; ++i) out[i] = (float)p[i];
      return true;
    }
    case 4: {  // int16
      for (int64_t i = 0; i < n; ++i)
        out[i] = (float)rd_i16(raw + 2 * i, swap);
      return true;
    }
    case 512: {  // uint16
      for (int64_t i = 0; i < n; ++i) {
        uint16_t v;
        memcpy(&v, raw + 2 * i, 2);
        if (swap) v = bswap16(v);
        out[i] = (float)v;
      }
      return true;
    }
    case 8: {  // int32
      for (int64_t i = 0; i < n; ++i)
        out[i] = (float)rd_i32(raw + 4 * i, swap);
      return true;
    }
    case 768: {  // uint32
      for (int64_t i = 0; i < n; ++i) {
        uint32_t v;
        memcpy(&v, raw + 4 * i, 4);
        if (swap) v = bswap32(v);
        out[i] = (float)v;
      }
      return true;
    }
    case 1024: {  // int64
      for (int64_t i = 0; i < n; ++i) {
        uint64_t v;
        memcpy(&v, raw + 8 * i, 8);
        if (swap) v = bswap64(v);
        int64_t s;
        memcpy(&s, &v, 8);
        out[i] = (float)s;
      }
      return true;
    }
    case 16: {  // float32
      if (!swap) {
        memcpy(out, raw, (size_t)n * 4);
      } else {
        for (int64_t i = 0; i < n; ++i) out[i] = rd_f32(raw + 4 * i, true);
      }
      return true;
    }
    case 64: {  // float64
      for (int64_t i = 0; i < n; ++i) {
        uint64_t v;
        memcpy(&v, raw + 8 * i, 8);
        if (swap) v = bswap64(v);
        double d;
        memcpy(&d, &v, 8);
        out[i] = (float)d;
      }
      return true;
    }
    default:
      return false;
  }
}

static int dtype_size(int code) {
  switch (code) {
    case 2: case 256: return 1;
    case 4: case 512: return 2;
    case 8: case 768: case 16: return 4;
    case 1024: case 64: return 8;
    default: return 0;
  }
}

// Read a whole (possibly gzipped) file. gzread transparently handles
// uncompressed files too, so one path serves .nii and .nii.gz.
static bool read_all(const char* path, std::vector<unsigned char>& buf) {
  gzFile f = gzopen(path, "rb");
  if (!f) return false;
  const size_t chunk = 1 << 22;  // 4 MiB
  size_t size = 0;
  for (;;) {
    buf.resize(size + chunk);
    int got = gzread(f, buf.data() + size, (unsigned)chunk);
    if (got < 0) {
      gzclose(f);
      return false;
    }
    size += (size_t)got;
    if ((size_t)got < chunk) break;
  }
  buf.resize(size);
  gzclose(f);
  return true;
}

// Decode one NIfTI-1 file into a fresh SrlImage. Mirrors
// superresolution_aniso_mri_tpu/utils/nifti.py read_nifti exactly,
// except the voxel payload always lands as float32.
static SrlImage* read_nifti_impl(const char* path) {
  SrlImage* im = new SrlImage();
  memset(im, 0, sizeof(SrlImage));

  std::vector<unsigned char> buf;
  if (!read_all(path, buf)) {
    set_err(im, path, "cannot open/read");
    return im;
  }
  if (buf.size() < 352) {
    set_err(im, path, "truncated NIfTI header");
    return im;
  }
  const unsigned char* h = buf.data();
  bool swap = false;
  int32_t sizeof_hdr = rd_i32(h, false);
  if (sizeof_hdr != 348) {
    swap = true;
    sizeof_hdr = rd_i32(h, true);
    if (sizeof_hdr != 348) {
      set_err(im, path, "not a NIfTI-1 file");
      return im;
    }
  }
  int16_t dim[8];
  for (int i = 0; i < 8; ++i) dim[i] = rd_i16(h + 40 + 2 * i, swap);
  int16_t datatype = rd_i16(h + 70, swap);
  float pixdim[8];
  for (int i = 0; i < 8; ++i) pixdim[i] = rd_f32(h + 76 + 4 * i, swap);
  float vox_offset = rd_f32(h + 108, swap);
  float scl_slope = rd_f32(h + 112, swap);
  float scl_inter = rd_f32(h + 116, swap);
  int16_t sform_code = rd_i16(h + 254, swap);

  int ndim = dim[0];
  if (ndim < 1 || ndim > 7) {
    set_err(im, path, "bad dim[0]");
    return im;
  }
  int isz = dtype_size(datatype);
  if (isz == 0) {
    set_err(im, path, "unsupported NIfTI datatype");
    return im;
  }
  int64_t count = 1;
  const int64_t max_count = ((int64_t)1 << 40);  // 1 Ti elements: far
  // beyond any real volume; also guards count*isz against overflow
  for (int i = 0; i < ndim; ++i) {
    int64_t d = dim[i + 1] > 0 ? dim[i + 1] : 1;
    if (d > 0 && count > max_count / d) {
      set_err(im, path, "implausible NIfTI dims (overflow)");
      return im;
    }
    count *= d;
    im->dims[ndim - 1 - i] = d;  // reversed → [z, y, x]
  }
  // reject implausible offsets BEFORE the float→size_t cast: converting
  // an out-of-range float to an integer type is undefined behavior
  if (!(vox_offset >= 0.0f) || vox_offset > (float)buf.size()) {
    set_err(im, path, "implausible NIfTI vox_offset");
    return im;
  }
  size_t offset = vox_offset >= 348.0f ? (size_t)(vox_offset + 0.5f) : 352;
  if (buf.size() < offset + (size_t)count * isz) {
    set_err(im, path, "truncated NIfTI payload");
    return im;
  }

  im->ndim = ndim;
  im->count = count;
  im->data = new float[count];
  if (!convert_to_f32(buf.data() + offset, count, datatype, swap,
                      im->data)) {
    delete[] im->data;
    im->data = nullptr;
    set_err(im, path, "unsupported NIfTI datatype");
    return im;
  }
  // scl_slope/inter like the Python reader: non-finite means "no
  // scaling" (uninitialized headers commonly carry NaN — multiplying
  // would silently NaN the whole volume); identity (0 or 1, 0) applies
  // nothing; anything else rescales
  if (!std::isfinite(scl_slope)) scl_slope = 1.0f;
  if (!std::isfinite(scl_inter)) scl_inter = 0.0f;
  // NIfTI-1: slope == 0 means NO scaling (inter included) — mirror the
  // Python reader exactly
  if (scl_slope != 0.0f && (scl_slope != 1.0f || scl_inter != 0.0f)) {
    float s = scl_slope;
    for (int64_t i = 0; i < count; ++i)
      im->data[i] = im->data[i] * s + scl_inter;
  }
  // spacing: pixdim[1..min(3,ndim)] padded with 1.0 to length 3, then
  // reversed to (z, y, x) — exactly the Python reader's
  // spacing_xyz-pad-then-[::-1]
  int nsp = ndim < 3 ? ndim : 3;
  for (int i = 0; i < 3; ++i) im->spacing[i] = 1.0;
  for (int i = 0; i < nsp; ++i)
    im->spacing[2 - i] = pixdim[i + 1] > 0.0f ? (double)pixdim[i + 1] : 1.0;
  im->sform = sform_code > 0 ? 1 : 0;
  if (im->sform) {
    for (int i = 0; i < 12; ++i)
      im->affine[i] = (double)rd_f32(h + 280 + 4 * i, swap);
  }
  return im;
}

// Exception firewall at the C ABI: a std::bad_alloc from new float[]
// or read_all's buf.resize must NOT cross extern "C" into ctypes
// (undefined behavior) nor escape srl_read_nifti_many's std::thread
// lambda (guaranteed std::terminate → SIGABRT kills the whole trainer).
// Failures become an err-tagged image the Python side raises as
// IOError — matching the pure-Python reader's catchable MemoryError —
// or, when even the 300-byte SrlImage can't be allocated, a nullptr
// (the binding treats NULL as a decode failure too).
SrlImage* srl_read_nifti(const char* path) {
  try {
    return read_nifti_impl(path);
  } catch (const std::exception& e) {
    SrlImage* im = new (std::nothrow) SrlImage();
    if (!im) return nullptr;
    memset(im, 0, sizeof(SrlImage));
    set_err(im, path, e.what());
    return im;
  } catch (...) {
    SrlImage* im = new (std::nothrow) SrlImage();
    if (!im) return nullptr;
    memset(im, 0, sizeof(SrlImage));
    set_err(im, path, "unknown native decode error");
    return im;
  }
}

void srl_free_image(SrlImage* im) {
  if (!im) return;
  delete[] im->data;
  delete im;
}

// Parallel multi-file ingest: decode n files across a worker pool.
// out[i] receives the SrlImage for paths[i] (check per-image err).
// Returns the number of failed decodes.
int srl_read_nifti_many(const char** paths, int n, SrlImage** out,
                        int nthreads) {
  if (n <= 0) return 0;
  if (nthreads <= 0) nthreads = (int)std::thread::hardware_concurrency();
  if (nthreads <= 0) nthreads = 1;  // hardware_concurrency may return 0
  if (nthreads > n) nthreads = n;
  std::atomic<int> next(0), failures(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      out[i] = srl_read_nifti(paths[i]);  // never throws (see firewall)
      if (!out[i] || out[i]->err[0]) failures.fetch_add(1);
    }
  };
  std::vector<std::thread> pool;
  try {
    // reserve() allocates and can itself throw bad_alloc under the very
    // memory exhaustion this firewall exists for — keep it inside
    pool.reserve(nthreads);
    for (int t = 0; t < nthreads; ++t) pool.emplace_back(worker);
  } catch (...) {
    // thread creation failed (resource exhaustion): letting the
    // exception cross the C ABI is UB, and destroying a vector holding
    // joinable threads is std::terminate — drain the remaining work on
    // the calling thread instead, then join whatever was spawned
    worker();
  }
  for (auto& t : pool) t.join();
  return failures.load();
}

// Assemble a [B, H*W, C] channel-interleaved batch from B*C per-slice
// pointers (each a contiguous H*W float32 plane): the native version of
//   np.stack([img[s_from], img[s_to], img[between], ...], axis=-1)
// for every item of the batch, threaded over items.
void srl_gather(const float** ptrs, int b, int c, int64_t hw, float* out,
                int nthreads) {
  if (b <= 0 || c <= 0 || hw <= 0) return;
  if (nthreads <= 0) nthreads = (int)std::thread::hardware_concurrency();
  if (nthreads <= 0) nthreads = 1;  // hardware_concurrency may return 0
  if (nthreads > b) nthreads = b;
  std::atomic<int> next(0);
  auto worker = [&]() {
    for (;;) {
      int item = next.fetch_add(1);
      if (item >= b) return;
      const float** src = ptrs + (size_t)item * c;
      float* dst = out + (size_t)item * hw * c;
      for (int64_t p = 0; p < hw; ++p) {
        float* row = dst + p * c;
        for (int ch = 0; ch < c; ++ch) row[ch] = src[ch][p];
      }
    }
  };
  std::vector<std::thread> pool;
  try {
    pool.reserve(nthreads);  // allocates — inside the firewall too
    for (int t = 0; t < nthreads; ++t) pool.emplace_back(worker);
  } catch (...) {
    worker();  // same firewall as srl_read_nifti_many
  }
  for (auto& t : pool) t.join();
}

}  // extern "C"
