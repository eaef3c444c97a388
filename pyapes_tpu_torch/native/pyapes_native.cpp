// Native (C++) runtime components for pyapes-tpu.
//
// The device path is the CUDA kernels of csrc/; this library provides the
// host-side native tier:
//   * an independent double-precision reference implementation of the
//     per-axis coefficient-vector stencil (test oracle, complementing
//     numpy.gradient),
//   * a streaming binary field snapshot writer/reader with CRC32
//     integrity (checkpoint fast path: no compression, sequential IO).
//
// Exposed with a plain C ABI for ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------
// Reference stencil: out[i] = sum_axes ap[k]*x[i+e_k] + ac[k]*x[i]
//                                + am[k]*x[i-e_k]   (wrap-around)
// x: (n0 [, n1 [, n2]]) row-major f64; coefficient vectors per axis.
// ---------------------------------------------------------------------
void stencil_apply_ref(
    const double* x, double* out,
    const int64_t* dims, int ndim,
    const double* const* ap, const double* const* ac,
    const double* const* am) {
  int64_t n0 = dims[0];
  int64_t n1 = ndim > 1 ? dims[1] : 1;
  int64_t n2 = ndim > 2 ? dims[2] : 1;
  int64_t s0 = n1 * n2, s1 = n2;

  for (int64_t i = 0; i < n0; ++i) {
    int64_t ip = (i + 1) % n0, im = (i - 1 + n0) % n0;
    for (int64_t j = 0; j < n1; ++j) {
      int64_t jp = (j + 1) % n1, jm = (j - 1 + n1) % n1;
      for (int64_t k = 0; k < n2; ++k) {
        int64_t kp = (k + 1) % n2, km = (k - 1 + n2) % n2;
        int64_t c = i * s0 + j * s1 + k;
        double acc = ap[0][i] * x[ip * s0 + j * s1 + k] +
                     ac[0][i] * x[c] +
                     am[0][i] * x[im * s0 + j * s1 + k];
        if (ndim > 1) {
          acc += ap[1][j] * x[i * s0 + jp * s1 + k] +
                 ac[1][j] * x[c] +
                 am[1][j] * x[i * s0 + jm * s1 + k];
        }
        if (ndim > 2) {
          acc += ap[2][k] * x[i * s0 + j * s1 + kp] +
                 ac[2][k] * x[c] +
                 am[2][k] * x[i * s0 + j * s1 + km];
        }
        out[c] = acc;
      }
    }
  }
}

// ---------------------------------------------------------------------
// CRC32 (IEEE, table-driven)
// ---------------------------------------------------------------------
static uint32_t crc_table[256];
static bool crc_init_done = false;

static void crc_init() {
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int j = 0; j < 8; ++j)
      c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
    crc_table[i] = c;
  }
  crc_init_done = true;
}

uint32_t crc32_buf(const uint8_t* buf, uint64_t len, uint32_t seed) {
  if (!crc_init_done) crc_init();
  uint32_t c = seed ^ 0xFFFFFFFFu;
  for (uint64_t i = 0; i < len; ++i)
    c = crc_table[(c ^ buf[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

// ---------------------------------------------------------------------
// Snapshot IO: [magic u32][ndim i32][dims i64 x ndim][dtype i32 (4|8)]
//              [payload][crc32 u32]
// Returns 0 on success.
// ---------------------------------------------------------------------
static const uint32_t kMagic = 0x50594150;  // "PYAP"

int snapshot_write(const char* path, const void* data,
                   const int64_t* dims, int ndim, int itemsize) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  uint64_t n = 1;
  for (int i = 0; i < ndim; ++i) n *= (uint64_t)dims[i];
  uint64_t bytes = n * (uint64_t)itemsize;
  uint32_t crc = crc32_buf((const uint8_t*)data, bytes, 0);
  int32_t nd = ndim, isz = itemsize;
  bool ok = fwrite(&kMagic, 4, 1, f) == 1 && fwrite(&nd, 4, 1, f) == 1 &&
            fwrite(dims, 8, (size_t)ndim, f) == (size_t)ndim &&
            fwrite(&isz, 4, 1, f) == 1 &&
            fwrite(data, 1, bytes, f) == bytes &&
            fwrite(&crc, 4, 1, f) == 1;
  fclose(f);
  return ok ? 0 : -2;
}

// Reads header into dims/ndim/itemsize when data==nullptr; reads payload
// (validating CRC) otherwise. Returns 0 ok, -3 bad magic, -4 bad crc.
int snapshot_read(const char* path, void* data, int64_t* dims,
                  int32_t* ndim, int32_t* itemsize) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  uint32_t magic = 0;
  if (fread(&magic, 4, 1, f) != 1 || magic != kMagic) {
    fclose(f);
    return -3;
  }
  int32_t nd = 0, isz = 0;
  if (fread(&nd, 4, 1, f) != 1 || nd < 1 || nd > 8) { fclose(f); return -2; }
  if (fread(dims, 8, (size_t)nd, f) != (size_t)nd) { fclose(f); return -2; }
  if (fread(&isz, 4, 1, f) != 1) { fclose(f); return -2; }
  *ndim = nd;
  *itemsize = isz;
  if (data == nullptr) {
    fclose(f);
    return 0;
  }
  uint64_t n = 1;
  for (int i = 0; i < nd; ++i) n *= (uint64_t)dims[i];
  uint64_t bytes = n * (uint64_t)isz;
  if (fread(data, 1, bytes, f) != bytes) { fclose(f); return -2; }
  uint32_t crc_file = 0;
  if (fread(&crc_file, 4, 1, f) != 1) { fclose(f); return -2; }
  fclose(f);
  uint32_t crc = crc32_buf((const uint8_t*)data, bytes, 0);
  return crc == crc_file ? 0 : -4;
}

// ---------------------------------------------------------------------
// Legacy-VTK rectilinear-grid writer (binary, big-endian — the legacy
// format's required byte order). Point data is written x-fastest as VTK
// expects; the input fields are C-order (x slowest), so the inner loop
// strides. One call writes the coordinates and all fields.
// Returns 0 on success.
// ---------------------------------------------------------------------
static inline uint32_t swap_be(float v) {
  uint32_t u;
  std::memcpy(&u, &v, 4);
  return (u >> 24) | ((u >> 8) & 0xFF00u) | ((u << 8) & 0xFF0000u)
         | (u << 24);
}

static bool write_be_floats(FILE* f, const float* v, uint64_t n) {
  const uint64_t kChunk = 1 << 16;
  static thread_local uint32_t buf[1 << 16];
  for (uint64_t off = 0; off < n; off += kChunk) {
    uint64_t m = n - off < kChunk ? n - off : kChunk;
    for (uint64_t i = 0; i < m; ++i) buf[i] = swap_be(v[off + i]);
    if (fwrite(buf, 4, m, f) != m) return false;
  }
  return true;
}

int vtk_write_rectilinear(
    const char* path,
    const float* xc, int64_t nx,
    const float* yc, int64_t ny,
    const float* zc, int64_t nz,
    const char** names, const float** fields, int nfields) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  fprintf(f, "# vtk DataFile Version 3.0\n");
  fprintf(f, "pyapes_tpu export\n");
  fprintf(f, "BINARY\n");
  fprintf(f, "DATASET RECTILINEAR_GRID\n");
  fprintf(f, "DIMENSIONS %lld %lld %lld\n",
          (long long)nx, (long long)ny, (long long)nz);
  fprintf(f, "X_COORDINATES %lld float\n", (long long)nx);
  if (!write_be_floats(f, xc, (uint64_t)nx)) { fclose(f); return -2; }
  fprintf(f, "\nY_COORDINATES %lld float\n", (long long)ny);
  if (!write_be_floats(f, yc, (uint64_t)ny)) { fclose(f); return -2; }
  fprintf(f, "\nZ_COORDINATES %lld float\n", (long long)nz);
  if (!write_be_floats(f, zc, (uint64_t)nz)) { fclose(f); return -2; }
  uint64_t npts = (uint64_t)nx * (uint64_t)ny * (uint64_t)nz;
  fprintf(f, "\nPOINT_DATA %llu\n", (unsigned long long)npts);
  int64_t s0 = ny * nz, s1 = nz;
  std::vector<float> row((size_t)nx);
  for (int q = 0; q < nfields; ++q) {
    fprintf(f, "SCALARS %s float 1\n", names[q]);
    fprintf(f, "LOOKUP_TABLE default\n");
    const float* d = fields[q];
    for (int64_t k = 0; k < nz; ++k)
      for (int64_t j = 0; j < ny; ++j) {
        for (int64_t i = 0; i < nx; ++i) row[(size_t)i] = d[i * s0 + j * s1 + k];
        if (!write_be_floats(f, row.data(), (uint64_t)nx)) {
          fclose(f);
          return -2;
        }
      }
    fprintf(f, "\n");
  }
  fclose(f);
  return 0;
}

}  // extern "C"
