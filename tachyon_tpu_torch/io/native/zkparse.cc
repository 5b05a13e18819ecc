// Native zkey/wtns parser: mmap + byte->word repacking.
//
// The port's copy of tachyon_tpu/io/native/zkparse.cc (the JAX package's
// mmap parser; reference: vendors/circom/circomlib/zkey/zkey.cc,
// wtns/wtns.h, base/files/memory_mapped_file.h), exposed as a plain C ABI
// consumed via ctypes (tachyon_tpu_torch/io/native.py).  The port stores a
// field element as 32-bit words, word axis leading, so it adds
// zk_gather_words beside the JAX package's 16-bit limb repacks; the
// pure-Python parse in io/zkey.py (native=False) is the correctness oracle.
//
// All readers bounds-check against the mmap size and return an error code
// on truncated/malicious inputs (a file-declared section size is untrusted).
//
// Built with g++ at first use by io/native.py.
#include <cstdint>
#include <cstring>
#include <cstdio>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

// true iff [off, off+len) lies inside the mapped region (overflow-safe).
inline bool in_bounds(uint64_t file_size, uint64_t off, uint64_t len) {
  return off <= file_size && len <= file_size - off;
}

}  // namespace

extern "C" {

struct MappedFile {
  const uint8_t* data;
  uint64_t size;
  int fd;
};

// Opens and maps a file read-only. Returns 0 on success.
int zk_mmap_open(const char* path, MappedFile* out) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return -2;
  }
  void* p = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (p == MAP_FAILED) {
    close(fd);
    return -3;
  }
  out->data = static_cast<const uint8_t*>(p);
  out->size = st.st_size;
  out->fd = fd;
  return 0;
}

void zk_mmap_close(MappedFile* f) {
  if (f->data) munmap(const_cast<uint8_t*>(f->data), f->size);
  if (f->fd >= 0) close(f->fd);
  f->data = nullptr;
  f->fd = -1;
}

// Locates a section (magic-framed container: magic u32, version u32,
// n_sections u32, then [type u32, size u64, payload]*).
// Returns payload offset or 0 if absent/malformed; size via out param.
// `occurrence` selects the k-th section of that type.  A section whose
// declared size runs past EOF is treated as absent (returns 0).
uint64_t zk_find_section(const MappedFile* f, uint32_t type,
                         uint32_t occurrence, uint64_t* size_out) {
  if (f->size < 12) return 0;
  uint32_t n_sections;
  memcpy(&n_sections, f->data + 8, 4);
  uint64_t off = 12;
  uint32_t seen = 0;
  for (uint32_t i = 0; i < n_sections && in_bounds(f->size, off, 12); ++i) {
    uint32_t t;
    uint64_t sz;
    memcpy(&t, f->data + off, 4);
    memcpy(&sz, f->data + off + 4, 8);
    off += 12;
    // The payload must fit inside the file; a lying header stops the scan.
    if (!in_bounds(f->size, off, sz)) return 0;
    if (t == type) {
      if (seen == occurrence) {
        *size_out = sz;
        return off;
      }
      ++seen;
    }
    off += sz;
  }
  return 0;
}

// Repacks n big-integer values of n8 bytes each (little-endian, contiguous
// at data+off) into 16-bit limbs stored in uint32, LIMB-MAJOR layout:
// out[l * n + i] = limb l of value i.  (This is the (L, n) device layout,
// so the arrays upload with zero further transformation.)
// Returns 0 on success, -1 if the source range exceeds the mapped file.
int zk_repack_limbs(const MappedFile* f, uint64_t off, uint64_t n,
                    uint32_t n8, uint32_t* out) {
  if (n8 == 0 || (n != 0 && n > f->size / n8) ||
      !in_bounds(f->size, off, n * (uint64_t)n8)) {
    return -1;
  }
  const uint8_t* src = f->data + off;
  uint32_t L = n8 / 2;
  for (uint64_t i = 0; i < n; ++i) {
    const uint8_t* v = src + i * n8;
    for (uint32_t l = 0; l < L; ++l) {
      out[(uint64_t)l * n + i] =
          (uint32_t)v[2 * l] | ((uint32_t)v[2 * l + 1] << 8);
    }
  }
  return 0;
}

// Strided variant for interleaved records (e.g. coefficient entries:
// stride bytes apart, value at +value_off).  Returns 0 on success, -1 on
// out-of-bounds.
int zk_repack_limbs_strided(const MappedFile* f, uint64_t off, uint64_t n,
                            uint32_t stride, uint32_t value_off, uint32_t n8,
                            uint32_t* out) {
  // last record's value bytes: off + (n-1)*stride + value_off + n8
  if (stride == 0 || (uint64_t)value_off + n8 > stride) return -1;
  if (n != 0 && ((n - 1) > (UINT64_MAX - value_off - n8) / stride ||
                 !in_bounds(f->size, off,
                            (n - 1) * (uint64_t)stride + value_off + n8))) {
    return -1;
  }
  const uint8_t* src = f->data + off;
  uint32_t L = n8 / 2;
  for (uint64_t i = 0; i < n; ++i) {
    const uint8_t* v = src + i * stride + value_off;
    for (uint32_t l = 0; l < L; ++l) {
      out[(uint64_t)l * n + i] =
          (uint32_t)v[2 * l] | ((uint32_t)v[2 * l + 1] << 8);
    }
  }
  return 0;
}

// Gathers u32 fields from strided records (coefficient matrix/constraint/
// signal columns).  Returns 0 on success, -1 on out-of-bounds.
int zk_gather_u32(const MappedFile* f, uint64_t off, uint64_t n,
                  uint32_t stride, uint32_t field_off, uint32_t* out) {
  if (stride == 0 || (uint64_t)field_off + 4 > stride) return -1;
  if (n != 0 && ((n - 1) > (UINT64_MAX - field_off - 4) / stride ||
                 !in_bounds(f->size, off,
                            (n - 1) * (uint64_t)stride + field_off + 4))) {
    return -1;
  }
  const uint8_t* src = f->data + off;
  for (uint64_t i = 0; i < n; ++i) {
    memcpy(&out[i], src + i * stride + field_off, 4);
  }
  return 0;
}

// Gathers n values of W little-endian 32-bit words from strided records
// (value i at off + i*stride + value_off) into WORD-MAJOR layout:
// out[w * n + i] = word w of value i, the port's (W, n) layout.  Points are
// contiguous values (stride = 4W, value_off = 0), coefficient entries
// interleaved ones.  Returns 0 on success, -1 on out-of-bounds.
int zk_gather_words(const MappedFile* f, uint64_t off, uint64_t n, uint32_t W,
                    uint32_t stride, uint32_t value_off, uint32_t* out) {
  uint64_t nbytes = 4 * (uint64_t)W;
  if (W == 0 || stride == 0 || (uint64_t)value_off + nbytes > stride) return -1;
  if (n != 0 && ((n - 1) > (UINT64_MAX - value_off - nbytes) / stride ||
                 !in_bounds(f->size, off,
                            (n - 1) * (uint64_t)stride + value_off + nbytes))) {
    return -1;
  }
  const uint8_t* src = f->data + off;
  for (uint64_t i = 0; i < n; ++i) {
    const uint8_t* v = src + i * stride + value_off;
    for (uint32_t w = 0; w < W; ++w) {
      memcpy(&out[(uint64_t)w * n + i], v + 4 * w, 4);
    }
  }
  return 0;
}

}  // extern "C"
