// Native volume.npz reader for the slice store's ingest.
//
// The PyTorch port's copy of mri_acl_imagesegmentation_adsp_tpu/native/
// npz_loader.cc, the code unchanged. data/hbm_loader.py loads each packed
// volume once when it builds the store; this loader takes the Python and
// zipfile overhead out of that: a minimal ZIP (+deflate, zlib) reader with
// an npy v1/v2 header parser, exposed through a C ABI that native/loader.py
// binds with ctypes. Python releases the GIL during the calls, so a thread
// pool inflates in parallel on a host with several cores.
//
// Supported layout: the archives data/packer.py writes (np.savez /
// np.savez_compressed): stored (method 0) or deflated (method 8) members,
// npy dtypes f4 (img) and u1/i1..i8 (msk), C-order.
//
// Build (native/_build.py, into build/native/ at the checkout's root):
//   g++ -O3 -shared -fPIC -pthread npz_loader.cc -lz -o libnpzloader.so

#include <zlib.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Member {
  std::string name;
  uint16_t method = 0;
  uint64_t comp_size = 0;
  uint64_t raw_size = 0;
  uint64_t header_offset = 0;  // local file header offset
};

struct Archive {
  std::vector<uint8_t> file;
  std::vector<Member> members;
};

bool read_file(const char* path, std::vector<uint8_t>* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  out->resize(static_cast<size_t>(n));
  size_t got = std::fread(out->data(), 1, out->size(), f);
  std::fclose(f);
  return got == out->size();
}

uint16_t rd16(const uint8_t* p) { return p[0] | (p[1] << 8); }
uint32_t rd32(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | (uint32_t(p[3]) << 24);
}

// Locate the end-of-central-directory record and walk the central directory.
bool parse_central_dir(Archive* ar) {
  const auto& f = ar->file;
  if (f.size() < 22) return false;
  size_t eocd = std::string::npos;
  size_t scan_from = f.size() >= 22 + 65536 ? f.size() - 22 - 65536 : 0;
  for (size_t i = f.size() - 22 + 1; i-- > scan_from;) {
    if (rd32(&f[i]) == 0x06054b50) { eocd = i; break; }
  }
  if (eocd == std::string::npos) return false;
  uint16_t n_entries = rd16(&f[eocd + 10]);
  uint32_t cd_offset = rd32(&f[eocd + 16]);

  size_t p = cd_offset;
  for (uint16_t e = 0; e < n_entries; ++e) {
    if (p + 46 > f.size() || rd32(&f[p]) != 0x02014b50) return false;
    Member m;
    m.method = rd16(&f[p + 10]);
    m.comp_size = rd32(&f[p + 20]);
    m.raw_size = rd32(&f[p + 24]);
    uint16_t name_len = rd16(&f[p + 28]);
    uint16_t extra_len = rd16(&f[p + 30]);
    uint16_t comment_len = rd16(&f[p + 32]);
    m.header_offset = rd32(&f[p + 42]);
    m.name.assign(reinterpret_cast<const char*>(&f[p + 46]), name_len);
    ar->members.push_back(std::move(m));
    p += 46 + name_len + extra_len + comment_len;
  }
  return true;
}

// Decompress (or copy) one member's payload.
bool extract(const Archive& ar, const Member& m, std::vector<uint8_t>* out) {
  const auto& f = ar.file;
  size_t p = m.header_offset;
  if (p + 30 > f.size() || rd32(&f[p]) != 0x04034b50) return false;
  uint16_t name_len = rd16(&f[p + 26]);
  uint16_t extra_len = rd16(&f[p + 28]);
  size_t data = p + 30 + name_len + extra_len;
  if (data + m.comp_size > f.size()) return false;

  out->resize(m.raw_size);
  if (m.method == 0) {
    std::memcpy(out->data(), &f[data], m.raw_size);
    return true;
  }
  if (m.method != 8) return false;
  z_stream zs{};
  if (inflateInit2(&zs, -MAX_WBITS) != Z_OK) return false;  // raw deflate
  zs.next_in = const_cast<Bytef*>(&f[data]);
  zs.avail_in = static_cast<uInt>(m.comp_size);
  zs.next_out = out->data();
  zs.avail_out = static_cast<uInt>(out->size());
  int rc = inflate(&zs, Z_FINISH);
  inflateEnd(&zs);
  return rc == Z_STREAM_END;
}

// Parse an npy v1/v2 header: dtype char+size, fortran flag, shape.
struct NpyInfo {
  char kind = '?';       // 'f', 'u', 'i'
  int itemsize = 0;
  bool fortran = false;
  std::vector<int64_t> shape;
  size_t data_offset = 0;
};

bool parse_npy(const std::vector<uint8_t>& buf, NpyInfo* info) {
  if (buf.size() < 10 || std::memcmp(buf.data(), "\x93NUMPY", 6) != 0)
    return false;
  uint8_t major = buf[6];
  size_t header_len, header_start;
  if (major == 1) {
    header_len = rd16(&buf[8]);
    header_start = 10;
  } else {
    header_len = rd32(&buf[8]);
    header_start = 12;
  }
  if (header_start + header_len > buf.size()) return false;
  std::string hdr(reinterpret_cast<const char*>(&buf[header_start]),
                  header_len);
  info->data_offset = header_start + header_len;

  size_t dpos = hdr.find("'descr'");
  if (dpos == std::string::npos) return false;
  size_t q1 = hdr.find('\'', dpos + 7);
  size_t q2 = hdr.find('\'', q1 + 1);
  std::string descr = hdr.substr(q1 + 1, q2 - q1 - 1);  // e.g. "<f4", "|u1"
  if (descr.size() < 3) return false;
  info->kind = descr[1];
  info->itemsize = std::atoi(descr.c_str() + 2);

  info->fortran = hdr.find("'fortran_order': True") != std::string::npos;

  size_t spos = hdr.find("'shape':");
  if (spos == std::string::npos) return false;
  size_t o = hdr.find('(', spos);
  size_t c = hdr.find(')', o);
  std::string dims = hdr.substr(o + 1, c - o - 1);
  int64_t cur = -1;
  for (char ch : dims) {
    if (ch >= '0' && ch <= '9') {
      cur = (cur < 0 ? 0 : cur) * 10 + (ch - '0');
    } else if (cur >= 0) {
      info->shape.push_back(cur);
      cur = -1;
    }
  }
  if (cur >= 0) info->shape.push_back(cur);
  return true;
}

const Member* find_member(const Archive& ar, const char* name) {
  for (const auto& m : ar.members)
    if (m.name == name) return &m;
  return nullptr;
}

}  // namespace

extern "C" {

// Probe member shapes: fills shape[8], returns ndim, or -1 on error.
int npz_probe(const char* path, const char* member, int64_t* shape,
              int* itemsize, char* kind) {
  Archive ar;
  if (!read_file(path, &ar.file) || !parse_central_dir(&ar)) return -1;
  const Member* m = find_member(ar, member);
  if (!m) return -1;
  std::vector<uint8_t> buf;
  if (!extract(ar, *m, &buf)) return -1;
  NpyInfo info;
  if (!parse_npy(buf, &info) || info.fortran) return -1;
  for (size_t i = 0; i < info.shape.size() && i < 8; ++i)
    shape[i] = info.shape[i];
  *itemsize = info.itemsize;
  *kind = info.kind;
  return static_cast<int>(info.shape.size());
}

// Load one member's raw data into out (caller-sized). Returns 0 / -1.
int npz_load(const char* path, const char* member, void* out,
             int64_t out_bytes) {
  Archive ar;
  if (!read_file(path, &ar.file) || !parse_central_dir(&ar)) return -1;
  const Member* m = find_member(ar, member);
  if (!m) return -1;
  std::vector<uint8_t> buf;
  if (!extract(ar, *m, &buf)) return -1;
  NpyInfo info;
  if (!parse_npy(buf, &info) || info.fortran) return -1;
  int64_t n = static_cast<int64_t>(buf.size() - info.data_offset);
  if (n != out_bytes) return -1;
  std::memcpy(out, buf.data() + info.data_offset, n);
  return 0;
}

// Fused volume load: one file read + one inflate per member. Fills
// malloc'd buffers the caller must release with npz_free. Returns 0 / -1.
int npz_load_volume(const char* path,
                    void** img_data, int64_t* img_shape, int* img_ndim,
                    int* img_itemsize, char* img_kind,
                    void** msk_data, int64_t* msk_shape, int* msk_ndim,
                    int* msk_itemsize, char* msk_kind) {
  Archive ar;
  if (!read_file(path, &ar.file) || !parse_central_dir(&ar)) return -1;

  struct Out {
    const char* name;
    void** data;
    int64_t* shape;
    int* ndim;
    int* itemsize;
    char* kind;
  } outs[2] = {
      {"img.npy", img_data, img_shape, img_ndim, img_itemsize, img_kind},
      {"msk.npy", msk_data, msk_shape, msk_ndim, msk_itemsize, msk_kind},
  };
  *img_data = nullptr;
  *msk_data = nullptr;
  for (auto& o : outs) {
    const Member* m = find_member(ar, o.name);
    if (!m) return -1;
    std::vector<uint8_t> buf;
    if (!extract(ar, *m, &buf)) return -1;
    NpyInfo info;
    if (!parse_npy(buf, &info) || info.fortran) return -1;
    size_t n = buf.size() - info.data_offset;
    void* p = std::malloc(n);
    if (!p) return -1;
    std::memcpy(p, buf.data() + info.data_offset, n);
    *o.data = p;
    for (size_t i = 0; i < info.shape.size() && i < 8; ++i)
      o.shape[i] = info.shape[i];
    *o.ndim = static_cast<int>(info.shape.size());
    *o.itemsize = info.itemsize;
    *o.kind = info.kind;
  }
  return 0;
}

void npz_free(void* p) { std::free(p); }

}  // extern "C"

// ---------------------------------------------------------------------------
// Multi-threaded readahead: load many volume.npz archives in parallel with a
// native thread pool (no Python threads, no GIL round-trips between files).
// ---------------------------------------------------------------------------

#include <atomic>
#include <thread>

extern "C" {

struct VolumeOut {
  void* img_data;
  int64_t img_shape[8];
  int32_t img_ndim;
  int32_t img_itemsize;
  char img_kind;
  void* msk_data;
  int64_t msk_shape[8];
  int32_t msk_ndim;
  int32_t msk_itemsize;
  char msk_kind;
  int32_t rc;
};

// Load n archives with `threads` native workers pulling from a shared
// queue. Per-volume status lands in outs[i].rc (0 ok / -1 failed; failed
// entries have null data pointers). Returns 0.
int npz_load_volumes(const char** paths, int32_t n, int32_t threads,
                     VolumeOut* outs) {
  std::atomic<int32_t> next{0};
  auto work = [&]() {
    for (;;) {
      int32_t i = next.fetch_add(1);
      if (i >= n) return;
      VolumeOut& o = outs[i];
      o.img_data = nullptr;
      o.msk_data = nullptr;
      o.rc = npz_load_volume(paths[i], &o.img_data, o.img_shape, &o.img_ndim,
                             &o.img_itemsize, &o.img_kind, &o.msk_data,
                             o.msk_shape, &o.msk_ndim, &o.msk_itemsize,
                             &o.msk_kind);
    }
  };
  int32_t t = threads < 1 ? 1 : threads;
  if (t > n) t = n;
  std::vector<std::thread> pool;
  for (int32_t i = 1; i < t; ++i) pool.emplace_back(work);
  work();
  for (auto& th : pool) th.join();
  return 0;
}

}  // extern "C"
