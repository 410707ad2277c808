// Native HDF5 slab reader: parallel chunk decompression for fastMRI-style
// raw k-space files.
//
// The PyTorch port's copy of mri_acl_imagesegmentation_adsp_tpu/native/
// h5_reader.cc, the code unchanged. Readers of fastMRI files (the .h5
// adapters read kspace[slice] and whole volumes) spend their time
// inflating gzip chunks, and h5py serializes every HDF5 call behind one
// global lock, so a reader thread pool built on h5py decompresses one chunk
// at a time however many cores the host has.
//
// Design: libhdf5 is used ONLY for a short, mutex-guarded metadata pass
// (shape, dtype size, chunk dims, filter pipeline, and the chunk
// address/size table via H5Dget_num_chunks/H5Dget_chunk_info). The hot path
// never enters libhdf5: raw chunks are fetched with plain pread(2) --
// thread-safe on a shared fd -- inflated with zlib, byte-unshuffled when the
// shuffle filter is present, and scattered into the caller's row-major
// buffer by a C++ thread pool. Only chunks intersecting the requested slab
// are read at all.
//
// The library is resolved at run time with dlopen, so the build needs no
// HDF5 headers: the minimal 1.10/1.14-stable C-API surface is declared
// below. RTLD_LOCAL keeps this copy's global state away from h5py's bundled
// libhdf5 in the same process. Where no system libhdf5 exists, h5n_init
// fails and the Python wrapper (native/h5loader.py) falls back to h5py.
//
// Scope (anything else returns nonzero and the Python wrapper falls back to
// h5py): little-endian fixed-size elements, contiguous or chunked layout,
// filter pipeline a subset of {shuffle, deflate}. The pool is capped at the
// host's hardware concurrency: more concurrent inflates than cores only
// slow each one down.

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cstdlib>

#include <atomic>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <dlfcn.h>
#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>
#include <zlib.h>

namespace {

// ---------------------------------------------------------------------------
// Minimal HDF5 C API (types stable across 1.10 / 1.14)
// ---------------------------------------------------------------------------

typedef int64_t hid_t;
typedef int herr_t;
typedef unsigned long long hsize_t;
typedef unsigned long long haddr_t;
typedef int H5Z_filter_t;

constexpr unsigned kH5F_ACC_RDONLY = 0u;
constexpr hid_t kH5P_DEFAULT = 0;
constexpr hid_t kH5S_ALL = 0;
constexpr int kH5D_CONTIGUOUS = 1;
constexpr int kH5D_CHUNKED = 2;
constexpr int kH5T_ORDER_LE = 0;
constexpr H5Z_filter_t kFILTER_DEFLATE = 1;
constexpr H5Z_filter_t kFILTER_SHUFFLE = 2;

struct H5Api {
  herr_t (*H5open)();
  herr_t (*H5Eset_auto2)(hid_t, void *, void *);
  hid_t (*H5Fopen)(const char *, unsigned, hid_t);
  herr_t (*H5Fclose)(hid_t);
  hid_t (*H5Dopen2)(hid_t, const char *, hid_t);
  herr_t (*H5Dclose)(hid_t);
  hid_t (*H5Dget_space)(hid_t);
  hid_t (*H5Dget_type)(hid_t);
  hid_t (*H5Dget_create_plist)(hid_t);
  haddr_t (*H5Dget_offset)(hid_t);
  herr_t (*H5Dget_num_chunks)(hid_t, hid_t, hsize_t *);
  herr_t (*H5Dget_chunk_info)(hid_t, hid_t, hsize_t, hsize_t *, unsigned *,
                              haddr_t *, hsize_t *);
  int (*H5Sget_simple_extent_ndims)(hid_t);
  int (*H5Sget_simple_extent_dims)(hid_t, hsize_t *, hsize_t *);
  herr_t (*H5Sclose)(hid_t);
  size_t (*H5Tget_size)(hid_t);
  int (*H5Tget_order)(hid_t);
  herr_t (*H5Tclose)(hid_t);
  int (*H5Pget_layout)(hid_t);
  int (*H5Pget_chunk)(hid_t, int, hsize_t *);
  int (*H5Pget_nfilters)(hid_t);
  H5Z_filter_t (*H5Pget_filter2)(hid_t, unsigned, unsigned *, size_t *,
                                 unsigned *, size_t, char *, unsigned *);
  herr_t (*H5Pclose)(hid_t);
};

H5Api g_api;
bool g_api_ready = false;
// libhdf5 (serial build) is not thread-safe; every metadata pass holds this.
std::mutex g_h5_mutex;

template <typename T>
bool resolve(void *handle, const char *name, T *fn) {
  *fn = reinterpret_cast<T>(dlsym(handle, name));
  return *fn != nullptr;
}

bool load_api(const char *libpath) {
  void *h = dlopen(libpath, RTLD_NOW | RTLD_LOCAL);
  if (!h) return false;
  bool ok = resolve(h, "H5open", &g_api.H5open) &&
            resolve(h, "H5Eset_auto2", &g_api.H5Eset_auto2) &&
            resolve(h, "H5Fopen", &g_api.H5Fopen) &&
            resolve(h, "H5Fclose", &g_api.H5Fclose) &&
            resolve(h, "H5Dopen2", &g_api.H5Dopen2) &&
            resolve(h, "H5Dclose", &g_api.H5Dclose) &&
            resolve(h, "H5Dget_space", &g_api.H5Dget_space) &&
            resolve(h, "H5Dget_type", &g_api.H5Dget_type) &&
            resolve(h, "H5Dget_create_plist", &g_api.H5Dget_create_plist) &&
            resolve(h, "H5Dget_offset", &g_api.H5Dget_offset) &&
            resolve(h, "H5Dget_num_chunks", &g_api.H5Dget_num_chunks) &&
            resolve(h, "H5Dget_chunk_info", &g_api.H5Dget_chunk_info) &&
            resolve(h, "H5Sget_simple_extent_ndims",
                    &g_api.H5Sget_simple_extent_ndims) &&
            resolve(h, "H5Sget_simple_extent_dims",
                    &g_api.H5Sget_simple_extent_dims) &&
            resolve(h, "H5Sclose", &g_api.H5Sclose) &&
            resolve(h, "H5Tget_size", &g_api.H5Tget_size) &&
            resolve(h, "H5Tget_order", &g_api.H5Tget_order) &&
            resolve(h, "H5Tclose", &g_api.H5Tclose) &&
            resolve(h, "H5Pget_layout", &g_api.H5Pget_layout) &&
            resolve(h, "H5Pget_chunk", &g_api.H5Pget_chunk) &&
            resolve(h, "H5Pget_nfilters", &g_api.H5Pget_nfilters) &&
            resolve(h, "H5Pget_filter2", &g_api.H5Pget_filter2) &&
            resolve(h, "H5Pclose", &g_api.H5Pclose);
  if (!ok) {
    dlclose(h);
    return false;
  }
  if (g_api.H5open() < 0) return false;
  g_api.H5Eset_auto2(0, nullptr, nullptr);  // no stderr spew on fallbacks
  return true;
}

// ---------------------------------------------------------------------------
// Metadata pass
// ---------------------------------------------------------------------------

constexpr int kMaxNdim = 8;

struct ChunkRec {
  uint64_t grid[kMaxNdim];  // logical offset of the chunk in dataset coords
  uint64_t addr;            // file byte address of the raw (filtered) chunk
  uint64_t size;            // raw byte size on disk
  unsigned filter_mask;     // bit i set => pipeline filter i skipped
};

struct DsetMeta {
  int ndim = 0;
  uint64_t shape[kMaxNdim] = {0};
  uint64_t chunk[kMaxNdim] = {0};
  int64_t itemsize = 0;
  int layout = -1;
  int shuffle_idx = -1;  // pipeline position, -1 when absent
  int deflate_idx = -1;
  uint64_t contig_addr = 0;
  std::vector<ChunkRec> chunks;
};

struct ScopedIds {
  hid_t file = -1, dset = -1, space = -1, dtype = -1, plist = -1;
  ~ScopedIds() {
    if (plist >= 0) g_api.H5Pclose(plist);
    if (dtype >= 0) g_api.H5Tclose(dtype);
    if (space >= 0) g_api.H5Sclose(space);
    if (dset >= 0) g_api.H5Dclose(dset);
    if (file >= 0) g_api.H5Fclose(file);
  }
};

// Collects everything the hot path needs in one mutex-guarded pass.
// want_chunks=false (probe) skips the chunk-table walk.
int read_meta(const char *path, const char *dset_name, bool want_chunks,
              DsetMeta *m) {
  std::lock_guard<std::mutex> guard(g_h5_mutex);
  ScopedIds ids;
  ids.file = g_api.H5Fopen(path, kH5F_ACC_RDONLY, kH5P_DEFAULT);
  if (ids.file < 0) return -1;
  ids.dset = g_api.H5Dopen2(ids.file, dset_name, kH5P_DEFAULT);
  if (ids.dset < 0) return -1;

  ids.space = g_api.H5Dget_space(ids.dset);
  if (ids.space < 0) return -1;
  m->ndim = g_api.H5Sget_simple_extent_ndims(ids.space);
  if (m->ndim <= 0 || m->ndim > kMaxNdim) return -2;
  hsize_t dims[kMaxNdim];
  if (g_api.H5Sget_simple_extent_dims(ids.space, dims, nullptr) != m->ndim)
    return -2;
  for (int i = 0; i < m->ndim; ++i) m->shape[i] = dims[i];

  ids.dtype = g_api.H5Dget_type(ids.dset);
  if (ids.dtype < 0) return -1;
  m->itemsize = static_cast<int64_t>(g_api.H5Tget_size(ids.dtype));
  if (m->itemsize <= 0) return -2;
  // Byte order: compound types (h5py complex) report -1 ("mixed"); their
  // members are LE on every platform we run on, so only reject explicit BE.
  int order = g_api.H5Tget_order(ids.dtype);
  if (order > kH5T_ORDER_LE) return -3;

  ids.plist = g_api.H5Dget_create_plist(ids.dset);
  if (ids.plist < 0) return -1;
  m->layout = g_api.H5Pget_layout(ids.plist);
  if (m->layout == kH5D_CONTIGUOUS) {
    haddr_t addr = g_api.H5Dget_offset(ids.dset);
    if (addr == ~0ULL) return -3;  // HADDR_UNDEF: no storage allocated
    m->contig_addr = addr;
    return 0;
  }
  if (m->layout != kH5D_CHUNKED) return -3;  // compact/virtual -> fallback

  hsize_t cdims[kMaxNdim];
  if (g_api.H5Pget_chunk(ids.plist, kMaxNdim, cdims) != m->ndim) return -2;
  for (int i = 0; i < m->ndim; ++i) m->chunk[i] = cdims[i];

  int nfilters = g_api.H5Pget_nfilters(ids.plist);
  if (nfilters < 0) return -1;
  for (int i = 0; i < nfilters; ++i) {
    unsigned flags = 0, cfg = 0;
    size_t nelm = 0;
    H5Z_filter_t f = g_api.H5Pget_filter2(ids.plist, (unsigned)i, &flags,
                                          &nelm, nullptr, 0, nullptr, &cfg);
    if (f == kFILTER_SHUFFLE) m->shuffle_idx = i;
    else if (f == kFILTER_DEFLATE) m->deflate_idx = i;
    else return -3;  // fletcher32/szip/custom -> fallback
  }

  if (!want_chunks) return 0;
  // Some 1.10.x builds reject H5S_ALL here; the dataset's own dataspace
  // selects all chunks just the same.
  hsize_t nchunks = 0;
  if (g_api.H5Dget_num_chunks(ids.dset, ids.space, &nchunks) < 0 &&
      g_api.H5Dget_num_chunks(ids.dset, kH5S_ALL, &nchunks) < 0)
    return -1;
  m->chunks.resize(nchunks);
  for (hsize_t i = 0; i < nchunks; ++i) {
    hsize_t off[kMaxNdim];
    haddr_t addr = 0;
    hsize_t size = 0;
    ChunkRec &rec = m->chunks[i];
    if (g_api.H5Dget_chunk_info(ids.dset, ids.space, i, off,
                                &rec.filter_mask, &addr, &size) < 0)
      return -1;
    for (int d = 0; d < m->ndim; ++d) rec.grid[d] = off[d];
    rec.addr = addr;
    rec.size = size;
  }
  return 0;
}

// Training reads the same file hundreds of times (one example per slice);
// without a cache every call re-walks the whole chunk B-tree under the
// global mutex, serializing prefetch threads on exactly the lock the
// native path exists to avoid. Entries are validated by (mtime_ns, size).
struct MetaCacheEntry {
  std::shared_ptr<const DsetMeta> meta;
  int64_t mtime_ns = 0;
  int64_t size = 0;
  bool has_chunks = false;
};

std::mutex g_cache_mutex;
std::map<std::string, MetaCacheEntry> g_meta_cache;
constexpr size_t kMetaCacheCap = 4096;

int get_meta_cached(const char *path, const char *dset, bool want_chunks,
                    std::shared_ptr<const DsetMeta> *out) {
  struct stat st;
  if (stat(path, &st) != 0) return -4;
  int64_t mt = (int64_t)st.st_mtim.tv_sec * 1000000000 + st.st_mtim.tv_nsec;
  std::string key = std::string(path) + '\x1f' + dset;
  {
    std::lock_guard<std::mutex> guard(g_cache_mutex);
    auto it = g_meta_cache.find(key);
    if (it != g_meta_cache.end() && it->second.mtime_ns == mt &&
        it->second.size == (int64_t)st.st_size &&
        (it->second.has_chunks || !want_chunks)) {
      *out = it->second.meta;
      return 0;
    }
  }
  auto fresh = std::make_shared<DsetMeta>();
  int rc = read_meta(path, dset, want_chunks, fresh.get());
  if (rc != 0) return rc;
  {
    std::lock_guard<std::mutex> guard(g_cache_mutex);
    if (g_meta_cache.size() >= kMetaCacheCap) g_meta_cache.clear();
    g_meta_cache[key] = {fresh, mt, (int64_t)st.st_size, want_chunks};
  }
  *out = std::move(fresh);
  return 0;
}

// ---------------------------------------------------------------------------
// Hot path: pread + inflate + unshuffle + scatter (no HDF5, no GIL)
// ---------------------------------------------------------------------------

bool read_exact(int fd, uint64_t addr, uint64_t size, uint8_t *dst) {
  uint64_t done = 0;
  while (done < size) {
    ssize_t n = pread(fd, dst + done, size - done, (off_t)(addr + done));
    if (n <= 0) return false;
    done += (uint64_t)n;
  }
  return true;
}

// HDF5's shuffle filter stores byte plane b of every element contiguously:
// src[b*n + i] is byte b of element i.
void unshuffle(const uint8_t *src, uint8_t *dst, uint64_t n, int64_t esize) {
  for (int64_t b = 0; b < esize; ++b) {
    const uint8_t *plane = src + (uint64_t)b * n;
    uint8_t *out = dst + b;
    for (uint64_t i = 0; i < n; ++i) out[i * esize] = plane[i];
  }
}

struct SlabPlan {
  const DsetMeta *m;
  int axis;
  int64_t nidx;
  std::vector<int64_t> outpos;  // dataset index along axis -> slab position, -1
  uint64_t out_stride[kMaxNdim];    // byte strides of the output slab
  uint64_t chunk_stride[kMaxNdim];  // byte strides of a full chunk buffer
  uint8_t *out;
};

// Scatter the valid region of one decompressed chunk into the output slab.
// Recursion depth = ndim (<= 8); the innermost dim is copied as one memcpy
// run unless it IS the slab axis (then selected elements copy one by one).
void scatter_dim(const SlabPlan &p, const uint8_t *chunk,
                 const uint64_t *grid, int dim, uint64_t chunk_off,
                 uint64_t out_off) {
  const DsetMeta &m = *p.m;
  uint64_t lo = grid[dim];
  uint64_t hi = lo + m.chunk[dim];
  if (hi > m.shape[dim]) hi = m.shape[dim];  // edge chunks are padded
  const bool last = dim == m.ndim - 1;
  if (dim == p.axis) {
    for (uint64_t j = lo; j < hi; ++j) {
      int64_t pos = p.outpos[j];
      if (pos < 0) continue;
      uint64_t c_off = chunk_off + (j - lo) * p.chunk_stride[dim];
      uint64_t o_off = out_off + (uint64_t)pos * p.out_stride[dim];
      if (last)
        memcpy(p.out + o_off, chunk + c_off, (size_t)m.itemsize);
      else
        scatter_dim(p, chunk, grid, dim + 1, c_off, o_off);
    }
    return;
  }
  if (last) {
    // Non-axis dims address the output at ABSOLUTE dataset coordinates.
    memcpy(p.out + out_off + lo * p.out_stride[dim], chunk + chunk_off,
           (size_t)((hi - lo) * (uint64_t)m.itemsize));
    return;
  }
  for (uint64_t j = lo; j < hi; ++j)
    scatter_dim(p, chunk, grid, dim + 1,
                chunk_off + (j - lo) * p.chunk_stride[dim],
                out_off + j * p.out_stride[dim]);
}

int read_chunked_slab(const DsetMeta &m, const char *path, SlabPlan &plan,
                      int threads) {
  // Only chunks that intersect the slab along `axis` are touched.
  std::vector<const ChunkRec *> needed;
  for (const ChunkRec &c : m.chunks) {
    uint64_t lo = c.grid[plan.axis];
    uint64_t hi = lo + m.chunk[plan.axis];
    if (hi > m.shape[plan.axis]) hi = m.shape[plan.axis];
    for (uint64_t j = lo; j < hi; ++j)
      if (plan.outpos[j] >= 0) {
        needed.push_back(&c);
        break;
      }
  }
  if (getenv("H5N_DEBUG"))
    fprintf(stderr, "[h5n] needed %zu of %zu chunks, threads %d\n",
            needed.size(), m.chunks.size(), threads);
  if (needed.empty()) return 0;

  int fd = open(path, O_RDONLY);
  if (fd < 0) return -4;

  uint64_t chunk_elems = 1, chunk_bytes;
  for (int d = 0; d < m.ndim; ++d) chunk_elems *= m.chunk[d];
  chunk_bytes = chunk_elems * (uint64_t)m.itemsize;

  std::atomic<size_t> next(0);
  std::atomic<int> status(0);
  const bool dbg = getenv("H5N_DEBUG") != nullptr;
  auto nowms = [] {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return ts.tv_sec * 1e3 + 1e-6 * ts.tv_nsec;
  };
  auto worker = [&]() {
    std::vector<uint8_t> raw, tmp, dec;
    for (;;) {
      size_t i = next.fetch_add(1);
      if (i >= needed.size() || status.load() != 0) return;
      double w0 = dbg ? nowms() : 0;
      const ChunkRec &c = *needed[i];
      bool do_deflate =
          m.deflate_idx >= 0 && !(c.filter_mask & (1u << m.deflate_idx));
      bool do_shuffle =
          m.shuffle_idx >= 0 && !(c.filter_mask & (1u << m.shuffle_idx));
      raw.resize(c.size);
      if (!read_exact(fd, c.addr, c.size, raw.data())) {
        status.store(-4);
        return;
      }
      const uint8_t *plain = raw.data();
      if (do_deflate) {
        tmp.resize(chunk_bytes);
        uLongf dlen = (uLongf)chunk_bytes;
        if (uncompress(tmp.data(), &dlen, raw.data(), (uLong)c.size) != Z_OK ||
            dlen != chunk_bytes) {
          status.store(-5);
          return;
        }
        plain = tmp.data();
      } else if (c.size != chunk_bytes) {
        status.store(-5);
        return;
      }
      if (do_shuffle) {
        dec.resize(chunk_bytes);
        unshuffle(plain, dec.data(), chunk_elems, m.itemsize);
        plain = dec.data();
      }
      double w1 = dbg ? nowms() : 0;
      scatter_dim(plan, plain, c.grid, 0, 0, 0);
      if (dbg)
        fprintf(stderr, "[h5n] chunk %zu: inflate %.1f scatter %.1f ms\n",
                i, w1 - w0, nowms() - w1);
    }
  };

  // Oversubscription actively hurts: concurrent inflates on fewer cores
  // just context-switch (measured on a 1-core host: 8 threads turned a
  // 68 ms chunk inflate into 470 ms each).
  unsigned hw = std::thread::hardware_concurrency();
  int nthreads = threads < 1 ? 1 : threads;
  if (hw > 0 && (unsigned)nthreads > hw) nthreads = (int)hw;
  if ((size_t)nthreads > needed.size()) nthreads = (int)needed.size();
  std::vector<std::thread> pool;
  for (int t = 1; t < nthreads; ++t) pool.emplace_back(worker);
  worker();
  for (auto &t : pool) t.join();
  close(fd);
  return status.load();
}

int read_contig_slab(const DsetMeta &m, const char *path, int axis,
                     const std::vector<int64_t> &sel, uint8_t *out,
                     int threads) {
  // Row-major: fixing index j along `axis` selects `outer` contiguous runs
  // of `run` bytes, strided by shape[axis]*run.
  uint64_t run = (uint64_t)m.itemsize;
  for (int d = axis + 1; d < m.ndim; ++d) run *= m.shape[d];
  uint64_t outer = 1;
  for (int d = 0; d < axis; ++d) outer *= m.shape[d];
  uint64_t nsel = sel.size();

  std::atomic<uint64_t> next(0);
  std::atomic<int> status(0);
  uint64_t total = outer * nsel;
  auto worker = [&]() {
    int fd = open(path, O_RDONLY);
    if (fd < 0) {
      status.store(-4);
      return;
    }
    for (;;) {
      uint64_t i = next.fetch_add(1);
      if (i >= total || status.load() != 0) break;
      uint64_t o = i / nsel, s = i % nsel;
      uint64_t src = m.contig_addr +
                     (o * m.shape[axis] + (uint64_t)sel[s]) * run;
      uint64_t dst = (o * nsel + s) * run;
      if (!read_exact(fd, src, run, out + dst)) {
        status.store(-4);
        break;
      }
    }
    close(fd);
  };

  unsigned hw = std::thread::hardware_concurrency();
  int nthreads = threads < 1 ? 1 : threads;
  if (hw > 0 && (unsigned)nthreads > hw) nthreads = (int)hw;
  if ((uint64_t)nthreads > total) nthreads = (int)total;
  if (nthreads < 1) nthreads = 1;
  std::vector<std::thread> pool;
  for (int t = 1; t < nthreads; ++t) pool.emplace_back(worker);
  worker();
  for (auto &t : pool) t.join();
  return status.load();
}

}  // namespace

// ---------------------------------------------------------------------------
// C API
// ---------------------------------------------------------------------------

extern "C" {

// Load libhdf5 from `libpath` and resolve the API. 0 on success. Safe to
// call repeatedly; the first successful load wins.
int h5n_init(const char *libpath) {
  std::lock_guard<std::mutex> guard(g_h5_mutex);
  if (g_api_ready) return 0;
  if (!load_api(libpath)) return -1;
  g_api_ready = true;
  return 0;
}

// Dataset shape/itemsize. Returns ndim, or negative when the dataset is
// unreadable or out of scope for the native path.
int h5n_probe(const char *path, const char *dset, int64_t *shape8,
              int32_t *itemsize) {
  if (!g_api_ready) return -9;
  std::shared_ptr<const DsetMeta> m;
  int rc = get_meta_cached(path, dset, /*want_chunks=*/false, &m);
  if (rc != 0) return rc;
  for (int i = 0; i < m->ndim; ++i) shape8[i] = (int64_t)m->shape[i];
  *itemsize = (int32_t)m->itemsize;
  return m->ndim;
}

// Read dataset[..., indices, ...] (the `indices` list selecting along
// `axis`, other dims taken whole) into `out`, which must hold the full slab
// row-major. 0 on success; any negative => caller falls back to h5py.
int h5n_read_slab(const char *path, const char *dset, const int64_t *indices,
                  int64_t nidx, int32_t axis, void *out, int64_t out_nbytes,
                  int32_t threads) {
  if (!g_api_ready) return -9;
  if (nidx <= 0) return -2;
  const bool dbg = getenv("H5N_DEBUG") != nullptr;
  auto now = [] {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return ts.tv_sec + 1e-9 * ts.tv_nsec;
  };
  double t0 = dbg ? now() : 0.0;
  std::shared_ptr<const DsetMeta> mp;
  int rc = get_meta_cached(path, dset, /*want_chunks=*/true, &mp);
  if (rc != 0) return rc;
  const DsetMeta &m = *mp;
  if (dbg)
    fprintf(stderr, "[h5n] meta %.1f ms (%zu chunks)\n", (now() - t0) * 1e3,
            m.chunks.size());
  if (axis < 0 || axis >= m.ndim) return -2;

  int64_t expect = m.itemsize;
  for (int d = 0; d < m.ndim; ++d)
    expect *= (d == axis) ? nidx : (int64_t)m.shape[d];
  if (expect != out_nbytes) return -2;

  std::vector<int64_t> outpos(m.shape[axis], -1);
  std::vector<int64_t> sel(indices, indices + nidx);
  for (int64_t i = 0; i < nidx; ++i) {
    int64_t j = indices[i];
    if (j < 0 || (uint64_t)j >= m.shape[axis]) return -2;
    if (outpos[j] >= 0) return -2;  // duplicates unsupported
    outpos[j] = i;
  }

  if (m.layout == kH5D_CONTIGUOUS)
    return read_contig_slab(m, path, axis, sel,
                            static_cast<uint8_t *>(out), threads);

  SlabPlan plan;
  plan.m = &m;
  plan.axis = axis;
  plan.nidx = nidx;
  plan.outpos = std::move(outpos);
  plan.out = static_cast<uint8_t *>(out);
  uint64_t os = (uint64_t)m.itemsize, cs = (uint64_t)m.itemsize;
  for (int d = m.ndim - 1; d >= 0; --d) {
    plan.out_stride[d] = os;
    plan.chunk_stride[d] = cs;
    os *= (d == axis) ? (uint64_t)nidx : m.shape[d];
    cs *= m.chunk[d];
  }
  return read_chunked_slab(m, path, plan, threads);
}

}  // extern "C"
