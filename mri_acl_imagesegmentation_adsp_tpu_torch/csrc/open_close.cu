// disk(2) binary opening then closing of a stack of uint8 masks, one kernel.
//
// Replaces the TPU kernel _fused_open_close in
// mri_acl_imagesegmentation_adsp_tpu/ops/pallas/morphology.py (the
// pallas_call at :93-101; body _open_close_kernel with helpers _erode,
// _dilate and _shift_with_fill). It computes what that kernel computes,
// closing(opening(m, disk(2)), disk(2)), i.e. erode -> dilate -> dilate ->
// erode over the 13 taps of disk(2), but for a (S, H, W) stack at once.
// Input: contiguous (S, H, W) uint8, nonzero meaning 1. Output: uint8 0/1.
//
// Border rule: a tap that falls outside the IMAGE reads 1 in an erosion
// pass and 0 in a dilation pass, at every one of the four passes, as
// skimage does.
//
// Bit order: pixel x of a row is bit (x mod 32) of word x/32 of the row, so
// a row packs into nw = ceil(W/32) words. For word j of a row with
// neighbours l (word j-1) and r (word j+1), __funnelshift_r(c, r, d) holds
// pixel x+d at the bit of pixel x, and __funnelshift_l(l, c, d) pixel x-d.
//
// Design: one block of 256 threads per band of R output rows across the
// full width of one slice; the wrapper (ops/kernels/morphology.py,
// band_plan) picks R from S and H so that the grid S*ceil(H/R) fills the
// 132 SMs. The block works on the band's R+16 rows (an 8-row halo above
// and below for four radius-2 passes; no horizontal halo, no carry between
// blocks). disk(2) is, per word, row y at horizontal radius 2, rows y+-1 at
// radius 1 and rows y+-2 at radius 0, combined by AND (erode) or OR
// (dilate): 8 funnel shifts and 12 logic operations for 32 pixels. Each
// pass computes 2 rows fewer at each end of the band, so the fourth yields
// exactly the R output rows; two packed buffers in shared memory ping-pong
// between passes. A thread computes 4 rows of one word column, so it loads
// 20 words from shared memory for 4 outputs.
//
// Bytes in and out, 16 at a time. A band's rows are one contiguous run of
// bytes. Each thread loads 16-byte chunks of it, aligned to the address
// (byte loads for the two end chunks only), and turns each into 16 bits
// with a few integer operations, into a bit stream in shared memory: bit i
// of the stream is the byte at the aligned start plus i. A row's word j is
// then one funnel shift of two stream words, whatever W and the alignment.
// The output goes the other way: the last pass ORs its words into a bit
// stream aligned to the output's address (shared-memory atomics, as a word
// may straddle two stream words), and each thread expands 16 bits to a
// 16-byte chunk and stores it (byte stores at the two ends, which
// neighbouring bands share). A first design packed 32 bytes with one warp
// ballot and unpacked one byte a lane; with its addressing that was about
// 60 warp instructions a 32-pixel word, and it took 58 us a volume.
//
// The border rule without per-tap tests: pixels outside the image pack as
// 1 (the first pass erodes). Each pass writes, for the next pass, its fill
// to the band's rows outside [0, H) and to the bits x >= W of each row's
// last word (one mask), and reads its own fill for the virtual words j = -1
// and j = nw. So the fill is re-applied at every pass.
//
// What bounds it on an H100: bytes. The function must read S*H*W u8 and
// write S*H*W u8: 16.5 MB for a 35x640x368 volume, 4.92 us at 3.35 TB/s.
// Its logic, 80 INT32 operations a word over four passes, is 1.29 us at
// the card's INT32 rate.
//
// Measured (chip_smoke.py and tools/probe_open_close.py, NVIDIA H100 80GB
// HBM3, 700.00 W; PERF.md, section 6): 15.2 us cold (L2 flushed) and 12.4 us
// warm at 35x640x368, 9.9 and 8.8 us at 8x640x368, where an empty kernel
// between the same events takes 5.1 us. Cold, a block spends 4.1 us loading
// its band, then 4.2 us on the words, the passes and the stores: every block
// loads at once and then computes, so the loads do not overlap the work.
// ptxas: 48 registers, no spills, no static shared memory; dynamic shared
// memory 11,664 bytes a block at R = 64 and W = 368 (7,120 at R = 32).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kHalo = 8;            // 4 passes x radius 2
constexpr int kRowsPerThread = 4;   // rows of one word column per thread
constexpr int kChunksInFlight = 8;  // 16-byte loads a thread keeps in flight

#ifdef OPEN_CLOSE_PHASE_CLOCK
// Instrumented build only (tools/probe_open_close.py builds it with
// -DOPEN_CLOSE_PHASE_CLOCK; the wrapper never does): thread 0 of each of the
// first kStampedBlocks blocks records the card's nanosecond timer when the
// block starts and after each of its phases (load, words, four passes,
// store), for open_close_phase_ns to read.
constexpr int kStamps = 8;
constexpr int kStampedBlocks = 8192;
__device__ unsigned long long g_phase_ns[kStampedBlocks * kStamps];
#define PHASE(k)                                                          \
  do {                                                                    \
    if (threadIdx.x == 0 && blockIdx.x < kStampedBlocks) {                \
      unsigned long long t;                                               \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));               \
      g_phase_ns[blockIdx.x * kStamps + (k)] = t;                         \
    }                                                                     \
  } while (0)
#else
#define PHASE(k) \
  do {           \
  } while (0)
#endif

// Rows of one packed buffer: the band, its halo, and the rows a thread's
// last 4-row group reads past the pass's end (their results are dropped).
__host__ __device__ inline int packed_rows(int band_rows) {
  return band_rows + 2 * kHalo + kRowsPerThread - 1;
}

// 32-bit words of the bit stream: the band's bytes, up to 15 bits of
// alignment ahead of them, and one word that a funnel shift reads past the
// end. Rounded to 4 words, so the packed buffers after it stay aligned.
__host__ __device__ inline int stream_words(int band_rows, int w) {
  return (((band_rows + 2 * kHalo) * w + 15 + 31) / 32 + 1 + 3) / 4 * 4;
}

template <bool kErode>
__device__ __forceinline__ uint32_t combine(uint32_t a, uint32_t b) {
  return kErode ? (a & b) : (a | b);
}

// Bit k (k < 4) of the result is whether byte k of x is nonzero: bit 7 of
// each byte is set by the add or by x itself, and the product moves the four
// bit 7s to bits 28-31 without carries.
__device__ __forceinline__ uint32_t nonzero4(uint32_t x) {
  const uint32_t msb = (((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x) & 0x80808080u;
  return (msb * 0x00204081u) >> 28;
}

__device__ __forceinline__ uint32_t chunk_bits(uint4 v) {
  return nonzero4(v.x) | nonzero4(v.y) << 4 | nonzero4(v.z) << 8 |
         nonzero4(v.w) << 12;
}

// Four bits to four bytes of 0 or 1: the product spreads bit k to bit 8k
// (and to bits the mask clears) without carries.
__device__ __forceinline__ uint32_t spread4(uint32_t nib) {
  return (nib * 0x00204081u) & 0x01010101u;
}

// The low 16 bits of `bits` as 16 bytes of 0 or 1.
__device__ __forceinline__ uint4 spread16(uint32_t bits) {
  return make_uint4(spread4(bits & 15u), spread4((bits >> 4) & 15u),
                    spread4((bits >> 8) & 15u), spread4((bits >> 12) & 15u));
}

// The 16 bytes at the 16-aligned address p; bytes outside [lo, hi) read 0
// and are not touched.
__device__ __forceinline__ uint4 load_chunk(intptr_t p, intptr_t lo,
                                            intptr_t hi) {
  if (p >= lo && p + 16 <= hi) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  uint32_t x[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    if (p + i >= lo && p + i < hi) {
      x[i / 4] |= static_cast<uint32_t>(
                      *reinterpret_cast<const uint8_t*>(p + i))
                  << (8 * (i % 4));
    }
  }
  return make_uint4(x[0], x[1], x[2], x[3]);
}

// Store the 16 bytes v at the 16-aligned address p, only those in [lo, hi).
__device__ __forceinline__ void store_chunk(intptr_t p, intptr_t lo,
                                            intptr_t hi, uint4 v) {
  if (p >= lo && p + 16 <= hi) {
    *reinterpret_cast<uint4*>(p) = v;
    return;
  }
  const uint32_t x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    if (p + i >= lo && p + i < hi) {
      *reinterpret_cast<uint8_t*>(p + i) =
          static_cast<uint8_t>(x[i / 4] >> (8 * (i % 4)));
    }
  }
}

// Walks the cells (row, word) of a grid nw words wide, kThreads cells
// apart in row-major order, with no division per cell.
struct Cells {
  int r, j, step_r, step_j, nw;
  __device__ __forceinline__ explicit Cells(int words)
      : r(static_cast<int>(threadIdx.x) / words),
        j(static_cast<int>(threadIdx.x) % words),
        step_r(kThreads / words),
        step_j(kThreads % words),
        nw(words) {}
  __device__ __forceinline__ void next() {
    r += step_r;
    j += step_j;
    if (j >= nw) {
      j -= nw;
      ++r;
    }
  }
};

// Where the last pass puts its words: ORed into the output bit stream
// `bits`, where pixel x of output row r is bit lead + r * w + x; the kernel
// stores the stream afterwards.
struct Out {
  uint32_t* bits;
  int lead, w;
};

// One disk(2) pass over packed buffer rows [lo, hi). band_y0 is the image
// row of buffer row 0; last_valid masks the real pixels of a row's last
// word. A pass writes dst for the next pass; the last (kLast) writes the
// output instead.
template <bool kErode, bool kNextErode, bool kLast = false>
__device__ __forceinline__ void disk_pass(const uint32_t* __restrict__ src,
                                          uint32_t* __restrict__ dst, int lo,
                                          int hi, int band_y0, int h, int nw,
                                          uint32_t last_valid, Out out = {}) {
  constexpr uint32_t kFill = kErode ? ~0u : 0u;
  constexpr uint32_t kNextFill = kNextErode ? ~0u : 0u;
  constexpr int kV = kRowsPerThread;
  const int n_strips = (hi - lo + kV - 1) / kV;
  for (Cells cell(nw); cell.r < n_strips; cell.next()) {
    const int j = cell.j;
    const int y = lo + cell.r * kV;
    uint32_t c[kV + 4], h1[kV + 4], h2[kV + 4];
#pragma unroll
    for (int v = 0; v < kV + 4; ++v) {
      const uint32_t* row = src + (y - 2 + v) * nw;
      const uint32_t mid = row[j];
      const uint32_t left = j > 0 ? row[j - 1] : kFill;
      const uint32_t right = j + 1 < nw ? row[j + 1] : kFill;
      c[v] = mid;
      h1[v] = combine<kErode>(
          mid, combine<kErode>(__funnelshift_r(mid, right, 1),
                               __funnelshift_l(left, mid, 1)));
      h2[v] = combine<kErode>(
          h1[v], combine<kErode>(__funnelshift_r(mid, right, 2),
                                 __funnelshift_l(left, mid, 2)));
    }
#pragma unroll
    for (int v = 0; v < kV; ++v) {
      const int yy = y + v;
      const int g = band_y0 + yy;
      if (yy >= hi) continue;
      uint32_t word = combine<kErode>(
          h2[v + 2],
          combine<kErode>(combine<kErode>(h1[v + 1], h1[v + 3]),
                          combine<kErode>(c[v], c[v + 4])));
      if (kLast) {
        if (g >= h) continue;
        if (j == nw - 1) word &= last_valid;
        const int b = out.lead + (yy - kHalo) * out.w + 32 * j;
        const int s = b & 31;
        atomicOr(&out.bits[b >> 5], word << s);
        if (s != 0 && (word >> (32 - s)) != 0) {
          atomicOr(&out.bits[(b >> 5) + 1], word >> (32 - s));
        }
      } else {
        if (g < 0 || g >= h) {
          word = kNextFill;
        } else if (j == nw - 1) {
          word = (word & last_valid) | (kNextFill & ~last_valid);
        }
        dst[yy * nw + j] = word;
      }
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
    open_close_kernel(const uint8_t* __restrict__ in,
                      uint8_t* __restrict__ out, int h, int w, int nw,
                      int band_rows, int n_bands) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* stream = smem;
  uint16_t* stream16 = reinterpret_cast<uint16_t*>(smem);
  uint32_t* buf_a = smem + stream_words(band_rows, w);
  uint32_t* buf_b = buf_a + packed_rows(band_rows) * nw;

  const int slice = blockIdx.x / n_bands;
  const int band = blockIdx.x % n_bands;
  const size_t plane = static_cast<size_t>(h) * w;
  const intptr_t src = reinterpret_cast<intptr_t>(in + slice * plane);
  const intptr_t dst = reinterpret_cast<intptr_t>(out + slice * plane);
  const int y_out = band * band_rows;      // first output row
  const int band_y0 = y_out - kHalo;       // image row of buffer row 0
  const int n_rows = band_rows + 2 * kHalo;
  const uint32_t last_valid = (w % 32) ? (1u << (w % 32)) - 1u : ~0u;
  PHASE(0);

  // The band's image rows as a bit stream from the 16-aligned address at or
  // before their first byte.
  const intptr_t ia = src + static_cast<intptr_t>(max(band_y0, 0)) * w;
  const intptr_t ib =
      src + static_cast<intptr_t>(min(band_y0 + n_rows, h)) * w;
  const intptr_t ibase = ia & ~static_cast<intptr_t>(15);
  const int n_in = static_cast<int>((ib - ibase + 15) / 16);
  for (int c0 = threadIdx.x; c0 < n_in; c0 += kThreads * kChunksInFlight) {
    uint4 v[kChunksInFlight];
#pragma unroll
    for (int u = 0; u < kChunksInFlight; ++u) {
      const int c = c0 + u * kThreads;
      if (c < n_in) v[u] = load_chunk(ibase + 16 * c, ia, ib);
    }
#pragma unroll
    for (int u = 0; u < kChunksInFlight; ++u) {
      const int c = c0 + u * kThreads;
      if (c < n_in) stream16[c] = static_cast<uint16_t>(chunk_bits(v[u]));
    }
  }
  __syncthreads();
  PHASE(1);

  // Words of the band's rows; pixels outside the image are 1.
  const int row_bit0 = static_cast<int>(src - ibase) + band_y0 * w;
  for (Cells cell(nw); cell.r < n_rows; cell.next()) {
    const int g = band_y0 + cell.r;
    uint32_t word = ~0u;
    if (g >= 0 && g < h) {
      const int b = row_bit0 + cell.r * w + 32 * cell.j;
      word = __funnelshift_r(stream[b >> 5], stream[(b >> 5) + 1], b & 31);
      if (cell.j == nw - 1) word |= ~last_valid;
    }
    buf_a[cell.r * nw + cell.j] = word;
  }
  __syncthreads();
  PHASE(2);

  // Output rows [y_out, y_out + n_out) go to a bit stream from the
  // 16-aligned address at or before their first byte, which the last pass
  // ORs into; it reuses the input stream, read for the last time above.
  const int n_out = min(band_rows, h - y_out);
  const int span = n_out * w;
  const intptr_t oa = dst + static_cast<intptr_t>(y_out) * w;
  const intptr_t obase = oa & ~static_cast<intptr_t>(15);
  const int lead = static_cast<int>(oa - obase);
  for (int q = threadIdx.x; q < (lead + span + 31) / 32; q += kThreads) {
    stream[q] = 0u;
  }

  const int top = 2 * kHalo + band_rows;
  disk_pass<true, false>(buf_a, buf_b, 2, top - 2, band_y0, h, nw,
                         last_valid);  // erode
  PHASE(3);
  disk_pass<false, false>(buf_b, buf_a, 4, top - 4, band_y0, h, nw,
                          last_valid);  // dilate
  PHASE(4);
  disk_pass<false, true>(buf_a, buf_b, 6, top - 6, band_y0, h, nw,
                         last_valid);  // dilate
  PHASE(5);
  disk_pass<true, true, true>(buf_b, nullptr, 8, top - 8, band_y0, h, nw,
                              last_valid, {stream, lead, w});  // erode
  PHASE(6);

  for (int c = threadIdx.x; c < (lead + span + 15) / 16; c += kThreads) {
    store_chunk(obase + 16 * c, oa, oa + span, spread16(stream16[c]));
  }
  PHASE(7);
}

}  // namespace

// C entry point bound with ctypes. in/out: contiguous (S, H, W) uint8 on the
// current device; bands of band_rows output rows, n_bands = ceil(H /
// band_rows) of them a slice, one block each; launches on `stream`; returns
// cudaGetLastError().
extern "C" int open_close_u8(const uint8_t* in, uint8_t* out, int s, int h,
                             int w, int band_rows, int n_bands,
                             cudaStream_t stream) {
  if (s <= 0 || h <= 0 || w <= 0) return static_cast<int>(cudaSuccess);
  if (band_rows <= 0 || n_bands <= 0 ||
      static_cast<long long>(n_bands) * band_rows < h ||
      static_cast<long long>(n_bands - 1) * band_rows >= h) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nw = (w + 31) / 32;
  const size_t smem =
      4 * (static_cast<size_t>(stream_words(band_rows, w)) +
           2 * static_cast<size_t>(packed_rows(band_rows)) * nw);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        open_close_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  open_close_kernel<<<s * n_bands, kThreads, smem, stream>>>(
      in, out, h, w, nw, band_rows, n_bands);
  return static_cast<int>(cudaGetLastError());
}

#ifdef OPEN_CLOSE_PHASE_CLOCK
// Copies the stamps of the last launch's first n_blocks blocks to host.
extern "C" int open_close_phase_ns(unsigned long long* host, int n_blocks) {
  if (n_blocks < 0 || n_blocks > kStampedBlocks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaMemcpyFromSymbol(
      host, g_phase_ns, sizeof(unsigned long long) * kStamps * n_blocks));
}
#endif
