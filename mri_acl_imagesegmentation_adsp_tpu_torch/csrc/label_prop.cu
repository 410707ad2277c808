// Label propagation on the card: exact 4-connected component labels of a
// stack of masks, and the masked 4-neighbour max propagation of the probe.
//
// Replaces the TPU kernel _prop_kernel of scripts/probe_pallas_roll.py (the
// pallas_call in prop_pallas, :48-55; body :33-45). That kernel runs ITERS
// = 128 steps of v <- where(m > 0, max(v, max of the 4 circular
// neighbours), v) on one (320, 320) f32 image held in VMEM, with the
// neighbours from pltpu.roll, which wraps around the edges. It probes
// whether an on-chip, iterate-to-convergence connected-components kernel
// can beat the label propagation of ops/maskops.py. Two entry points; the
// launch geometry of both comes from ops/kernels/components.py
// (tile_plan, prop_plan), and each entry point checks it.
//
// label_components_u8: exact 4-connected labels, background H*W, each
// foreground pixel the minimum in-slice linear index of its component (the
// labels of ops/maskops.py:label_components in both packages). What bounds
// it: bytes, 8.2 MB of mask in and 33.0 MB of labels out a 35x640x368
// volume, 12.3 us at 3.35 TB/s. Iterating minima to a fixpoint would be
// bound by latency instead (dependent sweeps: 3-4 a body mask, hundreds on
// a maze), so this is block-based union-find (Playne & Hawick, IEEE TPDS
// 2018; Allegretti, Bolelli & Grana, IEEE TPDS 2020) in three kernels of a
// fixed count on the stream, with no host sync and no loop whose length
// depends on the whole image:
//   1. cc_local: one block a 32x32 tile of one slice (240 tiles a 640x368
//      slice, 8,400 blocks a volume: every SM busy). A warp takes a row of
//      the tile: a ballot gives the row's foreground bits and each pixel's
//      parent is the start of its horizontal run. Runs are joined down the
//      tile by union-find in shared memory, one union where a run of
//      vertically joined columns starts, the larger root linked under the
//      smaller with atomicMin; five rounds of pointer jumping then cut the
//      chains the concurrent unions leave. A tile all background or all
//      foreground skips all that (two barrier reductions tell). Each
//      foreground pixel writes its root as an in-slice index (row-major
//      order inside a tile is the global order, so a tile's root is the
//      minimum of its piece), background H*W.
//   2. cc_merge: a thread for each pixel on a tile's top row and left
//      column; where it and its neighbour across the edge are foreground,
//      and the pixel before it along the edge does not already join the
//      same two runs, it unites their trees in the labels themselves:
//      find both roots (path halving, reads from L2), atomicMin the larger
//      root's parent to the smaller, retry from the old value until it was
//      a root.
//   3. cc_compress: every foreground pixel follows its parents to the root
//      and writes it, four consecutive pixels a thread (their chains walked
//      side by side, a run of equal labels walked once).
// A parent is never larger than its child and roots only fall, to an
// index of the same component, so at the end each component's root is its
// minimum index whatever order the atomics took: the labels are bit-equal
// from run to run although the trees differ.
//
// masked_max_prop_f32: the probe's function exactly, wrap-around included,
// all steps in one launch of one thread-block cluster of kCluster = 16
// blocks (a non-portable size) with k = 8 halo rows, the fastest of 8 or 16
// blocks and 1-16 rows when they were measured (PERF.md). Block r owns a
// band of rows and holds it with k halo rows above and below in two
// ping-pong buffers of shared memory.
// What bounds it: the steps are dependent, so a step's operations (about
// 6 a pixel) run on the cluster's SMs only, and each step waits on the
// one before. The design keeps a step down to those operations: every
// thread owns the pixels t, t + 1024, ... of its block's buffer for the
// whole launch, with their foreground and first- and last-column bits in
// three registers, so a step loops over its foreground bits (__ffs) with
// no division, no modulo and no remote address; and the blocks trade k
// halo rows through distributed shared memory once every k steps (one
// cluster barrier for k steps), running the k steps locally on a band
// that shrinks by a row on each side each step. The halo rows are pulled
// from the owner's export rows, written in one of two alternating
// buffers, so the barrier before the pull is the only one.
//
// chip_smoke.py (phase 8) and tools/probe_label_prop.py time both against
// their bounds; PERF.md section 6 keeps the numbers.
//
// Both take contiguous row-major tensors on the current device and launch
// on the given stream; each C function returns cudaGetLastError() (or
// cudaErrorInvalidValue for a plan it does not take).

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 32;          // TILE in ops/kernels/components.py
constexpr int kTileRowsPerPass = 8;  // warps of cc_local: 4 tile rows each
constexpr int kJumpRounds = 5;       // 2^5 = kTile
constexpr int kLinearThreads = 256;  // LINEAR_THREADS: cc_merge, compress
constexpr int kMaxGridY = 65535;
constexpr int kPropThreads = 1024;  // PROP_THREADS
constexpr int kCluster = 16;  // PROP_CLUSTER: a non-portable size
constexpr size_t kMaxSmem = 227 * 1024;

// ---------------------------------------------------------------------------
// label_components
// ---------------------------------------------------------------------------

__device__ __forceinline__ int find_shared(const volatile int* par, int x) {
  int p = par[x];
  while (p != x) {
    x = p;
    p = par[x];
  }
  return x;
}

// Join the trees of a and b in a tile: the larger root goes under the
// smaller; if another thread moved that root first, go on from where it
// points.
__device__ __forceinline__ void unite_shared(int* par, int a, int b) {
  for (;;) {
    a = find_shared(par, a);
    b = find_shared(par, b);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicMin(par + b, a);
    if (old == b) return;
    b = old;
  }
}

// The root of x in the slice's labels, halving the path on the way (each
// node visited is pointed at its grandparent, an ancestor in the same
// tree, by an atomicMin that never raises a parent). Loads bypass L1,
// which other SMs' atomics do not update.
__device__ __forceinline__ int find_global(int* lbl, int x) {
  for (;;) {
    const int p = __ldcg(lbl + x);
    if (p == x) return x;
    const int gp = __ldcg(lbl + p);
    if (gp == p) return p;
    atomicMin(lbl + x, gp);
    x = gp;
  }
}

__device__ __forceinline__ void unite_global(int* lbl, int a, int b) {
  for (;;) {
    a = find_global(lbl, a);
    b = find_global(lbl, b);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicMin(lbl + b, a);
    if (old == b) return;
    b = old;
  }
}

// Grid (tiles_y * tiles_x, grid_y), block (32, 8): block (i, z) takes tile
// i of slices z, z + grid_y, ...; warp wy takes the tile rows wy, wy + 8,
// wy + 16, wy + 24, lane c column c. The four rows' loads go out together,
// before the first ballot waits on one. The unions, all at once, leave
// chains of run starts as deep as the tile is high (a full tile: 32), so
// kJumpRounds rounds of pointer jumping (each node to its grandparent, in
// place) shorten every chain 32-fold before each pixel finds its root.
__global__ void __launch_bounds__(kTile * kTileRowsPerPass)
    cc_local_kernel(const uint8_t* __restrict__ mask, int* __restrict__ labels,
                    int s, int h, int w, int tiles_x) {
  constexpr int kRows = kTile / kTileRowsPerPass;
  __shared__ int par[kTile * kTile];
  __shared__ unsigned rowbits[kTile];
  const int lane = threadIdx.x;
  const int ty = static_cast<int>(blockIdx.x) / tiles_x;
  const int x0 = (static_cast<int>(blockIdx.x) - ty * tiles_x) * kTile;
  const int y0 = ty * kTile;
  const int x = x0 + lane;
  const int hw = h * w;
  for (int z = blockIdx.y; z < s; z += gridDim.y) {
    const size_t base = static_cast<size_t>(z) * hw;
    bool fg[kRows];
    bool all_fg = true, any_fg = false;  // over this thread's in-image pixels
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const int y = y0 + threadIdx.y + q * kTileRowsPerPass;
      const bool inside = y < h && x < w;
      fg[q] = inside && mask[base + static_cast<size_t>(y) * w + x] != 0;
      all_fg &= fg[q] || !inside;
      any_fg |= fg[q];
    }
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const int r = threadIdx.y + q * kTileRowsPerPass;
      const unsigned bits = __ballot_sync(0xffffffffu, fg[q]);
      if (lane == 0) rowbits[r] = bits;
      // the run starts after the last background pixel left of this one
      const unsigned bg_left = ~bits & ((1u << lane) - 1u);
      par[r * kTile + lane] = fg[q] ? r * kTile + 32 - __clz(bg_left) : -1;
    }
    // A tile all background, or all foreground (its in-image pixels, a
    // rectangle, are one piece whose minimum is its first pixel), needs no
    // union-find: most tiles of a body mask are one or the other.
    const bool full = __syncthreads_and(all_fg);
    const bool any = __syncthreads_or(any_fg);
    if (full || !any) {
      const int label = any ? y0 * w + x0 : hw;
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        const int y = y0 + threadIdx.y + q * kTileRowsPerPass;
        if (y < h && x < w) {
          labels[base + static_cast<size_t>(y) * w + x] = label;
        }
      }
      continue;  // the next slice's writes to par follow two barriers
    }
#pragma unroll 1
    for (int r = threadIdx.y; r < kTile; r += kTileRowsPerPass) {
      if (r == 0) continue;
      const unsigned both = rowbits[r] & rowbits[r - 1];
      if ((both & ~(both << 1)) >> lane & 1u) {
        unite_shared(par, r * kTile + lane, (r - 1) * kTile + lane);
      }
    }
    __syncthreads();
#pragma unroll 1
    for (int round = 0; round < kJumpRounds; ++round) {
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        const int i = (threadIdx.y + q * kTileRowsPerPass) * kTile + lane;
        const int p = par[i];
        if (p >= 0) par[i] = par[p];
      }
      __syncthreads();
    }
#pragma unroll 1
    for (int r = threadIdx.y; r < kTile; r += kTileRowsPerPass) {
      const int y = y0 + r;
      if (y >= h || x >= w) continue;
      const int p = par[r * kTile + lane];
      int label = hw;
      if (p >= 0) {
        const int root = find_shared(par, p);
        label = (y0 + root / kTile) * w + x0 + root % kTile;
      }
      labels[base + static_cast<size_t>(y) * w + x] = label;
    }
    __syncthreads();
  }
}

// Grid (merge_blocks, grid_y) of kLinearThreads: item j of a slice is, for
// j < (tiles_y - 1) * w, pixel (32 (j / w + 1), j % w) of a tile's top row
// with its neighbour above; after those, pixel (j' % h, 32 (j' / h + 1))
// of a tile's left column with its neighbour to the left.
__global__ void __launch_bounds__(kLinearThreads)
    cc_merge_kernel(const uint8_t* __restrict__ mask, int* labels, int s,
                    int h, int w, int tiles_y, int border) {
  const int top = (tiles_y - 1) * w;
  for (int z = blockIdx.y; z < s; z += gridDim.y) {
    const size_t base = static_cast<size_t>(z) * h * w;
    const uint8_t* m = mask + base;
    int* lbl = labels + base;
    for (long long j = static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
         j < border; j += static_cast<long long>(gridDim.x) * blockDim.x) {
      int y, x, a, b;
      bool along;  // the pixel before along the edge joins the same runs
      if (j < top) {
        const int k = static_cast<int>(j) / w;
        x = static_cast<int>(j) - k * w;
        y = (k + 1) * kTile;
        a = y * w + x;
        b = a - w;
        along = x % kTile != 0 && m[a - 1] && m[b - 1];
      } else {
        const int jj = static_cast<int>(j) - top;
        const int k = jj / h;
        y = jj - k * h;
        x = (k + 1) * kTile;
        a = y * w + x;
        b = a - 1;
        along = y % kTile != 0 && m[a - w] && m[b - w];
      }
      if (m[a] && m[b] && !along) unite_global(lbl, a, b);
    }
  }
}

// Grid (compress_blocks, grid_y) of kLinearThreads: a thread takes four
// consecutive labels of a slice (one int4 where H*W is a multiple of 4,
// else the slice goes one label a thread), follows their parents to the
// roots side by side (a label equal to the one before it takes that one's
// root), and writes them back if any changed.
__global__ void __launch_bounds__(kLinearThreads)
    cc_compress_kernel(int* labels, int s, int h, int w) {
  const int hw = h * w;
  const long long n4 = (hw & 3) == 0 ? hw / 4 : 0;
  const long long first =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (int z = blockIdx.y; z < s; z += gridDim.y) {
    int* lbl = labels + static_cast<size_t>(z) * hw;
    for (long long q = first; q < n4; q += stride) {
      int4* at = reinterpret_cast<int4*>(lbl) + q;
      const int4 v = *at;
      const int l[4] = {v.x, v.y, v.z, v.w};
      int r[4] = {v.x, v.y, v.z, v.w};
      bool live[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        live[e] = l[e] != hw && (e == 0 || l[e] != l[e - 1]);
      }
      for (bool any = true; any;) {
        any = false;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (!live[e]) continue;
          const int p = lbl[r[e]];
          live[e] = p != r[e];
          r[e] = p;
          any |= live[e];
        }
      }
#pragma unroll
      for (int e = 1; e < 4; ++e) {
        if (l[e] == l[e - 1]) r[e] = r[e - 1];
      }
      if (r[0] != l[0] || r[1] != l[1] || r[2] != l[2] || r[3] != l[3]) {
        *at = make_int4(r[0], r[1], r[2], r[3]);
      }
    }
    for (long long i = 4 * n4 + first; i < hw; i += stride) {
      const int l = lbl[i];
      if (l == hw) continue;
      int r = l;
      for (int p = lbl[r]; p != r; p = lbl[r]) r = p;
      if (r != l) lbl[i] = r;
    }
  }
}

// ---------------------------------------------------------------------------
// masked_max_prop
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned bits_below(int n) {
  return n >= 32 ? 0xffffffffu : (1u << n) - 1u;
}

__device__ __forceinline__ int wrap_row(int y, int h) {
  return ((y % h) + h) % h;
}

// One cluster; block r owns rows [r band, r band + nb). Shared memory: two
// buffers of (band + 2 k) rows (row i is global row r band - k + i, mod
// h), then two export areas of 2 k rows (slot i < k: band row i; slot k +
// i: band row nb - min(k, nb) + i).
__global__ void __launch_bounds__(kPropThreads)
    masked_max_prop_kernel(const float* __restrict__ mask,
                           const float* __restrict__ x,
                           float* __restrict__ out, int h, int w, int iters,
                           int band, int k) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int y0 = static_cast<int>(cluster.block_rank()) * band;
  const int nb = max(0, min(band, h - y0));
  const int rows = nb > 0 ? nb + 2 * k : 0;
  const int cap = (band + 2 * k) * w;
  const auto buf = [&](int b) { return smem + b * cap; };  // b = 0 or 1
  float* exports = smem + 2 * cap;
  const int t = threadIdx.x;

  // This thread's pixels i = t + 1024 j, j < 32: load both buffers and
  // keep the pixel's foreground, first- and last-column bits.
  unsigned fg = 0, first = 0, last = 0;
  for (int j = 0, i = t; i < rows * w; ++j, i += kPropThreads) {
    const int r = i / w;
    const int c = i - r * w;
    const size_t g = static_cast<size_t>(wrap_row(y0 - k + r, h)) * w + c;
    const float v = x[g];
    buf(0)[i] = v;
    buf(1)[i] = v;
    fg |= static_cast<unsigned>(mask[g] > 0.f) << j;
    first |= static_cast<unsigned>(c == 0) << j;
    last |= static_cast<unsigned>(c == w - 1) << j;
  }
  __syncthreads();

  int cur = 0;
  for (int done = 0, round = 0; done < iters; ++round) {
    const int steps = min(k, iters - done);
    for (int st = 1; st <= steps; ++st) {
      // rows [st, rows - st) are still right after st steps
      const float* src = buf(cur);
      float* dst = buf(cur ^ 1);
      const int lo = st * w - t;
      const int hi = (rows - st) * w - t;
      const int jlo = lo > 0 ? (lo + kPropThreads - 1) / kPropThreads : 0;
      const int jhi = hi > 0 ? (hi + kPropThreads - 1) / kPropThreads : 0;
      unsigned todo = fg & bits_below(jhi) & ~bits_below(jlo);
      while (todo) {
        const int j = __ffs(todo) - 1;
        todo &= todo - 1;
        const int i = t + j * kPropThreads;
        const float v = src[i];
        const float up = src[i - w];
        const float dn = src[i + w];
        const float lf = src[(first >> j & 1u) ? i + w - 1 : i - 1];
        const float rt = src[(last >> j & 1u) ? i - w + 1 : i + 1];
        dst[i] = fmaxf(v, fmaxf(fmaxf(up, dn), fmaxf(lf, rt)));
      }
      cur ^= 1;
      __syncthreads();
    }
    done += steps;
    if (done == iters) break;
    // Export this band's first and last min(k, nb) rows; after the barrier
    // every halo row is the export of the block that owns it (a halo row
    // above a band is among its owner's last k rows, one below among the
    // first k). The two export areas alternate, so no block writes one
    // before every block has passed the barrier after its last read of it.
    float* ex = exports + (round & 1) * 2 * k * w;
    const int m = min(k, nb);
    for (int i = t; i < m * w; i += kPropThreads) {
      ex[i] = buf(cur)[k * w + i];
      ex[k * w + i] = buf(cur)[(k + nb - m) * w + i];
    }
    cluster.sync();
    if (nb > 0) {
      for (int hr = t >> 5; hr < 2 * k; hr += kPropThreads / 32) {
        const int br = hr < k ? hr : nb + hr;
        const int gy = wrap_row(y0 - k + br, h);
        const int owner = gy / band;
        const int oy0 = owner * band;
        const int onb = min(band, h - oy0);
        const int om = min(k, onb);
        const int slot = gy - oy0 < om ? gy - oy0 : k + gy - (oy0 + onb - om);
        const float* from =
            cluster.map_shared_rank(ex, static_cast<unsigned>(owner)) +
            slot * w;
        float* to = buf(cur) + br * w;
        for (int c = t & 31; c < w; c += 32) to[c] = from[c];
      }
    }
    __syncthreads();
  }
  for (int i = t; i < nb * w; i += kPropThreads) {
    out[static_cast<size_t>(y0) * w + i] = buf(cur)[k * w + i];
  }
  cluster.sync();  // no block leaves while another may read its exports
}

size_t prop_smem_bytes(int band, int k, int w) {
  return sizeof(float) * (2 * static_cast<size_t>(band + 2 * k) +
                          4 * static_cast<size_t>(k)) * w;
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

}  // namespace

// C entry points bound with ctypes.

// mask: contiguous (S, H, W) uint8, nonzero meaning foreground; labels:
// contiguous (S, H, W) int32 output. The plan (components.tile_plan):
// tiles_y = ceil(H / 32), tiles_x = ceil(W / 32), border = (tiles_y - 1) W
// + (tiles_x - 1) H items a slice for cc_merge, merge_blocks and
// compress_blocks blocks of 256 threads along a slice (cc_compress four
// labels a thread), grid_y along the slices. Three launches.
extern "C" int label_components_u8(const uint8_t* mask, int* labels, int s,
                                   int h, int w, int tiles_y, int tiles_x,
                                   int border, int merge_blocks,
                                   int compress_blocks, int grid_y,
                                   cudaStream_t stream) {
  if (s <= 0 || h <= 0 || w <= 0) return static_cast<int>(cudaSuccess);
  if (static_cast<long long>(h) * w >= 0x7fffffffLL ||
      tiles_y != ceil_div(h, kTile) || tiles_x != ceil_div(w, kTile) ||
      static_cast<long long>(border) !=
          static_cast<long long>(tiles_y - 1) * w +
              static_cast<long long>(tiles_x - 1) * h ||
      merge_blocks < 1 || compress_blocks < 1 || grid_y < 1 ||
      grid_y > kMaxGridY) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cc_local_kernel<<<dim3(tiles_y * tiles_x, grid_y),
                    dim3(kTile, kTileRowsPerPass), 0, stream>>>(
      mask, labels, s, h, w, tiles_x);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cc_merge_kernel<<<dim3(merge_blocks, grid_y), kLinearThreads, 0, stream>>>(
      mask, labels, s, h, w, tiles_y, border);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cc_compress_kernel<<<dim3(compress_blocks, grid_y), kLinearThreads, 0,
                       stream>>>(labels, s, h, w);
  return static_cast<int>(cudaGetLastError());
}

// mask, x, out: contiguous (H, W) float32; iters steps in one launch of one
// cluster of kCluster blocks, each `band` rows with `halo` halo rows a
// side and `smem` bytes of shared memory (components.prop_plan).
extern "C" int masked_max_prop_f32(const float* mask, const float* x,
                                   float* out, int h, int w, int iters,
                                   int band, int halo, long long smem,
                                   cudaStream_t stream) {
  if (h <= 0 || w <= 0 || iters < 0 || band < 1 ||
      static_cast<long long>(band) * kCluster < h || halo < 1 ||
      halo > band ||
      static_cast<long long>(band + 2 * halo) * w > 32LL * kPropThreads ||
      smem != static_cast<long long>(prop_smem_bytes(band, halo, w)) ||
      smem > static_cast<long long>(kMaxSmem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      masked_max_prop_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(masked_max_prop_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, 1, 1);
  cfg.blockDim = dim3(kPropThreads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, masked_max_prop_kernel, mask, x, out, h, w,
                           iters, band, halo);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
