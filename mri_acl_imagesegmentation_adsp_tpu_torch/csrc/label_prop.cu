// Label propagation on the card: exact 4-connected component labels of a
// stack of masks, and the masked 4-neighbour max propagation of the probe.
//
// Replaces the TPU kernel _prop_kernel of scripts/probe_pallas_roll.py (the
// pallas_call in prop_pallas, :48-55; body :33-45). That kernel runs ITERS
// = 128 steps of v <- where(m > 0, max(v, max of the 4 circular
// neighbours), v) on one (320, 320) f32 image held in VMEM, with the
// neighbours from pltpu.roll, which wraps around the edges. It probes
// whether an on-chip, iterate-to-convergence connected-components kernel
// can beat the label propagation of ops/maskops.py. Two entry points:
//
// masked_max_prop_f32: the probe's function exactly, wrap-around included,
// all iterations in one launch. One thread-block cluster of kCluster blocks
// holds the image in distributed shared memory: block r owns a band of
// ceil(H / kCluster) rows, in two ping-pong buffers, and reads the rows
// above and below its band from its neighbours' shared memory. One
// cluster barrier a step. What bounds it: the steps are dependent, so
// one step's operations (about 6 a pixel) run on the cluster's SMs at a
// time; at 320x320 the whole card would take 2.3 us for 128 steps, one
// SM 310 us, the 8 SMs of the cluster 39 us.
//
// label_components_u8: exact 4-connected labels, background H*W, each
// foreground pixel the minimum in-slice linear index of its component (the
// labels of ops/maskops.py:label_components in both packages). One block
// a slice runs to the fixpoint inside the launch: no host sync and no fixed
// sweep count. A sweep is a segmented min along every row (forward, then
// backward), then along every column; a run of foreground along a line is
// a 4-connected path, so a run's minimum spreads over the whole run in
// one pass, and the labels only ever fall to another label of the same
// component. The sweeps repeat until one changes nothing
// (__syncthreads_or), which is the fixpoint whatever the order of the
// updates: every run along every line is constant there, so a component
// holds one value, and that is its minimum index, which nothing can
// lower. The labels live in the output in device memory (0.94 MB a
// 640x368 slice, so a 35-slice volume stays in the 50 MB L2). A warp scans
// 32 lines through a 32x32 tile in shared memory, so its loads and stores
// are coalesced along rows in both directions of scan: lane i loads
// column i of the tile, then scans line i of it serially (a row of the
// tile for the row pass, a column for the column pass).
// What bounds it: bytes, at 8.2 MB of mask in and 33.0 MB of labels out
// a 35x640x368 volume, 12.3 us at 3.35 TB/s; but each sweep reads and
// writes the labels twice from L2, and the sweeps a mask needs are
// serial: a post-morphology body mask converges in 2-4 sweeps plus the
// one that checks, a serpentine maze in hundreds.
//
// Both take contiguous row-major tensors on the current device and launch
// on the given stream; each C function returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kTile = 32;
constexpr int kCluster = 8;
constexpr size_t kMaxSmem = 227 * 1024;

using TileT = int[kTile][kTile + 1];  // +1 column: no bank conflicts

// One pass of segmented minima along every row (kRows) or column of a
// slice, forward or backward. Warp w takes the lines [l0, l0 + 32) for l0 =
// 32 w, 32 (w + nwarps), ...; lane i owns line l0 + i and carries the
// running minimum of its current run along it. A background pixel (the
// sentinel) ends a run. Returns whether the pass lowered any label.
template <bool kRows, bool kForward>
__device__ bool sweep_lines(int* lbl, int h, int w, int sentinel,
                            TileT& t) {
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int lines = kRows ? h : w;
  const int len = kRows ? w : h;
  const int ntiles = (len + kTile - 1) / kTile;
  bool changed = false;
  for (int l0 = (threadIdx.x >> 5) * kTile; l0 < lines;
       l0 += nwarps * kTile) {
    int carry = sentinel;
    for (int k = 0; k < ntiles; ++k) {
      const int p0 = (kForward ? k : ntiles - 1 - k) * kTile;
      const int y0 = kRows ? l0 : p0;
      const int x0 = kRows ? p0 : l0;
      const int th = min(kTile, h - y0);
      const int tw = min(kTile, w - x0);
      if (lane < tw) {
        const int* src = lbl + static_cast<size_t>(y0) * w + x0 + lane;
#pragma unroll 8
        for (int r = 0; r < th; ++r) t[r][lane] = src[static_cast<size_t>(r) * w];
      }
      __syncwarp();
      const int nlines = kRows ? th : tw;
      const int n = kRows ? tw : th;
      if (lane < nlines) {
        for (int i = 0; i < n; ++i) {
          const int p = kForward ? i : n - 1 - i;
          int& cell = kRows ? t[lane][p] : t[p][lane];
          const int v = cell;
          if (v == sentinel) {
            carry = sentinel;
          } else if (v > carry) {
            cell = carry;
            changed = true;
          } else {
            carry = v;
          }
        }
      }
      __syncwarp();
      if (lane < tw) {
        int* dst = lbl + static_cast<size_t>(y0) * w + x0 + lane;
#pragma unroll 8
        for (int r = 0; r < th; ++r) dst[static_cast<size_t>(r) * w] = t[r][lane];
      }
      __syncwarp();
    }
  }
  return changed;
}

__global__ void __launch_bounds__(kThreads)
    label_components_kernel(const uint8_t* __restrict__ mask,
                            int* labels, int h, int w,
                            int* __restrict__ sweeps) {
  extern __shared__ TileT tiles[];
  TileT& t = tiles[threadIdx.x >> 5];
  const int hw = h * w;
  const size_t base = static_cast<size_t>(blockIdx.x) * hw;
  const uint8_t* m = mask + base;
  int* lbl = labels + base;
  for (int i = threadIdx.x; i < hw; i += blockDim.x) {
    lbl[i] = m[i] ? i : hw;
  }
  __syncthreads();
  int n = 0;
  for (;;) {
    bool changed = sweep_lines<true, true>(lbl, h, w, hw, t);
    changed |= sweep_lines<true, false>(lbl, h, w, hw, t);
    __syncthreads();
    changed |= sweep_lines<false, true>(lbl, h, w, hw, t);
    changed |= sweep_lines<false, false>(lbl, h, w, hw, t);
    ++n;
    if (!__syncthreads_or(changed)) break;
  }
  if (sweeps != nullptr && threadIdx.x == 0) sweeps[blockIdx.x] = n;
}

// Pixel (y, c) of the current buffer, from whichever block of the cluster
// owns row y.
__device__ __forceinline__ float pixel(cg::cluster_group& cluster,
                                       float* cur, int y, int c, int band,
                                       int w, unsigned rank) {
  const unsigned owner = static_cast<unsigned>(y / band);
  const int off = (y - static_cast<int>(owner) * band) * w + c;
  if (owner == rank) return cur[off];
  return cluster.map_shared_rank(cur, owner)[off];
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
    masked_max_prop_kernel(const float* __restrict__ mask,
                           const float* __restrict__ x,
                           float* __restrict__ out, int h, int w, int iters,
                           int band) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const int y0 = static_cast<int>(rank) * band;
  const int n = max(0, min(band, h - y0)) * w;
  float* buf[2] = {smem, smem + band * w};
  uint8_t* m = reinterpret_cast<uint8_t*>(smem + 2 * band * w);
  const size_t g0 = static_cast<size_t>(y0) * w;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    buf[0][i] = x[g0 + i];
    m[i] = mask[g0 + i] > 0.f;
  }
  cluster.sync();
  for (int it = 0; it < iters; ++it) {
    float* cur = buf[it & 1];
    float* nxt = buf[(it + 1) & 1];
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const float v = cur[i];
      if (!m[i]) {
        nxt[i] = v;
        continue;
      }
      const int r = i / w;
      const int c = i - r * w;
      const int y = y0 + r;
      const float up = pixel(cluster, cur, y == 0 ? h - 1 : y - 1, c, band,
                             w, rank);
      const float dn = pixel(cluster, cur, y == h - 1 ? 0 : y + 1, c, band,
                             w, rank);
      const float lf = cur[i - c + (c == 0 ? w - 1 : c - 1)];
      const float rt = cur[i - c + (c == w - 1 ? 0 : c + 1)];
      nxt[i] = fmaxf(v, fmaxf(fmaxf(up, dn), fmaxf(lf, rt)));
    }
    cluster.sync();
  }
  const float* fin = buf[iters & 1];
  for (int i = threadIdx.x; i < n; i += blockDim.x) out[g0 + i] = fin[i];
}

size_t prop_smem_bytes(int band, int w) {
  return (2 * sizeof(float) + 1) * static_cast<size_t>(band) * w;
}

}  // namespace

// C entry points bound with ctypes.

// mask: contiguous (S, H, W) uint8, nonzero meaning foreground; labels:
// contiguous (S, H, W) int32 output; sweeps: (S,) int32 output of the
// sweeps each slice took, the last of them the one that changed nothing,
// or null. One block a slice.
extern "C" int label_components_u8(const uint8_t* mask, int* labels, int s,
                                   int h, int w, int* sweeps,
                                   cudaStream_t stream) {
  if (s <= 0 || h <= 0 || w <= 0) return static_cast<int>(cudaSuccess);
  if (static_cast<long long>(h) * w >= 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(TileT) * (kThreads / 32);
  const cudaError_t err = cudaFuncSetAttribute(
      label_components_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  label_components_kernel<<<s, kThreads, smem, stream>>>(mask, labels, h, w,
                                                         sweeps);
  return static_cast<int>(cudaGetLastError());
}

// Shared-memory bytes a block of masked_max_prop_f32 needs for (h, w), or 0
// when one cluster cannot hold the image.
extern "C" long long masked_max_prop_smem(int h, int w) {
  if (h <= 0 || w <= 0) return 0;
  const int band = (h + kCluster - 1) / kCluster;
  const size_t bytes = prop_smem_bytes(band, w);
  return bytes > kMaxSmem ? 0 : static_cast<long long>(bytes);
}

// mask, x, out: contiguous (H, W) float32; iters steps in one launch of one
// cluster of kCluster blocks.
extern "C" int masked_max_prop_f32(const float* mask, const float* x,
                                   float* out, int h, int w, int iters,
                                   cudaStream_t stream) {
  if (h <= 0 || w <= 0 || iters < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int band = (h + kCluster - 1) / kCluster;
  const size_t smem = prop_smem_bytes(band, w);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      masked_max_prop_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  masked_max_prop_kernel<<<kCluster, kThreads, smem, stream>>>(
      mask, x, out, h, w, iters, band);
  return static_cast<int>(cudaGetLastError());
}
