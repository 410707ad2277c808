// disk(2) binary opening then closing of a stack of uint8 masks, one kernel.
//
// Replaces the TPU kernel _fused_open_close in
// mri_acl_imagesegmentation_adsp_tpu/ops/pallas/morphology.py (the
// pallas_call at :93-101; body _open_close_kernel with helpers _erode,
// _dilate and _shift_with_fill). It computes what that kernel computes,
// closing(opening(m, disk(2)), disk(2)), i.e. erode -> dilate -> dilate ->
// erode over the 13 taps of disk(2), but for a (S, H, W) stack at once.
//
// Border rule: a tap that falls outside the IMAGE (not outside the tile)
// reads 1 in an erosion pass and 0 in a dilation pass, at every one of the
// four passes, as skimage does. Padding the input once would be wrong near
// the image edge, so each pass tests the tap's image coordinates itself.
//
// Design: one block per 32x32 output tile, grid (ceil(W/32), ceil(H/32), S).
// The block loads the tile plus an 8-pixel halo (four radius-2 passes) into
// a 48x48 u8 shared buffer and runs the four passes there, ping-ponging
// between two buffers; each pass computes a region 2 pixels narrower on
// every side than the last, so the fourth pass yields exactly the tile.
//
// What bounds it on an H100: bytes. The function must read S*H*W u8 and
// write S*H*W u8, 2*S*H*W bytes: 16.5 MB for a 35x640x368 volume, about
// 5 us at 3.35 TB/s. Its logic is 48 boolean operations a pixel, which a
// bit-packed formulation does 32 pixels to a 32-bit operation, far below
// the memory time; at that bound a launch's own few us of overhead would
// cost as much as the work. The halo re-reads (48x48 loaded for 32x32
// written) come from L2. This simple design does not reach the bound: its
// per-tap image-bounds tests and byte-wide shared-memory passes take
// 0.41 ms a volume on an H100 SXM at 700 W (chip_smoke.py, PERF.md).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kHalo = 8;                  // 4 passes x radius 2
constexpr int kRegion = kTile + 2 * kHalo;  // 48
constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;

// One radius-2 disk pass over buffer rows/cols [lo, hi) of the region.
// (oy, ox) are the image coordinates of region cell (0, 0).
template <bool kErode>
__device__ __forceinline__ void disk_pass(uint8_t (*src)[kRegion],
                                          uint8_t (*dst)[kRegion], int lo,
                                          int hi, int oy, int ox, int H,
                                          int W) {
  const uint8_t fill = kErode ? 1 : 0;
  for (int y = lo + threadIdx.y; y < hi; y += kThreadsY) {
    for (int x = lo + threadIdx.x; x < hi; x += kThreadsX) {
      uint8_t acc = kErode ? 1 : 0;
#pragma unroll
      for (int dy = -2; dy <= 2; ++dy) {
#pragma unroll
        for (int dx = -2; dx <= 2; ++dx) {
          if (dy * dy + dx * dx > 4) continue;
          const int gy = oy + y + dy;
          const int gx = ox + x + dx;
          const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
          const uint8_t v = inside ? src[y + dy][x + dx] : fill;
          acc = static_cast<uint8_t>(kErode ? (acc & v) : (acc | v));
        }
      }
      dst[y][x] = acc;
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreadsX * kThreadsY)
    open_close_kernel(const uint8_t* __restrict__ in,
                      uint8_t* __restrict__ out, int H, int W) {
  __shared__ uint8_t buf[2][kRegion][kRegion];
  const size_t plane = static_cast<size_t>(H) * W;
  const uint8_t* src = in + blockIdx.z * plane;
  uint8_t* dst = out + blockIdx.z * plane;
  const int ty = blockIdx.y * kTile;
  const int tx = blockIdx.x * kTile;
  const int oy = ty - kHalo;
  const int ox = tx - kHalo;

  // Cells outside the image are never read as data (each pass substitutes
  // its fill there), so their loaded value does not matter.
  for (int y = threadIdx.y; y < kRegion; y += kThreadsY) {
    const int gy = oy + y;
    for (int x = threadIdx.x; x < kRegion; x += kThreadsX) {
      const int gx = ox + x;
      uint8_t v = 0;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        v = static_cast<uint8_t>(
            src[static_cast<size_t>(gy) * W + gx] != 0);
      }
      buf[0][y][x] = v;
    }
  }
  __syncthreads();

  disk_pass<true>(buf[0], buf[1], 2, kRegion - 2, oy, ox, H, W);   // erode
  disk_pass<false>(buf[1], buf[0], 4, kRegion - 4, oy, ox, H, W);  // dilate
  disk_pass<false>(buf[0], buf[1], 6, kRegion - 6, oy, ox, H, W);  // dilate
  disk_pass<true>(buf[1], buf[0], 8, kRegion - 8, oy, ox, H, W);   // erode

  for (int y = threadIdx.y; y < kTile; y += kThreadsY) {
    const int gy = ty + y;
    if (gy >= H) break;
    for (int x = threadIdx.x; x < kTile; x += kThreadsX) {
      const int gx = tx + x;
      if (gx < W) dst[static_cast<size_t>(gy) * W + gx] =
          buf[0][kHalo + y][kHalo + x];
    }
  }
}

}  // namespace

// C entry point bound with ctypes. in/out: contiguous (S, H, W) uint8 on the
// current device; launches on `stream`; returns cudaGetLastError().
extern "C" int open_close_u8(const uint8_t* in, uint8_t* out, int S, int H,
                             int W, cudaStream_t stream) {
  if (S <= 0 || H <= 0 || W <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, S);
  const dim3 block(kThreadsX, kThreadsY);
  open_close_kernel<<<grid, block, 0, stream>>>(in, out, H, W);
  return static_cast<int>(cudaGetLastError());
}
