// Demand-sized emission of the (Gaussian, tile) pairs, for NVIDIA Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the JAX package emits into static [tcap, N] tables
// with XLA ops (eogs2_tpu/ops/pair_pipeline.py:_tier_keys,
// _tier_keys_compact, _slot_cull_mask). The port sized its emission by
// demand in plain PyTorch (ops/pair_pipeline.emit_pairs_plain), which
// expands every Gaussian into all of its rect tiles before culling: at 1M
// Gaussians and 1024^2 that is ~13M pre-cull pairs, each gathered,
// tested by ~40 elementwise kernels and dropped by two boolean masks that
// wait for the card. These two passes follow the CUDA reference's
// duplicateWithKeys after its tiles_touched scan (rasterizer_impl.cu): no
// per-pair array exists before the cull.
//
//   count pass  lengths[g] = the live tiles among Gaussian g's first
//               tiles[g] = min(tiles_touched, tcap) rect tiles, row-major;
//   (the wrapper: ends = cumsum(lengths), one read of the total)
//   write pass  the same walk and the same test; gid, tile and, when asked,
//               the sort key tile << 32 | depth_key(depth[g]) of each live
//               pair at [ends[g] - lengths[g], ends[g]).
//
// The output is the plain version's bit for bit: Gaussian-major, row-major
// within a Gaussian, culled tiles removed in place; the stable sort, its tie
// order and the deterministic backward rest on that order. The cull test
// mirrors _slot_cull_mask and _tile_qmin operation by operation, in their
// order, compiled with -fmad=false and IEEE division: x0 + TILE - 1 is two
// roundings, q = a dx dx + 2 b dx dy + c dy dy is summed left to right,
// where(c > 0, c, 1e-12) is kept, torch.minimum and torch.clamp propagate a
// NaN (fminf would drop it), and a tile is dead when isfinite(qmin) and
// qmin > thr, thr = cull_tau(opacity) + 1e-3 computed by PyTorch at [N] (so
// no logf has to match). The sign of a zero never reaches the decision.
//
// Bound on this card: each per-Gaussian input read once (rect, tiles,
// depth; with the cull also mean2d, conic, thr), the counts written, 24 B a
// live pair written: ~0.1-0.4 GB a 1M-Gaussian render, 30-120 us at
// 3.35 TB/s. The cull test is ~110 FP32 operations (four IEEE divisions) a
// walked tile, 10-30M of them a render: 1.1-3.2 GFLOP, 17-48 us at
// 67 TFLOP/s.
// What the design does about the imbalance between Gaussians: a thread
// walks its own Gaussian when it has at most WIDE tiles; a wider one is
// walked by the whole warp, 32 tiles a round, the live ones placed by a
// ballot's prefix count, so it does not hold 31 idle lanes for its walk.
// In the benchmark cells' 2048^2 sun renders 18-32% of the Gaussians walk
// more than 32 tiles (up to ~360) and hold 40-54% of the walked tiles; the
// warp walk takes 26-40% off each pass there (PERF.md section 6).

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 16;
constexpr int NT = 256;   // threads per block
constexpr int WIDE = 32;  // a Gaussian with more tiles is walked by a warp
constexpr unsigned FULL = 0xffffffffu;

struct Inputs {
  const int* rect_min;   // [N, 2] int32 (x, y)
  const int* rect_size;  // [N, 2] int32 (w, h)
  const int* tiles;      // [N] int32 rect tiles walked
  const float* mean2d;   // [N, 2]
  const float* conic;    // [N, 3]
  const float* thr;      // [N] cull threshold; nullptr: no cull
  long long n;
  int grid_x;
};

struct Gauss {
  int rx, ry, rw, tiles;
  float mx, my, a, b, c, thr;
};

__device__ __forceinline__ Gauss load(const Inputs& in, long long g) {
  Gauss G;
  G.rx = in.rect_min[2 * g];
  G.ry = in.rect_min[2 * g + 1];
  G.rw = max(in.rect_size[2 * g], 1);
  G.tiles = max(in.tiles[g], 0);
  if (in.thr != nullptr) {
    G.mx = in.mean2d[2 * g];
    G.my = in.mean2d[2 * g + 1];
    G.a = in.conic[3 * g];
    G.b = in.conic[3 * g + 1];
    G.c = in.conic[3 * g + 2];
    G.thr = in.thr[g];
  }
  return G;
}

__device__ __forceinline__ bool isnan_(float x) { return x != x; }

// torch.minimum: a NaN in either argument gives NaN
__device__ __forceinline__ float tmin(float x, float y) {
  return isnan_(x) ? x : (isnan_(y) ? y : fminf(x, y));
}

// torch.clamp(t, lo, hi) with tensor bounds: a NaN anywhere gives NaN
__device__ __forceinline__ float tclamp(float t, float lo, float hi) {
  if (isnan_(t)) return t;
  if (isnan_(lo)) return lo;
  if (isnan_(hi)) return hi;
  return fminf(fmaxf(t, lo), hi);
}

__device__ __forceinline__ float quad(float a, float b, float c, float dx,
                                      float dy) {
  float t1 = a * dx;
  t1 = t1 * dx;
  float t2 = 2.0f * b;
  t2 = t2 * dx;
  t2 = t2 * dy;
  float t3 = c * dy;
  t3 = t3 * dy;
  return (t1 + t2) + t3;
}

// _slot_cull_mask for tile (tx, ty) of the Gaussian's rect: every pixel of
// the tile provably has alpha < 1/255 or power > 0.
__device__ __forceinline__ bool dead(const Gauss& G, int tx, int ty) {
  const float x0 = (float)(G.rx + tx) * (float)TILE;
  const float y0 = (float)(G.ry + ty) * (float)TILE;
  const float lx = G.mx - ((x0 + (float)TILE) - 1.0f), ux = G.mx - x0;
  const float ly = G.my - ((y0 + (float)TILE) - 1.0f), uy = G.my - y0;
  float qmin;
  if (lx <= 0.0f && 0.0f <= ux && ly <= 0.0f && 0.0f <= uy) {
    qmin = 0.0f;  // the centre lies in the tile
  } else {
    const float a = G.a, b = G.b, c = G.c;
    const float cs = c > 0.0f ? c : 1e-12f, as = a > 0.0f ? a : 1e-12f;
    const float nb = -b;
    // edge_x(e): dx fixed at e, dy the clamped minimiser
    const float ex_l = quad(a, b, c, lx, tclamp((nb * lx) / cs, ly, uy));
    const float ex_u = quad(a, b, c, ux, tclamp((nb * ux) / cs, ly, uy));
    // edge_y(e): dy fixed at e, dx the clamped minimiser
    const float ey_l = quad(a, b, c, tclamp((nb * ly) / as, lx, ux), ly);
    const float ey_u = quad(a, b, c, tclamp((nb * uy) / as, lx, ux), uy);
    qmin = tmin(tmin(tmin(ex_l, ex_u), tmin(ey_l, ey_u)),
                tmin(tmin(quad(a, b, c, lx, ly), quad(a, b, c, lx, uy)),
                     tmin(quad(a, b, c, ux, ly), quad(a, b, c, ux, uy))));
  }
  return isfinite(qmin) && qmin > G.thr;
}

__device__ __forceinline__ long long tile_id(const Gauss& G, int tx, int ty,
                                             int grid_x) {
  return (long long)(G.ry + ty) * grid_x + (G.rx + tx);
}

// depth_key (ops/binning.py): the float's bits, ordered as the floats
__device__ __forceinline__ long long depth_key(float d) {
  const long long bits = (long long)__float_as_int(d);
  return bits < 0 ? (~bits & 0xFFFFFFFFLL) : (bits | 0x80000000LL);
}

// Gaussians with at most WIDE tiles: this thread's alone, row-major.
__global__ void __launch_bounds__(NT)
count_kernel(Inputs in, long long* lengths) {
  const long long g = (long long)blockIdx.x * NT + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool have = g < in.n;
  const Gauss G = have ? load(in, g) : Gauss{};
  const bool cull = in.thr != nullptr;
  const bool wide = have && cull && G.tiles > WIDE;
  if (have && !wide) {
    long long live = G.tiles;
    if (cull) {
      live = 0;
      int tx = 0, ty = 0;
      for (int j = 0; j < G.tiles; ++j) {
        live += !dead(G, tx, ty);
        if (++tx == G.rw) tx = 0, ++ty;
      }
    }
    lengths[g] = live;
  }
  // the warp walks each wide Gaussian of its lanes together
  unsigned todo = __ballot_sync(FULL, wide);
  while (todo) {
    const int src = __ffs(todo) - 1;
    todo &= todo - 1;
    const long long gw = __shfl_sync(FULL, g, src);
    const Gauss W = load(in, gw);
    long long live = 0;
    for (int base = 0; base < W.tiles; base += 32) {
      const int j = base + lane;
      const bool ok = j < W.tiles && !dead(W, j % W.rw, j / W.rw);
      live += __popc(__ballot_sync(FULL, ok));
    }
    if (lane == src) lengths[gw] = live;
  }
}

__global__ void __launch_bounds__(NT)
write_kernel(Inputs in, const long long* ends, const long long* lengths,
             const float* depth, long long* gid, long long* tile,
             long long* key) {
  const long long g = (long long)blockIdx.x * NT + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool have = g < in.n;
  const Gauss G = have ? load(in, g) : Gauss{};
  const bool cull = in.thr != nullptr;
  const bool wide = have && G.tiles > WIDE;
  if (have && !wide) {
    long long pos = ends[g] - lengths[g];
    const long long dk = key != nullptr ? depth_key(depth[g]) : 0;
    int tx = 0, ty = 0;
    for (int j = 0; j < G.tiles; ++j) {
      if (!cull || !dead(G, tx, ty)) {
        const long long t = tile_id(G, tx, ty, in.grid_x);
        gid[pos] = g;
        tile[pos] = t;
        if (key != nullptr) key[pos] = (t << 32) | dk;
        ++pos;
      }
      if (++tx == G.rw) tx = 0, ++ty;
    }
  }
  unsigned todo = __ballot_sync(FULL, wide);
  while (todo) {
    const int src = __ffs(todo) - 1;
    todo &= todo - 1;
    const long long gw = __shfl_sync(FULL, g, src);
    const Gauss W = load(in, gw);
    long long pos = ends[gw] - lengths[gw];
    const long long dk = key != nullptr ? depth_key(depth[gw]) : 0;
    for (int base = 0; base < W.tiles; base += 32) {
      const int j = base + lane;
      const int tx = j % W.rw, ty = j / W.rw;
      const bool ok = j < W.tiles && (!cull || !dead(W, tx, ty));
      const unsigned live = __ballot_sync(FULL, ok);
      if (ok) {
        const long long at = pos + __popc(live & ((1u << lane) - 1u));
        const long long t = tile_id(W, tx, ty, in.grid_x);
        gid[at] = gw;
        tile[at] = t;
        if (key != nullptr) key[at] = (t << 32) | dk;
      }
      pos += __popc(live);
    }
  }
}

Inputs inputs(const int* rect_min, const int* rect_size, const int* tiles,
              const float* mean2d, const float* conic, const float* thr,
              long long n, int grid_x) {
  return Inputs{rect_min, rect_size, tiles, mean2d, conic, thr, n, grid_x};
}

int blocks(long long n) { return (int)((n + NT - 1) / NT); }

}  // namespace

// Count pass. rect_min, rect_size [n, 2] int32; tiles [n] int32 (the rect
// tiles to walk, min(tiles_touched, tcap)); mean2d [n, 2], conic [n, 3],
// thr [n] float32, all three nullptr for no cull. Writes lengths [n] int64.
// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int eogs2_emit_count(const int* rect_min, const int* rect_size,
                                const int* tiles, const float* mean2d,
                                const float* conic, const float* thr,
                                long long n, int grid_x, long long* lengths,
                                void* stream) {
  if (n > 0) {
    count_kernel<<<blocks(n), NT, 0, (cudaStream_t)stream>>>(
        inputs(rect_min, rect_size, tiles, mean2d, conic, thr, n, grid_x),
        lengths);
  }
  return (int)cudaGetLastError();
}

// Write pass. Inputs as the count pass's; ends [n] int64 the inclusive
// prefix sum of the count pass's lengths [n]; writes gid, tile [P] int64
// and, unless key is nullptr, key [P] int64 from depth [n] float32.
extern "C" int eogs2_emit_write(const int* rect_min, const int* rect_size,
                                const int* tiles, const float* mean2d,
                                const float* conic, const float* thr,
                                long long n, int grid_x, const long long* ends,
                                const long long* lengths, const float* depth,
                                long long* gid, long long* tile,
                                long long* key, void* stream) {
  if (n > 0) {
    write_kernel<<<blocks(n), NT, 0, (cudaStream_t)stream>>>(
        inputs(rect_min, rect_size, tiles, mean2d, conic, thr, n, grid_x),
        ends, lengths, depth, gid, tile, key);
  }
  return (int)cudaGetLastError();
}
