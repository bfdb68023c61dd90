// What the port's blend kernels (K1-K4) share: the tile shape, the skip and
// stop constants of the CUDA reference's renderCUDA (forward.cu), the
// staging of fused-route pairs and of K4's packed slots into shared memory,
// and the backward kernels' warp reduce-scatter. ops/cuda_build.py hashes
// this header with every source that includes it, so an edit here rebuilds
// them all.

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

// the plain versions compare float32 tensors with Python doubles, which
// torch rounds to float32 once: round the same doubles here
#define ALPHA_EPS ((float)(1.0 / 255.0))
#define ALPHA_MAX ((float)0.99)
#define T_EPS ((float)1e-4)
#define POWER_TOL ((float)1e-4)

namespace eogs2 {

constexpr int TILE = 16;
constexpr int PIX = TILE * TILE;  // pixels per tile
constexpr int NC = 5;             // feature channels
constexpr unsigned FULL = 0xffffffffu;

// fused-route payload: 11 fields per pair (mx, my, conic a, b, c, opacity,
// 5 features); the row layout pads each pair to one 64-byte row
constexpr int NF = 11;
constexpr int NFR = 16;

// A fused-route pair as K1 and K2 stage it in shared memory: three 16-byte
// rows, each read by all threads at once (a broadcast LDS.128). r0 and r1
// feed the keep test, r1.w and r2 the composite.
//   r0 = (mx, my, conic a, conic b)
//   r1 = (conic c, alpha cut, opacity, f0)
//   r2 = (f1, f2, f3, f4)
struct __align__(16) Pair {
  float4 r0, r1, r2;
};

constexpr int BATCH = 256;  // pairs per staged batch

// K1 and K2: two horizontally adjacent pixels per thread, so 128 threads
// per tile
constexpr int PPT = 2;
constexpr int NT = PIX / PPT;

// The power below which op * exp(power) < ALPHA_EPS for certain, so the keep
// test fails: log(ALPHA_EPS / op) less a margin of 1e-3 in log space, a
// thousand times the few-ulp error of logf, expf and the product. Skipping
// such a pixel (no exp) is therefore exact: the same pixels are kept, with
// the same bits. Opacity 0 gives +inf (alpha is 0: every pixel skips); a
// negative or NaN opacity gives NaN, which skips none.
__device__ __forceinline__ float alpha_cut(float op) {
  return logf(ALPHA_EPS / op) - 1e-3f;
}

// Start the asynchronous copy (cp.async) of pair p into s, in the payload's
// field order: r0 = fields 0-3, r1 = fields 4-7, r2 = fields 8-11.
// Column layout (K1, K2): field f of pair p at pay[f * stride + p], eleven
// 4-byte copies. Row layout (K3): the 16 floats at pay[p * 16], three
// 16-byte copies (field 11 is zero).
template <bool ROWS>
__device__ __forceinline__ void copy_pair_async(Pair* s,
                                                const float* __restrict__ pay,
                                                long long stride, long long p) {
  if (ROWS) {
    const float* src = pay + p * NFR;
    __pipeline_memcpy_async(&s->r0, src, 16);
    __pipeline_memcpy_async(&s->r1, src + 4, 16);
    __pipeline_memcpy_async(&s->r2, src + 8, 16);
  } else {
    float* dst = &s->r0.x;
#pragma unroll
    for (int f = 0; f < NF; ++f)
      __pipeline_memcpy_async(dst + f, pay + (long long)f * stride + p, 4);
  }
}

// Copy pairs [base, min(base + BATCH, n)) of a tile whose range starts at
// `start` into buf: thread t copies slots t, t + NT, ... and commits one
// cp.async group.
template <bool ROWS>
__device__ __forceinline__ void stage_batch(Pair* buf,
                                            const float* __restrict__ pay,
                                            long long stride, long long start,
                                            int base, int n) {
#pragma unroll
  for (int i = 0; i < BATCH / NT; ++i) {
    const int k = threadIdx.x + i * NT;
    if (base + k < n)
      copy_pair_async<ROWS>(buf + k, pay, stride, start + base + k);
  }
  __pipeline_commit();
}

// Wait for this thread's copies of the batch and rearrange its slots from
// the payload's field order into Pair's (adding the alpha cut). A barrier
// must follow before other threads read the batch.
__device__ __forceinline__ void finish_batch(Pair* buf, int base, int n) {
  __pipeline_wait_prior(0);
#pragma unroll
  for (int i = 0; i < BATCH / NT; ++i) {
    const int k = threadIdx.x + i * NT;
    if (base + k < n) {
      const float4 r1 = buf[k].r1, r2 = buf[k].r2;  // (c, op, f0, f1), (f2..f4, -)
      buf[k].r1 = make_float4(r1.x, alpha_cut(r1.y), r1.y, r1.z);
      buf[k].r2 = make_float4(r1.w, r2.x, r2.y, r2.z);
    }
  }
}

// The tile-local (x, y) of thread t's first pixel; its PPT pixels are (x + i,
// y). Each warp covers an 8 x 8 block of the tile, four lanes to a row, so
// that fewer warps meet a small Gaussian than with whole rows.
__device__ __forceinline__ int2 thread_pixel(int t) {
  constexpr int WB = 8;              // block width in pixels
  constexpr int PER_ROW = WB / PPT;  // lanes per block row
  const int lane = t & 31, warp = t >> 5;
  return make_int2((warp % (TILE / WB)) * WB + (lane % PER_ROW) * PPT,
                   (warp / (TILE / WB)) * (32 / PER_ROW) + lane / PER_ROW);
}

// The power of a pair at a pixel, rounded as the plain versions round it:
// -0.5 (a dx^2 + c dy^2) - b dx dy, with c dy^2 passed in (a pixel row
// shares it).
__device__ __forceinline__ float pair_power(float4 r0, float cdy2, float dx,
                                            float dy) {
  return -0.5f * (r0.z * dx * dx + cdy2) - r0.w * dx * dy;
}

// The largest v over the block's THREADS threads (every thread must call
// it); smem holds THREADS / 32 ints and may be reused once it returns.
template <int THREADS = PIX>
__device__ __forceinline__ int block_max(int v, int* smem) {
  v = __reduce_max_sync(FULL, v);
  if ((threadIdx.x & 31) == 0) smem[threadIdx.x >> 5] = v;
  __syncthreads();
  int m = smem[0];
#pragma unroll
  for (int w = 1; w < THREADS / 32; ++w) m = max(m, smem[w]);
  __syncthreads();
  return m;
}

// The backward kernels (K2, K4) sum 11 values per pair over a warp's pixels
// by a reduce-scatter butterfly: at the shuffle of offset o a lane keeps half
// of its values (chosen by lane bit o) and sends the other half, so the 11
// values, padded to NV = 16, take 8 + 4 + 2 + 1 + 1 = 16 shuffles instead of
// 55, and each field's warp sum lands on its own pair of lanes.
constexpr int NV = 16;

// One step of recursive halving: lanes l and l ^ 2H swap halves of v[0, 2H)
// so that each keeps the sum of one half, selected by its lane bit 2H. H is
// a template parameter so that every index is a constant and v stays in
// registers.
template <int H>
__device__ __forceinline__ void halve(float (&v)[NV], int lane) {
  const bool upper = lane & (2 * H);
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = upper ? v[i] : v[i + H];
    const float keep = upper ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(FULL, send, 2 * H);
  }
}

// The warp sum of field (lane >> 1) of v, on every lane: 16 shuffles.
// v is clobbered.
__device__ __forceinline__ float warp_reduce_scatter(float (&v)[NV], int lane) {
  halve<8>(v, lane);
  halve<4>(v, lane);
  halve<2>(v, lane);
  halve<1>(v, lane);
  return v[0] + __shfl_xor_sync(FULL, v[0], 1);
}

// ---- K4: the dense routes' packed table ------------------------------------
//
// data [T, 16, K] float32: field f of slot k of a tile at tile * 16 K + f K
// + k, rows 0-10 the fused route's 11 fields, row 11 the mask (1 = a pair),
// rows 12-15 unused. A tile's rows are the column layout with stride K.

// The number of slots up to the tile's last pair (mask row set), so the
// kernels skip the trailing empty slots: an empty slot changes nothing
// (alpha 0, log1p(-0) = 0) and stays live. Every thread of the NT-thread
// block calls it.
__device__ __forceinline__ int slots_in_use(const float* __restrict__ mask,
                                            int K, int* smem) {
  int last = 0;  // each thread's slots rise, so its last set one wins
  for (int k = threadIdx.x; k < K; k += NT)
    if (mask[k] > 0.5f) last = k + 1;
  return block_max<NT>(last, smem);
}

// Copy slots [lo, lo + n) of a tile (n <= BATCH) into buf[0, n): thread t
// copies slots t, t + NT, ..., 12 rows each (the 11 fields as K1 copies a
// column payload with stride K, then the mask into r2.w), and commits one
// cp.async group.
__device__ __forceinline__ void stage_slots(Pair* buf,
                                            const float* __restrict__ tile,
                                            int K, int lo, int n) {
#pragma unroll
  for (int i = 0; i < BATCH / NT; ++i) {
    const int k = threadIdx.x + i * NT;
    if (k < n) {
      copy_pair_async<false>(buf + k, tile, K, lo + k);
      __pipeline_memcpy_async(&buf[k].r2.w, tile + (long long)NF * K + lo + k,
                              4);
    }
  }
  __pipeline_commit();
}

// The warps whose 8 x 8 pixel block (thread_pixel: warp w covers tile-local
// x in [8 (w % 2), 8 (w % 2) + 8), y in [8 (w / 2), 8 (w / 2) + 8)) may hold
// a pixel that passes the cheap keep test of a slot, power <= 0 and
// !(power < cut): bit w for warp w. With M = [[a, b], [b, c]] and Q = d^T M
// d, power = -Q / 2, so a passing pixel lies in the ellipse Q <= -2 cut,
// whose half-widths are sqrt(-2 cut c / det) and sqrt(-2 cut a / det),
// det = ac - b^2. Computed in double and widened, so that no block whose
// pixels could pass by the float arithmetic of pair_power is left out:
// that arithmetic errs by at most ~7 ulp of (a + c)^2 / det times |power|
// (a few 1e-7 relative of Q), and the ellipse is grown by 1e-5 of that
// ratio, plus 1e-2 px. A skipped slot fails the cheap test at every pixel
// of the block, so skipping it decides nothing. Where the region is
// unbounded or ill-conditioned (not positive definite, (a + c)^2 / det >
// 1e4, a NaN cut: every pixel passes it, an infinite one) every block is
// marked; where no power can pass (cut > 0, +inf for an empty slot) none.
// A NaN centre marks none: its power is NaN at every pixel.
__device__ __forceinline__ unsigned slot_blocks(float4 r0, float c, float cut,
                                                float ox, float oy) {
  if (!(cut <= 0.0f)) return cut > 0.0f ? 0u : 0xfu;
  const double a = r0.z, b = r0.w, cc = c;
  const double det = a * cc - b * b;
  if (!(a > 0.0 && det > 0.0)) return 0xfu;
  const double inv_det = 1.0 / det;
  const double r2 = -2.0 * (double)cut;
  const double cond = (a + cc) * (a + cc) * inv_det;
  if (!(cond <= 1e4 && r2 < 1e300)) return 0xfu;
  const double grow = r2 * (1.0 + 1e-5 * cond) * inv_det;
  const double hx = sqrt(grow * cc) + 1e-2, hy = sqrt(grow * a) + 1e-2;
  const double mx = (double)r0.x - ox, my = (double)r0.y - oy;
  unsigned bits = 0;
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) {
    const double bx = 8 * (w % 2), by = 8 * (w / 2);
    if (mx - hx <= bx + 7 && mx + hx >= bx && my - hy <= by + 7 &&
        my + hy >= by)
      bits |= 1u << w;
  }
  return bits;
}

// K4's finish_batch: wait for this thread's copies and rearrange its slots
// into Pair's order with the mask folded into the alpha cut: +inf for an
// empty slot, whose power then never passes !(power < cut), whatever its
// fields hold (NaN power fails power <= 0 first). Each slot's slot_blocks
// for the tile at (ox, oy) goes to blocks[k]. A barrier must follow.
__device__ __forceinline__ void finish_slots(Pair* buf, unsigned char* blocks,
                                             int n, float ox, float oy) {
  __pipeline_wait_prior(0);
#pragma unroll
  for (int i = 0; i < BATCH / NT; ++i) {
    const int k = threadIdx.x + i * NT;
    if (k < n) {
      // (c, op, f0, f1), (f2, f3, f4, mask)
      const float4 r0 = buf[k].r0, r1 = buf[k].r1, r2 = buf[k].r2;
      const float cut =
          r2.w > 0.5f ? alpha_cut(r1.y) : __int_as_float(0x7f800000);  // +inf
      buf[k].r1 = make_float4(r1.x, cut, r1.y, r1.z);
      buf[k].r2 = make_float4(r1.w, r2.x, r2.y, r2.z);
      blocks[k] = (unsigned char)slot_blocks(r0, r1.x, cut, ox, oy);
    }
  }
}

// K4's alpha, min(0.99, op G) with a NaN kept NaN, as torch.clamp_max keeps
// it in the plain versions (fminf would give 0.99): a NaN opacity is then
// never kept, since NaN >= 1/255 is false.
__device__ __forceinline__ float clamp_alpha(float opG) {
  return opG > ALPHA_MAX ? ALPHA_MAX : opG;
}

}  // namespace eogs2
