// The core of the two NHWC conv prototypes' kernels, K5 (conv_proto.cu) and
// K7 (lowcin_nhwc.cu): a reflect-padded SAME stride-1 conv forward of NHWC x
// with a weight (k, k, cin, cout), NHWC y (n, h, w, cout) in x's dtype, f32
// accumulation and one rounding. The two kernels differ only in their loader
// (Source): K5 reads its wrapper's reflect-padded copy of x, each padded row
// one flat run; K7 reads x itself and reflects each chunk's source position.
//
// The GEMM of one tile: M = R output rows x BM columns, N = a tile of BN
// output channels, K = taps x channels in chunks of 16 bytes (8 bf16
// channels; cin is zero-filled to a whole chunk, cin_s), two chunks per mma
// step of 16. The taps are walked in each TPU kernel's contraction order:
// K5 (dy, dx, ci), the im2col of pallas_conv_proto.py; K7 (dx, dy, ci), the
// k dx-shifted GEMMs of pallas_conv3.py.
//
// - The slab: the R + k - 1 input rows under a tile, sp = BM + k - 1
//   positions each, channel-innermost in shared memory, a position's chunks
//   at an odd stride (ps chunks: cin_s / 8, or one more), so the 8 rows of
//   an ldmatrix (8 consecutive positions) fall in distinct banks. Tap (dy,
//   dx) of output (r, m) is slab position (r + dy) * sp + m + dx, so A
//   fragments come by ldmatrix.x4 at any dx, each lane giving its own
//   position's address; the lane steps its chunk offset through the taps
//   itself (Walk): no offset table and no 2-byte gathers.
// - The weights: resident per block for its N tile, as [cout][K] with K
//   contiguous (the wrappers' layout), rows at an odd stride in chunks; B
//   fragments by ldmatrix.x4 (two n8 fragments per load).
// - The pipeline: persistent blocks, one wave of them walking the flat
//   (image, band of R rows, column tile) space; a ring of two slabs filled
//   by cp.async 16-byte copies in commit groups: the next tile's slab is in
//   flight while the tensor cores run on this one. Where cin is not a whole
//   number of chunks (the head's 3, the edges' 5) the ring holds raw rows
//   instead: each source row's span under the slab from its 16-byte boundary
//   (16-byte cp.async, the last one partial), and the slab is built from it
//   in shared memory (zeros past cin) before the tile's products.
// - The epilogue: the tile goes to shared memory (in the slab slot it was
//   computed from, where it fits), then out as 16-byte NHWC stores: per
//   position and chunk of channels where cout is a multiple of 8, else
//   packed, each tile row one run of positions x cout in aligned 16-byte
//   groups with scalar ends.
// - FOLD (k * cout <= kFoldCols: K5's tail, cout 3): the dx taps folded into
//   N, as K3 does (starved_conv.cu): N = (co, dx), K = (dy, ci), M = slab
//   positions; the epilogue sums each co over its k dx-shifted positions, dx
//   ascending, in f32, then rounds once. Unfolded, the tail would fill 3 of
//   every 16 columns.
// - f32 (the checks) runs the same walk with FMAs on the CUDA cores (TF32
//   would not keep f32's precision), each thread R * BM * BN / 256 outputs.
// - Each output's products are summed in one fixed order and there are no
//   atomics: a launch repeats bit for bit.
//
// Tiles (dispatch, below) were chosen from phase timings per tile (clock64
// in an instrumented copy) and CUDA-event times on the card: the K loop is bounded
// by ldmatrix traffic (192 bytes per mma at 64 x 32 warp tiles, 128 at
// 64 x 64), and the copies and stores of a tile run as phases of their own
// beside it; taller and wider tiles (R = 2, BM = 256 where it fits; R = 4
// for the fold) spread those phases over more outputs. Spreading the next
// tile's copies and the last tile's stores over the K loop's steps, or two
// blocks per SM, were slower.
//
// wgmma is a later step: a dx-shifted A tile starts at any position, which a
// wgmma shared-memory descriptor (8-row core matrices at fixed strides)
// cannot describe, so wgmma here would take A from registers (ldmatrix-
// loaded, as now) and B from a swizzled weight tile.
#pragma once

#include <stdint.h>
#include <string.h>

#include <climits>
#include <type_traits>

#include "igemm.cuh"
#include "ptx.cuh"

namespace vct {
namespace nhwc {

constexpr int kThreads = 256;  // 8 warps
using igemm::kDefaultSmem;
using igemm::kMaxSmem;
constexpr int kFoldCols = 32;  // fold the dx taps into N where k * cout <= this
constexpr int kStages = 2;      // slabs in the ring

enum class Source { kPadded, kReflect };

// What a launch computes and how it is cut; filled on the host. Positions,
// chunks (16 bytes) and elements as named.
struct Shape {
  int n, h, wd, cin, cout, k, p;
  int G;         // chunks per input position: cin_s / V
  int ps;        // slab position stride in chunks (odd)
  int sp;        // slab positions per slab row
  int src_w;     // positions per source row: w + 2p (padded) or w
  int src_rows;  // source rows per image: h + 2p + 1 (padded) or h
  int n_out, n_in, os, is;  // taps: outer x inner, their strides in positions
  int nchunks;   // K chunks: taps x G
  int kc;        // nchunks rounded up to even (mma steps of two chunks)
  int wstride;   // weight row stride in chunks (odd, >= kc)
  int wrows;     // rows of the weight: cout, or cout * k (FOLD)
  int bmo;       // output columns per tile row
  int tiles_w, bands, tiles_n;
  int tiles;         // spatial tiles: n * bands * tiles_w
  int stage_bytes;   // one slab: (R + k - 1) rows of sp positions
  int staging;       // byte offset of the staged tile, or -1: in the slab
                     // slot of the tile just computed
  int compact;       // byte offset of the tile's outputs, packed NHWC
  int raw, raw_row;  // byte offset of the raw rows (cin not a whole number
                     // of chunks), and each one's bytes
};

__device__ __forceinline__ int reflect_index(int i, int n) {
  i = i < 0 ? -i : i;
  i = i >= n ? 2 * n - 2 - i : i;
  return min(max(i, 0), n - 1);
}

// f(r, q) for every cell of a rows x cols grid, the block's threads taking
// the cells in turn, q fastest (no division per cell)
template <class F>
__device__ __forceinline__ void grid2(int rows, int cols, F&& f) {
  const int dr = kThreads / cols, dq = kThreads - dr * cols;
  int r = threadIdx.x / cols, q = threadIdx.x - r * cols;
  while (r < rows) {
    f(r, q);
    r += dr, q += dq;
    if (q >= cols) q -= cols, ++r;
  }
}

// A lane's walk over the K chunks of its A rows: chunk j is channel chunk g
// of tap (outer, inner); offset() is its slab chunk offset from the row's
// position (chunk 0 past the last chunk, whose weights are zero).
struct Walk {
  int j, g, in, toff;
  __device__ __forceinline__ explicit Walk(int j0, const Shape& s)
      : j(0), g(0), in(0), toff(0) {
    for (int i = 0; i < j0; ++i) next(s);
  }
  __device__ __forceinline__ int offset(const Shape& s) const {
    return j < s.nchunks ? toff * s.ps + g : 0;
  }
  __device__ __forceinline__ void next(const Shape& s) {
    ++j;
    if (++g == s.G) {
      g = 0;
      toff += s.is;
      if (++in == s.n_in) {
        in = 0;
        toff += s.os - s.n_in * s.is;
      }
    }
  }
};

// A thread's walk over its cells of an A x B x C grid (c fastest): cells
// tid, tid + kThreads, ... in order, with no division per step.
struct Cursor {
  int a, b, c, A, B, C, db, dc;
  __device__ __forceinline__ void start(int A_, int B_, int C_) {
    A = A_, B = B_, C = C_;
    db = kThreads / C, dc = kThreads - db * C;
    c = threadIdx.x % C;
    const int rest = threadIdx.x / C;
    b = rest % B, a = rest / B;
  }
  __device__ __forceinline__ bool more() const { return a < A; }
  __device__ __forceinline__ void next() {
    c += dc;
    if (c >= C) c -= C, ++b;
    b += db;
    while (b >= B) b -= B, ++a;
  }
};

template <typename T>
__device__ __forceinline__ uint4 pack(const T (&e)[16 / sizeof(T)]) {
  uint4 u;
  memcpy(&u, e, 16);
  return u;
}

// One block's work: R output rows x BM columns per tile (M = R * BM), BN
// output channels (the N tile blockIdx.y), its tiles blockIdx.x + i *
// gridDim.x of the flat (image, band of R rows, column tile) space.
template <typename T, int R, int BM, int BN, int WARPS_M, bool FOLD,
          Source SRC>
__device__ __forceinline__ void conv_body(const T* __restrict__ x,
                                          const T* __restrict__ wk,
                                          T* __restrict__ y, const Shape& s) {
  constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  constexpr int V = 16 / sizeof(T);
  constexpr int M = R * BM;
  using Stage = std::conditional_t<FOLD, float, T>;
  constexpr int SS = BN + 16 / (int)sizeof(Stage);  // staging row stride
  const int tid = threadIdx.x;
  const int n0 = blockIdx.y * BN;
  const int nreal = min(BN, s.cout - n0);

  // shared memory: weights [BN][wstride chunks] | kStages slabs
  // [R + k - 1][sp][ps chunks] | staging [M][SS] (unless in the slab slot)
  // | compact outputs
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* wsm = smem;
  unsigned char* slab = smem + (size_t)BN * s.wstride * 16;
  T* compact = reinterpret_cast<T*>(smem + s.compact);

  // the block's weights: rows n0 .. n0 + BN - 1, chunks 0 .. kc - 1; zeros
  // past the weight's rows and chunks (once per block, in the first group)
  for (int i = tid; i < BN * s.kc; i += kThreads) {
    const int row = i / s.kc, ch = i - row * s.kc;
    const bool ok = n0 + row < s.wrows && ch < s.nchunks;
    ptx::cp_async16_or_zero(
        wsm + ((size_t)row * s.wstride + ch) * 16,
        ok ? wk + ((long long)(n0 + row) * s.nchunks + ch) * V : wk, ok);
  }

  // tile t: its image, first output row and first output column; slab
  // position q of its slab row rr is padded column c0 + q of padded row
  // r0 + rr
  struct Where {
    int img, r0, c0;
  };
  auto where = [&](int t) {
    Where w;
    const int ib = t / s.tiles_w;  // image * bands + band
    w.c0 = (t - ib * s.tiles_w) * s.bmo;
    w.img = ib / s.bands;
    w.r0 = (ib - w.img * s.bands) * R;
    return w;
  };
  // the source row of slab row rr (rows past the image, under a last band
  // that R does not fill, feed unstored outputs: clamped)
  auto row_of = [&](const Where& w, int rr) -> const T* {
    if constexpr (SRC == Source::kPadded)
      return x + ((long long)w.img * s.src_rows + min(w.r0 + rr, s.src_rows - 1)) *
                     s.src_w * s.cin;
    else
      return x + ((long long)w.img * s.h + reflect_index(w.r0 + rr - s.p, s.h)) *
                     s.wd * s.cin;
  };
  // the source position of slab position q, and whether it holds data
  auto col_of = [&](const Where& w, int q, bool& ok) -> int {
    if constexpr (SRC == Source::kPadded) {
      const int col = w.c0 + q;
      ok = col < s.src_w;  // past the padded row: zeros
      return ok ? col : 0;
    } else {
      ok = true;  // past the reflected row (unstored outputs): clamped
      return reflect_index(w.c0 + q - s.p, s.wd);
    }
  };
  const int slab_rows = R + s.k - 1;
  auto slot_at = [&](int slot) { return slab + (size_t)slot * s.stage_bytes; };
  // whole chunks of channels (cin a multiple of V): cp.async copies
  const bool async = s.cin % V == 0;
  auto load = [&](int t, int slot) {
    const Where w = where(t);
    for (int rr = 0; rr < slab_rows; ++rr) {
      const T* src = row_of(w, rr);
      unsigned char* d = slot_at(slot) + (size_t)rr * s.sp * s.ps * 16;
      grid2(s.sp, s.G, [&](int q, int g) {
        bool ok;
        const int col = col_of(w, q, ok);
        ptx::cp_async16_or_zero(d + (q * s.ps + g) * 16, src + col * s.cin + g * V,
                                ok);
      });
    }
  };
  // else (the head's 3 channels, the edges' 5) each source row's span under
  // the slab, from its 16-byte boundary, by cp.async into a raw row; then,
  // once it is in, each slab chunk is built from the raw row in shared
  // memory (zeros past cin), so no thread waits on device memory. The span
  // of slab row rr: its first byte `lo` and its length.
  unsigned char* raw = smem + s.raw;
  auto span_of = [&](const Where& w, int rr, const unsigned char*& lo) {
    const T* row = row_of(w, rr);
    int c_lo, c_hi;
    if constexpr (SRC == Source::kPadded) {
      c_lo = w.c0, c_hi = min(w.c0 + s.sp, s.src_w);
    } else {
      c_lo = max(w.c0 - s.p, 0), c_hi = min(w.c0 - s.p + s.sp, s.wd);
    }
    const uintptr_t a = reinterpret_cast<uintptr_t>(row + c_lo * s.cin);
    lo = reinterpret_cast<const unsigned char*>(a & ~(uintptr_t)15);
    return c_hi > c_lo ? (int)(reinterpret_cast<uintptr_t>(row + c_hi * s.cin) -
                               reinterpret_cast<uintptr_t>(lo))
                       : 0;
  };
  auto raw_at = [&](int slot, int rr) {
    return raw + ((size_t)slot * slab_rows + rr) * s.raw_row;
  };
  auto load_raw = [&](int t, int slot) {
    const Where w = where(t);
    Cursor cu;
    for (cu.start(slab_rows, s.raw_row / 16, 1); cu.more(); cu.next()) {
      const unsigned char* lo;
      const int left = span_of(w, cu.a, lo) - 16 * cu.b;
      if (left > 0)
        ptx::cp_async16_part(raw_at(slot, cu.a) + 16 * cu.b, lo + 16 * cu.b,
                             min(left, 16));
    }
  };
  auto expand = [&](int t, int slot) {
    const Where w = where(t);
    uint4* dst = reinterpret_cast<uint4*>(slot_at(slot));
    Cursor cu;
    for (cu.start(slab_rows, s.sp, s.G); cu.more(); cu.next()) {
      bool ok;
      const int col = col_of(w, cu.b, ok);
      const unsigned char* lo;
      const int len = span_of(w, cu.a, lo);
      // positions past the span (far past a reflected edge) feed only
      // unstored outputs: zeros
      const long long off =
          reinterpret_cast<const unsigned char*>(row_of(w, cu.a) + col * s.cin) - lo;
      ok = ok && off >= 0 && off + (long long)s.cin * sizeof(T) <= len;
      const T* src = reinterpret_cast<const T*>(raw_at(slot, cu.a) + (ok ? off : 0));
      T e[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int ci = cu.c * V + j;
        e[j] = ok && ci < s.cin ? src[ci] : igemm::from_f<T>(0.f);
      }
      dst[(cu.a * s.sp + cu.b) * s.ps + cu.c] = pack<T>(e);
    }
  };

  const int first = blockIdx.x, step = gridDim.x;
  const int count = first < s.tiles ? (s.tiles - 1 - first) / step + 1 : 0;
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < count) {
      if (async)
        load(first + i * step, i);
      else
        load_raw(first + i * step, i);
    }
    ptx::cp_async_commit();
  }

  for (int i = 0; i < count; ++i) {
    ptx::cp_async_wait<kStages - 2>();
    __syncthreads();  // tile i's slab is in; every warp is done with i - 1
    if (!async) expand(first + i * step, i % kStages);
    if (i + kStages - 1 < count) {
      if (async)
        load(first + (i + kStages - 1) * step, (i + kStages - 1) % kStages);
      else
        load_raw(first + (i + kStages - 1) * step, (i + kStages - 1) % kStages);
    }
    ptx::cp_async_commit();
    if (!async) __syncthreads();  // the slab is built
    unsigned char* cur = slab + (size_t)(i % kStages) * s.stage_bytes;
    Stage* out = reinterpret_cast<Stage*>(s.staging < 0 ? cur : smem + s.staging);
    // slab position of A row m: its tile row's slab row, then its column
    auto pos = [](int m, const Shape& sh) { return (m / BM) * sh.sp + m % BM; };

    if constexpr (kMma) {
      constexpr int WARPS_N = 8 / WARPS_M;
      constexpr int WM = M / WARPS_M, WN = BN / WARPS_N;
      constexpr int MI = WM / 16, NI = WN / 8;
      static_assert(WARPS_M * WARPS_N == 8 && WM % 16 == 0 && WN % 16 == 0 &&
                        BM % 16 == 0, "tile");
      const int warp = tid >> 5, lane = tid & 31;
      const int wm = warp / WARPS_N, wn = warp % WARPS_N;
      // A: the lane's row of each 16-row fragment and its chunk (of two);
      // B: its row of a 16-row pair of n8 fragments and its chunk
      unsigned abase[MI];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
        abase[mi] = ptx::smem_addr(cur) +
                    (unsigned)(pos(wm * WM + mi * 16 + (lane & 15), s) * s.ps) * 16;
      const unsigned bbase =
          ptx::smem_addr(wsm) +
          (unsigned)((wn * WN + (lane & 7) + ((lane >> 4) << 3)) * s.wstride +
                     ((lane >> 3) & 1)) * 16;
      Walk walk(lane >> 4, s);
      float acc[MI][NI][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
      const int steps = s.kc / 2;
#pragma unroll 4
      for (int ks = 0; ks < steps; ++ks) {
        const unsigned ao = (unsigned)walk.offset(s) * 16;
        uint32_t af[MI][4], bf[NI][2];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) ptx::ldmatrix_x4(af[mi], abase[mi] + ao);
#pragma unroll
        for (int nj = 0; nj < NI / 2; ++nj) {
          uint32_t r[4];
          ptx::ldmatrix_x4(
              r, bbase + (unsigned)(nj * 16 * s.wstride + 2 * ks) * 16);
          bf[2 * nj][0] = r[0], bf[2 * nj][1] = r[1];
          bf[2 * nj + 1][0] = r[2], bf[2 * nj + 1][1] = r[3];
        }
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int ni = 0; ni < NI; ++ni) igemm::mma_bf16(acc[mi][ni], af[mi], bf[ni]);
        walk.next(s);
        walk.next(s);
      }
      __syncthreads();  // every warp is done with the slab (the staging may be in it)
      // C fragment: c0, c1 at row gid, columns 2 tig (+1); c2, c3 row gid + 8
      const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int m = wm * WM + mi * 16 + gid + 8 * hf;
            const int n = wn * WN + ni * 8 + 2 * tig;
            const float v0 = acc[mi][ni][2 * hf], v1 = acc[mi][ni][2 * hf + 1];
            if constexpr (FOLD) {
              *reinterpret_cast<float2*>(out + m * SS + n) = make_float2(v0, v1);
            } else {
              *reinterpret_cast<__nv_bfloat162*>(out + m * SS + n) =
                  __floats2bfloat162_rn(v0, v1);
            }
          }
    } else {
      constexpr int PER = M * BN / kThreads;
      const T* S = reinterpret_cast<const T*>(cur);
      const T* W = reinterpret_cast<const T*>(wsm);
      float acc[PER];
#pragma unroll
      for (int e = 0; e < PER; ++e) acc[e] = 0.f;
      Walk walk(0, s);
      for (int j = 0; j < s.nchunks; ++j) {
        const int off = walk.offset(s);
#pragma unroll
        for (int e = 0; e < V; ++e)
#pragma unroll
          for (int o = 0; o < PER; ++o) {
            const int idx = tid + o * kThreads, m = idx / BN, n = idx % BN;
            acc[o] = fmaf(igemm::to_f(S[(off + pos(m, s) * s.ps) * V + e]),
                          igemm::to_f(W[((size_t)n * s.wstride + j) * V + e]),
                          acc[o]);
          }
        walk.next(s);
      }
      __syncthreads();  // every thread is done with the slab
#pragma unroll
      for (int o = 0; o < PER; ++o) {
        const int idx = tid + o * kThreads;
        out[(idx / BN) * SS + idx % BN] = acc[o];
      }
    }
    __syncthreads();  // the tile is staged

    const Where w = where(first + i * step);
    const int mreal = min(s.bmo, s.wd - w.c0);
    const int rows = min(R, s.h - w.r0);
    // y offset of output column c0 + m of tile row rr, channel n0
    auto at = [&](int rr, int m) {
      return (((long long)w.img * s.h + w.r0 + rr) * s.wd + w.c0 + m) * s.cout + n0;
    };
    if (!FOLD && s.cout % V == 0) {
      // per output position, 16-byte chunks of the tile's channels: one tile
      // row at a time, 32-bit offsets from the row's start
      for (int rr = 0; rr < rows; ++rr) {
        T* dst = y + at(rr, 0);
        const Stage* src = out + rr * BM * SS;
        grid2(mreal, nreal / V, [&](int m, int g) {
          *reinterpret_cast<uint4*>(dst + m * s.cout + g * V) =
              *reinterpret_cast<const uint4*>(src + m * SS + g * V);
        });
      }
    } else {
      // the outputs, rounded, packed as NHWC runs (FOLD: each co summed over
      // its k dx-shifted slab positions, dx ascending)
      Cursor cu;
      for (cu.start(rows, mreal, nreal); cu.more(); cu.next()) {
        const int m = cu.a * BM + cu.b, n = cu.c;
        float v;
        if constexpr (FOLD) {
          v = 0.f;
          for (int dx = 0; dx < s.k; ++dx) v += out[(m + dx) * SS + n * s.k + dx];
        } else {
          v = igemm::to_f(out[m * SS + n]);
        }
        compact[(cu.a * mreal + cu.b) * nreal + n] = igemm::from_f<T>(v);
      }
      __syncthreads();
      if (nreal == s.cout) {
        // each tile row one run of mreal * cout elements: 16-byte groups
        // aligned in y, scalar stores at the two ends
        const int len = mreal * s.cout;
        for (cu.start(rows, len / V + 2, 1); cu.more(); cu.next()) {
          const long long g0 = at(cu.a, 0), qq = g0 / V + cu.b;
          const int e0 = (int)(qq * V - g0);
          if (e0 >= len) continue;
          const T* src = compact + cu.a * len;
          if (e0 >= 0 && e0 + V <= len) {
            T e[V];
#pragma unroll
            for (int j = 0; j < V; ++j) e[j] = src[e0 + j];
            *reinterpret_cast<uint4*>(y + qq * V) = pack<T>(e);
          } else {
#pragma unroll
            for (int j = 0; j < V; ++j)
              if (e0 + j >= 0 && e0 + j < len) y[qq * V + j] = src[e0 + j];
          }
        }
      } else {
        // a channel tile of a cout that is not a multiple of V
        for (cu.start(rows, mreal, nreal); cu.more(); cu.next())
          y[at(cu.a, cu.b) + cu.c] = compact[(cu.a * mreal + cu.b) * nreal + cu.c];
      }
    }
  }
  ptx::cp_async_wait_all();  // no copy in flight at exit
}

inline int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      count = 132;
  }
  return count;
}

inline long long cdiv(long long a, long long b) { return (a + b - 1) / b; }
inline size_t align16(size_t b) { return (b + 15) / 16 * 16; }

// The shape of a launch before its tiles are cut: V elements per chunk.
inline bool make_shape(Shape& s, int n, int h, int wd, int cin, int cout,
                       int k, bool fold, Source src, int V) {
  if (n <= 0 || h <= 0 || wd <= 0 || cin <= 0 || cout <= 0 || k <= 0 ||
      k % 2 == 0 || k / 2 >= h || k / 2 >= wd || (fold && k * cout > kFoldCols) ||
      (long long)k * k * cin > INT_MAX / 64 ||
      (long long)(wd + k) * (cin > cout ? cin : cout) > INT_MAX / 16)
    return false;
  s = Shape{};
  s.n = n, s.h = h, s.wd = wd, s.cin = cin, s.cout = cout, s.k = k;
  s.p = k / 2;
  s.G = (int)cdiv(cin, V);
  s.ps = s.G | 1;
  const bool padded = src == Source::kPadded;
  s.src_w = padded ? wd + 2 * s.p : wd;
  s.src_rows = padded ? h + 2 * s.p + 1 : h;
  s.wrows = fold ? cout * k : cout;
  return true;
}

// Cut `s` for R x BM by BN tiles and the tap order K::kDxOuter names (K7:
// dx outermost); the shared memory a block then takes.
template <class K, typename T, int R, int BM, int BN, bool FOLD>
size_t plan(Shape& s) {
  using Stage = std::conditional_t<FOLD, float, T>;
  constexpr int V = 16 / sizeof(T);
  const int k = s.k;
  s.sp = FOLD ? BM : BM + k - 1;
  s.bmo = FOLD ? BM - k + 1 : BM;
  if (FOLD) {
    // K = (dy, ci), the dx taps in N
    s.n_out = k, s.os = s.sp, s.n_in = 1, s.is = 0;
  } else if (K::kDxOuter) {
    s.n_out = k, s.os = 1, s.n_in = k, s.is = s.sp;
  } else {
    s.n_out = k, s.os = s.sp, s.n_in = k, s.is = 1;
  }
  s.nchunks = s.n_out * s.n_in * s.G;
  s.kc = (s.nchunks + 1) / 2 * 2;
  s.wstride = s.kc | 1;
  s.tiles_w = (int)cdiv(s.wd, s.bmo);
  s.bands = (int)cdiv(s.h, R);
  s.tiles_n = FOLD ? 1 : (int)cdiv(s.wrows, BN);
  const long long tiles = (long long)s.n * s.bands * s.tiles_w;
  const size_t weights = (size_t)BN * s.wstride * 16;
  const size_t stage = (size_t)(R + k - 1) * s.sp * s.ps * 16;
  const size_t staging = (size_t)R * BM * (BN + 16 / sizeof(Stage)) * sizeof(Stage);
  if (s.bmo < 1 || tiles > INT_MAX || stage > INT_MAX || s.tiles_n > 65535)
    return SIZE_MAX;
  s.tiles = (int)tiles;
  s.stage_bytes = (int)stage;
  size_t smem = weights + kStages * stage;
  s.staging = -1;  // in the slab slot of the tile just computed, if it fits
  if (staging > stage) {
    s.staging = (int)smem;
    smem += align16(staging);
  }
  s.compact = (int)smem;
  if (FOLD || s.cout % V != 0) smem += align16((size_t)R * BM * BN * sizeof(T));
  // a raw row: the span of sp positions from its 16-byte boundary
  s.raw = (int)smem;
  s.raw_row = (int)align16((size_t)s.sp * s.cin * sizeof(T) + 15);
  if (s.cin % V != 0) smem += (size_t)kStages * (R + k - 1) * s.raw_row;
  return smem;
}

// Launch K's kernel (conv_body's instantiation; K::template get<T, R, BM,
// BN, WARPS_M, FOLD>()) on `s` cut by plan.
template <class K, typename T, int R, int BM, int BN, int WARPS_M, bool FOLD>
cudaError_t run(const void* x, const void* wk, void* y, Shape s,
                cudaStream_t stream) {
  const auto kernel = K::template get<T, R, BM, BN, WARPS_M, FOLD>();
  const size_t smem = plan<K, T, R, BM, BN, FOLD>(s);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  // per instantiation: the shared-memory limit raised so far, and the blocks
  // per SM of the last size asked (the host calls are made once per size)
  static size_t raised = kDefaultSmem, asked = 0;
  static int per_sm = 1;
  if (smem > raised) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    raised = smem;
  }
  if (smem != asked) {
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                      smem) != cudaSuccess ||
        per_sm < 1)
      per_sm = 1;
    asked = smem;
  }
  // one wave: as many blocks as fit on the card at once, split over the N
  // tiles, each walking its spatial tiles with a stride of the wave
  const long long slots = (long long)sm_count() * per_sm;
  long long bx = cdiv(slots, s.tiles_n);
  if (bx > s.tiles) bx = s.tiles;
  kernel<<<dim3((unsigned)bx, (unsigned)s.tiles_n), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wk), static_cast<T*>(y),
      s);
  return cudaGetLastError();
}

// The tile configurations (R x BM by BN; warp tiles): bf16 on the tensor
// cores with 8 warps: 2 x 256 by 64 (64 x 64), or 2 x 128 by 64 (64 x 32)
// where that slab does not fit shared memory (cin past 32 at k 3); 2 x 64
// by 128 where cout > 64 (64 x 32); 2 x 64 by 16 where cout <= 16 (16 x
// 16); 4 x 64 by 32 folded (32 x 32). f32, one row: 64 by 32, 64 by 16, 32
// by 32 folded.
template <class K, typename T>
cudaError_t dispatch(const void* x, const void* wk, void* y, const Shape& s,
                     bool fold, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (fold) return run<K, T, 4, 64, 32, 8, true>(x, wk, y, s, stream);
    if (s.cout <= 16) return run<K, T, 2, 64, 16, 8, false>(x, wk, y, s, stream);
    if (s.cout > 64) return run<K, T, 2, 64, 128, 2, false>(x, wk, y, s, stream);
    Shape t = s;
    if (plan<K, T, 2, 256, 64, false>(t) <= kMaxSmem)
      return run<K, T, 2, 256, 64, 8, false>(x, wk, y, s, stream);
    return run<K, T, 2, 128, 64, 4, false>(x, wk, y, s, stream);
  } else {
    if (fold) return run<K, T, 1, 32, 32, 8, true>(x, wk, y, s, stream);
    if (s.cout <= 16) return run<K, T, 1, 64, 16, 8, false>(x, wk, y, s, stream);
    return run<K, T, 1, 64, 32, 8, false>(x, wk, y, s, stream);
  }
}

// The C entry points' body: x (K5: the padded copy), the weight wk
// (wrows, nchunks * V) and y; dtype vct::kFloat32 or vct::kBFloat16.
template <class K>
int entry(const void* x, const void* wk, void* y, int n, int h, int wd,
          int cin, int cout, int k, int fold, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Shape s;
  if (dtype == kFloat32) {
    if (!make_shape(s, n, h, wd, cin, cout, k, fold, K::kSource, 4))
      return (int)cudaErrorInvalidValue;
    return (int)dispatch<K, float>(x, wk, y, s, fold, st);
  }
  if (dtype == kBFloat16) {
    if (!make_shape(s, n, h, wd, cin, cout, k, fold, K::kSource, 8))
      return (int)cudaErrorInvalidValue;
    return (int)dispatch<K, __nv_bfloat16>(x, wk, y, s, fold, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace nhwc
}  // namespace vct
