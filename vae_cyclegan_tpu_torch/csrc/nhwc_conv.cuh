// The core of the three conv prototypes' kernels, K5 (conv_proto.cu), K6
// (lowcin_conv.cu) and K7 (lowcin_nhwc.cu): a reflect-padded SAME stride-1
// conv forward of NHWC x with a weight (k, k, cin, cout), f32 accumulation
// and one rounding to x's dtype. The kernels differ only in their loader
// (Source) and K6 in its output: K5 reads its wrapper's reflect-padded copy
// of x, each padded row one flat run, and K7 reads x itself and reflects
// each chunk's source position, both into NHWC y (n, h, w, cout); K6 reads a
// padded copy Wp >= w + 2p columns wide (zeros past w + 2p, one zero row
// below) as one flat run per image, a slab row continuing across the row end
// as the TPU kernel's flat lanes do, into channel-major y (n, cout, h * Wp):
// every one of the Wp columns, those past w wrapping into the next row.
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
//   (column tile, image, band of R rows) space; a ring of two slabs filled
//   by cp.async 16-byte copies in commit groups: the next tile's slab is in
//   flight while the tensor cores run on this one. Where cin is not a whole
//   number of chunks (the head's 3, the edges' 5) the ring holds raw rows
//   instead: each source row's span under the slab from its 16-byte boundary
//   (16-byte cp.async, the last one partial), and the slab is built from it
//   in shared memory (zeros past cin) before the tile's products.
// - A ragged tile (the last column tile of a row, or a band under the last
//   rows) copies only the slab rows and positions its stored outputs read,
//   and its warps run the K loop only on the A fragments that hold such
//   outputs (with_live) and stage only those. K6's rows of Wp = 264 (136 at
//   U3) would leave a tile of 8 columns beside each whole one, and even so
//   those cost half a whole tile each (their fixed phases and a K loop of
//   one fragment in two warps): K6 gives the lw = Wp % BM columns past the
//   whole tiles to strip tiles of lw columns x rs rows (rs * lw <= M), 64
//   rows of 8 at the head and U4, a whole tile's work each (plan). The
//   tiles are walked column tile outermost, the strips last, so that a
//   wave whose stride is a multiple of the tiles per row does not give some
//   blocks only one kind.
// - The epilogue: the tile goes to shared memory (in the slab slot it was
//   computed from, where it fits), then out as 16-byte stores. NHWC: per
//   position and chunk of channels where cout is a multiple of 8, else
//   packed, each tile row one run of positions x cout in aligned 16-byte
//   groups with scalar ends. Channel-major (K6): the tile is staged per
//   channel by stmatrix.trans (each stored row 8 positions of one channel),
//   and each (channel, tile row) is one run of positions, stored in 16-byte
//   chunks (the tiles' first columns, their widths and Wp are multiples of
//   16 bytes of elements). At Wp = 264 and 136 those runs do not start on
//   128 bytes, which makes K6's store phase slower than K5's (clock64 per
//   phase in an instrumented copy).
// - FOLD (k * cout <= kFoldCols: the tail, cout 3): the dx taps folded into
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
// in an instrumented copy) and CUDA-event times on the card: the K loop is
// bounded by ldmatrix traffic (192 bytes per mma at 64 x 32 warp tiles, 128
// at 64 x 64; Walk::next is branch-free: a branching one was slower), and
// the copies and stores of a tile run as phases of their own beside it;
// taller and wider tiles (R = 2, BM = 256 where it fits; R = 4 for the
// fold) spread those phases over more outputs. Spreading the next
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

// The loader: kPadded (K5) the padded copy, zeros past each padded row;
// kReflect (K7) x itself, each position reflected; kFlat (K6) the Wp-wide
// padded copy as one flat run per image, and with it the channel-major
// output of every Wp column.
enum class Source { kPadded, kReflect, kFlat };

// What a launch computes and how it is cut; filled on the host. Positions,
// chunks (16 bytes) and elements as named.
struct Shape {
  int n, h, wd, cin, cout, k, p;
  int ow;        // output columns per row: w, or Wp (kFlat)
  int G;         // chunks per input position: cin_s / V
  int ps;        // slab position stride in chunks (odd)
  int sp;        // slab positions per slab row of a whole tile (a strip
                 // tile's rows hold lw + k - 1)
  int src_w;     // positions per source row: w + 2p (padded), Wp (flat) or w
  int src_rows;  // source rows per image: h + 2p + 1 (padded, flat) or h
  int n_out, n_in;  // taps: outer x inner
  int dy_outer;  // K ordered (dy, dx, ci) (K5), else dx outermost (K6, K7)
  int nchunks;   // K chunks: taps x G
  int kc;        // nchunks rounded up to even (mma steps of two chunks)
  int wstride;   // weight row stride in chunks (odd, >= kc)
  int wrows;     // rows of the weight: cout, or cout * k (FOLD)
  int bmo;       // output columns per tile row
  int tiles_w, bands, tiles_n;  // column tiles of bmo (the last one ragged
                                // where FOLD), bands of R rows, N tiles
  int bands_all;     // n * bands
  int tiles_main;    // the tiles of R x bmo: tiles_w * n * bands
  int lw, rs;        // the strip (not FOLD): the lw < BM columns past the
                     // tiles_w whole tiles, in tiles of rs rows x lw
  int strip_bands;   // strip tiles per image
  int tiles;         // spatial tiles: tiles_main + n * strip_bands
  int stage_bytes;   // one slab: (R + k - 1) rows of sp positions
  int staging;       // byte offset of the staged tile, or -1: in the slab
                     // slot of the tile just computed
  int compact;       // byte offset of the tile's outputs, packed NHWC
  int raw, raw_row;  // byte offset of the raw rows (cin not a whole number
                     // of chunks), and each one's bytes
  int raw_row_s;     // a strip tile's raw row
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
// of tap (outer, inner), the inner taps `is` slab positions apart and the
// outer ones os (per tile: a strip tile's rows are narrower); offset() is
// its slab chunk offset from the row's position (chunk 0 past the last
// chunk, whose weights are zero). next() takes no branch, so the K loop
// stays one block of predicated code.
struct Walk {
  int j, g, in, toff, is, wrap;  // wrap: the step from the last inner tap
                                 // of one outer tap to the next's first
  __device__ __forceinline__ Walk(int j0, const Shape& s, int os, int is_)
      : j(0), g(0), in(0), toff(0), is(is_), wrap(os - (s.n_in - 1) * is_) {
    for (int i = 0; i < j0; ++i) next(s);
  }
  __device__ __forceinline__ int offset(const Shape& s) const {
    return j < s.nchunks ? toff * s.ps + g : 0;
  }
  __device__ __forceinline__ void next(const Shape& s) {
    ++j;
    const bool tap = ++g == s.G;  // on to the next tap
    g = tap ? 0 : g;
    in += tap;
    const bool outer = in == s.n_in;  // and the next outer tap
    in = outer ? 0 : in;
    toff += tap ? (outer ? wrap : is) : 0;
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

// f(integral_constant<int, live>) for live in 1 .. L, nothing for 0: the K
// loop instantiated for the number of A fragments a warp must compute, so a
// ragged tile's idle fragments cost no instruction and their accumulators
// stay in registers
template <int L, class F>
__device__ __forceinline__ void with_live(int live, F& f) {
  if constexpr (L > 0) {
    if (live == L)
      f(std::integral_constant<int, L>{});
    else
      with_live<L - 1>(live, f);
  }
}

// One block's work: tiles of R output rows x BM columns (M = R * BM), BN
// output channels (the N tile blockIdx.y), its tiles blockIdx.x + i *
// gridDim.x of the flat (column tile, image, band of R rows) space, then
// of the strip's tiles (image, band of rs rows). The column tile is
// outermost: a wave whose stride is a multiple of the tiles per row would
// otherwise give some blocks only one kind of tile.
template <typename T, int R, int BM, int BN, int WARPS_M, bool FOLD,
          Source SRC>
__device__ __forceinline__ void conv_body(const T* __restrict__ x,
                                          const T* __restrict__ wk,
                                          T* __restrict__ y, const Shape& s) {
  constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  constexpr bool CM = SRC == Source::kFlat;  // K6: channel-major y
  constexpr bool kStrips = CM && !FOLD;       // plan's strip tiles
  constexpr int V = 16 / sizeof(T);
  constexpr int M = R * BM;
  using Stage = std::conditional_t<FOLD, float, T>;
  // the staged tile, element (m, n): NHWC per position (stride SS), or
  // channel-major per channel (stride SM); either pad keeps the fragment
  // writes and the 16-byte reads apart in the banks
  constexpr int SS = BN + 16 / (int)sizeof(Stage);
  constexpr int SM = M + 16 / (int)sizeof(Stage);
  auto st = [](int m, int n) { return CM ? n * SM + m : m * SS + n; };
  const int tid = threadIdx.x;
  const int n0 = blockIdx.y * BN;
  const int nreal = min(BN, s.cout - n0);

  // shared memory: weights [BN][wstride chunks] | kStages slabs
  // [rows][sp][ps chunks] | staging (unless in the slab slot) | compact
  // outputs | raw rows
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

  // tile t: its image, first output row and column, its rows (R, or a strip
  // tile's rs; `rows` of them in the image) and A rows per tile row (BM, or
  // lw), its slab rows' positions sp; slab position q of its slab row rr is
  // padded column c0 + q of padded row r0 + rr; the first rows + k - 1 slab
  // rows and `need` positions of each feed its stored outputs (a ragged
  // last column tile needs fewer than sp)
  struct Where {
    int img, r0, c0, rt, rows, bm, sp, need;
  };
  auto where = [&](int t) {
    Where w;
    if (!kStrips || t < s.tiles_main) {
      const int ct = t / s.bands_all;       // the column tile, outermost
      const int ib = t - ct * s.bands_all;  // image * bands + band
      w.c0 = ct * s.bmo;
      w.img = ib / s.bands;
      w.r0 = (ib - w.img * s.bands) * R;
      w.rt = R, w.bm = BM, w.sp = s.sp;
      w.need = min(s.bmo, s.ow - w.c0) + s.k - 1;
    } else {
      const int u = t - s.tiles_main;
      w.img = u / s.strip_bands;
      w.r0 = (u - w.img * s.strip_bands) * s.rs;
      w.c0 = s.tiles_w * s.bmo;
      w.rt = s.rs, w.bm = s.lw, w.sp = s.lw + s.k - 1;
      w.need = w.sp;
    }
    w.rows = min(w.rt, s.h - w.r0);
    return w;
  };
  // the source row of slab row rr (rows past the image, under a last band
  // that the tile's rows do not fill, feed unstored outputs: clamped;
  // kFlat: the flat run from the row's start, checked per position)
  auto row_of = [&](const Where& w, int rr) -> const T* {
    if constexpr (SRC == Source::kPadded)
      return x + ((long long)w.img * s.src_rows + min(w.r0 + rr, s.src_rows - 1)) *
                     s.src_w * s.cin;
    else if constexpr (SRC == Source::kFlat)
      return x + ((long long)w.img * s.src_rows + w.r0 + rr) * s.src_w * s.cin;
    else
      return x + ((long long)w.img * s.h + reflect_index(w.r0 + rr - s.p, s.h)) *
                     s.wd * s.cin;
  };
  // the source position of slab position q of slab row rr, from the row's
  // start, and whether it holds data
  auto col_of = [&](const Where& w, int rr, int q, bool& ok) -> int {
    if constexpr (SRC == Source::kPadded) {
      const int col = w.c0 + q;
      ok = col < s.src_w;  // past the padded row: zeros
      return ok ? col : 0;
    } else if constexpr (SRC == Source::kFlat) {
      // on across the row's end; past the image's last (zero) row: zeros
      // (an image's positions fit an int: make_shape)
      const int col = w.c0 + q;
      ok = col < (s.src_rows - w.r0 - rr) * s.src_w;
      return ok ? col : 0;
    } else {
      ok = true;  // past the reflected row (unstored outputs): clamped
      return reflect_index(w.c0 + q - s.p, s.wd);
    }
  };
  auto slot_at = [&](int slot) { return slab + (size_t)slot * s.stage_bytes; };
  // whole chunks of channels (cin a multiple of V): cp.async copies
  const bool async = s.cin % V == 0;
  auto load = [&](int t, int slot) {
    const Where w = where(t);
    for (int rr = 0; rr < w.rows + s.k - 1; ++rr) {
      const T* src = row_of(w, rr);
      unsigned char* d = slot_at(slot) + (size_t)rr * w.sp * s.ps * 16;
      grid2(w.need, s.G, [&](int q, int g) {
        bool ok;
        const int col = col_of(w, rr, q, ok);
        ptx::cp_async16_or_zero(d + (q * s.ps + g) * 16,
                                ok ? src + col * s.cin + g * V : x, ok);
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
      c_lo = w.c0, c_hi = min(w.c0 + w.need, s.src_w);
    } else if constexpr (SRC == Source::kFlat) {
      // the raw run whole, across row ends, up to the image's end
      c_lo = w.c0;
      c_hi = min(w.c0 + w.need, (s.src_rows - w.r0 - rr) * s.src_w);
    } else {
      c_lo = max(w.c0 - s.p, 0), c_hi = min(w.c0 - s.p + w.need, s.wd);
    }
    if (c_hi <= c_lo) {
      lo = reinterpret_cast<const unsigned char*>(x);
      return 0;
    }
    const uintptr_t a = reinterpret_cast<uintptr_t>(row + c_lo * s.cin);
    lo = reinterpret_cast<const unsigned char*>(a & ~(uintptr_t)15);
    return (int)(reinterpret_cast<uintptr_t>(row + c_hi * s.cin) -
                 reinterpret_cast<uintptr_t>(lo));
  };
  // raw row rr of a slot: a strip tile's rows are more and shorter
  auto raw_at = [&](const Where& w, int slot, int rr) {
    return raw + (size_t)slot * (R + s.k - 1) * s.raw_row +
           (size_t)rr * (!kStrips || w.bm == BM ? s.raw_row : s.raw_row_s);
  };
  auto load_raw = [&](int t, int slot) {
    const Where w = where(t);
    Cursor cu;
    for (cu.start(w.rows + s.k - 1, (!kStrips || w.bm == BM ? s.raw_row : s.raw_row_s) / 16, 1);
         cu.more(); cu.next()) {
      const unsigned char* lo;
      const int left = span_of(w, cu.a, lo) - 16 * cu.b;
      if (left > 0)
        ptx::cp_async16_part(raw_at(w, slot, cu.a) + 16 * cu.b, lo + 16 * cu.b,
                             min(left, 16));
    }
  };
  auto expand = [&](const Where& w, int slot) {
    uint4* dst = reinterpret_cast<uint4*>(slot_at(slot));
    Cursor cu;
    for (cu.start(w.rows + s.k - 1, w.need, s.G); cu.more(); cu.next()) {
      bool ok;
      const int col = col_of(w, cu.a, cu.b, ok);
      const unsigned char* lo;
      const int len = span_of(w, cu.a, lo);
      // positions past the span (far past a reflected edge) feed only
      // unstored outputs: zeros
      const long long off =
          reinterpret_cast<const unsigned char*>(row_of(w, cu.a) + col * s.cin) - lo;
      ok = ok && off >= 0 && off + (long long)s.cin * (long long)sizeof(T) <= len;
      const T* src =
          reinterpret_cast<const T*>(raw_at(w, slot, cu.a) + (ok ? off : 0));
      T e[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int ci = cu.c * V + j;
        e[j] = ok && ci < s.cin ? src[ci] : igemm::from_f<T>(0.f);
      }
      dst[(cu.a * w.sp + cu.b) * s.ps + cu.c] = pack<T>(e);
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
    const Where w = where(first + i * step);
    const int mreal = w.need - s.k + 1;  // stored columns of each tile row
    const int rows = w.rows;
    ptx::cp_async_wait<kStages - 2>();
    __syncthreads();  // tile i's slab is in; every warp is done with i - 1
    if (!async) expand(w, i % kStages);
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
    // (a strip tile's rows past its last, in its last fragment, read its
    // last)
    auto pos = [&](int m) {
      if (!kStrips || w.bm == BM) return (m / BM) * w.sp + m % BM;
      m = min(m, w.rt * w.bm - 1);
      return (m / w.bm) * w.sp + m % w.bm;
    };
    // the taps' strides: dy one slab row, dx one position
    const int os = FOLD || s.dy_outer ? w.sp : 1;
    const int is = FOLD ? 0 : s.dy_outer ? 1 : w.sp;

    if constexpr (kMma) {
      constexpr int WARPS_N = 8 / WARPS_M;
      constexpr int WM = M / WARPS_M, WN = BN / WARPS_N;
      constexpr int MI = WM / 16, NI = WN / 8;
      static_assert(WARPS_M * WARPS_N == 8 && WM % 16 == 0 && WN % 16 == 0 &&
                        BM % 16 == 0 && BM % WM == 0, "tile");
      const int warp = tid >> 5, lane = tid & 31;
      const int wm = warp / WARPS_N, wn = warp % WARPS_N;
      // the warp's first `live` fragments hold the A rows whose products are
      // stored (FOLD: the slab positions of the stored outputs and the k - 1
      // after them): in a whole tile's row, its columns; in a strip tile,
      // the rows of the tile's first `rows` rows
      const int m0 = wm * WM;
      const int live =
          !kStrips || w.bm == BM
              ? (m0 / BM < rows
                     ? max(0, min(MI, ((FOLD ? w.need : mreal) - m0 % BM + 15) / 16))
                     : 0)
              : max(0, min(MI, (rows * w.bm - m0 + 15) / 16));
      // A: the lane's row of each 16-row fragment and its chunk (of two);
      // B: its row of a 16-row pair of n8 fragments and its chunk
      unsigned abase[MI];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
        abase[mi] = ptx::smem_addr(cur) +
                    (unsigned)(pos(m0 + mi * 16 + (lane & 15)) * s.ps) * 16;
      const unsigned bbase =
          ptx::smem_addr(wsm) +
          (unsigned)((wn * WN + (lane & 7) + ((lane >> 4) << 3)) * s.wstride +
                     ((lane >> 3) & 1)) * 16;
      float acc[MI][NI][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
      auto kloop = [&](auto n_live) {
        constexpr int L = decltype(n_live)::value;
        Walk walk(lane >> 4, s, os, is);
        const int steps = s.kc / 2;
#pragma unroll 4
        for (int ks = 0; ks < steps; ++ks) {
          const unsigned ao = (unsigned)walk.offset(s) * 16;
          uint32_t af[L][4], bf[NI][2];
#pragma unroll
          for (int mi = 0; mi < L; ++mi) ptx::ldmatrix_x4(af[mi], abase[mi] + ao);
#pragma unroll
          for (int nj = 0; nj < NI / 2; ++nj) {
            uint32_t r[4];
            ptx::ldmatrix_x4(
                r, bbase + (unsigned)(nj * 16 * s.wstride + 2 * ks) * 16);
            bf[2 * nj][0] = r[0], bf[2 * nj][1] = r[1];
            bf[2 * nj + 1][0] = r[2], bf[2 * nj + 1][1] = r[3];
          }
#pragma unroll
          for (int mi = 0; mi < L; ++mi)
#pragma unroll
            for (int ni = 0; ni < NI; ++ni)
              igemm::mma_bf16(acc[mi][ni], af[mi], bf[ni]);
          walk.next(s);
          walk.next(s);
        }
      };
      with_live<MI>(live, kloop);
      __syncthreads();  // every warp is done with the slab (the staging may be in it)
      // the live fragments staged. C fragment: c0, c1 at row gid, columns
      // 2 tig (+1); c2, c3 row gid + 8
      const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        if (mi >= live) continue;
        if constexpr (CM && !FOLD) {
          // per channel: stmatrix.trans of two n8 fragments (four 8 x 8
          // matrices: rows m..m+7 and m+8..m+15 of each), each stored row
          // 8 positions of one channel
#pragma unroll
          for (int nj = 0; nj < NI / 2; ++nj) {
            uint32_t r[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float* a = acc[mi][2 * nj + q / 2] + 2 * (q % 2);
              const __nv_bfloat162 v = __floats2bfloat162_rn(a[0], a[1]);
              memcpy(&r[q], &v, 4);
            }
            const int mat = lane >> 3;
            const int n = wn * WN + (2 * nj + mat / 2) * 8 + (lane & 7);
            const int m = m0 + mi * 16 + 8 * (mat % 2);
            ptx::stmatrix_x4_trans(ptx::smem_addr(out + st(m, n)), r);
          }
        } else {
#pragma unroll
          for (int ni = 0; ni < NI; ++ni)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int m = m0 + mi * 16 + gid + 8 * hf;
              const int n = wn * WN + ni * 8 + 2 * tig;
              const float v0 = acc[mi][ni][2 * hf], v1 = acc[mi][ni][2 * hf + 1];
              if constexpr (CM) {  // FOLD: f32, per channel
                out[st(m, n)] = v0;
                out[st(m, n + 1)] = v1;
              } else if constexpr (FOLD) {
                *reinterpret_cast<float2*>(out + st(m, n)) = make_float2(v0, v1);
              } else {
                *reinterpret_cast<__nv_bfloat162*>(out + st(m, n)) =
                    __floats2bfloat162_rn(v0, v1);
              }
            }
        }
      }
    } else {
      constexpr int PER = M * BN / kThreads;
      const T* S = reinterpret_cast<const T*>(cur);
      const T* W = reinterpret_cast<const T*>(wsm);
      float acc[PER];
      int ap[PER];  // slab chunk offset of each output's A row
#pragma unroll
      for (int o = 0; o < PER; ++o) {
        acc[o] = 0.f;
        ap[o] = pos((tid + o * kThreads) / BN) * s.ps;
      }
      Walk walk(0, s, os, is);
      for (int j = 0; j < s.nchunks; ++j) {
        const int off = walk.offset(s);
#pragma unroll
        for (int e = 0; e < V; ++e)
#pragma unroll
          for (int o = 0; o < PER; ++o) {
            const int n = (tid + o * kThreads) % BN;
            acc[o] = fmaf(igemm::to_f(S[(off + ap[o]) * V + e]),
                          igemm::to_f(W[((size_t)n * s.wstride + j) * V + e]),
                          acc[o]);
          }
        walk.next(s);
      }
      __syncthreads();  // every thread is done with the slab
#pragma unroll
      for (int o = 0; o < PER; ++o) {
        const int idx = tid + o * kThreads;
        out[st(idx / BN, idx % BN)] = acc[o];
      }
    }
    __syncthreads();  // the tile is staged

    if constexpr (CM) {
      // channel-major y (n, cout, h * ow): each (channel, tile row) one run
      // of mreal positions from column c0, in 16-byte chunks (c0, mreal and
      // ow are multiples of V); 32-bit offsets from the tile's first (an
      // image's outputs fit an int: make_shape)
      T* const ytile =
          y + (((long long)w.img * s.cout + n0) * s.h + w.r0) * s.ow + w.c0;
      const int plane = s.h * s.ow;
      auto at = [&](int n, int rr) { return ytile + n * plane + rr * s.ow; };
      Cursor cu;
      if constexpr (FOLD) {
        // each co summed over its k dx-shifted slab positions, dx ascending,
        // in f32, rounded once, into compact [co][R][bmo]
        for (cu.start(nreal, rows, mreal); cu.more(); cu.next()) {
          const int m = cu.b * BM + cu.c;
          float v = 0.f;
          for (int dx = 0; dx < s.k; ++dx) v += out[st(m + dx, cu.a * s.k + dx)];
          compact[(cu.a * R + cu.b) * s.bmo + cu.c] = igemm::from_f<T>(v);
        }
        __syncthreads();
        for (cu.start(nreal, rows, mreal / V); cu.more(); cu.next())
          *reinterpret_cast<uint4*>(at(cu.a, cu.b) + cu.c * V) =
              *reinterpret_cast<const uint4*>(compact + (cu.a * R + cu.b) * s.bmo +
                                              cu.c * V);
      } else {
        // a tile row at a time: each channel's run, V positions a lane
        for (int rr = 0; rr < rows; ++rr) {
          T* const dst = at(0, rr);
          const Stage* src = out + st(rr * w.bm, 0);
          grid2(nreal, mreal / V, [&](int n, int c) {
            *reinterpret_cast<uint4*>(dst + n * plane + c * V) =
                *reinterpret_cast<const uint4*>(src + n * SM + c * V);
          });
        }
      }
    } else {
      // y offset of output column c0 + m of tile row rr, channel n0
      auto at = [&](int rr, int m) {
        return (((long long)w.img * s.h + w.r0 + rr) * s.ow + w.c0 + m) * s.cout + n0;
      };
      if (!FOLD && s.cout % V == 0) {
        // per output position, 16-byte chunks of the tile's channels: one
        // tile row at a time, 32-bit offsets from the row's start
        for (int rr = 0; rr < rows; ++rr) {
          T* dst = y + at(rr, 0);
          const Stage* src = out + st(rr * w.bm, 0);
          grid2(mreal, nreal / V, [&](int m, int g) {
            *reinterpret_cast<uint4*>(dst + m * s.cout + g * V) =
                *reinterpret_cast<const uint4*>(src + m * SS + g * V);
          });
        }
      } else {
        // the outputs, rounded, packed as NHWC runs (FOLD: each co summed
        // over its k dx-shifted slab positions, dx ascending)
        Cursor cu;
        for (cu.start(rows, mreal, nreal); cu.more(); cu.next()) {
          const int m = cu.a * w.bm + cu.b, n = cu.c;
          float v;
          if constexpr (FOLD) {
            v = 0.f;
            for (int dx = 0; dx < s.k; ++dx) v += out[st(m + dx, n * s.k + dx)];
          } else {
            v = igemm::to_f(out[st(m, n)]);
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

// The shape of a launch before its tiles are cut: V elements per chunk; wp
// the flat source's row width (kFlat: Wp >= w + 2p, a multiple of V).
inline bool make_shape(Shape& s, int n, int h, int wd, int cin, int cout,
                       int k, bool fold, Source src, int V, int wp) {
  const bool flat = src == Source::kFlat;
  if (n <= 0 || h <= 0 || wd <= 0 || cin <= 0 || cout <= 0 || k <= 0 ||
      k % 2 == 0 || k / 2 >= h || k / 2 >= wd || (fold && k * cout > kFoldCols) ||
      (flat && (wp < wd + k - 1 || wp % V != 0 ||
                (long long)(h + k) * wp * (cout > k ? cout : k) > INT_MAX)) ||
      (long long)k * k * cin > INT_MAX / 64 ||
      (long long)((flat ? wp : wd) + k) * (cin > cout ? cin : cout) > INT_MAX / 16)
    return false;
  s = Shape{};
  s.n = n, s.h = h, s.wd = wd, s.cin = cin, s.cout = cout, s.k = k;
  s.p = k / 2;
  s.ow = flat ? wp : wd;
  s.G = (int)cdiv(cin, V);
  s.ps = s.G | 1;
  const bool padded = src == Source::kPadded;
  s.src_w = flat ? wp : padded ? wd + 2 * s.p : wd;
  s.src_rows = flat || padded ? h + 2 * s.p + 1 : h;
  s.wrows = fold ? cout * k : cout;
  return true;
}

// Cut `s` for R x BM by BN tiles and the tap order K::kDxOuter names (K6,
// K7: dx outermost); the shared memory a block then takes. Where K6's row
// (not FOLD) leaves lw < BM columns past its whole tiles, they go in strip
// tiles of rs rows x lw, as many rows as the tile's M and the slab and raw
// rows of a whole tile hold: one strip tile in place of M / lw ragged ones.
// K5 and K7 keep a ragged last column tile: their main shapes' rows are
// whole tiles, and the strips' per-tile branches cost them ~4% there.
template <class K, typename T, int R, int BM, int BN, bool FOLD>
size_t plan(Shape& s) {
  using Stage = std::conditional_t<FOLD, float, T>;
  constexpr bool CM = K::kSource == Source::kFlat;
  constexpr int V = 16 / sizeof(T);
  const int k = s.k;
  s.sp = FOLD ? BM : BM + k - 1;
  s.bmo = FOLD ? BM - k + 1 : BM;
  if (CM) s.bmo -= s.bmo % V;  // each tile's runs start on 16 bytes
  s.n_out = k, s.n_in = FOLD ? 1 : k;  // FOLD: K = (dy, ci), the dx taps in N
  s.dy_outer = !K::kDxOuter;
  s.nchunks = s.n_out * s.n_in * s.G;
  s.kc = (s.nchunks + 1) / 2 * 2;
  s.wstride = s.kc | 1;
  const bool strips = CM && !FOLD;
  s.lw = strips ? s.ow % BM : 0;
  s.tiles_w = strips ? s.ow / BM : (int)cdiv(s.ow, s.bmo);
  s.bands = (int)cdiv(s.h, R);
  s.tiles_n = FOLD ? 1 : (int)cdiv(s.wrows, BN);
  const size_t weights = (size_t)BN * s.wstride * 16;
  const size_t stage = (size_t)(R + k - 1) * s.sp * s.ps * 16;
  const size_t staging =
      (CM ? (size_t)BN * (R * BM + 16 / sizeof(Stage))
          : (size_t)R * BM * (BN + 16 / sizeof(Stage))) * sizeof(Stage);
  // a raw row: the span of sp positions from its 16-byte boundary
  s.raw_row = (int)align16((size_t)s.sp * s.cin * sizeof(T) + 15);
  s.raw_row_s = (int)align16((size_t)(s.lw + k - 1) * s.cin * sizeof(T) + 15);
  s.rs = s.lw > 0 ? R * BM / s.lw : 0;
  while (s.rs > R && ((size_t)(s.rs + k - 1) * (s.lw + k - 1) * s.ps * 16 > stage ||
                      (s.rs + k - 1) * s.raw_row_s > (R + k - 1) * s.raw_row))
    --s.rs;
  s.strip_bands = s.lw > 0 ? (int)cdiv(s.h, s.rs) : 0;
  const long long tiles_main = (long long)s.tiles_w * s.n * s.bands;
  const long long tiles = tiles_main + (long long)s.n * s.strip_bands;
  if (s.bmo < 1 || tiles > INT_MAX || stage > INT_MAX || s.tiles_n > 65535)
    return SIZE_MAX;
  s.tiles_main = (int)tiles_main;
  s.tiles = (int)tiles;
  s.bands_all = s.n * s.bands;  // at most tiles
  s.stage_bytes = (int)stage;
  size_t smem = weights + kStages * stage;
  s.staging = -1;  // in the slab slot of the tile just computed, if it fits
  if (staging > stage) {
    s.staging = (int)smem;
    smem += align16(staging);
  }
  s.compact = (int)smem;
  if (FOLD || (!CM && s.cout % V != 0))
    smem += align16((size_t)R * BM * BN * sizeof(T));
  s.raw = (int)smem;
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

// The C entry points' body: x (K5, K6: the padded copy), the weight wk
// (wrows, nchunks * V) and y; dtype vct::kFloat32 or vct::kBFloat16; wp the
// padded copy's row width (K6; unread by the others).
template <class K>
int entry(const void* x, const void* wk, void* y, int n, int h, int wd,
          int cin, int cout, int k, int fold, int dtype, void* stream,
          int wp = 0) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Shape s;
  if (dtype == kFloat32) {
    if (!make_shape(s, n, h, wd, cin, cout, k, fold, K::kSource, 4, wp))
      return (int)cudaErrorInvalidValue;
    return (int)dispatch<K, float>(x, wk, y, s, fold, st);
  }
  if (dtype == kBFloat16) {
    if (!make_shape(s, n, h, wd, cin, cout, k, fold, K::kSource, 8, wp))
      return (int)cudaErrorInvalidValue;
    return (int)dispatch<K, __nv_bfloat16>(x, wk, y, s, fold, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace nhwc
}  // namespace vct
