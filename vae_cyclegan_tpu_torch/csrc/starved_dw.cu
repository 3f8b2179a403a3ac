// Weight gradient of the reflect-padded SAME convolution (stride 1, odd k):
//
//   dw[co, ci, dy, dx] = sum over (n, oh, ow) of
//       g[n, co, oh, ow] * x[n, ci, refl(oh + dy - k/2), refl(ow + dx - k/2)]
//
// NCHW x (n, cin, h, w) and g (n, cout, h, w) of one type (f32 or bf16), f32
// accumulation, f32 OIHW output (cout, cin, k, k).
//
// Replaces vae_cyclegan_tpu/ops/starved_conv.py::_dw_call (kernel body
// _dw_kernel): the weight gradients of the encoder head (k7, 3->64), the
// decoder's U4 (k3, 32->64) and tail (k7, 64->3), all at 256x256. Like the
// TPU kernel it reads x with the reflect halo resolved in the loader, so no
// padded copy of x is written to device memory.
//
// What bounds it: the reduction runs over n*h*w positions (262,144 per weight
// at batch 4): 2.5 G multiply-adds for the head and the tail, 4.8 G for U4,
// over 35-50 MB of bf16 input, ~100-190 flop/byte, below the bf16
// tensor-core ridge (~295): its bound is bytes, 0.0105-0.015 ms per site at
// 3.35 TB/s. So the products run on the tensor cores, and each input comes
// from device memory about once, its loads overlapping the products.
//
// Design: a split-K GEMM on the tensor cores (mma.sync m16n8k16, bf16 in,
// f32 accumulate), K = the positions, walked along W one output row (a
// chunk of up to 256 of its columns) at a time. A contraction pair (ow,
// ow + 1) is then two neighbours of one NCHW row, in g and in every x patch
// column, so both operands are staged as they lie, rows along W, with no
// transpose.
// - Orientation, chosen on the host from (cin, cout, k):
//   * M = cout (tiles of 64), N = (ci, dy, dx) in OIHW order (tiles of at
//     most 160 columns: a channel range, all taps; the head's 147 in one
//     tile, U4's 288 in two of 144); A = g rows, B = x rows shifted by dx.
//     The head and U4.
//   * where k * cout <= 24 (the tail, cout 3), the taps are folded as the
//     TPU kernel packs them: M = (dy, ci), the channel fastest (tiles of at
//     most 128 rows: a channel range, all dy), N = (co, dx) <= 24; A = x
//     rows, B = g rows shifted by dx, zero out of range; K = the input
//     columns of the row chunk from 8 before it (its w + k - 1 and the
//     rest of that group of 8, rounded up to 16), so that every A row
//     starts 16-byte aligned. Unfolded, the tail would fill 3 of every 16
//     rows of each mma.
// - A fragments (g rows, or folded x rows: 16-byte aligned) are read with
//   ldmatrix.x4, one instruction per 16 x 16 fragment.
// - The dx shift moves a pair's start by one element for odd offsets, where
//   it is not one aligned 4-byte word. Such a B pair is built from the two
//   aligned words around it with __byte_perm, inside the K loop: B is the
//   smaller operand per mma (8 rows against A's 16), and the fix needs no
//   shifted copy of a row in shared memory. (A shifted copy, made shared to
//   shared once per row, halved B's loads, but its pass between two
//   barriers cost more than it saved.)
// - Split K: each block owns a band of output rows of one image and one
//   column chunk (a "slice") and one M x N tile, accumulates in registers
//   over its rows in ascending order, and writes its f32 partial to its
//   slice of a scratch, partial[slice][co][ci][dy][dx]. A second kernel sums
//   the slices in a fixed order (eight runs of consecutive slices, each in
//   order, then the eight in order). No atomics: a launch repeats bit for
//   bit. The bands are sized for about two blocks per SM over the card.
// - Staging, a two-stage pipeline with one barrier per row: a ring of k + 1
//   x rows (every channel of the tile) and two g rows in shared memory. Per
//   output row the block issues cp.async (16 bytes) for the next row's g
//   and its one new x row, and loads that row's reflect halo columns (the
//   element-wise part) into registers; runs the mma on this row; stores the
//   halo; then waits for the copies and meets at the barrier. Columns past
//   the halo hold zeros (g) or finite values (x, multiplied by zero g).
//   Shapes whose rows are not 16-byte aligned (w % 8 != 0) stage element by
//   element after the wait, behind a second barrier.
// - Shared-memory strides: the 8 rows of one fragment load fall in distinct
//   banks: channel stride 4 mod 8 words, g row stride 12 mod 32 words, ring
//   slot stride 8 mod 32 words.
// - f32 (the checks and the f32 steps, never a timed path) runs the same
//   kernel with f32 FMAs on the CUDA cores (TF32 would not keep f32's
//   precision): each thread owns BM * BN / 128 elements of the tile and
//   sums its products in the same K order.
// Not built yet: wgmma, TMA row loads and warp specialisation.

#include <algorithm>
#include <climits>
#include <type_traits>

#include "igemm.cuh"
#include "ptx.cuh"

namespace {

using vct::igemm::kThreads;

// M x N tiles of the two orientations: g rows x (ci, dy, dx), and the
// folded (dy, ci) x (co, dx)
constexpr int kBM = 64, kBN = 160;
constexpr int kFM = 128, kFN = 24;
constexpr int kMaxCols = 256;  // output columns per K step
constexpr size_t kMaxSmem = vct::igemm::kMaxSmem;
// shared memory per block for two blocks per SM (bf16)
constexpr size_t kTwoPerSm = 113 * 1024;
constexpr int kGroups = 8;  // runs of slices in the second kernel
// reflect halo cells per thread and row, at most: a tile's ci_tile * (k - 1)
// halo cells are fewer than 2 * 128 in both orientations
constexpr int kHalo = 2;

__device__ __forceinline__ int reflect_index(int i, int n) {
  i = i < 0 ? -i : i;
  i = i >= n ? 2 * n - 2 - i : i;
  return min(max(i, 0), n - 1);
}

using vct::ptx::cp_async16;
using vct::ptx::cp_async_commit;
using vct::ptx::cp_async_wait_all;
using vct::ptx::ldmatrix_x4;

// f(r, q) for every cell of a rows x cols grid, the block's threads taking
// the cells in turn, q fastest (no division per cell)
template <class F>
__device__ __forceinline__ void grid2(int rows, int cols, F&& f) {
  if (cols <= 0) return;
  const int dr = kThreads / cols, dq = kThreads - dr * cols;
  int r = threadIdx.x / cols, q = threadIdx.x - r * cols;
  while (r < rows) {
    f(r, q);
    r += dr, q += dq;
    if (q >= cols) q -= cols, ++r;
  }
}

inline int rup(int v, int m) { return (v + m - 1) / m * m; }
inline int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }
// the least stride >= cols that is `rem` mod `mod` elements
inline int stride_for(int cols, int rem, int mod) {
  return cols + ((rem - cols) % mod + mod) % mod;
}

int sm_count() {
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

// How the work is cut; computed on the host for both kernels and for the
// scratch the wrapper allocates. Offsets and strides count elements.
struct Plan {
  int n, cin, cout, h, wd, k, p;
  int fold;
  int vec;            // rows 16-byte aligned: cp.async staging
  int kc, chunks;     // output columns per K step, chunks per row
  int kpad;           // K per step (a multiple of 16)
  int rows, bands;    // output rows per band, bands per image
  int tiles, ct_n;    // tiles per slice; channel tiles
  int ci_tile;        // channels per tile, at most
  int xs, ss, xoff;   // x ring: channel stride, slot stride, column of c0
  int ring;           // x ring elements; the two g buffers follow
  int gs, grows, goff;  // g buffers: row stride, rows, column of c0
  long long slices, wcount;
  size_t smem;
};

Plan make_plan(int n, int cin, int cout, int h, int wd, int k, size_t elem) {
  Plan P{};
  P.n = n, P.cin = cin, P.cout = cout, P.h = h, P.wd = wd, P.k = k;
  P.p = k / 2;
  P.fold = k * cout <= kFN;
  P.wcount = (long long)cout * cin * k * k;
  int mtiles = 1, ci_max;
  if (P.fold) {
    ci_max = kFM / k;
    P.grows = cout;
  } else {
    mtiles = cdiv(cout, kBM);
    ci_max = kBN / (k * k);
    P.grows = std::min(cout, kBM);
  }
  P.ct_n = cdiv(cin, ci_max);
  P.ci_tile = cdiv(cin, P.ct_n);
  P.tiles = mtiles * P.ct_n;
  P.xoff = rup(P.p, 8);
  P.goff = P.fold ? rup(k + P.xoff - P.p, 8) : 0;
  const size_t budget = elem == 2 ? kTwoPerSm : kMaxSmem;
  P.kc = std::min(rup(wd, 16), kMaxCols);
  for (;;) {
    // the columns each row's reads reach (a pair built from two words
    // reads one word past it)
    int xcols, gcols;
    if (P.fold) {
      P.kpad = rup(P.kc + P.p + P.xoff, 16);
      xcols = P.kpad;
      gcols = P.goff + P.kpad + 2;
    } else {
      P.kpad = P.kc;
      xcols = P.xoff + P.p + P.kpad + 2;
      gcols = P.kpad;
    }
    P.xs = stride_for(rup(xcols, 8), 8, 16);
    P.ss = stride_for(P.ci_tile * P.xs, 16, 64);
    P.gs = stride_for(rup(gcols, 8), 24, 64);
    P.ring = (k + 1) * P.ss;
    P.smem = elem * ((size_t)P.ring + 2 * (size_t)P.grows * P.gs);
    if (P.smem <= budget || P.kc <= 16) break;
    P.kc = rup(P.kc / 2, 16);
  }
  P.chunks = cdiv(wd, P.kc);
  // about two blocks per SM, then as few slices as that allows: every slice
  // writes a whole partial
  const long long per_band = (long long)n * P.chunks * P.tiles;
  const long long target = 2LL * sm_count();
  P.bands = (int)std::min<long long>(
      h, std::max<long long>(1, (target + per_band - 1) / per_band));
  P.rows = cdiv(h, P.bands);
  P.bands = cdiv(h, P.rows);
  P.slices = (long long)n * P.bands * P.chunks;
  return P;
}

bool fits(const Plan& P) {
  return P.smem <= kMaxSmem && P.slices * P.tiles <= INT_MAX &&
         P.slices * P.wcount <= (1LL << 40);
}

template <typename T, bool FOLD>
__global__ void __launch_bounds__(kThreads)
    dw_gemm_kernel(const T* __restrict__ x, const T* __restrict__ g,
                   float* __restrict__ partial, const Plan P) {
  constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  constexpr int BM = FOLD ? kFM : kBM, BN = FOLD ? kFN : kBN;
  constexpr int WARPS_M = FOLD ? 4 : 1, WARPS_N = 4 / WARPS_M;
  constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  constexpr int MI = WM / 16, NI = WN / 8;
  constexpr int ACC = kMma ? MI * NI * 4 : BM * BN / kThreads;
  constexpr int G = 16 / sizeof(T);  // elements per 16-byte load
  static_assert(WM % 16 == 0 && WN % 8 == 0 && BM * BN % kThreads == 0, "tile");

  // shared memory: x ring [slot][channel][xs], then g buffers [buf][row][gs]
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  T* ring = sm;
  T* gbuf = sm + P.ring;
  const int gbuf_elems = P.grows * P.gs;

  const int tid = threadIdx.x;
  const int k = P.k, p = P.p, ring_slots = k + 1;
  const int tile = (int)(blockIdx.x % P.tiles);
  const long long slice = blockIdx.x / P.tiles;
  const int mt = tile / P.ct_n, ct = tile % P.ct_n;
  const int chunk = (int)(slice % P.chunks);
  const long long rest = slice / P.chunks;
  const int band = (int)(rest % P.bands);
  const int img = (int)(rest / P.bands);
  const int r0 = band * P.rows, r1 = min(P.h, r0 + P.rows);
  const int c0 = chunk * P.kc, len = min(P.kc, P.wd - c0);

  // the tile: its channels and output channels, and its last real row and
  // column (tile local)
  const int ci_lo = ct * P.ci_tile, ci_t = min(P.ci_tile, P.cin - ci_lo);
  const int co0 = FOLD ? 0 : mt * BM;
  const int m_last = FOLD ? k * ci_t - 1 : min(BM, P.cout - co0) - 1;
  const int n_last = FOLD ? P.cout * k - 1 : ci_t * k * k - 1;
  const int grows = FOLD ? P.cout : m_last + 1;
  const long long plane = (long long)P.h * P.wd;
  const T* xn = x + ((long long)img * P.cin + ci_lo) * plane;
  const T* gn = g + ((long long)img * P.cout + co0) * plane;
  const T zero = vct::igemm::from_f<T>(0.f);

  // x row lr (logical: reflected here) of the tile's channels into a ring
  // slot, column v of the slot holding x col c0 + v - xoff. issue_x: the
  // 16-byte groups inside the image (groups q_lo .. q_hi - 1 of each row),
  // asynchronously. The reflect halo columns (col in [-p, 0) or [w, w + p))
  // go through registers: this thread's cells (at most kHalo per row), their
  // slot-relative destination and source offsets, are the same for every
  // row. stage_x: the whole row element by element (rows not 16-byte
  // aligned).
  const int q_lo = max(0, (P.xoff - c0 + G - 1) / G);
  const int q_hi = min(P.xs / G, (P.wd - c0 + P.xoff) / G);
  auto issue_x = [&](int lr, int slot) {
    const T* src = xn + (long long)reflect_index(lr, P.h) * P.wd;
    T* dst = ring + slot * P.ss;
    grid2(ci_t, q_hi - q_lo, [&](int c, int q) {
      q += q_lo;
      cp_async16(dst + c * P.xs + q * G,
                 src + c * plane + c0 + q * G - P.xoff);
    });
  };
  int hdst[kHalo];
  long long hsrc[kHalo];
#pragma unroll
  for (int j = 0; j < kHalo; ++j) {
    const int i = tid + j * kThreads;
    hdst[j] = -1;
    hsrc[j] = 0;
    if (P.vec && i < ci_t * 2 * p) {
      const int c = i / (2 * p), d = i - c * 2 * p;
      const int col = d < p ? -1 - d : P.wd + d - p;
      const int v = col - c0 + P.xoff;
      if (v >= 0 && v < P.xs) {
        hdst[j] = c * P.xs + v;
        hsrc[j] = c * plane + reflect_index(col, P.wd);
      }
    }
  }
  auto load_halo = [&](int lr, T (&hv)[kHalo]) {
    const T* src = xn + (long long)reflect_index(lr, P.h) * P.wd;
#pragma unroll
    for (int j = 0; j < kHalo; ++j) hv[j] = hdst[j] >= 0 ? src[hsrc[j]] : zero;
  };
  auto store_halo = [&](int slot, const T (&hv)[kHalo]) {
#pragma unroll
    for (int j = 0; j < kHalo; ++j)
      if (hdst[j] >= 0) ring[slot * P.ss + hdst[j]] = hv[j];
  };
  auto stage_x = [&](int lr, int slot) {
    const T* src = xn + (long long)reflect_index(lr, P.h) * P.wd;
    T* dst = ring + slot * P.ss;
    grid2(ci_t, P.xs, [&](int c, int v) {
      dst[c * P.xs + v] = src[c * plane + reflect_index(c0 + v - P.xoff, P.wd)];
    });
  };
  // g row oh of the tile's rows (all cout when folded) into a buffer,
  // column goff + u holding g col c0 + u for u < len; zeros around it.
  // issue_g: asynchronously (16-byte aligned rows); stage_g: element by
  // element
  auto issue_g = [&](int oh, int buf) {
    const T* src = gn + (long long)oh * P.wd + c0;
    T* dst = gbuf + buf * gbuf_elems + P.goff;
    grid2(grows, len / G, [&](int r, int q) {
      cp_async16(dst + r * P.gs + q * G, src + r * plane + q * G);
    });
  };
  auto stage_g = [&](int oh, int buf) {
    const T* src = gn + (long long)oh * P.wd + c0;
    T* dst = gbuf + buf * gbuf_elems;
    grid2(grows, P.gs, [&](int r, int s) {
      const int u = s - P.goff;
      dst[r * P.gs + s] = u >= 0 && u < len ? src[r * plane + u] : zero;
    });
  };

  // A row m and B row n of the tile (tile local): the offset of the row's
  // element 0 in its x ring slot or g buffer, and its tap dy (an x row) or
  // -1 (a g row). B rows may be odd.
  struct Row {
    int st, dy;
  };
  auto a_of = [&](int m) -> Row {
    if constexpr (FOLD) {
      const int dy = m / ci_t, cl = m - dy * ci_t;
      return {cl * P.xs, dy};
    } else {
      return {m * P.gs, -1};
    }
  };
  auto b_of = [&](int n) -> Row {
    if constexpr (FOLD) {
      const int co = n / k, dx = n - co * k;
      return {co * P.gs + P.goff - dx - (P.xoff - p), -1};
    } else {
      const int t = n / k, dx = n - t * k;
      const int cl = t / k, dy = t - cl * k;
      return {cl * P.xs + P.xoff - p + dx, dy};
    }
  };
  // the row's element offset at the output row whose tap 0 is in ring slot
  // s0, its g row in buffer buf
  auto at = [&](Row r, int s0, int buf) -> int {
    if (r.dy < 0) return P.ring + buf * gbuf_elems + r.st;
    const int s = s0 + r.dy;
    return (s >= ring_slots ? s - ring_slots : s) * P.ss + r.st;
  };
  // the OIHW index of tile element (m, n): the part of row m plus that of
  // column n
  auto m_part = [&](int m) -> long long {
    if constexpr (FOLD) {
      const int dy = m / ci_t, cl = m - dy * ci_t;
      return ((long long)(ci_lo + cl) * k + dy) * k;
    } else {
      return (long long)(co0 + m) * P.cin * k * k;
    }
  };
  auto n_part = [&](int n) -> long long {
    if constexpr (FOLD) {
      const int co = n / k, dx = n - co * k;
      return (long long)co * P.cin * k * k + dx;
    } else {
      return (long long)ci_lo * k * k + n;
    }
  };

  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int gid = lane >> 2, tig = lane & 3;
  float acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.f;
  // bf16: the A row whose address this lane gives ldmatrix, the thread's B
  // fragment rows (rows past the tile read its last) and the byte selection
  // of each B pair (odd rows: the high half of one word and the low half of
  // the next)
  Row ra[kMma ? MI : 1], rb[kMma ? NI : 1];
  uint32_t bsel[kMma ? NI : 1];
  const unsigned sm_addr =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_raw)) +
      2 * 8 * (lane >> 4);  // the lane's column group
  if constexpr (kMma) {
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
      ra[mi] = a_of(min(wm * WM + mi * 16 + (lane & 15), m_last));
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      rb[ni] = b_of(min(wn * WN + ni * 8 + gid, n_last));
      bsel[ni] = rb[ni].st & 1 ? 0x5432u : 0x3210u;
    }
  }

  // acc += A . B^T over one K step, K ascending
  auto compute = [&](int s0, int buf) {
    if constexpr (kMma) {
      unsigned aaddr[MI];
      int boff[NI];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) aaddr[mi] = sm_addr + 2 * at(ra[mi], s0, buf);
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) boff[ni] = at(rb[ni], s0, buf) >> 1;
      const uint32_t* w = reinterpret_cast<const uint32_t*>(sm) + tig;
#pragma unroll 2
      for (int k0 = 0; k0 < P.kpad; k0 += 16) {
        const int kw = k0 >> 1;
        uint32_t af[MI][4], bf[NI][2];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) ldmatrix_x4(af[mi], aaddr[mi] + 2 * k0);
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
          const uint32_t* b = w + boff[ni] + kw;
          bf[ni][0] = __byte_perm(b[0], b[1], bsel[ni]);
          bf[ni][1] = __byte_perm(b[4], b[5], bsel[ni]);
        }
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int ni = 0; ni < NI; ++ni)
            vct::igemm::mma_bf16(acc + (mi * NI + ni) * 4, af[mi], bf[ni]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < ACC; ++j) {
        const int e = tid + j * kThreads, m = e / BN, n = e % BN;
        if (m > m_last || n > n_last) continue;
        const T* a = sm + at(a_of(m), s0, buf);
        const T* b = sm + at(b_of(n), s0, buf);
        float s = acc[j];
        for (int kq = 0; kq < P.kpad; ++kq)
          s = fmaf(vct::igemm::to_f(a[kq]), vct::igemm::to_f(b[kq]), s);
        acc[j] = s;
      }
    }
  };

  // zeros everywhere first: no load writes the g columns outside the row
  // nor the x columns past the halo
  for (int i = tid; i < (int)(P.smem / 16); i += kThreads)
    reinterpret_cast<uint4*>(smem_raw)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  int s0 = r0 % ring_slots;  // the ring slot of output row oh's tap 0
  auto next_slot = [&](int s) { return s + 1 == ring_slots ? 0 : s + 1; };
  if (P.vec) {
    for (int dy = 0, s = s0; dy < k; ++dy, s = next_slot(s))
      issue_x(r0 - p + dy, s);
    issue_g(r0, 0);
    cp_async_commit();
    // the halo of the k rows: cells (row, channel, column), every load of a
    // batch issued before its stores
    const int cells = k * ci_t * 2 * p;
    constexpr int kBatch = 8;
    for (int i0 = 0; i0 < cells; i0 += kThreads * kBatch) {
      T v[kBatch];
      int dst[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int i = i0 + b * kThreads + tid;
        dst[b] = -1;
        if (i >= cells) continue;
        const int dy = i / (ci_t * 2 * p), rem = i - dy * (ci_t * 2 * p);
        const int c = rem / (2 * p), d = rem - c * 2 * p;
        const int col = d < p ? -1 - d : P.wd + d - p;
        const int vv = col - c0 + P.xoff;
        if (vv < 0 || vv >= P.xs) continue;
        const int s = s0 + dy >= ring_slots ? s0 + dy - ring_slots : s0 + dy;
        dst[b] = s * P.ss + c * P.xs + vv;
        v[b] = xn[c * plane + (long long)reflect_index(r0 - p + dy, P.h) * P.wd +
                  reflect_index(col, P.wd)];
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b)
        if (dst[b] >= 0) ring[dst[b]] = v[b];
    }
    cp_async_wait_all();
  } else {
    for (int dy = 0, s = s0; dy < k; ++dy, s = next_slot(s))
      stage_x(r0 - p + dy, s);
    stage_g(r0, 0);
  }
  __syncthreads();

  // per output row: issue the next row's loads (its g row and its one new
  // x row, into the slot this row does not read: the one before s0) and its
  // halo's, the products, the halo's stores, the wait, one barrier
  for (int oh = r0; oh < r1; ++oh) {
    const int buf = (oh - r0) & 1;
    const bool next = oh + 1 < r1;
    const int free_slot = s0 == 0 ? k : s0 - 1;
    T hv[kHalo];
    if (next && P.vec) {
      issue_x(oh + 1 + p, free_slot);
      issue_g(oh + 1, buf ^ 1);
      load_halo(oh + 1 + p, hv);
    }
    cp_async_commit();
    compute(s0, buf);
    if (next && P.vec) store_halo(free_slot, hv);
    cp_async_wait_all();
    __syncthreads();
    if (next && !P.vec) {
      stage_x(oh + 1 + p, free_slot);
      stage_g(oh + 1, buf ^ 1);
      __syncthreads();
    }
    s0 = next_slot(s0);
  }

  // the block's partial: each element of the tile to its OIHW place
  float* out = partial + slice * P.wcount;
  if constexpr (kMma) {
    long long mp[MI][2], np[NI][2];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        mp[mi][hh] = m_part(min(wm * WM + mi * 16 + gid + 8 * hh, m_last));
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        np[ni][e] = n_part(min(wn * WN + ni * 8 + tig * 2 + e, n_last));
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int m = wm * WM + mi * 16 + gid + (i >= 2 ? 8 : 0);
          const int n = wn * WN + ni * 8 + tig * 2 + (i & 1);
          if (m <= m_last && n <= n_last)
            out[mp[mi][i >> 1] + np[ni][i & 1]] = acc[(mi * NI + ni) * 4 + i];
        }
  } else {
#pragma unroll
    for (int j = 0; j < ACC; ++j) {
      const int e = tid + j * kThreads, m = e / BN, n = e % BN;
      if (m <= m_last && n <= n_last) out[m_part(m) + n_part(n)] = acc[j];
    }
  }
}

// dw[i] = the sum over the slices of partial[slice][i], in a fixed order:
// kGroups runs of consecutive slices, each summed in slice order, then the
// runs in order. A block takes 32 weights; its warps take one run each.
__global__ void __launch_bounds__(32 * kGroups)
    dw_reduce_kernel(const float* __restrict__ partial, float* __restrict__ dw,
                     long long wcount, long long slices) {
  __shared__ float runs[kGroups][32];
  const int lane = threadIdx.x & 31, run = threadIdx.x >> 5;
  const long long i = (long long)blockIdx.x * 32 + lane;
  const long long per = (slices + kGroups - 1) / kGroups;
  const long long t0 = run * per, t1 = min(slices, t0 + per);
  float s = 0.f;
  if (i < wcount) {
    constexpr int kBatch = 8;  // loads in flight before their sums
    long long t = t0;
    for (; t + kBatch <= t1; t += kBatch) {
      float v[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) v[b] = partial[(t + b) * wcount + i];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) s += v[b];
    }
    for (; t < t1; ++t) s += partial[t * wcount + i];
  }
  runs[run][lane] = s;
  __syncthreads();
  if (run == 0 && i < wcount) {
    float total = 0.f;
#pragma unroll
    for (int r = 0; r < kGroups; ++r) total += runs[r][lane];
    dw[i] = total;
  }
}

template <typename T, bool FOLD>
cudaError_t run(const Plan& P, const void* x, const void* g, float* partial,
                cudaStream_t stream) {
  auto kernel = dw_gemm_kernel<T, FOLD>;
  // the shared-memory limit raised so far (one host call per size)
  static size_t raised = vct::igemm::kDefaultSmem;
  if (P.smem > raised) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P.smem);
    if (e != cudaSuccess) return e;
    raised = P.smem;
  }
  kernel<<<(unsigned)(P.slices * P.tiles), kThreads, P.smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), partial, P);
  return cudaGetLastError();
}

bool valid(int n, int cin, int cout, int h, int wd, int k) {
  // k * k <= kBN: one channel's taps fit an N tile (k <= 11, unless the
  // taps fold)
  return n > 0 && cin > 0 && cout > 0 && h > 0 && wd > 0 && k > 1 &&
         k % 2 == 1 && k / 2 < h && k / 2 < wd &&
         ((long long)k * cout <= kFN || (long long)k * k <= kBN) &&
         (long long)cin * k * k <= INT_MAX / 4 &&
         (long long)cout * k <= INT_MAX / 4;
}

}  // namespace

// Floats of f32 scratch that vct_starved_dw needs for these shapes (the
// slices of the first kernel, enough for either type), or -1 when the kernel
// does not take them.
extern "C" long long vct_dw_scratch_floats(int n, int cin, int cout, int h,
                                           int wd, int k) {
  if (!valid(n, cin, cout, h, wd, k)) return -1;
  const Plan a = make_plan(n, cin, cout, h, wd, k, sizeof(float));
  const Plan b = make_plan(n, cin, cout, h, wd, k, sizeof(__nv_bfloat16));
  if (!fits(a) || !fits(b)) return -1;
  return std::max(a.slices, b.slices) * a.wcount;
}

// x: contiguous (n, cin, h, wd); g: contiguous (n, cout, h, wd) of the same
// type; dw: contiguous f32 (cout, cin, k, k); scratch: f32, at least
// vct_dw_scratch_floats(...) floats. dtype: vct::kFloat32 or
// vct::kBFloat16. Requires odd k > 1 with k / 2 < min(h, wd). Returns the
// cudaError_t of the launches (0 = success).
extern "C" int vct_starved_dw(const void* x, const void* g, void* dw,
                              void* scratch, int n, int cin, int cout, int h,
                              int wd, int k, int dtype, void* stream) {
  if (!valid(n, cin, cout, h, wd, k)) return (int)cudaErrorInvalidValue;
  const bool bf16 = dtype == vct::kBFloat16;
  if (!bf16 && dtype != vct::kFloat32) return (int)cudaErrorInvalidValue;
  const size_t elem = bf16 ? sizeof(__nv_bfloat16) : sizeof(float);
  Plan P = make_plan(n, cin, cout, h, wd, k, elem);
  if (!fits(P)) return (int)cudaErrorInvalidValue;
  P.vec = wd % (int)(16 / elem) == 0 &&
          reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(g) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* partial = static_cast<float*>(scratch);
  cudaError_t e;
  if (bf16)
    e = P.fold ? run<__nv_bfloat16, true>(P, x, g, partial, s)
               : run<__nv_bfloat16, false>(P, x, g, partial, s);
  else
    e = P.fold ? run<float, true>(P, x, g, partial, s)
               : run<float, false>(P, x, g, partial, s);
  if (e != cudaSuccess) return (int)e;
  dw_reduce_kernel<<<(unsigned)((P.wcount + 31) / 32), 32 * kGroups, 0, s>>>(
      partial, static_cast<float*>(dw), P.wcount, P.slices);
  return (int)cudaGetLastError();
}
