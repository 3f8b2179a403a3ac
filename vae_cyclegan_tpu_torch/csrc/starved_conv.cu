// Stride-1 convolution, odd k, in the three padding modes of the TPU kernel:
// NCHW input, OIHW weight, NCHW output, f32 accumulation, output in the input
// type. No bias (the caller adds it, as the JAX blocks do).
//
//   mode 0, reflect:   reflect-padded SAME (pad k/2), output h x w
//   mode 1, zero_same: zero-padded SAME (pad k/2), output h x w
//   mode 2, zero:      zero-padded FULL correlation (pad k-1), output
//                      (h+k-1) x (w+k-1)
//
// Replaces vae_cyclegan_tpu/ops/starved_conv.py:279 _conv_call (kernel body
// _conv_kernel) in all three of its modes. On the training path, reflect is
// the forward of the decoder's U4 (k3, 32->64 at 256x256) and tail (k7, 64->3);
// zero_same is the core of the input gradient (dx = reflect-fold of the full
// correlation with the rotated kernel; ops/starved_conv.py applies the fold's
// border strips): U4 dx (64->32 k3), tail dx (3->64 k7) and the encoder
// head's dx (64->3 k7). zero (full) is the fold's oracle, kept for tests.
// Like the TPU kernel, it resolves the halo in the loader, so no padded copy
// of the input is ever written to device memory: in reflect mode row and
// column -1 read 1, row H reads H-2 (no edge repeat), as _row_specs /
// _padded_row do; in the zero modes a halo element outside the image is 0.
//
// What bounds it: U4 at batch 4 is 9.7 GFLOP over ~50 MB of bf16 input and
// output, ~190 flop/byte, below the bf16 tensor-core ridge (~295 flop/byte):
// its bound is bytes, 0.015 ms at 3.35 TB/s. Summed over the path's sites
// at batch 4 the bounds are 0.0255 ms (reflect: U4 + tail) and 0.0360 ms
// (zero_same: head + U4 + tail dx), all bytes. So the work must run on the
// tensor cores, and the input must come from device memory about once.
//
// Design: an implicit GEMM per image on the tensor cores. M = output
// positions, a tile of R = 4 output rows x BM = 64 columns; N = output
// channels, a tile of BN = 8, 32 or 64; K = k*k*cin_g ordered (dy, dx, ci),
// ci fastest, cin_g = cin rounded up to even (the tail dx's 3 channels
// become 4, with zero weights), so each contraction pair is one aligned
// 4-byte word. A block of four warps owns one N tile and walks several M
// tiles: one wave of blocks over the card, sized from the occupancy API.
// - Weights: staged once per block in shared memory, reordered in the copy
//   from OIHW to (co, (dy*k + dx)*cin_g + ci). The block's rows are one run
//   of w, read in order with 16-byte loads and scattered into zeroed rows.
// - Slab: per M tile the input under it, R + k - 1 rows x BM + k - 1
//   columns, channel-innermost ([row][col][cin_s], cin_s = 8 mod 16 so that
//   a warp's fragment rows hit distinct banks). NCHW rows are read along W
//   with 16-byte loads where 8 columns lie inside the image, element by
//   element at the halo; two channels are packed into one 4-byte store.
//   Each input element is read (R + k - 1) / R times, not k*k times.
// - K loop: igemm::Tile, mma.sync m16n8k16, bf16 in, f32 accumulate. Every
//   fragment comes straight from the two resident operands, with no
//   barrier and no device-memory load in the loop, and K is summed in
//   ascending order, so a launch repeats bit for bit.
// - Epilogue: the tile is staged in shared memory (reusing the slab), and
//   each output channel's run of BM columns is stored with 16-byte stores.
// - The cout = 3 sites (tail forward, head dx; k * cout <= 24): an N tile
//   of cout would waste 5 of 8 columns and read each patch fragment for 3
//   products, so the dx taps are folded into N, as the TPU kernel packs
//   them for such a cout (_tight_co): rows M = the slab positions of the
//   tile's R rows (BM = 32 columns here, rounded up to 192 rows), N = (dx,
//   co), 21 of 24 used, K = (dy, ci), 7x smaller. The f32 products of each
//   position are staged, and output (r, c) sums those of positions c + dx
//   over dx in ascending order: per output, 3.5x fewer fragment loads
//   and two thirds of the mma of an N tile of 8.
// - f32 (the checks and the f32 step, never a timed path) runs the same
//   kernel through igemm::Tile's f32 FMA path, unfolded, with 2 x 32 tiles.
// - Where the weights and the slab of every channel do not fit shared
//   memory together (no site of the model), the K loop walks the channels
//   in chunks, each staged per tile; the order stays fixed.
// Not built yet: wgmma, and a two-stage slab whose loads overlap the last
// tile's products (today one tile's loads, and the barriers around them,
// wait on memory while the warps of that block do no products).

#include <climits>
#include <utility>

#include "igemm.cuh"

namespace {

using vct::igemm::align16;
using vct::igemm::kThreads;

// Padding modes shared with the Python wrapper (ops/starved_conv.py).
constexpr int kReflect = 0;
constexpr int kZeroSame = 1;
constexpr int kZeroFull = 2;

// Reflect without edge repeat (-1 -> 1, n -> n - 2), valid for a halo
// narrower than the image; rows and columns of a tile that lie past the
// image only feed outputs that are never stored, so clamp them.
__device__ __forceinline__ int reflect_index(int i, int n) {
  i = i < 0 ? -i : i;
  i = i >= n ? 2 * n - 2 - i : i;
  return min(max(i, 0), n - 1);
}

// Two channels' values at one slab position, stored as one pair.
__device__ __forceinline__ void store_pair(float* p, float lo, float hi) {
  *reinterpret_cast<float2*>(p) = make_float2(lo, hi);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, __nv_bfloat16 lo,
                                           __nv_bfloat16 hi) {
  *reinterpret_cast<uint32_t*>(p) =
      vct::igemm::bits(lo) | (vct::igemm::bits(hi) << 16);
}

// The A operand: patch-matrix element (m, k), m = r * BM + c the output
// position (r, c) of the tile, at slab element r * row + c * cin_s +
// koff[k / 2] + (k & 1), koff holding (dy * span + dx) * cin_s + ci of each
// contraction pair. row = span * cin_s.
template <typename T, int BM>
struct Patches {
  const T* p;
  const int* koff;
  int row, cin_s;
  __device__ __forceinline__ const T* at(int m, int k) const {
    return p + (m / BM) * row + (m % BM) * cin_s + koff[k >> 1];
  }
  __device__ __forceinline__ uint32_t pair(int m, int k) const {
    return *reinterpret_cast<const uint32_t*>(at(m, k));
  }
  __device__ __forceinline__ float value(int m, int k) const {
    return vct::igemm::to_f(at(m, k)[k & 1]);
  }
};

// The A operand of the folded form (bf16 only): element (m, k), m a slab
// position (r * span + c), k = dy * cin_g + ci, at slab element m * cin_s +
// koff[k / 2] + (k & 1), koff holding dy * span * cin_s + ci.
template <typename T>
struct Positions {
  const T* p;
  const int* koff;
  int cin_s;
  __device__ __forceinline__ uint32_t pair(int m, int k) const {
    return *reinterpret_cast<const uint32_t*>(p + m * cin_s + koff[k >> 1]);
  }
};

// The folded form: its N tile (k * cout columns, the tail's 21), and the
// slab columns past BM that its M tile covers per output row (k <= 17).
constexpr int kFoldN = 24;
constexpr int kFoldHalo = 16;

struct Shape {
  int cin, cout, h, wd, k, pad, mode, out_h, out_w;
  int cc, cin_s;     // channels per K chunk (even), their slab stride
  int chunks;        // K chunks over cin (1: the weights stay resident)
  int bands, tiles_w, tiles_n, tpb;
  long long tiles;   // M tiles over all images
};

// The element of channel plane `xc` at input (ir, ic) under the padding
// rule; `row_ok` is false for a row outside the image in a zero mode.
template <typename T>
__device__ __forceinline__ T fetch(const T* xc, int ir, bool row_ok, int ic,
                                   const Shape& s) {
  if (s.mode == kReflect) return xc[(long long)ir * s.wd + reflect_index(ic, s.wd)];
  return row_ok && ic >= 0 && ic < s.wd ? xc[(long long)ir * s.wd + ic]
                                        : vct::igemm::from_f<T>(0.f);
}

template <typename T, int BM, int R, int BN, bool FOLD>
__global__ void __launch_bounds__(kThreads)
    conv_kernel(const T* __restrict__ x, const T* __restrict__ w,
                T* __restrict__ y, const Shape s) {
  // FOLD: M = every slab position of R rows (rounded up), N = (dx, co)
  constexpr int M = FOLD ? (R * (BM + kFoldHalo) + 63) / 64 * 64 : R * BM;
  constexpr int G = 16 / sizeof(T);  // columns per 16-byte load or store
  constexpr int OS = M + 8;          // staged output: channel stride
  using Tl = vct::igemm::Tile<T, M, BN, 4>;
  static_assert(BM % G == 0, "tile");
  const int k = s.k, kk2 = k * k;
  const int K = (FOLD ? k : kk2) * s.cc, kpad = (K + 15) / 16 * 16;
  const int ws = kpad + 8;  // weight row stride: 8 mod 16, distinct banks
  const int span = BM + k - 1, rows_s = R + k - 1;
  const int npairs = s.cc / 2;
  const int nt = blockIdx.x % s.tiles_n;
  const int n0 = nt * BN;
  const int nreal = FOLD ? k * s.cout : min(BN, s.cout - n0);
  const int tid = threadIdx.x;
  const long long plane = (long long)s.h * s.wd;
  const long long out_plane = (long long)s.out_h * s.out_w;
  const bool vec = s.wd % G == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec_out =
      s.out_w % G == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;

  // shared memory: weights [nreal][ws] | koff [kpad / 2] | slab
  // [rows_s][span][cin_s], which the staged output [BN][OS] reuses
  extern __shared__ __align__(16) unsigned char smem[];
  T* wsm = reinterpret_cast<T*>(smem);
  int* koff = reinterpret_cast<int*>(smem + align16(sizeof(T) * nreal * ws));
  T* slab = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(koff) +
                                 align16(sizeof(int) * (kpad / 2)));
  T* stage = slab;

  for (int q = tid; q < kpad / 2; q += kThreads) {
    const int kq = 2 * q;
    int off = 0;
    if (kq < K) {
      const int tap = kq / s.cc, ci = kq - tap * s.cc;
      if constexpr (FOLD) {
        off = tap * span * s.cin_s + ci;  // tap = dy
      } else {
        const int dy = tap / k, dx = tap - dy * k;
        off = (dy * span + dx) * s.cin_s + ci;
      }
    }
    koff[q] = off;
  }
  // the weights of channels ci0 .. ci0 + cc - 1: row co, column (dy * k +
  // dx) * cc + ci - ci0; FOLD: row dx * cout + co, column dy * cc + ci - ci0;
  // zeros past cin and K. The block's rows are one run of OIHW w, read in
  // order with 16-byte loads where aligned (a gather in the smem order would
  // wait on memory once per element) and scattered into the zeroed rows.
  auto stage_weights = [&](int ci0) {
    constexpr int V = 16 / sizeof(T);
    for (int i = tid; i < nreal * ws / V; i += kThreads)
      reinterpret_cast<uint4*>(wsm)[i] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
    const int per_co = s.cin * kk2;
    const int len = (FOLD ? s.cout : nreal) * per_co;
    const T* src = w + (long long)n0 * per_co;
    // `count` elements of the run from element f: output channel f /
    // per_co, then ci, then the tap
    auto put = [&](int f, const T* vals, int count) {
      int co = f / per_co, rem = f - co * per_co;
      int ci = rem / kk2, t = rem - ci * kk2;
      for (int j = 0; j < count; ++j) {
        if (ci >= ci0 && ci < ci0 + s.cc) {
          int dst;
          if constexpr (FOLD) {
            const int dy = t / k, dx = t - dy * k;
            dst = (dx * s.cout + co) * ws + dy * s.cc + ci - ci0;
          } else {
            dst = co * ws + t * s.cc + ci - ci0;
          }
          wsm[dst] = vals[j];
        }
        if (++t == kk2) {
          t = 0;
          if (++ci == s.cin) ci = 0, ++co;
        }
      }
    };
    if (len % V == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0) {
      constexpr int kBatch = 4;
      const int nv = len / V;
      for (int i0 = 0; i0 < nv; i0 += kThreads * kBatch) {
        uint4 v[kBatch];
#pragma unroll
        for (int bt = 0; bt < kBatch; ++bt) {
          const int i = i0 + bt * kThreads + tid;
          if (i < nv) v[bt] = reinterpret_cast<const uint4*>(src)[i];
        }
#pragma unroll
        for (int bt = 0; bt < kBatch; ++bt) {
          const int i = i0 + bt * kThreads + tid;
          if (i < nv) put(i * V, reinterpret_cast<const T*>(&v[bt]), V);
        }
      }
    } else {
      for (int f = tid; f < len; f += kThreads) put(f, src + f, 1);
    }
  };
  if (s.chunks == 1) stage_weights(0);
  using OpA = std::conditional_t<FOLD, Positions<T>, Patches<T, BM>>;
  OpA a;
  if constexpr (FOLD) a = OpA{slab, koff, s.cin_s};
  else a = OpA{slab, koff, span * s.cin_s, s.cin_s};
  const vct::igemm::Rows<T> b{wsm, ws, nreal - 1};

  const long long per_img = (long long)s.bands * s.tiles_w;
  const long long t0 = (long long)(blockIdx.x / s.tiles_n) * s.tpb;
  const long long t1 = min(s.tiles, t0 + s.tpb);
  for (long long t = t0; t < t1; ++t) {
    const int img = (int)(t / per_img);
    const int rem = (int)(t - img * per_img);
    const int oh0 = rem / s.tiles_w * R, oc0 = rem % s.tiles_w * BM;
    const T* xn = x + (long long)img * s.cin * plane;
    float acc[Tl::ACC];
#pragma unroll
    for (int i = 0; i < Tl::ACC; ++i) acc[i] = 0.f;

    for (int ci0 = 0; ci0 < s.cin; ci0 += s.cc) {
      __syncthreads();  // every warp is done with the last slab and stage
      if (s.chunks > 1) stage_weights(ci0);
      // interior columns oc0 .. oc0 + BM - 1, G at a time: item (row,
      // group, pair), the pair fastest. The loads of a batch are issued
      // before its stores.
      constexpr int kBatch = 4;
      const int ngroups = BM / G;
      const int items = rows_s * ngroups * npairs;
      for (int i0 = 0; i0 < items; i0 += kThreads * kBatch) {
        uint4 lo[kBatch], hi[kBatch];
        int dst[kBatch];
#pragma unroll
        for (int bt = 0; bt < kBatch; ++bt) {
          const int i = i0 + bt * kThreads + tid;
          dst[bt] = -1;
          if (i >= items) continue;
          const int q = i % npairs, rest = i / npairs;
          const int g = rest % ngroups, rr = rest / ngroups;
          const int c = ci0 + 2 * q;
          int ir = oh0 - s.pad + rr;
          bool row_ok = true;
          if (s.mode == kReflect) ir = reflect_index(ir, s.h);
          else row_ok = ir >= 0 && ir < s.h;
          const int ic = oc0 + g * G;
          const int d = (rr * span + s.pad + g * G) * s.cin_s + 2 * q;
          if (vec && row_ok && ic + G <= s.wd) {
            const T* src = xn + (long long)c * plane + (long long)ir * s.wd + ic;
            const uint4 z = make_uint4(0u, 0u, 0u, 0u);
            lo[bt] = c < s.cin ? *reinterpret_cast<const uint4*>(src) : z;
            hi[bt] = c + 1 < s.cin
                         ? *reinterpret_cast<const uint4*>(src + plane) : z;
            dst[bt] = d;
          } else {  // rare: element by element, here and now
            const T zero = vct::igemm::from_f<T>(0.f);
            const T* x0 = xn + (long long)c * plane;
            for (int j = 0; j < G; ++j) {
              const T v0 = c < s.cin ? fetch(x0, ir, row_ok, ic + j, s) : zero;
              const T v1 = c + 1 < s.cin
                               ? fetch(x0 + plane, ir, row_ok, ic + j, s) : zero;
              store_pair(slab + d + j * s.cin_s, v0, v1);
            }
          }
        }
#pragma unroll
        for (int bt = 0; bt < kBatch; ++bt) {
          if (dst[bt] < 0) continue;
          const T* l = reinterpret_cast<const T*>(&lo[bt]);
          const T* u = reinterpret_cast<const T*>(&hi[bt]);
#pragma unroll
          for (int j = 0; j < G; ++j)
            store_pair(slab + dst[bt] + j * s.cin_s, l[j], u[j]);
        }
      }
      // the halo: pad columns on the left, k - 1 - pad on the right
      const int hitems = rows_s * (k - 1) * npairs;
      for (int i = tid; i < hitems; i += kThreads) {
        const int q = i % npairs, rest = i / npairs;
        const int hs = rest % (k - 1), rr = rest / (k - 1);
        const int sc = hs < s.pad ? hs : hs + BM;
        const int c = ci0 + 2 * q;
        int ir = oh0 - s.pad + rr;
        bool row_ok = true;
        if (s.mode == kReflect) ir = reflect_index(ir, s.h);
        else row_ok = ir >= 0 && ir < s.h;
        const int ic = oc0 - s.pad + sc;
        const T zero = vct::igemm::from_f<T>(0.f);
        const T* x0 = xn + (long long)c * plane;
        const T v0 = c < s.cin ? fetch(x0, ir, row_ok, ic, s) : zero;
        const T v1 = c + 1 < s.cin ? fetch(x0 + plane, ir, row_ok, ic, s) : zero;
        store_pair(slab + (rr * span + sc) * s.cin_s + 2 * q, v0, v1);
      }
      __syncthreads();
      Tl::mac(acc, a, b, kpad);
    }

    // epilogue: the tile through shared memory, [n][m], then each output
    // channel's row runs out G columns at a time. FOLD: the f32 products
    // of each slab position and tap column are staged, and output (r, c)
    // of channel co sums those of positions r * span + c + dx, columns
    // dx * cout + co, over dx in ascending order.
    __syncthreads();  // every warp is done with the slab
    float* zst = reinterpret_cast<float*>(slab);
    Tl::each(acc, [&](int m, int n, float v) {
      if constexpr (FOLD) zst[n * OS + m] = v;
      else stage[n * OS + m] = vct::igemm::from_f<T>(v);
    });
    __syncthreads();
    const int ngroups = BM / G;
    const int cout_t = FOLD ? s.cout : nreal;
    const int oitems = cout_t * R * ngroups;
    for (int i = tid; i < oitems; i += kThreads) {
      const int g = i % ngroups, rest = i / ngroups;
      const int r = rest % R, co = rest / R;
      const int oh = oh0 + r, oc = oc0 + g * G;
      if (oh >= s.out_h || oc >= s.out_w) continue;
      T* dst = y + ((long long)img * s.cout + n0 + co) * out_plane +
               (long long)oh * s.out_w + oc;
      const T* src = stage + co * OS + r * BM + g * G;
      alignas(16) T folded[G];
      if constexpr (FOLD) {
#pragma unroll
        for (int j = 0; j < G; ++j) {
          const float* z = zst + co * OS + r * span + g * G + j;
          float v = 0.f;
          for (int dx = 0; dx < k; ++dx) v += z[dx * s.cout * OS + dx];
          folded[j] = vct::igemm::from_f<T>(v);
        }
        src = folded;
      }
      if (vec_out && oc + G <= s.out_w) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int j = 0; j < G && oc + j < s.out_w; ++j) dst[j] = src[j];
      }
    }
  }
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

template <typename T, int BM, int R, int BN, bool FOLD>
cudaError_t run(const void* x, const void* w, void* y, int n, Shape s,
                cudaStream_t stream) {
  constexpr int M = FOLD ? (R * (BM + kFoldHalo) + 63) / 64 * 64 : R * BM;
  const int k = s.k;
  const int rows_w = FOLD ? k * s.cout : min(BN, s.cout);
  // channels per K chunk: all of them where the weights and the slab fit
  // shared memory together, else the most that do (even)
  auto smem_for = [&](int cc) {
    int cin_s = (cc + 7) / 8 * 8;
    if (cin_s % 16 == 0) cin_s += 8;
    const size_t kpad = ((size_t)(FOLD ? k : k * k) * cc + 15) / 16 * 16;
    // FOLD: the last tile rows read k - 1 slab rows on past its R * span
    // positions (products that the fold never reads); its stage is f32
    const size_t positions = FOLD ? (size_t)M + (size_t)(k - 1) * (BM + k - 1)
                                  : (size_t)(R + k - 1) * (BM + k - 1);
    const size_t slab = sizeof(T) * positions * cin_s;
    const size_t out = (FOLD ? sizeof(float) : sizeof(T)) * (size_t)BN * (M + 8);
    return std::make_pair(
        align16(sizeof(T) * rows_w * (kpad + 8)) + align16(sizeof(int) * kpad / 2) +
            (slab > out ? slab : out),
        cin_s);
  };
  int cc = (s.cin + 1) / 2 * 2;
  while (cc > 2 && smem_for(cc).first > vct::igemm::kMaxSmem)
    cc = (cc / 2 + 1) / 2 * 2;
  const auto [smem, cin_s] = smem_for(cc);
  if (smem > vct::igemm::kMaxSmem) return cudaErrorInvalidValue;
  s.cc = cc;
  s.cin_s = cin_s;
  s.chunks = (s.cin + cc - 1) / cc;
  s.bands = (s.out_h + R - 1) / R;
  s.tiles_w = (s.out_w + BM - 1) / BM;
  s.tiles_n = FOLD ? 1 : (s.cout + BN - 1) / BN;
  s.tiles = (long long)n * s.bands * s.tiles_w;

  auto kernel = conv_kernel<T, BM, R, BN, FOLD>;
  // the shared-memory limit raised so far, and the blocks per SM of the
  // last size asked (the host calls are made once per size)
  static size_t raised = vct::igemm::kDefaultSmem, asked = 0;
  static int per_sm = 1;
  if (smem > raised) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    raised = smem;
  }
  if (smem != asked) {
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kernel, kThreads, smem) != cudaSuccess || per_sm < 1)
      per_sm = 1;
    asked = smem;
  }
  // one wave: as many blocks as fit on the card at once, each walking
  // tpb M tiles of one N tile, so that its weights are staged once
  const long long slots = (long long)sm_count() * per_sm;
  const long long work = s.tiles * s.tiles_n;
  s.tpb = (int)((work + slots - 1) / slots);
  if (s.tpb < 1) s.tpb = 1;
  const long long blocks = s.tiles_n * ((s.tiles + s.tpb - 1) / s.tpb);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
      s);
  return cudaGetLastError();
}

// bf16 on the tensor cores: where k * cout <= kFoldN (the cout = 3 sites)
// the folded form, M tiles of 4 output rows x 32 columns; else M tiles of 4
// rows x 64 columns and N tiles of 8, 32 or 64 channels. f32 on the CUDA
// cores (every thread M * BN / 128 accumulators): 2 rows x 32 columns.
template <typename T>
cudaError_t dispatch(const void* x, const void* w, void* y, int n,
                     const Shape& s, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (s.k * s.cout <= kFoldN && s.k - 1 <= kFoldHalo)
      return run<T, 32, 4, kFoldN, true>(x, w, y, n, s, stream);
    if (s.cout <= 8) return run<T, 64, 4, 8, false>(x, w, y, n, s, stream);
    if (s.cout <= 32) return run<T, 64, 4, 32, false>(x, w, y, n, s, stream);
    return run<T, 64, 4, 64, false>(x, w, y, n, s, stream);
  } else {
    if (s.cout <= 8) return run<T, 32, 2, 8, false>(x, w, y, n, s, stream);
    if (s.cout <= 32) return run<T, 32, 2, 32, false>(x, w, y, n, s, stream);
    return run<T, 32, 2, 64, false>(x, w, y, n, s, stream);
  }
}

}  // namespace

// x: contiguous (n, cin, h, wd); w: contiguous (cout, cin, k, k) of the same
// type; y: contiguous (n, cout, out_h, out_w), out = in for modes 0 and 1 and
// in + k - 1 for mode 2. mode: 0 reflect, 1 zero_same, 2 zero (full). dtype:
// vct::kFloat32 or vct::kBFloat16. Requires odd k, and k / 2 < min(h, wd) in
// reflect mode. Returns the cudaError_t of the launch (0 = success).
extern "C" int vct_starved_conv(const void* x, const void* w, void* y, int n,
                                int cin, int cout, int h, int wd, int k,
                                int mode, int dtype, void* stream) {
  if (n <= 0 || n > 65535 || cin <= 0 || cout <= 0 || h <= 0 || wd <= 0 ||
      k <= 0 || k % 2 == 0 || mode < kReflect || mode > kZeroFull ||
      (mode == kReflect && (k / 2 >= h || k / 2 >= wd)) ||
      (long long)k * k * (cin + 1) > INT_MAX / 4 ||
      (long long)(h + k) * (wd + k) > INT_MAX)
    return (int)cudaErrorInvalidValue;
  Shape s{};
  s.cin = cin;
  s.cout = cout;
  s.h = h;
  s.wd = wd;
  s.k = k;
  s.mode = mode;
  s.pad = mode == kZeroFull ? k - 1 : k / 2;
  s.out_h = h + 2 * s.pad - (k - 1);
  s.out_w = wd + 2 * s.pad - (k - 1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == vct::kFloat32)
    return (int)dispatch<float>(x, w, y, n, s, st);
  if (dtype == vct::kBFloat16)
    return (int)dispatch<__nv_bfloat16>(x, w, y, n, s, st);
  return (int)cudaErrorInvalidValue;
}
