// The dw dot probe: out (mk, nk) f32 = sum over `steps` passes of p . g^T,
// p (mk, kk) and g (nk, kk) of one type, each pass's whole K = kk contraction
// summed afresh in f32 and then added to the accumulator, in pass order.
//
// Replaces experiments/dw_dot_probe.py::make (kernel body kern). The TPU
// kernel walks a sequential grid of `steps` steps whose BlockSpecs all map to
// block (0, 0): p and g are loaded into VMEM once and every step's dot runs
// from there, adding into an f32 scratch. It times the MXU on the
// weight-gradient dot shapes of the k7 and k3 starved convs.
//
// What bounds it: the six probes do 34.7-65.5 GFLOP on 1-11 MB, so the
// tensor cores bound them: 0.0351, 0.0351, 0.0435, 0.0435, 0.0589 and
// 0.0662 ms at 989 TFLOP/s. Their outputs are few (9,728-18,432), so one
// CTA per output tile would leave most of the 132 SMs idle.
//
// The design:
//  1. Each output tile (32 rows of p by TN = 16, 32 or 64 rows of g) belongs
//     to a thread block cluster of C CTAs (1-16; above 8 with the
//     non-portable attribute, refused unless the occupancy API places one).
//     Rank r owns the K slice [r * kslice, (r + 1) * kslice), kslice a
//     multiple of 16, every slice nonempty. The launch plan (the wrapper's
//     dw_dot_probe.plan) picks C, a power of two, and TN, 32 where it can,
//     for the fewest waves of CTAs and the least work on the busiest SM: the
//     four tail and head probes run 80-112 CTAs in one wave; the two u4
//     probes 288 CTAs of ~100 KB, more than 132 SMs hold at two a SM, so
//     two waves.
//  2. Each CTA copies its rows of p and g over its K slice into shared memory
//     once (4-byte loads where kk is even and both operands 4-byte aligned,
//     else 2-byte ones; zeros past kk and past mk, nk), rows an odd number of
//     16-byte chunks apart. Every step then runs from there: eight warps,
//     each a 32 x 16 warp tile over 1/KW of the slice (KW = 8 / (TN / 16)
//     K groups), fragments by ldmatrix.x4 into mma.sync m16n8k16 (bf16), or
//     f32 FMAs (true f32, no TF32) on the same split.
//  3. Per step the CTA sums its K groups' partial tiles in group order and
//     sends each quad (4 floats) of the sum to the rank that owns it (rank r
//     owns the r-th 1/C of the tile) with st.async into one of that rank's
//     two receive slots, in this rank's row; the stores count their bytes on
//     the owner's mbarrier for the slot. The owner waits on that mbarrier,
//     sums its quads over the ranks in rank order and adds the step's dot to
//     its f32 accumulator. The next step's products are computed while the
//     quads travel. No rank writes a slot again before its owner has read
//     it: a rank sends step s + 2 only after receiving everyone's step s + 1,
//     and everyone sends step s + 1 only after reading step s (a CTA barrier
//     between, and st.async's byte count is a release at cluster scope). No
//     atomics: a launch repeats bit for bit. A cluster barrier at the start
//     (mbarriers ready) and one at the end.
// Every step is computed afresh; the kernel never folds them into
// steps x (p . g^T).
//
// What still holds it back: mma.sync, at half wgmma's rate (wgmma's 64-row
// operand would make the tiles, and so each step's exchange, four times as
// large); per step two CTA barriers, the K groups' sum and the quads' trip
// to their owners, 1,920 sequential exchanges over the six probes; the
// 32-row tile pads mk = 24 by a third; the two u4 probes take two waves.
// Tried in copies of this kernel on the card and not kept: a pull through
// distributed shared memory behind a cluster barrier per step (this
// design's first form: the barrier's release and the remote loads took most
// of a step, by clock64 per phase); the A fragments held in registers (a
// third of the shared-memory reads, but no faster, and one CTA an SM); a
// ninth warp doing the exchange beside the eight that multiply (no
// faster).

#include <cooperative_groups.h>

#include "igemm.cuh"
#include "ptx.cuh"

namespace {

namespace cg = cooperative_groups;
using vct::igemm::mma_bf16;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTileM = 32;       // rows of p a tile covers
constexpr int kWarpN = 16;       // rows of g a warp tile covers
constexpr int kPad = 8;          // floats past each partial-tile row
constexpr int kMaxCluster = 16;
constexpr int kPortableCluster = 8;
constexpr int kLoadBatch = 16;   // loads a thread keeps in flight
constexpr int kRanksAtOnce = 8;  // receive-slot loads a thread keeps in flight

// The shared-memory layout of a CTA: the operand rows (kTileM of p, then tn
// of g) over the K slice, rows `stride` bytes apart (bf16: an odd number of
// 16-byte chunks, so ldmatrix's eight rows fall in distinct banks; f32: an
// odd number of words); the K groups' partial tiles, kTileM rows of tn +
// kPad floats each; the two receive slots, each one share of the tile (share
// quads of 4 floats) from every rank; the slots' two mbarriers. Mirrored by
// experiments/dw_dot_probe.py::smem_bytes.
struct Geometry {
  int kgroups, stride, ps, quads, share;
  size_t op_bytes, part_floats, recv_bytes, smem;
};

__host__ __device__ inline Geometry geometry(int tn, int kslice, int elem,
                                             int cluster) {
  Geometry g;
  g.kgroups = kWarps / (tn / kWarpN);
  if (elem == 2) {
    const int chunks = kslice / 8;
    g.stride = (chunks % 2 == 0 ? chunks + 1 : chunks) * 16;
  } else {
    g.stride = (kslice + 1) * 4;
  }
  g.ps = tn + kPad;
  g.quads = kTileM * tn / 4;
  g.share = (g.quads + cluster - 1) / cluster;
  g.op_bytes = ((size_t)(kTileM + tn) * g.stride + 15) / 16 * 16;
  g.part_floats = (size_t)kTileM * g.ps;
  g.recv_bytes = (size_t)2 * cluster * g.share * 16;
  g.smem = g.op_bytes + g.kgroups * g.part_floats * sizeof(float) +
           g.recv_bytes + 2 * sizeof(uint64_t);
  return g;
}

__device__ __forceinline__ void cluster_sync_all() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// `addr` (this CTA's shared window) as the same offset in rank `rank`'s
// shared window
__device__ __forceinline__ unsigned map_rank(unsigned addr, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void mbar_init(unsigned bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// this thread's arrival on the local mbarrier, expecting `bytes` more
__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.release.cta.shared::cta.b64 _, [%0], %1;\n" ::
          "r"(bar),
      "r"(bytes)
      : "memory");
}

// until the phase of parity `parity` of the local mbarrier has completed; its
// data, stored by any rank, is then visible
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// v into another rank's shared memory at `addr` (shared::cluster), its 16
// bytes counted on that rank's mbarrier `bar`; the count is a release at
// cluster scope
__device__ __forceinline__ void send4(unsigned addr, const float4& v,
                                      unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(addr),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// Rows [0, tm) of `a` and [0, tn) of `b` (row length ld units; `arows`,
// `brows` of them real) over the columns [c0, c0 + cols) into dst (rows
// dstride units apart): a's rows first, then b's; zeros past the real rows
// and past ld. U is the unit of a load: a 4-byte word (an f32, or a bf16
// pair) or a 2-byte bf16.
template <typename U>
__device__ __forceinline__ void load_slice(U* dst, int dstride, const U* a,
                                           int arows, const U* b, int brows,
                                           long long ld, long long c0,
                                           int cols, int tm, int tn) {
  const int total = (tm + tn) * cols;
  for (int base = threadIdx.x; base < total; base += kThreads * kLoadBatch) {
    U v[kLoadBatch];
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int i = base + u * kThreads;
      v[u] = U(0);
      if (i < total) {
        const int r = i / cols, c = i - r * cols;
        const bool in_a = r < tm;
        const int rr = in_a ? r : r - tm;
        if ((in_a ? rr < arows : rr < brows) && c0 + c < ld)
          v[u] = (in_a ? a : b)[rr * ld + c0 + c];
      }
    }
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int i = base + u * kThreads;
      if (i < total) {
        const int r = i / cols;
        dst[r * dstride + (i - r * cols)] = v[u];
      }
    }
  }
}

template <typename T, int NT>
__global__ void __launch_bounds__(kThreads, 2)
    dot_probe_cluster_kernel(const T* __restrict__ p, const T* __restrict__ g,
                             float* __restrict__ out, int mk, int nk, int kk,
                             int steps, int tiles_n, int kslice, int pairs) {
  constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  constexpr int TN = NT * kWarpN;
  constexpr int KW = kWarps / NT;    // K groups of warps
  constexpr int PS = TN + kPad;      // floats a partial-tile row
  constexpr int PART = kTileM * PS;  // floats a partial tile
  constexpr int QUADS = kTileM * TN / 4;
  constexpr int NQ = (QUADS + kThreads - 1) / kThreads;  // quads a thread
  extern __shared__ __align__(16) unsigned char smem[];

  cg::cluster_group cl = cg::this_cluster();
  const int C = (int)cl.num_blocks();
  const int rank = (int)cl.block_rank();
  const int tile = blockIdx.x / C;
  const int m0 = (tile / tiles_n) * kTileM, n0 = (tile % tiles_n) * TN;
  const long long k0 = (long long)rank * kslice;
  const Geometry geo = geometry(TN, kslice, (int)sizeof(T), C);
  float* wpart = reinterpret_cast<float*>(smem + geo.op_bytes);
  float4* recv = reinterpret_cast<float4*>(wpart + KW * PART);
  const unsigned full = vct::ptx::smem_addr(
      reinterpret_cast<unsigned char*>(recv) + geo.recv_bytes);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int share = geo.share;
  // this rank's quads of the tile: [rank * share, rank * share + owned)
  const int owned = max(0, min(share, QUADS - rank * share));

  if (tid == 0) {
    mbar_init(full, 1);
    mbar_init(full + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the operands, once
  if (kMma && pairs) {
    load_slice(reinterpret_cast<uint32_t*>(smem), geo.stride / 4,
               reinterpret_cast<const uint32_t*>(p) + (long long)m0 * (kk / 2),
               mk - m0,
               reinterpret_cast<const uint32_t*>(g) + (long long)n0 * (kk / 2),
               nk - n0, kk / 2, k0 / 2, kslice / 2, kTileM, TN);
  } else {
    using U = typename std::conditional<kMma, uint16_t, uint32_t>::type;
    load_slice(reinterpret_cast<U*>(smem), geo.stride / (int)sizeof(U),
               reinterpret_cast<const U*>(p) + (long long)m0 * kk, mk - m0,
               reinterpret_cast<const U*>(g) + (long long)n0 * kk, nk - n0,
               kk, k0, kslice, kTileM, TN);
  }
  cluster_sync_all();  // operands loaded, every rank's mbarriers ready

  // this warp: columns [tp * 16, tp * 16 + 16) of the tile over the k16
  // blocks [kb0, kb1) of the slice
  const int tp = warp % NT, kg = warp / NT;
  const int nkb = kslice / 16;
  const int kb0 = kg * nkb / KW, kb1 = (kg + 1) * nkb / KW;
  float part[16];  // bf16: [mi][ni][4] of mma C fragments; f32: [i][j]

  auto dot = [&]() {
    if constexpr (kMma) {
      // A: the lane's row of a 16-row fragment and its chunk (of two); B:
      // its row of the 16-row pair of n8 fragments and its chunk
      const unsigned ops = vct::ptx::smem_addr(smem);
      const unsigned abase = ops + (unsigned)((lane & 15) * geo.stride +
                                              (lane >> 4) * 16);
      const unsigned bbase =
          ops + (unsigned)((kTileM + tp * kWarpN + (lane & 7) +
                            ((lane >> 4) << 3)) * geo.stride +
                           ((lane >> 3) & 1) * 16);
      const unsigned a1 = 16u * (unsigned)geo.stride;
      float c[2][16];  // two chains, even and odd k16 blocks
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 16; ++i) c[h][i] = 0.f;
      // a block's fragments: A rows 0-15, A rows 16-31, B's two n8 halves
      auto load = [&](uint32_t (*f)[4], int kb) {
        const unsigned off = (unsigned)kb * 32u;
        vct::ptx::ldmatrix_x4(f[0], abase + off);
        vct::ptx::ldmatrix_x4(f[1], abase + a1 + off);
        vct::ptx::ldmatrix_x4(f[2], bbase + off);
      };
      auto mma = [&](float* acc, uint32_t (*f)[4]) {
        const uint32_t b0[2] = {f[2][0], f[2][1]}, b1[2] = {f[2][2], f[2][3]};
        mma_bf16(acc + 0, f[0], b0);
        mma_bf16(acc + 4, f[0], b1);
        mma_bf16(acc + 8, f[1], b0);
        mma_bf16(acc + 12, f[1], b1);
      };
      // software-pipelined: a block's fragments load while the one before
      // it multiplies
      uint32_t fe[3][4], fo[3][4];
      if (kb0 < kb1) load(fe, kb0);
      for (int kb = kb0; kb < kb1; kb += 2) {
        if (kb + 1 < kb1) load(fo, kb + 1);
        mma(c[0], fe);
        if (kb + 2 < kb1) load(fe, kb + 2);
        if (kb + 1 < kb1) mma(c[1], fo);
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) part[i] = c[0][i] + c[1][i];
    } else {
      // lane (lm, ln): rows 4 lm + i of the tile, columns tp * 16 + 4 ln + j
      const int srow = geo.stride / 4;
      const float* a = reinterpret_cast<const float*>(smem) +
                       (lane >> 2) * 4 * srow;
      const float* b = reinterpret_cast<const float*>(smem) +
                       (kTileM + tp * kWarpN + (lane & 3) * 4) * srow;
#pragma unroll
      for (int i = 0; i < 16; ++i) part[i] = 0.f;
      for (int k = kb0 * 16; k < kb1 * 16; ++k) {
        float av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          av[i] = a[i * srow + k];
          bv[i] = b[i * srow + k];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            part[i * 4 + j] = fmaf(av[i], bv[j], part[i * 4 + j]);
      }
    }
  };

  float4 acc[NQ];
#pragma unroll
  for (int j = 0; j < NQ; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);

  dot();
  for (int s = 0; s < steps; ++s) {
    const int b = s & 1;
    // the warp's partial tile
    float* w = wpart + kg * PART;
    if constexpr (kMma) {
      const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = mi * 16 + gid + 8 * h;
            const int n = tp * kWarpN + ni * 8 + 2 * tig;
            const float* f = part + (mi * 2 + ni) * 4 + 2 * h;
            *reinterpret_cast<float2*>(w + m * PS + n) = make_float2(f[0], f[1]);
          }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<float4*>(w + ((lane >> 2) * 4 + i) * PS +
                                   tp * kWarpN + (lane & 3) * 4) =
            make_float4(part[i * 4], part[i * 4 + 1], part[i * 4 + 2],
                        part[i * 4 + 3]);
    }
    // Every partial tile is written; and every read of the slots for step
    // s - 1 is done, so the sends below (releases) order them before any
    // rank can receive step s + 1 into the same slots.
    __syncthreads();
    // the K groups summed in group order, each quad sent to its owner's
    // slot b, in the row of this rank
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const int q = tid + j * kThreads;
      if (q < QUADS) {
        const int off = (q * 4 / TN) * PS + q * 4 % TN;
        float4 t = *reinterpret_cast<const float4*>(wpart + off);
#pragma unroll
        for (int k = 1; k < KW; ++k)
          add4(t, *reinterpret_cast<const float4*>(wpart + k * PART + off));
        const int o = q / share;
        const unsigned dst = vct::ptx::smem_addr(
            recv + (b * C + rank) * share + (q - o * share));
        send4(map_rank(dst, o), t, map_rank(full + 8 * b, o));
      }
    }
    __syncthreads();  // the partial tiles are free for the next step
    if (s + 1 < steps) dot();  // the next step's products meanwhile
    // step s over the whole K: every rank's share of this rank's quads, in
    // rank order, added to the accumulator
    if (tid == 0) mbar_expect(full + 8 * b, (unsigned)(C * owned * 16));
    if (tid < owned) {
      mbar_wait(full + 8 * b, (unsigned)((s >> 1) & 1));
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        const int i = tid + j * kThreads;
        if (i < owned) {
          // the ranks' quads, kRanksAtOnce loads in flight, summed in order
          const float4* q = recv + b * C * share + i;
          float4 t = q[0];
          for (int r0 = 1; r0 < C; r0 += kRanksAtOnce) {
            float4 v[kRanksAtOnce];
#pragma unroll
            for (int u = 0; u < kRanksAtOnce; ++u)
              if (r0 + u < C) v[u] = q[(r0 + u) * share];
#pragma unroll
            for (int u = 0; u < kRanksAtOnce; ++u)
              if (r0 + u < C) add4(t, v[u]);
          }
          add4(acc[j], t);
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < NQ; ++j) {
    const int i = tid + j * kThreads;
    if (i < owned) {
      const int q = rank * share + i;
      const int m = m0 + q * 4 / TN, n = n0 + q * 4 % TN;
      const float v[4] = {acc[j].x, acc[j].y, acc[j].z, acc[j].w};
      if (m < mk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (n + e < nk) out[(long long)m * nk + n + e] = v[e];
    }
  }
  cluster_sync_all();  // no CTA leaves while a peer may still send to it
}

// The launch of one instantiation: `query` (non-null) receives the CTA's
// shared bytes and the clusters the occupancy API places at once, instead
// of a launch.
template <typename T, int NT>
cudaError_t run(const void* p, const void* g, float* out, int mk, int nk,
                int kk, int steps, int cluster, int kslice,
                cudaStream_t stream, long long* query) {
  const auto kernel = dot_probe_cluster_kernel<T, NT>;
  const Geometry geo = geometry(NT * kWarpN, kslice, (int)sizeof(T), cluster);
  if (geo.smem > vct::igemm::kMaxSmem) return cudaErrorInvalidValue;
  static bool ready = false;  // per instantiation
  if (!ready) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)vct::igemm::kMaxSmem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    ready = true;
  }
  const long long tiles_m = (mk + kTileM - 1) / kTileM;
  const long long tiles_n = (nk + NT * kWarpN - 1) / (NT * kWarpN);
  const long long blocks = tiles_m * tiles_n * cluster;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = geo.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // per instantiation: the last (cluster, bytes) above the portable size
  // that the occupancy API was asked about, and its answer
  static int asked_cluster = 0, asked_fit = 0;
  static size_t asked_smem = 0;
  if (query != nullptr ||
      (cluster > kPortableCluster &&
       (cluster != asked_cluster || geo.smem != asked_smem))) {
    int fit = 0;
    const cudaError_t e = cudaOccupancyMaxActiveClusters(&fit, kernel, &cfg);
    if (e != cudaSuccess) return e;
    if (query != nullptr) {
      query[0] = (long long)geo.smem;
      query[1] = fit;
      return cudaSuccess;
    }
    asked_cluster = cluster;
    asked_smem = geo.smem;
    asked_fit = fit;
  }
  if (cluster > kPortableCluster && asked_fit < 1)
    return cudaErrorInvalidConfiguration;  // refused: no cluster fits
  const int pairs = kk % 2 == 0 && reinterpret_cast<uintptr_t>(p) % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(g) % 4 == 0;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(p), static_cast<const T*>(g), out,
      mk, nk, kk, steps, (int)tiles_n, kslice, pairs);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* p, const void* g, float* out, int mk, int nk,
                     int kk, int steps, int tn, int cluster, int kslice,
                     cudaStream_t stream, long long* query) {
  switch (tn) {
    case 16:
      return run<T, 1>(p, g, out, mk, nk, kk, steps, cluster, kslice, stream,
                       query);
    case 32:
      return run<T, 2>(p, g, out, mk, nk, kk, steps, cluster, kslice, stream,
                       query);
    case 64:
      return run<T, 4>(p, g, out, mk, nk, kk, steps, cluster, kslice, stream,
                       query);
    default:
      return cudaErrorInvalidValue;
  }
}

// The plan's checks: a tile width the kernel has, a cluster of 1-16 whose
// K slices (multiples of 16) cover kk and are all nonempty, and whose every
// rank owns quads of the tile (the owners' waits order the slots' reuse).
bool plan_ok(int kk, int tn, int cluster, int kslice) {
  if (!(tn == 16 || tn == 32 || tn == 64) || cluster < 1 ||
      cluster > kMaxCluster || kslice <= 0 || kslice % 16 != 0)
    return false;
  const int quads = kTileM * tn / 4, share = (quads + cluster - 1) / cluster;
  return (long long)kslice * cluster >= kk &&
         (long long)kslice * (cluster - 1) < kk &&
         share * (cluster - 1) < quads;
}

cudaError_t entry(const void* p, const void* g, void* out, int mk, int nk,
                  int kk, int steps, int dtype, int tn, int cluster,
                  int kslice, void* stream, long long* query) {
  if (mk <= 0 || nk <= 0 || kk <= 0 || steps <= 0 ||
      !plan_ok(kk, tn, cluster, kslice))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (dtype == vct::kFloat32)
    return dispatch<float>(p, g, o, mk, nk, kk, steps, tn, cluster, kslice, s,
                           query);
  if (dtype == vct::kBFloat16)
    return dispatch<__nv_bfloat16>(p, g, o, mk, nk, kk, steps, tn, cluster,
                                   kslice, s, query);
  return cudaErrorInvalidValue;
}

}  // namespace

// p: contiguous (mk, kk); g: contiguous (nk, kk) of the same type; out:
// contiguous float32 (mk, nk). dtype: vct::kFloat32 or vct::kBFloat16. The
// launch plan (experiments/dw_dot_probe.py::plan): tile width tn (16, 32 or
// 64), cluster size, K slice per rank. Returns the cudaError_t of the launch
// (0 = success); an invalid plan, one whose shared memory exceeds 227 KB,
// or a cluster above 8 that the occupancy API cannot place is refused.
extern "C" int vct_dot_probe(const void* p, const void* g, void* out, int mk,
                             int nk, int kk, int steps, int dtype, int tn,
                             int cluster, int kslice, void* stream) {
  return (int)entry(p, g, out, mk, nk, kk, steps, dtype, tn, cluster, kslice,
                    stream, nullptr);
}

// The plan's footprint on this card: out[0] the CTA's shared bytes, out[1]
// the clusters the occupancy API places at once (cudaOccupancyMaxActiveClusters).
extern "C" int vct_dot_probe_query(int kk, int dtype, int tn, int cluster,
                                   int kslice, long long* out) {
  return (int)entry(nullptr, nullptr, nullptr, kTileM, tn, kk, 1, dtype, tn,
                    cluster, kslice, nullptr, out);
}
