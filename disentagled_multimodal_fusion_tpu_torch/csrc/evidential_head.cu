// Evidential-head forward for V stacked heads in one launch, f32 throughout;
// at the end of the file its bf16 compute mode (--dtype bfloat16).
//
//   out[b, v, :] = evidence(relu(x[v, b, :] W1[v] + b1[v]) W2[v] + b2[v])
//   evidence(z)  = exp(z' + ln 1e13 - logaddexp(z', ln 1e13)),  z' = clip(z, -10, 10)
//
// Replaces the Pallas TPU kernel evidential_head_fused / evidential_heads_stacked
// (disentagled_multimodal_fusion_tpu/ops/pallas_kernels.py:53-105).
//
// Bound on an H100 (SXM, 700 W; 67 TFLOP/s f32 outside the tensor cores,
// 3.35 TB/s): at V=7, D=200, H=128, C=10 the work is 2 V B (D H + H C) flops,
// 1.438 us at B=256 and 2.247 us at B=400 (validation on HandWritten's test
// split, most of the launches), against 2-3 MB of traffic: bound by
// operations. At B <= 8 the weights (0.75 MB) make it bound by bytes
// (~0.23 us). No tensor cores: the port holds f32 with TF32 off, and Hopper's
// tensor cores reach TF32 at best (3xTF32 on wgmma, split operands, is a
// question for later).
//
// Design. Grid (n, row tiles of BM, V) of 256-thread blocks, one per SM,
// launched as thread-block clusters of n = 2 blocks along x when H > 64
// (else 1). Rank q of a cluster owns the 64-unit H tiles q, q + n, ...: it
// holds only those columns of W1, so each W1 byte it fetches feeds BM rows
// (32, or 64 where 32 would need more blocks than the card has SMs, as at
// B = 400, and 64 rows fit the shared memory: not at C = 42, LUMA's), and
// small batches spread W1 over 2V SMs. Rank 1 sends its share
// of z to rank 0 by distributed shared memory.
//
// Copies. Each H tile's W1 [kc x 64] and x [BM x kc] come in K-chunks of at
// most 128 columns (evened out: 2 x 100 at D = 200) through a ring of up to
// four stages with a "full" and an "empty" mbarrier each; at every main-path
// width all of a tile's chunks fit the ring, so thread 0 issues them (one TMA
// tensor copy of W1 and one of x per chunk) before the block first meets,
// with the tile's W2 rows and b1 as two bulk copies. Out-of-bounds rows and
// columns land as zeros, so the B, D and H tails need no masking. Longer
// runs refill a stage once every warp has freed it. Where a tensor map is
// not legal for an array (H, or x's strides, not multiples of 4 floats;
// unaligned bases: Scene's D = 59, odd test widths) every thread issues
// 4-byte cp.async copies of it into the same zero-padded layout, counted on
// the same full barrier: a second path inside the kernel with the same
// arithmetic, so both give bitwise-equal results. On the card a copy or a
// load issued while the warps multiply queues behind their shared-memory
// reads for thousands of cycles, so the copies go out first.
//
// Products. 8 warps: RG = BM / 32 row groups of 32 rows x 8 / RG slices of K
// (every (8 / RG)-th group of 4 columns of the tile's run). A lane keeps an
// 8 row x 8 unit register tile, 64 FMAs for every 4 float4 it reads from
// shared memory (its 8 lanes of a quarter warp share rows, so x is one
// broadcast); its shared-memory reads take about half the time of its
// FMAs, and it reaches about half of the f32 peak. The K slices' sums meet
// in shared memory and are added in slice order; b1 and ReLU are applied in
// registers, so relu(h) never leaves the chip. Then warp w takes units
// 8 w + [0, 8) of every row,
// one row per lane, so each W2 value it reads is one broadcast, and the 8
// warps' shares of z are added in warp order. Rank 1 sends its z straight
// into rank 0's shared memory (st.async, counted on an mbarrier of rank 0,
// no cluster barrier at the end); rank 0 adds the two in rank order and
// finishes every row with b2 and the evidence epilogue.
//
// No float atomics: every sum has one fixed order, so strided and
// contiguous x give the same bits. Any D, H and C that fit the shared memory
// a block may take (else the C entry point returns cudaErrorInvalidValue);
// the kernel attributes are set once per variant. x is read through its row
// and view strides, so the probe's (B, V, D) stack needs no transpose copy.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstring>

namespace cg = cooperative_groups;

namespace {

constexpr int WARP = 32;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * WARP;
constexpr int HT = 64;       // hidden units per H tile (8 lanes x 8)
constexpr int MAX_KC = 128;  // K columns per chunk at most
constexpr int MAX_STAGES = 4;
constexpr int MAX_CLUSTER = 2;
constexpr int PS = HT + 4;             // row stride of the partial sums
constexpr int PART = WARPS * 32 * PS;  // the K slices' partial sums, any RG

__device__ __forceinline__ float evidence(float z) {
  const float kLog1e13 = 29.933606208922594f;  // 13 * ln(10)
  z = fminf(fmaxf(z, -10.0f), 10.0f);
  // logaddexp(z, L) = max + log1p(exp(-|z - L|)), as torch and XLA compute it
  const float lse = fmaxf(z, kLog1e13) + log1pf(expf(-fabsf(z - kLog1e13)));
  return expf((z + kLog1e13) - lse);
}

// ---- barriers and asynchronous copies, global -> shared ----
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// an arrival that also makes the phase wait for `bytes` more (the TMA's)
__device__ __forceinline__ void mbar_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// an arrival once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void mbar_arrive_cp_async(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned phase) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(phase)
      : "memory");
}
// a 3-d box of the tensor map `map` at coordinates (c0, c1, c2), innermost
// first, counted on `bar` as it lands (the TMA engine)
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_u32(bar))
      : "memory");
}
// `bytes` (a multiple of 16, both addresses 16-byte aligned) in one bulk
// copy, counted on `bar` as they land
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// 4 bytes; bytes = 0 writes a zero (the path where tensor maps are not legal)
__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}

// `value` into the shared memory of cluster rank `rank` at the address that
// `local` has here, counted on that rank's mbarrier at `bar`'s address
__device__ __forceinline__ void st_async_remote(float* local, float value, int rank,
                                                unsigned long long* bar) {
  unsigned dst, rbar;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(dst) : "r"(smem_u32(local)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(rbar) : "r"(smem_u32(bar)), "r"(rank));
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n" ::"r"(dst),
               "r"(__float_as_uint(value)), "r"(rbar)
               : "memory");
}

// Shared memory in floats: the ring [stages][W1 kc x HT, then x BM x kc],
// the K slices' partial sums [8 / RG][BM][PS] (after them, the warps' shares
// of z [8][C][BM] where they fit, else their own room at the end), W2's rows
// of the tile [HT][C], b1 of the tile [HT], b2 of the view [C], the block's
// z [BM][C], rank 1's z [BM][C] (rank 0 only).
__host__ __device__ constexpr int stage_floats(int bm, int kc) { return kc * HT + bm * kc; }
__host__ __device__ inline size_t zw_floats(int bm, int C) {
  const size_t zw = static_cast<size_t>(WARPS) * C * bm;
  return zw > PART ? zw : 0;
}
__host__ __device__ inline size_t smem_floats(int bm, int kc, int stages, int C) {
  return static_cast<size_t>(stages) * stage_floats(bm, kc) + PART + static_cast<size_t>(HT) * C +
         HT + C + 2 * static_cast<size_t>(bm) * C + zw_floats(bm, C);
}

// RG row groups of 32 rows; 8 / RG slices of K
template <int RG>
__global__ void __launch_bounds__(THREADS, 1)
evidential_heads_kernel(const __grid_constant__ CUtensorMap map_x,
                        const __grid_constant__ CUtensorMap map_w1, int tma_x, int tma_w1,
                        int x_view_inner, const float* __restrict__ x, long long sxv,
                        long long sxb, const float* __restrict__ w1,
                        const float* __restrict__ b1, const float* __restrict__ w2,
                        const float* __restrict__ b2, float* __restrict__ out, int V, int B,
                        int D, int H, int C, int kc, int stages, int bulk_params) {
  constexpr int BM = 32 * RG;
  constexpr int KS = WARPS / RG;  // K slices
  const int STAGE = stage_floats(BM, kc);
  static_assert(BM * PS * KS == PART, "the partial sums' room");

  extern __shared__ __align__(128) float smem[];
  // a stage has landed; every warp is done with a stage; the tile's W2 rows
  // and b1 have landed; rank 1's z has landed in zin
  __shared__ __align__(8) unsigned long long full[MAX_STAGES], empty[MAX_STAGES], pready, zbar;
  float* ring = smem;
  float* part = ring + stages * STAGE;
  float* w2s = part + PART;
  float* b1s = w2s + HT * C;
  float* b2s = b1s + HT;
  float* zs = b2s + C;
  float* zin = zs + BM * C;
  float* zw = zw_floats(BM, C) ? zin + BM * C : part;

  cg::cluster_group cluster = cg::this_cluster();
  const int n = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int t = threadIdx.x;
  const int warp = t / WARP, lane = t % WARP;
  const int v = blockIdx.z;
  const int b0 = blockIdx.y * BM;
  const int rows = min(BM, B - b0);
  const int nk = (D + kc - 1) / kc;
  const int ntiles = (H + HT - 1) / HT;

  // The block's run of chunks: chunk jj is chunk jj % nk of the rank's
  // (jj / nk)-th H tile, in stage jj % stages
  const int total = (ntiles - rank + n - 1) / n * nk;
  // every thread's 4-byte copies, where TMA may not take an array
  const int cp_threads = tma_w1 && tma_x ? 0 : THREADS;
  const unsigned tma_bytes = 4u * ((tma_w1 ? kc * HT : 0) + (tma_x ? BM * kc : 0));
  const float* w1v = w1 + static_cast<long long>(v) * D * H;
  const float* w2v = w2 + static_cast<long long>(v) * H * C;
  const float* xv = x + v * sxv + static_cast<long long>(b0) * sxb;

  // chunk jj's TMA copies (or a plain arrival), by thread 0
  auto fill = [&](int jj) {
    const int stage = jj % stages, h0 = (rank + jj / nk * n) * HT, k0 = jj % nk * kc;
    float* w1d = ring + stage * STAGE;
    float* xd = w1d + kc * HT;
    if (tma_bytes) {
      mbar_expect(&full[stage], tma_bytes);
      if (tma_w1) tma_load_3d(w1d, &map_w1, h0, k0, v, &full[stage]);
      if (tma_x) {
        if (x_view_inner)
          tma_load_3d(xd, &map_x, k0, v, b0, &full[stage]);
        else
          tma_load_3d(xd, &map_x, k0, b0, v, &full[stage]);
      }
    } else {
      mbar_arrive(&full[stage]);
    }
  };
  // a thread's share of chunk jj's 4-byte copies into the same zero-padded
  // layout, counted on the stage's full barrier as they land
  auto copy_share = [&](int jj) {
    const int stage = jj % stages, h0 = (rank + jj / nk * n) * HT, k0 = jj % nk * kc;
    float* w1d = ring + stage * STAGE;
    float* xd = w1d + kc * HT;
    if (!tma_w1) {
      for (int i = t; i < kc * HT; i += THREADS) {
        const int kk = i / HT, u = i % HT;
        const bool ok = k0 + kk < D && h0 + u < H;
        cp_async4(w1d + i, ok ? w1v + static_cast<long long>(k0 + kk) * H + h0 + u : w1,
                  ok ? 4 : 0);
      }
    }
    if (!tma_x) {
      for (int i = t; i < BM * kc; i += THREADS) {
        const int r = i / kc, kk = i - r * kc;
        const bool ok = r < rows && k0 + kk < D;
        cp_async4(xd + i, ok ? xv + r * sxb + k0 + kk : x, ok ? 4 : 0);
      }
    }
    mbar_arrive_cp_async(&full[stage]);
  };
  // the rank's k-th tile's W2 rows and b1 into w2s and b1s (which lie in a
  // row): one bulk copy each where that is legal, by thread 0; else a plain
  // arrival, and every thread loads its share after the K loop
  auto bulk_tile = [&](int k) { return bulk_params && (rank + k * n) * HT + HT <= H; };
  auto issue_params = [&](int k) {
    const int h0 = (rank + k * n) * HT;
    if (bulk_tile(k)) {
      mbar_expect(&pready, 4u * (HT * C + HT));
      bulk_load(w2s, w2v + static_cast<long long>(h0) * C, 4u * HT * C, &pready);
      bulk_load(b1s, b1 + static_cast<long long>(v) * H + h0, 4u * HT, &pready);
    } else {
      mbar_arrive(&pready);
    }
  };

  if (t == 0) {
    // the barriers, and the first chunks' copies and the first tile's
    // parameters before the block meets, while nothing else is asking for
    // shared memory
    for (int s = 0; s < MAX_STAGES; ++s) {
      mbar_init(&full[s], 1 + cp_threads);
      mbar_init(&empty[s], WARPS);
    }
    mbar_init(&pready, 1);
    mbar_init(&zbar, 1);
    if (n > 1 && rank == 0) mbar_expect(&zbar, 4u * rows * C);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (tma_w1)
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<unsigned long long>(&map_w1))
                   : "memory");
    if (tma_x)
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<unsigned long long>(&map_x))
                   : "memory");
    for (int jj = 0; jj < min(stages, total); ++jj) fill(jj);
    issue_params(0);
  }
  __syncwarp();
  // the cluster's blocks have started (and rank 0's zbar expects rank 1's z)
  // before rank 1 writes into rank 0
  if (n > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  __syncthreads();  // the barriers are initialised
  // every block of the cluster has started (rank 1 writes into rank 0 at the
  // end); waited for here, while the first chunk lands
  if (n > 1) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");

  // the lane's register tile: rows rg 32 + rl 8 + [0, 8), units 4 ul + [0, 4)
  // and 32 + 4 ul + [0, 4)
  const int rg = warp % RG, ks = warp / RG;
  const int ul = lane % 8, rl = lane / 8;
  const bool active = rg * 32 < rows;  // warp-uniform: the group holds a row of B
  const float b2v = t < C ? b2[static_cast<long long>(v) * C + t] : 0.0f;  // stored after the loop
  if (cp_threads)
    for (int jj = 0; jj < min(stages, total); ++jj) copy_share(jj);

  int j = 0;
  for (int tile = rank, k = 0; tile < ntiles; tile += n, ++k) {
    const int h0 = tile * HT;
    if (k > 0) {
      __syncthreads();  // the previous tile's z is done with part, w2s and b1s
      if (t == 0) issue_params(k);
    }

    float acc[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[r][q] = 0.0f;

    for (int c = 0; c < nk; ++c, ++j) {
      const int stage = j % stages;
      mbar_wait(&full[stage], static_cast<unsigned>((j / stages) & 1));
      if (active) {
        // the chunk's columns that hold D, in groups of 4; slice ks takes
        // every KS-th group of the tile's run (columns past D within the
        // last group are zero)
        const int ngroups = (min(kc, D - c * kc) + 3) / 4;
        const float* wp = ring + stage * STAGE + 4 * ul;
        const float* xp = ring + stage * STAGE + kc * HT + (rg * 32 + rl * 8) * kc;
#pragma unroll 2
        for (int gi = ((ks - c * (kc / 4)) % KS + KS) % KS; gi < ngroups; gi += KS) {
          const int kk = 4 * gi;
          float4 xk[8];
#pragma unroll
          for (int r = 0; r < 8; ++r) xk[r] = *reinterpret_cast<const float4*>(xp + r * kc + kk);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float4 wa = *reinterpret_cast<const float4*>(wp + (kk + u) * HT);
            const float4 wb = *reinterpret_cast<const float4*>(wp + (kk + u) * HT + 32);
#pragma unroll
            for (int r = 0; r < 8; ++r) {
              const float xr = u == 0 ? xk[r].x : u == 1 ? xk[r].y : u == 2 ? xk[r].z : xk[r].w;
              acc[r][0] = fmaf(xr, wa.x, acc[r][0]);
              acc[r][1] = fmaf(xr, wa.y, acc[r][1]);
              acc[r][2] = fmaf(xr, wa.z, acc[r][2]);
              acc[r][3] = fmaf(xr, wa.w, acc[r][3]);
              acc[r][4] = fmaf(xr, wb.x, acc[r][4]);
              acc[r][5] = fmaf(xr, wb.y, acc[r][5]);
              acc[r][6] = fmaf(xr, wb.z, acc[r][6]);
              acc[r][7] = fmaf(xr, wb.w, acc[r][7]);
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);  // this warp is done with the stage
      if (j + stages < total) {
        // a run longer than the ring: once every warp is done with the
        // stage, thread 0 refills it by TMA and every thread its 4-byte part
        if (t == 0 || cp_threads) mbar_wait(&empty[stage], static_cast<unsigned>((j / stages) & 1));
        if (t == 0) fill(j + stages);
        if (cp_threads) copy_share(j + stages);
      }
    }

    if (k == 0) {
      if (t < C) b2s[t] = b2v;
      for (int i = t + THREADS; i < C; i += THREADS) b2s[i] = b2[static_cast<long long>(v) * C + i];
    }
    if (!bulk_tile(k)) {
      const int nparam = HT * C + HT;
      for (int i = t; i < nparam; i += THREADS) {
        float val = 0.0f;
        if (i < HT * C) {
          if (h0 + i / C < H) val = w2v[static_cast<long long>(h0) * C + i];
        } else if (h0 + i - HT * C < H) {
          val = b1[static_cast<long long>(v) * H + h0 + i - HT * C];
        }
        w2s[i] = val;
      }
    }
    // the K slices' sums
    float* pp = part + (ks * BM + rg * 32 + rl * 8) * PS + 4 * ul;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      *reinterpret_cast<float4*>(pp + r * PS) = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      *reinterpret_cast<float4*>(pp + r * PS + 32) =
          make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
    }
    __syncthreads();
    mbar_wait(&pready, static_cast<unsigned>(k & 1));

    // h = relu(sum of the slices in slice order + b1), kept in registers:
    // warp w takes units 8 w + [0, 8) of every row, one row per lane
    float h[RG][8];
#pragma unroll
    for (int p = 0; p < RG; ++p) {
      const float* pr = part + (p * 32 + lane) * PS + 8 * warp;
      float4 a = *reinterpret_cast<const float4*>(pr);
      float4 b = *reinterpret_cast<const float4*>(pr + 4);
#pragma unroll
      for (int sl = 1; sl < KS; ++sl) {
        const float4 a2 = *reinterpret_cast<const float4*>(pr + sl * BM * PS);
        const float4 b2p = *reinterpret_cast<const float4*>(pr + sl * BM * PS + 4);
        a = make_float4(a.x + a2.x, a.y + a2.y, a.z + a2.z, a.w + a2.w);
        b = make_float4(b.x + b2p.x, b.y + b2p.y, b.z + b2p.z, b.w + b2p.w);
      }
      const float* bb = b1s + 8 * warp;
      h[p][0] = fmaxf(a.x + bb[0], 0.0f);
      h[p][1] = fmaxf(a.y + bb[1], 0.0f);
      h[p][2] = fmaxf(a.z + bb[2], 0.0f);
      h[p][3] = fmaxf(a.w + bb[3], 0.0f);
      h[p][4] = fmaxf(b.x + bb[4], 0.0f);
      h[p][5] = fmaxf(b.y + bb[5], 0.0f);
      h[p][6] = fmaxf(b.z + bb[6], 0.0f);
      h[p][7] = fmaxf(b.w + bb[7], 0.0f);
    }
    __syncthreads();  // the partial sums are read: zw may lie over them
    // the warp's share of z, relu(h) W2[its 8 units], W2's values the same
    // for every lane (one broadcast each), into zw [warp][class][row]
    const float* w2w = w2s + 8 * warp * C;
#pragma unroll 4
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int p = 0; p < RG; ++p) {
        float z = 0.0f;
#pragma unroll
        for (int i = 0; i < 8; ++i) z = fmaf(h[p][i], w2w[i * C + c], z);
        zw[(warp * C + c) * BM + p * 32 + lane] = z;
      }
    }
    __syncthreads();
    // the 8 warps' shares added in warp order, then the earlier tiles' z,
    // into the block's z; after the last tile rank 1 sends its z straight
    // into rank 0's zin (asynchronous stores counted on rank 0's zbar)
    const bool send = tile + n >= ntiles && rank == 1;
#pragma unroll 2
    for (int i = t; i < C * BM; i += THREADS) {
      const int c = i / BM, r = i % BM;
      float z = zw[c * BM + r];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) z += zw[(w * C + c) * BM + r];
      if (r >= rows) continue;
      if (k > 0) z += zs[r * C + c];
      if (send)
        st_async_remote(zin + r * C + c, z, 0, &zbar);
      else
        zs[r * C + c] = z;
    }
  }
  if (rank == 1) return;

  // rank 0 adds rank 1's z in rank order and finishes every row with b2 and
  // the evidence epilogue
  if (n > 1) mbar_wait(&zbar, 0);
  __syncthreads();  // the block's z is complete
#pragma unroll 2
  for (int o = t; o < rows * C; o += THREADS) {
    const int r = o / C, c = o - r * C;
    float z = zs[o];
    if (n > 1) z += zin[o];
    out[(static_cast<long long>(b0 + r) * V + v) * C + c] = evidence(z + b2s[c]);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return (e == cudaSuccess && q == cudaDriverEntryPointSuccess) ? reinterpret_cast<EncodeTiled>(p)
                                                                  : nullptr;
  }();
  return fn;
}

// a 3-d f32 tensor map: dims innermost first, strides (in floats) of dims 1
// and 2; false where TMA may not take the array (16-byte aligned base and
// strides are needed)
bool encode(CUtensorMap* map, const void* base, const cuuint64_t dims[3], long long s1,
            long long s2, const cuuint32_t box[3]) {
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr || (reinterpret_cast<unsigned long long>(base) & 15) != 0 || s1 % 4 != 0 ||
      s2 % 4 != 0 || s1 <= 0 || s2 <= 0)
    return false;
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(s1) * 4, static_cast<cuuint64_t>(s2) * 4};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(base), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the device's SM count and, once per kernel variant, its dynamic shared
// memory raised to all the block may take beside the static part
struct Device {
  int smem_optin = 0;
  int sms = 0;
  cudaError_t err = cudaSuccess;
};

const Device& device() {
  static const Device d = [] {
    Device r;
    int dev = 0;
    r.err = cudaGetDevice(&dev);
    if (r.err == cudaSuccess)
      r.err = cudaDeviceGetAttribute(&r.smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (r.err == cudaSuccess)
      r.err = cudaDeviceGetAttribute(&r.sms, cudaDevAttrMultiProcessorCount, dev);
    return r;
  }();
  return d;
}

struct Variant {
  size_t max_dynamic = 0;
  cudaError_t err = cudaSuccess;
};

template <int RG>
const Variant& variant() {
  static const Variant var = [] {
    Variant r;
    cudaFuncAttributes attr;
    r.err = device().err;
    if (r.err == cudaSuccess) r.err = cudaFuncGetAttributes(&attr, evidential_heads_kernel<RG>);
    if (r.err == cudaSuccess) {
      r.max_dynamic = static_cast<size_t>(device().smem_optin) - attr.sharedSizeBytes;
      r.err = cudaFuncSetAttribute(evidential_heads_kernel<RG>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(r.max_dynamic));
    }
    return r;
  }();
  return var;
}

// A launch's K-chunk width, stages and dynamic shared memory (bytes) for
// variant RG at (D, C): K-chunks of at most MAX_KC columns, evened out to a
// multiple of 4; as many stages as there are chunks, up to MAX_STAGES and
// what fits. The bytes exceed the variant's room where even one stage does
// not fit.
struct Plan {
  int kc = 0;
  int stages = 0;
  size_t smem = 0;
};

template <int RG>
Plan plan(int D, int C) {
  constexpr int BM = 32 * RG;
  const size_t room = variant<RG>().max_dynamic;
  Plan p;
  const int nk0 = (D + MAX_KC - 1) / MAX_KC;
  p.kc = ((D + nk0 - 1) / nk0 + 3) / 4 * 4;
  const int nk = (D + p.kc - 1) / p.kc;
  p.stages = nk < MAX_STAGES ? nk : MAX_STAGES;
  while (p.stages > 1 && sizeof(float) * smem_floats(BM, p.kc, p.stages, C) > room) --p.stages;
  p.smem = sizeof(float) * smem_floats(BM, p.kc, p.stages, C);
  return p;
}

template <int RG>
cudaError_t launch(const float* x, long long sxv, long long sxb, const float* w1, const float* b1,
                   const float* w2, const float* b2, float* out, int V, int B, int D, int H,
                   int C, cudaStream_t stream, int n) {
  constexpr int BM = 32 * RG;
  const Variant& var = variant<RG>();
  if (var.err != cudaSuccess) return var.err;
  const Plan pl = plan<RG>(D, C);
  const int kc = pl.kc, stages = pl.stages;
  const size_t smem = pl.smem;
  const int tiles = (B + BM - 1) / BM;
  if (smem > var.max_dynamic || tiles > 65535 || V > 65535) return cudaErrorInvalidValue;

  // a tensor map for each array that TMA may take; the other comes through
  // 4-byte cp.async
  CUtensorMap map_x, map_w1;
  memset(&map_x, 0, sizeof(map_x));
  memset(&map_w1, 0, sizeof(map_w1));
  const cuuint64_t dw[3] = {static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(D),
                            static_cast<cuuint64_t>(V)};
  const cuuint32_t bw[3] = {HT, static_cast<cuuint32_t>(kc), 1};
  const bool tma_w1 = encode(&map_w1, w1, dw, H, static_cast<long long>(D) * H, bw);
  const long long sxv_eff = V == 1 ? sxb * B : sxv;
  const int x_view_inner = sxv_eff < sxb ? 1 : 0;
  const cuuint64_t dv[3] = {static_cast<cuuint64_t>(D),
                            static_cast<cuuint64_t>(x_view_inner ? V : B),
                            static_cast<cuuint64_t>(x_view_inner ? B : V)};
  const cuuint32_t bv[3] = {static_cast<cuuint32_t>(kc), x_view_inner ? 1u : static_cast<cuuint32_t>(BM),
                            x_view_inner ? static_cast<cuuint32_t>(BM) : 1u};
  const bool tma_x = x_view_inner ? encode(&map_x, x, dv, sxv_eff, sxb, bv)
                                  : encode(&map_x, x, dv, sxb, sxv_eff, bv);

  // W2's rows and b1 by bulk copy: 16-byte aligned bases and tile offsets
  const auto addr = [](const void* p) { return reinterpret_cast<unsigned long long>(p); };
  const int bulk_params = ((addr(w2) | addr(b1)) & 15) == 0 && H % 4 == 0;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n, tiles, V);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, evidential_heads_kernel<RG>, map_x, map_w1,
                            static_cast<int>(tma_x), static_cast<int>(tma_w1), x_view_inner, x,
                            sxv, sxb, w1, b1, w2, b2, out, V, B, D, H, C, kc, stages,
                            bulk_params);
}

// ---- the bf16 compute mode: --dtype bfloat16's heads ----
//
// What JAX's StackedMLP(dtype=bf16) and the f32 evidence compute, with its
// roundings: every operand rounded to bf16, each product summed in f32 and
// rounded to bf16 once, the bias added in bf16 (a second rounding), ReLU,
// the same for the second layer, and the evidence in f32:
//
//   h = relu(bf16(bf16(x W1) + bf16(b1))),  z = bf16(bf16(h W2) + bf16(b2)),
//   out = evidence(float(z))
//
// Weights and biases come in f32 (the parameters stay f32), x in f32 too
// (the wrapper widens a bf16 x first, exactly); all are rounded here.
//
// Bound on an H100 (SXM, 700 W; 989 TFLOP/s bf16 on the tensor cores, 3.35
// TB/s): bytes at every main-path shape. x in f32 is most of them: 67 MB,
// 20 us of the 25 us bound at the largest, (20, 4200, 200); the products
// at the tensor-core peak take a fifth of that.
//
// Design. Tensor cores, a ring of TMA copies fed by a warp of its own,
// weights read once per block (PERF.md):
// - Products: bf16 mma.sync.m16n8k16 with f32 sums, both layers. A bf16 x
//   bf16 product is exact in f32, so only the order of the f32 sum differs
//   from a sequential one (16-deep steps in k order; tests/
//   test_torch_bf16_order.py emulates it). Each layer's sum is rounded to
//   bf16 once, after its whole K loop; then the bias is added and rounded,
//   as flax does. mma.sync and not wgmma: blocks of 32 rows need it, wgmma
//   would want a bf16 copy of x in its shared-memory layout, and the
//   products are not the limit.
// - Copies: x and W1 come in f32, in K-chunks of 64 columns, through a ring
//   of three stages with a "full" and an "empty" mbarrier each. A 17th warp
//   only copies: lane 0 issues one TMA tensor copy per array and chunk as
//   soon as the 16 warps that multiply have freed the stage, so no warp
//   that multiplies waits while an issue holds its thread (per-thread
//   16-byte cp.async, this kernel's first form, stalled every thread on
//   each chunk). A box is wider than its chunk (x rows of 72, W1 rows of
//   132 floats), so rows land padded and the fragment reads are free of
//   bank conflicts; out-of-bounds rows and columns land as zeros. Where a
//   tensor map is not legal for an array (Scene's D = 59, odd test widths),
//   the copy warp's lanes copy it by 4-byte cp.async into the same layout,
//   counted on the same mbarrier: the same arithmetic, so the same bits.
// - Weights once per block: a block takes one head and a run of its row
//   tiles (bx, bx + G, ...; V G <= the SMs, so one wave). Where the head's
//   W1 fits beside the ring (H = 128 up to D = 256: 135 KB of f32) it stays
//   resident: it comes with the first tile's chunks, is rounded to bf16 in
//   place, and later tiles reuse it, so only x streams. Where it does not
//   (CUB's D = 1024, PIE's 484), W1's chunks stream through the ring beside
//   x's. W2 (transposed, bf16) and the rounded biases are set up once per
//   block while the first chunks land.
// - Operands: W1 is rounded to bf16 in place as its chunk lands and read
//   by ldmatrix.trans; x stays f32 and is rounded as its fragments are
//   built (two f32 -> one bf16x2), which needs no barrier, so the later
//   tiles of a resident W1 meet twice per tile: before h is written (the
//   row group's other warps may still read the last tile's h in layer 2)
//   and before layer 2.
// - Warps: 16 that multiply, WR row groups of 16 rows x 16 / WR column
//   groups of WR n-tiles of 8 hidden units: a tile of 16 WR rows and a pass
//   of 128 units (H > 128 takes more passes). relu(h) goes to shared memory
//   as bf16 (exact: h is bf16 anyway), never to device memory. Layer 2 runs
//   on the tensor cores over h (ldmatrix), C padded to a multiple of 8 with
//   the padded columns never stored; then b2 and the evidence in f32,
//   written once.
// - Small grids: row tiles of 32 (WR = 2) or 64 rows (WR = 4), whichever
//   leaves a block fewer rows: (3, 160) runs as 15 blocks of one 32-row
//   tile, (20, 4200) as 120 blocks of 11 tiles of 64.
// Every sum has one fixed order, so strided, bf16 and f32 x give the same
// bits. Any V, B, D, H and C whose plan fits a block's shared memory with
// W1 streamed (else the C entry point returns cudaErrorInvalidValue).
constexpr int BF_KC = 64;               // K columns per chunk
constexpr int BF_STAGES = 3;            // ring stages
constexpr int BF_PASS = 128;            // hidden units per pass
constexpr int BF_XS = BF_KC + 8;        // x's box and row stride in a stage (floats)
constexpr int BF_WS = BF_PASS + 4;      // W1's box and row stride as it lands (floats)
constexpr int BF_WB = BF_PASS + 8;      // W1's row stride once rounded to bf16 in place
constexpr int BF_WARPS = 16;                   // the warps that multiply
constexpr int BF_THREADS = BF_WARPS * WARP;
constexpr int BF_BLOCK = BF_THREADS + WARP;    // and one warp that issues the copies

__device__ __forceinline__ float bf16_round(float f) {
  return __bfloat162float(__float2bfloat16_rn(f));
}
// two f32 rounded into one bf16x2 register, lo in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&p);
}
__device__ __forceinline__ unsigned ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}
// d += a b over one 16 x 8 x 16 step: bf16 operands, f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7},"
      " {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// four 8 x 8 bf16 matrices, one row address per lane (lanes 8 i to 8 i + 7
// give matrix i's rows): the fragment of the row-major A operand, or with
// .trans that of a k-major B operand
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
// a barrier of the 16 warps that multiply (the copy warp keeps on copying)
__device__ __forceinline__ void bf16_warps_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(BF_THREADS) : "memory");
}
// The evidence of a bf16 logit: exp(z) 1e13 / (exp(z) + 1e13) of z clipped
// to +-10, computed as exp(z). The factor 1e13 / (exp(z) + 1e13) lies within
// 2.3e-9 of 1 for z <= 10, below half an f32 ulp, so exp(z) is the function
// to f32 rounding, without evidence()'s log1p and second exp.
__device__ __forceinline__ float evidence_clipped_exp(float z) {
  return expf(fminf(fmaxf(z, -10.0f), 10.0f));
}

// A launch's padded widths and shared-memory regions, the same on the host
// and in the kernel: W1 (resident: [passes][nk BF_KC][BF_WS]; streamed: a
// slot [BF_KC][BF_WS] per stage) and the x ring [stages][bm][BF_XS] (f32),
// h [bm][hs] and W2^T [cp][hs] (bf16), b1 and b2 (f32, rounded to bf16).
// Every TMA destination is 128-byte aligned.
struct Bf16Geom {
  int dp, hp, cp, hs, nk, passes;
  size_t w1, xr, hh, w2, b1;
  __host__ __device__ Bf16Geom(int bm, int D, int H, int C, bool resident)
      : dp((D + 15) / 16 * 16),
        hp((H + 15) / 16 * 16),
        cp((C + 7) / 8 * 8),
        hs((H + 63) / 64 * 64 + 8),
        nk((dp + BF_KC - 1) / BF_KC),
        passes((H + BF_PASS - 1) / BF_PASS),
        w1(static_cast<size_t>(resident ? passes * nk : BF_STAGES) * BF_KC * BF_WS),
        xr(static_cast<size_t>(BF_STAGES) * bm * BF_XS),
        hh(static_cast<size_t>(bm) * hs),
        w2(static_cast<size_t>(cp) * hs),
        b1((H + 3) / 4 * 4) {}
  __host__ __device__ size_t bytes() const { return 4 * (w1 + xr + b1 + cp) + 2 * (hh + w2); }
};

// WR row groups of 16 rows x 16 / WR column groups of WR n-tiles
template <int WR>
__global__ void __launch_bounds__(BF_BLOCK, 1)
    evidential_heads_bf16_kernel(const __grid_constant__ CUtensorMap map_x,
                                 const __grid_constant__ CUtensorMap map_w1, int tma_x,
                                 int tma_w1, int x_view_inner, const float* __restrict__ x,
                                 long long sxv, long long sxb, const float* __restrict__ w1,
                                 const float* __restrict__ b1, const float* __restrict__ w2,
                                 const float* __restrict__ b2, float* __restrict__ out, int V,
                                 int B, int D, int H, int C, int resident) {
  constexpr int BM = 16 * WR;
  constexpr int WC = BF_WARPS / WR;  // column groups
  constexpr int NT = WR;             // n-tiles of a warp
  static_assert(WC * NT * 8 == BF_PASS && NT % 2 == 0, "the warps' n-tiles make a pass");
  constexpr int WQ = BF_KC * BF_PASS / 4 / BF_THREADS;  // a chunk's W1, float4s per thread
  static_assert(WQ * 4 * BF_THREADS == BF_KC * BF_PASS, "whole float4s per thread");
  const Bf16Geom geo(BM, D, H, C, resident);
  const int nk = geo.nk, hs = geo.hs;
  extern __shared__ __align__(128) float bf_smem[];
  // a stage has landed; the 16 warps are done with a stage
  __shared__ __align__(8) unsigned long long full[BF_STAGES], empty[BF_STAGES];
  float* w1s = bf_smem;
  float* xs = w1s + geo.w1;
  __nv_bfloat16* hsm = reinterpret_cast<__nv_bfloat16*>(xs + geo.xr);
  __nv_bfloat16* w2t = hsm + geo.hh;
  float* b1r = reinterpret_cast<float*>(w2t + geo.w2);
  float* b2r = b1r + geo.b1;

  const int v = blockIdx.y, bx = blockIdx.x, G = gridDim.x;
  const int t = threadIdx.x, lane = t % WARP, warp = t / WARP;
  const int g = lane / 4, tq = lane % 4;     // the fragments' row and column in a quad
  const int wr = warp / WC, wc = warp % WC;  // the warp's row group and column group
  const int ntiles = (B + BM - 1) / BM;
  const int per_tile = geo.passes * nk;
  const int J = (ntiles - bx + G - 1) / G * per_tile;  // the block's items
  const bool cp_lanes = !(tma_x && tma_w1);            // 4-byte copies by the copy warp
  const float* xv = x + v * sxv;
  const float* w1v = w1 + static_cast<long long>(v) * D * H;

  // item j: chunk c of pass p of the block's m-th row tile, in stage j %
  // BF_STAGES: x's box, and W1's unless it is resident and already there.
  // Lane 0 of the copy warp issues the TMA copies; with a 4-byte array every
  // lane copies its share and arrives once its copies land.
  auto issue = [&](int j) {
    const int m = j / per_tile, p = j % per_tile / nk, c = j % nk;
    const int s = j % BF_STAGES;
    const int b0 = (bx + m * G) * BM, k0 = c * BF_KC, n0 = p * BF_PASS;
    const bool with_w1 = !resident || j < per_tile;
    float* xd = xs + s * BM * BF_XS;
    float* wd = w1s + static_cast<size_t>(resident ? p * nk + c : s) * BF_KC * BF_WS;
    if (lane == 0) {
      const unsigned bytes =
          4u * ((tma_x ? BM * BF_XS : 0) + (with_w1 && tma_w1 ? BF_KC * BF_WS : 0));
      if (bytes) {
        mbar_expect(&full[s], bytes);
        if (tma_x) {
          if (x_view_inner)
            tma_load_3d(xd, &map_x, k0, v, b0, &full[s]);
          else
            tma_load_3d(xd, &map_x, k0, b0, v, &full[s]);
        }
        if (with_w1 && tma_w1) tma_load_3d(wd, &map_w1, n0, k0, v, &full[s]);
      } else {
        mbar_arrive(&full[s]);
      }
    }
    if (!cp_lanes) return;
    if (!tma_x) {
      const int rows = min(BM, B - b0);
      const float* xsrc = xv + b0 * sxb + k0;
      for (int q = lane; q < BM * BF_XS; q += WARP) {
        const int r = q / BF_XS, kk = q % BF_XS;
        const bool ok = r < rows && k0 + kk < D;
        cp_async4(xd + q, ok ? xsrc + r * sxb + kk : x, ok ? 4 : 0);
      }
    }
    if (with_w1 && !tma_w1) {
      const float* wsrc = w1v + static_cast<long long>(k0) * H + n0;
      for (int q = lane; q < BF_KC * BF_WS; q += WARP) {
        const int kr = q / BF_WS, nn = q % BF_WS;
        const bool ok = k0 + kr < D && n0 + nn < H;
        cp_async4(wd + q, ok ? wsrc + static_cast<long long>(kr) * H + nn : w1, ok ? 4 : 0);
      }
    }
    mbar_arrive_cp_async(&full[s]);
  };

  if (t == 0) {
    for (int s = 0; s < BF_STAGES; ++s) {
      mbar_init(&full[s], 1 + (cp_lanes ? WARP : 0));
      mbar_init(&empty[s], BF_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (tma_x)
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<unsigned long long>(&map_x))
                   : "memory");
    if (tma_w1)
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<unsigned long long>(&map_w1))
                   : "memory");
  }
  __syncthreads();  // the barriers are initialised

  if (warp == BF_WARPS) {
    // the copy warp: every item as soon as its stage is free
    for (int j = 0; j < J; ++j) {
      if (j >= BF_STAGES)
        mbar_wait(&empty[j % BF_STAGES], static_cast<unsigned>((j / BF_STAGES - 1) & 1));
      issue(j);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // the 16 warps: while the first chunks land, W2 transposed to
  // [class][unit] in bf16 (read in its own order, coalesced; the first
  // W2R values per thread through registers, so their loads are in flight
  // together), zero where padded, and the rounded biases
  constexpr int W2R = 12;
  const float* w2v = w2 + static_cast<long long>(v) * H * C;
  float w2r[W2R];
#pragma unroll
  for (int i = 0; i < W2R; ++i) {
    const int e = t + i * BF_THREADS;
    w2r[i] = e < H * C ? w2v[e] : 0.0f;
  }
  const float b1t = t < H ? b1[static_cast<long long>(v) * H + t] : 0.0f;
  const float b2t = t < C ? b2[static_cast<long long>(v) * C + t] : 0.0f;
#pragma unroll
  for (int i = 0; i < W2R; ++i) {
    const int e = t + i * BF_THREADS;
    if (e < H * C) w2t[e % C * hs + e / C] = __float2bfloat16_rn(w2r[i]);
  }
  for (int e = t + W2R * BF_THREADS; e < H * C; e += BF_THREADS)
    w2t[e % C * hs + e / C] = __float2bfloat16_rn(w2v[e]);
  for (int i = t; i < geo.cp * geo.hp; i += BF_THREADS) {
    const int n = i / geo.hp, k = i % geo.hp;
    if (n >= C || k >= H) w2t[n * hs + k] = __float2bfloat16_rn(0.0f);
  }
  if (t < H) b1r[t] = bf16_round(b1t);
  for (int i = t + BF_THREADS; i < H; i += BF_THREADS)
    b1r[i] = bf16_round(b1[static_cast<long long>(v) * H + i]);
  if (t < geo.cp) b2r[t] = bf16_round(b2t);
  for (int i = t + BF_THREADS; i < geo.cp; i += BF_THREADS)
    b2r[i] = i < C ? bf16_round(b2[static_cast<long long>(v) * C + i]) : 0.0f;

  const int row0 = wr * 16;  // the warp's first row of a tile
  float acc[NT][4];
  for (int j = 0; j < J; ++j) {
    mbar_wait(&full[j % BF_STAGES], static_cast<unsigned>(j / BF_STAGES & 1));

    const int m = j / per_tile, p = j % per_tile / nk, c = j % nk;
    const int ksteps = min(BF_KC, geo.dp - c * BF_KC) / 16;
    const int n0 = p * BF_PASS + wc * NT * 8;  // the warp's first hidden unit
    if (c == 0) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
    }
    // layer 1 over the chunk. Its W1, where it came with the item (every item
    // when W1 streams, the first tile's when it is resident), is rounded to
    // bf16 in place first, [BF_KC][BF_WS] f32 -> [BF_KC][BF_WB] bf16: every
    // thread reads its f32 values, the 16 warps meet, then they land as
    // bf16 over them. x stays f32 in its stage and is rounded as the A
    // fragments are built, so the later tiles of a resident W1 run layer 1
    // with no barrier.
    const float* xst = xs + j % BF_STAGES * BM * BF_XS;
    float* slot = w1s + static_cast<size_t>(resident ? p * nk + c : j % BF_STAGES) * BF_KC * BF_WS;
    __nv_bfloat16* slotb = reinterpret_cast<__nv_bfloat16*>(slot);
    if (!resident || j < per_tile) {
      float4 f[WQ];
#pragma unroll
      for (int i = 0; i < WQ; ++i) {
        const int q = t + i * BF_THREADS;
        f[i] = *reinterpret_cast<const float4*>(slot + q / (BF_PASS / 4) * BF_WS +
                                                q % (BF_PASS / 4) * 4);
      }
      bf16_warps_sync();  // every f32 value is read before a bf16 one lands over it
#pragma unroll
      for (int i = 0; i < WQ; ++i) {
        const int q = t + i * BF_THREADS;
        *reinterpret_cast<uint2*>(slotb + q / (BF_PASS / 4) * BF_WB + q % (BF_PASS / 4) * 4) =
            make_uint2(pack_bf16(f[i].x, f[i].y), pack_bf16(f[i].z, f[i].w));
      }
      // these writes come before a later TMA copy into the slot
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bf16_warps_sync();  // the bf16 chunk is complete
    }
    // the chunk's 16-deep steps in k order: A from the f32 stage (two f32 ->
    // one bf16x2), B two n-tiles at a time by ldmatrix.trans (lane l gives
    // row l % 8 of matrix l / 8). The n-tiles past H multiply zeros (W1's
    // columns there land as zeros) and their h is never kept.
    const float* xa0 = xst + (row0 + g) * BF_XS + 2 * tq;
    const __nv_bfloat16* wb0 =
        slotb + (lane % 8 + lane / 8 % 2 * 8) * BF_WB + wc * NT * 8 + lane / 16 * 8;
    for (int ks = 0; ks < ksteps; ++ks) {
      const float* xa = xa0 + ks * 16;
      const float2 q0 = *reinterpret_cast<const float2*>(xa);
      const float2 q1 = *reinterpret_cast<const float2*>(xa + 8 * BF_XS);
      const float2 q2 = *reinterpret_cast<const float2*>(xa + 8);
      const float2 q3 = *reinterpret_cast<const float2*>(xa + 8 * BF_XS + 8);
      const unsigned a[4] = {pack_bf16(q0.x, q0.y), pack_bf16(q1.x, q1.y),
                             pack_bf16(q2.x, q2.y), pack_bf16(q3.x, q3.y)};
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        unsigned b[4];
        ldsm_x4_trans(b, wb0 + ks * 16 * BF_WB + nt * 8);
        mma_bf16(acc[nt], a, b[0], b[1]);
        mma_bf16(acc[nt + 1], a, b[2], b[3]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[j % BF_STAGES]);  // the warp is done with the stage
    if (c != nk - 1) continue;

    // a later tile of a resident W1 has met no barrier since the last
    // tile's: its h is free once every warp is past that tile's layer 2
    if (resident && m > 0 && p == 0) bf16_warps_sync();
    // the pass's h = relu(bf16(bf16(x W1) + b1)) into shared memory, zero
    // past H up to hp
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = n0 + nt * 8 + 2 * tq;
      if (n >= geo.hp) continue;
      const float c0 = n < H ? b1r[n] : 0.0f, c1 = n + 1 < H ? b1r[n + 1] : 0.0f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float e0 = acc[nt][2 * half], e1 = acc[nt][2 * half + 1];
        const float h0 = n < H ? fmaxf(bf16_round(bf16_round(e0) + c0), 0.0f) : 0.0f;
        const float h1 = n + 1 < H ? fmaxf(bf16_round(bf16_round(e1) + c1), 0.0f) : 0.0f;
        *reinterpret_cast<unsigned*>(hsm + (row0 + g + 8 * half) * hs + n) = pack_bf16(h0, h1);
      }
    }
    if (p != geo.passes - 1) continue;
    bf16_warps_sync();  // the tile's h is complete

    // layer 2 over the warp's 16 rows of h: column group wc takes n-tiles
    // wc, wc + WC, ... of the padded classes; then b2 and the evidence,
    // stored once
    const int b0 = (bx + m * G) * BM, rows = min(BM, B - b0);
    const __nv_bfloat16* ha = hsm + (row0 + lane % 8 + lane / 8 % 2 * 8) * hs + lane / 16 * 8;
    for (int nt = wc; nt < geo.cp / 8; nt += WC) {
      float z[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      const __nv_bfloat16* wb = w2t + (nt * 8 + g) * hs + 2 * tq;
#pragma unroll 4
      for (int ks = 0; ks < geo.hp / 16; ++ks) {
        unsigned a[4];
        ldsm_x4(a, ha + ks * 16);
        mma_bf16(z, a, ld_u32(wb + ks * 16), ld_u32(wb + ks * 16 + 8));
      }
      const int cc = nt * 8 + 2 * tq;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = row0 + g + 8 * half;
        if (r >= rows) continue;
        float* o = out + (static_cast<long long>(b0 + r) * V + v) * C + cc;
        if (cc < C) o[0] = evidence_clipped_exp(bf16_round(bf16_round(z[2 * half]) + b2r[cc]));
        if (cc + 1 < C)
          o[1] = evidence_clipped_exp(bf16_round(bf16_round(z[2 * half + 1]) + b2r[cc + 1]));
      }
    }
  }
}

// once per variant: the kernel's dynamic shared memory raised to all the
// block may take beside the static part
template <int WR>
const Variant& bf16_variant() {
  static const Variant var = [] {
    Variant r;
    cudaFuncAttributes attr;
    r.err = device().err;
    if (r.err == cudaSuccess)
      r.err = cudaFuncGetAttributes(&attr, evidential_heads_bf16_kernel<WR>);
    if (r.err == cudaSuccess) {
      r.max_dynamic = static_cast<size_t>(device().smem_optin) - attr.sharedSizeBytes;
      r.err = cudaFuncSetAttribute(evidential_heads_bf16_kernel<WR>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(r.max_dynamic));
    }
    return r;
  }();
  return var;
}

// blocks per head at row tiles of `bm` rows: the head's tiles over at most
// SMs / V blocks, so that the grid is one wave
int bf16_blocks_per_head(int bm, int V, int B) {
  const int tiles = (B + bm - 1) / bm;
  return min(tiles, max(1, device().sms / V));
}

template <int WR>
cudaError_t launch_bf16(const float* x, long long sxv, long long sxb, const float* w1,
                        const float* b1, const float* w2, const float* b2, float* out, int V,
                        int B, int D, int H, int C, cudaStream_t stream) {
  constexpr int BM = 16 * WR;
  const Variant& var = bf16_variant<WR>();
  if (var.err != cudaSuccess) return var.err;
  const bool resident = Bf16Geom(BM, D, H, C, true).bytes() <= var.max_dynamic;
  const size_t smem = Bf16Geom(BM, D, H, C, resident).bytes();
  if (smem > var.max_dynamic) return cudaErrorInvalidValue;

  // a tensor map for each array that TMA may take (boxes of a chunk's x
  // rows, 72 columns, and W1's 64 rows of 132 units); the other comes by
  // 4-byte cp.async
  CUtensorMap map_x, map_w1;
  memset(&map_x, 0, sizeof(map_x));
  memset(&map_w1, 0, sizeof(map_w1));
  const cuuint64_t dw[3] = {static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(D),
                            static_cast<cuuint64_t>(V)};
  const cuuint32_t bw[3] = {BF_WS, BF_KC, 1};
  const bool tma_w1 = encode(&map_w1, w1, dw, H, static_cast<long long>(D) * H, bw);
  const long long sxv_eff = V == 1 ? sxb * B : sxv;
  const int x_view_inner = sxv_eff < sxb ? 1 : 0;
  const cuuint64_t dv[3] = {static_cast<cuuint64_t>(D),
                            static_cast<cuuint64_t>(x_view_inner ? V : B),
                            static_cast<cuuint64_t>(x_view_inner ? B : V)};
  const cuuint32_t bv[3] = {BF_XS, x_view_inner ? 1u : static_cast<cuuint32_t>(BM),
                            x_view_inner ? static_cast<cuuint32_t>(BM) : 1u};
  const bool tma_x = x_view_inner ? encode(&map_x, x, dv, sxv_eff, sxb, bv)
                                  : encode(&map_x, x, dv, sxb, sxv_eff, bv);

  const dim3 grid(bf16_blocks_per_head(BM, V, B), V);
  evidential_heads_bf16_kernel<WR><<<grid, BF_BLOCK, smem, stream>>>(
      map_x, map_w1, tma_x ? 1 : 0, tma_w1 ? 1 : 0, x_view_inner, x, sxv, sxb, w1, b1, w2, b2,
      out, V, B, D, H, C, resident ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: V heads of B rows, element (v, b, d) at x[v * sxv + b * sxb + d].
// w1 (V, D, H), b1 (V, H), w2 (V, H, C), b2 (V, C) contiguous; out (B, V, C)
// contiguous. Launches on `stream` and returns the launch's error code
// (cudaErrorInvalidValue for a shape beyond the block's shared memory).
int dmf_evidential_heads(const void* x, long long sxv, long long sxb, const void* w1,
                         const void* b1, const void* w2, const void* b2, void* out,
                         int V, int B, int D, int H, int C, void* stream) {
  const Device& dev = device();
  if (dev.err != cudaSuccess) return static_cast<int>(dev.err);
  if (V <= 0 || B <= 0 || D <= 0 || H <= 0 || C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int n = H > HT ? MAX_CLUSTER : 1;
  // row tiles of 32, or of 64 where 32 would need more blocks than SMs
  const long long blocks32 = static_cast<long long>(n) * ((B + 31) / 32) * V;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* w1f = static_cast<const float*>(w1);
  const auto* b1f = static_cast<const float*>(b1);
  const auto* w2f = static_cast<const float*>(w2);
  const auto* b2f = static_cast<const float*>(b2);
  auto* of = static_cast<float*>(out);
  // row tiles of 64 need twice the room for z's shares (8 x C x 64 floats):
  // where they do not fit (C = 42 at D = 200), the tiles stay at 32 rows
  const bool rows64 = blocks32 > dev.sms && variant<2>().err == cudaSuccess &&
                      plan<2>(D, C).smem <= variant<2>().max_dynamic;
  cudaError_t e = rows64
                      ? launch<2>(xf, sxv, sxb, w1f, b1f, w2f, b2f, of, V, B, D, H, C, s, n)
                      : launch<1>(xf, sxv, sxb, w1f, b1f, w2f, b2f, of, V, B, D, H, C, s, n);
  const cudaError_t last = cudaGetLastError();  // also clears a refused launch's error
  return static_cast<int>(e != cudaSuccess ? e : last);
}

// The bf16 compute mode (see the kernel above), with the arguments of
// dmf_evidential_heads: x, the weights, biases and out f32 in the same
// layouts (x is rounded to bf16 as its fragments are built).
int dmf_evidential_heads_bf16(const void* x, long long sxv, long long sxb, const void* w1,
                              const void* b1, const void* w2, const void* b2, void* out,
                              int V, int B, int D, int H, int C, void* stream) {
  const Device& dev = device();
  if (dev.err != cudaSuccess) return static_cast<int>(dev.err);
  if (V <= 0 || B <= 0 || D <= 0 || H <= 0 || C <= 0 || V > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* w1f = static_cast<const float*>(w1);
  const auto* b1f = static_cast<const float*>(b1);
  const auto* w2f = static_cast<const float*>(w2);
  const auto* b2f = static_cast<const float*>(b2);
  auto* of = static_cast<float*>(out);
  const auto* xf = static_cast<const float*>(x);
  // row tiles of 32 or 64, whichever leaves a block fewer rows (64 on a tie)
  const auto block_rows = [&](int bm) {
    const int tiles = (B + bm - 1) / bm, per_head = bf16_blocks_per_head(bm, V, B);
    return (tiles + per_head - 1) / per_head * bm;
  };
  const cudaError_t e =
      block_rows(32) < block_rows(64)
          ? launch_bf16<2>(xf, sxv, sxb, w1f, b1f, w2f, b2f, of, V, B, D, H, C, s)
          : launch_bf16<4>(xf, sxv, sxb, w1f, b1f, w2f, b2f, of, V, B, D, H, C, s);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : last);
}

const char* dmf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
