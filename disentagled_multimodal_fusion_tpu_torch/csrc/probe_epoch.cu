// One probe epoch: S AdamW steps of V stacked evidential heads, f32 throughout.
//
// Replaces the Pallas TPU kernel run_epoch_kernel
// (disentagled_multimodal_fusion_tpu/ops/probe_megakernel.py:246, body
// _make_epoch_kernel at lines 166-237). Per step:
//   hd  = dropout(relu(x W1 + b1))            (V, B, H)
//   z   = hd W2 + b2, e = evidence(clip(z))   (V, B, C)
//   L   = AvgTrustedLoss(e): EDL digamma A-term + annealed Dirichlet KL, a
//         row-masked mean over B*V rows with the reference's extra / V, plus
//         gamma_t * fused * the pairwise DC regulariser
//   g   = dL/d(W1, b1, W2, b2), derived by hand (below)
//   AdamW with per-step bias corrections bc1[s], bc2[s], then p -= lr * upd.
//
// Backward. The TPU kernel differentiates with jax.value_and_grad; here the
// gradient is written out. With psi, psi' the Stirling digamma and its exact
// derivative (trigamma series), Y = sum_c y_c, kl_c = (alpha_c - 1)(1 - y_c) + 1,
// Skl = sum kl, T = sum (kl - 1):
//   dEDL/dalpha_c = Y psi'(S) - y_c psi'(alpha_c)
//                   + coef (1 - y_c) ((kl_c - 1) psi'(kl_c) - T psi'(Skl))
// (d gammaln_stirling / dx is digamma_stirling algebraically, so the
// digamma terms of the KL cancel). The DC term of a row couples its views:
// with p = alpha / (S + eps), u = C / (S + eps), Gp_c = sum_j cc_ij s_ij,c
// (s = d|p_i - p_j|/dp_i with JAX's +1 at a tie, taken in pair order i < j),
// Gu = -2 sum_j pd_ij (1 - u_j):
//   dDC/dalpha_c = Gp_c / (S + eps) - (sum_k Gp_k alpha_k + C Gu) / (S + eps)^2
// Then de/dz' = e sigmoid(ln 1e13 - z'), the clip passes 1 inside, 0.5 at
// exactly +-10 and 0 outside (as jnp.clip's gradient), dh = (dz W2^T) masked
// by relu' and the dropout scale, and the weight gradients are the usual
// products over the B rows. tests/test_torch_probe_epoch_grad.py holds this
// formula against autograd in float64.
//
// Bound on an NVIDIA H100 (SXM, 700 W; 67 TFLOP/s f32 outside the tensor
// cores, 3.35 TB/s) at V=7, B=100, D=200, H=128, C=10, S=16: ~79 MFLOP of
// f32 per step (1.26 GFLOP per epoch, 18.9 us) against 19 MB per epoch with
// each input read once and the state (p, m, v of 7 heads, 2.3 MB) read and
// written once (5.8 us): bound by operations, 0.018943 ms per epoch. The
// state does not fit one SM's shared memory, so here it stays in device
// memory (and L2) and is read and written every step (87 MB per epoch).
// No tensor cores: the port holds f32 with TF32 off, and Hopper's tensor
// cores reach TF32 at best (3xTF32, split operands, is a question for later).
//
// Design: the C entry point loops over the S steps on the host and launches
// three kernels per step on the caller's stream:
//   1. forward, grid (row tiles of 8, V), 8 warps. W1 of the view (D x H),
//      the 8 rows of x and W2 of the view are contiguous in device memory,
//      so ten bulk asynchronous copies (cp.async.bulk, Hopper's TMA engine,
//      completing on mbarriers) bring them into shared memory: one per
//      warp's slice of K, one for x, one for W2. With per-thread 16-byte
//      cp.async, or one bulk copy per W1 row of a 64-unit tile, issuing the
//      copies set the kernel's time on the card; ten large copies leave
//      that cost behind. Warp g waits for its slice alone and
//      keeps a register tile of 8 rows x 4 hidden units (lane 4l .. 4l + 3):
//      each float4 of W1 from shared memory feeds 32 FMAs, each float4 of x
//      (a broadcast) 16. The 8 slices' sums meet in shared memory (over
//      W1's place) and are added in slice order, no atomics; b1 and the
//      dropout mask are read while W1 streams in, and ReLU and dropout are
//      applied in registers. hd goes to scratch and to shared memory, where
//      z = hd W2 + b2 is summed by groups of 8 lanes (every 8th hidden unit,
//      then a shuffle reduction). H <= 128; any D and C up to the shared
//      memory a block may take (at D = 200, H = 128: 113 KB + 0.5 KB per
//      class). Widths that are not multiples of 4 take 4-byte cp.async
//      copies into a zero-padded layout instead.
//   2. loss and dh, grid (rows / 2), a warp per (row, view) with the classes
//      across lanes (a lane loops when C > 32): z, e, alpha and
//      p = alpha / (S + eps) go to shared memory; S, Skl, T, Y, pd_ij and
//      sum_c Gp_c alpha_c are butterfly shuffle sums (the same order for
//      every view, so equal views give bitwise-equal p, as the tie of
//      |p_i - p_j| needs). psi and psi' of every alpha, of S, of Skl and of
//      each kl that differs from its alpha are one lane's argument each,
//      sharing the reciprocals 1/(x + k) between the two series (the same
//      IEEE results, not an approximation); gammaln of every kl and of Skl
//      likewise. The views of a row meet in shared memory for the DC term.
//      The kernel overwrites z with dL/dz, keeps dL/dz of its row in shared
//      memory, and the warp then writes the row's dh = (dz W2^T) * (hd > 0)
//      * 1/keep at once, while other warps of the block still work: a lane
//      per hidden unit (j = lane + 32 k, the four sums side by side), the C
//      products in class order (the bits of a separate dh pass); hd is read
//      as the block starts. W2 of all V views is one contiguous run: one
//      bulk copy, issued as the block starts, brings it into shared memory
//      while the loss is computed (read from device memory instead where it
//      does not fit, V H C > ~26 K floats, or is not 16-byte whole; slower
//      at HandWritten's shape). W2 is not written before step 3, so there
//      is no hazard. Each block writes its partial sums; no float
//      atomics.
//   3. gradient + AdamW, grid (D / 4 W1 blocks + C / 4 W2 blocks, V), 8
//      warps. The products are dW1_v = x_v^T dh_v (D x B . B x H),
//      dW2_v = hd_v^T dz_v (H x B . B x C), db1 and db2 the column sums of
//      dh_v and dz_v. A W1 block takes 4 rows of W1 and all of H: dh_v is
//      one contiguous run (one bulk copy on an mbarrier), x's 4 columns one
//      16-byte cp.async a row (4-byte where D is not a multiple of 4). A W2
//      block takes 4 classes: hd_v and dz_v, one bulk copy each. B is split
//      across the 8 warps (row r to warp r % 8), each lane keeping a 4 x 4
//      register tile of 4 hidden units (lane 4l .. 4l + 3) by 4 rows of W1
//      or 4 classes: each float4 of dh (of hd) feeds 16 FMAs, x and dz are
//      broadcasts. The bias sums ride along: every float4 of dh (of dz)
//      read for the product is also added into a bias row of the tile, so
//      db1 (in the block of W1's first rows) and db2 cost no pass of their
//      own. The 8 warps' tiles meet in shared memory (over the operands)
//      and are added in warp order (no atomics), and AdamW updates p, m, v
//      in place in the epilogue, each thread on up to 3 elements
//      (consecutive across the threads) whose p, m, v came into shared
//      memory by cp.async as the block started: the epilogue's reads, its
//      longest wait, overlap the staging. Small tiles and many blocks (371
//      at HandWritten's V = 7, D = 200, C = 10, three an SM, one wave; 15
//      on the synthetic sweep) measured fastest on the card: 8 and 16 rows
//      of W1 a block were slower at every probe shape, each block staging
//      all of dh_v. Rows are staged in chunks of 128 (one chunk at the
//      probes' batch of 100 or 128), so any B works.
//      Block (0, 0) also adds up the loss pass's block partials into the
//      step's loss (one warp, a fixed order).
// Any V <= 8, D, H <= 128, C and B work, up to the shared memory a block may
// take (else cudaErrorInvalidValue); rows with rmask 0 (the padded tail)
// have dL/dz = 0 and contribute nothing. Each launch is checked with
// cudaGetLastError() and the entry point returns the first error.

#include <cuda_runtime.h>

namespace {

constexpr int MAXV = 8;
constexpr int WARP = 32;
constexpr unsigned kFull = 0xffffffffu;
// forward
constexpr int FWD_ROWS = 8;       // batch rows per block
constexpr int FWD_SPLITK = 8;     // warps per block, one slice of K each
constexpr int FWD_THREADS = FWD_SPLITK * WARP;
constexpr int MAX_HIDDEN = 128;   // a lane holds 4 hidden units
constexpr int Z_GROUP = 8;        // lanes summing one z output
// loss and dh
constexpr int LOSS_ROWS = 2;              // rows per loss block
constexpr int LOSS_ARRAYS = 12;           // per-warp arrays of C in shared memory
constexpr size_t LOSS_W2_SMEM = 112 * 1024;  // W2 staged while the block stays under this
// gradient + AdamW
constexpr int GRAD_WARPS = 8;             // B split across the warps
constexpr int GRAD_THREADS = GRAD_WARPS * WARP;
constexpr int GRAD_ROWS = 128;            // batch rows staged per chunk
constexpr int W1_ROWS = 4;                // W1 rows per W1 block (a lane: 4 rows x 4 units)
constexpr int W2_CLASSES = 4;             // classes per W2 block (a lane: 4 units x 4 classes)
// epilogue outputs per thread: a W1 block's 4 rows and b1, or 4 classes of
// H + 1 rows (W2 and b2)
constexpr int GRAD_OUTS = ((W1_ROWS + 1) * MAX_HIDDEN + GRAD_THREADS - 1) / GRAD_THREADS;
static_assert((MAX_HIDDEN + 1) * W2_CLASSES <= GRAD_OUTS * GRAD_THREADS, "epilogue outputs");
constexpr int GRAD_BLOCKS_PER_SM = 3;     // HandWritten's 371 blocks in one wave
constexpr float kLog1e13 = 29.933606208922594f;  // 13 ln 10
constexpr float kB1 = 0.9f, kB2 = 0.999f;
constexpr float kOneMinusB1 = 0.1f, kOneMinusB2 = 0.001f;
constexpr float kEps = 1e-8f, kDcEps = 1e-8f;

// ---- Stirling series (ops/special.py), shifted by 8 ----
// digamma_stirling and trigamma_stirling of one argument, sharing 1/(x + k) and 1/z
__device__ __forceinline__ void digamma_trigamma_s(float x, float& psi, float& psi1) {
  const float z = x + 8.0f;
  float shift = 0.0f, shift_sq = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float r = 1.0f / (x + static_cast<float>(k));
    shift += r;
    shift_sq += r * r;
  }
  const float rz = 1.0f / z, rz2 = rz * rz;
  const float series = rz2 * (-1.0f / 12.0f + rz2 * (1.0f / 120.0f - rz2 * (1.0f / 252.0f)));
  psi = logf(z) - 0.5f * rz + series - shift;
  psi1 = rz + rz2 * (0.5f + rz * (1.0f / 6.0f + rz2 * (-1.0f / 30.0f + rz2 * (1.0f / 42.0f)))) +
         shift_sq;
}

__device__ __forceinline__ float gammaln_s(float x) {
  const float z = x + 8.0f;
  float shift = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) shift += logf(x + static_cast<float>(k));
  const float rz = 1.0f / z, rz2 = rz * rz;
  const float series = rz * (1.0f / 12.0f + rz2 * (-1.0f / 360.0f + rz2 * (1.0f / 1260.0f)));
  return (z - 0.5f) * logf(z) - z + 0.91893853320467274f + series - shift;
}

__device__ __forceinline__ float clip10(float z) { return fminf(fmaxf(z, -10.0f), 10.0f); }

// saturated evidence of a clipped logit: exp(z + L - logaddexp(z, L))
__device__ __forceinline__ float evidence(float zc) {
  const float lse = fmaxf(zc, kLog1e13) + log1pf(expf(-fabsf(zc - kLog1e13)));
  return expf((zc + kLog1e13) - lse);
}

__device__ __forceinline__ void adamw(float& p, float& m, float& v, float g, float bc1, float bc2,
                                      float lr, float wd) {
  m = kB1 * m + kOneMinusB1 * g;
  v = kB2 * v + kOneMinusB2 * (g * g);
  float upd = (m / bc1) / (sqrtf(v / bc2) + kEps);
  if (wd > 0.0f) upd = upd + wd * p;
  p = p - lr * upd;
}

// butterfly sum over the warp: every lane gets the same bits (each step adds
// the same two values in both lanes, and float addition commutes)
__device__ __forceinline__ float warp_sum(float value) {
#pragma unroll
  for (int offset = WARP / 2; offset > 0; offset >>= 1)
    value += __shfl_xor_sync(kFull, value, offset);
  return value;
}

// ---- asynchronous copies, global -> shared ----
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// Hopper's bulk copy (the TMA engine, no tensor map): `bytes` (a multiple of
// 16, both addresses 16-byte aligned) from global to shared memory, counted
// on the mbarrier `bar` as they land
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}
// the one arrival of the barrier's phase, which then also waits for `bytes`
__device__ __forceinline__ void mbar_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
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
// 4 bytes; bytes = 0 writes a zero (the path for rows that are not 16-byte aligned)
__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}
// 16 bytes; bytes = 0 writes zeros
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Shared memory of the forward kernel, in floats: W1 of the view [Dp][Hp]
// (after the products, the warps' partial sums [FWD_SPLITK][FWD_ROWS][Hp]),
// x [FWD_ROWS][Dp], W2 [H][C], b2 [C], hd [FWD_ROWS][Hp + 1]; Dp and Hp are
// D and H rounded up to 4
__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) / 4 * 4; }
__host__ __device__ __forceinline__ size_t fwd_smem_floats(int D, int H, int C) {
  const size_t dp = round4(D), hp = round4(H);
  return hp * (dp > FWD_SPLITK * FWD_ROWS ? dp : FWD_SPLITK * FWD_ROWS) + FWD_ROWS * dp +
         static_cast<size_t>(H) * C + C + FWD_ROWS * (hp + 1);
}

// 1. forward of FWD_ROWS rows of one view: hd = dropout(relu(x W1 + b1)) and
// z = hd W2 + b2
__global__ void __launch_bounds__(FWD_THREADS)
forward_kernel(const float* __restrict__ x, const float* __restrict__ drop,
               const float* __restrict__ w1, const float* __restrict__ b1,
               const float* __restrict__ w2, const float* __restrict__ b2,
               float* __restrict__ hd, float* __restrict__ zbuf, int B, int D, int H, int C,
               float inv_keep) {
  extern __shared__ __align__(128) float smem[];
  __shared__ __align__(8) unsigned long long bars[FWD_SPLITK + 1];
  const int dp = round4(D), hp = round4(H);
  float* w1s = smem;                                                   // [dp][hp]
  float* xs = w1s + static_cast<size_t>(hp) * max(dp, FWD_SPLITK * FWD_ROWS);  // [FWD_ROWS][dp]
  float* w2s = xs + FWD_ROWS * dp;                                     // [H][C]
  float* b2s = w2s + H * C;                                            // [C]
  float* hs = b2s + C;                                                 // [FWD_ROWS][hp + 1]
  const int t = threadIdx.x;
  const int warp = t / WARP, lane = t % WARP;
  const int b0 = blockIdx.x * FWD_ROWS;
  const int v = blockIdx.y;
  const int rows = min(FWD_ROWS, B - b0);
  const float* xv = x + (static_cast<long long>(v) * B + b0) * D;
  const float* w1v = w1 + static_cast<long long>(v) * D * H;
  const float* w2v = w2 + static_cast<long long>(v) * H * C;
  const long long hrow0 = static_cast<long long>(v) * B + b0;  // row of (v, b0) in (V*B, .)
  // warp g sums over the W1 rows [g kc, (g + 1) kc)
  const int kc = round4((dp + FWD_SPLITK - 1) / FWD_SPLITK);
  const int k_begin = min(D, warp * kc), k_end = min(D, (warp + 1) * kc);
  // With D and H multiples of 4 and 16-byte aligned bases, the view's W1,
  // the rows' x and the view's W2 are contiguous runs of whole 16-byte
  // units: ten bulk copies, one per K slice of W1 (barrier g), x and W2
  // (barrier FWD_SPLITK). Otherwise 4-byte copies into the padded layout.
  using u64 = unsigned long long;
  const bool bulk = H % 4 == 0 && D % 4 == 0 && (H * C) % 4 == 0 &&
                    ((reinterpret_cast<u64>(w1) | reinterpret_cast<u64>(x) |
                      reinterpret_cast<u64>(w2)) & 15) == 0;
  if (bulk) {
    if (t == 0) {
      for (int g = 0; g <= FWD_SPLITK; ++g) mbar_init(&bars[g]);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      for (int g = 0; g < FWD_SPLITK; ++g)
        mbar_expect(&bars[g], 4u * H * max(0, min(D, (g + 1) * kc) - min(D, g * kc)));
      mbar_expect(&bars[FWD_SPLITK], 4u * (rows * D + H * C));
    }
    __syncthreads();
    if (t < FWD_SPLITK) {
      const int k0 = min(D, t * kc), k1 = min(D, (t + 1) * kc);
      if (k1 > k0)
        bulk_copy(w1s + static_cast<size_t>(k0) * H, w1v + static_cast<long long>(k0) * H,
                  4u * H * (k1 - k0), &bars[t]);
    } else if (t == FWD_SPLITK) {
      bulk_copy(xs, xv, 4u * rows * D, &bars[FWD_SPLITK]);
    } else if (t == FWD_SPLITK + 1) {
      bulk_copy(w2s, w2v, 4u * H * C, &bars[FWD_SPLITK]);
    }
  } else {
    for (int i = t; i < dp * hp; i += FWD_THREADS) {
      const int k = i / hp, j = i - k * hp;
      const bool ok = k < D && j < H;
      cp_async4(w1s + i, ok ? w1v + static_cast<long long>(k) * H + j : w1, ok ? 4 : 0);
    }
    for (int i = t; i < FWD_ROWS * dp; i += FWD_THREADS) {
      const int r = i / dp, k = i - r * dp;
      const bool ok = r < rows && k < D;
      cp_async4(xs + i, ok ? xv + static_cast<long long>(r) * D + k : x, ok ? 4 : 0);
    }
    for (int i = t; i < H * C; i += FWD_THREADS) cp_async4(w2s + i, w2v + i, 4);
    cp_async_wait_all();
  }
  for (int c = t; c < C; c += FWD_THREADS) b2s[c] = b2[static_cast<long long>(v) * C + c];

  // the thread's outputs of the epilogue, (row, unit) = divmod(t + FWD_THREADS i, hp):
  // their b1 and dropout mask are read while W1 streams in
  constexpr int kOuts = FWD_ROWS * MAX_HIDDEN / FWD_THREADS;
  float bias[kOuts], keep[kOuts];
#pragma unroll
  for (int i = 0; i < kOuts; ++i) {
    const int o = t + FWD_THREADS * i;
    const int r = o / hp, j = o - r * hp;
    const bool ok = r < rows && j < H;
    bias[i] = ok ? b1[static_cast<long long>(v) * H + j] : 0.0f;
    keep[i] = ok && drop != nullptr ? drop[(hrow0 + r) * H + j] : 1.0f;
  }

  // warp g: all FWD_ROWS rows x units 4 lane .. 4 lane + 3, over its K slice
  float acc[FWD_ROWS][4];
#pragma unroll
  for (int r = 0; r < FWD_ROWS; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = 0.0f;
  if (bulk) {
    mbar_wait(&bars[warp], 0);
    mbar_wait(&bars[FWD_SPLITK], 0);
  } else {
    __syncthreads();
  }
  if (4 * lane < H) {
    const float* wl = w1s + 4 * lane;
    for (int k = k_begin; k < k_end; k += 4) {
      float4 xk[FWD_ROWS];
#pragma unroll
      for (int r = 0; r < FWD_ROWS; ++r) xk[r] = *reinterpret_cast<const float4*>(xs + r * dp + k);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (k + u < k_end) {
          const float4 w = *reinterpret_cast<const float4*>(wl + static_cast<size_t>(k + u) * hp);
#pragma unroll
          for (int r = 0; r < FWD_ROWS; ++r) {
            const float xr = u == 0 ? xk[r].x : u == 1 ? xk[r].y : u == 2 ? xk[r].z : xk[r].w;
            acc[r][0] = fmaf(xr, w.x, acc[r][0]);
            acc[r][1] = fmaf(xr, w.y, acc[r][1]);
            acc[r][2] = fmaf(xr, w.z, acc[r][2]);
            acc[r][3] = fmaf(xr, w.w, acc[r][3]);
          }
        }
      }
    }
  }
  // the K slices' sums, over W1's place, added in slice order (no atomics)
  __syncthreads();
  float* part = w1s;  // [FWD_SPLITK][FWD_ROWS][hp]
  if (4 * lane < hp) {
#pragma unroll
    for (int r = 0; r < FWD_ROWS; ++r)
      *reinterpret_cast<float4*>(part + (warp * FWD_ROWS + r) * hp + 4 * lane) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kOuts; ++i) {
    const int o = t + FWD_THREADS * i;
    const int r = o / hp, j = o - r * hp;
    if (r >= FWD_ROWS) continue;
    float h = 0.0f;
    if (r < rows && j < H) {
      float sum = 0.0f;
#pragma unroll
      for (int g = 0; g < FWD_SPLITK; ++g) sum += part[(g * FWD_ROWS + r) * hp + j];
      h = fmaxf(sum + bias[i], 0.0f);
      if (drop != nullptr) h = (h * keep[i]) * inv_keep;
      hd[(hrow0 + r) * H + j] = h;
    }
    hs[r * (hp + 1) + j] = h;
  }
  __syncthreads();

  // z[r][c] = sum_j hd[r][j] W2[j][c] + b2[c]: Z_GROUP lanes per output, lane q
  // summing units q, q + Z_GROUP, ..., then a shuffle sum inside the group.
  // The trip count is the same for every thread, so whole warps shuffle.
  const int q = t % Z_GROUP;
  const int group = t / Z_GROUP;
  constexpr int kGroups = FWD_THREADS / Z_GROUP;
  const int n_out = rows * C;
  for (int base = 0; base < n_out; base += kGroups) {
    const int o = base + group;
    const int r = o / C;
    const int c = o - r * C;
    float sum = 0.0f;
    if (o < n_out) {
      const float* hr = hs + r * (hp + 1);
      for (int j = q; j < H; j += Z_GROUP) sum = fmaf(hr[j], w2s[j * C + c], sum);
    }
#pragma unroll
    for (int offset = Z_GROUP / 2; offset > 0; offset >>= 1)
      sum += __shfl_xor_sync(kFull, sum, offset);
    if (o < n_out && q == 0) zbuf[(hrow0 + r) * C + c] = sum + b2s[c];
  }
}

// d|p_i - p_j| / dp_i for the pair taken in the order (min, max), with JAX's
// gradient of +1 for abs at 0
__device__ __forceinline__ float abs_grad(float pi, float pj, bool i_first) {
  const float diff = i_first ? pi - pj : pj - pi;
  const float s = diff >= 0.0f ? 1.0f : -1.0f;
  return i_first ? s : -s;
}

// Shared memory of the loss kernel, in floats: the warps' arrays
// [LOSS_ROWS * V][LOSS_ARRAYS][C], then (when staged) W2 of all views [V][H][C]
__host__ __device__ __forceinline__ size_t loss_smem_floats(int V, int H, int C, bool stage_w2) {
  return round4(LOSS_ROWS * V * LOSS_ARRAYS * C) +
         (stage_w2 ? static_cast<size_t>(V) * H * C : 0);
}

// 2. dL/dz and dh: block (32, V, LOSS_ROWS), the warp (lane, v, r) for view
// v of row blockIdx.x * LOSS_ROWS + r, the classes across its lanes. zbuf
// holds z and is overwritten with dL/dz; dh (V, B, H) gets
// (dz W2^T) * (hd > 0) * inv_keep. With stage_w2, W2 is read from shared
// memory (one bulk copy), else from device memory. Writes the block's
// partial sums (EDL, DC) at partials[2 * block]; block 0 also writes
// sum(rmask) at partials[2 * gridDim.x].
__global__ void __launch_bounds__(LOSS_ROWS * MAXV * WARP)
loss_dh_kernel(float* __restrict__ zbuf, const float* __restrict__ yoh,
               const float* __restrict__ rmask, const float* __restrict__ scal,
               float* __restrict__ partials, const float* __restrict__ hd,
               const float* __restrict__ w2, float* __restrict__ dh, int V, int B, int H, int C,
               float fused, float lgamma_c, float inv_keep, int stage_w2) {
  extern __shared__ __align__(16) float lsm[];        // loss_smem_floats
  __shared__ __align__(8) unsigned long long w2_bar;
  __shared__ float red[LOSS_ROWS * MAXV][3];          // per warp: sum(rmask) share, EDL, DC
  __shared__ float u_sh[LOSS_ROWS][MAXV];             // u = C / (S + eps) of each view
  __shared__ float row_fn[LOSS_ROWS * MAXV][5];       // psi(S), psi'(S), psi(Skl), psi'(Skl),
                                                      // gammaln(Skl) of each warp's row
  const int lane = threadIdx.x;
  const int v = threadIdx.y;
  const int rr = threadIdx.z;
  const int w = rr * V + v;                           // the hardware warp
  const int n_warps = LOSS_ROWS * V;
  const int b = blockIdx.x * LOSS_ROWS + rr;
  const bool active = b < B;
  const size_t span = static_cast<size_t>(LOSS_ARRAYS) * C;
  float* zs = lsm + w * span;  // z, then dL/dz
  float* ys = zs + C;          // y
  float* es = ys + C;          // evidence
  float* as = es + C;          // alpha
  float* ps = as + C;          // p = alpha / (S + eps)
  float* kls = ps + C;         // kl = (alpha - 1)(1 - y) + 1, computed once
  float* psa = kls + C;        // psi(alpha)
  float* ps1a = psa + C;       // psi'(alpha)
  float* psk = ps1a + C;       // psi(kl), where kl != alpha
  float* ps1k = psk + C;       // psi'(kl), where kl != alpha
  float* gps = ps1k + C;       // Gp
  float* klist = gps + C;      // the classes whose kl != alpha, as floats
  const float* p_row = lsm + static_cast<size_t>(rr) * V * span + 4 * C;  // p of view j: + j span
  const float coef = scal[1];
  const float gamma_t = scal[2];
  const float cf = static_cast<float>(C);
  const float vf = static_cast<float>(V);
  float* w2s = lsm + loss_smem_floats(V, H, C, false);  // [V][H][C] when staged
  if (stage_w2 && lane == 0 && w == 0) {
    // W2 of every view streams in while the loss is computed; the barrier is
    // initialised before the block's first __syncthreads, and waited on after it
    mbar_init(&w2_bar);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    const unsigned bytes = 4u * V * H * C;
    mbar_expect(&w2_bar, bytes);
    bulk_copy(w2s, w2, bytes, &w2_bar);
  }

  // hd of the row's hidden units j = lane + 32 k, read while the loss is computed
  const long long hrow = (static_cast<long long>(v) * B + b) * H;
  constexpr int kUnits = MAX_HIDDEN / WARP;
  float hv[kUnits];
#pragma unroll
  for (int k = 0; k < kUnits; ++k) {
    const int j = lane + WARP * k;
    hv[k] = active && j < H ? hd[hrow + j] : 0.0f;
  }

  // this warp's share of sum(rmask), added up at the block's first barrier
  float part = 0.0f;
  for (int i = lane + WARP * w; i < B; i += WARP * n_warps) part += rmask[i];
  const float rb = active ? rmask[b] : 0.0f;
  float* zr = zbuf + (static_cast<long long>(v) * B + b) * C;
  const float* yr = yoh + static_cast<long long>(b) * C;
  float S = 0.0f, se = 1.0f, Skl = 0.0f, T = 0.0f, Y = 0.0f, edl = 0.0f;
  if (active) {
    // z, y, evidence, alpha and their sum S
    float s_part = 0.0f;
    for (int c = lane; c < C; c += WARP) {
      const float z = zr[c];
      const float e = evidence(clip10(z));
      zs[c] = z;
      ys[c] = yr[c];
      es[c] = e;
      as[c] = e + 1.0f;
      s_part += e + 1.0f;
    }
    S = warp_sum(s_part);
    se = S + kDcEps;
    // p, kl and the sums Y, Skl, T; list the classes whose kl differs from alpha
    float y_part = 0.0f, skl_part = 0.0f, t_part = 0.0f;
    int n_kl = 0;
    for (int c0 = 0; c0 < C; c0 += WARP) {
      const int c = c0 + lane;
      bool differs = false;
      if (c < C) {
        const float a = as[c], y = ys[c];
        const float kl = (a - 1.0f) * (1.0f - y) + 1.0f;
        kls[c] = kl;
        ps[c] = a / se;
        y_part += y;
        skl_part += kl;
        t_part += kl - 1.0f;
        differs = kl != a;
      }
      const unsigned mask = __ballot_sync(kFull, differs);
      if (differs) klist[n_kl + __popc(mask & ((1u << lane) - 1u))] = static_cast<float>(c);
      n_kl += __popc(mask);
    }
    Y = warp_sum(y_part);
    Skl = warp_sum(skl_part);
    T = warp_sum(t_part);
    __syncwarp();

    // one argument per lane for psi and psi' (every alpha, then S, Skl and
    // each kl that differs from its alpha: the label's, for one-hot y) and
    // for gammaln (every kl, then Skl), in one pass
    const int n_args = C + 2 + n_kl;
    float lg_part = 0.0f;
    for (int i = lane; i < n_args; i += WARP) {
      int c = i;
      float arg;
      if (i < C) {
        arg = as[i];
      } else if (i == C) {
        arg = S;
      } else if (i == C + 1) {
        arg = Skl;
      } else {
        c = static_cast<int>(klist[i - C - 2]);
        arg = kls[c];
      }
      float psi, psi1;
      digamma_trigamma_s(arg, psi, psi1);
      const float lg = gammaln_s(i < C ? kls[i] : Skl);
      if (i < C) {
        psa[i] = psi;
        ps1a[i] = psi1;
        lg_part += lg;
      } else if (i <= C + 1) {
        row_fn[w][2 * (i - C)] = psi;
        row_fn[w][2 * (i - C) + 1] = psi1;
        if (i == C) row_fn[w][4] = lg;
      } else {
        psk[c] = psi;
        ps1k[c] = psi1;
      }
    }
    const float lg_sum = warp_sum(lg_part);
    __syncwarp();

    // the EDL row term
    const float psi_s = row_fn[w][0], psi_skl = row_fn[w][2];
    float a_part = 0.0f, second_part = 0.0f;
    for (int c = lane; c < C; c += WARP) {
      const float a = as[c], y = ys[c], kl = kls[c];
      if (y != 0.0f) a_part += y * (psi_s - psa[c]);
      second_part += (kl - 1.0f) * ((kl != a ? psk[c] : psa[c]) - psi_skl);
    }
    const float a_term = warp_sum(a_part);
    const float second = warp_sum(second_part);
    const float first = row_fn[w][4] - lg_sum - lgamma_c;
    edl = (a_term + coef * (first + second)) * rb;
    if (lane == 0) u_sh[rr][v] = cf / se;
  }
  part = warp_sum(part);
  if (lane == 0) red[w][0] = part;
  __syncthreads();  // p and u of every view of the block's rows, the shares of sum(rmask)

  float msum = 0.0f;
  for (int i = 0; i < n_warps; ++i) msum += red[i][0];
  float dc = 0.0f;
  if (active) {
    // the DC term of the row: pd_ij against every other view, the V - 1
    // shuffle sums side by side (zeros for j = v and j >= V)
    const float ui = u_sh[rr][v];
    float pd[MAXV];
#pragma unroll
    for (int j = 0; j < MAXV; ++j) pd[j] = 0.0f;
    for (int c = lane; c < C; c += WARP) {
      const float pi = ps[c];
#pragma unroll
      for (int j = 0; j < MAXV; ++j)
        if (j < V && j != v) pd[j] += fabsf(pi - p_row[j * span + c]);
    }
#pragma unroll
    for (int j = 0; j < MAXV; ++j) pd[j] = 0.5f * warp_sum(pd[j]);
    float gu = 0.0f, dc_part = 0.0f;
#pragma unroll
    for (int j = 0; j < MAXV; ++j) {
      if (j < V && j != v) {
        const float uj = u_sh[rr][j];
        if (j > v) dc_part += 2.0f * pd[j] * ((1.0f - ui) * (1.0f - uj));
        gu += -2.0f * pd[j] * (1.0f - uj);
      }
    }
    dc = dc_part / static_cast<float>(max(1, V - 1)) * rb;

    if (rb != 0.0f) {
      const float ke = rb / fmaxf(msum * vf, 1.0f) / vf;
      const float kd = gamma_t * fused / static_cast<float>(max(1, V - 1)) / fmaxf(msum, 1.0f) * rb;
      const float psi1_s = row_fn[w][1], psi1_skl = row_fn[w][3];
      // Gp_c, once, and sum_c Gp_c alpha_c
      float gpa_part = 0.0f;
      for (int c = lane; c < C; c += WARP) {
        const float pi = ps[c];
        float gp = 0.0f;
#pragma unroll
        for (int j = 0; j < MAXV; ++j) {
          if (j < V && j != v)
            gp += ((1.0f - ui) * (1.0f - u_sh[rr][j])) * abs_grad(pi, p_row[j * span + c], v < j);
        }
        gps[c] = gp;
        gpa_part += gp * as[c];
      }
      const float gpa = warp_sum(gpa_part);
      for (int c = lane; c < C; c += WARP) {
        const float a = as[c], y = ys[c], kl = kls[c];
        float dedl = Y * psi1_s;
        if (y != 0.0f) dedl -= y * ps1a[c];
        dedl += coef * (1.0f - y) * ((kl - 1.0f) * (kl != a ? ps1k[c] : ps1a[c]) - T * psi1_skl);
        const float ddc = gps[c] / se - (gpa + cf * gu) / (se * se);
        const float dalpha = ke * dedl + kd * ddc;
        const float z = zs[c];
        const float zc = clip10(z);
        const float az = fabsf(z);
        const float clip_grad = az < 10.0f ? 1.0f : (az == 10.0f ? 0.5f : 0.0f);
        const float sig = 1.0f / (1.0f + expf(zc - kLog1e13));
        const float dz = dalpha * es[c] * sig * clip_grad;
        zr[c] = dz;
        zs[c] = dz;  // z of this class is read above by this lane alone
      }
    } else {
      for (int c = lane; c < C; c += WARP) {
        zr[c] = 0.0f;
        zs[c] = 0.0f;
      }
    }
    __syncwarp();

    // dh of the row, while other warps of the block still work: a lane per
    // hidden unit j = lane + 32 k, its 4 sums side by side, each in class order
    if (stage_w2) mbar_wait(&w2_bar, 0);
    const float* w2v = (stage_w2 ? w2s : w2) + static_cast<size_t>(v) * H * C;
    float acc[kUnits];
#pragma unroll
    for (int k = 0; k < kUnits; ++k) acc[k] = 0.0f;
    for (int c = 0; c < C; ++c) {
      const float d = zs[c];
#pragma unroll
      for (int k = 0; k < kUnits; ++k) {
        const int j = lane + WARP * k;
        if (j < H) acc[k] = fmaf(d, w2v[static_cast<size_t>(j) * C + c], acc[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < kUnits; ++k) {
      const int j = lane + WARP * k;
      if (j < H) dh[hrow + j] = hv[k] > 0.0f ? acc[k] * inv_keep : 0.0f;
    }
  }

  // the block's sums, in warp order
  if (lane == 0) {
    red[w][1] = edl;
    red[w][2] = dc;
  }
  __syncthreads();
  if (w == 0 && lane == 0) {
    float edl_sum = 0.0f, dc_sum = 0.0f;
    for (int i = 0; i < n_warps; ++i) {
      edl_sum += red[i][1];
      dc_sum += red[i][2];
    }
    partials[2 * blockIdx.x] = edl_sum;
    partials[2 * blockIdx.x + 1] = dc_sum;
    if (blockIdx.x == 0) partials[2 * gridDim.x] = msum;
  }

  // every thread waits for W2, so no block exits with the copy in flight
  if (stage_w2) mbar_wait(&w2_bar, 0);
}

// Shared memory of the gradient kernel, in floats, at chunks of bc rows:
// the (rows x H) operand (dh for a W1 block, hd for a W2 block) [bc][Hp] and
// the second (x's W1_ROWS columns [bc][W1_ROWS], or dz [bc][C]), after the
// products the warps' tiles [GRAD_WARPS][grad_tile(Hp)] over them; then p,
// m and v of the block's outputs [3][GRAD_OUTS * GRAD_THREADS]
__host__ __device__ __forceinline__ int grad_chunk_rows(int B) {
  return B < GRAD_ROWS ? B : GRAD_ROWS;
}
// a warp's tile: [W1_ROWS + 1][Hp] (the last row db1) or [Hp + 1][W2_CLASSES]
// (the last row db2)
__host__ __device__ __forceinline__ int grad_tile(int hp) {
  return (W1_ROWS + 1) * hp > (hp + 1) * W2_CLASSES ? (W1_ROWS + 1) * hp
                                                    : (hp + 1) * W2_CLASSES;
}
__host__ __device__ __forceinline__ size_t grad_operands_floats(int B, int H, int C) {
  const int bc = grad_chunk_rows(B), hp = round4(H);
  const size_t staged = static_cast<size_t>(bc) * hp + round4(bc * (C > W1_ROWS ? C : W1_ROWS));
  const size_t tiles = static_cast<size_t>(GRAD_WARPS) * grad_tile(hp);
  return staged > tiles ? staged : tiles;
}
__host__ __device__ __forceinline__ size_t grad_smem_floats(int B, int H, int C) {
  return grad_operands_floats(B, H, C) + 3 * GRAD_OUTS * GRAD_THREADS;
}

// rows [r0, r0 + rows) of the row-major (., width) matrix src into dst
// [rows][stride] (columns [width, stride) zero) with 4-byte cp.async: the
// path for widths or bases that are not whole 16-byte units
__device__ __forceinline__ void copy_rows4(float* dst, const float* src, int r0, int rows,
                                           int width, int stride, int t) {
  for (int i = t; i < rows * stride; i += GRAD_THREADS) {
    const int r = i / stride, j = i - r * stride;
    const bool ok = j < width;
    cp_async4(dst + i, ok ? src + static_cast<long long>(r0 + r) * width + j : src, ok ? 4 : 0);
  }
}

// 3. the gradients over the B rows, then AdamW in place. Block (k, v): for
// k < n_w1, W1 rows [W1_ROWS k, + W1_ROWS) of view v (and b1 when k = 0);
// else the classes [W2_CLASSES (k - n_w1), + W2_CLASSES) of W2 and b2. Block
// (0, 0) also writes the step's loss from the loss kernel's n_loss partials.
__global__ void __launch_bounds__(GRAD_THREADS, GRAD_BLOCKS_PER_SM)
grad_adamw_kernel(const float* __restrict__ x, const float* __restrict__ hd,
                  const float* __restrict__ dz, const float* __restrict__ dh,
                  float* __restrict__ w1, float* __restrict__ b1, float* __restrict__ w2,
                  float* __restrict__ b2, float* __restrict__ m1, float* __restrict__ m2,
                  float* __restrict__ m3, float* __restrict__ m4, float* __restrict__ v1,
                  float* __restrict__ v2, float* __restrict__ v3, float* __restrict__ v4,
                  const float* __restrict__ bc1s, const float* __restrict__ bc2s,
                  const float* __restrict__ scal, int step, int B, int D, int H, int C,
                  float wd, int n_w1, const float* __restrict__ partials, int n_loss, int V,
                  float fused, float* __restrict__ loss_out) {
  extern __shared__ __align__(128) float smem[];
  __shared__ __align__(8) unsigned long long bar;
  using u64 = unsigned long long;
  const int t = threadIdx.x;
  const int warp = t / WARP, lane = t % WARP;
  const int k = blockIdx.x;
  const int v = blockIdx.y;
  const int hp = round4(H);
  const int bc = grad_chunk_rows(B);
  const int n_chunks = (B + bc - 1) / bc;
  const bool w1_role = k < n_w1;
  // the (rows x H) operand, dh or hd of the view, into hs [bc][hp]; the
  // second into os; later the warps' tiles over both; the state after them
  const float* hsrc = (w1_role ? dh : hd) + static_cast<long long>(v) * B * H;
  const bool hbulk = H % 4 == 0 && (reinterpret_cast<u64>(hsrc) & 15) == 0;
  float* hs = smem;
  float* os = hs + static_cast<size_t>(bc) * hp;
  float* part = smem;
  const int tile = grad_tile(hp);
  float* sp = smem + grad_operands_floats(B, H, C);
  float* sm = sp + GRAD_OUTS * GRAD_THREADS;
  float* sv = sm + GRAD_OUTS * GRAD_THREADS;
  if (t == 0) {
    mbar_init(&bar);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // The block's outputs o (a W1 block: its rows of W1, then b1 in block 0;
  // a W2 block: (unit, class) of W2, then b2), thread t taking o = t + 256 i:
  // each one's place in a warp's tile and in the state. Their p, m, v come
  // in by cp.async now, beside the staging.
  const int d0 = w1_role ? k * W1_ROWS : 0;
  const int dt = w1_role ? min(W1_ROWS, D - d0) : 0;
  const int c0 = w1_role ? 0 : (k - n_w1) * W2_CLASSES;
  const int cn = w1_role ? 0 : min(W2_CLASSES, C - c0);
  const int n_out = w1_role ? (dt + (k == 0 ? 1 : 0)) * H : (H + 1) * cn;
  auto where = [&](int o, int& place, long long& at) {  // returns whether o is a bias
    if (w1_role) {
      const int r = o / H, j = o - r * H;
      place = (r < dt ? r : W1_ROWS) * hp + j;
      at = r < dt ? (static_cast<long long>(v) * D + d0 + r) * H + j
                  : static_cast<long long>(v) * H + j;
      return r >= dt;
    }
    const int j = o / cn, q = o - j * cn;
    place = (j < H ? j : hp) * W2_CLASSES + q;
    at = j < H ? (static_cast<long long>(v) * H + j) * C + c0 + q
               : static_cast<long long>(v) * C + c0 + q;
    return j >= H;
  };
  float* pw = w1_role ? w1 : w2;
  float* mw = w1_role ? m1 : m3;
  float* vw = w1_role ? v1 : v3;
  float* pb = w1_role ? b1 : b2;
  float* mb = w1_role ? m2 : m4;
  float* vb = w1_role ? v2 : v4;
  for (int o = t; o < n_out; o += GRAD_THREADS) {
    int place;
    long long at;
    const bool bias = where(o, place, at);
    cp_async4(sp + o, (bias ? pb : pw) + at, 4);
    cp_async4(sm + o, (bias ? mb : mw) + at, 4);
    cp_async4(sv + o, (bias ? vb : vw) + at, 4);
  }
  const float bc1 = bc1s[step], bc2 = bc2s[step], lr = scal[0];
  __syncthreads();  // the barrier's initialisation

  if (k == 0 && v == 0 && warp == GRAD_WARPS - 1) {
    // the loss: the masked EDL mean over B*V rows with the extra / V, plus
    // gamma_t * fused * the masked DC mean; lane-strided sums, then a butterfly
    float edl_sum = 0.0f, dc_sum = 0.0f;
    for (int i = lane; i < n_loss; i += WARP) {
      edl_sum += partials[2 * i];
      dc_sum += partials[2 * i + 1];
    }
    edl_sum = warp_sum(edl_sum);
    dc_sum = warp_sum(dc_sum);
    if (lane == 0) {
      const float msum = partials[2 * n_loss];
      const float vf = static_cast<float>(V);
      *loss_out = edl_sum / fmaxf(msum * vf, 1.0f) / vf +
                  scal[2] * (dc_sum / fmaxf(msum, 1.0f)) * fused;
    }
  }

  // brings chunk `chunk` in (hs by one bulk copy, or 4-byte copies into the
  // padded layout; x's columns by cp.async; dz by one bulk copy where whole)
  // and returns its number of rows
  const float* xv = x + static_cast<long long>(v) * B * D;
  const float* dzv = dz + static_cast<long long>(v) * B * C;
  const bool xquad = D % 4 == 0 && (reinterpret_cast<u64>(xv) & 15) == 0;
  unsigned phase = 0;
  auto stage = [&](int chunk) {
    const int r0 = chunk * bc, rows = min(bc, B - r0);
    const bool obulk = !w1_role && (rows * C) % 4 == 0 &&
                       (reinterpret_cast<u64>(dzv + static_cast<long long>(r0) * C) & 15) == 0;
    const unsigned hbytes = hbulk ? 4u * rows * H : 0u;
    const unsigned obytes = obulk ? 4u * rows * C : 0u;
    if (t == 0 && hbytes + obytes > 0) {
      mbar_expect(&bar, hbytes + obytes);
      if (hbytes) bulk_copy(hs, hsrc + static_cast<long long>(r0) * H, hbytes, &bar);
      if (obytes) bulk_copy(os, dzv + static_cast<long long>(r0) * C, obytes, &bar);
    }
    if (!hbulk) copy_rows4(hs, hsrc, r0, rows, H, hp, t);
    if (w1_role && xquad) {
      // x[r0 + r][d0 .. d0 + 4): one 16-byte unit a row
      for (int r = t; r < rows; r += GRAD_THREADS)
        cp_async16(os + W1_ROWS * r, xv + static_cast<long long>(r0 + r) * D + d0, 16);
    } else if (w1_role) {
      for (int i = t; i < rows * W1_ROWS; i += GRAD_THREADS) {
        const int r = i / W1_ROWS, d = d0 + (i - r * W1_ROWS);
        const bool ok = d < D;
        cp_async4(os + i, ok ? xv + static_cast<long long>(r0 + r) * D + d : xv, ok ? 4 : 0);
      }
    } else if (!obulk) {
      copy_rows4(os, dzv, r0, rows, C, C, t);
    }
    cp_async_wait_all();
    if (hbytes + obytes > 0) {
      mbar_wait(&bar, phase);
      phase ^= 1u;
    }
    __syncthreads();
    return rows;
  };

  // Each lane's register tile over this warp's rows (r = warp, warp + 8, ...),
  // units 4 lane .. 4 lane + 3: acc[a][u] is dW1[d0 + a][4 lane + u] or
  // dW2[4 lane + u][c0 + a], bacc the bias sums of the float4s read
  float acc[4][4], bacc[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    bacc[a] = 0.0f;
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[a][u] = 0.0f;
  }
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    if (chunk > 0) __syncthreads();  // every warp is done with the last chunk
    const int rows = stage(chunk);
    if (4 * lane >= hp) continue;
    for (int r = warp; r < rows; r += GRAD_WARPS) {
      if (w1_role) {
        const float4 g = *reinterpret_cast<const float4*>(hs + r * hp + 4 * lane);
        const float4 xq = *reinterpret_cast<const float4*>(os + W1_ROWS * r);
        const float xr[4] = {xq.x, xq.y, xq.z, xq.w};
        bacc[0] += g.x;
        bacc[1] += g.y;
        bacc[2] += g.z;
        bacc[3] += g.w;
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          acc[a][0] = fmaf(xr[a], g.x, acc[a][0]);
          acc[a][1] = fmaf(xr[a], g.y, acc[a][1]);
          acc[a][2] = fmaf(xr[a], g.z, acc[a][2]);
          acc[a][3] = fmaf(xr[a], g.w, acc[a][3]);
        }
      } else {
        const float4 h = *reinterpret_cast<const float4*>(hs + r * hp + 4 * lane);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float d = a < cn ? os[r * C + c0 + a] : 0.0f;  // a broadcast
          bacc[a] += d;
          acc[a][0] = fmaf(h.x, d, acc[a][0]);
          acc[a][1] = fmaf(h.y, d, acc[a][1]);
          acc[a][2] = fmaf(h.z, d, acc[a][2]);
          acc[a][3] = fmaf(h.w, d, acc[a][3]);
        }
      }
    }
  }

  // the warps' tiles meet in shared memory, over the operands, and are
  // added in warp order; the epilogue's p, m, v came with the staging
  // (cp_async_wait_all), each thread reading only its own
  __syncthreads();
  float* mine = part + warp * tile;
  if (4 * lane < hp) {
    if (w1_role) {
#pragma unroll
      for (int a = 0; a < 4; ++a)
        *reinterpret_cast<float4*>(mine + a * hp + 4 * lane) =
            make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
      *reinterpret_cast<float4*>(mine + W1_ROWS * hp + 4 * lane) =
          make_float4(bacc[0], bacc[1], bacc[2], bacc[3]);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        *reinterpret_cast<float4*>(mine + (4 * lane + u) * W2_CLASSES) =
            make_float4(acc[0][u], acc[1][u], acc[2][u], acc[3][u]);
      if (lane == 0)
        *reinterpret_cast<float4*>(mine + hp * W2_CLASSES) =
            make_float4(bacc[0], bacc[1], bacc[2], bacc[3]);
    }
  }
  __syncthreads();
  for (int o = t; o < n_out; o += GRAD_THREADS) {
    int place;
    long long at;
    const bool bias = where(o, place, at);
    float g = 0.0f;
#pragma unroll
    for (int w = 0; w < GRAD_WARPS; ++w) g += part[w * tile + place];
    float pn = sp[o], mn = sm[o], vn = sv[o];
    adamw(pn, mn, vn, g, bc1, bc2, lr, wd);
    (bias ? pb : pw)[at] = pn;
    (bias ? mb : mw)[at] = mn;
    (bias ? vb : vw)[at] = vn;
  }
}

// dynamic shared memory above 48 KB needs the kernel's opt-in
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, int max_bytes) {
  if (bytes > static_cast<size_t>(max_bytes)) return cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

extern "C" {

// xs (S, V, B, D), drops (S, V, B, H) or null (no dropout), yohs (S, B, C),
// rmasks (S, B, 1), bc1s/bc2s (S, 1), scal = [lr, coef, gamma_t]; params,
// moments and second moments (w1 (V, D, H), b1 (V, H), w2 (V, H, C),
// b2 (V, C)) are updated in place; losses (S,); hd, dh (V, B, H), zbuf
// (V, B, C: the logits, then dL/dz) and partials (2 * ceil(B / LOSS_ROWS)
// + 1 floats; 2 B + 1 always suffice) are scratch. All float32, contiguous,
// on one device.
// Launches on `stream` and returns the first CUDA error (0 when none).
int dmf_probe_epoch(const void* xs, const void* drops, const void* yohs, const void* rmasks,
                    const void* bc1s, const void* bc2s, const void* scal, void* w1, void* b1,
                    void* w2, void* b2, void* m1, void* m2, void* m3, void* m4, void* v1,
                    void* v2, void* v3, void* v4, void* losses, void* hd, void* zbuf,
                    void* dh, void* partials, int S, int V, int B, int D, int H, int C,
                    float inv_keep, float fused, float wd, float lgamma_c, void* stream) {
  if (V < 1 || V > MAXV || B < 1 || D < 1 || H < 1 || H > MAX_HIDDEN || C < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int device = 0, max_smem = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  // W2 of all views goes to the loss kernel's shared memory in one bulk copy
  // where it is whole 16-byte units and the block stays small enough for two
  // blocks an SM
  const bool stage_w2 =
      (static_cast<long long>(V) * H * C) % 4 == 0 && (reinterpret_cast<size_t>(w2) & 15) == 0 &&
      sizeof(float) * loss_smem_floats(V, H, C, true) <= LOSS_W2_SMEM;
  const size_t fwd_smem = sizeof(float) * fwd_smem_floats(D, H, C);
  const size_t loss_smem = sizeof(float) * loss_smem_floats(V, H, C, stage_w2);
  const int n_w1 = (D + W1_ROWS - 1) / W1_ROWS;
  const int n_w2 = (C + W2_CLASSES - 1) / W2_CLASSES;
  const size_t grad_smem = sizeof(float) * grad_smem_floats(B, H, C);
  if ((e = allow_smem(forward_kernel, fwd_smem, max_smem)) != cudaSuccess ||
      (e = allow_smem(loss_dh_kernel, loss_smem, max_smem)) != cudaSuccess ||
      (e = allow_smem(grad_adamw_kernel, grad_smem, max_smem)) != cudaSuccess)
    return static_cast<int>(e);
  const dim3 fwd_grid((B + FWD_ROWS - 1) / FWD_ROWS, V);
  const int n_loss = (B + LOSS_ROWS - 1) / LOSS_ROWS;
  const dim3 loss_block(WARP, V, LOSS_ROWS);
  const dim3 grad_grid(n_w1 + n_w2, V);
  float* pp = static_cast<float*>(partials);
  const float* x0 = static_cast<const float*>(xs);
  const float* d0 = static_cast<const float*>(drops);
  const float* y0 = static_cast<const float*>(yohs);
  const float* r0 = static_cast<const float*>(rmasks);
  float* hdp = static_cast<float*>(hd);
  float* zp = static_cast<float*>(zbuf);
  float* dhp = static_cast<float*>(dh);
  const long long vb = static_cast<long long>(V) * B;
  for (int s = 0; s < S; ++s) {
    forward_kernel<<<fwd_grid, FWD_THREADS, fwd_smem, st>>>(
        x0 + s * vb * D, d0 == nullptr ? nullptr : d0 + s * vb * H,
        static_cast<const float*>(w1), static_cast<const float*>(b1),
        static_cast<const float*>(w2), static_cast<const float*>(b2), hdp, zp, B, D, H, C,
        inv_keep);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    loss_dh_kernel<<<n_loss, loss_block, loss_smem, st>>>(
        zp, y0 + static_cast<long long>(s) * B * C, r0 + static_cast<long long>(s) * B,
        static_cast<const float*>(scal), pp, hdp, static_cast<const float*>(w2), dhp, V, B, H,
        C, fused, lgamma_c, inv_keep, stage_w2 ? 1 : 0);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    grad_adamw_kernel<<<grad_grid, GRAD_THREADS, grad_smem, st>>>(
        x0 + s * vb * D, hdp, zp, dhp, static_cast<float*>(w1), static_cast<float*>(b1),
        static_cast<float*>(w2), static_cast<float*>(b2), static_cast<float*>(m1),
        static_cast<float*>(m2), static_cast<float*>(m3), static_cast<float*>(m4),
        static_cast<float*>(v1), static_cast<float*>(v2), static_cast<float*>(v3),
        static_cast<float*>(v4), static_cast<const float*>(bc1s),
        static_cast<const float*>(bc2s), static_cast<const float*>(scal), s, B, D, H, C, wd,
        n_w1, pp, n_loss, V, fused, static_cast<float*>(losses) + s);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

const char* dmf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
