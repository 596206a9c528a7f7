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
// products over the B rows.
//
// Bound on an H100 at V=7, B=100, D=200, H=128, C=10, S=16: ~79 MFLOP of f32
// per step (1.26 GFLOP per epoch, 19 us at 67 TFLOP/s) against 19 MB per
// epoch with each input read once and the state (p, m, v of 7 heads, 2.3 MB)
// read and written once (6 us at 3.35 TB/s): bound by operations. The state
// does not fit one SM's shared memory, so here it stays in device memory
// (and L2) and is read and written every step (87 MB per epoch, 26 us).
//
// Design: the C entry point loops over the S steps on the host and launches
// four kernels per step on the caller's stream:
//   1. forward, grid (row tiles, V): x tile in shared memory, one hidden
//      unit per thread, hd kept in shared memory for the second product;
//      writes hd and z to scratch;
//   2. loss, grid (row tiles): a (row, view) pair per thread; the views of a
//      row share their alpha sums through shared memory for the DC term;
//      overwrites z with dL/dz and writes each block's partial sums;
//   3. dh = (dz W2^T) * (hd > 0) * 1/keep, grid (row tiles, V); its first
//      thread also adds up the loss kernel's partial sums into the loss;
//   4. gradient + AdamW over parameter tiles: W1 rows in tiles of 8 with x
//      staged in shared memory, W2 elements one per thread, biases in one
//      block; each updates p, m, v in place.
// W2 is read by step 3 and written by step 4 of the same optimizer step, so
// the two are separate launches. Any V <= 8, D, H, C and B work; rows with
// rmask 0 (the padded tail) contribute nothing. Each launch is checked with
// cudaGetLastError() and the entry point returns the first error.

#include <cuda_runtime.h>

namespace {

constexpr int MAXV = 8;
constexpr int TB = 8;             // rows per forward / dh block
constexpr int KD = 256;           // input columns staged per forward pass
constexpr int THREADS = 128;
constexpr int LOSS_ROWS = 16;     // rows per loss block
constexpr int LOSS_THREADS = LOSS_ROWS * MAXV;
constexpr int DT = 8;             // W1 rows per gradient block
constexpr int BT = 128;           // batch rows staged per gradient pass
constexpr float kLog1e13 = 29.933606208922594f;  // 13 ln 10
constexpr float kB1 = 0.9f, kB2 = 0.999f;
constexpr float kOneMinusB1 = 0.1f, kOneMinusB2 = 0.001f;
constexpr float kEps = 1e-8f, kDcEps = 1e-8f;

// ---- Stirling series (ops/special.py), shifted by 8 ----
__device__ __forceinline__ float digamma_s(float x) {
  const float z = x + 8.0f;
  float shift = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) shift += 1.0f / (x + static_cast<float>(k));
  const float rz = 1.0f / z, rz2 = rz * rz;
  const float series = rz2 * (-1.0f / 12.0f + rz2 * (1.0f / 120.0f - rz2 * (1.0f / 252.0f)));
  return logf(z) - 0.5f * rz + series - shift;
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

__device__ __forceinline__ float trigamma_s(float x) {
  const float z = x + 8.0f;
  float shift = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float r = 1.0f / (x + static_cast<float>(k));
    shift += r * r;
  }
  const float rz = 1.0f / z, rz2 = rz * rz;
  return rz + rz2 * (0.5f + rz * (1.0f / 6.0f + rz2 * (-1.0f / 30.0f + rz2 * (1.0f / 42.0f)))) +
         shift;
}

__device__ __forceinline__ float clip10(float z) { return fminf(fmaxf(z, -10.0f), 10.0f); }

// saturated evidence of a clipped logit: exp(z + L - logaddexp(z, L))
__device__ __forceinline__ float evidence(float zc) {
  const float lse = fmaxf(zc, kLog1e13) + log1pf(expf(-fabsf(zc - kLog1e13)));
  return expf((zc + kLog1e13) - lse);
}

__device__ __forceinline__ void adamw(float* p, float* m, float* v, float g, float bc1, float bc2,
                                      float lr, float wd) {
  const float mn = kB1 * *m + kOneMinusB1 * g;
  const float vn = kB2 * *v + kOneMinusB2 * (g * g);
  *m = mn;
  *v = vn;
  float upd = (mn / bc1) / (sqrtf(vn / bc2) + kEps);
  if (wd > 0.0f) upd = upd + wd * *p;
  *p = *p - lr * upd;
}

// sum over the block; every thread gets the result. red holds blockDim.x floats.
__device__ float block_sum(float value, float* red) {
  __syncthreads();
  red[threadIdx.x] = value;
  __syncthreads();
  for (int stride = blockDim.x / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) red[threadIdx.x] += red[threadIdx.x + stride];
    __syncthreads();
  }
  const float total = red[0];
  __syncthreads();
  return total;
}

// 1. forward: hd = dropout(relu(x W1 + b1)) and z = hd W2 + b2
__global__ void __launch_bounds__(THREADS)
forward_kernel(const float* __restrict__ x, const float* __restrict__ drop,
               const float* __restrict__ w1, const float* __restrict__ b1,
               const float* __restrict__ w2, const float* __restrict__ b2,
               float* __restrict__ hd, float* __restrict__ zbuf, int B, int D, int H, int C,
               float inv_keep) {
  extern __shared__ float smem[];
  float* xs = smem;             // [TB][KD]
  float* hs = smem + TB * KD;   // [TB][H + 1]
  const int hs_stride = H + 1;
  const int v = blockIdx.y;
  const int b0 = blockIdx.x * TB;
  const int rows = min(TB, B - b0);
  const float* xv = x + (static_cast<long long>(v) * B + b0) * D;
  const float* w1v = w1 + static_cast<long long>(v) * D * H;
  const float* w2v = w2 + static_cast<long long>(v) * H * C;
  const long long hrow0 = static_cast<long long>(v) * B + b0;  // row of (v, b0) in (V*B, .)

  for (int j0 = 0; j0 < H; j0 += THREADS) {
    const int j = j0 + threadIdx.x;
    float acc[TB];
#pragma unroll
    for (int r = 0; r < TB; ++r) acc[r] = 0.0f;
    for (int d0 = 0; d0 < D; d0 += KD) {
      const int kd = min(KD, D - d0);
      __syncthreads();
      for (int i = threadIdx.x; i < TB * KD; i += THREADS) {
        const int r = i / KD;
        const int d = i - r * KD;
        xs[i] = (r < rows && d < kd) ? xv[static_cast<long long>(r) * D + d0 + d] : 0.0f;
      }
      __syncthreads();
      if (j < H) {
        const float* wcol = w1v + static_cast<long long>(d0) * H + j;
        for (int d = 0; d < kd; ++d) {
          const float w = wcol[static_cast<long long>(d) * H];
#pragma unroll
          for (int r = 0; r < TB; ++r) acc[r] = fmaf(xs[r * KD + d], w, acc[r]);
        }
      }
    }
    if (j < H) {
      const float bj = b1[static_cast<long long>(v) * H + j];
      for (int r = 0; r < rows; ++r) {
        float h = fmaxf(acc[r] + bj, 0.0f);
        const long long at = (hrow0 + r) * H + j;
        if (drop != nullptr) h = (h * drop[at]) * inv_keep;
        hs[r * hs_stride + j] = h;
        hd[at] = h;
      }
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < rows * C; i += THREADS) {
    const int r = i / C;
    const int c = i - r * C;
    const float* hr = hs + r * hs_stride;
    float acc = 0.0f;
    for (int k = 0; k < H; ++k) acc = fmaf(hr[k], w2v[static_cast<long long>(k) * C + c], acc);
    zbuf[(hrow0 + r) * C + c] = acc + b2[static_cast<long long>(v) * C + c];
  }
}

// d|p_i - p_j| / dp_i for the pair taken in the order (min, max), with JAX's
// gradient of +1 for abs at 0
__device__ __forceinline__ float abs_grad(float pi, float pj, bool i_first) {
  const float diff = i_first ? pi - pj : pj - pi;
  const float s = diff >= 0.0f ? 1.0f : -1.0f;
  return i_first ? s : -s;
}

// 2. dL/dz for all views of the block's rows, and the block's partial sums
// (EDL, DC) at partials[2 * block]; block 0 also writes sum(rmask) at
// partials[2 * gridDim.x]
__global__ void __launch_bounds__(LOSS_THREADS)
loss_kernel(float* __restrict__ zbuf, float* __restrict__ abuf, const float* __restrict__ yoh,
            const float* __restrict__ rmask, const float* __restrict__ scal,
            float* __restrict__ partials, int V, int B, int C, float fused, float lgamma_c) {
  __shared__ float red[LOSS_THREADS];
  __shared__ float s_sh[LOSS_ROWS][MAXV];
  __shared__ float u_sh[LOSS_ROWS][MAXV];
  const int r = threadIdx.x / MAXV;
  const int v = threadIdx.x % MAXV;
  const float coef = scal[1];
  const float gamma_t = scal[2];
  const float cf = static_cast<float>(C);
  const float vf = static_cast<float>(V);

  float part = 0.0f;
  for (int b = threadIdx.x; b < B; b += LOSS_THREADS) part += rmask[b];
  const float msum = block_sum(part, red);
  const float denom_e = fmaxf(msum * vf, 1.0f);
  const float dc_scale = gamma_t * fused / static_cast<float>(max(1, V - 1)) / fmaxf(msum, 1.0f);

  float edl_acc = 0.0f, dc_acc = 0.0f;
  {
    const int b = blockIdx.x * LOSS_ROWS + r;
    const bool active = b < B && v < V;
    const float rb = b < B ? rmask[b] : 0.0f;
    float* zr = zbuf + (static_cast<long long>(v) * B + b) * C;
    float* ar = abuf + (static_cast<long long>(v) * B + b) * C;
    const float* yr = yoh + static_cast<long long>(b) * C;

    // phase 1: alpha, the EDL row term and the row sums of this view
    float S = 0.0f, Skl = 0.0f, T = 0.0f, Y = 0.0f;
    if (active) {
      for (int c = 0; c < C; ++c) {
        const float a = evidence(clip10(zr[c])) + 1.0f;
        ar[c] = a;
        S += a;
      }
      const float psi_s = digamma_s(S);
      float a_term = 0.0f;
      for (int c = 0; c < C; ++c) {
        const float y = yr[c];
        const float kl = (ar[c] - 1.0f) * (1.0f - y) + 1.0f;
        if (y != 0.0f) a_term += y * (psi_s - digamma_s(ar[c]));
        Skl += kl;
        T += kl - 1.0f;
        Y += y;
      }
      const float psi_skl = digamma_s(Skl);
      float lg_sum = 0.0f, second = 0.0f;
      for (int c = 0; c < C; ++c) {
        const float kl = (ar[c] - 1.0f) * (1.0f - yr[c]) + 1.0f;
        lg_sum += gammaln_s(kl);
        second += (kl - 1.0f) * (digamma_s(kl) - psi_skl);
      }
      const float first = gammaln_s(Skl) - lg_sum - lgamma_c;
      edl_acc += (a_term + coef * (first + second)) * rb;
      s_sh[r][v] = S;
      u_sh[r][v] = cf / (S + kDcEps);
    }
    __syncthreads();

    // phase 2: the DC term of the row, and dL/dz of this view
    if (active) {
      const float se = S + kDcEps;
      const float ui = u_sh[r][v];
      float gu = 0.0f, dc_part = 0.0f;
      for (int j = 0; j < V; ++j) {
        if (j == v) continue;
        const float sej = s_sh[r][j] + kDcEps;
        const float* aj = abuf + (static_cast<long long>(j) * B + b) * C;
        float pd = 0.0f;
        for (int c = 0; c < C; ++c) pd += fabsf(ar[c] / se - aj[c] / sej);
        pd *= 0.5f;
        const float uj = u_sh[r][j];
        if (j > v) dc_part += 2.0f * pd * ((1.0f - ui) * (1.0f - uj));
        gu += -2.0f * pd * (1.0f - uj);
      }
      dc_acc += dc_part / static_cast<float>(max(1, V - 1)) * rb;

      if (rb != 0.0f) {
        const float ke = rb / denom_e / vf;
        const float kd = dc_scale * rb;
        const float psi1_s = trigamma_s(S);
        const float psi1_skl = trigamma_s(Skl);
        // Gp_c for this view, and sum_c Gp_c alpha_c
        float gpa = 0.0f;
        for (int c = 0; c < C; ++c) {
          const float pi = ar[c] / se;
          float gp = 0.0f;
          for (int j = 0; j < V; ++j) {
            if (j == v) continue;
            const float sej = s_sh[r][j] + kDcEps;
            const float pj = abuf[(static_cast<long long>(j) * B + b) * C + c] / sej;
            gp += ((1.0f - ui) * (1.0f - u_sh[r][j])) * abs_grad(pi, pj, v < j);
          }
          gpa += gp * ar[c];
        }
        for (int c = 0; c < C; ++c) {
          const float a = ar[c];
          const float y = yr[c];
          const float pi = a / se;
          float gp = 0.0f;
          for (int j = 0; j < V; ++j) {
            if (j == v) continue;
            const float sej = s_sh[r][j] + kDcEps;
            const float pj = abuf[(static_cast<long long>(j) * B + b) * C + c] / sej;
            gp += ((1.0f - ui) * (1.0f - u_sh[r][j])) * abs_grad(pi, pj, v < j);
          }
          float dedl = Y * psi1_s;
          if (y != 0.0f) dedl -= y * trigamma_s(a);
          const float kl = (a - 1.0f) * (1.0f - y) + 1.0f;
          dedl += coef * (1.0f - y) * ((kl - 1.0f) * trigamma_s(kl) - T * psi1_skl);
          const float ddc = gp / se - (gpa + cf * gu) / (se * se);
          const float dalpha = ke * dedl + kd * ddc;
          const float z = zr[c];
          const float zc = clip10(z);
          const float az = fabsf(z);
          const float clip_grad = az < 10.0f ? 1.0f : (az == 10.0f ? 0.5f : 0.0f);
          const float sig = 1.0f / (1.0f + expf(zc - kLog1e13));
          zr[c] = dalpha * evidence(zc) * sig * clip_grad;
        }
      } else {
        for (int c = 0; c < C; ++c) zr[c] = 0.0f;
      }
    }
  }

  const float edl_sum = block_sum(edl_acc, red);
  const float dc_sum = block_sum(dc_acc, red);
  if (threadIdx.x == 0) {
    partials[2 * blockIdx.x] = edl_sum;
    partials[2 * blockIdx.x + 1] = dc_sum;
    if (blockIdx.x == 0) partials[2 * gridDim.x] = msum;
  }
}

// 3. dh = (dz W2^T) * relu'(h) * dropout scale, read off hd > 0
__global__ void __launch_bounds__(THREADS)
dh_kernel(const float* __restrict__ dz, const float* __restrict__ hd,
          const float* __restrict__ w2, float* __restrict__ dh, int B, int H, int C,
          float scale, const float* __restrict__ partials, int n_loss_blocks,
          const float* __restrict__ scal, int V, float fused, float* __restrict__ loss_out) {
  extern __shared__ float dzs[];  // [TB][C]
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) {
    // the loss: the masked EDL mean over B*V rows with the extra / V, plus
    // gamma_t * fused * the masked DC mean
    float edl_sum = 0.0f, dc_sum = 0.0f;
    for (int i = 0; i < n_loss_blocks; ++i) {
      edl_sum += partials[2 * i];
      dc_sum += partials[2 * i + 1];
    }
    const float msum = partials[2 * n_loss_blocks];
    const float vf = static_cast<float>(V);
    *loss_out = edl_sum / fmaxf(msum * vf, 1.0f) / vf +
                scal[2] * (dc_sum / fmaxf(msum, 1.0f)) * fused;
  }
  const int v = blockIdx.y;
  const int b0 = blockIdx.x * TB;
  const int rows = min(TB, B - b0);
  const long long row0 = static_cast<long long>(v) * B + b0;
  for (int i = threadIdx.x; i < rows * C; i += THREADS) dzs[i] = dz[row0 * C + i];
  __syncthreads();
  const float* w2v = w2 + static_cast<long long>(v) * H * C;
  for (int j = threadIdx.x; j < H; j += THREADS) {
    const float* wj = w2v + static_cast<long long>(j) * C;
    for (int r = 0; r < rows; ++r) {
      const long long at = (row0 + r) * H + j;
      float acc = 0.0f;
      for (int c = 0; c < C; ++c) acc = fmaf(dzs[r * C + c], wj[c], acc);
      dh[at] = hd[at] > 0.0f ? acc * scale : 0.0f;
    }
  }
}

// 4. gradients over the B rows, then AdamW, in place
__global__ void __launch_bounds__(THREADS)
grad_adam_kernel(const float* __restrict__ x, const float* __restrict__ hd,
                 const float* __restrict__ dz, const float* __restrict__ dh,
                 float* __restrict__ w1, float* __restrict__ b1, float* __restrict__ w2,
                 float* __restrict__ b2, float* __restrict__ m1, float* __restrict__ m2,
                 float* __restrict__ m3, float* __restrict__ m4, float* __restrict__ v1,
                 float* __restrict__ v2, float* __restrict__ v3, float* __restrict__ v4,
                 const float* __restrict__ bc1s, const float* __restrict__ bc2s,
                 const float* __restrict__ scal, int step, int B, int D, int H, int C,
                 float wd, int n_w1_blocks, int n_w2_blocks) {
  __shared__ float xs[BT][DT];
  const int v = blockIdx.y;
  const float bc1 = bc1s[step], bc2 = bc2s[step], lr = scal[0];
  const float* xv = x + static_cast<long long>(v) * B * D;
  const float* hdv = hd + static_cast<long long>(v) * B * H;
  const float* dzv = dz + static_cast<long long>(v) * B * C;
  const float* dhv = dh + static_cast<long long>(v) * B * H;

  if (blockIdx.x < n_w1_blocks) {
    // dW1[d0:d0+DT, :] = x[:, d0:d0+DT]^T dh
    const int d0 = blockIdx.x * DT;
    const int dt = min(DT, D - d0);
    for (int j0 = 0; j0 < H; j0 += THREADS) {
      const int j = j0 + threadIdx.x;
      float acc[DT];
#pragma unroll
      for (int k = 0; k < DT; ++k) acc[k] = 0.0f;
      for (int r0 = 0; r0 < B; r0 += BT) {
        const int rows = min(BT, B - r0);
        __syncthreads();
        for (int i = threadIdx.x; i < BT * DT; i += THREADS) {
          const int r = i / DT;
          const int k = i - r * DT;
          xs[r][k] = (r < rows && k < dt) ? xv[static_cast<long long>(r0 + r) * D + d0 + k] : 0.0f;
        }
        __syncthreads();
        if (j < H) {
          for (int r = 0; r < rows; ++r) {
            const float g = dhv[static_cast<long long>(r0 + r) * H + j];
#pragma unroll
            for (int k = 0; k < DT; ++k) acc[k] = fmaf(xs[r][k], g, acc[k]);
          }
        }
      }
      if (j < H) {
        for (int k = 0; k < dt; ++k) {
          const long long at = (static_cast<long long>(v) * D + d0 + k) * H + j;
          adamw(w1 + at, m1 + at, v1 + at, acc[k], bc1, bc2, lr, wd);
        }
      }
    }
  } else if (blockIdx.x < n_w1_blocks + n_w2_blocks) {
    // dW2[j, c] = sum_b hd[b, j] dz[b, c], one element per thread
    const int e = (blockIdx.x - n_w1_blocks) * THREADS + threadIdx.x;
    if (e < H * C) {
      const int j = e / C;
      const int c = e - j * C;
      float acc = 0.0f;
      for (int b = 0; b < B; ++b)
        acc = fmaf(hdv[static_cast<long long>(b) * H + j], dzv[static_cast<long long>(b) * C + c], acc);
      const long long at = static_cast<long long>(v) * H * C + e;
      adamw(w2 + at, m3 + at, v3 + at, acc, bc1, bc2, lr, wd);
    }
  } else {
    // db1 = sum_b dh, db2 = sum_b dz
    for (int j = threadIdx.x; j < H; j += THREADS) {
      float acc = 0.0f;
      for (int b = 0; b < B; ++b) acc += dhv[static_cast<long long>(b) * H + j];
      const long long at = static_cast<long long>(v) * H + j;
      adamw(b1 + at, m2 + at, v2 + at, acc, bc1, bc2, lr, wd);
    }
    for (int c = threadIdx.x; c < C; c += THREADS) {
      float acc = 0.0f;
      for (int b = 0; b < B; ++b) acc += dzv[static_cast<long long>(b) * C + c];
      const long long at = static_cast<long long>(v) * C + c;
      adamw(b2 + at, m4 + at, v4 + at, acc, bc1, bc2, lr, wd);
    }
  }
}

}  // namespace

extern "C" {

// xs (S, V, B, D), drops (S, V, B, H) or null (no dropout), yohs (S, B, C),
// rmasks (S, B, 1), bc1s/bc2s (S, 1), scal = [lr, coef, gamma_t]; params,
// moments and second moments (w1 (V, D, H), b1 (V, H), w2 (V, H, C),
// b2 (V, C)) are updated in place; losses (S,); hd, dh (V, B, H),
// zbuf, abuf (V, B, C) and partials (2 * ceil(B / 16) + 1) are scratch.
// All float32, contiguous, on one device.
// Launches on `stream` and returns the first CUDA error (0 when none).
int dmf_probe_epoch(const void* xs, const void* drops, const void* yohs, const void* rmasks,
                    const void* bc1s, const void* bc2s, const void* scal, void* w1, void* b1,
                    void* w2, void* b2, void* m1, void* m2, void* m3, void* m4, void* v1,
                    void* v2, void* v3, void* v4, void* losses, void* hd, void* zbuf,
                    void* abuf, void* dh, void* partials, int S, int V, int B, int D,
                    int H, int C,
                    float inv_keep, float fused, float wd, float lgamma_c, void* stream) {
  if (V < 1 || V > MAXV || B < 1 || D < 1 || H < 1 || C < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t fwd_smem = sizeof(float) * (static_cast<size_t>(TB) * KD +
                                           static_cast<size_t>(TB) * (H + 1));
  if (fwd_smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(fwd_smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const size_t dh_smem = sizeof(float) * static_cast<size_t>(TB) * C;
  if (dh_smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        dh_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(dh_smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 row_grid((B + TB - 1) / TB, V);
  const int n_w1 = (D + DT - 1) / DT;
  const int n_w2 = (H * C + THREADS - 1) / THREADS;
  const dim3 grad_grid(n_w1 + n_w2 + 1, V);
  const int n_loss = (B + LOSS_ROWS - 1) / LOSS_ROWS;
  float* pp = static_cast<float*>(partials);
  const float* x0 = static_cast<const float*>(xs);
  const float* d0 = static_cast<const float*>(drops);
  const float* y0 = static_cast<const float*>(yohs);
  const float* r0 = static_cast<const float*>(rmasks);
  float* hdp = static_cast<float*>(hd);
  float* zp = static_cast<float*>(zbuf);
  float* ap = static_cast<float*>(abuf);
  float* dhp = static_cast<float*>(dh);
  const long long vb = static_cast<long long>(V) * B;
  for (int s = 0; s < S; ++s) {
    forward_kernel<<<row_grid, THREADS, fwd_smem, st>>>(
        x0 + s * vb * D, d0 == nullptr ? nullptr : d0 + s * vb * H,
        static_cast<const float*>(w1), static_cast<const float*>(b1),
        static_cast<const float*>(w2), static_cast<const float*>(b2), hdp, zp, B, D, H, C,
        inv_keep);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    loss_kernel<<<n_loss, LOSS_THREADS, 0, st>>>(
        zp, ap, y0 + static_cast<long long>(s) * B * C, r0 + static_cast<long long>(s) * B,
        static_cast<const float*>(scal), pp, V, B, C, fused, lgamma_c);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    dh_kernel<<<row_grid, THREADS, dh_smem, st>>>(
        zp, hdp, static_cast<const float*>(w2), dhp, B, H, C, inv_keep, pp, n_loss,
        static_cast<const float*>(scal), V, fused, static_cast<float*>(losses) + s);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    grad_adam_kernel<<<grad_grid, THREADS, 0, st>>>(
        x0 + s * vb * D, hdp, zp, dhp, static_cast<float*>(w1), static_cast<float*>(b1),
        static_cast<float*>(w2), static_cast<float*>(b2), static_cast<float*>(m1),
        static_cast<float*>(m2), static_cast<float*>(m3), static_cast<float*>(m4),
        static_cast<float*>(v1), static_cast<float*>(v2), static_cast<float*>(v3),
        static_cast<float*>(v4), static_cast<const float*>(bc1s),
        static_cast<const float*>(bc2s), static_cast<const float*>(scal), s, B, D, H, C, wd,
        n_w1, n_w2);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

const char* dmf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
