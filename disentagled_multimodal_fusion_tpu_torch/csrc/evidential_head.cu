// Evidential-head forward for V stacked heads in one launch, f32 throughout.
//
//   out[b, v, :] = evidence(relu(x[v, b, :] W1[v] + b1[v]) W2[v] + b2[v])
//   evidence(z)  = exp(z' + ln 1e13 - logaddexp(z', ln 1e13)),  z' = clip(z, -10, 10)
//
// Replaces the Pallas TPU kernel evidential_head_fused / evidential_heads_stacked
// (disentagled_multimodal_fusion_tpu/ops/pallas_kernels.py:53-105).
//
// Bound on an H100: at the serving shape (B=256, V=7, D=200, H=128, C=10) the
// work is 96.3 MFLOP of f32 FMA (1.44 us at 67 TFLOP/s, no tensor cores since
// TF32 is off) against ~2.26 MB of traffic (0.68 us at 3.35 TB/s), so f32
// compute bounds it; at B=1 the weights dominate and it is bound by bytes.
// At these sizes launch latency dominates both.
//
// Design: grid (ceil(B / TB), V). A block stages TB rows of x in shared memory
// in chunks of KD columns; each thread owns one hidden unit and accumulates
// the TB rows in registers while streaming its column of W1 (neighbouring
// threads read neighbouring addresses). relu(h) stays in shared memory, never
// in device memory; the second product and the evidence epilogue read it from
// there. Rows past B are masked; x is read through its row and view strides so
// the probe's (B, V, D) stack needs no transpose copy. Any D, H and C work.
// The C entry point returns cudaGetLastError() so the caller can raise.

#include <cuda_runtime.h>

namespace {

constexpr int TB = 8;         // batch rows per block
constexpr int KD = 256;       // input columns staged per pass
constexpr int THREADS = 128;  // one hidden unit per thread per pass

__device__ __forceinline__ float evidence(float z) {
  const float kLog1e13 = 29.933606208922594f;  // 13 * ln(10)
  z = fminf(fmaxf(z, -10.0f), 10.0f);
  // logaddexp(z, L) = max + log1p(exp(-|z - L|)), as torch and XLA compute it
  const float lse = fmaxf(z, kLog1e13) + log1pf(expf(-fabsf(z - kLog1e13)));
  return expf((z + kLog1e13) - lse);
}

__global__ void __launch_bounds__(THREADS)
evidential_heads_kernel(const float* __restrict__ x, long long sxv, long long sxb,
                        const float* __restrict__ w1, const float* __restrict__ b1,
                        const float* __restrict__ w2, const float* __restrict__ b2,
                        float* __restrict__ out, int V, int B, int D, int H, int C) {
  extern __shared__ float smem[];
  float* xs = smem;             // [TB][KD]
  float* hs = smem + TB * KD;   // [TB][H + 1], padded against bank conflicts
  const int hs_stride = H + 1;

  const int v = blockIdx.y;
  const long long b0 = static_cast<long long>(blockIdx.x) * TB;
  const int rows = static_cast<int>(min(static_cast<long long>(TB), B - b0));
  const float* xv = x + v * sxv + b0 * sxb;
  const float* w1v = w1 + static_cast<long long>(v) * D * H;
  const float* w2v = w2 + static_cast<long long>(v) * H * C;

  // h = relu(x W1 + b1) for this block's rows, into shared memory
  for (int j0 = 0; j0 < H; j0 += THREADS) {
    const int j = j0 + threadIdx.x;
    float acc[TB];
#pragma unroll
    for (int r = 0; r < TB; ++r) acc[r] = 0.0f;
    for (int d0 = 0; d0 < D; d0 += KD) {
      const int kd = min(KD, D - d0);
      __syncthreads();  // the previous chunk's readers are done with xs
      for (int i = threadIdx.x; i < TB * KD; i += THREADS) {
        const int r = i / KD;
        const int d = i - r * KD;
        xs[i] = (r < rows && d < kd) ? xv[r * sxb + d0 + d] : 0.0f;
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
#pragma unroll
      for (int r = 0; r < TB; ++r) hs[r * hs_stride + j] = fmaxf(acc[r] + bj, 0.0f);
    }
  }
  __syncthreads();

  // logits = h W2 + b2, then the evidence epilogue, one (row, class) per thread
  for (int i = threadIdx.x; i < rows * C; i += THREADS) {
    const int r = i / C;
    const int c = i - r * C;
    const float* hr = hs + r * hs_stride;
    float acc = 0.0f;
    for (int k = 0; k < H; ++k) acc = fmaf(hr[k], w2v[static_cast<long long>(k) * C + c], acc);
    const float z = acc + b2[static_cast<long long>(v) * C + c];
    out[((b0 + r) * V + v) * C + c] = evidence(z);
  }
}

}  // namespace

extern "C" {

// x: V heads of B rows, element (v, b, d) at x[v * sxv + b * sxb + d].
// w1 (V, D, H), b1 (V, H), w2 (V, H, C), b2 (V, C) contiguous; out (B, V, C)
// contiguous. Launches on `stream` and returns cudaGetLastError().
int dmf_evidential_heads(const void* x, long long sxv, long long sxb, const void* w1,
                         const void* b1, const void* w2, const void* b2, void* out,
                         int V, int B, int D, int H, int C, void* stream) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(TB) * KD +
                                       static_cast<size_t>(TB) * (H + 1));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        evidential_heads_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((B + TB - 1) / TB, V);
  evidential_heads_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), sxv, sxb, static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<float*>(out), V, B, D, H, C);
  return static_cast<int>(cudaGetLastError());
}

const char* dmf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
