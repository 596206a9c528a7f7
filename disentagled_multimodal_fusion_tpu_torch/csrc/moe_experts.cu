// The routed experts' grouped product of a mixture-of-experts layer, bf16
// operands with f32 sums, in two launches a layer over one tile table
// (ops/moe_experts.py builds the table and calls both):
//
//   gated: out[r, n] = silu(a[src(r)] . w1[e, n]) * (a[src(r)] . w2[e, n])   (bf16)
//   down:  out[dst(r), n] = scale[r] * (a[r] . w1[e, n])                      (f32)
//
// for every row r of a tile of expert e, src(r) = rows[r] (the token a
// routed row gathers) and dst(r) = dest[r] (the (token, slot) place its
// weighted output goes to), each r itself where the pointer is null.
//
// Replaces no TPU kernel: the JAX package has no expert layer. Added for
// the DeepSeek-V2 text tower (models/text_tower.py), whose MoE layers do
// most of its products and for which no kernel of the port computes a
// grouped product.
//
// Bound on an H100 (SXM; 989 TFLOP/s bf16 dense, 3.35 TB/s): at 16 384
// tokens, top-6, hidden 2048 and expert width 1408 a layer is 1.70 TFLOP
// (1.72 ms) against about 2.3 GB of weights and activations (0.69 ms):
// bound by operations.
//
// Design, first version (right and simple). A block of 8 warps computes one
// tile of 128 rows of one expert (a slot of the table; an idle slot
// returns at once) by 128 weight rows: the down launch's 128 output
// columns, or the gated launch's 64 columns of w1 beside the same 64 of w2,
// so that one thread holds a column's gate and up sums and multiplies them
// as silu(g) u in registers. K comes in steps of 32 through a ring of four
// stages in shared memory, filled by 16-byte cp.async copies (each row
// through its own source pointer: the gather costs nothing extra; rows past
// the tile's end, columns past N and the K tail copy zeros), and multiplied
// with ldmatrix and mma.sync m16n8k16 (each warp 64 rows by 32 weight rows).
// Rows are padded to 40 bf16 in shared memory, so the eight 16-byte rows
// each ldmatrix reads fall in distinct banks. No atomics: every output
// element is written once by one thread, from sums in one fixed order, so
// a run, its graph replay and its next run give the same bits. Not yet:
// wgmma, TMA, a persistent schedule or a staged, coalesced epilogue.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;       // rows a tile (the table's tile size)
constexpr int BN = 128;       // weight rows a tile held in shared memory
constexpr int BK = 32;        // K a stage
constexpr int STAGES = 4;
constexpr int THREADS = 256;  // 8 warps: 2 along the rows x 4 along the weight rows
constexpr int LDS = BK + 8;   // a padded shared-memory row, in bf16
constexpr int SMEM_BYTES = STAGES * (BM + BN) * LDS * 2;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16 bytes from global to shared memory; zeros where bytes is 0
__device__ __forceinline__ void cp_async16(const __nv_bfloat16* dst, const __nv_bfloat16* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
// four 8 x 8 bf16 matrices, one row address per lane (lanes 8 i to 8 i + 7
// give matrix i's rows)
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
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

// Grid (column tiles, slots). GATED: the gated launch (w2 given, out bf16);
// else the down launch (scale given, out f32).
template <bool GATED>
__global__ void __launch_bounds__(THREADS, 2)
    moe_experts_kernel(const __nv_bfloat16* __restrict__ a, const long long* __restrict__ rows,
                       const __nv_bfloat16* __restrict__ w1, const __nv_bfloat16* __restrict__ w2,
                       void* __restrict__ out, const long long* __restrict__ dest,
                       const float* __restrict__ scale, const int* __restrict__ tile_expert,
                       const int* __restrict__ tile_start, const int* __restrict__ tile_end, int N,
                       int K, long long stride_a, long long stride_we, long long stride_wn,
                       long long stride_out) {
  constexpr int OUT_N = GATED ? BN / 2 : BN;  // output columns a tile
  const int slot = blockIdx.y;
  const int expert = tile_expert[slot];
  if (expert < 0) return;  // an idle slot of the static table
  const int start = tile_start[slot], end = tile_end[slot];
  const int n0 = blockIdx.x * OUT_N;

  extern __shared__ __align__(16) unsigned char smem[];
  auto* As = reinterpret_cast<__nv_bfloat16*>(smem);  // [STAGES][BM][LDS]
  auto* Ws = As + STAGES * BM * LDS;                   // [STAGES][BN][LDS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;

  // this thread's copies: rows tid / 4 and tid / 4 + 64 of A and of W, the
  // 8 columns at (tid % 4) 8 of each stage
  const int kc = (tid & 3) * 8;
  const __nv_bfloat16* a_src[2];
  const __nv_bfloat16* w_src[2];
  bool a_ok[2], w_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = (tid >> 2) + i * 64;
    const int r = start + row;
    a_ok[i] = r < end;
    const long long src = a_ok[i] ? (rows ? rows[r] : r) : 0;
    a_src[i] = a + src * stride_a + kc;
    // W row j: w1's column n0 + j, or (gated) w1's n0 + j below 64 and
    // w2's n0 + j - 64 from 64 on
    const __nv_bfloat16* w = (GATED && i == 1) ? w2 : w1;
    const int n = n0 + (GATED ? (tid >> 2) : row);
    w_ok[i] = n < N;
    w_src[i] = w + static_cast<long long>(expert) * stride_we +
               static_cast<long long>(w_ok[i] ? n : 0) * stride_wn + kc;
  }

  const int ktiles = (K + BK - 1) / BK;
  auto load = [&](int stage, int kt) {
    const int k = kt * BK;
    const bool k_ok = k + kc < K;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = (tid >> 2) + i * 64;
      const bool ok_a = a_ok[i] && k_ok, ok_w = w_ok[i] && k_ok;
      cp_async16(As + (stage * BM + row) * LDS + kc, ok_a ? a_src[i] + k : a, ok_a ? 16 : 0);
      cp_async16(Ws + (stage * BN + row) * LDS + kc, ok_w ? w_src[i] + k : w1, ok_w ? 16 : 0);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load(s, s);
    cp_async_commit();
  }
  // the warp's weight rows: two groups of 16 (gated: 16 of w1 and the same
  // 16 of w2, so n-tiles j and j + 2 are one column's gate and up)
  const int w_base0 = GATED ? wn * 16 : wn * 32;
  const int w_base1 = GATED ? 64 + wn * 16 : wn * 32 + 16;
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int next = kt + STAGES - 1;
    if (next < ktiles) load(next % STAGES, next);
    cp_async_commit();
    const __nv_bfloat16* At = As + (kt % STAGES) * BM * LDS;
    const __nv_bfloat16* Wt = Ws + (kt % STAGES) * BN * LDS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      // B fragments of the 4 n-tiles: lanes 0-7 rows 0-7 at k, 8-15 rows
      // 0-7 at k + 8, 16-23 rows 8-15 at k, 24-31 rows 8-15 at k + 8
      const int b_row = (lane & 7) + ((lane >> 4) << 3), b_col = kk + (((lane >> 3) & 1) << 3);
      unsigned b[2][4];
      ldsm_x4(b[0], Wt + (w_base0 + b_row) * LDS + b_col);
      ldsm_x4(b[1], Wt + (w_base1 + b_row) * LDS + b_col);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        unsigned af[4];
        ldsm_x4(af, At + (wm * 64 + i * 16 + (lane & 15)) * LDS + kk + ((lane >> 4) << 3));
        mma_bf16(acc[i][0], af, b[0][0], b[0][1]);
        mma_bf16(acc[i][1], af, b[0][2], b[0][3]);
        mma_bf16(acc[i][2], af, b[1][0], b[1][1]);
        mma_bf16(acc[i][3], af, b[1][2], b[1][3]);
      }
    }
  }
  cp_async_wait<0>();

  // epilogue: c0, c1 at row lane / 4, columns 2 (lane % 4) + {0, 1}; c2, c3
  // at row lane / 4 + 8
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = start + wm * 64 + i * 16 + (lane >> 2) + h * 8;
      if (r >= end) continue;
      if (GATED) {
        auto* o = static_cast<__nv_bfloat16*>(out) + r * stride_out;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = n0 + wn * 16 + j * 8 + 2 * (lane & 3);
          if (col >= N) continue;
          const float g0 = acc[i][j][2 * h], g1 = acc[i][j][2 * h + 1];
          const float u0 = acc[i][j + 2][2 * h], u1 = acc[i][j + 2][2 * h + 1];
          *reinterpret_cast<__nv_bfloat162*>(o + col) = __floats2bfloat162_rn(
              g0 / (1.0f + __expf(-g0)) * u0, g1 / (1.0f + __expf(-g1)) * u1);
        }
      } else {
        const float s = scale[r];
        const long long d = dest ? dest[r] : r;
        auto* o = static_cast<float*>(out) + d * stride_out;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = n0 + wn * 32 + j * 8 + 2 * (lane & 3);
          if (col >= N) continue;
          *reinterpret_cast<float2*>(o + col) =
              make_float2(acc[i][j][2 * h] * s, acc[i][j][2 * h + 1] * s);
        }
      }
    }
  }
}

template <bool GATED>
cudaError_t launch(const void* a, const void* rows, const void* w1, const void* w2, void* out,
                   const void* dest, const void* scale, const void* tile_expert,
                   const void* tile_start, const void* tile_end, int slots, int N, int K,
                   long long stride_a, long long stride_we, long long stride_wn,
                   long long stride_out, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      moe_experts_kernel<GATED>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (attr != cudaSuccess) return attr;
  constexpr int OUT_N = GATED ? BN / 2 : BN;
  const dim3 grid((N + OUT_N - 1) / OUT_N, slots);
  moe_experts_kernel<GATED><<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const long long*>(rows),
      static_cast<const __nv_bfloat16*>(w1), static_cast<const __nv_bfloat16*>(w2), out,
      static_cast<const long long*>(dest), static_cast<const float*>(scale),
      static_cast<const int*>(tile_expert), static_cast<const int*>(tile_start),
      static_cast<const int*>(tile_end), N, K, stride_a, stride_we, stride_wn, stride_out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One launch over `slots` tiles of the table (tile_expert, tile_start,
// tile_end: int32 each, expert -1 for an idle slot) of block_m rows.
// a (rows of K bf16, stride stride_a), w1 and w2 (E, N, K) bf16 with
// strides stride_we and stride_wn; rows and dest int64 or null.
// w2 given: the gated launch, out (M, N) bf16; else the down launch, scale
// (M,) f32 and out f32 rows of stride stride_out. Launches on `stream`
// and returns the launch's error code (cudaErrorInvalidValue for a shape
// or layout it does not take: block_m other than 128, K, N or a stride not
// a multiple of 8, an address not 16-byte aligned, more than 65535 slots).
int dmf_moe_experts(const void* a, const void* rows, const void* w1, const void* w2, void* out,
                    const void* dest, const void* scale, const void* tile_expert,
                    const void* tile_start, const void* tile_end, int slots, int block_m, int N,
                    int K, long long stride_a, long long stride_we, long long stride_wn,
                    long long stride_out, void* stream) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<unsigned long long>(p) % 16 == 0;
  };
  if (block_m != BM || slots <= 0 || slots > 65535 || N <= 0 || K <= 0 || N % 8 || K % 8 ||
      stride_a % 8 || stride_we % 8 || stride_wn % 8 || stride_out % 8 || !aligned(a) ||
      !aligned(w1) || (w2 && !aligned(w2)) || !aligned(out) || (!w2 && !scale))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      w2 ? launch<true>(a, rows, w1, w2, out, dest, scale, tile_expert, tile_start, tile_end,
                        slots, N, K, stride_a, stride_we, stride_wn, stride_out, s)
         : launch<false>(a, rows, w1, w2, out, dest, scale, tile_expert, tile_start, tile_end,
                         slots, N, K, stride_a, stride_we, stride_wn, stride_out, s);
  return static_cast<int>(e);
}

const char* dmf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
