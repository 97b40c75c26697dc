// Banded separable blurs and their adjoints for Hopper (sm_90a).
//
// Replaces four TPU kernels of kornia_tpu/ops/pallas_kernels.py:
//   * fused_separable_blur2d (_blur_kernel_mm2): out = Sv · x · Shᵀ, with
//     Sv and Sh 'same'-correlation operators of 1-D kernels and a border
//     rule (reflect, replicate, circular, constant) folded in;
//   * its adjoint (_mm2_bwd, the same call with Svᵀ and Shᵀ): dx = Svᵀ g Sh;
//   * multi_level_blur (_ml_blur_kernel): every level of a pyramid octave,
//     level_l = SV_l · x · SH_lᵀ, SV_l and SH_l cumulative products of
//     replicate Gaussian band operators (the sequential blur chain); and
//   * its adjoint (_ml_adj_kernel): dx = Σ_l SV_lᵀ g_l SH_l.
// The TPU kernels multiply dense (H, H) and (W, W) operators on the matrix
// unit; at 640 wide about twelve of every thirteen of those products are
// multiplications by zero.
//
// What bounds it on the card: at the two-view path's and the SSIM loss's
// shapes every function here is bound by its bytes (one read of x or of
// the L gradients, one write per output); the taps are few (15 + 15 for
// the first-level blur, 11 + 11 for SSIM, 5 + 5 for pyrdown).
//
// What the design does about it: it never touches an operator entry that
// is zero. separable_blur reads the 1-D kernels themselves and computes
// each tap's source index under the border rule, as the operator folds it
// (kornia_tpu_torch/ops/kernels.py::_fold_taps is the same rule in
// torch); its anchor (the tap that lands on the output pixel) is an
// argument, so the adjoint of a constant or circular blur is the same
// kernel run with flipped taps. banded_blur reads each operator as a band:
// per output row (or column) a start index and K_l consecutive weights,
// stored tap-major (L, Kmax, size) so that the threads of a warp read
// neighbouring weights; level l loops over its own K_l taps only. Entries
// of an operator outside its band are exact zeros, so the sum over the band
// is the dense product. The transposed operators of a reflect or replicate
// blur, and the transposed cumulative operators, are banded with the same
// half-widths (their first and last columns collect the folded taps), so
// the adjoints read them the same way; banded_blur_adjoint sums the levels
// in its second pass, inside the launch. All run a vertical pass into an
// intermediate, then a horizontal pass; plain FMA loops, simple and exact
// first (shared-memory tiling and fusion of the passes come later).

#include <cuda_runtime.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr int kMaxLevels = 8;

// border rules, numbered as kornia_tpu_torch/ops/kernels.py::_BORDERS
constexpr int kReflect = 0;
constexpr int kReplicate = 1;
constexpr int kCircular = 2;

// source index of tap position t in [0, size) under the border rule, or -1
// where the rule drops the tap (constant zero; a reflection still outside)
__device__ __forceinline__ int border_index(int t, int size, int border) {
    if (border == kReflect) {
        int i = t < 0 ? -t : t;
        if (i >= size) i = 2 * (size - 1) - i;
        return (i >= 0 && i < size) ? i : -1;
    }
    if (border == kReplicate) return min(max(t, 0), size - 1);
    if (border == kCircular) {
        const int i = t % size;
        return i < 0 ? i + size : i;
    }
    return (t >= 0 && t < size) ? t : -1;
}

// tmp[n, i, w] = sum_k ky[k] * x[n, border(i + k - anchor), w]
__global__ void taps_vertical(const float* __restrict__ x,
                              const float* __restrict__ ky,
                              float* __restrict__ tmp, int H, int W, int K,
                              int anchor, int border) {
    const int col = blockIdx.x * blockDim.x + threadIdx.x;
    const int row = blockIdx.y * blockDim.y + threadIdx.y;
    const int n = blockIdx.z;
    if (col >= W || row >= H) return;
    const float* xn = x + (size_t)n * H * W;
    const int t0 = row - anchor;
    float acc = 0.0f;
    for (int k = 0; k < K; ++k) {
        const int src = border_index(t0 + k, H, border);
        if (src >= 0) acc += ky[k] * xn[(size_t)src * W + col];
    }
    tmp[((size_t)n * H + row) * W + col] = acc;
}

// out[n, i, j] = sum_k kx[k] * tmp[n, i, border(j + k - anchor)]
__global__ void taps_horizontal(const float* __restrict__ tmp,
                                const float* __restrict__ kx,
                                float* __restrict__ out, int H, int W, int K,
                                int anchor, int border) {
    const int col = blockIdx.x * blockDim.x + threadIdx.x;
    const int row = blockIdx.y * blockDim.y + threadIdx.y;
    const int n = blockIdx.z;
    if (col >= W || row >= H) return;
    const float* src = tmp + ((size_t)n * H + row) * W;
    const int t0 = col - anchor;
    float acc = 0.0f;
    for (int k = 0; k < K; ++k) {
        const int s = border_index(t0 + k, W, border);
        if (s >= 0) acc += kx[k] * src[s];
    }
    out[((size_t)n * H + row) * W + col] = acc;
}

// taps per level of the vertical and the horizontal bands
struct LevelTaps {
    int v[kMaxLevels];
    int h[kMaxLevels];
};

// tmp[l, n, i, w] = sum_{k < Kv_l} wv[l, k, i] * x[n, sv[l, i] + k, w]
// (one base image for every level: the forward blur), or, with
// kPerLevel, x[l, n, sv[l, i] + k, w] (one gradient per level: the
// adjoint)
template <bool kPerLevel>
__global__ void band_vertical(const float* __restrict__ x,
                              const int* __restrict__ sv,
                              const float* __restrict__ wv,
                              float* __restrict__ tmp, int N, int H, int W,
                              int Kmax, LevelTaps taps) {
    const int col = blockIdx.x * blockDim.x + threadIdx.x;
    const int row = blockIdx.y * blockDim.y + threadIdx.y;
    const int ln = blockIdx.z;  // level * N + image
    if (col >= W || row >= H) return;
    const int l = ln / N;
    const int n = ln - l * N;
    const int img = kPerLevel ? ln : n;
    const float* xn = x + ((size_t)img * H + sv[l * H + row]) * W + col;
    const float* wgt = wv + (size_t)l * Kmax * H + row;
    const int K = taps.v[l];
    float acc = 0.0f;
    for (int k = 0; k < K; ++k) {
        acc += wgt[(size_t)k * H] * xn[(size_t)k * W];
    }
    tmp[((size_t)ln * H + row) * W + col] = acc;
}

// out[l, n, i, j] = sum_{k < Kh_l} wh[l, k, j] * tmp[l, n, i, sh[l, j] + k]
__global__ void band_horizontal(const float* __restrict__ tmp,
                                const int* __restrict__ sh,
                                const float* __restrict__ wh,
                                float* __restrict__ out, int N, int H, int W,
                                int Kmax, LevelTaps taps) {
    const int col = blockIdx.x * blockDim.x + threadIdx.x;
    const int row = blockIdx.y * blockDim.y + threadIdx.y;
    const int ln = blockIdx.z;
    if (col >= W || row >= H) return;
    const int l = ln / N;
    const float* src = tmp + ((size_t)ln * H + row) * W + sh[l * W + col];
    const float* wgt = wh + (size_t)l * Kmax * W + col;
    const int K = taps.h[l];
    float acc = 0.0f;
    for (int k = 0; k < K; ++k) {
        acc += wgt[(size_t)k * W] * src[k];
    }
    out[((size_t)ln * H + row) * W + col] = acc;
}

// out[n, i, j] = sum_l sum_{k < Kh_l} wh[l, k, j] * tmp[l, n, i, sh[l, j] + k]
// (the horizontal pass of the multi-level adjoint, levels summed in order)
__global__ void band_horizontal_sum(const float* __restrict__ tmp,
                                    const int* __restrict__ sh,
                                    const float* __restrict__ wh,
                                    float* __restrict__ out, int L, int N,
                                    int H, int W, int Kmax, LevelTaps taps) {
    const int col = blockIdx.x * blockDim.x + threadIdx.x;
    const int row = blockIdx.y * blockDim.y + threadIdx.y;
    const int n = blockIdx.z;
    if (col >= W || row >= H) return;
    float acc = 0.0f;
    for (int l = 0; l < L; ++l) {
        const float* src = tmp + (((size_t)l * N + n) * H + row) * W
                           + sh[l * W + col];
        const float* wgt = wh + (size_t)l * Kmax * W + col;
        const int K = taps.h[l];
        for (int k = 0; k < K; ++k) {
            acc += wgt[(size_t)k * W] * src[k];
        }
    }
    out[((size_t)n * H + row) * W + col] = acc;
}

dim3 grid_of(int H, int W, int depth) {
    return dim3((W + kBlockX - 1) / kBlockX, (H + kBlockY - 1) / kBlockY,
                depth);
}

// copies the per-level tap counts (host memory) into a kernel argument;
// false if a count is out of range
bool level_taps(const int* kv, const int* kh, int L, int Kv_max, int Kh_max,
                LevelTaps* taps) {
    if (L < 1 || L > kMaxLevels) return false;
    *taps = LevelTaps{};
    for (int l = 0; l < L; ++l) {
        if (kv[l] < 0 || kv[l] > Kv_max || kh[l] < 0 || kh[l] > Kh_max)
            return false;
        taps->v[l] = kv[l];
        taps->h[l] = kh[l];
    }
    return true;
}

}  // namespace

// x (N, H, W); ky (Kv,); kx (Kh,); tmp and out (N, H, W); av, ah the tap
// of each kernel that lands on the output pixel (K / 2 for the blur, K - 1
// - K / 2 for the adjoint's flipped taps); border numbered as above.
// Returns the first CUDA error of the two launches (0 on success).
extern "C" int separable_blur(const float* x, const float* ky,
                              const float* kx, float* tmp, float* out, int N,
                              int H, int W, int Kv, int Kh, int av, int ah,
                              int border, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const dim3 block(kBlockX, kBlockY);
    const dim3 grid = grid_of(H, W, N);
    taps_vertical<<<grid, block, 0, s>>>(x, ky, tmp, H, W, Kv, av, border);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    taps_horizontal<<<grid, block, 0, s>>>(tmp, kx, out, H, W, Kh, ah,
                                           border);
    return static_cast<int>(cudaGetLastError());
}

// x (N, H, W); sv (L, H) and sh (L, W) band starts; wv (L, Kv_max, H) and
// wh (L, Kh_max, W) band weights; kv, kh (L,) taps per level, host memory;
// tmp and out (L, N, H, W). Returns the first CUDA error (0 on success).
extern "C" int banded_blur(const float* x, const int* sv, const float* wv,
                           const int* sh, const float* wh, const int* kv,
                           const int* kh, float* tmp, float* out, int L,
                           int N, int H, int W, int Kv_max, int Kh_max,
                           void* stream) {
    LevelTaps taps;
    if (!level_taps(kv, kh, L, Kv_max, Kh_max, &taps))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const dim3 block(kBlockX, kBlockY);
    const dim3 grid = grid_of(H, W, L * N);
    band_vertical<false><<<grid, block, 0, s>>>(x, sv, wv, tmp, N, H, W,
                                                Kv_max, taps);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    band_horizontal<<<grid, block, 0, s>>>(tmp, sh, wh, out, N, H, W, Kh_max,
                                           taps);
    return static_cast<int>(cudaGetLastError());
}

// g (L, N, H, W); sv, wv, sh, wh the bands of the TRANSPOSED operators
// SV_lᵀ (L, H, H) and SH_lᵀ (L, W, W), laid out as for banded_blur; tmp
// (L, N, H, W); out (N, H, W) = sum_l SV_lᵀ g_l SH_l. Returns the first
// CUDA error (0 on success).
extern "C" int banded_blur_adjoint(const float* g, const int* sv,
                                   const float* wv, const int* sh,
                                   const float* wh, const int* kv,
                                   const int* kh, float* tmp, float* out,
                                   int L, int N, int H, int W, int Kv_max,
                                   int Kh_max, void* stream) {
    LevelTaps taps;
    if (!level_taps(kv, kh, L, Kv_max, Kh_max, &taps))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const dim3 block(kBlockX, kBlockY);
    band_vertical<true><<<grid_of(H, W, L * N), block, 0, s>>>(
        g, sv, wv, tmp, N, H, W, Kv_max, taps);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    band_horizontal_sum<<<grid_of(H, W, N), block, 0, s>>>(
        tmp, sh, wh, out, L, N, H, W, Kh_max, taps);
    return static_cast<int>(cudaGetLastError());
}
