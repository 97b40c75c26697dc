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
// the first-level blur, 11 + 11 for SSIM, 5 + 5 for pyrdown), but the
// multi-level bands are wide (11 to 87 taps an axis), so a kernel that
// loads each tap from L2 is bound by those loads instead.
//
// What the design does about it: it never touches an operator entry that
// is zero. separable_blur reads the 1-D kernels themselves and folds each
// tap's source index by the border rule, as the operator does
// (kornia_tpu_torch/ops/kernels.py::_fold_taps is the same rule in
// torch); its anchor (the tap that lands on the output pixel) is an
// argument, so the adjoint of a constant or circular blur is the same
// kernel run with flipped taps. banded_blur reads each operator as a band:
// per output row (or column) a start index and K_l consecutive weights,
// stored tap-major (L, Kmax, size). Entries of an operator outside its band
// are exact zeros, so the sum over the band is the dense product.
// The blurs and the band adjoints run one tiled kernel (below): a block
// stages its tile's input and halo in shared memory once, runs both passes
// there, and writes each output once, so no intermediate goes through
// device memory and each staged value serves several taps; for
// separable_blur the border rule is applied while the halo is staged and
// never in the tap loops. The transposed operators of a reflect or
// replicate blur, and the transposed cumulative operators, are banded with
// the same half-widths and band starts (their first and last columns
// collect the folded taps), so the adjoint's block reads them as the
// forward reads its bands, one level after another, and sums the levels in
// its registers: dx is written once and no (L, N, H, W) intermediate
// exists (banded_blur_adjoint's tiled route). Two plain passes through an
// intermediate (taps_*, band_*) remain a route of their own, which the
// caller chooses before anything launches: for bands too wide to stage (a
// circular border's) and for grids too small to fill the card. A failed
// tiled launch is returned as an error, never run again as the passes.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr int kMaxLevels = 8;

// border rules, numbered as kornia_tpu_torch/ops/kernels.py::_BORDERS
constexpr int kReflect = 0;
constexpr int kReplicate = 1;
constexpr int kCircular = 2;

// source index of tap position t in [0, size) under the border rule, or -1
// where the rule drops the tap (constant zero). A reflection is repeated
// until it lands inside (numpy's rule), for kernels wider than the image
__device__ __forceinline__ int border_index(int t, int size, int border) {
    if (border == kReflect) {
        const int period = size > 1 ? 2 * (size - 1) : 1;
        int i = t % period;
        if (i < 0) i += period;
        return i >= size ? period - i : i;
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

// ---------------------------------------------------------------------------
// Tiled blur: both passes of one output tile in one block, through shared
// memory. Serves the single blur (taps, the border folded while the halo is
// staged), the multi-level blur (bands, one level per block) and the band
// adjoint (bands of the transposed operators; a block loops over the levels
// and sums them, kSum); the passes above stay for bands too wide to stage
// and for grids too small to fill the card.
//
// A block owns a Tile::H x Tile::W output tile of one image (and level).
// It first stages, with asynchronous copies that are all in flight at once
// (a small tile then costs one round trip to memory, not one per load):
//   * xs: every input row and column the tile's outputs read, once, 16
//     bytes a copy where the rows allow it;
//   * the weights: the 1-D taps, or the band weights of the tile's rows
//     (k, i), tap-major, zero past the level's K;
//   * the band starts of the tile's rows and columns.
// Then the vertical pass writes tmp (the tile's rows over every staged column)
// in shared memory; the bands' column weights (k, j) are staged in xs's place
// (the level sum's short bands: with everything else, in a region of their
// own); the horizontal pass reads tmp and writes each output once (the level
// sum: adds it to the thread's registers, and the block moves on to the next
// level).
// Each thread computes a run of kRun consecutive outputs along the tap axis:
// where the run's band starts are consecutive (every tap of the single blur,
// the interior of a band), a window of kRun staged values slides along the
// taps, so one load serves kRun taps and the run's kRun band weights of a tap
// are two 16-byte loads the whole warp shares; where they are equal (the band
// clamped at an edge), one load per tap serves the run; a run across the clamp
// sums each output alone.
// ---------------------------------------------------------------------------

// a block's tile: output rows and columns, threads
template <int kRows, int kCols, int kThreads>
struct Tile {
    static constexpr int H = kRows;
    static constexpr int W = kCols;
    static constexpr int threads = kThreads;
};
// the single blur on grids of at least two blocks per SM; on smaller grids
// (the pyramid's small levels) a block's serial work, not the card's
// width, sets the time, so the tiles are smaller (the wrapper chooses:
// kornia_tpu_torch/ops/kernels.py::_blocks_per_sm)
using LargeTile = Tile<32, 64, 256>;
using SmallTile = Tile<16, 32, 256>;
// the multi-level blur: a block holds one level of a tile; 512 threads
// share its long band loops. The band adjoint: the same tile in 256
// threads, each thread one output run summed over the levels (in turns on
// an H100 it beat 512 threads and 16 x 64 tiles both at octave 0 and at
// the SSIM shape)
using BandTile = Tile<32, 64, 512>;
using AdjointTile = Tile<32, 64, 256>;
constexpr int kRun = 8;  // outputs per thread along the tap axis

struct TiledArgs {
    const float* x;   // (N, H, W); the adjoint's gradients (L, N, H, W)
    float* out;       // (L, N, H, W); the adjoint's dx (N, H, W)
    int N, H, W, L;
    int vec;          // x and out rows may be copied as 16 bytes
    int vec_wv, vec_wh;  // so may the rows of wv and wh
    // taps (single blur): ky (Kv,), kx (Kh,), anchors, border rule
    const float* ky;
    const float* kx;
    int av, ah, border;
    // bands (multi-level blur): starts (L, H) and (L, W), weights
    // (L, Kv_max, H) and (L, Kh_max, W), taps per level
    const int* sv;
    const float* wv;
    const int* sh;
    const float* wh;
    int Kv_max, Kh_max;
    LevelTaps taps;
    // shared-memory layout (floats), from tiled_geometry()
    // the level sum's bands: hb_apart = the column weights have a region
    // of their own and are staged with everything else, else they take
    // xs's place
    int xpitch, tpitch, off_hb, off_st, off_x, off_tmp, hb_apart;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// asynchronous copy of 16 bytes, zeros where !keep (src is then not read)
__device__ __forceinline__ void copy16(void* dst, const void* src,
                                       bool keep) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(keep ? 16 : 0));
}

// asynchronous copy of 4 bytes, zeros where !keep
__device__ __forceinline__ void copy4(void* dst, const void* src, bool keep) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(keep ? 4 : 0));
}

__device__ __forceinline__ void copies_wait() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

enum RunKind { kConsecutive, kEqual, kAcross };

// o[r] = sum_k w(k, r) * src[(start_r + k) * stride] for the kRun outputs r
// of a run, start_r = s0 + r (kConsecutive), s0 (kEqual) or st[r] - st_off
// (kAcross). Weights: bands wt[k * wpitch + r]; taps wt[k] for every r.
// The window's tap loop runs to Kpad (K rounded up to kRun, zero weights
// past K); its loads past the last staged index `last` read that index
// instead (a finite value, weighed by zero).
template <bool kBands>
__device__ __forceinline__ void run_sum(const float* __restrict__ src,
                                        int stride, int last, int s0,
                                        RunKind kind, const int* st,
                                        int st_off,
                                        const float* __restrict__ wt,
                                        int wpitch, int K, int Kpad,
                                        float (&acc)[kRun]) {
#pragma unroll
    for (int r = 0; r < kRun; ++r) acc[r] = 0.0f;
    if (!kBands || kind == kConsecutive) {
        // win[m % kRun] holds src[s0 + m]
        float win[kRun];
#pragma unroll
        for (int m = 0; m < kRun - 1; ++m)
            win[m] = src[min(s0 + m, last) * stride];
        for (int k = 0; k < Kpad; k += kRun) {
#pragma unroll
            for (int u = 0; u < kRun; ++u) {
                win[(u + kRun - 1) % kRun] =
                    src[min(s0 + k + u + kRun - 1, last) * stride];
                if (kBands) {
                    const float* w = wt + (k + u) * wpitch;
                    const float4 w0 = *reinterpret_cast<const float4*>(w);
                    const float4 w1 = *reinterpret_cast<const float4*>(w + 4);
                    const float ws[kRun] = {w0.x, w0.y, w0.z, w0.w,
                                            w1.x, w1.y, w1.z, w1.w};
#pragma unroll
                    for (int r = 0; r < kRun; ++r)
                        acc[r] = fmaf(ws[r], win[(u + r) % kRun], acc[r]);
                } else {
                    const float w = wt[k + u];
#pragma unroll
                    for (int r = 0; r < kRun; ++r)
                        acc[r] = fmaf(w, win[(u + r) % kRun], acc[r]);
                }
            }
        }
    } else if (kind == kEqual) {
        for (int k = 0; k < K; ++k) {
            const float v = src[(s0 + k) * stride];
            const float* w = wt + k * wpitch;
            const float4 w0 = *reinterpret_cast<const float4*>(w);
            const float4 w1 = *reinterpret_cast<const float4*>(w + 4);
            const float ws[kRun] = {w0.x, w0.y, w0.z, w0.w,
                                    w1.x, w1.y, w1.z, w1.w};
#pragma unroll
            for (int r = 0; r < kRun; ++r) acc[r] = fmaf(ws[r], v, acc[r]);
        }
    } else {
#pragma unroll
        for (int r = 0; r < kRun; ++r) {
            const float* s = src + (st[r] - st_off) * stride;
            for (int k = 0; k < K; ++k)
                acc[r] = fmaf(wt[k * wpitch + r], s[k * stride], acc[r]);
        }
    }
}

// dst[k][i] = w[k * size + i] for k < K and i < n, zeros elsewhere in
// (Kpad, kN): one tile's band weights, 16 bytes a copy where the rows allow
// it (vec)
template <int kN, int kThreads>
__device__ __forceinline__ void stage_band_weights(float* dst, const float* w,
                                                   int size, int K, int Kpad,
                                                   int n, int vec) {
    constexpr int kQuads = kN / 4;
    for (int q = threadIdx.x; q < Kpad * kQuads; q += kThreads) {
        const int k = q / kQuads, i = 4 * (q - k * kQuads);
        float* d = dst + k * kN + i;
        const float* src = w + (size_t)k * size + i;
        if (vec && (k >= K || i + 4 <= n)) {
            copy16(d, k < K ? src : w, k < K);
        } else {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const bool keep = k < K && i + j < n;
                copy4(d + j, keep ? src + j : w, keep);
            }
        }
    }
}

// how a run of n outputs with band starts st[0 .. n) lies
__device__ __forceinline__ RunKind run_kind(const int* st, int n) {
    const int d = st[n - 1] - st[0];
    return d == n - 1 ? kConsecutive : (d == 0 ? kEqual : kAcross);
}

// writes the jn <= kRun outputs of a run, 16 bytes a store where the row
// allows it (vec) and the run is whole
__device__ __forceinline__ void store_run(float* dst, const float (&v)[kRun],
                                          int jn, int vec) {
    if (vec && jn == kRun) {
        reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
        reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
    } else {
#pragma unroll
        for (int r = 0; r < kRun; ++r)
            if (r < jn) dst[r] = v[r];
    }
}

// kSum (bands only): the block runs every level l of its tile on x[l] in
// turn and sums the horizontal passes in its threads' registers; each
// thread then owns one output run for all levels, and writes it once.
template <class T, bool kBands, bool kSum>
__device__ __forceinline__ void tiled_blur_body(const TiledArgs& a) {
    static_assert(kBands || !kSum, "the level sum reads bands");
    static_assert(!kSum || T::H * (T::W / kRun) <= T::threads,
                  "the level sum keeps one output run a thread");
    extern __shared__ __align__(16) float smem[];
    float* vb = smem;                  // (kvp, T::H) band weights, or taps
    int* svs = reinterpret_cast<int*>(smem + a.off_st);  // (T::H,)
    int* shs = svs + T::H;                               // (T::W,)
    float* xs = smem + a.off_x;        // (rows, xpitch)
    // bands: (khp, T::W) weights; the level sum's, in a region of their
    // own where the block's shared memory stays small (short bands), else
    // staged in xs's place once the vertical pass is done (two blocks fit
    // on an SM at 87 taps); taps: (khp,)
    float* hb = smem + (kBands && !kSum ? a.off_x : a.off_hb);
    const bool hb_later = kBands && !(kSum && a.hb_apart);
    float* tmp = smem + a.off_tmp;     // (T::H, tpitch)

    const int tid = threadIdx.x;
    const int N = a.N, H = a.H, W = a.W;
    const int n = (int)blockIdx.z % N;
    const int r0 = blockIdx.y * T::H;
    const int c0 = blockIdx.x * T::W;
    const int nr = min(T::H, H - r0);
    const int nc = min(T::W, W - c0);
    // the level sum: this thread's output run, summed over the levels
    float total[kRun];
#pragma unroll
    for (int r = 0; r < kRun; ++r) total[r] = 0.0f;
    const int levels = kSum ? a.L : 1;

    for (int li = 0; li < levels; ++li) {
        // the forward blur's widest levels first (they take longest); the
        // level sum in order
        const int l =
            kSum ? li : (kBands ? a.L - 1 - (int)blockIdx.z / N : 0);
        // the previous level's passes are done with the staged data
        if (kSum && li > 0) __syncthreads();
        const int Kv = a.taps.v[l];
        const int Kh = a.taps.h[l];
        const int Kvp = (Kv + kRun - 1) / kRun * kRun;
        const int Khp = (Kh + kRun - 1) / kRun * kRun;
        const int* svl = kBands ? a.sv + (size_t)l * H : nullptr;
        const int* shl = kBands ? a.sh + (size_t)l * W : nullptr;

        // staged rows [ys, ys + rows) and columns [xa, xa + cols), xa 16-byte
        // aligned: the first and last input each tap axis reads
        const int ys = kBands ? __ldg(svl + r0) : r0 - a.av;
        const int rows =
            (kBands ? __ldg(svl + r0 + nr - 1) : r0 + nr - 1 - a.av) + Kv
            - ys;
        const int xs0 = kBands ? __ldg(shl + c0) : c0 - a.ah;
        const int xa = xs0 & ~3;
        const int cols =
            (kBands ? __ldg(shl + c0 + nc - 1) : c0 + nc - 1 - a.ah) + Kh
            - xa;
        const int quads = (cols + 3) >> 2;
        const float* xn = a.x + (size_t)(kSum ? l * N + n : n) * H * W;

        // --- stage x, the vertical weights (or both taps) and the starts
        for (int q = tid; q < rows * quads; q += T::threads) {
            const int s = q / quads;
            const int c4 = 4 * (q - s * quads);
            const int c = xa + c4;
            float* dst = xs + s * a.xpitch + c4;
            const int sr = kBands ? ys + s : border_index(ys + s, H, a.border);
            if (a.vec && (sr < 0 || (c >= 0 && c + 4 <= W))) {
                copy16(dst, sr >= 0 ? xn + (size_t)sr * W + c : xn, sr >= 0);
            } else {
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    // for bands, the clamp only keeps the slack past the last
                    // staged column in range
                    const int sc = kBands ? min(c + j, W - 1)
                                          : border_index(c + j, W, a.border);
                    const bool keep = sr >= 0 && sc >= 0;
                    copy4(dst + j, keep ? xn + (size_t)sr * W + sc : xn, keep);
                }
            }
        }
        if (kBands) {
            stage_band_weights<T::H, T::threads>(
                vb, a.wv + (size_t)l * a.Kv_max * H + r0, H, Kv, Kvp, nr,
                a.vec_wv);
            if (!hb_later)
                stage_band_weights<T::W, T::threads>(
                    hb, a.wh + (size_t)l * a.Kh_max * W + c0, W, Kh, Khp,
                    nc, a.vec_wh);
            for (int q = tid; q < T::H + T::W; q += T::threads)
                copy4(svs + q,
                      q < T::H ? svl + r0 + min(q, nr - 1)
                                 : shl + c0 + min(q - T::H, nc - 1),
                      true);
        } else {
            for (int k = tid; k < Kvp; k += T::threads)
                copy4(vb + k, a.ky + min(k, Kv - 1), k < Kv);
            for (int k = tid; k < Khp; k += T::threads)
                copy4(hb + k, a.kx + min(k, Kh - 1), k < Kh);
        }
        copies_wait();
        __syncthreads();

        // --- vertical pass: tmp[i][t] for the tile's rows and every staged
        // column t the horizontal pass reads; a run of kRun rows per thread, a
        // warp on neighbouring columns
        const int t_lo = xs0 - xa;
        const int t_n = cols - t_lo;
        constexpr int kGroups = T::H / kRun;
        for (int q = tid; q < kGroups * t_n; q += T::threads) {
            const int g = q / t_n;
            const int t = t_lo + (q - g * t_n);
            const int i0 = g * kRun;
            if (i0 >= nr) continue;
            const RunKind kind =
                kBands ? run_kind(svs + i0, min(kRun, nr - i0)) : kConsecutive;
            const int s0 = kBands ? svs[i0] - ys : i0;
            float acc[kRun];
            run_sum<kBands>(xs + t, a.xpitch, rows - 1, s0, kind, svs + i0, ys,
                            kBands ? vb + i0 : vb, T::H, Kv, Kvp, acc);
#pragma unroll
            for (int r = 0; r < kRun; ++r)
                tmp[(i0 + r) * a.tpitch + t] = acc[r];
        }
        __syncthreads();
        if (hb_later) {
            stage_band_weights<T::W, T::threads>(
                hb, a.wh + (size_t)l * a.Kh_max * W + c0, W, Kh, Khp, nc,
                a.vec_wh);
            copies_wait();
            __syncthreads();
        }

        // --- horizontal pass: row i, a run of kRun columns per thread; a warp
        // holds 32 rows of one run (tpitch is odd: no bank conflicts) and
        // shares the run's weights
        for (int q = tid; q < T::H * (T::W / kRun); q += T::threads) {
            const int i = q % T::H;
            const int j0 = (q / T::H) * kRun;
            if (i >= nr || j0 >= nc) continue;
            const int jn = min(kRun, nc - j0);
            const RunKind kind = kBands ? run_kind(shs + j0, jn) : kConsecutive;
            const int s0 = kBands ? shs[j0] - xa : j0 + t_lo;
            float acc[kRun];
            run_sum<kBands>(tmp + i * a.tpitch, 1, cols - 1, s0, kind, shs + j0,
                            xa, kBands ? hb + j0 : hb, T::W, Kh, Khp, acc);
            if (kSum) {
#pragma unroll
                for (int r = 0; r < kRun; ++r) total[r] += acc[r];
            } else {
                store_run(a.out + (((size_t)l * N + n) * H + r0 + i) * W + c0
                          + j0, acc, jn, a.vec);
            }
        }
    }  // levels

    if (kSum) {
        const int i = tid % T::H;
        const int j0 = (tid / T::H) * kRun;
        if (tid < T::H * (T::W / kRun) && i < nr && j0 < nc)
            store_run(a.out + ((size_t)n * H + r0 + i) * W + c0 + j0, total,
                      min(kRun, nc - j0), a.vec);
    }
}

template <class T>
__global__ void __launch_bounds__(T::threads, 512 / T::threads)
tile_taps_blur(const TiledArgs a) {
    tiled_blur_body<T, false, false>(a);
}

template <class T>
__global__ void __launch_bounds__(T::threads, 512 / T::threads)
tile_band_blur(const TiledArgs a) {
    tiled_blur_body<T, true, false>(a);
}

// dx[n] = sum_l SV_lᵀ g[l, n] SH_l, one block per tile of dx
template <class T>
__global__ void __launch_bounds__(T::threads, 512 / T::threads)
tile_band_adjoint(const TiledArgs a) {
    tiled_blur_body<T, true, true>(a);
}

// the largest dynamic shared memory a block may have on sm_90
constexpr int kMaxSmemBytes = 227 * 1024;

// the level sum's bands whose block stays within this many bytes with the
// column weights in a region of their own stage them with everything else
// (one round trip to memory a level, not two: a few percent at the SSIM
// shape, in turns on an H100; 87 taps do not fit)
constexpr int kHbApartBytes = 48 * 1024;

// Shared-memory layout of the tiled blur for taps (or bands, kSum: of the
// level sum) of at most Kv rows and Kh columns; returns its bytes.
template <class T, bool kBands, bool kSum = false>
int tiled_geometry(int Kv, int Kh, TiledArgs* a) {
    const int kvp = (Kv + kRun - 1) / kRun * kRun;
    const int khp = (Kh + kRun - 1) / kRun * kRun;
    const int rows = T::H + Kv - 1;
    const int cols = T::W + Kh - 1 + 3;  // + 16-byte alignment slack
    a->xpitch = (cols + 3) & ~3;
    a->tpitch = a->xpitch + 1;  // odd: the horizontal pass reads columns
    if (!kBands) {
        // taps: ky (kvp,), kx (khp,), starts (unused), xs, tmp
        a->off_hb = kvp;
        a->off_st = a->off_hb + khp;
        a->off_x = a->off_st + T::H + T::W;
        a->off_tmp = a->off_x + rows * a->xpitch;
        a->hb_apart = 0;
        return (a->off_tmp + T::H * a->tpitch) * (int)sizeof(float);
    }
    // bands: vertical weights (kvp, T::H), starts, xs, [column weights
    // (khp, T::W)], tmp
    a->off_st = kvp * T::H;
    a->off_x = a->off_st + T::H + T::W;
    const int apart = a->off_x + rows * a->xpitch + khp * T::W
                      + T::H * a->tpitch;
    a->hb_apart = kSum && apart * (int)sizeof(float) <= kHbApartBytes;
    if (a->hb_apart) {
        a->off_hb = a->off_x + rows * a->xpitch;
        a->off_tmp = a->off_hb + khp * T::W;
    } else {
        a->off_hb = a->off_x;
        a->off_tmp = a->off_x + max(rows * a->xpitch, khp * T::W);
    }
    return (a->off_tmp + T::H * a->tpitch) * (int)sizeof(float);
}

// Launches the tiled blur (kSum: the band adjoint, one block per tile of
// every image, levels summed in the block); returns the CUDA error, and
// cudaErrorInvalidValue where the taps or bands are too wide to stage. The
// caller decides the route before it calls (tiled_blur_fits).
template <class T, bool kBands, bool kSum>
cudaError_t launch_tiled(TiledArgs* a, int Kv, int Kh, cudaStream_t s) {
    const int bytes = tiled_geometry<T, kBands, kSum>(Kv, Kh, a);
    if (bytes > kMaxSmemBytes) return cudaErrorInvalidValue;
    void (*kernel)(const TiledArgs);
    if constexpr (kSum) kernel = tile_band_adjoint<T>;
    else if constexpr (kBands) kernel = tile_band_blur<T>;
    else kernel = tile_taps_blur<T>;
    if (bytes > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
        if (err != cudaSuccess) return err;
    }
    const dim3 grid((a->W + T::W - 1) / T::W, (a->H + T::H - 1) / T::H,
                    kSum ? a->N : a->L * a->N);
    kernel<<<grid, T::threads, bytes, s>>>(*a);
    return cudaGetLastError();
}

bool aligned16(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
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

// the tiled kernel's arguments for bands (the forward multi-level blur on
// x (N, H, W) or the adjoint on x (L, N, H, W))
bool band_args(const float* x, const int* sv, const float* wv, const int* sh,
               const float* wh, const int* kv, const int* kh, float* out,
               int L, int N, int H, int W, int Kv_max, int Kh_max,
               TiledArgs* a) {
    *a = TiledArgs{};
    if (!level_taps(kv, kh, L, Kv_max, Kh_max, &a->taps)) return false;
    a->x = x;
    a->out = out;
    a->N = N;
    a->H = H;
    a->W = W;
    a->L = L;
    a->vec = W % 4 == 0 && aligned16(x) && aligned16(out);
    a->sv = sv;
    a->wv = wv;
    a->sh = sh;
    a->wh = wh;
    a->Kv_max = Kv_max;
    a->Kh_max = Kh_max;
    a->vec_wv = H % 4 == 0 && aligned16(wv);
    a->vec_wh = W % 4 == 0 && aligned16(wh);
    return true;
}

// routes of separable_blur, banded_blur and banded_blur_adjoint
constexpr int kPasses = 0;     // two passes through tmp
constexpr int kTiled = 1;      // LargeTile, BandTile, AdjointTile
constexpr int kTiledSmall = 2;  // SmallTile

}  // namespace

// 1 if the tiled kernel can stage taps (bands = 0; large = 1: LargeTile,
// 0: SmallTile) or bands (bands = 1) of at most Kv rows and Kh columns in a
// block's shared memory, else 0. The caller takes the passes where not.
extern "C" int tiled_blur_fits(int bands, int large, int Kv, int Kh) {
    TiledArgs a{};
    const int bytes =
        bands ? tiled_geometry<BandTile, true>(Kv, Kh, &a)
              : (large ? tiled_geometry<LargeTile, false>(Kv, Kh, &a)
                       : tiled_geometry<SmallTile, false>(Kv, Kh, &a));
    return bytes <= kMaxSmemBytes;
}

// x (N, H, W); ky (Kv,); kx (Kh,); out (N, H, W); tmp (N, H, W) for the
// passes, unread by the tiled kernel; av, ah the tap of each kernel that
// lands on the output pixel (K / 2 for the blur, K - 1 - K / 2 for the
// adjoint's flipped taps); border numbered as above. route: kTiled (large
// tiles), kTiledSmall (small tiles) or kPasses. Returns the first CUDA
// error (0 on success).
extern "C" int separable_blur(const float* x, const float* ky,
                              const float* kx, float* tmp, float* out, int N,
                              int H, int W, int Kv, int Kh, int av, int ah,
                              int border, int route, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (route == kPasses) {
        const dim3 block(kBlockX, kBlockY);
        const dim3 grid = grid_of(H, W, N);
        taps_vertical<<<grid, block, 0, s>>>(x, ky, tmp, H, W, Kv, av,
                                             border);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
        taps_horizontal<<<grid, block, 0, s>>>(tmp, kx, out, H, W, Kh, ah,
                                               border);
        return static_cast<int>(cudaGetLastError());
    }
    TiledArgs a{};
    a.x = x;
    a.out = out;
    a.N = N;
    a.H = H;
    a.W = W;
    a.L = 1;
    a.vec = W % 4 == 0 && aligned16(x) && aligned16(out);
    a.ky = ky;
    a.kx = kx;
    a.av = av;
    a.ah = ah;
    a.border = border;
    a.taps.v[0] = Kv;
    a.taps.h[0] = Kh;
    if (route == kTiled)
        return static_cast<int>(
            launch_tiled<LargeTile, false, false>(&a, Kv, Kh, s));
    if (route == kTiledSmall)
        return static_cast<int>(
            launch_tiled<SmallTile, false, false>(&a, Kv, Kh, s));
    return static_cast<int>(cudaErrorInvalidValue);
}

// x (N, H, W); sv (L, H) and sh (L, W) band starts; wv (L, Kv_max, H) and
// wh (L, Kh_max, W) band weights; kv, kh (L,) taps per level, host memory;
// out (L, N, H, W); tmp (L, N, H, W) for the passes, unread by the tiled
// kernel. route: kTiled or kPasses. Returns the first CUDA error (0 on
// success).
extern "C" int banded_blur(const float* x, const int* sv, const float* wv,
                           const int* sh, const float* wh, const int* kv,
                           const int* kh, float* tmp, float* out, int L,
                           int N, int H, int W, int Kv_max, int Kh_max,
                           int route, void* stream) {
    TiledArgs a;
    if (!band_args(x, sv, wv, sh, wh, kv, kh, out, L, N, H, W, Kv_max,
                   Kh_max, &a))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (route == kTiled)
        return static_cast<int>(
            launch_tiled<BandTile, true, false>(&a, Kv_max, Kh_max, s));
    if (route != kPasses) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 block(kBlockX, kBlockY);
    const dim3 grid = grid_of(H, W, L * N);
    band_vertical<false><<<grid, block, 0, s>>>(x, sv, wv, tmp, N, H, W,
                                                Kv_max, a.taps);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    band_horizontal<<<grid, block, 0, s>>>(tmp, sh, wh, out, N, H, W, Kh_max,
                                           a.taps);
    return static_cast<int>(cudaGetLastError());
}

// g (L, N, H, W); sv, wv, sh, wh the bands of the TRANSPOSED operators
// SV_lᵀ (L, H, H) and SH_lᵀ (L, W, W), laid out as for banded_blur; out
// (N, H, W) = sum_l SV_lᵀ g_l SH_l. route: kTiled (AdjointTile: a block
// per tile, the levels summed in it) or kPasses, which alone reads tmp
// (L, N, H, W). Returns the first CUDA error (0 on success).
extern "C" int banded_blur_adjoint(const float* g, const int* sv,
                                   const float* wv, const int* sh,
                                   const float* wh, const int* kv,
                                   const int* kh, float* tmp, float* out,
                                   int L, int N, int H, int W, int Kv_max,
                                   int Kh_max, int route, void* stream) {
    TiledArgs a;
    if (!band_args(g, sv, wv, sh, wh, kv, kh, out, L, N, H, W, Kv_max,
                   Kh_max, &a))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (route == kTiled)
        return static_cast<int>(
            launch_tiled<AdjointTile, true, true>(&a, Kv_max, Kh_max, s));
    if (route != kPasses) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 block(kBlockX, kBlockY);
    band_vertical<true><<<grid_of(H, W, L * N), block, 0, s>>>(
        g, sv, wv, tmp, N, H, W, Kv_max, a.taps);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    band_horizontal_sum<<<grid_of(H, W, N), block, 0, s>>>(
        tmp, sh, wh, out, L, N, H, W, Kh_max, a.taps);
    return static_cast<int>(cudaGetLastError());
}
