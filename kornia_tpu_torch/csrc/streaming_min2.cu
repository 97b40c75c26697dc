// Streaming nearest and second-nearest neighbour for Hopper (sm_90a).
//
// Replaces kornia_tpu/ops/pallas_kernels.py streaming_min2 (_min2_kernel):
// for every row of d1 (N, D), the smallest and second-smallest squared L2
// distance to the rows of d2 (M, D) and the index of the smallest, without
// ever storing the (N, M) distance matrix. The TPU kernel walks d2 in
// 256-row tiles along a sequential grid axis and carries the running
// (min1, min2, argmin) of each d1 row in its output block.
//
// What bounds it on the card: operations. 2·N·M·D flops for the dot
// products (17.2 GFLOP at N = M = 8192, D = 128) against 2·(N + M)·D·4
// bytes of input; in true f32 on the CUDA cores that is about 0.26 ms at
// 67 TFLOP/s, a hundred times the time its bytes need.
//
// What the design does about it: a register-tiled f32 product. A block
// owns 64 rows of d1 and one contiguous range of d2's rows, walks that
// range in 64-row tiles and stages 32 dimensions of both tiles at a time in
// shared memory, transposed (dimension-major, padded against bank
// conflicts). Each of its 256 threads computes a 4 x 4 block of dot
// products with fused multiply-adds in a fixed order, turns them into
// distances max(n1 + n2 - 2·dot, 0) and folds them into a running
// (min1, min2, argmin) per row; its columns arrive in increasing order, so
// a later column equal to min1 becomes min2 and the first index keeps the
// minimum. The 16 threads that share a row then merge their triples by
// warp shuffles. The Pallas kernel's sequential axis becomes a split of
// d2's rows over the grid (enough blocks to fill 132 SMs); a second small
// kernel merges the splits per row in order with the rule of
// _min2_kernel: min1 = min, argmin from the smaller (the earlier on a
// tie), min2 = min(max(a1, b1), min(a2, b2)). Rows past N and columns past
// M are masked, so N and M need not be multiples of a tile. Tensor cores
// (a 3xTF32 split) and TMA staging are for a later kernel.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;      // rows of d1, and of d2, per tile
constexpr int kDepth = 32;     // dimensions staged per step
constexpr int kThreads = 256;  // 16 x 16; each a 4 x 4 block of distances
constexpr int kSub = 4;
constexpr float kBig = 1e9f;   // _BIG of the reference: "no neighbour yet"

// squared norm of every row of d (rows, D): one warp per row
__global__ void row_norms(const float* __restrict__ d, int rows, int D,
                          float* __restrict__ out) {
    const int warp = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
    const int lane = threadIdx.x % 32;
    if (warp >= rows) return;
    const float* p = d + (size_t)warp * D;
    float acc = 0.0f;
    for (int k = lane; k < D; k += 32) acc = fmaf(p[k], p[k], acc);
    for (int off = 16; off > 0; off /= 2)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) out[warp] = acc;
}

// fold distance v of column c, columns arriving in increasing order
__device__ __forceinline__ void push(float v, int c, float& m1, float& m2,
                                     int& ix) {
    if (v < m1) {
        m2 = m1;
        m1 = v;
        ix = c;
    } else if (v < m2) {
        m2 = v;
    }
}

// merge the triple of another set of columns into (m1, m2, ix)
__device__ __forceinline__ void merge(float& m1, float& m2, int& ix, float b1,
                                      float b2, int bi) {
    const float n2 = fminf(fmaxf(m1, b1), fminf(m2, b2));
    if (b1 < m1 || (b1 == m1 && bi < ix)) ix = bi;
    m1 = fminf(m1, b1);
    m2 = n2;
}

// grid (ceil(N / 64), splits): block (i, s) reduces rows [64 i, 64 i + 64)
// of d1 over rows [s·span, (s + 1)·span) of d2 into p1, p2, pidx (splits, N)
__global__ void __launch_bounds__(kThreads)
    min2_partial(const float* __restrict__ d1, const float* __restrict__ d2,
                 const float* __restrict__ n1, const float* __restrict__ n2,
                 int N, int M, int D, int span, float* __restrict__ p1,
                 float* __restrict__ p2, int* __restrict__ pidx) {
    __shared__ float As[kDepth][kTile + 1];
    __shared__ float Bs[kDepth][kTile + 1];
    const int tx = threadIdx.x % 16;
    const int ty = threadIdx.x / 16;
    const int row0 = blockIdx.x * kTile;
    const int split = blockIdx.y;
    const int col_begin = split * span;
    const int col_end = min(M, col_begin + span);

    float m1[kSub], m2[kSub], rn1[kSub];
    int ix[kSub];
    for (int r = 0; r < kSub; ++r) {
        const int row = row0 + ty + 16 * r;
        m1[r] = kBig;
        m2[r] = kBig;
        ix[r] = 0;
        rn1[r] = row < N ? n1[row] : 0.0f;
    }

    for (int c0 = col_begin; c0 < col_end; c0 += kTile) {
        float acc[kSub][kSub];
#pragma unroll
        for (int r = 0; r < kSub; ++r)
#pragma unroll
            for (int c = 0; c < kSub; ++c) acc[r][c] = 0.0f;
        for (int k0 = 0; k0 < D; k0 += kDepth) {
            // neighbouring threads read neighbouring dimensions of a row
            for (int e = threadIdx.x; e < kTile * kDepth; e += kThreads) {
                const int r = e / kDepth;
                const int k = e % kDepth;
                const int gk = k0 + k;
                const int gr = row0 + r;
                const int gc = c0 + r;
                As[k][r] = (gr < N && gk < D) ? d1[(size_t)gr * D + gk] : 0.0f;
                Bs[k][r] = (gc < col_end && gk < D) ? d2[(size_t)gc * D + gk]
                                                    : 0.0f;
            }
            __syncthreads();
#pragma unroll 8
            for (int k = 0; k < kDepth; ++k) {
                float a[kSub], b[kSub];
#pragma unroll
                for (int r = 0; r < kSub; ++r) a[r] = As[k][ty + 16 * r];
#pragma unroll
                for (int c = 0; c < kSub; ++c) b[c] = Bs[k][tx + 16 * c];
#pragma unroll
                for (int r = 0; r < kSub; ++r)
#pragma unroll
                    for (int c = 0; c < kSub; ++c)
                        acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
            }
            __syncthreads();
        }
#pragma unroll
        for (int c = 0; c < kSub; ++c) {
            const int col = c0 + tx + 16 * c;
            if (col >= col_end) continue;
            const float nn2 = n2[col];
#pragma unroll
            for (int r = 0; r < kSub; ++r) {
                const float d = __fsub_rn(__fadd_rn(rn1[r], nn2),
                                          __fmul_rn(2.0f, acc[r][c]));
                push(fmaxf(d, 0.0f), col, m1[r], m2[r], ix[r]);
            }
        }
    }

    // the 16 threads of a row are one half of a warp
    for (int r = 0; r < kSub; ++r) {
        for (int off = 8; off > 0; off /= 2) {
            const float b1 = __shfl_xor_sync(0xffffffffu, m1[r], off);
            const float b2 = __shfl_xor_sync(0xffffffffu, m2[r], off);
            const int bi = __shfl_xor_sync(0xffffffffu, ix[r], off);
            merge(m1[r], m2[r], ix[r], b1, b2, bi);
        }
        const int row = row0 + ty + 16 * r;
        if (tx == 0 && row < N) {
            const size_t o = (size_t)split * N + row;
            p1[o] = m1[r];
            p2[o] = m2[r];
            pidx[o] = ix[r];
        }
    }
}

// merge the splits of each row in order
__global__ void min2_merge(const float* __restrict__ p1,
                           const float* __restrict__ p2,
                           const int* __restrict__ pidx, int splits, int N,
                           float* __restrict__ min1, float* __restrict__ min2,
                           int* __restrict__ idx) {
    const int row = blockIdx.x * blockDim.x + threadIdx.x;
    if (row >= N) return;
    float m1 = p1[row], m2 = p2[row];
    int ix = pidx[row];
    for (int s = 1; s < splits; ++s) {
        const size_t o = (size_t)s * N + row;
        merge(m1, m2, ix, p1[o], p2[o], pidx[o]);
    }
    min1[row] = m1;
    min2[row] = m2;
    idx[row] = ix;
}

}  // namespace

// d1 (N, D), d2 (M, D); n1 (N,), n2 (M,) scratch for the squared norms;
// p1, p2, pidx (splits, N) scratch; min1, min2, idx (N,) outputs. d2's rows
// are cut into `splits` ranges of `span` rows (span a multiple of 64,
// splits * span >= M). Returns the first CUDA error (0 on success).
extern "C" int streaming_min2(const float* d1, const float* d2, float* n1,
                              float* n2, float* p1, float* p2, int* pidx,
                              float* min1, float* min2, int* idx, int N,
                              int M, int D, int splits, int span,
                              void* stream) {
    if (N == 0) return 0;
    if (M < 1 || D < 1 || splits < 1 || span < 1 || span % kTile != 0 ||
        (long long)splits * span < M)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    row_norms<<<(N * 32 + 255) / 256, 256, 0, s>>>(d1, N, D, n1);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    row_norms<<<(M * 32 + 255) / 256, 256, 0, s>>>(d2, M, D, n2);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((N + kTile - 1) / kTile, splits);
    min2_partial<<<grid, kThreads, 0, s>>>(d1, d2, n1, n2, N, M, D, span, p1,
                                           p2, pidx);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    min2_merge<<<(N + 255) / 256, 256, 0, s>>>(p1, p2, pidx, splits, N, min1,
                                               min2, idx);
    return static_cast<int>(cudaGetLastError());
}
