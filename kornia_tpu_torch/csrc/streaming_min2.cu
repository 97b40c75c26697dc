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
// bytes of input. In f32 on the CUDA cores that is 0.26 ms at 67
// TFLOP/s. The tensor cores take TF32, which keeps 11 significant
// bits (about three digits), and the port's matcher is held to f32; a
// product accurate to f32 costs three TF32 products, so its least time is
// 3 · 2·N·M·D / 495 TFLOP/s = 0.104 ms.
//
// What the design does about it: a 3xTF32 product on the tensor cores.
// Each f32 value a splits into a_hi = tf32(a) and a_lo = tf32(a - a_hi)
// (cvt.rna: round to nearest, ties away from zero), and
// dot = a_lo·b_hi + a_hi·b_lo + a_hi·b_hi (the small terms first) by
// mma.sync m16n8k8. The dropped a_lo·b_lo and the rounding of the lo parts
// leave about 2^-21 of |a|·|b| a product. The tensor cores' own f32 sums
// lose more than rounding to nearest would: summed over all 128 dimensions
// in them, distances of unit rows erred by up to 3.8e-6 and moved the SMNN
// ratios of near-duplicate rows by more than 1e-5. So each 32-dimension
// step is summed from zero in the tensor cores and added into the running
// dot product by an f32 add that rounds to nearest (1.8e-6). On integer
// entries below 2^11 the lo parts are zero and every sum is exact.
//   * A block owns 128 rows of d1 and one contiguous range of d2's rows,
//     which it walks in tiles of 128 rows. The (tile, 32-dimension chunk)
//     steps form one sequence that a ring of three shared-memory stages
//     serves: cp.async fills stage s + 2 while the warps multiply stage s,
//     so the copies of the next tile overlap the last chunk of this one and
//     its epilogue. Both operands are K-major as the row-major inputs are;
//     rows are staged 36 floats apart, so each 8-row ldmatrix hits 32
//     different banks. A ragged D chunk is zero-filled (16-byte copies with
//     fewer source bytes, or 4-byte copies where D % 4 != 0), as are rows
//     past N and past the range.
//   * Eight warps, 4 along d1's rows by 2 along d2's, each a 32 x 64 tile
//     of dot products: 2 x 8 m16n8 accumulators and their step sums, 128
//     floats a thread. ldmatrix fetches the f32 fragments (a TF32 fragment
//     is an 8 x 4 matrix of 32-bit words), and the hi/lo split happens in
//     registers; the products run term by term, 16 independent ones
//     between two into one accumulator.
//   * Epilogue per tile, without branches: each dot product becomes
//     max(n1 + n2 - 2·dot, 0) and goes into the thread's running (min1,
//     min2, argmin) of its row (a thread holds 4 rows and 16 columns of
//     each, visited in increasing order, so a later column equal to min1
//     becomes min2 and the first index keeps the minimum).
//   * After the range: the 4 lanes of a row merge by quad shuffles, the two
//     warps of a row through shared memory, with merge()'s index rule.
// The Pallas kernel's sequential axis becomes a split of d2's rows over the
// grid (about four blocks per SM); a second small kernel merges the splits
// per row in order with the rule of _min2_kernel: min1 = min, argmin from
// the smaller (the earlier on a tie), min2 = min(max(a1, b1), min(a2, b2)).
// Rows past N and columns past M are masked, so N and M need not be
// multiples of a tile.
//
// Where the time goes (8192 x 8192 x 128 on an H100, 0.45 ms; variants
// with one part cut out, in turns: matcher_ablation.py): the two small
// products about 0.17 ms (mma.sync TF32 peaks near 310 TFLOP/s on the
// card; wgmma's 495 are out of its reach), the split about 0.08, the
// top-2 about 0.01 (0.13 while it branched), the f32 adds of the step sums
// about 0.01. ptxas (CUDA 12.8, sm_90a): min2_partial 209 registers, no
// spills, 110,592 bytes of dynamic shared memory; one block of 8 warps an
// SM (16 warps in 32 x 32 warp tiles were slower).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTileM = 128;    // rows of d1 per block
constexpr int kTileN = 128;    // rows of d2 per tile
constexpr int kDepth = 32;     // dimensions per pipeline step
constexpr int kPitch = kDepth + 4;  // staged row pitch in floats
constexpr int kStages = 3;     // the ring of shared-memory stages
constexpr int kWarpM = 32;     // a warp's rows of d1
constexpr int kWarpN = 64;     // a warp's rows of d2
constexpr int kWarpsM = kTileM / kWarpM;  // warps along d1's rows
constexpr int kWarpsN = kTileN / kWarpN;  // warps along d2's rows
constexpr int kThreads = 32 * kWarpsM * kWarpsN;
constexpr int kMT = kWarpM / 16;  // m16 tiles a warp
constexpr int kNT = kWarpN / 8;   // n8 tiles a warp
constexpr int kRows = 2 * kMT;    // d1 rows a thread holds
constexpr int kStageFloats = (kTileM + kTileN) * kPitch;
constexpr int kSmemBytes = kStages * kStageFloats * (int)sizeof(float);

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

// fold distance v of column c, columns arriving in increasing order: a
// smaller v takes min1 (and its index), min1 moving to min2; else v takes
// min2 if smaller (so a later column equal to min1 becomes min2). Selects,
// no branches
__device__ __forceinline__ void push(float v, int c, float& m1, float& m2,
                                     int& ix) {
    const bool first = v < m1;
    m2 = first ? m1 : fminf(m2, v);
    ix = first ? c : ix;
    m1 = first ? v : m1;
}

// merge the triple of another set of columns into (m1, m2, ix)
__device__ __forceinline__ void merge(float& m1, float& m2, int& ix, float b1,
                                      float b2, int bi) {
    const float n2 = fminf(fmaxf(m1, b1), fminf(m2, b2));
    if (b1 < m1 || (b1 == m1 && bi < ix)) ix = bi;
    m1 = fminf(m1, b1);
    m2 = n2;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// asynchronous copy of `bytes` (0 to 16) of src, zeros for the rest of 16
__device__ __forceinline__ void copy16(void* dst, const void* src,
                                       int bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(bytes));
}

// asynchronous copy of 4 bytes, zeros where !keep (src is then not read)
__device__ __forceinline__ void copy4(void* dst, const void* src, bool keep) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(keep ? 4 : 0));
}

__device__ __forceinline__ void copies_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most kPending of the committed groups are in flight
template <int kPending>
__device__ __forceinline__ void copies_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// x rounded to TF32 (10 mantissa bits), to nearest, ties away from zero
__device__ __forceinline__ uint32_t tf32(float x) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
    return r;
}

// the f32 value with bits x as hi + lo, both TF32: |x - hi - lo| is at
// most 2^-22 |x|
__device__ __forceinline__ void split_tf32(uint32_t x, uint32_t& hi,
                                           uint32_t& lo) {
    hi = tf32(__uint_as_float(x));
    lo = tf32(__fsub_rn(__uint_as_float(x), __uint_as_float(hi)));
}

// c += a · b on the tensor cores: a 16 x 8 (row) by b 8 x 8 (col) TF32
// product, f32 accumulators
__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 4 matrices of 32-bit words from shared memory, one row address a
// lane (lanes 8j .. 8j + 7 give matrix j's rows); lane l receives word l % 4
// of row l / 4 of each: the TF32 fragments' layout
__device__ __forceinline__ void ldmatrix4(uint32_t (&r)[4], const void* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p)));
}

// one pipeline step into a stage: dimensions [k0, k0 + kDepth) of d1's rows
// [row0, row0 + kTileM) (stage rows 0 .. kTileM) and of d2's rows
// [c0, c0 + kTileN) (stage rows kTileM ..); zeros past N, past col_end and
// past D
__device__ __forceinline__ void stage_step(float* st, const float* d1,
                                           const float* d2, int row0, int c0,
                                           int N, int col_end, int D, int k0,
                                           bool vec) {
    constexpr int kQuads = kDepth / 4;
    for (int q = threadIdx.x; q < (kTileM + kTileN) * kQuads;
         q += kThreads) {
        const int r = q / kQuads;
        const int c4 = 4 * (q - r * kQuads);
        const bool is_b = r >= kTileM;
        const int gr = is_b ? c0 + r - kTileM : row0 + r;
        const bool row_ok = gr < (is_b ? col_end : N);
        const float* base = is_b ? d2 : d1;
        const float* src = base + (size_t)gr * D + k0 + c4;
        float* dst = st + r * kPitch + c4;
        const int left = D - k0 - c4;  // dimensions left in the row
        if (vec) {
            const int bytes = row_ok ? 4 * max(0, min(4, left)) : 0;
            copy16(dst, bytes > 0 ? src : base, bytes);
        } else {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const bool keep = row_ok && j < left;
                copy4(dst + j, keep ? src + j : base, keep);
            }
        }
    }
}

// grid (ceil(N / 128), splits): block (i, s) reduces rows
// [128 i, 128 i + 128) of d1 over rows [s·span, (s + 1)·span) of d2 into
// p1, p2, pidx (splits, N)
__global__ void __launch_bounds__(kThreads, 1)
    min2_partial(const float* __restrict__ d1, const float* __restrict__ d2,
                 const float* __restrict__ n1, const float* __restrict__ n2,
                 int N, int M, int D, int span, int vec,
                 float* __restrict__ p1, float* __restrict__ p2,
                 int* __restrict__ pidx) {
    extern __shared__ __align__(16) float smem[];
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int wm = warp % kWarpsM;  // the warp's rows: wm·32 ..
    const int wn = warp / kWarpsM;  // its columns: wn·64 .. of a tile
    const int g = lane / 4;   // the fragments' row (group) and column pair
    const int t = lane % 4;
    const int row0 = blockIdx.x * kTileM;
    const int split = blockIdx.y;
    const int col_begin = split * span;
    const int col_end = min(M, col_begin + span);
    const int tiles = (col_end - col_begin + kTileN - 1) / kTileN;
    const int chunks = (D + kDepth - 1) / kDepth;
    const int steps = tiles * chunks;
    // each lane's ldmatrix row: A (rows of an m16 tile, + 4 words for
    // matrices 2, 3), B (rows of two n8 tiles, + 4 words for matrices 1, 3)
    const int m8 = lane / 8;
    const int a_off = (wm * kWarpM + (m8 & 1) * 8 + lane % 8) * kPitch
                      + (m8 >> 1) * 4;
    const int b_off = (kTileM + wn * kWarpN + (m8 >> 1) * 8 + lane % 8)
                      * kPitch + (m8 & 1) * 4;

    // the thread's rows: wm·32 + mt·16 + h·8 + g, state r = 2·mt + h
    float m1[kRows], m2[kRows], rn1[kRows];
    int ix[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
        const int row = row0 + wm * kWarpM + (r / 2) * 16 + (r % 2) * 8 + g;
        m1[r] = kBig;
        m2[r] = kBig;
        ix[r] = 0;
        rn1[r] = row < N ? n1[row] : 0.0f;
    }
    // dot products: the tensor cores sum one step (32 dimensions) from
    // zero into part, which is then added into dot in f32 with rounding to
    // nearest (the tensor cores' own f32 sums truncate, and over 128
    // dimensions their error grew to 3e-6 of a unit row's distance)
    float dot[kMT][kNT][4], part[kMT][kNT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) dot[mt][nt][e] = 0.0f;

    auto issue = [&](int s) {
        if (s < steps) {
            const int tile = s / chunks;
            stage_step(smem + (s % kStages) * kStageFloats, d1, d2, row0,
                       col_begin + tile * kTileN, N, col_end, D,
                       (s - tile * chunks) * kDepth, vec);
        }
        copies_commit();  // an empty group past the last step keeps count
    };
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) issue(s);

    for (int s = 0; s < steps; ++s) {
        copies_wait<kStages - 2>();  // step s has landed
        __syncthreads();             // and every warp is done with s - 1
        issue(s + kStages - 1);      // into the stage s - 1 used
        const float* st = smem + (s % kStages) * kStageFloats;
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
            for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) part[mt][nt][e] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < kDepth; kk += 8) {
            // the fragments as f32 bits, then split in registers
            uint32_t ar[kMT][4], br[kNT / 2][4];
#pragma unroll
            for (int mt = 0; mt < kMT; ++mt)
                ldmatrix4(ar[mt], st + a_off + mt * 16 * kPitch + kk);
#pragma unroll
            for (int np = 0; np < kNT / 2; ++np)
                ldmatrix4(br[np], st + b_off + np * 16 * kPitch + kk);
            uint32_t ah[kMT][4], al[kMT][4], bh[kNT / 2][4], bl[kNT / 2][4];
#pragma unroll
            for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    split_tf32(ar[mt][e], ah[mt][e], al[mt][e]);
#pragma unroll
            for (int np = 0; np < kNT / 2; ++np)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    split_tf32(br[np][e], bh[np][e], bl[np][e]);
            // the small terms first, term by term, so that 16 independent
            // products lie between two into one accumulator
#pragma unroll
            for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
                for (int mt = 0; mt < kMT; ++mt)
                    mma_tf32(part[mt][nt], al[mt], bh[nt / 2][2 * (nt % 2)],
                             bh[nt / 2][2 * (nt % 2) + 1]);
#pragma unroll
            for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
                for (int mt = 0; mt < kMT; ++mt)
                    mma_tf32(part[mt][nt], ah[mt], bl[nt / 2][2 * (nt % 2)],
                             bl[nt / 2][2 * (nt % 2) + 1]);
#pragma unroll
            for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
                for (int mt = 0; mt < kMT; ++mt)
                    mma_tf32(part[mt][nt], ah[mt], bh[nt / 2][2 * (nt % 2)],
                             bh[nt / 2][2 * (nt % 2) + 1]);
        }
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
            for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    dot[mt][nt][e] = __fadd_rn(dot[mt][nt][e],
                                               part[mt][nt][e]);
        const int tile = s / chunks;
        if (s - tile * chunks != chunks - 1) continue;
        // --- epilogue of the tile: column c0 + wn·64 + nt·8 + 2t + j of
        // row r = 2·mt + h is dot (mt, nt, 2h + j); the columns outer, in
        // increasing order, one n2 load each; a column past the range
        // pushes +inf, which changes nothing
        const int cw = col_begin + tile * kTileN + wn * kWarpN + 2 * t;
        const bool whole = col_begin + (tile + 1) * kTileN <= col_end;
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                const int col = cw + nt * 8 + j;
                const bool keep = whole || col < col_end;
                const float nn2 = keep ? __ldg(n2 + col) : 0.0f;
#pragma unroll
                for (int r = 0; r < kRows; ++r) {
                    float& a = dot[r / 2][nt][2 * (r % 2) + j];
                    const float d = fmaxf(
                        __fsub_rn(__fadd_rn(rn1[r], nn2), __fmul_rn(2.0f, a)),
                        0.0f);
                    push(keep ? d : INFINITY, col, m1[r], m2[r], ix[r]);
                    a = 0.0f;
                }
            }
    }

    // the 4 lanes of a row (t = 0 .. 3) by shuffles
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
        for (int off = 1; off < 4; off *= 2) {
            const float b1 = __shfl_xor_sync(0xffffffffu, m1[r], off);
            const float b2 = __shfl_xor_sync(0xffffffffu, m2[r], off);
            const int bi = __shfl_xor_sync(0xffffffffu, ix[r], off);
            merge(m1[r], m2[r], ix[r], b1, b2, bi);
        }
    }
    // the warps of a row through shared memory (the stages are free): warp
    // wn > 0 leaves its triples in slot wn - 1, warp 0 merges them
    copies_wait<0>();
    __syncthreads();
    float* x1 = smem;
    float* x2 = smem + (kWarpsN - 1) * kTileM;
    int* xi = reinterpret_cast<int*>(smem + 2 * (kWarpsN - 1) * kTileM);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
        const int lr = wm * kWarpM + (r / 2) * 16 + (r % 2) * 8 + g;
        if (wn > 0 && t == 0) {
            const int o = (wn - 1) * kTileM + lr;
            x1[o] = m1[r];
            x2[o] = m2[r];
            xi[o] = ix[r];
        }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
        const int lr = wm * kWarpM + (r / 2) * 16 + (r % 2) * 8 + g;
        const int row = row0 + lr;
        if (wn == 0 && t == 0 && row < N) {
            for (int w = 0; w < kWarpsN - 1; ++w) {
                const int o = w * kTileM + lr;
                merge(m1[r], m2[r], ix[r], x1[o], x2[o], xi[o]);
            }
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

bool aligned16(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// d1 (N, D), d2 (M, D); n1 (N,), n2 (M,) scratch for the squared norms;
// p1, p2, pidx (splits, N) scratch; min1, min2, idx (N,) outputs. d2's rows
// are cut into `splits` ranges of `span` rows (span a multiple of 128,
// splits * span >= M). Returns the first CUDA error (0 on success).
extern "C" int streaming_min2(const float* d1, const float* d2, float* n1,
                              float* n2, float* p1, float* p2, int* pidx,
                              float* min1, float* min2, int* idx, int N,
                              int M, int D, int splits, int span,
                              void* stream) {
    if (N == 0) return 0;
    if (M < 1 || D < 1 || splits < 1 || span < 1 || span % kTileN != 0 ||
        (long long)splits * span < M)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaFuncSetAttribute(
        min2_partial, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    row_norms<<<(N * 32 + 255) / 256, 256, 0, s>>>(d1, N, D, n1);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    row_norms<<<(M * 32 + 255) / 256, 256, 0, s>>>(d2, M, D, n2);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    // 16-byte copies where every row starts on 16 bytes
    const int vec = D % 4 == 0 && aligned16(d1) && aligned16(d2);
    const dim3 grid((N + kTileM - 1) / kTileM, splits);
    min2_partial<<<grid, kThreads, kSmemBytes, s>>>(
        d1, d2, n1, n2, N, M, D, span, vec, p1, p2, pidx);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    min2_merge<<<(N + 255) / 256, 256, 0, s>>>(p1, p2, pidx, splits, N, min1,
                                               min2, idx);
    return static_cast<int>(cudaGetLastError());
}
