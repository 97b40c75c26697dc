// Bilinear patch sampling for Hopper (sm_90a): out[n, s] = atlas(px, py).
//
// Replaces kornia_tpu/ops/pallas_kernels.py patch_sample_mxu (:539, its
// pallas_call :595, body _patch_sample_kernel :440) in its three modes. The
// TPU kernel avoids per-element gathers, which are slow there: it copies a
// 128x256 window of the atlas per keypoint into VMEM and evaluates the
// samples as 2-hot matrix products, so samples past the window clamp to its
// edge. Its 'split' and 'highest' modes are f32-exact (patch_sample_kernel
// here); its 'bf16' mode runs the row pass as one default-precision
// product, so the matrix unit rounds the two y weights (1 - ty, ty) and the
// two rows' texels to bf16, multiplies them exactly and sums in f32, and
// the x interpolation then runs in f32 (patch_sample_bf16_kernel repeats
// that arithmetic per sample). There is no window here: every keypoint is
// sampled exactly whatever its extent. The coordinate is clamped into the
// atlas first and the second tap to the last row/column: grid_sample's
// 'border' rule with align_corners=True in pixel units.
//
// What bounds it on the card. The function moves 12 bytes a sample (px
// and py in, the sample out) and reads the atlas once: at the pair's 1024 x
// 1681 samples on a 900 x 640 atlas, 20.7 MB of streams and 2.3 MB of
// atlas, 6.85 us at 3.35 TB/s; about 13 flops a sample. On the H100 the
// streams alone (patch_ablation.py's "no texel loads") reach about 70% of
// that rate, and the gathers add to them as their texels spread over cache
// lines: a warp's 32 samples along a patch row share a few 128-byte lines
// when the patch is upright and touch 32 atlas rows when it is turned 90
// degrees, and LAFs are turned every way (PERF.md §6 has the figures).
//
// What the design does about it: a grid-stride loop, at most kBlocksPerSm
// blocks of kThreads an SM (the wrapper passes the SM count), over pairs
// of consecutive samples. A thread reads its two px and two py with one
// 8-byte streaming load each (ld.global.cs: evict-first, so the streams do
// not push the atlas out of L2), issues all eight texel loads (read-only
// path) before it uses any, and writes both samples with one 8-byte store
// (evict-first stores, st.global.cs, gained nothing overall). A thread's
// two samples are neighbours in the patch, so their texels share lines,
// and each thread has twice the loads in flight of one sample a thread. A
// stream that starts on an odd 4-byte offset takes its first sample one a
// thread (the wrapper puts the output on the same parity); px and py on
// different parities go one a thread throughout; the odd sample at the end
// too. Those single samples run on the threads after the pairs', idle
// ones where the grid has them. Measured against it (patch_ablation.py):
// one and four consecutive samples a thread, 256-thread blocks, an
// uncapped grid, a thread's two samples 32 apart, evict-first stores, and
// a persistent kernel whose producer thread keeps the next tiles'
// coordinates in flight with 1-D bulk asynchronous copies (cp.async.bulk,
// an mbarrier a stage) into a ring of shared-memory stages. The ring was
// the slowest at every path shape: the streams are not what waits, and
// each block's start delays the small calls.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBlocksPerSm = 16;  // the grid-stride loop's grid, at most

__device__ __forceinline__ float bf16_round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

// The texel offsets and fractions of one sample (the 'border' rule).
struct Taps {
    int i00, i01, i10, i11;
    float tx, ty;
};

__device__ __forceinline__ Taps taps(int H, int W, float px, float py) {
    const float x = fminf(fmaxf(px, 0.0f), (float)(W - 1));
    const float y = fminf(fmaxf(py, 0.0f), (float)(H - 1));
    const float x0f = floorf(x);
    const float y0f = floorf(y);
    const int x0 = (int)x0f;
    const int y0 = (int)y0f;
    const int x1 = min(x0 + 1, W - 1);
    const int y1 = min(y0 + 1, H - 1);
    Taps t;
    t.tx = x - x0f;
    t.ty = y - y0f;
    t.i00 = y0 * W + x0;
    t.i01 = y0 * W + x1;
    t.i10 = y1 * W + x0;
    t.i11 = y1 * W + x1;
    return t;
}

// One bilinear value from its four texels (row, column). bf16: rows first,
// as the matrix unit does: a product of two bf16 values is exact in f32,
// so each column's sum rounds once; the x pass then rounds each product
// and the sum, with no fused multiply-add, as the plain version
// (kornia_tpu_torch/ops/kernels.py::patch_sample_plain) does.
template <bool kBf16>
__device__ __forceinline__ float combine(float v00, float v01, float v10,
                                         float v11, float tx, float ty) {
    if (kBf16) {
        const float wy0 = bf16_round(1.0f - ty);
        const float wy1 = bf16_round(ty);
        const float p0 = __fadd_rn(__fmul_rn(wy0, bf16_round(v00)),
                                   __fmul_rn(wy1, bf16_round(v10)));
        const float p1 = __fadd_rn(__fmul_rn(wy0, bf16_round(v01)),
                                   __fmul_rn(wy1, bf16_round(v11)));
        return __fadd_rn(__fmul_rn(p0, 1.0f - tx), __fmul_rn(p1, tx));
    }
    const float top = v00 * (1.0f - tx) + v01 * tx;
    const float bot = v10 * (1.0f - tx) + v11 * tx;
    return top * (1.0f - ty) + bot * ty;
}

template <bool kBf16>
__device__ __forceinline__ float sample_one(const float* __restrict__ atlas,
                                            int H, int W, float px,
                                            float py) {
    const Taps t = taps(H, W, px, py);
    return combine<kBf16>(__ldg(atlas + t.i00), __ldg(atlas + t.i01),
                          __ldg(atlas + t.i10), __ldg(atlas + t.i11), t.tx,
                          t.ty);
}

template <bool kBf16>
__device__ __forceinline__ void run(const float* __restrict__ atlas, int H,
                                    int W, const float* __restrict__ px,
                                    const float* __restrict__ py,
                                    float* __restrict__ out, long long total,
                                    long long head, long long pairs) {
    // items [0, pairs): the pairs of samples [head, head + 2 * pairs), two
    // a thread; then the head and the tail, one sample an item, on the
    // threads after the pairs' (idle ones where the grid has them)
    const long long body_end = head + 2 * pairs;
    const long long items = pairs + head + (total - body_end);
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         g < items; g += stride) {
        if (g >= pairs) {
            const long long r = g - pairs;
            const long long i = r < head ? r : body_end + (r - head);
            out[i] = sample_one<kBf16>(atlas, H, W, __ldcs(px + i),
                                       __ldcs(py + i));
            continue;
        }
        const long long i = head + 2 * g;
        const float2 x = __ldcs(reinterpret_cast<const float2*>(px + i));
        const float2 y = __ldcs(reinterpret_cast<const float2*>(py + i));
        const Taps a = taps(H, W, x.x, y.x);
        const Taps b = taps(H, W, x.y, y.y);
        const float a00 = __ldg(atlas + a.i00), a01 = __ldg(atlas + a.i01);
        const float a10 = __ldg(atlas + a.i10), a11 = __ldg(atlas + a.i11);
        const float b00 = __ldg(atlas + b.i00), b01 = __ldg(atlas + b.i01);
        const float b10 = __ldg(atlas + b.i10), b11 = __ldg(atlas + b.i11);
        *reinterpret_cast<float2*>(out + i) =
            make_float2(combine<kBf16>(a00, a01, a10, a11, a.tx, a.ty),
                        combine<kBf16>(b00, b01, b10, b11, b.tx, b.ty));
    }
}

__global__ void __launch_bounds__(kThreads)
patch_sample_kernel(const float* __restrict__ atlas, int H, int W,
                    const float* __restrict__ px,
                    const float* __restrict__ py, float* __restrict__ out,
                    long long total, long long head, long long pairs) {
    run<false>(atlas, H, W, px, py, out, total, head, pairs);
}

__global__ void __launch_bounds__(kThreads)
patch_sample_bf16_kernel(const float* __restrict__ atlas, int H, int W,
                         const float* __restrict__ px,
                         const float* __restrict__ py,
                         float* __restrict__ out, long long total,
                         long long head, long long pairs) {
    run<true>(atlas, H, W, px, py, out, total, head, pairs);
}

}  // namespace

// atlas (H, W) with H * W < 2^31; px, py, out (total,) with total =
// keypoints * samples. Samples [head, head + 2 * pairs) go two a thread,
// so px + head, py + head and out + head must be 8-byte aligned; the rest
// one a thread (kornia_tpu_torch/ops/kernels.py::_patch_plan). sms: the
// card's SM count. bf16 != 0 selects the bf16 row pass. Returns the
// launch's CUDA error.
extern "C" int patch_sample(const float* atlas, int H, int W, const float* px,
                            const float* py, float* out, long long total,
                            long long head, long long pairs, int sms,
                            int bf16, void* stream) {
    if (total == 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const long long items = pairs + (total - 2 * pairs);
    const long long want = (items + kThreads - 1) / kThreads;
    const long long cap = (long long)sms * kBlocksPerSm;
    const unsigned int grid = (unsigned int)(want < cap ? want : cap);
    if (bf16) {
        patch_sample_bf16_kernel<<<grid, kThreads, 0, s>>>(
            atlas, H, W, px, py, out, total, head, pairs);
    } else {
        patch_sample_kernel<<<grid, kThreads, 0, s>>>(atlas, H, W, px, py,
                                                      out, total, head,
                                                      pairs);
    }
    return static_cast<int>(cudaGetLastError());
}
