// Bilinear patch sampling for Hopper (sm_90a): out[n, s] = atlas(px, py).
//
// Replaces kornia_tpu/ops/pallas_kernels.py patch_sample_mxu
// (_patch_sample_kernel) in its three modes. The TPU kernel avoids
// per-element gathers, which are slow there: it copies a 128x256 window of
// the atlas per keypoint into VMEM and evaluates the samples as 2-hot
// matrix products, so samples past the window clamp to its edge. Its
// 'split' and 'highest' modes are f32-exact (patch_sample_kernel here);
// its 'bf16' mode runs the row pass as one default-precision product, so
// the matrix unit rounds the two y weights (1 - ty, ty) and the two rows'
// texels to bf16, multiplies them exactly and sums in f32, and the x
// interpolation then runs in f32 (patch_sample_bf16_kernel repeats that
// arithmetic per sample).
//
// What bounds it on the card: bytes. Each sample reads two coordinates,
// gathers four texels and writes one value (about 5 flops of arithmetic;
// a few more in bf16 mode for the roundings); the coordinate and output
// streams (12 bytes a sample) dominate, since the atlas (2.3 MB at 900x640)
// stays in the 50 MB L2 cache.
//
// What the design does about it: one thread per sample, with coalesced
// reads of px/py and a coalesced write of the output; the four texel loads
// go through the read-only cache and hit L2. There is no window, so every
// keypoint is sampled exactly whatever its extent. The coordinate is
// clamped into the atlas first and the second tap to the last row/column:
// grid_sample's 'border' rule with align_corners=True in pixel units.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

struct Taps {
    float tx, ty;              // fractional offsets
    float v00, v01, v10, v11;  // texels (row, column)
};

__device__ __forceinline__ Taps gather(const float* __restrict__ atlas,
                                       int H, int W, float px, float py) {
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
    t.v00 = __ldg(atlas + (size_t)y0 * W + x0);
    t.v01 = __ldg(atlas + (size_t)y0 * W + x1);
    t.v10 = __ldg(atlas + (size_t)y1 * W + x0);
    t.v11 = __ldg(atlas + (size_t)y1 * W + x1);
    return t;
}

__global__ void patch_sample_kernel(const float* __restrict__ atlas, int H,
                                    int W, const float* __restrict__ px,
                                    const float* __restrict__ py,
                                    float* __restrict__ out,
                                    long long total) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= total) return;
    const Taps t = gather(atlas, H, W, px[i], py[i]);
    const float top = t.v00 * (1.0f - t.tx) + t.v01 * t.tx;
    const float bot = t.v10 * (1.0f - t.tx) + t.v11 * t.tx;
    out[i] = top * (1.0f - t.ty) + bot * t.ty;
}

__device__ __forceinline__ float bf16_round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

// Rows first, as the matrix unit does: a product of two bf16 values is
// exact in f32, so each column's sum rounds once. The x pass then rounds
// each product and the sum, with no fused multiply-add, as the plain
// version (kornia_tpu_torch/ops/kernels.py::patch_sample_plain) does.
__global__ void patch_sample_bf16_kernel(const float* __restrict__ atlas,
                                         int H, int W,
                                         const float* __restrict__ px,
                                         const float* __restrict__ py,
                                         float* __restrict__ out,
                                         long long total) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= total) return;
    const Taps t = gather(atlas, H, W, px[i], py[i]);
    const float wy0 = bf16_round(1.0f - t.ty);
    const float wy1 = bf16_round(t.ty);
    const float p0 = __fadd_rn(__fmul_rn(wy0, bf16_round(t.v00)),
                               __fmul_rn(wy1, bf16_round(t.v10)));
    const float p1 = __fadd_rn(__fmul_rn(wy0, bf16_round(t.v01)),
                               __fmul_rn(wy1, bf16_round(t.v11)));
    out[i] = __fadd_rn(__fmul_rn(p0, 1.0f - t.tx), __fmul_rn(p1, t.tx));
}

}  // namespace

// atlas (H, W); px, py, out (total,) with total = keypoints * samples;
// bf16 != 0 selects the bf16 row pass. Returns the launch's CUDA error.
extern "C" int patch_sample(const float* atlas, int H, int W, const float* px,
                            const float* py, float* out, long long total,
                            int bf16, void* stream) {
    if (total == 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int threads = 256;
    const unsigned int blocks =
        (unsigned int)((total + threads - 1) / threads);
    if (bf16) {
        patch_sample_bf16_kernel<<<blocks, threads, 0, s>>>(atlas, H, W, px,
                                                            py, out, total);
    } else {
        patch_sample_kernel<<<blocks, threads, 0, s>>>(atlas, H, W, px, py,
                                                       out, total);
    }
    return static_cast<int>(cudaGetLastError());
}
