"""Where patch_sample's time goes, on one CUDA card:

    python3 patch_ablation.py

builds ``kornia_tpu_torch/csrc/patch_sample.cu`` as committed, variants of
it (text patches of the source, which fail loudly where the source no
longer matches) and the bulk-copy ring design it was measured against
(RING_SRC below), and times each in turns (chip_smoke.device_ms: from a
cold L2) on:

* the paths' own coordinates on bench.py's 480x640 image: the pair's
  SIFTFeature (1024 keypoints: 19² orientation and 41² descriptor
  patches), the tracker's GFTTSIFTFeature (512), config 2's HardNet (32²)
  and the KeyNet pair's 32² patches (2048), and the descriptor call with
  each patch's samples sorted by texel address (the best locality any
  order of the same samples could give);
* 1024 synthetic 41x41 patches at 2 px spacing, turned 0, 45 and 90
  degrees and at random angles, on the descriptor call's atlas.

Variants: "as committed" (two samples a thread, csrc/patch_sample.cu's
note); with 256-thread blocks, 8 an SM; its grid without the cap of
kBlocksPerSm blocks an SM (a block for every 128 pairs); a thread's two
samples 32 apart (a warp's lanes on 32 consecutive samples, 4-byte
loads); evict-first stores (st.global.cs); "one sample a thread" (every sample sent to the one-a-thread loop, a
block for every 128 samples: the design before this one, in 128-thread
blocks); "four samples a
thread" (16-byte loads and stores); "no texel loads" (the streams alone:
the texels replaced by values of the coordinates, wrong by design: it
bounds what the gathers cost); "bulk-copy ring" (a persistent grid, two
blocks an SM, whose producer thread keeps four tiles of 1024 samples in
flight with cp.async.bulk into shared memory). Each that computes the
function is held to the plain version first. Prints one JSON line last.
Needs a CUDA card and nvcc; exits 2 without a card.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import math
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent

PAIR_BODY = (r"        const long long i = head \+ 2 \* g;\n.*?"
             r"b\.tx, b\.ty\)\);\n")
FOUR_BODY = """        const long long i = head + 4 * g;
        const float4 x4 = __ldcs(reinterpret_cast<const float4*>(px + i));
        const float4 y4 = __ldcs(reinterpret_cast<const float4*>(py + i));
        const float x[4] = {x4.x, x4.y, x4.z, x4.w};
        const float y[4] = {y4.x, y4.y, y4.z, y4.w};
        Taps t[4];
        float v[4][4];
#pragma unroll
        for (int k = 0; k < 4; ++k) t[k] = taps(H, W, x[k], y[k]);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            v[k][0] = __ldg(atlas + t[k].i00);
            v[k][1] = __ldg(atlas + t[k].i01);
            v[k][2] = __ldg(atlas + t[k].i10);
            v[k][3] = __ldg(atlas + t[k].i11);
        }
        float r[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
            r[k] = combine<kBf16>(v[k][0], v[k][1], v[k][2], v[k][3],
                                  t[k].tx, t[k].ty);
        *reinterpret_cast<float4*>(out + i) =
            make_float4(r[0], r[1], r[2], r[3]);
"""
SPLIT_BODY = """        // a warp's 64 samples: lane l takes samples l and 32 + l
        const long long i = head + (g >> 5) * 64 + (g & 31);
        const Taps a = taps(H, W, __ldcs(px + i), __ldcs(py + i));
        const Taps b = taps(H, W, __ldcs(px + i + 32), __ldcs(py + i + 32));
        const float a00 = __ldg(atlas + a.i00), a01 = __ldg(atlas + a.i01);
        const float a10 = __ldg(atlas + a.i10), a11 = __ldg(atlas + a.i11);
        const float b00 = __ldg(atlas + b.i00), b01 = __ldg(atlas + b.i01);
        const float b10 = __ldg(atlas + b.i10), b11 = __ldg(atlas + b.i11);
        out[i] = combine<kBf16>(a00, a01, a10, a11, a.tx, a.ty);
        out[i + 32] = combine<kBf16>(b00, b01, b10, b11, b.tx, b.ty);
"""
UNCAPPED = (r"const long long cap = \(long long\)sms \* kBlocksPerSm;",
            "const long long cap = want;", 1)
# variant -> [(pattern, replacement, expected count)], and the (head,
# pairs) its wrapper call passes, for 16-byte aligned streams (None: the
# committed _patch_plan)
VARIANTS = {
    "as committed": ([], None),
    "256-thread blocks": ([(r"constexpr int kThreads = 128;",
                            "constexpr int kThreads = 256;", 1),
                           (r"constexpr int kBlocksPerSm = 16;",
                            "constexpr int kBlocksPerSm = 8;", 1)], None),
    "grid without a cap": ([UNCAPPED], None),
    "two a thread, 32 apart": ([(PAIR_BODY, SPLIT_BODY, 1)],
                               lambda n: (0, n // 2 // 32 * 32)),
    "one sample a thread": ([UNCAPPED], lambda n: (0, 0)),
    "four samples a thread": ([
        (PAIR_BODY, FOUR_BODY, 1),
        (r"const long long body_end = head \+ 2 \* pairs;",
         "const long long body_end = head + 4 * pairs;", 1),
        (r"const long long items = pairs \+ \(total - 2 \* pairs\);",
         "const long long items = pairs + (total - 4 * pairs);", 1)],
        lambda n: (0, n // 4)),
    "evict-first stores": ([
        (r"\*reinterpret_cast<float2\*>\(out \+ i\) =\n\s*(make_float2\(.*?\)\));",
         r"__stcs(reinterpret_cast<float2*>(out + i), \1);", 1),
        (r"out\[i\] = (sample_one<kBf16>\(.*?\));",
         r"__stcs(out + i, \1);", 1)], None),
    "no texel loads": ([(r"__ldg\(atlas \+ ([ab])\.(i\d\d)\)",
                         r"__int_as_float(\1.\2)", 8)], None),
    "bulk-copy ring": (None, lambda n: (0, 0)),
}

RING_SRC = r"""
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kConsumerWarps = 8;
constexpr int kConsumers = kConsumerWarps * 32;
constexpr int kThreads = kConsumers + 32;  // + one producer warp
constexpr int kPerThread = 4;  // one 16-byte load and store a thread
constexpr int kTile = kConsumers * kPerThread;  // samples a stage
constexpr int kStages = 4;
constexpr int kPad = 4;  // a misaligned stream's copy spans kTile + 4
static_assert(kTile % 4 == 0, "tiles start on 16-byte output boundaries");

struct Ring {
    alignas(16) float x[kStages][kTile + kPad];
    alignas(16) float y[kStages][kTile + kPad];
    alignas(8) uint64_t full[kStages];
    alignas(8) uint64_t empty[kStages];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    uint32_t done = 0;
    while (!done) {
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n"
            "}\n"
            : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
    }
}

__device__ __forceinline__ uint64_t evict_first_policy() {
    uint64_t policy;
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
                 : "=l"(policy));
    return policy;
}

// bytes of global memory at src -> shared memory at dst, counted on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar,
                                          uint64_t policy) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n"
        :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)),
           "l"(policy)
        : "memory");
}

// The 16-byte-aligned span of a stream that holds samples [a, a + kTile):
// its first sample and its length in samples (kTile, or kTile + kPad when
// the stream is misaligned).
__device__ __forceinline__ void stream_span(const float* p, long long a,
                                            long long* first, int* count) {
    const int shift = (int)((reinterpret_cast<uintptr_t>(p + a) >> 2) & 3);
    *first = a - shift;
    *count = shift ? kTile + kPad : kTile;
}

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

// Four consecutive samples of a stage, `shift` floats past p: one 16-byte
// read where the stream is aligned (no bank conflict), else four.
__device__ __forceinline__ void load4(const float* p, int shift,
                                      float (&v)[4]) {
    if (shift == 0) {
        const float4 q = *reinterpret_cast<const float4*>(p);
        v[0] = q.x;
        v[1] = q.y;
        v[2] = q.z;
        v[3] = q.w;
    } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] = p[shift + k];
    }
}

template <bool kBf16>
__device__ __forceinline__ void run(const float* __restrict__ atlas, int H,
                                    int W, const float* __restrict__ px,
                                    const float* __restrict__ py,
                                    float* __restrict__ out, long long total,
                                    long long head, int tiles) {
    __shared__ Ring ring;
    const int tid = threadIdx.x;
    if (tid == 0) {
        for (int s = 0; s < kStages; ++s) {
            mbar_init(&ring.full[s], 1);
            mbar_init(&ring.empty[s], kConsumerWarps);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (tid >= kConsumers) {
        // the producer: one thread keeps kStages tiles in flight
        if (tid != kConsumers) return;
        const uint64_t policy = evict_first_policy();
        int stage = 0;
        uint32_t phase = 0;
        for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
            mbar_wait(&ring.empty[stage], phase ^ 1);
            const long long a = head + (long long)t * kTile;
            long long fx, fy;
            int nx, ny;
            stream_span(px, a, &fx, &nx);
            stream_span(py, a, &fy, &ny);
            mbar_expect_tx(&ring.full[stage], (uint32_t)(nx + ny) * 4u);
            bulk_load(ring.x[stage], px + fx, (uint32_t)nx * 4u,
                      &ring.full[stage], policy);
            bulk_load(ring.y[stage], py + fy, (uint32_t)ny * 4u,
                      &ring.full[stage], policy);
            if (++stage == kStages) {
                stage = 0;
                phase ^= 1;
            }
        }
        return;
    }

    // the head and the tail after the last whole tile: one sample a thread
    const long long body_end = head + (long long)tiles * kTile;
    const long long rest = head + (total - body_end);
    for (long long r = (long long)blockIdx.x * kConsumers + tid; r < rest;
         r += (long long)gridDim.x * kConsumers) {
        const long long i = r < head ? r : body_end + (r - head);
        __stcs(out + i, sample_one<kBf16>(atlas, H, W, __ldcs(px + i),
                                          __ldcs(py + i)));
    }

    // the consumers: kPerThread consecutive samples of each tile a thread
    const int lane = tid & 31;
    const int j0 = tid * kPerThread;
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const long long a = head + (long long)t * kTile;
        // where this tile's samples start in the stage (0 when aligned)
        const int sx = (int)((reinterpret_cast<uintptr_t>(px + a) >> 2) & 3);
        const int sy = (int)((reinterpret_cast<uintptr_t>(py + a) >> 2) & 3);
        mbar_wait(&ring.full[stage], phase);
        float x[kPerThread], y[kPerThread];
        load4(ring.x[stage] + j0, sx, x);
        load4(ring.y[stage] + j0, sy, y);
        __syncwarp();
        if (lane == 0) mbar_arrive(&ring.empty[stage]);
        if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
        }
        Taps tp[kPerThread];
        float v[kPerThread][4];
#pragma unroll
        for (int k = 0; k < kPerThread; ++k) tp[k] = taps(H, W, x[k], y[k]);
#pragma unroll
        for (int k = 0; k < kPerThread; ++k) {
            v[k][0] = __ldg(atlas + tp[k].i00);
            v[k][1] = __ldg(atlas + tp[k].i01);
            v[k][2] = __ldg(atlas + tp[k].i10);
            v[k][3] = __ldg(atlas + tp[k].i11);
        }
        float r[kPerThread];
#pragma unroll
        for (int k = 0; k < kPerThread; ++k) {
            r[k] = combine<kBf16>(v[k][0], v[k][1], v[k][2], v[k][3],
                                  tp[k].tx, tp[k].ty);
        }
        __stcs(reinterpret_cast<float4*>(out + a + j0),
               make_float4(r[0], r[1], r[2], r[3]));
    }
}

__global__ void __launch_bounds__(kThreads)
patch_sample_kernel(const float* __restrict__ atlas, int H, int W,
                    const float* __restrict__ px,
                    const float* __restrict__ py, float* __restrict__ out,
                    long long total, long long head, int tiles) {
    run<false>(atlas, H, W, px, py, out, total, head, tiles);
}

__global__ void __launch_bounds__(kThreads)
patch_sample_bf16_kernel(const float* __restrict__ atlas, int H, int W,
                         const float* __restrict__ px,
                         const float* __restrict__ py,
                         float* __restrict__ out, long long total,
                         long long head, int tiles) {
    run<true>(atlas, H, W, px, py, out, total, head, tiles);
}

}  // namespace

extern "C" int patch_sample(const float* atlas, int H, int W, const float* px,
                            const float* py, float* out, long long total,
                            long long, long long, int sms, int bf16,
                            void* stream) {
    if (total == 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int tiles = (int)(total / kTile);  // 16-byte aligned streams only
    const int cap = 2 * sms;                 // two blocks an SM: the fastest
    const int grid = tiles < 1 ? 1 : (tiles < cap ? tiles : cap);
    if (bf16) {
        patch_sample_bf16_kernel<<<grid, kThreads, 0, s>>>(
            atlas, H, W, px, py, out, total, 0, tiles);
    } else {
        patch_sample_kernel<<<grid, kThreads, 0, s>>>(atlas, H, W, px, py,
                                                      out, total, 0, tiles);
    }
    return static_cast<int>(cudaGetLastError());
}
"""


def _module(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def patched(src: str, patches) -> str:
    for pattern, repl, count in patches:
        src, n = re.subn(pattern, lambda m, r=repl: m.expand(r)
                         if "\\" in r else r, src, flags=re.S)
        if n != count:
            raise RuntimeError(f"patch {pattern!r} matched {n} times, "
                               f"expected {count}: the source changed")
    return src


def synthetic(dev, gen, n, ps, angle, h, w, spacing=2.0):
    """n patches of ps x ps samples `spacing` px apart, turned by `angle`
    degrees (None: a random angle each), centred inside the atlas."""
    t = (torch.arange(ps, device=dev, dtype=torch.float32)
         - (ps - 1) / 2) * spacing
    gy, gx = torch.meshgrid(t, t, indexing="ij")
    th = (torch.rand((n, 1, 1), device=dev, generator=gen) * 2 * math.pi
          if angle is None else
          torch.full((n, 1, 1), math.radians(angle), device=dev))
    cx = 60 + torch.rand((n, 1, 1), device=dev, generator=gen) * (w - 120)
    cy = 60 + torch.rand((n, 1, 1), device=dev, generator=gen) * (h - 120)
    px = cx + gx * torch.cos(th) - gy * torch.sin(th)
    py = cy + gx * torch.sin(th) + gy * torch.cos(th)
    return px.reshape(n, -1).contiguous(), py.reshape(n, -1).contiguous()


def main() -> int:
    if not torch.cuda.is_available():
        print("patch_ablation: no CUDA device; nothing was run",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    from kornia_tpu_torch.core.linalg import f32_precision
    from kornia_tpu_torch.ops import kernels as K
    cs = _module("chip_smoke", HERE / "chip_smoke.py")
    card = cs.card_line()
    print(card)
    K.build_kernels()
    work = Path(tempfile.mkdtemp(dir=K.BUILD_DIR))
    src = (K.CSRC_DIR / K.SOURCES["patch_sample"]).read_text()
    procs = {}
    for i, (name, (patches, _)) in enumerate(VARIANTS.items()):
        cu = work / f"variant{i}.cu"
        cu.write_text(RING_SRC if patches is None else patched(src, patches))
        so = work / f"variant{i}.so"
        procs[name] = (subprocess.Popen(
            [K._nvcc(), *K.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        regs = re.search(r"patch_sample_kernel.*?Used (\d+) registers", log,
                         re.S)
        print(f"{name}: {regs.group(1) if regs else '?'} registers")
        libs[name] = ctypes.CDLL(str(so))
    real_plan = K._patch_plan

    def use(name):
        K._LIBS["patch_sample"] = libs[name]
        K._FNS.pop("patch_sample", None)
        plan = VARIANTS[name][1]
        K._patch_plan = real_plan if plan is None else (
            lambda n, *_: plan(n))

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    cases = {}
    with f32_precision(), torch.no_grad():
        from kornia_tpu_torch.feature.integrated import (GFTTSIFTFeature,
                                                         KeyNetAffNetHardNet)
        use("as committed")
        img = cs.bench_input(cs.H, cs.W, dev)[0]
        for path, feat in (
                ("gftt", GFTTSIFTFeature(num_features=cs.PLANAR_NF)),
                ("config2", cs.config2_feature(dev)),
                ("keynet", KeyNetAffNetHardNet(num_features=cs.KEYNET_NF,
                                               device=dev)),
                ("pair", None)):
            for atlas, px, py in cs.capture_patch_coords(dev, img, feat):
                n, s = px.shape
                cases.setdefault(f"{path} {n}x{s}", (atlas, px, py))
        W = atlas.shape[1]
        order = (py.floor() * W + px.floor()).argsort(dim=1)
        cases[f"pair {n}x{s}, sorted by texel"] = (
            atlas, px.gather(1, order).contiguous(),
            py.gather(1, order).contiguous())
        for angle in (0, 45, 90, None):
            cases[f"synthetic 1024x1681, "
                  f"{'random angles' if angle is None else f'{angle} deg'}"
                  ] = (atlas, *synthetic(dev, gen, 1024, 41, angle,
                                         *atlas.shape))
    for _, px, py in cases.values():
        if px.data_ptr() % 16 or py.data_ptr() % 16:
            raise RuntimeError("the ablation's streams must be 16-byte "
                               "aligned (the four-a-thread and ring "
                               "variants assume it)")
    res = {name: {"max_abs_err": None, "ms": {c: [] for c in cases}}
           for name in libs}
    for name in libs:
        use(name)
        if name == "no texel loads":
            continue
        err = 0.0
        for atlas, px, py in list(cases.values())[:6]:
            for mode in ("split", "bf16"):
                got = K.patch_sample(atlas, px, py, mode)
                err = max(err, (got - K.patch_sample_plain(
                    atlas, px, py, mode)).abs().max().item())
        if not err <= cs.PATCH_ATOL:
            raise RuntimeError(f"{name}: {err} from the plain version")
        res[name]["max_abs_err"] = err
    for name in list(libs) + list(libs)[::-1]:
        use(name)
        for case, (atlas, px, py) in cases.items():
            res[name]["ms"][case].append(cs.device_ms(
                lambda: K.patch_sample(atlas, px, py)))
    use("as committed")
    for case, (atlas, px, py) in cases.items():
        b = cs.patch_bound(atlas.numel(), px.numel())[0]
        print(f"{case} (bound {b:.5f} ms):")
        for name in libs:
            v = res[name]["ms"][case]
            print(f"  {name:>22}: {[round(x, 5) for x in v]} ms "
                  f"({b / min(v):.3f} of the bound at best)")
    print(json.dumps({"card": card, "variants": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
