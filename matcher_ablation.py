"""Where the streaming matcher's time goes, on one CUDA card:

    python3 matcher_ablation.py

builds ``kornia_tpu_torch/csrc/streaming_min2.cu`` as it is and in variants
with one part of its work cut out or replaced (each a text patch of the
source, which fails loudly where the source no longer matches), times each
in turns (forward, then backward) on chip_smoke.py's match-phase data
(8192 x 8192 x 128 unit rows), reports each variant's distance error
against the true-f32 plain version and the SMNN rows it changes, and
measures the peak rate of ``mma.sync`` on the card (TF32 m16n8k8 and bf16
m16n8k16, independent accumulators, no memory traffic). The variants that
cut work out compute wrong results by design; they bound the cost of the
part they cut. Prints one JSON line last. Needs a CUDA card and nvcc;
exits 2 without a card.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent

# variant -> [(pattern, replacement, expected count)]: text patches of the
# committed source
PUSH_BRANCHY = """    if (v < m1) {
        m2 = m1;
        m1 = v;
        ix = c;
    } else if (v < m2) {
        m2 = v;
    }
}"""
VARIANTS = {
    "as committed": [],
    # the top-2 epilogue as branches (the kernel's first form)
    "branchy epilogue": [(
        r"    const bool first = v < m1;\n.*?    m1 = first \? v : m1;\n}",
        PUSH_BRANCHY, 1)],
    # no running top-2: only the minimum distance
    "cheap epilogue": [(
        r"push\(keep \? d : INFINITY, col, m1\[r\], m2\[r\], ix\[r\]\);",
        "m1[r] = fminf(m1[r], keep ? d : INFINITY);", 1)],
    # no hi/lo split: the f32 bits straight to the tensor cores, lo = 0
    "no split": [(
        r"    hi = tf32\(__uint_as_float\(x\)\);\n    lo = tf32\(.*?\);",
        "    hi = x;\n    lo = 0u;", 1)],
    # one product (hi·hi) instead of three
    "one product": [(r"mma_tf32\(part\[mt\]\[nt\], al\[mt\]",
                     "if (false) mma_tf32(part[mt][nt], al[mt]", 1),
                    (r"mma_tf32\(part\[mt\]\[nt\], ah\[mt\], bl",
                     "if (false) mma_tf32(part[mt][nt], ah[mt], bl", 1)],
    # all dimensions of a tile summed inside the tensor cores (no f32 add
    # per 32-dimension step)
    "one accumulator": [
        (r"for \(int e = 0; e < 4; \+\+e\) "
         r"part\[mt\]\[nt\]\[e\] = 0\.0f;",
         "for (int e = 0; e < 4; ++e) if (s % chunks == 0) "
         "part[mt][nt][e] = 0.0f;", 1),
        (r"dot\[mt\]\[nt\]\[e\] = __fadd_rn\(dot\[mt\]\[nt\]\[e\],"
         r"\s*part\[mt\]\[nt\]\[e\]\);",
         "dot[mt][nt][e] = part[mt][nt][e];", 1)],
}

MMA_PEAK_SRC = r"""
#include <cstdint>
#include <cstdio>
#include <cuda_runtime.h>
template <bool kBf16>
__global__ void loop(float* out, int iters) {
    float acc[16][4] = {};
    const uint32_t one = kBf16 ? 0x3f803f80u : 0x3f800000u;
    const uint32_t a0 = one ^ threadIdx.x, a1 = one, a2 = one, a3 = one;
    const uint32_t b0 = one, b1 = one;
    for (int i = 0; i < iters; ++i) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
            if (kBf16)
                asm volatile(
                    "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                    "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                    : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]),
                      "+f"(acc[j][3])
                    : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
            else
                asm volatile(
                    "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                    "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                    : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]),
                      "+f"(acc[j][3])
                    : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
        }
    }
    float s = 0.0f;
    for (int j = 0; j < 16; ++j)
        for (int e = 0; e < 4; ++e) s += acc[j][e];
    if (s == 1.2345f) out[threadIdx.x] = s;
}
template <bool kBf16>
void run(int warps_per_sm) {
    int sms;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
    float* out;
    cudaMalloc(&out, 4096);
    const int iters = 2048, blocks = sms * warps_per_sm / 8;
    loop<kBf16><<<blocks, 256>>>(out, 16);
    cudaEvent_t e0, e1;
    cudaEventCreate(&e0);
    cudaEventCreate(&e1);
    cudaEventRecord(e0);
    loop<kBf16><<<blocks, 256>>>(out, iters);
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    float ms;
    cudaEventElapsedTime(&ms, e0, e1);
    const double flops = 2.0 * 16 * 8 * (kBf16 ? 16 : 8) * 16.0 * iters
                         * blocks * 8;
    printf("%s %d %.1f %s\n", kBf16 ? "bf16" : "tf32", warps_per_sm,
           flops / ms / 1e9, cudaGetErrorString(cudaGetLastError()));
}
int main() {
    run<false>(8);
    run<false>(16);
    run<true>(8);
    return 0;
}
"""


def _module(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def patched(src: str, patches) -> str:
    for pattern, repl, count in patches:
        src, n = re.subn(pattern, lambda _m, r=repl: r, src, flags=re.S)
        if n != count:
            raise RuntimeError(f"patch {pattern!r} matched {n} times, "
                               f"expected {count}: the source changed")
    return src


def main() -> int:
    if not torch.cuda.is_available():
        print("matcher_ablation: no CUDA device; nothing was run",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    from kornia_tpu_torch.core.linalg import f32_precision
    from kornia_tpu_torch.feature.matching import DescriptorMatcher
    from kornia_tpu_torch.ops import kernels as K
    cs = _module("chip_smoke", HERE / "chip_smoke.py")
    card = cs.card_line()
    print(card)
    K.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=K.BUILD_DIR))
    src = (K.CSRC_DIR / K.SOURCES["streaming_min2"]).read_text()
    procs = {}
    for i, (name, patches) in enumerate(VARIANTS.items()):
        cu = work / f"variant{i}.cu"
        cu.write_text(patched(src, patches))
        so = work / f"variant{i}.so"
        procs[name] = (subprocess.Popen(
            [K._nvcc(), *K.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    (work / "mma_peak.cu").write_text(MMA_PEAK_SRC)
    peak = subprocess.Popen(
        [K._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-o",
         str(work / "mma_peak"), str(work / "mma_peak.cu")])
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        regs = re.search(r"min2_partial.*?Used (\d+) registers", log, re.S)
        print(f"{name}: {regs.group(1) if regs else '?'} registers")
        libs[name] = so
    if peak.wait():
        raise RuntimeError("mma peak probe: nvcc failed")
    rates = {}
    for line in subprocess.run([str(work / "mma_peak")], capture_output=True,
                               text=True, check=True).stdout.splitlines():
        kind, warps, tflops, status = line.split(maxsplit=3)
        if status != "no error":
            raise RuntimeError(f"mma peak probe: {status}")
        rates[f"{kind} {warps} warps/SM"] = float(tflops)
        print(f"mma.sync {kind}, {warps} warps an SM: {tflops} TFLOP/s")

    def use(so):
        K._LIBS["streaming_min2"] = ctypes.CDLL(str(so))
        K._FNS.pop("streaming_min2", None)

    dev = torch.device("cuda", 0)
    res = {}
    with f32_precision():
        gen = torch.Generator(device=dev).manual_seed(cs.SEED + 4)
        n, d = cs.MATCH_N, cs.MATCH_D

        def unit(t):
            t = t.abs()
            return t / t.norm(dim=-1, keepdim=True)

        d1 = unit(torch.randn((n, d), device=dev, generator=gen))
        perm = torch.randperm(n, device=dev, generator=gen)
        d2 = unit(d1[perm] + 0.02 * torch.randn((n, d), device=dev,
                                                generator=gen))
        th = 0.95
        rd, rm, rv = DescriptorMatcher("smnn", th)(d1, d2)
        ref = K.streaming_min2_plain(d1, d2)
        for name, so in libs.items():
            use(so)
            o = K.streaming_min2(d1, d2)
            err = max((o[0] - ref[0]).abs().max().item(),
                      (o[1] - ref[1]).abs().max().item())
            dist, matches, valid = DescriptorMatcher("smnn", th,
                                                     streaming=True)(d1, d2)
            bad = ((matches != rm).any(-1) | (valid != rv)
                   | ((dist - rd).abs()[:, 0] > cs.MATCH_ATOL))
            res[name] = dict(max_abs_err=err, smnn_rows_differing=int(
                bad.sum()), ms=[])
        for name in list(libs) + list(libs)[::-1]:
            use(libs[name])
            res[name]["ms"].append(cs.device_ms(
                lambda: K.streaming_min2(d1, d2)))
    for name, r in res.items():
        print(f"{name}: {[round(v, 5) for v in r['ms']]} ms, max abs err "
              f"{r['max_abs_err']:.3e}, SMNN rows differing "
              f"{r['smnn_rows_differing']}")
    print(json.dumps({"card": card, "mma_sync_tflops": rates,
                      "variants": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
