"""Device times of the port's kernels at the shapes their paths give them,
for a same-call comparison of two trees:

    python3 kernel_times.py [--tree DIR] [--label NAME] [--only TEXT]

imports ``kornia_tpu_torch`` from DIR (default: this checkout), builds its
kernels into DIR/build/kernels, checks each wrapper against its plain
version and prints one JSON line of device ms (torch.profiler, 20 calls,
each from a cold L2) per case; ``--only`` keeps the cases whose name holds
TEXT (``--only patch_sample``: both patch modes on the paths' own
coordinates). To compare a parent commit with the working tree on one card,
unpack the parent into a git-ignored directory and run, in one command,
parent, change, change, parent:

    git archive HEAD | tar -x -C chip_scratch/parent
    for t in chip_scratch/parent . . chip_scratch/parent; do
        python3 kernel_times.py --tree $t; done

Needs a CUDA card; exits 2 without one.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent


def _smoke():
    """chip_smoke.py of this checkout (device_ms, the bound rules)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forced(K, knobs, fn):
    """fn run with the module constants K.<name> set as `knobs` says (a
    route forced), restored after each call."""
    def run():
        old = {k: getattr(K, k) for k in knobs}
        for k, v in knobs.items():
            setattr(K, k, v)
        try:
            return fn()
        finally:
            for k, v in old.items():
                setattr(K, k, v)
    return run


def cases(K, dev):
    """(name, kernel call, plain call, bound ms) at the paths' shapes: the
    pair's blurs at each shape, the SSIM blur and adjoints at (8, 3, 480,
    640), the multi-level adjoint at each octave of 480x640 (and, where the
    tree has route knobs, each route forced) and the streaming matcher."""
    from kornia_tpu_torch.ops.filters import get_gaussian_kernel1d
    from kornia_tpu_torch.ops.pyramid import ScalePyramid
    cs = _smoke()
    gen = torch.Generator(device=dev).manual_seed(0)
    out = []
    k15 = get_gaussian_kernel1d(15, math.sqrt(1.6 ** 2 - 0.5 ** 2),
                                device=dev).reshape(-1)
    k5 = torch.tensor([1.0, 4.0, 6.0, 4.0, 1.0], device=dev) / 16.0
    k11 = get_gaussian_kernel1d(11, 1.5, device=dev).reshape(-1)
    taps = {15: k15, 5: k5}
    shapes = cs.path_launch_shapes(cs.H, cs.W)
    for h, w, k, border in dict.fromkeys(shapes["fused_separable_blur2d"]):
        x = torch.rand((1, 1, h, w), device=dev, generator=gen)
        kk = taps[k]
        out.append((f"fused {h}x{w} k{k} {border}",
                    lambda x=x, kk=kk, b=border:
                        K.fused_separable_blur2d(x, kk, kk, b),
                    lambda x=x, kk=kk, b=border:
                        K.fused_separable_blur2d_plain(x, kk, kk, b),
                    cs.blur_bound(h, w, 1, 2 * k)[0]))
    kers = ScalePyramid(3, 1.6, 32)._level_kernels(1.6)[0]
    chain = 2 * sum(k.numel() for k in kers)
    for h, w in shapes["multi_level_blur"]:
        x = torch.rand((1, 1, h, w), device=dev, generator=gen)
        out.append((f"multi_level {h}x{w} L{len(kers)}",
                    lambda x=x: K.multi_level_blur(x, kers, kers),
                    lambda x=x: K.multi_level_blur_plain(x, kers, kers),
                    cs.ml_bound(h, w, 1, len(kers), chain)[0]))
    g = torch.rand(cs.TRAIN_SHAPE, device=dev, generator=gen)
    n, _, h, w = g.shape
    nimg = g.numel() // (h * w)
    sb = cs.blur_bound(h, w, nimg, 22)[0]
    out.append(("fused SSIM 8x3x480x640 k11 reflect",
                lambda: K.fused_separable_blur2d(g, k11, k11, "reflect"),
                lambda: K.fused_separable_blur2d_plain(g, k11, k11, "reflect"),
                sb))
    for border in ("reflect", "replicate", "constant", "circular"):
        out.append((f"fused adjoint SSIM k11 {border}",
                    lambda b=border: K.fused_separable_blur2d_adjoint(
                        g, k11, k11, b),
                    lambda b=border: K.fused_separable_blur2d_adjoint_plain(
                        g, k11, k11, b), sb))
    L = len(kers)
    grads = {}
    for h, w in shapes["multi_level_blur"]:
        gl = grads[h, w] = torch.rand((L, 1, 1, h, w), device=dev,
                                      generator=gen)
        out.append((f"multi_level adjoint {h}x{w} L{L}",
                    lambda gl=gl: K.multi_level_blur_adjoint(gl, kers, kers),
                    lambda gl=gl: K.multi_level_blur_adjoint_plain(
                        gl, kers, kers),
                    cs.ml_bound(h, w, 1, L, chain)[0]))
    # the band adjoint's routes forced, where the tree has them: tiled and
    # passes at every octave and at the SSIM shape (the readings that set
    # _ADJOINT_TILED_FILL)
    if hasattr(K, "_ADJOINT_TILED_FILL"):
        knobs = {"tiled": dict(_ADJOINT_TILED_FILL=0.0),
                 "passes": dict(_ADJOINT_TILED_FILL=math.inf)}
        for tag, kn in knobs.items():
            for (h, w), gl in grads.items():
                out.append((
                    f"multi_level adjoint {h}x{w} L{L} [{tag}]",
                    forced(K, kn, lambda gl=gl: K.multi_level_blur_adjoint(
                        gl, kers, kers)),
                    lambda gl=gl: K.multi_level_blur_adjoint_plain(
                        gl, kers, kers),
                    cs.ml_bound(h, w, 1, L, chain)[0]))
            out.append((f"fused adjoint SSIM k11 reflect [{tag}]",
                        forced(K, kn, lambda: K.fused_separable_blur2d_adjoint(
                            g, k11, k11, "reflect")),
                        lambda: K.fused_separable_blur2d_adjoint_plain(
                            g, k11, k11, "reflect"), sb))
    # unit rows, as descriptors are: distances at most 2. Bound: the
    # product accurate to f32 as three TF32 products on the tensor cores
    d1, d2 = (torch.nn.functional.normalize(torch.rand(
        (cs.MATCH_N, cs.MATCH_D), device=dev, generator=gen), dim=-1)
        for _ in range(2))
    out.append(("streaming_min2 8192x8192x128",
                lambda: K.streaming_min2(d1, d2)[0],
                lambda: K.streaming_min2_plain(d1, d2)[0],
                3 * 2 * cs.MATCH_N ** 2 * cs.MATCH_D / cs.H100_TF32_FLOPS
                * 1e3))
    return cs, out + patch_cases(K, cs, dev)


def patch_cases(K, cs, dev) -> list:
    """patch_sample in both modes on the coordinates the paths give it: the
    pair's SIFTFeature (1024 keypoints: 19² orientation and 41² descriptor
    patches), the tracker's and the stitch's GFTTSIFTFeature (512), config
    2's HardNet (32², 1024) and the KeyNet pair's 32² patches (2048)."""
    from kornia_tpu_torch.feature.integrated import (GFTTSIFTFeature,
                                                     KeyNetAffNetHardNet)
    img = cs.bench_input(cs.H, cs.W, dev)[0]
    feats = {"pair": None,
             "gftt": GFTTSIFTFeature(num_features=cs.PLANAR_NF),
             "config2": cs.config2_feature(dev),
             "keynet": KeyNetAffNetHardNet(num_features=cs.KEYNET_NF,
                                           device=dev)}
    seen, out = set(), []
    for path, feat in feats.items():
        with torch.no_grad():
            calls = cs.capture_patch_coords(dev, img, feat)
        for atlas, px, py in calls:
            key = (tuple(atlas.shape), tuple(px.shape))
            if key in seen:
                continue
            seen.add(key)
            b = cs.patch_bound(atlas.numel(), px.numel())[0]
            for mode in ("split", "bf16"):
                out.append((
                    f"patch_sample[{mode}] {path} {px.shape[0]}x"
                    f"{px.shape[1]} on {atlas.shape[0]}x{atlas.shape[1]}",
                    lambda a=atlas, x=px, y=py, m=mode: K.patch_sample(
                        a, x, y, m),
                    lambda a=atlas, x=px, y=py, m=mode: K.patch_sample_plain(
                        a, x, y, m), b))
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tree", default=str(HERE))
    p.add_argument("--label", default=None)
    p.add_argument("--only", default="")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    from kornia_tpu_torch.core.linalg import f32_precision
    from kornia_tpu_torch.ops import kernels as K
    if Path(K.__file__).resolve().parents[2] != tree:
        raise RuntimeError(f"imported {K.__file__}, not the tree {tree}")
    K.build_kernels()
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    res = {}
    with f32_precision():
        cs, todo = cases(K, dev)
        for name, kern, plain, b in todo:
            if args.only not in name:
                continue
            err = (kern() - plain()).abs().max().item()
            # bf16 patches: the plain version's own roundings
            if not err <= (1e-6 if "[bf16]" in name else 1e-5):
                raise RuntimeError(f"{name}: {err} from the plain version")
            ms = cs.device_ms(kern)
            res[name] = dict(ms=ms, bound_ms=b, max_abs_err=err)
            print(f"{args.label or tree.name}: {name}: {ms:.4f} ms, bound "
                  f"{b:.5f} ({ms / b:.1f}x), err {err:.2e}", flush=True)
    print(json.dumps({"tree": args.label or str(tree), "card": card,
                      "times": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
