"""Colour conversions and colour maps of the port against the JAX package
(``kornia_tpu/ops/{color,colormap}.py``) on the CPU.

Tolerances: 1e-5 absolute for maps of [0, 1] images; 1e-4 for Lab, Luv and
XYZ (values up to 100 from cube roots and powers); hue compared on the
circle, 1e-4 rad; bit for bit for the pure rearrangements (flips, RGBA,
the Bayer mosaic).
"""

import numpy as np
import pytest
import torch

import kornia_tpu.ops.color as jc
import kornia_tpu.ops.colormap as jcm
import kornia_tpu_torch.ops.color as tc
import kornia_tpu_torch.ops.colormap as tcm
from tests.torch_op_parity import (Case, batch_references, check_close,
                                   rand, run_case)
from tests.torch_threads import one_torch_thread  # noqa: F401

IMG = rand(2, 3, 16, 16)
GRAY = rand(2, 1, 16, 16, seed=1)
# pure colours and greys: hue on its bin boundaries, zero saturation
PURE = np.zeros((1, 3, 2, 4), np.float32)
PURE[0, :, 0, :] = np.eye(3, 4, dtype=np.float32) * [1, 1, 1, 0]
PURE[0, :, 1, :] = 0.5
HSV = np.concatenate([rand(2, 1, 16, 16, hi=2 * np.pi, seed=2),
                      rand(2, 2, 16, 16, seed=3)], axis=1)
LAB = np.concatenate([rand(2, 1, 8, 8, hi=100.0, seed=4),
                      rand(2, 2, 8, 8, lo=-60.0, hi=60.0, seed=5)], axis=1)
NORMALS = rand(2, 3, 8, 8, lo=-1.0, hi=1.0, seed=6)
CMAP = rand(16, 3, seed=7)

CASES = {
    "rgb_to_grayscale": Case("rgb_to_grayscale", (IMG,)),
    "rgb_to_grayscale_weights": Case("rgb_to_grayscale", (IMG,),
                                     {"rgb_weights": [0.2, 0.5, 0.3]}),
    "bgr_to_grayscale": Case("bgr_to_grayscale", (IMG,)),
    "grayscale_to_rgb": Case("grayscale_to_rgb", (GRAY,), atol=0),
    "rgb_to_bgr": Case("rgb_to_bgr", (IMG,), atol=0),
    "bgr_to_rgb": Case("bgr_to_rgb", (IMG,), atol=0),
    "rgb_to_rgba": Case("rgb_to_rgba", (IMG, 0.5), atol=0),
    "bgr_to_rgba": Case("bgr_to_rgba", (IMG,), atol=0),
    "rgba_to_rgb": Case("rgba_to_rgb", (rand(2, 4, 8, 8),), atol=0),
    "rgba_to_bgr": Case("rgba_to_bgr", (rand(2, 4, 8, 8),), atol=0),
    "rgb_to_linear_rgb": Case("rgb_to_linear_rgb", (IMG,)),
    "linear_rgb_to_rgb": Case("linear_rgb_to_rgb", (IMG,)),
    "rgb_to_hsv": Case("rgb_to_hsv", (IMG,), atol=1e-4, circle=True),
    "rgb_to_hsv_pure": Case("rgb_to_hsv", (PURE,), atol=1e-4, circle=True),
    "hsv_to_rgb": Case("hsv_to_rgb", (HSV,)),
    "rgb_to_hls": Case("rgb_to_hls", (IMG,), atol=1e-4, circle=True),
    "hls_to_rgb": Case("hls_to_rgb", (HSV,)),
    "rgb_to_xyz": Case("rgb_to_xyz", (IMG,), atol=1e-4),
    "xyz_to_rgb": Case("xyz_to_rgb", (IMG,), atol=1e-4),
    "rgb_to_lab": Case("rgb_to_lab", (IMG,), atol=1e-4),
    "lab_to_rgb": Case("lab_to_rgb", (LAB,), atol=1e-4),
    "lab_to_rgb_unclipped": Case("lab_to_rgb", (LAB, False), atol=1e-4),
    # exact: the fused cube root moves L by 1.3e-4
    "rgb_to_luv": Case("rgb_to_luv", (IMG,), atol=1e-4, exact=True),
    "luv_to_rgb": Case("luv_to_rgb", (LAB,), atol=1e-4),
    "rgb_to_ycbcr": Case("rgb_to_ycbcr", (IMG,)),
    "ycbcr_to_rgb": Case("ycbcr_to_rgb", (IMG,)),
    "rgb_to_yuv": Case("rgb_to_yuv", (IMG,)),
    "yuv_to_rgb": Case("yuv_to_rgb", (IMG,)),
    "rgb_to_yuv420": Case("rgb_to_yuv420", (IMG,)),
    "yuv420_to_rgb": Case("yuv420_to_rgb", (GRAY, rand(2, 2, 8, 8, seed=8))),
    "rgb_to_yuv422": Case("rgb_to_yuv422", (IMG,)),
    "yuv422_to_rgb": Case("yuv422_to_rgb", (GRAY,
                                            rand(2, 2, 16, 8, seed=9))),
    "rgb_to_raw_BG": Case("rgb_to_raw", (IMG, "BG"), atol=0),
    "rgb_to_raw_GR": Case("rgb_to_raw", (IMG, "GR"), atol=0),
    "raw_to_rgb_RG": Case("raw_to_rgb", (GRAY, "RG")),
    "raw_to_rgb_GB": Case("raw_to_rgb", (GRAY, "GB")),
    "raw_to_rgb_2x2_downscaled": Case("raw_to_rgb_2x2_downscaled",
                                      (GRAY, "BG")),
    "rgb_to_y": Case("rgb_to_y", (IMG,)),
    "rgb_to_rgb255": Case("rgb_to_rgb255", (IMG,), atol=1e-4),
    "rgb255_to_rgb": Case("rgb255_to_rgb", (IMG * 255,)),
    "normals_to_rgb255": Case("normals_to_rgb255", (NORMALS,), atol=1e-4),
    "rgb255_to_normals": Case("rgb255_to_normals", (IMG * 255,)),
    "sepia": Case("sepia", (IMG,)),
    "sepia_unscaled": Case("sepia", (IMG, False)),
    "sepia_from_rgb": Case("sepia_from_rgb", (IMG,)),
    "apply_colormap": Case("apply_colormap", (GRAY, CMAP)),
    # the round trips the op registry runs
    "hsv_round_trip": Case("", (IMG,), jax_fn=lambda x: jc.hsv_to_rgb(
        jc.rgb_to_hsv(x)), torch_fn=lambda x: tc.hsv_to_rgb(
            tc.rgb_to_hsv(x))),
    "lab_round_trip": Case("", (IMG,), atol=1e-4, jax_fn=lambda x:
                           jc.lab_to_rgb(jc.rgb_to_lab(x)), torch_fn=lambda
                           x: tc.lab_to_rgb(tc.rgb_to_lab(x))),
}


@pytest.fixture(scope="module")
def refs():
    return batch_references(CASES, jc)


@pytest.mark.parametrize("name", list(CASES))
def test_color_matches_reference(name, refs):
    run_case(CASES[name], tc, refs[name])


def test_cfa_enum_layouts():
    for member in tc.CFA:
        check_close(tc.rgb_to_raw(torch.from_numpy(IMG), member),
                    jc.rgb_to_raw(IMG, jc.CFA[member.name]), 0)


@pytest.mark.parametrize("base", [t.value for t in jcm.ColorMapType])
def test_colormap_tables(base):
    want = jcm.ColorMap(base, 32)
    got = tcm.ColorMap(base, 32, device="cpu")
    assert len(got) == len(want) == 32
    check_close(got.colors, want.colors, 1e-6)
    check_close(tcm.ApplyColorMap(got)(torch.from_numpy(GRAY)),
                jcm.ApplyColorMap(want)(GRAY), 1e-5)
