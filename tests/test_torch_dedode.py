"""The port's DeDoDe and DINOv2 (kornia_tpu_torch: feature/dedode.py and
feature/dinov2.py whole) against the JAX package on the CPU.

The detector (L) runs the golden family's parameters (the reference's draw
from ``PRNGKey(0)``) and reproduces tests/golden/models_golden.json at
tests/test_golden_models.py's tolerance. Descriptor B and descriptor G on
a DINOv2 of 2 layers, 64 wide, 2 heads, whose position grid (5x5) is not
the patch grid (4x4 at 56x56, so the bicubic interpolation runs), take
flax variables drawn with numpy from the port's parameter tables
(``tests/torch_op_parity.py::flax_variables``). DeDoDe-B runs end to end
(detector, coverage-weighted top-k, descriptors at the keypoints) at
56x56; ``sample_keypoints`` also runs on a score map with plateaus (exact
ties). The JAX references come from four jitted programs compiled side
by side with ``FAST_OPTIONS`` (``tests/torch_op_parity.py::
compile_parallel``): the detector's draw (``flax_init_program``'s grouped
form of the reference's init), DeDoDe-B, G with its ViT, and the ops.

Tolerances: net outputs within 1e-4 of their largest |entry|; the same
keypoints in every slot, the padded tie order included (normalised
coordinates within 1e-6: XLA rounds (x + 0.5) / W · 2 - 1 one ulp apart,
and neighbouring pixels are 2 / W apart); scores 1e-6 of the largest;
descriptors at the keypoints 1e-4 of the largest.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from kornia_tpu.feature import dedode as j_dd
from kornia_tpu.feature import dinov2 as j_v
from kornia_tpu_torch import convert
from kornia_tpu_torch.feature import _nets
from kornia_tpu_torch.feature import dedode as t_dd
from kornia_tpu_torch.feature import dinov2 as t_v
from tests.golden_builders import _img, probe
from tests.torch_op_parity import (FAST_OPTIONS, compile_parallel,
                                   flax_init_program, flax_variables)
from tests.torch_threads import one_torch_thread  # noqa: F401

VIT = dict(patch_size=14, embed_dim=64, depth=2, num_heads=2, mlp_ratio=4.0,
           init_values=1.0, pos_grid=5)
_RNG = np.random.default_rng(0)
IMG = gaussian_filter(_RNG.uniform(0, 1, (1, 3, 56, 56)),
                      (0, 0, 1.5, 1.5)).astype(np.float32)
VIT_VARS = flax_variables(t_v._param_rows(14, 64, 2, 4.0, 5), 1)
G_VARS = flax_variables(t_dd._descriptor_g_rows(256, 64)
                        + t_v._param_rows(14, 64, 2, 4.0, 5, ("dinov2",)), 2)
B_VARS = flax_variables(t_dd._descriptor_b_rows(256), 3)
# a softmax-like score map with plateaus: exact ties in the top-k
_S = gaussian_filter(_RNG.uniform(0, 1, (2, 40, 48)), (0, 2, 2))
_S[:, 10:16, 10:20] = _S.max()
_S[1, 30:, :] = 0.0
SCORES = (_S / _S.sum((1, 2), keepdims=True)).astype(np.float32)
# jax.image's bilinear upsampling at the walk's steps (G: 4 → 7) and at a
# factor that is no integer
UP = _RNG.normal(size=(1, 4, 5, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def refs():
    def draw(key):
        return j_dd.DeDoDeDetector().init(key, jnp.zeros((1, 64, 64, 3)))

    def b_refs(img, det_vars, b_vars):
        return dict(b=j_dd.DeDoDe(num_keypoints=96, params_det=det_vars,
                                  params_desc=b_vars)(img))

    def g_refs(img, vit_vars, g_vars):
        xn = jnp.transpose(img, (0, 2, 3, 1))
        return dict(vit=j_v.DinoV2ViT(**VIT).apply(vit_vars, xn),
                    g=j_dd.DeDoDeDescriptorG(vit_cfg=VIT).apply(g_vars, xn))

    def op_refs(scores, up):
        return dict(kp={c: j_dd.sample_keypoints(scores, 300, c)
                        for c in (True, False)},
                    up=[jax.image.resize(up, (1, 7, 7, 3), "bilinear"),
                        jax.image.resize(up, (1, 9, 13, 3), "bilinear")])

    key = jax.random.PRNGKey(0)
    d_fn, d_args, d_finish, d_avals = flax_init_program(draw, key)
    img = jnp.asarray(IMG)
    tree = lambda v: jax.tree_util.tree_map(jnp.asarray, v)  # noqa: E731
    b_args = [img, d_avals, tree(B_VARS)]
    g_args = [img, tree(VIT_VARS), tree(G_VARS)]
    o_args = [jnp.asarray(SCORES), jnp.asarray(UP)]
    d, b, g, o = compile_parallel([(d_fn, d_args), (b_refs, b_args),
                                   (g_refs, g_args), (op_refs, o_args)],
                                  FAST_OPTIONS)
    det_vars = d_finish(d(*d_args))
    out = dict(det_vars=det_vars, **b(img, det_vars, b_args[2]),
               **g(*g_args), **o(*o_args))
    return jax.tree_util.tree_map(np.asarray, out)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(got, want, rtol):
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


def test_dedode_detector_reproduces_golden_family(refs):
    with open(os.path.join(os.path.dirname(__file__), "golden",
                           "models_golden.json")) as f:
        expect = json.load(f)["dedode_detector"]
    det = _nets.make(t_dd.DeDoDeDetector, _nets.from_flax(
        t_dd._detector_rows(), refs["det_vars"]), None, "cpu")
    got = probe(det(_t(_img((1, 3, 64, 64)))).numpy())
    assert got["size"] == expect["size"]
    tol = 1e-4 * max(abs(expect["absmax"]), 1e-3)
    assert abs(got["mean"] - expect["mean"]) < tol
    assert abs(got["std"] - expect["std"]) < tol
    np.testing.assert_allclose(got["values"], expect["values"], atol=10 * tol)


def test_dedode_b_matches_reference(refs):
    """Detector L, the coverage density through the fused blur's plain
    version, the top-96 and descriptor B at the keypoints."""
    m = convert.dedode_from_numpy(refs["det_vars"], B_VARS, "B",
                                  device="cpu", num_keypoints=96)
    kps, scores, descs = m(_t(IMG))
    wk, ws, wd = refs["b"]
    np.testing.assert_allclose(kps.numpy(), wk, rtol=0, atol=1e-5)
    _rel(scores, ws, 1e-6)
    _rel(descs, wd, 1e-4)
    dense = m.describe(_t(IMG))
    assert dense.shape == (1, 256, 56, 56)


def test_dinov2_matches_reference(refs):
    vit = convert.dinov2_from_numpy(VIT_VARS, VIT, "cpu")
    out = vit(_t(IMG))
    assert out.shape == (1, 64, 4, 4)
    _rel(out.permute(0, 2, 3, 1), refs["vit"], 1e-4)


def test_dedode_g_matches_reference(refs):
    m = convert.dedode_from_numpy(refs["det_vars"], G_VARS, "G",
                                  vit_cfg=VIT, device="cpu")
    dense = m.descriptor(_t(IMG))
    _rel(dense.permute(0, 2, 3, 1), refs["g"], 1e-4)


@pytest.mark.parametrize("coverage", [True, False])
def test_sample_keypoints_matches_reference(refs, coverage):
    """Plateaus make exact ties: the same keypoints in every slot."""
    kps, scores = t_dd.sample_keypoints(_t(SCORES), 300, coverage)
    wk, ws = refs["kp"][coverage]
    np.testing.assert_allclose(kps.numpy(), wk, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(scores.numpy(), ws)


def test_bilinear_steps_follow_jax_image(refs):
    x = _t(UP).permute(0, 3, 1, 2)
    for (h, w), want in zip(((7, 7), (9, 13)), refs["up"]):
        got = t_dd._bilinear(x, (h, w)).permute(0, 2, 3, 1)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_bicubic_position_operator_is_torch_interpolate():
    """The port's copy of the reference's operator is torch's bicubic
    interpolation at the (g + 0.1) / pos_grid scale."""
    g, out = 5, 4
    A = t_v._torch_bicubic_matrix(g, out, (out + 0.1) / g)
    np.testing.assert_array_equal(A, j_v._torch_bicubic_matrix(
        g, out, (out + 0.1) / g))
    x = torch.from_numpy(_RNG.normal(size=(1, 3, g, g)).astype(np.float32))
    ref = torch.nn.functional.interpolate(
        x, scale_factor=(out + 0.1) / g, mode="bicubic", align_corners=False)
    got = torch.einsum("oh,bchw,pw->bcop", torch.from_numpy(A), x,
                       torch.from_numpy(A))
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-5)


def test_loaders_and_seeded_heads():
    """The checkpoint names load back through the loaders (G's ViT under
    ``dinov2.``); seeded heads draw the detector first, then the
    descriptor, all frozen."""
    m = t_dd.DeDoDe(descriptor="G", vit_cfg=VIT, device="cpu")
    sd = {k: v.detach() for k, v in m.descriptor.named_parameters()
          if not k.startswith("dinov2.")}
    vit_sd = {k[7:]: v.detach() for k, v in m.descriptor.named_parameters()
              if k.startswith("dinov2.")}
    out = t_dd.load_dedode_descriptor_g_torch_weights(sd, None)
    assert sorted(out) == sorted(sd)
    assert out["decoder.layers.14.hidden_blocks.4.0.weight"].shape == \
        (768, 1, 5, 5)
    assert sorted(t_v.load_dinov2_torch_weights(vit_sd, depth=2)) == \
        sorted(vit_sd)
    det_sd = dict(m.detector.named_parameters())
    assert len(t_dd.load_dedode_detector_torch_weights(det_sd)) == \
        len(det_sd)
    with pytest.raises(KeyError):
        t_dd.load_dedode_torch_weights(det_sd, "descriptor_x")
    assert not any(p.requires_grad for p in m.parameters())
    with pytest.raises(ValueError):
        m(torch.zeros(1, 3, 64, 64))   # G needs multiples of 56
