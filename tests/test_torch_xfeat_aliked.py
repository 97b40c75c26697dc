"""The port's XFeat and ALIKED (kornia_tpu_torch: feature/xfeat.py and
feature/aliked.py whole, and feature/extras.py's ALIKEDFeatures,
InterpolateSparse2d and XFeatModel) against the JAX package on the CPU.

XFeat runs on 1x1x64x96, ALIKED ("aliked-t16") on 1x3x64x64 and its grey
twin. XFeat runs the golden family's parameters (the reference's draw
from ``PRNGKey(0)``); ALIKED's flax variables are drawn with numpy from the
port's parameter table (``tests/torch_op_parity.py::flax_variables``, with
batch-norm statistics away from the identity). Both cross through
``convert.{xfeat,aliked}_from_numpy``. The
JAX references come from three jitted programs (the draw, XFeat's and
ALIKED's references) compiled side by side with ``FAST_OPTIONS``
(``tests/torch_op_parity.py::compile_parallel``); the xfeat golden family reproduces
tests/golden/models_golden.json at tests/test_golden_models.py's
tolerance.

Tolerances: net outputs within 1e-4 of their largest |entry|; keypoint
sets, validity and matches equal, the padded slots included (every top-k
keeps the lower index first among ties, as ``lax.top_k``); scores 1e-5;
descriptors 1e-4; subpixel keypoints (ALIKED, XFeat*) within 1e-3 px; LAF
affines within 1e-4 of their largest entry.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from kornia_tpu.feature import aliked as j_al
from kornia_tpu.feature import extras as j_ext
from kornia_tpu.feature import xfeat as j_xf
from kornia_tpu_torch import convert
from kornia_tpu_torch.feature import _nets
from kornia_tpu_torch.feature import aliked as t_al
from kornia_tpu_torch.feature import extras as t_ext
from kornia_tpu_torch.feature import xfeat as t_xf
from tests.golden_builders import _img, probe
from tests.torch_op_parity import (FAST_OPTIONS, compile_parallel,
                                   flax_variables)
from tests.torch_threads import one_torch_thread  # noqa: F401


def _smooth(seed, shape, sigma=1.5):
    rng = np.random.default_rng(seed)
    return gaussian_filter(rng.uniform(0, 1, shape),
                           (0,) * (len(shape) - 2) + (sigma, sigma)
                           ).astype(np.float32)


XF0 = _smooth(0, (1, 1, 64, 96))
XF1 = np.roll(XF0, 3, -1).copy()
AL = _smooth(1, (1, 3, 64, 64))
AL_GREY = AL[:, :1].copy()
# DKD's input: plateaus (exact ties among NMS survivors and in the
# zero-filled border) and a few peaks, two images
_T = np.zeros((2, 24, 32), np.float32)
_T[0, 4:20:4, 4:28:4] = 0.5            # equal peaks: ties in the top-k
_T[0, 10, 13] = 0.9
_T[1] = 0.05 * _smooth(2, (1, 1, 24, 32))[0, 0]   # nothing clears 0.2
_T[1, 6, 9], _T[1, 15, 20] = 0.15, 0.12
TIES = _T
POS = (np.random.default_rng(3).uniform(0, 1, (1, 40, 2))
       * [95, 63]).astype(np.float32)
DKD = {"subpixel": dict(), "pixel": dict(subpixel=False),
       "affine": dict(return_affine=True),
       "pixel_affine": dict(subpixel=False, return_affine=True),
       "no_threshold": dict(scores_th=0.0)}
ALIKED_VARS = flax_variables(t_al._param_rows("aliked-t16"), 4)


@pytest.fixture(scope="module")
def refs():
    def xfeat_refs(xp, x0, x1, pos):
        xf = j_xf.XFeat(top_k=256, params=xp)
        feats = j_xf.xfeat_model(xp, x0)
        return dict(
            model=feats, det=xf.detectAndCompute(x0),
            mnn=xf.match_xfeat(x0, x1), star=xf.match_xfeat_star(x0, x1),
            dense=xf.detectAndComputeDense(x0, 128, multiscale=False),
            interp=j_ext.InterpolateSparse2d("bilinear")(feats[0], pos, 64,
                                                        96))

    def aliked_refs(al, ties, avars):
        m = j_al.ALIKED("aliked-t16", num_keypoints=64, params=avars)
        return dict(
            aliked=m(al),
            net=m.model.apply(avars, jnp.transpose(al, (0, 2, 3, 1)),
                              method=lambda mod, x: mod.net(x)),
            dkd={k: j_al.dkd_detect(ties, 40, **kw) for k, kw in DKD.items()})

    key = jax.random.PRNGKey(0)
    x_args = [jnp.asarray(a) for a in (XF0, XF1, POS)]
    a_args = [jnp.asarray(AL), jnp.asarray(TIES),
              jax.tree_util.tree_map(jnp.asarray, ALIKED_VARS)]
    draw, xfr, alr = compile_parallel([
        (j_xf.xfeat_init_params, [key]),
        (xfeat_refs, [jax.eval_shape(j_xf.xfeat_init_params, key)]
         + x_args),
        (aliked_refs, a_args)], FAST_OPTIONS)
    xp = draw(key)
    out = dict(xparams=xp, **xfr(xp, *x_args), **alr(*a_args))
    return jax.tree_util.tree_map(np.asarray, out)


@pytest.fixture(scope="module")
def xfeat(refs):
    return convert.xfeat_from_numpy(refs["xparams"], "cpu", top_k=256)


@pytest.fixture(scope="module")
def aliked(refs):
    return convert.aliked_from_numpy(ALIKED_VARS, "aliked-t16", "cpu",
                                     num_keypoints=64)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _rel(got, want, rtol):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


# --- XFeat ------------------------------------------------------------------

def test_xfeat_reproduces_golden_family(refs):
    with open(os.path.join(os.path.dirname(__file__), "golden",
                           "models_golden.json")) as f:
        expect = json.load(f)["xfeat"]
    net = t_ext.XFeatModel(params=_nets.from_flax(t_xf._param_rows(),
                                                  refs["xparams"]),
                           device="cpu")
    out = net(_t(np.asarray(_img((1, 1, 64, 64)))))
    got = probe(np.concatenate([o.numpy().ravel() for o in out]))
    assert got["size"] == expect["size"]
    tol = 1e-4 * max(abs(expect["absmax"]), 1e-3)
    assert abs(got["mean"] - expect["mean"]) < tol
    assert abs(got["std"] - expect["std"]) < tol
    np.testing.assert_allclose(got["values"], expect["values"], atol=10 * tol)


def test_xfeat_model_matches_reference(refs, xfeat):
    got = t_xf.xfeat_model(xfeat.params, _t(XF0))
    for g, w in zip(got, refs["model"]):
        assert g.shape == w.shape
        _rel(g, w, 1e-4)


def test_xfeat_detect_and_compute_matches_reference(refs, xfeat):
    """Keypoints of every slot equal: at 64x96 most of the score map is
    the -1 fill, so the padded slots are ties the stable top-k orders."""
    got = xfeat.detectAndCompute(_t(XF0))
    want = refs["det"]
    np.testing.assert_array_equal(got["valid"].numpy(), want["valid"])
    np.testing.assert_array_equal(got["keypoints"].numpy(),
                                  want["keypoints"])
    np.testing.assert_allclose(got["scores"].numpy(), want["scores"],
                               atol=1e-5)
    np.testing.assert_allclose(got["descriptors"].numpy(),
                               want["descriptors"], atol=1e-4)
    assert want["valid"].sum() >= 8


def test_xfeat_mnn_match_matches_reference(refs, xfeat):
    got = xfeat.match_xfeat(_t(XF0), _t(XF1))
    for g, w in zip(got, refs["mnn"]):
        np.testing.assert_array_equal(g.numpy(), w)
    assert refs["mnn"][2].sum() >= 4
    strict = xfeat.match_xfeat(_t(XF0), _t(XF1), min_cossim=0.99)[2]
    assert not (strict & ~got[2]).any()


def test_xfeat_star_matches_reference(refs, xfeat):
    mk0, mk1, valid = xfeat.match_xfeat_star(_t(XF0), _t(XF1))
    w0, w1, wv = refs["star"]
    np.testing.assert_array_equal(valid.numpy(), wv)
    np.testing.assert_allclose(mk1.numpy(), w1, atol=1e-4)
    np.testing.assert_allclose(mk0.numpy(), w0, atol=1e-3)


def test_xfeat_dense_matches_reference(refs, xfeat):
    got = xfeat.detectAndComputeDense(_t(XF0), 128, multiscale=False)
    want = refs["dense"]
    np.testing.assert_array_equal(got["keypoints"].numpy(),
                                  want["keypoints"])
    np.testing.assert_array_equal(got["scales"].numpy(), want["scales"])
    np.testing.assert_allclose(got["descriptors"].numpy(),
                               want["descriptors"], atol=1e-4)


def test_interpolate_sparse2d_matches_reference(refs, xfeat):
    feats = t_xf.xfeat_model(xfeat.params, _t(XF0))[0]
    got = t_ext.InterpolateSparse2d("bilinear")(feats, _t(POS), 64, 96)
    _rel(got, refs["interp"], 1e-4)


def test_xfeat_checkpoint_round_trip(refs):
    """The xfeat.pt layout (OIHW) is the reference's dict (HWIO) as
    ``convert`` crosses it; it loads, and loads into the net, unchanged;
    the nets hold frozen parameters."""
    sd = {k: torch.from_numpy(v.transpose(3, 2, 0, 1).copy() if v.ndim == 4
                              else v.copy())
          for k, v in refs["xparams"].items()}
    crossed = _nets.from_flax(t_xf._param_rows(), refs["xparams"])
    back = t_xf.load_torch_weights(sd)
    assert back.keys() == crossed.keys() == sd.keys()
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k], v.numpy())
        np.testing.assert_array_equal(crossed[k], v.numpy())
    net = t_xf.XFeat.from_torch(sd, top_k=16, device="cpu")
    assert net.top_k == 16
    assert not any(p.requires_grad for p in net.parameters())
    torch.testing.assert_close(net.params["block1.0.layer.0.weight"],
                               sd["block1.0.layer.0.weight"])
    seeded = t_xf.XFeat(device="cpu").params
    assert seeded.keys() == net.params.keys()


# --- ALIKED -----------------------------------------------------------------

def test_aliked_net_matches_reference(refs, aliked):
    fmap, smap = t_al._net_forward(aliked.params, _t(AL))
    _rel(fmap.permute(0, 2, 3, 1), refs["net"][0], 1e-4)
    _rel(smap, refs["net"][1], 1e-4)


def test_aliked_matches_reference(refs, aliked):
    kps, sc, desc, valid = aliked(_t(AL))
    wk, ws, wd, wv = refs["aliked"]
    np.testing.assert_array_equal(valid.numpy(), wv)
    np.testing.assert_allclose(kps.numpy(), wk, atol=1e-3)
    np.testing.assert_allclose(sc.numpy(), ws, atol=1e-5)
    np.testing.assert_allclose(desc.numpy(), wd, atol=1e-4)
    assert wv.sum() >= 8


def test_aliked_forward_laf_is_dkd_affine_at_the_keypoints(refs, aliked):
    """forward_laf: the reference's keypoints, scores and descriptors
    (zero where invalid) and DKD's covariance shape (held to the reference
    by the "affine" DKD cases)."""
    lafs, resp, desc = aliked.forward_laf(_t(AL))
    wk, ws, wd, wv = refs["aliked"]
    m = wv[..., None]
    np.testing.assert_allclose(lafs.numpy()[..., 2], wk * m, atol=1e-3)
    np.testing.assert_allclose(resp.numpy()[..., 0], ws * wv, atol=1e-5)
    np.testing.assert_allclose(desc.numpy(), wd * m, atol=1e-4)
    fmap, smap = t_al._net_forward(aliked.params, _t(AL))
    aff = t_al.dkd_detect(smap, 64, return_affine=True)[4]
    torch.testing.assert_close(lafs[..., :2], aff * _t(m)[..., None])


@pytest.mark.parametrize("case", list(DKD))
def test_dkd_detect_matches_reference(refs, case):
    """Equal peaks and the zeroed border are ties: the same keypoints in
    the same slots; the second image falls back to its mean score."""
    got = t_al.dkd_detect(_t(TIES), 40, **DKD[case])
    want = refs["dkd"][case]
    assert len(got) == len(want)
    np.testing.assert_array_equal(got[3].numpy(), want[3])
    np.testing.assert_allclose(got[0].numpy(), want[0], atol=1e-6)
    for g, w in zip(got[1:3], want[1:3]):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5)
    if len(got) == 5:
        np.testing.assert_allclose(got[4].numpy(), want[4], atol=1e-4)
    if case == "subpixel":
        # nothing of image 1 clears 0.2: its keypoints are those above its
        # mean score
        assert TIES[1].max() < 0.2 and want[3][1].sum() > 0


def test_aliked_grey_input_is_the_repeated_plane(aliked):
    grey = aliked(_t(AL_GREY))
    rgb = aliked(_t(AL_GREY).expand(1, 3, 64, 64).contiguous())
    for g, r in zip(grey, rgb):
        torch.testing.assert_close(g, r, rtol=0, atol=0)


def test_aliked_checkpoint_names_and_seeded_nets(refs, aliked):
    sd = {k: torch.from_numpy(np.asarray(v).copy())
          for k, v in aliked.params.items()}
    back = t_al.load_torch_weights(sd, "aliked-t16")
    assert sorted(back) == sorted(sd)
    assert "block3.conv1.offset_conv.weight" in back
    assert back["desc_head.agg_weights"].shape == (16, 64, 64)
    sd["desc_head.sf_conv.weight"] = sd["desc_head.sf_conv.weight"][:1]
    with pytest.raises(ValueError):
        t_al.load_torch_weights(sd, "aliked-t16")
    net = t_al.ALIKEDNet("aliked-t16", device="cpu")
    head = t_al.SDDH(64, 3, 16, device="cpu")
    fmap, smap = net(_t(AL))
    desc, off = head(fmap, torch.zeros((1, 5, 2)))
    assert fmap.shape == (1, 64, 64, 64) and smap.shape == (1, 64, 64)
    assert desc.shape == (1, 5, 64) and off.shape == (1, 5, 16, 2)
    feats = t_ext.ALIKEDFeatures(torch.zeros(3, 2), torch.zeros(3, 64),
                                 torch.zeros(3))
    assert feats.keypoint_scores.shape == (3,)
