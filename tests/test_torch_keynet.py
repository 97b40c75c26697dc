"""The port's Key.Net presets (kornia_tpu_torch: KeyNet, the multi-resolution
KeyNetDetector, KeyNetHardNet and KeyNetAffNetHardNet,
``convert.keynet_from_numpy``) against the JAX package on the CPU.

Parameters are drawn with torch and numpy in the reference's layout (the
JAX initialisations cost seconds of eager dispatch each); only the golden
probe draws the JAX ``PRNGKey(0)`` weights. The JAX side runs jitted.
Tolerances: KeyNet's response within 1e-5 of its largest entry; detector
scores within 1e-5 and the same valid centres, compared sorted by score
(``torch.topk`` and ``lax.top_k`` may order ties otherwise); the presets
chained stage by stage, each stage fed the reference's input to it, LAFs
within 1e-4 of their largest entry and descriptors within 1e-4.
"""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from kornia_tpu.feature import descriptors as j_desc
from kornia_tpu.feature import integrated as j_int
from kornia_tpu.feature import multires_detector as j_mr
from kornia_tpu_torch import convert
from kornia_tpu_torch.feature import affnet as t_aff
from kornia_tpu_torch.feature import descriptors as t_desc
from kornia_tpu_torch.feature import hardnet as t_hn
from kornia_tpu_torch.feature import integrated as t_int
from kornia_tpu_torch.feature import multires_detector as t_mr
from tests.golden_builders import _img, probe
from tests.torch_threads import one_torch_thread  # noqa: F401

NF = 64


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _image(seed, *shape):
    rng = np.random.default_rng(seed)
    return gaussian_filter(rng.random(shape), (0, 0, 1.2, 1.2)).astype(
        np.float32)


def _close_rel(out, ref, rel):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=0,
                               atol=rel * max(np.abs(ref).max(), 1e-30))


def _randomised(params, seed):
    """A param dict with its batch-norm statistics, scales and biases drawn
    too (the initialisation leaves them at 0 and 1), as float32 numpy."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in params.items():
        v = np.asarray(v, np.float32)
        if v.ndim == 1:
            if k.endswith("var"):
                v = rng.uniform(0.5, 2.0, v.shape)
            elif k.endswith(".1.weight"):
                v = rng.uniform(0.5, 1.5, v.shape)
            else:
                v = rng.normal(0.0, 0.1, v.shape)
        out[k] = v.astype(np.float32)
    return out


@pytest.fixture(scope="module")
def params():
    gen = torch.Generator().manual_seed(5)
    return dict(
        keynet=_randomised(t_desc._init_from_specs(
            gen, t_desc.KeyNet._specs()), 0),
        hardnet=_randomised(t_hn.hardnet_init_params(gen), 1),
        orinet=_randomised(t_aff._init_params(gen, 2, 1), 2),
        affnet=_randomised(t_aff._init_params(gen, 3, 0), 3))


# ----------------------------------------------------------------------------
# KeyNet
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1, 1, 48, 48), (2, 1, 64, 96)])
def test_keynet_matches_reference(params, shape):
    x = _image(1, *shape)
    ref = np.asarray(jax.jit(j_desc.KeyNet(params["keynet"]).__call__)(
        jnp.asarray(x)))
    net = convert.keynet_from_numpy(params["keynet"], device="cpu")
    out = net(_t(x))
    assert out.shape == shape and not out.requires_grad
    _close_rel(out.numpy(), ref, 1e-5)
    assert (out.numpy() >= 0).all()


def test_keynet_sigmas_scale_after_the_relu(params):
    x = _image(2, 2, 1, 40, 40)
    s = np.array([1.5, 2.0], np.float32)
    ref = np.asarray(jax.jit(j_desc.KeyNet(params["keynet"]).__call__)(
        jnp.asarray(x), jnp.asarray(s)))
    out = convert.keynet_from_numpy(params["keynet"], device="cpu")(
        _t(x), _t(s))
    _close_rel(out.numpy(), ref, 1e-5)


def test_keynet_default_initialisation_is_seeded():
    """Without parameters the weights come from a generator seeded with 3:
    the same every time, nothing that requires grad, the reference's names
    and shapes, unit variances and norm scales, zero means and biases."""
    a, b = t_desc.KeyNet(device="cpu"), t_desc.KeyNet(device="cpu")
    specs = j_desc.KeyNet._specs()
    assert set(a.params) == set(specs)
    for k, v in a.params.items():
        assert tuple(v.shape) == specs[k] and not v.requires_grad
        assert torch.equal(v, b.params[k])
    assert torch.equal(a.params["last_conv.0.bias"], torch.zeros(1))
    w = a.params["feature_extractor.lb_block.conv0.0.weight"]
    assert abs(float(w.std()) - math.sqrt(2.0 / (10 * 25))) < 0.02


def test_keynet_from_numpy_and_checkpoint_loaders(params):
    sd = {k: torch.from_numpy(v) for k, v in params["keynet"].items()}
    sd["feature_extractor.lb_block.conv0.1.num_batches_tracked"] = \
        torch.tensor(3)
    got = t_desc.load_keynet_torch_weights(sd)
    want = j_desc.load_keynet_torch_weights(sd)
    assert got.keys() == want.keys() == params["keynet"].keys()
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    for net in (convert.keynet_from_numpy(params["keynet"], device="cpu"),
                t_desc.KeyNet.from_torch(sd, device="cpu")):
        for k, v in net.params.items():
            np.testing.assert_array_equal(v.numpy(), params["keynet"][k])
    with pytest.raises(ValueError):
        t_desc.load_keynet_torch_weights(
            {**sd, "last_conv.0.bias": torch.zeros(2)})


def test_port_reproduces_keynet_golden_family():
    """tests/golden/models_golden.json's keynet_response, at
    tests/test_golden_models.py's tolerance, from the JAX PRNGKey(0)
    weights (drawn eagerly: the draw's shapes must be concrete)."""
    p = _np(j_desc.KeyNet(key=jax.random.PRNGKey(0)).params)
    out = convert.keynet_from_numpy(p, device="cpu")(
        _t(_img((1, 1, 48, 48))))
    path = os.path.join(os.path.dirname(__file__), "golden",
                        "models_golden.json")
    with open(path) as f:
        expect = json.load(f)["keynet_response"]
    got = probe(out.numpy())
    assert got["size"] == expect["size"]
    tol = 1e-4 * max(abs(expect["absmax"]), 1e-3)
    assert abs(got["mean"] - expect["mean"]) < tol
    assert abs(got["std"] - expect["std"]) < tol
    np.testing.assert_allclose(got["values"], expect["values"], atol=10 * tol)


# ----------------------------------------------------------------------------
# the multi-resolution detector
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("num_features,config", [
    (2048, None),
    (500, dict(j_mr.default_detector_config, pyramid_levels=3, up_levels=0)),
    (1000, dict(j_mr.default_detector_config, up_levels=2,
                scale_factor_levels=1.2)),
])
def test_points_per_level_match_reference(num_features, config):
    ref = j_mr.MultiResolutionDetector(None, num_features, config)
    port = t_mr.MultiResolutionDetector(None, num_features, config)
    assert port._points_per_level() == ref._points_per_level()
    assert t_mr.default_detector_config == j_mr.default_detector_config


def _by_score(scores, lafs, valid):
    """The valid entries of one image, ordered by score then position (ties
    may come in another order from the two top-k's)."""
    s, l_ = scores[valid], lafs[valid]
    order = np.lexsort((l_[:, 1, 2], l_[:, 0, 2], -s))
    return s[order], l_[order]


@pytest.fixture(scope="module")
def detections(params):
    img = _image(3, 1, 1, 96, 128)
    det = j_mr.MultiResolutionDetector(j_desc.KeyNet(params["keynet"]), NF)
    ref = _np(jax.jit(det.detect)(jnp.asarray(img)))
    port = t_mr.MultiResolutionDetector(
        convert.keynet_from_numpy(params["keynet"], device="cpu"), NF)
    return ref, [t.numpy() for t in port.detect(_t(img))]


def test_multires_detector_matches_reference(detections):
    (rs, rl, rv), (ts, tl, tv) = detections
    assert rv.shape == tv.shape == (1, NF) and rv.sum() >= NF // 2
    assert rv.sum() == tv.sum()
    rs_, rl_ = _by_score(rs[0], rl[0], rv[0])
    ts_, tl_ = _by_score(ts[0], tl[0], tv[0])
    np.testing.assert_array_equal(tl_[..., 2], rl_[..., 2])
    _close_rel(ts_, rs_, 1e-5)
    _close_rel(tl_[..., :2], rl_[..., :2], 1e-5)
    # invalid slots score 0
    assert (ts[~tv] == 0).all()


def test_keynet_detector_wires_keynet(params):
    det = t_mr.KeyNetDetector(params["keynet"], 32, device="cpu")
    assert isinstance(det.model, t_desc.KeyNet)
    assert det.nms_size == 15 and det.mr_size == 22.0
    assert det.num_pyramid_levels == 4 and det.num_upscale_levels == 1


# ----------------------------------------------------------------------------
# the presets, chained stage by stage
# ----------------------------------------------------------------------------

_PRESETS = {"keynet_hardnet": ("KeyNetHardNet", False),
            "keynet_affnet_hardnet": ("KeyNetAffNetHardNet", True)}


def _kwargs(params, aff):
    kw = dict(keynet_params=params["keynet"],
              orinet_params=params["orinet"],
              hardnet_params=params["hardnet"])
    if aff:
        kw["affnet_params"] = params["affnet"]
    return kw


@pytest.fixture(scope="module")
def presets(params):
    """Both presets at 96x128 with 64 features, one JAX compile. The JAX
    side returns each stage of the detector's chain (detection, affine
    shape, orientation) and the descriptors; the port runs each stage on
    the reference's input to it."""
    img = _image(4, 1, 1, 96, 128)
    j_feats = [getattr(j_int, cls)(NF, **_kwargs(params, aff))
               for cls, aff in _PRESETS.values()]

    def chain(f, x):
        det = f.detector
        resp, lafs, valid = det.detect(x)
        aff = det.aff(lafs, x) if det.aff is not None else lafs
        ori = det.ori(aff, x)
        return dict(det=(resp, lafs, valid), aff=aff, ori=ori,
                    desc=f.descriptor(x, ori))

    ref = _np(jax.jit(lambda a: [chain(f, a) for f in j_feats])(
        jnp.asarray(img)))
    out = {}
    for (name, (cls, aff)), r in zip(_PRESETS.items(), ref):
        f = getattr(t_int, cls)(NF, **_kwargs(params, aff), device="cpu")
        det = f.detector
        x = _t(img)
        out[name] = dict(
            ref=r, det=[t.numpy() for t in det.detect(x)],
            aff=None if det.aff is None else det.aff(_t(r["det"][1]), x),
            ori=det.ori(_t(r["aff"]), x),
            desc=f.descriptor(x, _t(r["ori"])),
            full=[t.numpy() for t in f(x)])
    return out


@pytest.mark.parametrize("name", sorted(_PRESETS))
def test_keynet_presets_match_reference_stage_by_stage(presets, name):
    o = presets[name]
    r = o["ref"]
    v = r["det"][2][0]
    assert v.sum() >= NF // 2
    # detection: the same valid set, sorted by score
    rs, rl = _by_score(r["det"][0][0], r["det"][1][0], v)
    ts, tl = _by_score(o["det"][0][0], o["det"][1][0], o["det"][2][0])
    np.testing.assert_array_equal(tl[..., 2], rl[..., 2])
    _close_rel(ts, rs, 1e-5)
    # each later stage on the reference's input to it
    if o["aff"] is not None:
        _close_rel(o["aff"].numpy()[0][v], r["aff"][0][v], 1e-4)
    _close_rel(o["ori"].numpy()[0][v], r["ori"][0][v], 1e-4)
    np.testing.assert_allclose(o["desc"].numpy()[0][v], r["desc"][0][v],
                               rtol=0, atol=1e-4)
    # end to end: LocalFeature's output has the chain's valid keypoints
    lafs, resps, descs, valid = o["full"]
    assert valid.sum() == v.sum()
    assert descs.shape == (1, NF, 128) and lafs.shape == (1, NF, 2, 3)
    np.testing.assert_allclose(np.linalg.norm(descs[0][valid[0]], axis=-1),
                               1.0, atol=1e-5)


def test_keynet_presets_wire_the_reference_modules(params):
    f = t_int.KeyNetAffNetHardNet(16, device="cpu")
    assert isinstance(f.detector, t_mr.KeyNetDetector)
    assert f.orienter is None and f.aff_module is None
    assert isinstance(f.detector.ori.angle_detector, t_aff.OriNet)
    assert f.detector.ori.patch_size == 32
    assert not f.detector.aff.preserve_orientation
    assert f.descriptor.patch_size == 32
    g = t_int.KeyNetHardNet(16, upright=True, device="cpu")
    assert g.detector.ori is None and g.detector.aff is None
