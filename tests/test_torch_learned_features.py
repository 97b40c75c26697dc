"""The port's learned local features (kornia_tpu_torch: HardNet, OriNet,
AffNet, LAFAffNetShapeEstimator, LAFOrienter with an angle detector,
PassLAF, the rest of feature/laf.py, ops/color.py's grey conversions, the
GFTTAffNetHardNet and HesAffNetHardNet presets, and BASELINE config 2's
DoG + HardNet two-view pose) against the JAX package on the CPU.

Parameters are the JAX package's own initialisations (its default keys),
carried across through ``kornia_tpu_torch.convert``. The JAX side runs its
CPU paths, jitted once per module. Tolerances: net outputs and descriptors
1e-5; LAFs 1e-4 of the largest |entry| of their linear part (and of their
centres); the preset detectors' LAFs come out of the subpixel fit, which
amplifies f32 differences of the responses (tests/test_torch_gftt.py holds
them to 1e-3 px), so there descriptors are compared where both packages
sampled the same LAF to 1e-4. The golden probes reproduce
tests/golden/models_golden.json at tests/test_golden_models.py's tolerance.
"""

import json
import math
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from kornia_tpu.feature import affnet as j_aff
from kornia_tpu.feature import hardnet as j_hn
from kornia_tpu.feature import integrated as j_int
from kornia_tpu.feature import laf as j_laf
from kornia_tpu.feature import loftr as j_loftr
from kornia_tpu.feature import orientation as j_ori
from kornia_tpu.ops import color as j_color
from kornia_tpu.slam.twoview import two_view_pose as j_two_view_pose
from kornia_tpu_torch import convert
from kornia_tpu_torch.feature import affnet as t_aff
from kornia_tpu_torch.feature import hardnet as t_hn
from kornia_tpu_torch.feature import integrated as t_int
from kornia_tpu_torch.feature import laf as t_laf
from kornia_tpu_torch.feature import loftr as t_loftr
from kornia_tpu_torch.feature import orientation as t_ori
from kornia_tpu_torch.ops import color as t_color
from kornia_tpu_torch.slam.twoview import two_view_pose
from tests import port_references
from tests.golden_builders import _img, probe
from tests.torch_threads import one_torch_thread  # noqa: F401

NF = 64


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _image(seed, h, w, c=1):
    rng = np.random.default_rng(seed)
    return np.stack([gaussian_filter(rng.random((h, w)), 1.2)
                     for _ in range(c)]).astype(np.float32)[None]


def _patches(seed, n, ps):
    rng = np.random.default_rng(seed)
    return gaussian_filter(rng.random((n, 1, ps, ps)),
                           (0, 0, 1.0, 1.0)).astype(np.float32)


def _lafs(seed, n, h, w, smin=2.0, smax=10.0):
    """(1, n, 2, 3) random LAFs: centres inside, scales in [smin, smax],
    any orientation, up to 2:1 anisotropy."""
    rng = np.random.default_rng(seed)
    ang = rng.uniform(-np.pi, np.pi, n)
    c, s = np.cos(ang), np.sin(ang)
    R = np.stack([np.stack([c, s], -1), np.stack([-s, c], -1)], -2)
    D = np.zeros((n, 2, 2))
    D[:, 0, 0] = rng.uniform(0.7, 1.4, n)
    D[:, 1, 1] = 1.0 / D[:, 0, 0]
    D[:, 1, 0] = rng.uniform(-0.3, 0.3, n)
    A = (D @ R) * rng.uniform(smin, smax, n)[:, None, None]
    ctr = np.stack([rng.uniform(8, w - 8, n), rng.uniform(8, h - 8, n)], -1)
    return np.concatenate([A, ctr[..., None]], -1)[None].astype(np.float32)


def _close_rel(out, ref, rel):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=0,
                               atol=rel * max(np.abs(ref).max(), 1e-30))


def _close_lafs(out, ref, rel=1e-4):
    """Linear parts and centres, each to `rel` of its largest entry."""
    out, ref = np.asarray(out), np.asarray(ref)
    _close_rel(out[..., :2], ref[..., :2], rel)
    _close_rel(out[..., 2], ref[..., 2], rel)


def _randomised(params, seed):
    """A param dict with its batch-norm statistics and biases drawn too
    (the initialisations leave them at 0 and 1), as float32 numpy."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in params.items():
        v = np.asarray(v, np.float32)
        if k.endswith("_mean") or k.endswith("_b"):
            v = rng.normal(0.0, 0.1, v.shape).astype(np.float32)
        elif k.endswith("_var"):
            v = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
        out[k] = v
    return out


@pytest.fixture(scope="module")
def params():
    return make_params()


def make_params():
    """Weights made with numpy-seeded draws in the reference's layout (the
    JAX initialisations cost seconds of eager dispatch each)."""
    gen = torch.Generator().manual_seed(5)
    return dict(
        hardnet=_randomised(t_hn.hardnet_init_params(gen), 0),
        orinet=_randomised(t_aff._init_params(gen, 2, 1), 1),
        affnet=_randomised(t_aff._init_params(gen, 3, 0), 2))


# ----------------------------------------------------------------------------
# nets
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("ps", [32, 41])
def test_hardnet_matches_reference(params, ps):
    """(B, 1, 32, 32) → unit 128-vectors; other sizes are resized first."""
    x = _patches(1, 24, ps)
    ref = np.asarray(jax.jit(j_hn.HardNet(params["hardnet"]))(
        jnp.asarray(x)))
    net = convert.hardnet_from_numpy(params["hardnet"], "cpu")
    out = net(_t(x))
    assert out.shape == (24, 128)
    assert not out.requires_grad
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(out.numpy(), axis=-1), 1.0,
                               atol=1e-5)


def test_orinet_and_affnet_match_reference(params):
    x = _patches(2, 24, 32)
    ori_ref = np.asarray(jax.jit(j_aff.OriNet(params["orinet"]))(
        jnp.asarray(x)))
    aff_ref = np.asarray(jax.jit(j_aff.AffNet(params["affnet"]))(
        jnp.asarray(x)))
    ori = convert.orinet_from_numpy(params["orinet"], "cpu")(_t(x)).numpy()
    aff = convert.affnet_from_numpy(params["affnet"], "cpu")(_t(x)).numpy()
    assert ori.shape == (24,) and aff.shape == (24, 3)
    d = np.angle(np.exp(1j * (ori.astype(np.float64) - ori_ref)))
    assert np.abs(d).max() <= 1e-5
    np.testing.assert_allclose(aff, aff_ref, rtol=0, atol=1e-5)


def test_default_initialisation_is_seeded(golden_params):
    """Without parameters each net draws from a generator seeded with the
    reference's key number: the same weights every time, nothing that
    requires grad, and the reference's names and shapes."""
    for cls, ref in ((t_hn.HardNet, golden_params["hardnet"]),
                     (t_aff.OriNet, golden_params["orinet"]),
                     (t_aff.AffNet, golden_params["affnet"])):
        a, b = cls(device="cpu"), cls(device="cpu")
        assert set(a.params) == set(ref)
        for k, v in a.params.items():
            assert v.shape == ref[k].shape and not v.requires_grad
            assert torch.equal(v, b.params[k])


def _checkpoint(params, head):
    """A reference-style ``features.N.*`` state_dict of a param dict: conv
    N = 3i, its batch norm 3i + 1 (running statistics and the counter);
    the head conv (with bias) last."""
    sd = {}
    i = 0
    while f"conv{i}_w" in params:
        sd[f"features.{3 * i}.weight"] = torch.from_numpy(params[f"conv{i}_w"])
        for stat in ("mean", "var"):
            sd[f"features.{3 * i + 1}.running_{stat}"] = torch.from_numpy(
                params[f"bn{i}_{stat}"])
        sd[f"features.{3 * i + 1}.num_batches_tracked"] = torch.tensor(7)
        i += 1
    if head:
        sd[f"features.{3 * i + 1}.weight"] = torch.from_numpy(
            params["head_w"])
        sd[f"features.{3 * i + 1}.bias"] = torch.from_numpy(params["head_b"])
    return sd


@pytest.mark.parametrize("net", ["hardnet", "orinet", "affnet"])
def test_checkpoint_loaders_match_reference(params, net):
    """The port's torch-checkpoint loaders give the reference's dicts."""
    port, ref = {"hardnet": (t_hn.load_torch_weights, j_hn.load_torch_weights),
                 "orinet": (t_aff.load_orinet_torch_weights,
                            j_aff.load_orinet_torch_weights),
                 "affnet": (t_aff.load_affnet_torch_weights,
                            j_aff.load_affnet_torch_weights)}[net]
    sd = _checkpoint(params[net], net != "hardnet")
    got, want = port(sd), ref({k: v.numpy() for k, v in sd.items()})
    assert got.keys() == want.keys() == params[net].keys()
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
        np.testing.assert_array_equal(got[k], params[net][k])


@pytest.mark.parametrize("preserve", [True, False])
def test_affnet_shape_estimator_matches_reference(params, preserve):
    img = _image(3, 64, 80)
    lafs = _lafs(4, 24, 64, 80)
    est = j_aff.LAFAffNetShapeEstimator(params["affnet"], preserve)
    ref = np.asarray(jax.jit(est)(jnp.asarray(lafs), jnp.asarray(img)))
    out = t_aff.LAFAffNetShapeEstimator(params["affnet"], preserve,
                                        device="cpu")(_t(lafs), _t(img))
    _close_lafs(out.numpy(), ref)
    # the scale is kept; without preserve_orientation the result is upright
    np.testing.assert_allclose(t_laf.get_laf_scale(out).numpy(),
                               t_laf.get_laf_scale(_t(lafs)).numpy(),
                               rtol=1e-5)
    if not preserve:
        np.testing.assert_allclose(out[..., 0, 1].numpy(), 0.0, atol=1e-5)


def test_orienter_with_orinet_matches_reference(params):
    img = _image(5, 64, 80)
    lafs = _lafs(6, 24, 64, 80)
    ori = j_ori.LAFOrienter(32, angle_detector=j_aff.OriNet(params["orinet"]))
    ref = np.asarray(jax.jit(ori)(jnp.asarray(lafs), jnp.asarray(img)))
    port = t_ori.LAFOrienter(
        32, angle_detector=convert.orinet_from_numpy(params["orinet"], "cpu"))
    _close_lafs(port(_t(lafs), _t(img)).numpy(), ref)


def test_pass_laf_returns_the_lafs():
    lafs = _t(_lafs(7, 5, 32, 32))
    assert t_ori.PassLAF()(lafs, torch.zeros(1, 1, 32, 32)) is lafs


# ----------------------------------------------------------------------------
# LAF helpers and colour
# ----------------------------------------------------------------------------

_H = _np(jax.random.normal(jax.random.PRNGKey(3), (1, 3, 3))) * 0.05 \
    + np.eye(3, dtype=np.float32)
_ELLS = np.concatenate([np.random.default_rng(8).uniform(10, 50, (1, 6, 2)),
                        np.array([[[0.05, 0.01, 0.03]] * 6])],
                       -1).astype(np.float32)

_HELPERS = {
    "set_laf_scale": lambda m, L, img, x: m.set_laf_scale(
        L, 3.0 * m.get_laf_scale(L)),
    "make_upright": lambda m, L, img, x: m.make_upright(L),
    "ellipse_to_laf": lambda m, L, img, x: m.ellipse_to_laf(x["ells"]),
    "laf_to_boundary_points": lambda m, L, img, x:
        m.laf_to_boundary_points(L, 20),
    "normalize_laf": lambda m, L, img, x: m.normalize_laf(L, img),
    "denormalize_laf": lambda m, L, img, x: m.denormalize_laf(
        m.normalize_laf(L, img), img),
    "laf_is_inside_image": lambda m, L, img, x: m.laf_is_inside_image(
        L, img, 2),
    "three_points": lambda m, L, img, x: m.laf_from_three_points(
        m.laf_to_three_points(L)),
    "perspective_transform_lafs": lambda m, L, img, x:
        m.perspective_transform_lafs(x["H"], L),
    "generate_patch_grid_from_normalized_laf": lambda m, L, img, x:
        m.generate_patch_grid_from_normalized_laf(img, L, 8),
    "extract_patches_simple": lambda m, L, img, x: m.extract_patches_simple(
        img, L, 16),
}


@pytest.mark.parametrize("name", sorted(_HELPERS))
def test_laf_helpers_match_reference(name):
    lafs, img = _lafs(9, 12, 48, 64), _image(10, 48, 64)
    extra = dict(H=_H, ells=_ELLS)
    fn = _HELPERS[name]
    ref = np.asarray(fn(j_laf, jnp.asarray(lafs), jnp.asarray(img),
                        {k: jnp.asarray(v) for k, v in extra.items()}))
    out = fn(t_laf, _t(lafs), _t(img),
             {k: _t(v) for k, v in extra.items()}).numpy()
    assert out.shape == ref.shape
    if ref.dtype == bool:
        np.testing.assert_array_equal(out, ref)
        assert 0 < ref.sum() < ref.size  # some LAFs touch the border
    else:
        _close_rel(out, ref, 1e-5)


def test_ellipse_to_laf_is_upright_and_inverts_the_conic():
    laf = t_laf.ellipse_to_laf(_t(_ELLS)).double()
    A = laf[..., :2]
    assert torch.all(A[..., 0, 1].abs() < 1e-6)
    M = torch.tensor([[0.05, 0.01], [0.01, 0.03]], dtype=torch.float64)
    eye = A.transpose(-1, -2) @ M @ A  # the unit circle maps to the ellipse
    np.testing.assert_allclose(eye.numpy(), np.broadcast_to(np.eye(2),
                                                            eye.shape),
                               atol=1e-5)


@pytest.mark.parametrize("name", ["rgb_to_grayscale", "bgr_to_grayscale",
                                  "grayscale_to_rgb", "rgb_to_bgr",
                                  "weights"])
def test_color_matches_reference(name):
    rgb = np.random.default_rng(11).random((2, 3, 5, 7)).astype(np.float32)
    if name == "weights":
        w = np.array([0.2, 0.5, 0.3], np.float32)
        ref = j_color.rgb_to_grayscale(jnp.asarray(rgb), jnp.asarray(w))
        out = t_color.rgb_to_grayscale(_t(rgb), _t(w))
    else:
        x = rgb[:, :1] if name == "grayscale_to_rgb" else rgb
        ref = getattr(j_color, name)(jnp.asarray(x))
        out = getattr(t_color, name)(_t(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-7)
    with pytest.raises(ValueError):
        t_color.rgb_to_grayscale(_t(rgb[:, :2]))


# ----------------------------------------------------------------------------
# presets
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def presets(params):
    """Both presets at 96x128 with 64 features, one JAX compile: GFTT on a
    colour image, Hessian on a grey one. The JAX side returns every stage
    of LocalFeature's chain (detector, affine shape, orientation,
    descriptors), so that the port can run each stage on the reference's
    input to it as well as end to end."""
    rgb = _image(12, 96, 128, 3)
    gray = _image(13, 96, 128)
    kw = dict(params=params["hardnet"], affnet_params=params["affnet"])
    j_feats = (j_int.GFTTAffNetHardNet(NF, **kw),
               j_int.HesAffNetHardNet(NF, **kw))

    def chain(f, x):
        g = j_color.rgb_to_grayscale(x) if x.shape[1] == 3 else x
        lafs, resps, valid = f.detector(g)
        aff = f.aff_module(lafs, g)
        ori = f.orienter(aff, g)
        return dict(gray=g, det=(lafs, resps, valid), aff=aff, ori=ori,
                    desc=f.descriptor(g, ori))

    ref = _np(jax.jit(lambda a, b: [chain(f, x) for f, x in
                                    zip(j_feats, (a, b))])(
        jnp.asarray(rgb), jnp.asarray(gray)))
    out = {}
    for name, x, r in (("gftt", rgb, ref[0]), ("hessian", gray, ref[1])):
        f = getattr(t_int, {"gftt": "GFTTAffNetHardNet",
                            "hessian": "HesAffNetHardNet"}[name])(
            NF, **kw, device="cpu")
        g = _t(r["gray"])
        out[name] = dict(ref=r, full=f(_t(x)), det=f.detector(g),
                         aff=f.aff_module(_t(r["det"][0]), g),
                         ori=f.orienter(_t(r["aff"]), g),
                         desc=f.descriptor(g, _t(r["ori"])))
    return out


@pytest.mark.parametrize("which", ["gftt", "hessian"])
def test_affnet_hardnet_presets_match_reference(presets, which):
    o = presets[which]
    r = o["ref"]
    v = r["det"][2][0]
    assert v.sum() >= NF // 2
    # detection: the scale-space subpixel fit divides f32 differences of
    # the responses by their local Hessian (up to 1e-4 of the scale here)
    lafs, resps, valid = (t.numpy() for t in o["det"])
    np.testing.assert_array_equal(valid, r["det"][2])
    _close_rel(resps[0][v], r["det"][1][0][v], 1e-5)
    np.testing.assert_allclose(lafs[0][v][..., 2], r["det"][0][0][v][..., 2],
                               atol=1e-3)
    _close_rel(lafs[0][v][..., :2], r["det"][0][0][v][..., :2], 1e-3)
    # each later stage on the reference's input to it
    _close_lafs(o["aff"].numpy()[0][v], r["aff"][0][v])
    _close_lafs(o["ori"].numpy()[0][v], r["ori"][0][v])
    np.testing.assert_allclose(o["desc"].numpy()[0][v], r["desc"][0][v],
                               rtol=0, atol=1e-5)
    # end to end (the reference's chain is LocalFeature's): the same
    # keypoints; a scale that moved by 1e-4 in the detector's fit carries
    # into the keypoint's shape and patch, so LAFs are held to 1e-2 of the
    # largest entry, and to 1e-4 for 90% of the keypoints, whose
    # descriptors then agree to 1e-3
    f_lafs, _, f_descs, f_valid = (t.numpy() for t in o["full"])
    np.testing.assert_array_equal(f_valid, r["det"][2])
    f_lafs, r_lafs = f_lafs[0][v], r["ori"][0][v]
    _close_rel(f_lafs[..., :2], r_lafs[..., :2], 1e-2)
    same = np.abs(f_lafs - r_lafs).reshape(len(f_lafs), -1).max(1) \
        <= 1e-4 * np.abs(r_lafs[..., :2]).max()
    assert same.mean() >= 0.9
    np.testing.assert_allclose(f_descs[0][v][same], r["desc"][0][v][same],
                               rtol=0, atol=1e-3)


def test_presets_wire_the_reference_modules():
    g = t_int.GFTTAffNetHardNet(16, device="cpu")
    assert g.detector.scale_pyr.double_image
    assert g.descriptor.patch_size == 32
    assert g.orienter.patch_size == 19 and g.orienter.angle_detector is None
    assert not g.aff_module.preserve_orientation
    assert t_int.HesAffNetHardNet(16, upright=True,
                                  device="cpu").orienter is None


# ----------------------------------------------------------------------------
# BASELINE config 2: DoG + HardNet + 5-point essential RANSAC
# ----------------------------------------------------------------------------

T, S = 32, 256  # two_view_pose's RANSAC rounds and batch
NF2 = 128


def _replay_gumbel(key):
    draws = []
    for _ in range(T):
        key, sub = jax.random.split(key)
        draws.append(np.asarray(jax.random.gumbel(sub, (S, NF2))))
    return torch.from_numpy(np.stack(draws))


def _config2(pkg, hardnet):
    """SIFTFeature's DoG detector, HardNet on 32² patches, the gradient
    orientation on 19² patches."""
    sift = pkg.SIFTFeature(NF2)
    return pkg.LocalFeature(sift.detector, pkg.LAFDescriptor(hardnet, 32),
                            pkg.LAFOrienter(19))


def _config2_inputs(params):
    """The pair, K, the reference's RANSAC noise of PRNGKey(1), and the
    inputs' digest (HardNet's parameters included)."""
    h, w = 128, 160
    img0 = gaussian_filter(np.random.default_rng(0).random((h, w)),
                           1.0).astype(np.float32)
    img1 = np.zeros_like(img0)
    img1[:, :-4] = img0[:, 4:]
    img0, img1 = img0[None, None], img1[None, None]
    K = np.array([[0.8 * w, 0, w / 2], [0, 0.8 * w, h / 2], [0, 0, 1]],
                 np.float32)
    key = jax.random.PRNGKey(1)
    gumbel = _replay_gumbel(key)
    hn = params["hardnet"]
    dig = port_references.inputs(
        (img0, img1, K, *[hn[k] for k in sorted(hn)]), (gumbel,))
    return img0, img1, K, key, gumbel, dig


def config2_jax_reference(params):
    """The JAX config-2 pipeline on the test's inputs: (the inputs'
    digest, its result's fields), as tests/write_port_references.py
    records them."""
    img0, img1, K, key, _, dig = _config2_inputs(params)
    j_feat = _config2(j_int, j_hn.HardNet(params["hardnet"]))
    ref = _np(jax.jit(lambda a, b, k, kk: j_two_view_pose(
        a, b, k, kk, num_features=NF2, feature=j_feat))(
            jnp.asarray(img0), jnp.asarray(img1), jnp.asarray(K), key))
    fields = ("R", "t", "E", "inliers", "keypoints0", "keypoints1",
              "num_inliers")
    return dig, {f: np.asarray(getattr(ref, f)) for f in fields}


def test_config2_two_view_pose_matches_reference(params):
    """Against the recorded JAX result (tests/port_references.py; the
    pipeline's compile took about 65 s a run)."""
    img0, img1, K, _, gumbel, dig = _config2_inputs(params)
    ref = SimpleNamespace(**port_references.load("config2", dig))
    t_feat = _config2(t_int, convert.hardnet_from_numpy(params["hardnet"],
                                                        "cpu"))
    out = two_view_pose(img0, img1, K, num_features=NF2, feature=t_feat,
                        device="cpu", gumbel=gumbel)
    assert int(ref.num_inliers) >= 20
    np.testing.assert_array_equal(out.inliers.numpy(), ref.inliers)
    inl = ref.inliers
    np.testing.assert_allclose(out.keypoints0.numpy()[inl],
                               ref.keypoints0[inl], atol=1e-2)
    np.testing.assert_allclose(out.keypoints1.numpy()[inl],
                               ref.keypoints1[inl], atol=1e-2)
    dR = ref.R.T @ out.R.numpy()
    assert math.acos(max(-1.0, min(1.0, (np.trace(dR) - 1) / 2))) <= 1e-3
    a, b = out.t.numpy().ravel(), ref.t.ravel()
    assert math.acos(max(-1.0, min(1.0, float(a @ b / np.linalg.norm(a)
                                              / np.linalg.norm(b))))) <= 1e-2


# ----------------------------------------------------------------------------
# golden probes (tests/golden/models_golden.json)
# ----------------------------------------------------------------------------

_LOFTR_SMALL = dict(coarse_dim=64, fine_dim=32, num_coarse_layers=1,
                    num_heads=4, top_k=32)


@pytest.fixture(scope="module")
def golden_params():
    """tests/golden_builders.py's parameters: HardNet and LoFTR from
    PRNGKey(0), OriNet and AffNet from their defaults (keys 0 and 1), drawn
    in one jitted call (the eager draws take seconds each; jitted ones
    differ from them by at most 1.2e-7)."""
    jcfg = j_loftr.LoFTRConfig(**_LOFTR_SMALL)

    def init(k0, k1):
        return dict(hardnet=j_hn.hardnet_init_params(k0),
                    orinet=j_aff._init_params(k0, 2, 1),
                    affnet=j_aff._init_params(k1, 3, 0),
                    loftr_coarse=j_loftr.loftr_init_params(k0, jcfg))

    return _np(jax.jit(init)(jax.random.PRNGKey(0), jax.random.PRNGKey(1)))


def _golden_hardnet(p):
    return convert.hardnet_from_numpy(p, "cpu")(_t(_img((4, 1, 32, 32))))


def _golden_orinet(p):
    return convert.orinet_from_numpy(p, "cpu")(_t(_img((4, 1, 32, 32))))


def _golden_affnet(p):
    return convert.affnet_from_numpy(p, "cpu")(_t(_img((4, 1, 32, 32))))


def _golden_loftr_coarse(p):
    cfg = t_loftr.LoFTRConfig(**_LOFTR_SMALL)
    model = convert.loftr_from_numpy(p, cfg, "cpu")
    c, f = t_loftr.loftr_backbone(model.params, cfg,
                                  _t(_img((1, 1, 64, 64))))
    # the reference's maps are NHWC
    return np.concatenate([c.permute(0, 2, 3, 1).numpy().ravel(),
                           f.permute(0, 2, 3, 1).numpy().ravel()])


_GOLDEN = {"hardnet": _golden_hardnet, "orinet": _golden_orinet,
           "affnet": _golden_affnet, "loftr_coarse": _golden_loftr_coarse}


@pytest.mark.parametrize("family", sorted(_GOLDEN))
def test_port_reproduces_golden_family(golden_params, family):
    path = os.path.join(os.path.dirname(__file__), "golden",
                        "models_golden.json")
    with open(path) as f:
        expect = json.load(f)[family]
    got = probe(np.asarray(_GOLDEN[family](golden_params[family])))
    assert got["size"] == expect["size"]
    tol = 1e-4 * max(abs(expect["absmax"]), 1e-3)
    assert abs(got["mean"] - expect["mean"]) < tol
    assert abs(got["std"] - expect["std"]) < tol
    np.testing.assert_allclose(got["values"], expect["values"], atol=10 * tol)
