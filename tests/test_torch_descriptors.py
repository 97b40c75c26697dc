"""The port's patch descriptors and shape estimators (kornia_tpu_torch:
feature/descriptors.py's TFeat, SOSNet, HyNet, MKDGradientDescriptor,
PatchAffineShapeEstimator, LAFAffineShapeEstimator and DiscreteSteerer,
feature/siftdesc.py's DenseSIFTDescriptor, feature/mkd.py whole, and
feature/extras.py's HardNet8, FRN, TLU, PatchDominantGradientOrientation
and get_laf_descriptors) against the JAX package on the CPU.

The nets take the same parameters in both packages, drawn with numpy in
the reference's layout (batch-norm statistics, FRN and TLU values drawn
too, so that every term counts). Every JAX reference of the module comes
from one jitted program (``tests/torch_op_parity.py::batch_references``,
compiled with ``FAST_OPTIONS``: a fifth less compile time).
The golden families (tfeat, sosnet, hynet, mkd) reproduce
tests/golden/models_golden.json from the reference's own initialisations
at tests/test_golden_models.py's tolerance.

Tolerances: descriptors (unit vectors) 1e-5 absolute, TFeat's tanh of
a 4096-term product 2e-5;
MKD with a whitening model 1e-4 (a 238 x 238 product of eigenvectors);
shape-adapted LAFs 1e-4 of their largest entry; the second-moment
ellipses 1e-4 relative; orientations 1e-4 rad on the circle.
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
from kornia_tpu.feature import extras as j_ext
from kornia_tpu.feature import mkd as j_mkd
from kornia_tpu.feature import siftdesc as j_sift
from kornia_tpu_torch import convert
from kornia_tpu_torch.feature import descriptors as t_desc
from kornia_tpu_torch.feature import extras as t_ext
from kornia_tpu_torch.feature import mkd as t_mkd
from kornia_tpu_torch.feature import siftdesc as t_sift
from tests.golden_builders import _img, probe
from tests.torch_op_parity import (FAST_OPTIONS, Case, batch_references,
                                   run_case)
from tests.torch_threads import one_torch_thread  # noqa: F401


def _patches(seed, n, ps):
    rng = np.random.default_rng(seed)
    return gaussian_filter(rng.random((n, 1, ps, ps)),
                           (0, 0, 1.0, 1.0)).astype(np.float32)


def _image(seed, h, w, c=1):
    rng = np.random.default_rng(seed)
    return np.stack([gaussian_filter(rng.random((h, w)), 1.2)
                     for _ in range(c)]).astype(np.float32)[None]


def _lafs(seed, n, h, w, smin=2.0, smax=10.0):
    """(1, n, 2, 3) LAFs: centres inside, scales in [smin, smax], any
    orientation, up to 2:1 anisotropy."""
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


def _drawn(specs, seed):
    """A param dict for `specs` ({name: shape}) drawn with numpy: He-normal
    weights, and every other entry drawn in a range its role allows."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in specs.items():
        if name.endswith("running_var") or name.endswith("_var"):
            v = rng.uniform(0.5, 2.0, shape)
        elif name.endswith(".eps"):
            v = rng.uniform(1e-6, 1e-3, shape)
        elif name.endswith(".tau"):
            v = rng.uniform(-1.0, 0.0, shape)
        elif len(shape) >= 2:
            v = rng.normal(0, math.sqrt(2.0 / np.prod(shape[1:])), shape)
        elif name.endswith(".weight"):
            v = rng.uniform(0.5, 1.5, shape)
        else:
            v = rng.normal(0.0, 0.1, shape)
        out[name] = v.astype(np.float32)
    return out


def _hardnet8_specs():
    specs, cin = {}, 1
    for i, (cout, k, _s, _p) in enumerate(j_ext._HARDNET8_ARCH):
        specs[f"conv{i}_w"] = (cout, cin, k, k)
        specs[f"bn{i}_mean"] = (cout,)
        specs[f"bn{i}_var"] = (cout,)
        cin = cout
    specs["pca_mean"] = (512,)
    specs["pca_components"] = (512, 128)
    return specs


P = {"tfeat": _drawn(j_desc.TFeat._SPECS, 1),
     "sosnet": _drawn(j_desc.SOSNet._specs(), 2),
     "hynet": _drawn(j_desc.HyNet._specs(), 3),
     "hardnet8": _drawn(_hardnet8_specs(), 4)}
NAMES = {k: sorted(v) for k, v in P.items()}
ARRS = {k: [P[k][n] for n in NAMES[k]] for k in P}

P32 = _patches(0, 6, 32)
P41 = _patches(1, 4, 41)
P19 = _patches(2, 6, 19)
IMG = _image(3, 64, 96)
RGB = _image(4, 64, 96, 3)
LAFS = _lafs(5, 12, 64, 96)
DESC = np.random.default_rng(6).normal(size=(10, 16)).astype(np.float32)
STEER = np.random.default_rng(7).normal(size=(16, 16)).astype(np.float32)
FRN_X = np.random.default_rng(8).normal(size=(2, 4, 5, 5)).astype(np.float32)
WMKD = np.random.default_rng(9).normal(size=(36, 128)).astype(np.float32)


def _whitening_model(dims, seed):
    """A whitening model of the published layout: an orthonormal basis
    and positive decreasing eigenvalues, for both 'pca' and 'lw'."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(dims, dims)))
    model = {"mean": rng.normal(0, 0.01, dims),
             "eigvecs": q, "eigvals": np.sort(rng.uniform(0.1, 2.0,
                                                          dims))[::-1]}
    model = {k: np.ascontiguousarray(v, np.float32)
             for k, v in model.items()}
    return {"pca": model, "lw": model}


WM_CONCAT = _whitening_model(238, 10)
WM_POLAR = _whitening_model(175, 11)
WM_CART = _whitening_model(63, 12)


def _net_case(family, jax_net, torch_net, x, atol=1e-5):
    names = NAMES[family]
    return Case("", (x, ARRS[family]), atol=atol,
                jax_fn=lambda a, ps: jax_net(dict(zip(names, ps)))(a),
                torch_fn=lambda a, ps: torch_net(
                    {n: p.numpy() for n, p in zip(names, ps)})(a))


def _mkd_case(kernel_type, whitening, model, output_dims=128, simple=False,
              atol=1e-4):
    def make(mod):
        cls = mod.SimpleKD if simple else mod.MKDDescriptor
        return cls(32, kernel_type, whitening, "liberty", output_dims, model)
    return Case("", (P32,), atol=atol, jax_fn=lambda a: make(j_mkd)(a),
                torch_fn=lambda a: make(t_mkd)(a))


CASES = {
    "tfeat": _net_case("tfeat", lambda p: j_desc.TFeat(p),
                       lambda p: t_desc.TFeat(p, device="cpu"), P32, 2e-5),
    "tfeat_resized": _net_case("tfeat", lambda p: j_desc.TFeat(p),
                               lambda p: t_desc.TFeat(p, device="cpu"), P41,
                               2e-5),
    "sosnet": _net_case("sosnet", lambda p: j_desc.SOSNet(p),
                        lambda p: t_desc.SOSNet(p, device="cpu"), P32),
    "hynet": _net_case("hynet", lambda p: j_desc.HyNet(p),
                       lambda p: t_desc.HyNet(p, device="cpu"), P32),
    "hardnet8": _net_case("hardnet8", lambda p: j_ext.HardNet8(p),
                          lambda p: t_ext.HardNet8(p, device="cpu"), P32),
    "mkd_gradient_whitened": Case(
        "", (P32, WMKD),
        jax_fn=lambda a, w: j_desc.MKDGradientDescriptor(32, 128, w)(a),
        torch_fn=lambda a, w: t_desc.MKDGradientDescriptor(32, 128, w)(a)),
    "patch_affine_shape": Case(
        "", (P19,), atol=0, rtol=1e-4,
        jax_fn=lambda a: j_desc.PatchAffineShapeEstimator(19)(a),
        torch_fn=lambda a: t_desc.PatchAffineShapeEstimator(19)(a)),
    "discrete_steerer": Case(
        "", (DESC, STEER), atol=1e-5,
        jax_fn=lambda d, g: j_desc.DiscreteSteerer(g).steer_descriptions(
            d, 2, True),
        torch_fn=lambda d, g: t_desc.DiscreteSteerer(g).steer_descriptions(
            d, 2, True)),
    "dense_sift": Case("", (IMG[..., :24, :32],),
                       jax_fn=lambda a: j_sift.DenseSIFTDescriptor()(a),
                       torch_fn=lambda a: t_sift.DenseSIFTDescriptor()(a)),
    "dense_sift_no_root_unpadded": Case(
        "", (IMG[..., :24, :32],),
        jax_fn=lambda a: j_sift.DenseSIFTDescriptor(
            rootsift=False, padding=0)(a),
        torch_fn=lambda a: t_sift.DenseSIFTDescriptor(
            rootsift=False, padding=0)(a)),
    "patch_dominant_orientation": Case(
        "", (P32,), atol=1e-4, circle=True,
        jax_fn=lambda a: j_ext.PatchDominantGradientOrientation(32)(a),
        torch_fn=lambda a: t_ext.PatchDominantGradientOrientation(32)(a)),
    "frn_tlu": Case("", (FRN_X,), jax_fn=lambda a: j_ext.TLU(4)(
        j_ext.FilterResponseNorm2d(4)(a)),
        torch_fn=lambda a: t_ext.TLU(4)(t_ext.FilterResponseNorm2d(4)(a))),
    "mkd_concat": _mkd_case("concat", None, None, atol=1e-5),
    "mkd_concat_pcawt": _mkd_case("concat", "pcawt", WM_CONCAT),
    "mkd_polar_lw": _mkd_case("polar", "lw", WM_POLAR, 64),
    "mkd_cart_pca": _mkd_case("cart", "pca", WM_CART, 32),
    "simple_kd_pcaws": _mkd_case("polar", "pcaws", WM_POLAR, simple=True),
    "mkd_gradients": Case("", (P32,), jax_fn=j_mkd.MKDGradients(),
                          torch_fn=t_mkd.MKDGradients(), atol=1e-5),
    "spatial_kernel_embedding_polar": Case(
        "", (), jax_fn=lambda: j_mkd.spatial_kernel_embedding(
            "polar", j_mkd.get_grid_dict(16)),
        torch_fn=lambda: t_mkd.spatial_kernel_embedding(
            "polar", t_mkd.get_grid_dict(16))),
    "get_laf_descriptors_sift": Case(
        "", (IMG, LAFS),
        jax_fn=lambda i, l: j_ext.get_laf_descriptors(
            i, l, j_sift.SIFTDescriptor(32), 32),
        torch_fn=lambda i, l: t_ext.get_laf_descriptors(
            i, l, t_sift.SIFTDescriptor(32), 32)),
    "get_laf_descriptors_hardnet8_rgb": Case(
        "", (RGB, LAFS, ARRS["hardnet8"]),
        jax_fn=lambda i, l, ps: j_ext.get_laf_descriptors(
            i, l, j_ext.HardNet8(dict(zip(NAMES["hardnet8"], ps))), 32),
        torch_fn=lambda i, l, ps: t_ext.get_laf_descriptors(
            i, l, t_ext.HardNet8({n: p.numpy() for n, p in
                                  zip(NAMES["hardnet8"], ps)}, "cpu"), 32)),
}


@pytest.fixture(scope="module")
def refs():
    """Every reference of the module, and the reference's fixed MKD
    projection (its one draw, PRNGKey(12)) and shape-adapted LAFs, from
    one jitted program."""
    cases = dict(CASES)

    def proj_and_lafs(img, lafs, patches):
        est = j_desc.LAFAffineShapeEstimator(32)(lafs, img)
        out = j_desc.MKDGradientDescriptor(32, 128)(patches)
        proj = jax.random.normal(jax.random.PRNGKey(12), (36, 128))
        proj = proj / jnp.linalg.norm(proj, axis=0, keepdims=True)
        return est, out, proj

    cases["_extra"] = Case("", (IMG, LAFS, P32), jax_fn=proj_and_lafs)
    return batch_references(cases, None, FAST_OPTIONS)


@pytest.mark.parametrize("name", list(CASES))
def test_descriptor_matches_reference(name, refs):
    run_case(CASES[name], None, refs[name])


def test_mkd_gradient_descriptor_with_the_reference_projection(refs):
    """Without a whitening matrix both packages project by a fixed random
    matrix; the port's own comes from a torch generator seeded with 12,
    unit columns. Given the reference's, it gives the reference's
    descriptors."""
    _, want, proj = refs["_extra"]
    net = t_desc.MKDGradientDescriptor(32, 128)
    own = net(torch.from_numpy(P32))
    assert own.shape == (6, 128) and net.projection.shape == (36, 128)
    np.testing.assert_allclose(np.linalg.norm(net.projection, axis=0), 1.0,
                               rtol=1e-6)
    net.projection = np.asarray(proj)
    np.testing.assert_allclose(net(torch.from_numpy(P32)).numpy(),
                               np.asarray(want), atol=1e-5, rtol=0)


def test_laf_affine_shape_estimator_matches_reference(refs):
    want = np.asarray(refs["_extra"][0])
    got = t_desc.LAFAffineShapeEstimator(32)(torch.from_numpy(LAFS),
                                             torch.from_numpy(IMG)).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=1e-4 * scale, rtol=0)


def test_inverse_sqrt_2x2_holds_eigh():
    """The closed form against eigh, on well and badly conditioned and
    diagonal matrices."""
    rng = np.random.default_rng(13)
    A = rng.normal(size=(64, 2, 2))
    M = A @ A.transpose(0, 2, 1) + np.eye(2) * rng.uniform(1e-6, 1, 64)[
        :, None, None]
    M[:4] = np.diag([2.0, 3.0])
    M[4] = np.eye(2)
    w, v = np.linalg.eigh(M)
    want = np.einsum("nij,nj,nkj->nik", v, 1 / np.sqrt(w), v)
    t = torch.from_numpy(M)
    got, det = t_desc._inverse_sqrt_2x2(t[:, 0, 0], t[:, 0, 1], t[:, 1, 1])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(det.numpy(), np.linalg.det(want), rtol=1e-9)


def test_checkpoint_loaders_keep_names_and_check_shapes():
    sd = {k: torch.from_numpy(v) for k, v in P["sosnet"].items()}
    out = t_desc.load_sosnet_torch_weights(sd)
    assert sorted(out) == NAMES["sosnet"]
    net = t_desc.SOSNet.from_torch(sd, device="cpu")
    assert sorted(net.params) == NAMES["sosnet"]
    assert not any(p.requires_grad for p in net.parameters())
    for load, fam in ((t_desc.load_tfeat_torch_weights, "tfeat"),
                      (t_desc.load_hynet_torch_weights, "hynet")):
        assert sorted(load(P[fam])) == NAMES[fam]
    bad = dict(P["tfeat"], **{"descr.0.bias": np.zeros(3, np.float32)})
    with pytest.raises(ValueError):
        t_desc.load_tfeat_torch_weights(bad)


def test_hardnet8_loader_reads_the_checkpoint_layout():
    """features.{0,3,...} convolutions, each followed by its batch norm,
    and the PCA buffers."""
    sd, p = {}, P["hardnet8"]
    for i in range(8):
        sd[f"features.{3 * i}.weight"] = p[f"conv{i}_w"]
        sd[f"features.{3 * i + 1}.running_mean"] = p[f"bn{i}_mean"]
        sd[f"features.{3 * i + 1}.running_var"] = p[f"bn{i}_var"]
    sd["mean"], sd["components"] = p["pca_mean"], p["pca_components"]
    out = t_ext.load_hardnet8_torch_weights(sd)
    assert sorted(out) == NAMES["hardnet8"]
    for k in out:
        np.testing.assert_array_equal(out[k], p[k])


def test_whitening_loader_and_convert():
    state = {"liberty": {"pca": {k: torch.from_numpy(v) for k, v in
                                 WM_CART["pca"].items()}}}
    out = t_mkd.load_whitening_from_torch(state)
    np.testing.assert_array_equal(out["liberty"]["pca"]["eigvecs"],
                                  WM_CART["pca"]["eigvecs"])
    conv = convert.mkd_whitening_from_numpy(WM_CART)
    assert conv["lw"]["eigvals"].dtype == np.float32


def test_mkd_tables_live_per_device_and_object():
    """The embedding tables are copied to a device once per object, and
    two descriptors do not share them."""
    a, b = t_mkd.MKDDescriptor(), t_mkd.MKDDescriptor()
    x = torch.from_numpy(P32)
    a(x)
    se = a.feats["polar"][1]
    first = se._device_tables[("emb", torch.device("cpu"), torch.float32)][1]
    a(x)
    again = se._device_tables[("emb", torch.device("cpu"), torch.float32)][1]
    assert again is first
    assert "_device_tables" not in b.feats["polar"][1].__dict__


# --- golden families ------------------------------------------------------

@pytest.fixture(scope="module")
def golden_params():
    """tests/golden_builders.py's TFeat, SOSNet and HyNet parameters (each
    from PRNGKey(0)), drawn in one jitted call. ``_init_from_specs`` reads
    a fan-in with ``int(jnp.prod(...))``, which jit cannot trace;
    ``_jit_init`` is its draw with the fan-in from the static shape (jitted
    draws differ from eager ones by at most 1.2e-7)."""
    def _jit_init(key, specs):
        params = {}
        for name, shape in specs.items():
            key, sub = jax.random.split(key)
            if name.endswith("running_var"):
                params[name] = jnp.ones(shape)
            elif name.endswith(".tau"):
                params[name] = -jnp.ones(shape)
            elif name.endswith(".eps"):
                params[name] = jnp.full(shape, 1e-6)
            elif len(shape) >= 2:
                params[name] = jax.random.normal(sub, shape) * math.sqrt(
                    2.0 / math.prod(shape[1:]))
            elif name.endswith(".weight"):
                params[name] = jnp.ones(shape)
            else:
                params[name] = jnp.zeros(shape)
        return params

    def init(k):
        return {name: _jit_init(k, specs) for name, specs in
                (("tfeat", j_desc.TFeat._SPECS),
                 ("sosnet", j_desc.SOSNet._specs()),
                 ("hynet", j_desc.HyNet._specs()))}
    out = jax.jit(init)(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, out)


_GOLDEN = {
    "tfeat": lambda p: convert.tfeat_from_numpy(p["tfeat"], "cpu"),
    "sosnet": lambda p: convert.sosnet_from_numpy(p["sosnet"], "cpu"),
    "hynet": lambda p: convert.hynet_from_numpy(p["hynet"], device="cpu"),
    "mkd": lambda p: t_mkd.MKDDescriptor(32, "concat", None),
}


@pytest.mark.parametrize("family", sorted(_GOLDEN))
def test_port_reproduces_golden_family(golden_params, family):
    path = os.path.join(os.path.dirname(__file__), "golden",
                        "models_golden.json")
    with open(path) as f:
        expect = json.load(f)[family]
    x = torch.from_numpy(np.asarray(_img((4, 1, 32, 32))))
    got = probe(_GOLDEN[family](golden_params)(x).numpy())
    assert got["size"] == expect["size"]
    tol = 1e-4 * max(abs(expect["absmax"]), 1e-3)
    assert abs(got["mean"] - expect["mean"]) < tol
    assert abs(got["std"] - expect["std"]) < tol
    np.testing.assert_allclose(got["values"], expect["values"], atol=10 * tol)


def test_default_initialisations_are_seeded():
    """Without params the nets draw from CPU generators seeded with the
    reference's keys (TFeat 0, SOSNet 1, HyNet 2, HardNet8 8): two builds
    agree, and TLU thresholds and FRN epsilons take their init values."""
    for cls in (t_desc.TFeat, t_desc.SOSNet, t_desc.HyNet):
        a, b = cls(device="cpu"), cls(device="cpu")
        for k, v in a.params.items():
            torch.testing.assert_close(v, b.params[k], rtol=0, atol=0)
    h = t_desc.HyNet(device="cpu").params
    assert float(h["layer1.1.tau"].max()) == -1.0
    assert abs(float(h["layer1.0.eps"][0]) - 1e-6) < 1e-12
    h8 = t_ext.HardNet8(device="cpu")
    assert h8(torch.from_numpy(P32)).shape == (6, 128)
