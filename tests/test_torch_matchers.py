"""The port's matchers and the DISK detector (kornia_tpu_torch:
feature/adalam.py, feature/lightglue.py and feature/disk.py whole, and
feature/extras.py's match_adalam, GeometryAwareDescriptorMatcher and
LightGlueMatcher) against the JAX package on the CPU.

The nets take the same parameters in both packages (drawn with numpy in
the reference's layout: DISK's convolutions HWIO). Every JAX reference of
the module comes from one jitted program
(``tests/torch_op_parity.py::batch_references``, compiled with
``FAST_OPTIONS``: a fifth less compile time); the golden families
(lightglue, disk_unet) reproduce tests/golden/models_golden.json from the
reference's own initialisations at tests/test_golden_models.py's
tolerance.

Tolerances: AdaLAM's keep mask and the matchers' index pairs equal, their
distances 1e-5; LightGlue's log assignment 1e-4 of its largest entry, its
matches equal and its scores 1e-5; DISK's heatmap and descriptors 1e-4
of their largest entry, its keypoints and validity equal.
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

from kornia_tpu.feature import adalam as j_adalam
from kornia_tpu.feature import disk as j_disk
from kornia_tpu.feature import extras as j_ext
from kornia_tpu.feature import lightglue as j_lg
from kornia_tpu_torch import convert
from kornia_tpu_torch.feature import adalam as t_adalam
from kornia_tpu_torch.feature import disk as t_disk
from kornia_tpu_torch.feature import extras as t_ext
from kornia_tpu_torch.feature import lightglue as t_lg
from tests.golden_builders import _img, probe
from tests.torch_op_parity import (FAST_OPTIONS, Case, batch_references,
                                   check_close)
from tests.torch_threads import one_torch_thread  # noqa: F401

N = 96


def _matches(seed, n=N, outliers=0.3, w=160.0, h=120.0):
    """Matched points under a smooth warp (two affine halves) with a share
    of outliers, and a validity mask with a few rows off."""
    rng = np.random.default_rng(seed)
    kp0 = rng.uniform([0, 0], [w, h], (n, 2))
    A = np.array([[1.05, 0.1], [-0.08, 0.95]])
    kp1 = kp0 @ A.T + [7.0, -4.0]
    kp1[kp0[:, 0] > w / 2] += [3.0, 2.0]
    bad = rng.random(n) < outliers
    kp1[bad] = rng.uniform([0, 0], [w, h], (bad.sum(), 2))
    kp1 += rng.normal(0, 0.5, kp1.shape)
    valid = rng.random(n) > 0.05
    return (kp0.astype(np.float32), kp1.astype(np.float32), valid)


def _lafs_at(xy, scale=4.0):
    n = xy.shape[0]
    A = np.tile(np.eye(2, dtype=np.float32) * scale, (n, 1, 1))
    return np.concatenate([A, xy[:, :, None]], -1)[None].astype(np.float32)


def _descs(seed, n, d=128, noise=0.3, base=None):
    rng = np.random.default_rng(seed)
    x = base if base is not None else rng.normal(size=(n, d))
    x = x + noise * rng.normal(size=x.shape)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


KP0, KP1, VALID = _matches(0)
KP0_DENSE, KP1_DENSE, _ = _matches(1, n=160, outliers=0.1)
D0 = _descs(2, N)
# row i matches row i, as KP0 and KP1 do; the last 16 rows match nothing
D1 = np.concatenate([_descs(3, N - 16, base=D0[:N - 16]), _descs(4, 16)])
LAF0, LAF1 = _lafs_at(KP0), _lafs_at(KP1)


def _lg_params(cfg, seed):
    """LightGlue parameters of `cfg`'s layout, drawn with numpy: linear
    weights N(0, 1/fan_in), LayerNorm scales near 1, biases small."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in j_lg._param_specs(cfg).items():
        if len(shape) == 2:
            v = rng.normal(0, 1 / math.sqrt(shape[1]), shape)
        elif name.endswith("ffn.1.weight"):
            v = rng.uniform(0.8, 1.2, shape)
        else:
            v = rng.normal(0, 0.05, shape)
        out[name] = v.astype(np.float32)
    return out


def _disk_params(seed):
    """DISK parameters in the reference's layout (HWIO convolutions)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in j_disk._param_specs().items():
        if len(shape) == 4:
            o, i, kh, kw = shape
            v = rng.normal(0, math.sqrt(2.0 / (i * kh * kw)), (kh, kw, i, o))
        elif name.endswith("1.weight"):
            v = rng.uniform(0.1, 0.4, shape)
        else:
            v = rng.normal(0, 0.05, shape)
        out[name] = v.astype(np.float32)
    return out


LG_CFGS = {
    "doghardnet": dict(features="doghardnet", descriptor_dim=32, n_layers=2,
                       num_heads=2),
    "sift": dict(features="sift", descriptor_dim=32, n_layers=2,
                 num_heads=4),
    "plain": dict(input_dim=32, descriptor_dim=32, n_layers=3, num_heads=2,
                  filter_threshold=0.01),
}
LG_P = {k: _lg_params(j_lg.LightGlueConfig(**v), i)
        for i, (k, v) in enumerate(LG_CFGS.items())}
LG_NAMES = {k: sorted(v) for k, v in LG_P.items()}
LG_ARRS = {k: [LG_P[k][n] for n in LG_NAMES[k]] for k in LG_P}

_RNG = np.random.default_rng(20)
LG_KP0 = (_RNG.uniform(0, 1, (1, 24, 2)) * [160, 120]).astype(np.float32)
LG_KP1 = np.concatenate([LG_KP0[:, :18] + _RNG.normal(0, 1, (1, 18, 2)),
                         _RNG.uniform(0, 1, (1, 2, 2)) * [160, 120]],
                        1).astype(np.float32)
LG_D0 = _descs(21, 24, 128).reshape(1, 24, 128)
LG_D1 = np.concatenate([_descs(22, 18, 128, 0.2, LG_D0[0, :18]),
                        _descs(23, 2, 128)], 0)[None].astype(np.float32)
LG_S0 = _RNG.uniform(1, 6, (1, 24)).astype(np.float32)
LG_S1 = _RNG.uniform(1, 6, (1, 20)).astype(np.float32)
LG_O0 = _RNG.uniform(-3, 3, (1, 24)).astype(np.float32)
LG_O1 = _RNG.uniform(-3, 3, (1, 20)).astype(np.float32)
SIZE = np.array([160.0, 120.0], np.float32)

DISK_P = _disk_params(30)
DISK_NAMES = sorted(DISK_P)
DISK_ARRS = [DISK_P[n] for n in DISK_NAMES]
DISK_IMG = np.stack([gaussian_filter(np.random.default_rng(31 + c).random(
    (40, 56)), 1.5) for c in range(3)]).astype(np.float32)[None]


def _nested(kp0, d0, kp1, d1, s0=None, o0=None, s1=None, o1=None,
            size=None):
    i0 = {"keypoints": kp0, "descriptors": d0, "image_size": size}
    i1 = {"keypoints": kp1, "descriptors": d1, "image_size": size}
    if s0 is not None:
        i0.update(scales=s0, oris=o0)
        i1.update(scales=s1, oris=o1)
    return {"image0": i0, "image1": i1}


def _lg_case(name, scale_ori):
    names, cfg = LG_NAMES[name], LG_CFGS[name]
    d_in = 128 if "features" in cfg else 32
    args = (LG_KP0, LG_D0[..., :d_in], LG_KP1, LG_D1[..., :d_in], SIZE,
            LG_S0, LG_O0, LG_S1, LG_O1, LG_ARRS[name])

    def run(mod, make, kp0, d0, kp1, d1, size, s0, o0, s1, o1, ps):
        data = _nested(kp0, d0, kp1, d1, *((s0, o0, s1, o1) if scale_ori
                                           else (None,) * 4), size=size)
        out = make(mod.LightGlueConfig(**cfg), dict(zip(names, ps)))(data)
        return [out[k] for k in ("log_assignment", "matches0", "matches1",
                                 "matching_scores0", "matching_scores1")]

    return Case("", args,
                jax_fn=lambda *a: run(j_lg, lambda c, p: j_lg.LightGlue(
                    c, params=p), *a),
                torch_fn=lambda *a: run(t_lg, lambda c, p: t_lg.LightGlue(
                    c, params={k: v.numpy() for k, v in p.items()},
                    device="cpu"), *a))


def _matcher(mode):
    params = {"num_seeds": 32} if mode == "adalam" else {"th": 0.9}
    return lambda mod: mod.GeometryAwareDescriptorMatcher(mode, params)


CASES = {
    "adalam_filter": Case("adalam_filter", (KP0, KP1, VALID)),
    "adalam_filter_no_mask_few_seeds": Case(
        "adalam_filter", (KP0_DENSE, KP1_DENSE), {"num_seeds": 8,
                                                   "inlier_th": 4.0}),
    "match_adalam": Case("", (D0, D1, LAF0, LAF1),
                         jax_fn=lambda *a: j_ext.match_adalam(*a),
                         torch_fn=lambda *a: t_ext.match_adalam(*a)),
    "matcher_adalam": Case("", (D0, D1, LAF0, LAF1),
                           jax_fn=lambda *a: _matcher("adalam")(j_ext)(*a),
                           torch_fn=lambda *a: _matcher("adalam")(t_ext)(*a)),
    "matcher_fginn": Case("", (D0, D1, LAF0, LAF1),
                          jax_fn=lambda *a: _matcher("fginn")(j_ext)(*a),
                          torch_fn=lambda *a: _matcher("fginn")(t_ext)(*a)),
    "lightglue_doghardnet": _lg_case("doghardnet", True),
    "lightglue_sift": _lg_case("sift", True),
    "lightglue_plain": _lg_case("plain", False),
    "lightglue_flat_layout": Case(
        "", (LG_KP0, LG_D0[..., :32], LG_KP1, LG_D1[..., :32], SIZE,
             LG_ARRS["plain"]),
        jax_fn=lambda k0, d0, k1, d1, s, ps: j_lg.LightGlue(
            j_lg.LightGlueConfig(**LG_CFGS["plain"]),
            params=dict(zip(LG_NAMES["plain"], ps)))(
            {"keypoints0": k0, "keypoints1": k1, "descriptors0": d0,
             "descriptors1": d1, "image_size": s})["log_assignment"],
        torch_fn=lambda k0, d0, k1, d1, s, ps: t_lg.LightGlue(
            t_lg.LightGlueConfig(**LG_CFGS["plain"]),
            params={n: p.numpy() for n, p in zip(LG_NAMES["plain"], ps)},
            device="cpu")(
            {"keypoints0": k0, "keypoints1": k1, "descriptors0": d0,
             "descriptors1": d1, "image_size": s})["log_assignment"]),
    "lightglue_matcher": Case(
        "", (LG_D0[0, :, :32], LG_D1[0, :, :32], _lafs_at(LG_KP0[0]),
             _lafs_at(LG_KP1[0]), LG_ARRS["plain"]),
        jax_fn=lambda d0, d1, l0, l1, ps: j_ext.LightGlueMatcher(
            params={"cfg": j_lg.LightGlueConfig(**LG_CFGS["plain"]),
                    "weights": dict(zip(LG_NAMES["plain"], ps))})(
            d0, d1, l0, l1, (120, 160), (120, 160)),
        torch_fn=lambda d0, d1, l0, l1, ps: t_ext.LightGlueMatcher(
            params={"cfg": t_lg.LightGlueConfig(**LG_CFGS["plain"]),
                    "weights": {n: p.numpy() for n, p in
                                zip(LG_NAMES["plain"], ps)}},
            device="cpu")(d0, d1, l0, l1, (120, 160), (120, 160))),
    "disk_heatmap_and_descriptors": Case(
        "", (DISK_IMG, DISK_ARRS),
        jax_fn=lambda x, ps: j_disk.DISK(params=dict(zip(DISK_NAMES, ps))
                                         ).heatmap_and_dense_descriptors(
            jnp.pad(x, [(0, 0), (0, 0), (0, 8), (0, 8)])),
        torch_fn=lambda x, ps: t_disk.DISK(
            params={n: p.numpy() for n, p in zip(DISK_NAMES, ps)},
            device="cpu").heatmap_and_dense_descriptors(
            torch.nn.functional.pad(x, (0, 8, 0, 8)))),
    "disk_forward": Case(
        "", (DISK_IMG, DISK_ARRS),
        jax_fn=lambda x, ps: _disk_out(j_disk.DISK(
            params=dict(zip(DISK_NAMES, ps)))(x, 64, 5)),
        torch_fn=lambda x, ps: _disk_out(t_disk.DISK(
            params={n: p.numpy() for n, p in zip(DISK_NAMES, ps)},
            device="cpu")(x, 64, 5))),
}


def _disk_out(f):
    return [f.keypoints, f.descriptors, f.detection_scores, f.valid]


@pytest.fixture(scope="module")
def refs():
    def golden(k):
        """tests/golden_builders.py's LightGlue and DISK draws (jitted),
        and the LightGlue inputs it draws."""
        cfg = j_lg.LightGlueConfig(descriptor_dim=32, input_dim=32,
                                   n_layers=2, num_heads=2)
        return dict(
            lightglue=j_lg.lightglue_init_params(k, cfg),
            disk=j_disk.disk_init_params(k),
            lg_in=[jax.random.uniform(jax.random.PRNGKey(1), (1, 16, 2)) * 64,
                   jax.random.uniform(jax.random.PRNGKey(2), (1, 16, 2)) * 64,
                   jax.random.normal(jax.random.PRNGKey(3), (1, 16, 32)),
                   jax.random.normal(jax.random.PRNGKey(4), (1, 16, 32))])

    cases = dict(CASES)
    cases["_golden"] = Case("", (), jax_fn=lambda: golden(
        jax.random.PRNGKey(0)))
    return batch_references(cases, j_adalam, FAST_OPTIONS)


def _check(name, got, want):
    if name.startswith("lightglue") and name != "lightglue_matcher":
        got = [got] if name == "lightglue_flat_layout" else got
        want = [want] if name == "lightglue_flat_layout" else want
        la, wa = got[0].numpy(), np.asarray(want[0])
        np.testing.assert_allclose(la, wa, rtol=0,
                                   atol=1e-4 * np.abs(wa).max())
        for g, w in zip(got[1:3], want[1:3]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        for g, w in zip(got[3:], want[3:]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
        return
    if name.startswith("disk"):
        if name == "disk_forward":
            kp, d, s, v = [np.asarray(w) for w in want]
            np.testing.assert_array_equal(got[3].numpy(), v)
            np.testing.assert_array_equal(got[0].numpy()[v], kp[v])
            np.testing.assert_allclose(got[1].numpy()[v], d[v], atol=1e-4)
            np.testing.assert_allclose(got[2].numpy(), s,
                                       atol=1e-4 * np.abs(s).max())
            assert v.sum() > 8
            return
        for g, w in zip(got, want):
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                       atol=1e-4 * np.abs(w).max())
        return
    check_close(got, want, 1e-5, 0.0, False, name)


@pytest.mark.parametrize("name", list(CASES))
def test_matcher_matches_reference(name, refs):
    case = CASES[name]
    tf = case.torch_fn or getattr(t_adalam, case.fn)
    got = tf(*[torch.from_numpy(a.copy()) if isinstance(a, np.ndarray) else
               ([torch.from_numpy(x.copy()) for x in a]
                if isinstance(a, list) else a) for a in case.args],
             **case.kwargs)
    _check(name, got, refs[name])


def test_the_filters_keep_and_drop(refs):
    """The probes reach both outcomes: AdaLAM keeps most inliers and drops
    most outliers, the AdaLAM matchers keep some rows and drop the
    unmatched ones, and LightGlue matches some keypoints and not others."""
    keep = np.asarray(refs["adalam_filter"])
    assert 0.3 * N < keep.sum() < VALID.sum()
    for name in ("match_adalam", "matcher_adalam"):
        idx = np.asarray(refs[name][1])
        assert 8 < (idx[:, 0] >= 0).sum() < N - 16
    m0 = np.asarray(refs["lightglue_plain"][1])
    assert (m0 >= 0).any() and (m0 < 0).any()


def test_lightglue_matcher_reads_the_image_size_from_the_keypoints():
    """Without hw the size comes from the largest LAF centre, as in the
    reference (one read to the host)."""
    cfg = t_lg.LightGlueConfig(**LG_CFGS["plain"])
    m = t_ext.LightGlueMatcher(params={"cfg": cfg, "weights": LG_P["plain"]},
                               device="cpu")
    d0 = torch.from_numpy(LG_D0[0, :, :32])
    d1 = torch.from_numpy(LG_D1[0, :, :32])
    l0, l1 = (torch.from_numpy(_lafs_at(k[0])) for k in (LG_KP0, LG_KP1))
    kmax0 = LG_KP0[0].max(0)
    kmax1 = LG_KP1[0].max(0)
    a = m(d0, d1, l0, l1)
    b = m(d0, d1, l0, l1, (int(kmax0[1]) + 1, int(kmax0[0]) + 1),
          (int(kmax1[1]) + 1, int(kmax1[0]) + 1))
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_disk_ties_take_the_lower_index():
    """A flat heatmap suppresses everything (plateaus die): every row is
    -inf and invalid, and the indices are the first n in order, as
    lax.top_k gives them."""
    net = t_disk.DISK(params={k: v * 0 for k, v in DISK_P.items()},
                      device="cpu")
    f = net(torch.from_numpy(DISK_IMG), n=8)
    assert not f.valid.any()
    np.testing.assert_array_equal(f.keypoints[0, :, 0].numpy(),
                                  np.arange(8))


def test_loaders_and_convert():
    cfg = t_lg.LightGlueConfig(**LG_CFGS["plain"])
    old = {k.replace("transformers.0.self_attn", "self_attn.0")
           .replace("transformers.0.cross_attn", "cross_attn.0"):
           torch.from_numpy(v) for k, v in LG_P["plain"].items()}
    old = {"matcher." + k: v for k, v in old.items()}
    assert sorted(t_lg.load_torch_weights(old, cfg)) == LG_NAMES["plain"]
    lg = t_lg.LightGlue.from_torch(old, cfg, device="cpu")
    assert not any(p.requires_grad for p in lg.parameters())
    sd = {k: torch.from_numpy(v.transpose(3, 2, 0, 1) if v.ndim == 4 else v)
          for k, v in DISK_P.items()}
    back = t_disk.load_torch_weights(sd)
    for k in DISK_NAMES:
        np.testing.assert_array_equal(back[k], DISK_P[k])
    net = t_disk.DISK.from_torch(sd, device="cpu")
    torch.testing.assert_close(net.params["unet.path_down.0.1.3.weight"],
                               sd["unet.path_down.0.1.3.weight"])
    conv = convert.disk_from_numpy(DISK_P, "cpu")
    assert conv.params["unet.path_up.3.conv.3.weight"].shape == \
        (129, 64 + 16, 5, 5)
    assert convert.lightglue_from_numpy(LG_P["plain"], cfg, "cpu").cfg is cfg


# --- golden families ------------------------------------------------------

def _golden_lightglue(g):
    cfg = t_lg.LightGlueConfig(descriptor_dim=32, input_dim=32, n_layers=2,
                               num_heads=2)
    k0, k1, d0, d1 = [torch.from_numpy(np.asarray(a)) for a in g["lg_in"]]
    model = convert.lightglue_from_numpy(
        {k: np.asarray(v) for k, v in g["lightglue"].items()}, cfg, "cpu")
    return model({"keypoints0": k0, "keypoints1": k1, "descriptors0": d0,
                  "descriptors1": d1,
                  "image_size": [64.0, 64.0]})["log_assignment"]


def _golden_disk_unet(g):
    net = convert.disk_from_numpy({k: np.asarray(v) for k, v in
                                   g["disk"].items()}, "cpu")
    x = torch.from_numpy(np.asarray(_img((1, 3, 64, 64))))
    return t_disk.disk_unet(net.params, x)


_GOLDEN = {"lightglue": _golden_lightglue, "disk_unet": _golden_disk_unet}


@pytest.mark.parametrize("family", sorted(_GOLDEN))
def test_port_reproduces_golden_family(refs, family):
    path = os.path.join(os.path.dirname(__file__), "golden",
                        "models_golden.json")
    with open(path) as f:
        expect = json.load(f)[family]
    got = probe(_GOLDEN[family](refs["_golden"]).numpy())
    assert got["size"] == expect["size"]
    tol = 1e-4 * max(abs(expect["absmax"]), 1e-3)
    assert abs(got["mean"] - expect["mean"]) < tol
    assert abs(got["std"] - expect["std"]) < tol
    np.testing.assert_allclose(got["values"], expect["values"], atol=10 * tol)
