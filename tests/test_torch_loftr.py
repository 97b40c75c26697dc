"""The port's LoFTR (kornia_tpu_torch/feature/loftr.py) against the JAX
package's on the CPU, at tests/test_models_misc.py's small configuration
(coarse 64, fine 32, one coarse layer pair, 4 heads, top_k 32) on 64x64 and
64x96 pairs.

Weights are drawn once from a seeded generator, with the batch-norm
statistics, norm scales and biases drawn too; the JAX side gets them in its
HWIO conv layout and the port through ``convert.loftr_from_numpy``. The JAX
side is jitted once. Tolerances: dense maps and tokens 1e-5 of their
largest |entry|, the confidence matrix 1e-4 (the dual softmax at
temperature 0.1 amplifies the tokens' rounding); coarse matches compared
on the valid entries (top-k orders the many zero scores of invalid entries
arbitrarily), their scores exactly on the same matrix and to 1e-4 through
the forward (confidences are at most 1); fine keypoints 1e-3 px (the
window's spatial expectation is scaled by 4 px).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from kornia_tpu.feature import loftr as j_loftr
from kornia_tpu_torch import convert
from kornia_tpu_torch.feature import loftr as t_loftr
from tests.torch_op_parity import exact_jit
from tests.torch_threads import one_torch_thread  # noqa: F401

CFG = dict(coarse_dim=64, fine_dim=32, num_coarse_layers=1, num_heads=4,
           top_k=32)
SIZES = [(64, 64), (64, 96)]
# with random weights a few tokens win most rows' maxima, and the 2-cell
# border leaves 4x4 and 4x8 of these 8x8 and 8x12 coarse grids: 0-2 valid
# matches. The same weights without the border removal give 6 and 9, so
# the coarse and fine stages are also held on more matches.
MATCH_CFGS = {"published": CFG, "no_border": dict(CFG, border_rm=0)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close_rel(out, ref, rel=1e-5):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=0,
                               atol=rel * max(np.abs(ref).max(), 1e-30))


def _nchw(a):
    return np.transpose(np.asarray(a), (0, 3, 1, 2))


@pytest.fixture(scope="module")
def weights():
    """(JAX params with HWIO convs, the same as torch-layout numpy)."""
    cfg = t_loftr.LoFTRConfig(**CFG)
    rng = np.random.default_rng(0)
    torch_layout = {}
    for k, v in t_loftr.loftr_init_params(torch.Generator().manual_seed(3),
                                          cfg).items():
        v = v.numpy()
        if k.endswith("running_mean") or k.endswith("bias"):
            v = rng.normal(0.0, 0.1, v.shape).astype(np.float32)
        elif k.endswith("running_var") or (v.ndim == 1
                                           and k.endswith("weight")):
            v = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        torch_layout[k] = v
    jax_layout = {k: v.transpose(2, 3, 1, 0) if v.ndim == 4 else v
                  for k, v in torch_layout.items()}
    return jax_layout, torch_layout


def _pair(h, w):
    """A smooth random image and its 8 px (one coarse cell) shift."""
    rng = np.random.default_rng(h + w)
    img0 = gaussian_filter(rng.random((h, w + 8)), 1.5).astype(np.float32)
    return img0[None, None, :, 8:], img0[None, None, :, :-8]


def _jax_run(p, a, b, cfg, match_cfgs):
    """The reference's forward, with its intermediates."""
    c0, f0 = j_loftr.loftr_backbone(p, cfg, a)
    c1, f1 = j_loftr.loftr_backbone(p, cfg, b)
    B, h0, w0, C = c0.shape
    h1, w1 = c1.shape[1:3]
    t0 = (c0 + j_loftr.position_encoding(C, (h0, w0), False)).reshape(
        B, -1, C)
    t1 = (c1 + j_loftr.position_encoding(C, (h1, w1), False)).reshape(
        B, -1, C)
    t0, t1 = j_loftr._transformer(p, "loftr_coarse", cfg.num_coarse_layers,
                                  cfg.num_heads, t0, t1)
    sim = jnp.einsum("nlc,nsc->nls", t0 / C ** 0.5, t1 / C ** 0.5) \
        / cfg.dsmax_temperature
    conf = jax.nn.softmax(sim, 1) * jax.nn.softmax(sim, 2)
    out = {name: j_loftr.LoFTR(c, params=p)({"image0": a, "image1": b})
           for name, c in match_cfgs.items()}
    return dict(c0=c0, f0=f0, c1=c1, f1=f1, t0=t0, t1=t1, conf=conf,
                out=out)


@pytest.fixture(scope="module")
def runs(weights):
    jcfgs = {k: j_loftr.LoFTRConfig(**c) for k, c in MATCH_CFGS.items()}
    p_j, _ = weights
    models = {k: convert.loftr_from_numpy(p_j, t_loftr.LoFTRConfig(**c),
                                          "cpu")
              for k, c in MATCH_CFGS.items()}
    fn = jax.jit(lambda p, a, b: _jax_run(p, a, b, jcfgs["published"],
                                          jcfgs))
    pj = {k: jnp.asarray(v) for k, v in p_j.items()}
    out = {}
    for h, w in SIZES:
        a, b = _pair(h, w)
        ref = _np(fn(pj, jnp.asarray(a), jnp.asarray(b)))
        st = models["published"].coarse_stage(_t(a), _t(b))
        full = {k: m({"image0": _t(a), "image1": _t(b)})
                for k, m in models.items()}
        out[(h, w)] = dict(ref=ref, st=st, full=full, images=(a, b))
    return models["published"], out


@pytest.mark.parametrize("hw", SIZES)
def test_backbone_matches_reference(runs, hw):
    _, out = runs
    ref, st = out[hw]["ref"], out[hw]["st"]
    for name in ("c0", "f0", "c1", "f1"):
        assert st[name].shape == _nchw(ref[name]).shape
        _close_rel(st[name].numpy(), _nchw(ref[name]))


@pytest.mark.parametrize("hw", SIZES)
def test_coarse_transformer_and_confidence_match_reference(runs, hw):
    _, out = runs
    ref, st = out[hw]["ref"], out[hw]["st"]
    for name in ("t0", "t1"):
        _close_rel(st[name].numpy(), ref[name])
    # the dual softmax at temperature 0.1 amplifies the tokens' rounding
    _close_rel(st["conf"].numpy(), ref["conf"], 1e-4)


def _valid_matches(i, j, s, v):
    return {(int(a), int(b)): float(c) for a, b, c, ok in
            zip(i.ravel(), j.ravel(), s.ravel(), v.ravel()) if ok}


@pytest.mark.parametrize("cfg", sorted(MATCH_CFGS))
@pytest.mark.parametrize("hw", SIZES)
def test_coarse_match_matches_reference(runs, hw, cfg):
    """Both coarse matchers on the reference's confidence matrix."""
    _, out = runs
    conf = out[hw]["ref"]["conf"]
    h, w = hw
    hwc = (h // 8, w // 8)
    c = MATCH_CFGS[cfg]
    ref = _np(exact_jit(lambda m: j_loftr._coarse_match(
        j_loftr.LoFTRConfig(**c), m, hwc, hwc, 32), conf))
    got = [t.numpy() for t in t_loftr._coarse_match(
        t_loftr.LoFTRConfig(**c), _t(conf), hwc, hwc, 32)]
    want = _valid_matches(*ref)
    if cfg == "no_border":
        assert len(want) >= 6
    have = _valid_matches(*got)
    assert have.keys() == want.keys()
    for k in want:
        assert have[k] == want[k]


def test_coarse_match_rules():
    """Threshold, border, mutual maximum and the first-maximum tie rule on
    a planted confidence matrix (6x6 cells, border 2 leaves the inner
    2x2)."""
    cfg = t_loftr.LoFTRConfig(**CFG)
    conf = torch.full((1, 36, 36), 0.01)
    inner = [14, 15, 20, 21]
    conf[0, 14, 15] = 0.9   # kept: mutual, inside
    conf[0, 15, 14] = 0.1   # under the threshold
    conf[0, 20, 21] = 0.5   # not the column maximum below
    conf[0, 21, 21] = 0.6   # kept
    conf[0, 0, 0] = 0.95    # on the border
    i, j, s, v = (t.numpy()[0] for t in t_loftr._coarse_match(
        cfg, conf, (6, 6), (6, 6), 4))
    got = {(int(a), int(b)) for a, b, ok in zip(i, j, v) if ok}
    assert got == {(14, 15), (21, 21)}
    assert all(a in inner for a, _ in got)
    np.testing.assert_allclose(np.sort(s[v])[::-1], [0.9, 0.6])
    ref = _np(exact_jit(lambda m: j_loftr._coarse_match(
        j_loftr.LoFTRConfig(**CFG), m, (6, 6), (6, 6), 4), conf.numpy()))
    assert _valid_matches(*ref).keys() == got


@pytest.mark.parametrize("cfg", sorted(MATCH_CFGS))
@pytest.mark.parametrize("hw", SIZES)
def test_forward_matches_reference(runs, hw, cfg):
    _, out = runs
    ref, full = out[hw]["ref"]["out"][cfg], out[hw]["full"][cfg]
    for k in ("keypoints0", "keypoints1", "confidence", "valid",
              "batch_indexes"):
        assert full[k].shape == ref[k].shape
    v_ref, v = ref["valid"][0], full["valid"][0].numpy()
    assert v.sum() == v_ref.sum()
    if cfg == "no_border":
        assert v.sum() >= 6
    # the valid entries, keyed by their image-0 keypoint
    key = lambda kp: [tuple(r) for r in kp.astype(np.int64)]  # noqa: E731
    r0 = dict(zip(key(ref["keypoints0"][0][v_ref]),
                  zip(ref["keypoints1"][0][v_ref],
                      ref["confidence"][0][v_ref])))
    g0 = dict(zip(key(full["keypoints0"][0].numpy()[v]),
                  zip(full["keypoints1"][0].numpy()[v],
                      full["confidence"][0].numpy()[v])))
    assert g0.keys() == r0.keys()
    for k in r0:
        np.testing.assert_allclose(g0[k][0], r0[k][0], atol=1e-3)
        np.testing.assert_allclose(g0[k][1], r0[k][1], rtol=0, atol=1e-4)
    assert np.isfinite(full["keypoints1"].numpy()).all()


@pytest.mark.parametrize("fix", [False, True])
@pytest.mark.parametrize("d_model", [64, 256])
def test_position_encoding_matches_reference(fix, d_model):
    """Both the floor-division variant (div = exp(-k) for d_model 256) and
    the fixed one."""
    ref = np.asarray(exact_jit(lambda: j_loftr.position_encoding(
        d_model, (5, 7), fix)))
    got = t_loftr.position_encoding(d_model, (5, 7), fix, device="cpu")
    assert got.shape == (1, d_model, 5, 7)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref,
                               rtol=0, atol=1e-6)


def test_linear_attention_and_transformer_match_reference(weights):
    p_j, p_t = weights
    rng = np.random.default_rng(4)
    q, k, v = (rng.normal(size=(2, 30, 4, 16)).astype(np.float32)
               for _ in range(3))
    ref = np.asarray(exact_jit(j_loftr._linear_attention, q, k, v))
    _close_rel(t_loftr._linear_attention(_t(q), _t(k), _t(v)).numpy(), ref)
    f0, f1 = (rng.normal(size=(2, 25, 32)).astype(np.float32)
              for _ in range(2))
    ref = _np(jax.jit(lambda a, b: j_loftr._transformer(
        {kk: jnp.asarray(vv) for kk, vv in p_j.items()}, "loftr_fine", 1, 4,
        a, b))(jnp.asarray(f0), jnp.asarray(f1)))
    got = t_loftr._transformer({kk: _t(vv) for kk, vv in p_t.items()},
                               "loftr_fine", 1, 4, _t(f0), _t(f1))
    for g, r in zip(got, ref):
        _close_rel(g.numpy(), r)


def test_window_gather_and_expectation_match_reference():
    rng = np.random.default_rng(5)
    feat = rng.normal(size=(2, 16, 24, 8)).astype(np.float32)  # NHWC
    ids = rng.integers(0, 4 * 6, size=(2, 7))
    ref = np.asarray(exact_jit(lambda f, i: j_loftr._gather_windows(
        f, i, 6, 5, 4), feat, ids))
    got = t_loftr._gather_windows(_t(np.transpose(feat, (0, 3, 1, 2))),
                                  _t(ids), 6, 5, 4)
    assert got.shape == (2, 7, 25, 8)
    np.testing.assert_array_equal(got.numpy(), ref)
    heat = rng.random((9, 5, 5)).astype(np.float32)
    heat /= heat.sum((1, 2), keepdims=True)
    np.testing.assert_allclose(
        t_loftr._spatial_expectation(_t(heat)).numpy(),
        np.asarray(exact_jit(j_loftr._spatial_expectation, heat)),
        rtol=0, atol=1e-6)


def test_load_torch_weights_round_trip(runs, weights):
    """A torch state_dict with the checkpoints' names (with and without the
    'matcher.' prefix) loads into the port unchanged and into the JAX
    package as the same weights in its HWIO layout."""
    model, out = runs
    p_j, _ = weights
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    for prefix in ("", "matcher."):
        sd_p = {prefix + k: v for k, v in sd.items()}
        loaded = t_loftr.load_torch_weights(sd_p,
                                            t_loftr.LoFTRConfig(**CFG))
        assert loaded.keys() == sd.keys()
        for k, v in loaded.items():
            np.testing.assert_array_equal(v, sd[k].numpy())
    j_loaded = j_loftr.load_torch_weights({k: v.numpy() for k, v in
                                           sd.items()},
                                          j_loftr.LoFTRConfig(**CFG))
    for k, v in p_j.items():
        np.testing.assert_array_equal(np.asarray(j_loaded[k]), v)
    again = t_loftr.LoFTR.from_torch(sd_p, t_loftr.LoFTRConfig(**CFG),
                                     device="cpu")
    a, b = out[SIZES[0]]["images"]
    got = again({"image0": _t(a), "image1": _t(b)})
    want = out[SIZES[0]]["full"]["published"]
    for k in ("keypoints0", "keypoints1", "confidence", "valid"):
        assert torch.equal(got[k], want[k])
    bad = dict(sd)
    bad["backbone.conv1.weight"] = bad["backbone.conv1.weight"][:, :, :5]
    with pytest.raises(ValueError):
        t_loftr.load_torch_weights(bad, t_loftr.LoFTRConfig(**CFG))


def test_default_weights_are_seeded_and_frozen():
    a = t_loftr.LoFTR(t_loftr.LoFTRConfig(**CFG), device="cpu")
    b = t_loftr.LoFTR(t_loftr.LoFTRConfig(**CFG), device="cpu")
    assert set(a.params) == set(t_loftr._param_specs(a.cfg))
    for k, v in a.params.items():
        assert not v.requires_grad and torch.equal(v, b.params[k])
