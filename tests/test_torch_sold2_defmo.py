"""The port's SOLD2 and DeFMO (kornia_tpu_torch: feature/sold2.py and
feature/defmo.py whole) against the JAX package on the CPU.

Both nets run the golden families' parameters (the reference's draws from
``PRNGKey(0)``): the port reproduces sold2_heatmaps and defmo (DeFMO with
``tsr_steps=4``) in tests/golden/models_golden.json at
tests/test_golden_models.py's tolerance, and SOLD2 with its matcher
(local-maximum sampling) and SOLD2_detector (bilinear sampling and the
endpoint refinement) run end to end on 1x1x64x64 against the reference. Line verification runs on a
planted-lines heatmap (tests/test_sold2.py's two lines and a diagonal,
blurred, with noise; one junction invalid, one on a line's interior for
the candidate suppression) with both samplings, both heatmap refinement
modes and max_segments 6, then the endpoint refinement. The JAX
references come from four jitted programs compiled side by side with
``FAST_OPTIONS`` (``tests/torch_op_parity.py::compile_parallel``): the two
draws, each ``flax_init_program``'s grouped form of the reference's init
(its values for a fraction of the compile), the line functions and the
nets end to end.

Tolerances: adjacency, segments, masks, junctions and matches equal (the
stable top-k's tie order included); scores 1e-6; refined endpoints 1e-4
px; net outputs within 1e-4 of their largest |entry|.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from kornia_tpu.feature import defmo as j_dm
from kornia_tpu.feature import sold2 as j_s
from kornia_tpu_torch import convert
from kornia_tpu_torch.feature import defmo as t_dm
from kornia_tpu_torch.feature import sold2 as t_s
from tests.golden_builders import _img, probe
from tests.torch_op_parity import (FAST_OPTIONS, compile_parallel,
                                   flax_init_program)
from tests.torch_threads import one_torch_thread  # noqa: F401

_RNG = np.random.default_rng(0)
H, W = 64, 80
_h = np.zeros((H, W), np.float32)
_h[20, 10:51] = 1.0
_h[10:41, 40] = 1.0
for _t in np.linspace(0, 1, 200):
    _h[int(45 + 10 * _t), int(5 + 60 * _t)] = 1.0
HEAT = np.clip(gaussian_filter(_h, 0.7) * 2.5
               + _RNG.uniform(0, 0.05, _h.shape), 0, 1).astype(np.float32)
JUNC = np.array([[20, 10], [20, 50], [10, 40], [40, 40], [45, 5], [55, 65],
                 [20, 30], [5, 5], [60, 70], [30, 60]], np.float32)
VALID = np.ones(10, bool)
VALID[7] = False
MODES = [(s, m) for s in ("local_max", "bilinear") for m in ("global",
                                                              "local")]
# junction probabilities with equal peaks: ties in the top-k
PROB = np.zeros((32, 40), np.float32)
PROB[4:28:6, 5:35:6] = 0.5
PROB[10, 11] = 0.9
IMG = gaussian_filter(_RNG.uniform(0, 1, (1, 1, 64, 64)),
                      (0, 0, 1.5, 1.5)).astype(np.float32)
D1 = _RNG.normal(size=(6, 5, 16)).astype(np.float32)
D2 = np.concatenate([D1[[2, 0, 5]][:, ::-1], _RNG.normal(size=(3, 5, 16))]
                    ).astype(np.float32) + 0.1
V2 = np.array([True, True, True, False, True, True])


@pytest.fixture(scope="module")
def refs():
    def sold2_draw(key):
        return j_s.SOLD2Net().init(key, jnp.zeros((1, 64, 64, 1)))

    def defmo_draw(key):
        return j_dm.DeFMO(tsr_steps=4).model.init(key,
                                                  jnp.zeros((1, 32, 32, 6)))

    def line_refs(heat, junc, valid, prob, d1, d2, v2):
        lines = {}
        for s, m in MODES:
            adj, sc = j_s.detect_line_segments(
                junc, valid, heat, sampling=s, heatmap_refine_mode=m,
                num_samples=16)
            segs, mask = j_s.adjacency_to_segments(junc, adj, sc, 6)
            lines[s + "/" + m] = (adj, sc, segs, mask,
                                  j_s.refine_segments_perturb(
                                      segs, mask, heat, num_samples=16))
        return dict(lines=lines, junctions=j_s.prob_to_junctions(prob, 24),
                    nw=j_s.match_lines_nw(d1, d2, jnp.ones(6, bool), v2))

    def net_refs(img, net_vars):
        full = j_s.SOLD2(max_junctions=16, max_segments=8, num_samples=16,
                         params=net_vars)
        out = full(img)
        # SOLD2_detector(sampling="bilinear")'s steps on the same maps (one
        # trace of the net: tracing it twice costs 3 s)
        junc, valid = j_s.prob_to_junctions(out["junction_heatmap"][0], 16)
        heat = out["line_heatmap"][0]
        adj, score = j_s.detect_line_segments(junc, valid, heat, 0.5, 16,
                                              0.99, sampling="bilinear")
        segs, mask = j_s.adjacency_to_segments(junc, adj, score, 8)
        return dict(full=out, match=full.match(out, out),
                    det=(j_s.refine_segments_perturb(segs, mask, heat)[None],
                         mask[None]))

    key = jax.random.PRNGKey(0)
    s_fn, s_args, s_finish, s_avals = flax_init_program(sold2_draw, key)
    d_fn, d_args, d_finish, _ = flax_init_program(defmo_draw, key)
    l_args = [jnp.asarray(a) for a in (HEAT, JUNC, VALID, PROB, D1, D2, V2)]
    img = jnp.asarray(IMG)
    sd, dd, lr, nr = compile_parallel([
        (s_fn, s_args), (d_fn, d_args), (line_refs, l_args),
        (net_refs, [img, s_avals])], FAST_OPTIONS)
    net_vars = s_finish(sd(*s_args))
    out = dict(net_vars=net_vars, dm_vars=d_finish(dd(*d_args)),
               **lr(*l_args), **nr(img, net_vars))
    return jax.tree_util.tree_map(np.asarray, out)


def _t(a):
    return torch.from_numpy(np.array(a))


def _golden(family, got):
    with open(os.path.join(os.path.dirname(__file__), "golden",
                           "models_golden.json")) as f:
        expect = json.load(f)[family]
    got = probe(got)
    assert got["size"] == expect["size"]
    tol = 1e-4 * max(abs(expect["absmax"]), 1e-3)
    assert abs(got["mean"] - expect["mean"]) < tol
    assert abs(got["std"] - expect["std"]) < tol
    np.testing.assert_allclose(got["values"], expect["values"], atol=10 * tol)


def test_sold2_net_reproduces_golden_family(refs):
    det = convert.sold2_from_numpy(refs["net_vars"], "cpu",
                                   cls=t_s.SOLD2_detector)
    out = det.net(_t(_img((1, 1, 64, 64))))
    _golden("sold2_heatmaps", np.concatenate(
        [out["junctions"].numpy().ravel(), out["heatmap"].numpy().ravel()]))


def test_defmo_reproduces_golden_family(refs):
    m = convert.defmo_from_numpy(refs["dm_vars"], 4, "cpu")
    out = m(_t(_img((1, 6, 32, 32))))
    assert out.shape == (1, 4, 4, 32, 32)
    _golden("defmo", out.numpy())


@pytest.mark.parametrize("mode", ["/".join(m) for m in MODES])
def test_line_verification_matches_reference(refs, mode):
    sampling, refine = mode.split("/")
    adj, sc = t_s.detect_line_segments(
        _t(JUNC), _t(VALID), _t(HEAT), sampling=sampling,
        heatmap_refine_mode=refine, num_samples=16)
    segs, mask = t_s.adjacency_to_segments(_t(JUNC), adj, sc, 6)
    moved = t_s.refine_segments_perturb(segs, mask, _t(HEAT),
                                        num_samples=16)
    w_adj, w_sc, w_segs, w_mask, w_moved = refs["lines"][mode]
    np.testing.assert_array_equal(adj.numpy(), w_adj)
    np.testing.assert_allclose(sc.numpy(), w_sc, atol=1e-6)
    np.testing.assert_array_equal(segs.numpy(), w_segs)
    np.testing.assert_array_equal(mask.numpy(), w_mask)
    np.testing.assert_allclose(moved.numpy(), w_moved, atol=1e-4)
    # the three planted lines, the horizontal one split at junction 6, and
    # nothing through the invalid junction 7
    assert w_mask.sum() == 4 and not w_adj[7].any() and not w_adj[0, 1]


def test_prob_to_junctions_tie_order_matches_reference(refs):
    junc, valid = t_s.prob_to_junctions(_t(PROB), 24)
    np.testing.assert_array_equal(junc.numpy(), refs["junctions"][0])
    np.testing.assert_array_equal(valid.numpy(), refs["junctions"][1])


def test_sold2_detector_matches_reference(refs):
    """Bilinear sampling and the endpoint refinement (the local maximum
    without refinement is SOLD2's own path, below)."""
    det = convert.sold2_from_numpy(
        refs["net_vars"], "cpu", cls=t_s.SOLD2_detector, max_junctions=16,
        max_segments=8, num_samples=16, sampling="bilinear")
    out = det(_t(IMG))
    want = refs["full"]
    for k in ("junction_heatmap", "line_heatmap"):
        np.testing.assert_allclose(out[k].numpy(), want[k], rtol=0,
                                   atol=1e-4 * np.abs(want[k]).max())
    np.testing.assert_array_equal(out["line_mask"].numpy(), refs["det"][1])
    np.testing.assert_allclose(out["line_segments"].numpy(), refs["det"][0],
                               atol=1e-4)


def test_sold2_and_match_match_reference(refs):
    m = convert.sold2_from_numpy(refs["net_vars"], "cpu", max_junctions=16,
                                 max_segments=8, num_samples=16)
    out = m(_t(IMG))
    want = refs["full"]
    np.testing.assert_array_equal(out["line_segments"].numpy(),
                                  want["line_segments"])
    np.testing.assert_array_equal(out["line_mask"].numpy(),
                                  want["line_mask"])
    dd = want["dense_desc"]
    np.testing.assert_allclose(out["dense_desc"].numpy(), dd, rtol=0,
                               atol=1e-4 * np.abs(dd).max())
    np.testing.assert_array_equal(m.match(out, out).numpy(), refs["match"])


def test_needleman_wunsch_matches_reference(refs):
    """Lines 0-2 of the second set are lines 2, 0, 5 of the first,
    reversed: they match across the direction flip."""
    got = t_s.match_lines_nw(_t(D1), _t(D2), torch.ones(6, dtype=torch.bool),
                             _t(V2))
    np.testing.assert_array_equal(got.numpy(), refs["nw"])
    assert got[2] == 0 and got[0] == 1 and got[5] == 2


def test_loaders_and_seeded_nets(refs):
    """The checkpoint names load back; the seeded twins of the flax modules
    run with their own parameters, all frozen."""
    sd = convert.sold2_from_numpy(refs["net_vars"], "cpu").net.state_dict()
    assert "backbone_net.net.hg.1.hg.3.2.0.conv2.weight" in sd
    assert len(t_s.load_torch_weights(sd)) == len(sd)
    enc = t_dm.EncoderDeFMO(device="cpu")
    ren = t_dm.RenderingDeFMO(2, device="cpu")
    lat = enc(torch.zeros(1, 6, 32, 32))
    assert lat.shape == (1, 2048, 2, 2)
    assert ren(lat).shape == (1, 2, 4, 32, 32)
    dm_sd = t_dm.DeFMO(2, device="cpu").state_dict()
    assert len(t_dm.load_torch_weights(dm_sd)) == len(dm_sd)
    assert "encoder.net.1.3.0.downsample.1.running_var" in dm_sd
    assert not any(p.requires_grad for p in enc.parameters())
    with pytest.raises(ValueError):
        t_dm.DeFMO(2, device="cpu")(torch.zeros(1, 3, 32, 32))
