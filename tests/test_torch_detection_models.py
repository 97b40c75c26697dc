"""The port's detection and dense-prediction models (kornia_tpu_torch:
models/{common,rt_detr,yunet,dexined,rrdbnet,small_sr,depth_anything}.py)
against the JAX package on the CPU.

Golden route: the six families' golden builders (tests/golden_builders.py)
drawn from the reference's ``PRNGKey(0)``, carried across by
``convert.*_from_numpy`` and run by the port, reproduce
tests/golden/models_golden.json at tests/test_golden_models.py's
tolerance. The flat-dict inits (RT-DETR, YuNet, DexiNed, RRDBNet) are the
JAX package's own init functions run on the host with ``jax.random``
replayed in numpy (``tests/torch_op_parity.py::numpy_random``, held to
``jax.random`` here); SmallSR's and Depth Anything's flax inits go through
``flax_init_program``. No JAX forward of a golden family compiles.

Live parity: RT-DETR on an HGNetv2 config of light and plain stages and on
a bottleneck ResNet-D, the query selection and the post-processor on
planted ties and in the head itself, the anchors; YuNet's priors and
decode; RRDBNet at scale 2 (the pixel-unshuffle path), its draw with
basicsr's 0.1 scale undone so that its output is O(1)
(``tests/torch_unit_scale.py``); the UNet segmentor at a size whose pools
floor (the upsamplings are not 2x); Depth Anything "tiny" on a patch grid
other than its position table's; common.py's blocks. The JAX references
come from three programs compiled side by side with FAST_OPTIONS, the two
golden flax draws beside them.

Depth Anything's bicubic branch: the JAX module's flax ``param`` refuses a
position table of another size than the grid's (ScopeParamShapeError),
so the JAX side cannot take that branch; its reference is the branch's own
expression, ``jax.image.resize(table, grid, "bicubic")``, and the JAX net
run on the resized table, against the port given the original table.

Tolerances: net outputs within 1e-4 of their largest |entry| (flax's
LayerNorm takes the variance as E[x²] - E[x]², torch's in two passes:
3.5e-5 apart over six channels); the selected query indices and the post-processor's
rows equal, ties resolved as ``lax.top_k`` (the lower index first).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from kornia_tpu.models import common as j_cm
from kornia_tpu.models import depth_anything as j_da
from kornia_tpu.models import dexined as j_dx
from kornia_tpu.models import rrdbnet as j_rr
from kornia_tpu.models import rt_detr as j_rt
from kornia_tpu.models import small_sr as j_sr
from kornia_tpu.models import yunet as j_yu
from kornia_tpu_torch import convert
from kornia_tpu_torch.core.sort import top_k
from kornia_tpu_torch.feature import _nets
from kornia_tpu_torch.models import common as t_cm
from kornia_tpu_torch.models import depth_anything as t_da
from kornia_tpu_torch.models import rrdbnet as t_rr
from kornia_tpu_torch.models import rt_detr as t_rt
from kornia_tpu_torch.models import small_sr as t_sr
from kornia_tpu_torch.models import yunet as t_yu
from tests.golden_builders import _img, probe
from tests.torch_op_parity import (FAST_OPTIONS, compile_parallel,
                                   flax_init_program, flax_variables,
                                   numpy_random)
from tests.torch_threads import one_torch_thread  # noqa: F401
from tests.torch_unit_scale import rrdbnet_unit_scale

_GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                       "models_golden.json")
_RNG = np.random.default_rng(0)


def _smooth(shape, sigma=1.5):
    return gaussian_filter(_RNG.uniform(0, 1, shape),
                           (0,) * (len(shape) - 2) + (sigma, sigma)
                           ).astype(np.float32)


def _np_key(seed):
    return np.asarray(jax.random.PRNGKey(seed))


IMG = _smooth((1, 3, 64, 64))
IMG2 = _smooth((2, 3, 64, 64))
SR_IMG = _smooth((1, 3, 16, 16))
UNET_IMG = _smooth((1, 3, 22, 30))
DA_IMG = _smooth((1, 3, 32, 64))      # 4x8 grid; the table is 6x6

HG_STAGES = (j_rt.HGNetStageConfig(16, 16, 32, 1, False, False, 3, 2),
             j_rt.HGNetStageConfig(32, 16, 48, 1, True, False, 3, 2),
             j_rt.HGNetStageConfig(48, 24, 64, 2, True, True, 5, 2),
             j_rt.HGNetStageConfig(64, 32, 96, 1, True, True, 5, 2))
_SMALL = dict(num_classes=10, neck_hidden_dim=32, neck_dim_feedforward=64,
              head_hidden_dim=32, head_num_queries=20,
              head_num_decoder_layers=2, head_num_heads=4)


def _rt_cfgs(mod):
    hg = tuple(mod.HGNetStageConfig(*dataclasses.astuple(s))
               for s in HG_STAGES)
    return {"hgnet": mod.RTDETRConfig("hgnetv2_l", hgnet_stem=[3, 8, 16],
                                      hgnet_stages=hg, **_SMALL),
            "bottleneck": mod.RTDETRConfig(resnet_n_blocks=[1, 1, 1, 1],
                                           resnet_bottleneck=True, **_SMALL)}


RRDB = dict(num_feat=8, num_block=2, num_grow_ch=4, scale=2)
DA_TINY = dict(patch_size=8, hidden_size=64, num_layers=4, num_heads=4,
               out_indices=(0, 1, 2, 3), reassemble_channels=(16, 24, 32, 48),
               fusion_channels=16)
DA_GOLDEN = dict(hidden_size=32, num_layers=4, num_heads=2,
                 out_indices=(0, 1, 2, 3), reassemble_channels=(8, 8, 8, 8),
                 fusion_channels=8)
# planted ties: equal class maxima among the encoder's rows, equal scores
# across queries and classes
_L = _RNG.normal(0, 1, (2, 30, 6)).astype(np.float32)
_L[:, 3:9, 2] = 4.0
_L[0, 20:25, :] = 4.0
TIE_LOGITS = _L
TIE_BOXES = _RNG.uniform(0.1, 0.9, (2, 30, 4)).astype(np.float32)


def _flat_init(init, seed, *args):
    with numpy_random():
        p = init(_np_key(seed), *args)
    return {k: np.asarray(v, np.float32) for k, v in p.items()}


def _attn_vars(rng, d, heads):
    hd = d // heads

    def dense(*shape):
        return rng.normal(0, 1 / np.sqrt(d), shape).astype(np.float32)

    mha = {p: {"kernel": dense(d, heads, hd), "bias": dense(heads, hd)}
           for p in ("query", "key", "value")}
    mha["out"] = {"kernel": dense(heads, hd, d), "bias": dense(d)}
    return mha


def _encoder_layer_vars(d, heads, with_context):
    rng = np.random.default_rng(7 + with_context)
    tree = flax_variables(t_cm.TransformerEncoderLayer(
        d, heads, device="cpu")._rows(with_context), 5)
    tree["params"]["MultiHeadDotProductAttention_0"] = _attn_vars(rng, d,
                                                                  heads)
    return tree


def _common_cases():
    """name → (JAX module, port module, input (NCHW or rows), context)."""
    x = _smooth((2, 6, 9, 11))
    rows = _RNG.normal(0, 1, (2, 7, 16)).astype(np.float32)
    ctx = _RNG.normal(0, 1, (2, 5, 16)).astype(np.float32)
    return {
        "cna_bn": (j_cm.ConvNormAct(8, 3, stride=2),
                   t_cm.ConvNormAct(8, 3, stride=2, device="cpu"), x, None),
        "cna_ln_grouped": (j_cm.ConvNormAct(6, 3, groups=3, act=None,
                                            norm="ln"),
                           t_cm.ConvNormAct(6, 3, groups=3, act=None,
                                            norm="ln", device="cpu"), x,
                           None),
        "cna_even_bias": (j_cm.ConvNormAct(4, 2, stride=2, norm="none"),
                          t_cm.ConvNormAct(4, 2, stride=2, norm="none",
                                           device="cpu"), x, None),
        "layernorm2d": (j_cm.LayerNorm2d(), t_cm.LayerNorm2d(device="cpu"),
                        x, None),
        "mlp": (j_cm.MLP(12, 5, num_layers=3),
                t_cm.MLP(12, 5, num_layers=3, device="cpu"), rows, None),
        "encoder": (j_cm.TransformerEncoderLayer(16, 4),
                    t_cm.TransformerEncoderLayer(16, 4, device="cpu"), rows,
                    None),
        "encoder_ctx": (j_cm.TransformerEncoderLayer(16, 4),
                        t_cm.TransformerEncoderLayer(16, 4, device="cpu"),
                        rows, ctx),
    }


COMMON = _common_cases()


def _common_vars(name, tmod, x, ctx):
    if name.startswith("encoder"):
        return _encoder_layer_vars(16, 4, ctx is not None)
    width = x.shape[-1] if name == "mlp" else x.shape[1]
    return flax_variables(tmod._rows(width), 11)


COMMON_VARS = {k: _common_vars(k, v[1], v[2], v[3])
               for k, v in COMMON.items()}


@pytest.fixture(scope="module")
def draws():
    cfgs = _rt_cfgs(j_rt)
    out = {name: _flat_init(j_rt.rtdetr_init_params, 1 + i, cfg)
           for i, (name, cfg) in enumerate(cfgs.items())}
    out["rrdb"] = rrdbnet_unit_scale(_flat_init(j_rr.init_params, 3,
                                                j_rr.RRDBNetConfig(**RRDB)))
    out["unet"] = flax_variables(t_sr._UNetModule(5, device="cpu")._rows(3),
                                 4)
    out["da"] = flax_variables(t_da._param_rows(
        t_da.DepthAnythingConfig(**DA_TINY), 36), 5)
    return out


@pytest.fixture(scope="module")
def refs(draws):
    cfgs = _rt_cfgs(j_rt)

    def rtdetr_refs(img, p_hg, p_bn, logits, boxes):
        post = j_rt.DETRPostProcessor(0.3, 6, 25)
        enc = jnp.asarray(logits)
        return dict(
            hgnet=j_rt.rtdetr_forward(p_hg, cfgs["hgnet"], img),
            bottleneck=j_rt.rtdetr_forward(p_bn, cfgs["bottleneck"], img),
            post=post(logits, boxes, [(48, 80), (64, 64)]),
            post_all=j_rt.DETRPostProcessor(None, 6, 200)(
                logits, boxes, [(48, 80)] * 2),
            queries=jax.lax.top_k(jnp.max(enc, -1), 12)[1],
            anchors=j_rt._generate_anchors([(8, 8), (4, 4), (2, 2), (3, 5)],
                                           jnp.float32))

    def dense_refs(sr, unet_img, da_img, p_rr, unet_vars, da_vars, loc,
                   common_in, common_ctx, common_vars):
        da = j_da.DepthAnythingNet(j_da.DepthAnythingConfig(**DA_TINY))
        g, D = 6, DA_TINY["hidden_size"]
        h, w = da_img.shape[2] // 8, da_img.shape[3] // 8
        pos = jax.image.resize(da_vars["params"]["pos_embed"].reshape(
            g, g, D), (h, w, D), "bicubic").reshape(h * w, D)
        resized = {"params": dict(da_vars["params"], pos_embed=pos)}
        priors = j_yu.prior_boxes((120, 160))
        common = {}
        for name, (jm, _, _, _) in COMMON.items():
            xin = common_in[name]
            if xin.ndim == 4:
                xin = jnp.transpose(xin, (0, 2, 3, 1))
            args = (xin,) if common_ctx[name] is None else (
                xin, common_ctx[name])
            y = jm.apply(common_vars[name], *args)
            common[name] = jnp.transpose(y, (0, 3, 1, 2)) if y.ndim == 4 \
                else y
        return dict(
            rrdb=j_rr.forward(p_rr, j_rr.RRDBNetConfig(**RRDB), sr),
            unet=jnp.transpose(j_sr._UNetModule(5).apply(
                unet_vars, jnp.transpose(unet_img, (0, 2, 3, 1))),
                (0, 3, 1, 2)),
            pos=pos, depth=da.apply(resized, jnp.transpose(da_img,
                                                           (0, 2, 3, 1))),
            decode=j_yu.decode(loc, priors), common=common)

    key = jax.random.PRNGKey(0)
    sr_fn, sr_args, sr_finish, _ = flax_init_program(
        lambda k: j_sr._SmallSRModule(scale=2).init(
            k, jnp.zeros((1, 16, 16, 3))), key)
    da_fn, da_args, da_finish, _ = flax_init_program(
        lambda k: j_da.DepthAnythingNet(
            j_da.DepthAnythingConfig(**DA_GOLDEN)).init(
                k, jnp.zeros((1, 56, 56, 3))), key)
    rt_args = [jnp.asarray(IMG2), draws["hgnet"], draws["bottleneck"],
               jnp.asarray(TIE_LOGITS), jnp.asarray(TIE_BOXES)]
    n_priors = t_yu.prior_boxes((120, 160), device="cpu").shape[0]
    loc = _RNG.normal(0, 1, (2, n_priors, 14)).astype(np.float32)
    d_args = [jnp.asarray(a) for a in (SR_IMG, UNET_IMG, DA_IMG)] + [
        draws["rrdb"], draws["unet"], draws["da"], jnp.asarray(loc),
        {k: jnp.asarray(v[2]) for k, v in COMMON.items()},
        {k: None if v[3] is None else jnp.asarray(v[3])
         for k, v in COMMON.items()}, COMMON_VARS]
    srd, dad, rtr, dr = compile_parallel([
        (sr_fn, sr_args), (da_fn, da_args), (rtdetr_refs, rt_args),
        (dense_refs, d_args)], FAST_OPTIONS)
    out = dict(sr_golden=sr_finish(srd(*sr_args)),
               da_golden=da_finish(dad(*da_args)), loc=loc,
               **rtr(*rt_args), **dr(*d_args))
    return jax.tree_util.tree_map(np.asarray, out)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want, rtol=1e-4):
    """got within rtol of the largest |want| (each output at its own
    scale)."""
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = float(np.abs(want).max())
    assert scale > 0, "an all-zero reference holds nothing"
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def _golden(family, out):
    with open(_GOLDEN) as f:
        expect = json.load(f)[family]
    got = probe(np.asarray(out))
    assert got["size"] == expect["size"], (got["size"], expect["size"])
    tol = 1e-4 * max(abs(expect["absmax"]), 1e-3)
    assert abs(got["mean"] - expect["mean"]) < tol, family
    assert abs(got["std"] - expect["std"]) < tol, family
    np.testing.assert_allclose(got["values"], expect["values"], atol=10 * tol,
                               err_msg=family)


def test_numpy_random_replays_jax_random():
    numpy_random.check()


def _golden_out(family, refs):
    if family == "rt_detr":
        cfg = j_rt.RTDETRConfig()
        m = convert.rtdetr_from_numpy(_flat_init(j_rt.rtdetr_init_params, 0,
                                                 cfg), t_rt.RTDETRConfig(),
                                      "cpu")
        logits, boxes = m(_t(_img((1, 3, 64, 64))))
        return np.concatenate([logits.numpy().ravel(), boxes.numpy().ravel()])
    if family == "yunet":
        m = convert.yunet_from_numpy(_flat_init(j_yu.yunet_init_params, 0),
                                     "cpu")
        out = m(_t(_img((1, 3, 64, 64))))
        return np.concatenate([v.numpy().ravel() for v in out.values()])
    if family == "dexined":
        m = convert.dexined_from_numpy(_flat_init(j_dx.dexined_init_params,
                                                  0), "cpu")
        return m(_t(_img((1, 3, 64, 64)))).numpy()
    if family == "rrdbnet":
        kw = dict(num_feat=8, num_block=1, num_grow_ch=4)
        m = convert.rrdbnet_from_numpy(
            _flat_init(j_rr.init_params, 0, j_rr.RRDBNetConfig(**kw)),
            t_rr.RRDBNetConfig(**kw), "cpu")
        return m(_t(_img((1, 3, 16, 16)))).numpy()
    if family == "small_sr":
        m = convert.small_sr_from_numpy(refs["sr_golden"], 2, "cpu")
        return m(_t(_img((1, 3, 16, 16)))).numpy()
    m = convert.depth_anything_from_numpy(
        refs["da_golden"], t_da.DepthAnythingConfig(**DA_GOLDEN), "cpu")
    return m(_t(_img((1, 3, 56, 56)))).numpy()


@pytest.mark.parametrize("family", ["rt_detr", "yunet", "dexined", "rrdbnet",
                                    "small_sr", "depth_anything"])
def test_golden_family(family, refs):
    with torch.inference_mode():
        _golden(family, _golden_out(family, refs))


@pytest.mark.parametrize("name", ["hgnet", "bottleneck"])
def test_rtdetr_backbones(name, draws, refs):
    cfg = _rt_cfgs(t_rt)[name]
    m = convert.rtdetr_from_numpy(draws[name], cfg, "cpu")
    with torch.inference_mode():
        logits, boxes = m(_t(IMG2))
    _close(logits, refs[name][0])
    _close(boxes, refs[name][1])


def test_rtdetr_param_table_round_trip(draws):
    """load_torch_weights and from_torch take the state dict back."""
    cfg = _rt_cfgs(t_rt)["hgnet"]
    m = convert.rtdetr_from_numpy(draws["hgnet"], cfg, "cpu")
    sd = {k: v.clone() for k, v in m.params.items()}
    m2 = t_rt.RTDETR.from_torch(sd, cfg, device="cpu")
    assert all(torch.equal(m2.params[k], v) for k, v in sd.items())
    with pytest.raises(ValueError, match="shape"):
        bad = dict(sd)
        bad["decoder.enc_score_head.weight"] = torch.zeros(3, 3)
        t_rt.load_torch_weights(bad, cfg)


def test_query_selection_takes_the_lower_index_among_ties(draws, refs):
    """The head's rule (the stable top-k of the class maxima) on planted
    ties against ``lax.top_k``; then in the head itself, whose score head
    with zero weights ties every row: the first indices are selected."""
    got = top_k(_t(TIE_LOGITS).max(-1).values, 12)[1]
    np.testing.assert_array_equal(got.numpy(), refs["queries"])
    cfg = _rt_cfgs(t_rt)["bottleneck"]
    p = convert.rtdetr_from_numpy(draws["bottleneck"], cfg, "cpu").params
    p["decoder.enc_score_head.weight"] = torch.zeros_like(
        p["decoder.enc_score_head.weight"])
    with torch.inference_mode():
        _, _, enc_max, sel = t_rt._forward(p, cfg, _t(IMG2))
    assert bool((enc_max == enc_max[:, :1]).all())
    np.testing.assert_array_equal(
        sel.numpy(), np.broadcast_to(np.arange(sel.shape[1]), sel.shape))


@pytest.mark.parametrize("which", ["post", "post_all"])
def test_post_processor_rows(which, refs):
    post = t_rt.DETRPostProcessor(0.3, 6, 25) if which == "post" else \
        t_rt.DETRPostProcessor(None, 6, 200)
    sizes = [(48, 80), (64, 64)] if which == "post" else [(48, 80)] * 2
    got = post(_t(TIE_LOGITS), _t(TIE_BOXES), sizes)
    want = refs[which]
    np.testing.assert_array_equal(got[..., 0].numpy(), want[..., 0])
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_generate_anchors(refs):
    a, v = t_rt._generate_anchors([(8, 8), (4, 4), (2, 2), (3, 5)], "cpu")
    np.testing.assert_array_equal(v.numpy(), refs["anchors"][1])
    np.testing.assert_allclose(a.numpy(), refs["anchors"][0], rtol=0,
                               atol=1e-6)


def test_yunet_priors_and_decode(refs):
    for size in ((120, 160), (97, 131)):
        for clip in (False, True):
            np.testing.assert_array_equal(
                t_yu.prior_boxes(size, clip=clip, device="cpu").numpy(),
                np.asarray(j_yu.prior_boxes(size, clip=clip)))
    got = t_yu.decode(_t(refs["loc"]), t_yu.prior_boxes((120, 160),
                                                        device="cpu"))
    _close(got, refs["decode"], 1e-6)


def test_rrdbnet_scale2(draws, refs):
    m = convert.rrdbnet_from_numpy(draws["rrdb"], t_rr.RRDBNetConfig(**RRDB),
                                   "cpu")
    with torch.inference_mode():
        _close(m(_t(SR_IMG)), refs["rrdb"])
    np.testing.assert_array_equal(
        t_rr._pixel_unshuffle(_t(IMG), 2).numpy(),
        np.transpose(np.asarray(j_rr._pixel_unshuffle(
            jnp.transpose(IMG, (0, 2, 3, 1)), 2)), (0, 3, 1, 2)))


def test_rrdbnet_presets():
    for name in ("RealESRGAN_x4plus", "RealESRNet_x4plus",
                 "RealESRGAN_x4plus_anime_6B", "RealESRGAN_x2plus"):
        assert t_rr.RRDBNetConfig.from_name(name) == \
            t_rr.RRDBNetConfig(**vars(j_rr.RRDBNetConfig.from_name(name)))
    with pytest.raises(ValueError, match="not found"):
        t_rr.RRDBNetConfig.from_name("x3")


def test_unet_segmentor(draws, refs):
    m = convert.unet_segmentor_from_numpy(draws["unet"], 5, "cpu")
    with torch.inference_mode():
        _close(m(_t(UNET_IMG)), refs["unet"])


def test_depth_anything_resizes_its_position_table(draws, refs):
    m = convert.depth_anything_from_numpy(
        draws["da"], t_da.DepthAnythingConfig(**DA_TINY), "cpu")
    with torch.inference_mode():
        _close(m(_t(DA_IMG))[:, 0], refs["depth"])
        pos = m.model._pos_table(m.params["pretrained.pos_embed"], 4, 8)
        _close(pos, refs["pos"], 1e-5)


def test_depth_anything_loader_folds_layerscale(draws):
    """The official layout (LayerScale, the class token's position slot)
    folds into the port's parameters."""
    cfg = t_da.DepthAnythingConfig(**DA_TINY)
    p = _nets.from_flax(t_da._param_rows(cfg, 36), draws["da"])
    rng = np.random.default_rng(9)
    sd = {k: v for k, v in p.items()}
    pos_cls = rng.normal(0, 0.02, (1, 1, 64)).astype(np.float32)
    sd["pretrained.pos_embed"] = np.concatenate(
        [pos_cls, p["pretrained.pos_embed"][None]], 1)
    sd["pretrained.cls_token"] = p["pretrained.cls_token"] - pos_cls
    for i in range(4):
        for ls, lin in (("ls1", "attn.proj"), ("ls2", "mlp.fc2")):
            g = rng.uniform(0.5, 1.5, 64).astype(np.float32)
            b = f"pretrained.blocks.{i}"
            sd[f"{b}.{ls}.gamma"] = g
            sd[f"{b}.{lin}.weight"] = p[f"{b}.{lin}.weight"] / g[:, None]
            sd[f"{b}.{lin}.bias"] = p[f"{b}.{lin}.bias"] / g
    got = t_da.load_torch_weights(sd, cfg)
    for k, v in p.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("name", sorted(COMMON))
def test_common_blocks(name, refs):
    _, tm, x, ctx = COMMON[name]
    width = x.shape[-1] if name == "mlp" else x.shape[1]
    if name.startswith("encoder"):
        width = ctx is not None
    tm.load_params(_nets.from_flax(tm._rows(width), COMMON_VARS[name]))
    with torch.inference_mode():
        got = tm(_t(x)) if ctx is None else tm(_t(x), _t(ctx))
    _close(got, refs["common"][name])


def test_drop_path():
    x = torch.ones(64, 3, 4)
    assert t_cm.DropPath(0.5)(x) is x
    g = torch.Generator().manual_seed(0)
    y = t_cm.DropPath(0.25, deterministic=False)(x, g)
    kept = y[:, 0, 0] != 0
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.75))
    assert 0 < int(kept.sum()) < 64
