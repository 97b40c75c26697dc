"""The port's losses and metrics against the JAX package on the CPU:
``losses/{losses,mutual_information}.py`` and ``metrics/metrics.py``.

Each module's JAX references come from one jitted program
(``batch_references``), except ``mean_average_precision``, whose
reference reads class counts and matches on the host and so runs eagerly.
Tolerances: 1e-5 absolute by default (1e-5 relative for sums over many
pixels); 1e-4 for the mutual-information losses (entropies of a 64x64
joint histogram); 0 for one-hot labels, counts, confusion matrices and
the accuracy. Gradients within 1e-4 of the largest.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kornia_tpu.losses as jlosses
import kornia_tpu.losses.losses as jl
import kornia_tpu.losses.mutual_information as jmi
import kornia_tpu.metrics as jmetrics
import kornia_tpu.metrics.metrics as jm
import kornia_tpu_torch.losses as tlosses
import kornia_tpu_torch.losses.losses as tl
import kornia_tpu_torch.losses.mutual_information as tmi
import kornia_tpu_torch.metrics as tmetrics
import kornia_tpu_torch.metrics.metrics as tm
from tests.torch_op_parity import Case, batch_references, rand, run_case
from tests.torch_threads import one_torch_thread  # noqa: F401

RNG = np.random.default_rng(0)
IMG_A = rand(2, 3, 16, 16, seed=1)
IMG_B = np.clip(IMG_A + 0.2 * rand(2, 3, 16, 16, lo=-1.0, seed=2), 0, 1)
MS_A = rand(1, 2, 64, 64, seed=3)
MS_B = np.clip(MS_A + 0.3 * rand(1, 2, 64, 64, lo=-1.0, seed=4), 0, 1)
VOL_A = rand(1, 2, 6, 12, 12, seed=5)
VOL_B = np.clip(VOL_A + 0.2 * rand(1, 2, 6, 12, 12, lo=-1.0, seed=6), 0, 1)
LOGITS = rand(2, 4, 8, 8, lo=-3.0, hi=3.0, seed=7)
LABELS = RNG.integers(0, 4, (2, 8, 8)).astype(np.int32)
LABELS_OUT = LABELS.copy()
LABELS_OUT[0, 0, :3] = 4  # outside [0, C): a zero row in both one-hots
BIN_LOGITS = rand(2, 1, 8, 8, lo=-3.0, hi=3.0, seed=8)
BIN_MASK = (rand(2, 8, 8, seed=9) > 0.5).astype(np.float32)
# tied errors: the sort's order of equal keys decides the Lovász gradient
TIED = np.round(BIN_LOGITS * 2) / 2
CLASS_W = np.array([0.5, 1.0, 2.0, 1.5], np.float32)
DIST_P = np.exp(LOGITS[:, :2]) / np.exp(LOGITS[:, :2]).sum((-2, -1),
                                                             keepdims=True)
DIST_Q = np.exp(LOGITS[:, 2:]) / np.exp(LOGITS[:, 2:]).sum((-2, -1),
                                                             keepdims=True)
IDEPTH = rand(2, 1, 8, 8, seed=10)
HAUS_LOGITS = rand(1, 3, 12, 12, lo=-3.0, hi=3.0, seed=11)
HAUS_LABELS = RNG.integers(0, 3, (1, 12, 12)).astype(np.int32)

LOSSES = {
    "one_hot": Case("one_hot", (LABELS_OUT, 4), atol=0),
    "ssim3d": Case("ssim3d", (VOL_A, VOL_B, 5)),
    "ssim3d_loss": Case("ssim3d_loss", (VOL_A, VOL_B, 5)),
    "ms_ssim_loss": Case("ms_ssim_loss", (MS_A, MS_B)),
    "ms_ssim_loss_none": Case("ms_ssim_loss", (MS_A, MS_B, None, 7, "none")),
    "total_variation": Case("total_variation", (IMG_A,), rtol=1e-5),
    "total_variation_mean": Case("total_variation", (IMG_A, "mean")),
    "inverse_depth_smoothness_loss": Case("inverse_depth_smoothness_loss",
                                          (IDEPTH, IMG_A[..., :8, :8])),
    "focal_loss": Case("focal_loss", (LOGITS, LABELS)),
    "focal_loss_mean_weight": Case("focal_loss", (LOGITS, LABELS, 0.25, 1.5,
                                                  "mean", CLASS_W)),
    "binary_focal_loss_with_logits": Case(
        "binary_focal_loss_with_logits", (BIN_LOGITS, BIN_MASK[:, None])),
    "binary_focal_sum_pos_weight": Case(
        "binary_focal_loss_with_logits",
        (BIN_LOGITS, BIN_MASK[:, None], 0.3, 2.0, "sum",
         np.array(2.0, np.float32)), rtol=1e-5),
    "dice_loss": Case("dice_loss", (LOGITS, LABELS)),
    "dice_loss_macro": Case("dice_loss", (LOGITS, LABELS, "macro")),
    "tversky_loss": Case("tversky_loss", (LOGITS, LABELS, 0.3, 0.7)),
    "lovasz_hinge_loss": Case("lovasz_hinge_loss", (BIN_LOGITS, BIN_MASK)),
    "lovasz_hinge_loss_ties": Case("lovasz_hinge_loss", (TIED, BIN_MASK)),
    "lovasz_softmax_loss": Case("lovasz_softmax_loss", (LOGITS, LABELS)),
    "kl_div_loss_2d": Case("kl_div_loss_2d", (DIST_P, DIST_Q)),
    "js_div_loss_2d": Case("js_div_loss_2d", (DIST_P, DIST_Q, "none")),
    "hausdorff_distance_loss": Case("hausdorff_distance_loss",
                                    (HAUS_LOGITS, HAUS_LABELS), rtol=1e-5),
    "hausdorff_distance_loss_k3": Case("hausdorff_distance_loss",
                                       (HAUS_LOGITS, HAUS_LABELS, 3.0,
                                        "none"), rtol=1e-5),
}

SIG_X = rand(2, 300, seed=12)
SIG_Y = (SIG_X ** 2 + 0.1 * rand(2, 300, seed=13)).astype(np.float32)
IM_X = rand(2, 12, 12, seed=14)
IM_Y = np.sqrt(IM_X) + 0.05 * rand(2, 12, 12, seed=15)
VOL_X = rand(2, 3, 6, 6, seed=16)
VOL_Y = (1 - VOL_X) * 0.9
MASK = (rand(300, seed=17) > 0.3).astype(np.float32)
MASK2 = (rand(12, 12, seed=18) > 0.3).astype(np.float32)
KERNEL_X = rand(50, lo=-1.5, hi=1.5, seed=19)


def _from_ref(name):
    def call(mod, ref, other, mask):
        return getattr(mod, name)(ref, mask)(other)
    return lambda mod: lambda ref, other, mask: call(mod, ref, other, mask)


MI = {
    "xu_kernel": Case("xu_kernel", (KERNEL_X, 1.2)),
    "rectangular_kernel": Case("rectangular_kernel", (KERNEL_X,)),
    "truncated_gaussian_kernel": Case("truncated_gaussian_kernel",
                                      (KERNEL_X, 0.8)),
    "mutual_information_loss": Case("mutual_information_loss",
                                    (SIG_X, SIG_Y), atol=1e-4),
    "mutual_information_loss_masked": Case(
        "mutual_information_loss", (SIG_X, SIG_Y, MASK, None), atol=1e-4),
    "normalized_mutual_information_loss": Case(
        "normalized_mutual_information_loss",
        (SIG_X, SIG_Y, None, MASK, jmi.MIKernel.rectangular, 32),
        atol=1e-4),
    "mutual_information_loss_2d": Case(
        "mutual_information_loss_2d",
        (IM_X, IM_Y, MASK2, MASK2, jmi.MIKernel.truncated_gaussian, 16,
         1.5), atol=1e-4),
    "mutual_information_loss_3d": Case("mutual_information_loss_3d",
                                       (VOL_X, VOL_Y), atol=1e-4),
    "normalized_mutual_information_loss_2d": Case(
        "normalized_mutual_information_loss_2d", (IM_X, IM_Y), atol=1e-4),
    "normalized_mutual_information_loss_3d": Case(
        "normalized_mutual_information_loss_3d", (VOL_X, VOL_Y), atol=1e-4),
}
for _cls, _args in (("MILossFromRef", (SIG_X, SIG_Y, MASK)),
                    ("NMILossFromRef", (SIG_X, SIG_Y, None)),
                    ("MILossFromRef2D", (IM_X, IM_Y, MASK2)),
                    ("NMILossFromRef2D", (IM_X, IM_Y, None)),
                    ("MILossFromRef3D", (VOL_X, VOL_Y, None)),
                    ("NMILossFromRef3D", (VOL_X, VOL_Y, None))):
    MI[_cls] = Case("", _args, atol=1e-4, jax_fn=_from_ref(_cls)(jmi),
                    torch_fn=_from_ref(_cls)(tmi))
# the kernels' enum members map onto the port's (same names)
_TORCH_KERNEL = {k: getattr(tmi.MIKernel, k.name) for k in jmi.MIKernel}

SCORES = rand(6, 5, lo=-2.0, hi=2.0, seed=20)
SCORES[2, 1] = SCORES[2, 3]  # a tie in the ranking
TARGETS = np.array([1, 3, 3, 0, 4, 2], np.int32)
SEG_PRED = RNG.integers(0, 5, (2, 16, 16)).astype(np.int32)
SEG_TRUE = np.where(rand(2, 16, 16, seed=21) > 0.3, SEG_PRED,
                    RNG.integers(0, 5, (2, 16, 16))).astype(np.int32)
BOX1 = np.sort(rand(5, 2, 2, hi=50.0, seed=22), 1).reshape(5, 4)[:,
                                                                [0, 2, 1, 3]]
BOX2 = np.sort(rand(4, 2, 2, hi=50.0, seed=23), 1).reshape(4, 4)[:,
                                                                [0, 2, 1, 3]]
FLOW_A = rand(2, 10, 12, 2, lo=-3.0, hi=3.0, seed=24)
FLOW_B = FLOW_A + rand(2, 10, 12, 2, lo=-1.0, hi=1.0, seed=25)
DISP_A = rand(2, 9, 11, hi=60.0, seed=26)
DISP_B = DISP_A + rand(2, 9, 11, lo=-6.0, hi=6.0, seed=27)
DISP_MASK = (rand(2, 9, 11, seed=28) > 0.2).astype(np.float32)

METRICS = {
    # exact: the simplifier folds count · 100 / B into one product
    "accuracy": Case("accuracy", (SCORES, TARGETS, (1, 2, 3)), atol=0,
                     exact=True),
    "confusion_matrix": Case("confusion_matrix", (SEG_PRED, SEG_TRUE, 5),
                             atol=0),
    "confusion_matrix_normalized": Case("confusion_matrix",
                                        (SEG_PRED, SEG_TRUE, 5, True)),
    "mean_iou": Case("mean_iou", (SEG_PRED, SEG_TRUE, 5)),
    "mean_iou_bbox": Case("mean_iou_bbox", (BOX1, BOX2)),
    "aepe": Case("aepe", (FLOW_A, FLOW_B)),
    "aepe_sum": Case("aepe", (FLOW_A, FLOW_B, "sum"), rtol=1e-5),
    "aepe_none": Case("aepe", (FLOW_A, FLOW_B, "none")),
    "average_endpoint_error": Case("average_endpoint_error",
                                   (FLOW_A, FLOW_B)),
    "mean_absolute_disparity_error": Case(
        "mean_absolute_disparity_error", (DISP_A, DISP_B)),
    "mean_absolute_disparity_error_masked": Case(
        "mean_absolute_disparity_error", (DISP_A, DISP_B, DISP_MASK),
        rtol=1e-5),
    "root_mean_squared_disparity_error": Case(
        "root_mean_squared_disparity_error", (DISP_A, DISP_B, DISP_MASK),
        rtol=1e-5),
    "root_mean_squared_disparity_error_none": Case(
        "root_mean_squared_disparity_error", (DISP_A, DISP_B, None, "none"),
        rtol=1e-5),
    "mean_bad_pixel_error": Case("mean_bad_pixel_error", (DISP_A, DISP_B)),
    "mean_bad_pixel_error_masked_sum": Case(
        "mean_bad_pixel_error", (DISP_A, DISP_B, 1.0, DISP_MASK, "sum"),
        atol=0),
}

# the gradients of four losses with respect to the logits (or image), and
# the reference's class API: cases of the losses' program too
GRADS = {"ms_ssim": ("ms_ssim_loss", MS_A, (MS_B,)),
         "focal": ("focal_loss", LOGITS, (LABELS, 0.5, 2.0, "mean")),
         "lovasz_softmax": ("lovasz_softmax_loss", LOGITS, (LABELS,)),
         "hausdorff": ("hausdorff_distance_loss", HAUS_LOGITS,
                       (HAUS_LABELS,))}


def _jax_grad(fn, rest):
    return lambda x: jax.grad(lambda a: getattr(jl, fn)(a, *map(
        jnp.asarray, rest[:1]), *rest[1:]))(x)


for _name, (_fn, _x, _rest) in GRADS.items():
    LOSSES["grad_" + _name] = Case("", (_x,), jax_fn=_jax_grad(_fn, _rest))

CLASSES = {"SSIMLoss": (tlosses, "ssim_loss", (MS_A, MS_B), {}),
           "MS_SSIMLoss": (tlosses, "ms_ssim_loss", (MS_A, MS_B), {}),
           "FocalLoss": (tlosses, "focal_loss", (LOGITS, LABELS),
                         dict(alpha=0.5, reduction="mean")),
           "HausdorffERLoss": (tlosses, "hausdorff_distance_loss",
                               (HAUS_LOGITS, HAUS_LABELS), {}),
           "SSIM": (tmetrics, "ssim", (IMG_A, IMG_B), {}),
           "AEPE": (tmetrics, "aepe", (FLOW_A, FLOW_B), {})}


MODULES = {"losses": (LOSSES, jl, tl), "mi": (MI, jmi, tmi),
           "metrics": (METRICS, jm, tm)}


@pytest.fixture(scope="module")
def refs():
    return {m: batch_references(cases, jmod)
            for m, (cases, jmod, _) in MODULES.items()}


@pytest.mark.parametrize("module,name", [
    (m, n) for m, (cases, _, _) in MODULES.items() for n in cases
    if not n.startswith("grad_")])
def test_losses_metrics_match_reference(module, name, refs):
    cases, _, tmod = MODULES[module]
    case = cases[name]
    if module == "mi":  # the port's own enum in the kernel's place
        case = Case(case.fn, tuple(_TORCH_KERNEL.get(a, a) if isinstance(
            a, jmi.MIKernel) else a for a in case.args), case.kwargs,
            case.atol, case.rtol, jax_fn=case.jax_fn,
            torch_fn=case.torch_fn)
    run_case(case, tmod, refs[module][name])


@pytest.mark.parametrize("name", list(GRADS))
def test_loss_gradients_match_reference(name, refs):
    """The port's autograd gradient within 1e-4 of the largest of the
    reference's ``jax.grad``."""
    fn, x, rest = GRADS[name]
    xt = torch.from_numpy(x.copy()).requires_grad_(True)
    loss = getattr(tl, fn)(xt, *[torch.from_numpy(r) if isinstance(
        r, np.ndarray) else r for r in rest])
    (gt,) = torch.autograd.grad(loss, xt)
    gj = np.asarray(refs["losses"]["grad_" + name])
    scale = max(float(np.abs(gj).max()), 1e-30)
    assert np.isfinite(gt.numpy()).all()
    assert float(np.abs(gt.numpy() - gj).max()) <= 1e-4 * scale


def test_mean_average_precision_matches_reference():
    rng = np.random.default_rng(30)
    gt = np.sort(rng.uniform(0, 80, (6, 2, 2)), 1).reshape(6, 4)[:,
                                                                  [0, 2, 1, 3]]
    gt[:, 2:] += 10
    gt_labels = np.array([0, 1, 1, 2, 2, 2], np.int32)
    # predictions: jittered ground truth (some matched twice), a few
    # strays, two tied scores
    pred = np.concatenate([gt + rng.normal(0, 2, gt.shape),
                           gt[:3] + rng.normal(0, 15, (3, 4))]).astype(
                               np.float32)
    pred[:, 2:] = np.maximum(pred[:, 2:], pred[:, :2] + 1)
    labels = np.array([0, 1, 1, 2, 2, 2, 0, 1, 3], np.int32)
    scores = rng.uniform(0.1, 1.0, 9).astype(np.float32)
    scores[4] = scores[7]
    gt = gt.astype(np.float32)
    args = (pred, labels, scores, gt, gt_labels, 4)
    m_j, aps_j = jm.mean_average_precision(*map(
        lambda a: jnp.asarray(a) if isinstance(a, np.ndarray) else a, args))
    m_t, aps_t = tm.mean_average_precision(*map(
        lambda a: torch.from_numpy(a) if isinstance(a, np.ndarray) else a,
        args))
    assert sorted(aps_t) == sorted(aps_j)
    for c in aps_j:
        assert abs(aps_t[c] - aps_j[c]) <= 1e-6, c
    assert abs(float(m_t) - float(m_j)) <= 1e-6


def test_average_meter_follows_reference():
    mj, mt = jm.AverageMeter(), tm.AverageMeter()
    for v, n in ((0.5, 1), (2.0, 3), (1.25, 2)):
        mj.update(v, n)
        mt.update(torch.tensor(v), n)
    assert (mt.val, mt.sum, mt.count, mt.avg) == (mj.val, mj.sum, mj.count,
                                                  mj.avg)
    mt.reset()
    assert (mt.sum, mt.count) == (0.0, 0)


@pytest.mark.parametrize("name", list(CLASSES))
def test_class_api_binds_as_the_functional(name):
    """The reference's class API (``fn_module`` over a functional, as in the
    reference's ``__init__``): the configuration at construction, the
    tensors at the call; bit for bit the functional, whose parity the cases
    above hold."""
    pkg, fn, args, kw = CLASSES[name]
    targs = [torch.from_numpy(a) for a in args]
    got = getattr(pkg, name)(**kw)(*targs)
    want = getattr(pkg, fn)(*targs, **kw)
    assert torch.equal(got, want)
