"""Parity of the port's mix and volumetric augmentations
(``kornia_tpu_torch/augmentation/{mix,volumetric}.py``) with the JAX
package.

Every class draws its parameters in JAX and replays them in the port
(one JAX program, tests/torch_aug_parity): images 2 × 3 × 32 × 32 with
labels and label masks, volumes 1 × 1 × 8 × 16 × 16 (two for the 3-D
transplantation). Tolerances: 0 (bit for bit) for the selections, labels
and masks (CutMix, Mosaic, Jigsaw, PatchMix's mask, transplantation, the
3-D flips and crops, the volumetric equalisation), 1e-5 for MixUp's blend
and the mixed-label weights, 1e-4 for the 3-D warps and their (B, 4, 4)
matrices. Mirrors the mix legs of tests/test_augmentation.py.
"""

import numpy as np
import pytest
import torch

import kornia_tpu_torch.augmentation as TA
from tests.torch_aug_parity import (AugCase, check_case, check_layout,
                                    default_call, references)
from tests.torch_op_parity import rand
from tests.torch_threads import one_torch_thread  # noqa: F401

ARRAYS = {
    "img": rand(2, 3, 32, 32, seed=5),
    "labels": np.array([3, 7], np.int32),
    "seg": np.floor(np.kron(rand(2, 4, 4, hi=4.0, seed=6),
                            np.ones((8, 8), np.float32))).astype(np.int32),
    "vol": rand(1, 1, 8, 16, 16, seed=7),
    "vol2": rand(2, 1, 8, 16, 16, seed=8),
    "vseg": np.floor(np.kron(rand(2, 2, 4, 4, hi=3.0, seed=9),
                             np.ones((4, 4, 4), np.float32))).astype(
                                 np.int32),
}
WARP = 1e-4


def with_labels(aug, ins, p):
    return aug(ins[0], ins[1], params=p)


def paired(aug, ins, p):
    return aug(ins[0], ins[1], params=p)


def with_matrix(aug, ins, p):
    return aug(ins[0], params=p), aug.matrix4(p, ins[0].shape)


def vol(make, atol=WARP, call=with_matrix, **kw):
    return AugCase(make, ("vol",), atol, call, **kw)


CASES = {
    "RandomMixUpV2": AugCase(lambda A: A.RandomMixUpV2(p=1.0),
                             ("img", "labels"), 1e-5, with_labels),
    "RandomCutMixV2": AugCase(lambda A: A.RandomCutMixV2(p=1.0),
                              ("img", "labels"), 0.0, with_labels),
    "RandomMosaic": AugCase(lambda A: A.RandomMosaic(p=1.0), atol=0.0),
    "RandomJigsaw": AugCase(lambda A: A.RandomJigsaw((4, 4), p=1.0),
                            atol=0.0),
    "RandomJigsaw[3x5]": AugCase(lambda A: A.RandomJigsaw((3, 5), p=1.0),
                                 atol=0.0),
    "RandomPatchMix": AugCase(lambda A: A.RandomPatchMix(p=1.0), atol=0.0),
    "PatchMix[3x3]": AugCase(lambda A: A.PatchMix((3, 3), 0.6, p=1.0),
                             atol=1e-6),
    "RandomTransplantation": AugCase(
        lambda A: A.RandomTransplantation(p=1.0), ("img", "seg"), 0.0,
        paired),
    "RandomTransplantation3D": AugCase(
        lambda A: A.RandomTransplantation3D(p=1.0), ("vol2", "vseg"), 0.0,
        paired),
    "RandomHorizontalFlip3D": vol(lambda A: A.RandomHorizontalFlip3D(
        p=1.0), 0.0),
    "RandomVerticalFlip3D": vol(lambda A: A.RandomVerticalFlip3D(p=1.0),
                                0.0),
    "RandomDepthicalFlip3D": vol(lambda A: A.RandomDepthicalFlip3D(p=1.0),
                                 0.0),
    "RandomRotation3D": vol(lambda A: A.RandomRotation3D(20.0, p=1.0)),
    "RandomAffine3D": vol(lambda A: A.RandomAffine3D(
        (10.0, 20.0, 15.0), (0.1, 0.1, 0.1), (0.9, 1.1), p=1.0)),
    "RandomCrop3D": vol(lambda A: A.RandomCrop3D((6, 12, 10)), 0.0),
    "CenterCrop3D": vol(lambda A: A.CenterCrop3D((6, 12, 10)), 0.0,
                        default_call),
    "RandomEqualize3D": vol(lambda A: A.RandomEqualize3D(p=1.0), 0.0,
                            default_call, exact=True),
    "RandomMotionBlur3D": vol(lambda A: A.RandomMotionBlur3D(5, p=1.0),
                              1e-5, default_call),
    "RandomPerspective3D": vol(lambda A: A.RandomPerspective3D(0.4, p=1.0)),
}


@pytest.fixture(scope="module")
def refs():
    return references(CASES, ARRAYS)


@pytest.mark.parametrize("name", list(CASES))
def test_replays_the_jax_params(name, refs):
    check_case(name, CASES[name], refs, ARRAYS)


@pytest.mark.parametrize("name", list(CASES))
def test_params_have_the_jax_layout(name, refs):
    check_layout(name, CASES[name], refs, ARRAYS)


def test_every_exported_class_has_a_case():
    import kornia_tpu.augmentation.mix as JM
    import kornia_tpu.augmentation.volumetric as JV
    from kornia_tpu_torch.augmentation import mix as TM, volumetric as TV
    assert sorted(TM.__all__) == sorted(JM.__all__)
    assert sorted(TV.__all__) == sorted(JV.__all__)
    bases = {"MixAugmentationBaseV2", "AugmentationBase3D",
             "IntensityAugmentationBase3D", "GeometricAugmentationBase3D",
             "RigidAffineAugmentationBase3D"}
    left = set(JM.__all__) | set(JV.__all__)
    assert not left - bases - {n.split("[")[0] for n in CASES}
    assert TM.PatchMix is TM.RandomPatchMix


def test_mix_outputs_and_labels():
    x = torch.from_numpy(ARRAYS["img"])
    labels = torch.arange(2)
    g = torch.Generator().manual_seed(0)
    out, mixed = TA.RandomMixUpV2(p=1.0)(x, labels, g)
    assert out.shape == x.shape and mixed.shape == (2, 3)
    out, mixed = TA.RandomCutMixV2(p=1.0)(x, labels, g)
    lam = mixed[:, 2]
    assert bool(((lam >= 0) & (lam <= 1)).all())
    assert TA.RandomMosaic(p=1.0)(x, g).shape == x.shape
    jig = TA.RandomJigsaw((4, 4), p=1.0)(x, g)
    # a permutation of tiles keeps every pixel value
    assert torch.equal(jig.reshape(2, -1).sort(-1).values,
                       x.reshape(2, -1).sort(-1).values)


def test_cutmix_beta_draws():
    """The port's Beta(1, 1) draws (gamma ratios): uniform on [0, 1]."""
    lam = torch.stack([
        1 - TA.RandomCutMixV2().generate_parameters(
            torch.Generator().manual_seed(s), (256, 3, 8, 8))["h"] ** 2 / 64
        for s in range(8)]).reshape(-1)
    assert 0.0 <= lam.min() and lam.max() <= 1.0
    assert abs(lam.mean().item() - 0.5) < 4 * (1 / 12 / 2048) ** 0.5
    assert abs(lam.var().item() - 1 / 12) < 0.01


def test_volumetric_defaults_and_crop_origins():
    v = torch.from_numpy(ARRAYS["vol"]).expand(64, 1, 8, 16, 16)
    prm = TA.RandomCrop3D((6, 12, 10)).generate_parameters(
        torch.Generator().manual_seed(0), v.shape)
    assert set(prm["z0"].tolist()) == {0, 1, 2}
    assert set(prm["x0"].tolist()) <= set(range(7))
    out = TA.RandomCrop3D((6, 12, 10))(v, params=prm)
    b = 5
    z, y, x0 = (int(prm[k][b]) for k in ("z0", "y0", "x0"))
    assert torch.equal(out[b], v[b, :, z:z + 6, y:y + 12, x0:x0 + 10])
