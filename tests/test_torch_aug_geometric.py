"""Parity of the port's geometric augmentations
(``kornia_tpu_torch/augmentation/geometric.py``) with the JAX package.

Every class draws its parameters in JAX and replays them in the port at
2 × 3 × 32 × 32 (one JAX program, tests/torch_aug_parity): the image, the
container paths of the op (points through ``transform_coords`` and
``inverse_coords``, a label mask through ``apply_to_mask``, the output
back through ``inverse_image``) and the parameter layout. Tolerances:
1e-4 for warps (integer-shift crops included) and coordinates (pixels of
a 32-wide image; the warps' sampling coordinates round differently), 0 for
the flips, centre crops and
rotations by 90° and for the label masks of the matrix warps, which
resample by nearest (elastic, TPS and fisheye resample masks bilinearly,
as in the JAX package: 1e-4).
Mirrors the geometric legs of tests/test_augmentation.py.
"""

import numpy as np
import pytest
import torch

import kornia_tpu_torch.augmentation as TA
from tests.torch_aug_parity import (AugCase, check_case, check_layout,
                                    references)
from tests.torch_op_parity import rand
from tests.torch_threads import one_torch_thread  # noqa: F401

ARRAYS = {
    "img": rand(2, 3, 32, 32, seed=2),
    "pts": rand(2, 5, 2, lo=0.0, hi=31.0, seed=3),
    # integer labels 0-3, smooth enough that nearest sampling keeps regions
    "mask": np.floor(np.kron(rand(2, 1, 4, 4, hi=4.0, seed=4),
                             np.ones((1, 1, 8, 8), np.float32))),
}
WARP = 1e-4


def geo_call(aug, ins, p):
    """The op on the image, the points forward and back, the label mask,
    and the output back to the op's input frame."""
    x, pts, mask = ins
    hw = tuple(x.shape[-2:])
    out = aug(x, params=p)
    return (out, aug.transform_coords(pts, p, hw),
            aug.inverse_coords(pts, p, hw), aug.apply_to_mask(mask, p, hw),
            aug.inverse_image(out, p, hw))


def geo(make, image_atol=WARP, mask_atol=0.0):
    return AugCase(make, ("img", "pts", "mask"),
                   (image_atol, WARP, WARP, mask_atol, WARP), geo_call)


CASES = {
    "Resize": geo(lambda A: A.Resize((24, 40))),
    "LongestMaxSize": geo(lambda A: A.LongestMaxSize(48)),
    "SmallestMaxSize": geo(lambda A: A.SmallestMaxSize(20)),
    "RandomHorizontalFlip": geo(lambda A: A.RandomHorizontalFlip(), 0.0),
    "RandomVerticalFlip": geo(lambda A: A.RandomVerticalFlip(p=1.0), 0.0),
    "RandomRotation": geo(lambda A: A.RandomRotation(30.0, p=1.0)),
    "RandomRotation90": geo(lambda A: A.RandomRotation90((1, 3), p=1.0),
                            0.0),
    "RandomAffine": geo(lambda A: A.RandomAffine(
        15.0, (0.1, 0.1), (0.8, 1.2), 5.0, p=1.0)),
    "RandomPerspective": geo(lambda A: A.RandomPerspective(0.4, p=1.0)),
    "RandomShear": geo(lambda A: A.RandomShear((-15.0, 15.0), p=1.0)),
    "RandomTranslate": geo(lambda A: A.RandomTranslate((0.2, 0.1), p=1.0)),
    "RandomCrop": geo(lambda A: A.RandomCrop((20, 24))),
    "RandomResizedCrop": geo(lambda A: A.RandomResizedCrop((24, 24))),
    "CenterCrop": geo(lambda A: A.CenterCrop((16, 20)), 0.0),
    # the deformation fields resample masks bilinearly, as their JAX
    # twins do (their apply takes no resample mode)
    "RandomElasticTransform": geo(lambda A: A.RandomElasticTransform(
        p=1.0), mask_atol=WARP),
    "RandomThinPlateSpline": geo(lambda A: A.RandomThinPlateSpline(
        0.1, p=1.0), mask_atol=WARP),
    "RandomFisheye": geo(lambda A: A.RandomFisheye(p=1.0), mask_atol=WARP),
    "PadTo": AugCase(lambda A: A.PadTo((40, 36), pad_value=0.5), atol=0),
    "PadTo[replicate]": AugCase(lambda A: A.PadTo((40, 36), "replicate"),
                                atol=0),
    "PadTo[reflect]": AugCase(lambda A: A.PadTo((40, 36), "reflect"),
                              atol=0),
    "PadTo[circular]": AugCase(lambda A: A.PadTo((40, 36), "circular"),
                               atol=0),
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
    import kornia_tpu.augmentation.geometric as J
    from kornia_tpu_torch.augmentation import geometric as T
    assert sorted(T.__all__) == sorted(J.__all__)
    assert not set(J.__all__) - {n.split("[")[0] for n in CASES}


def _img():
    return torch.from_numpy(ARRAYS["img"])


def test_flips_and_crops_are_exact():
    x = _img()
    g = torch.Generator().manual_seed(0)
    assert torch.equal(TA.RandomHorizontalFlip(p=1.0)(x, g), x.flip(-1))
    assert torch.equal(TA.RandomVerticalFlip(p=1.0)(x, g), x.flip(-2))
    assert torch.equal(TA.CenterCrop((8, 8))(x), x[:, :, 12:20, 12:20])
    out = TA.RandomRotation90((1, 1), p=1.0)(x, g)
    assert torch.equal(out, torch.rot90(x, 1, (-2, -1)))
    assert TA.RandomCrop((8, 8))(x, g).shape == (2, 3, 8, 8)
    assert TA.RandomResizedCrop((12, 12))(x, g).shape == (2, 3, 12, 12)


def test_hflip_matrix_maps_the_left_edge_right():
    x = _img()
    aug = TA.RandomHorizontalFlip(p=1.0)
    params = aug.generate_parameters(torch.Generator().manual_seed(0),
                                     x.shape)
    from kornia_tpu_torch.geometry.linalg import transform_points
    out = transform_points(aug.transform_matrix(x, params),
                           torch.zeros(2, 1, 2))
    assert torch.allclose(out[..., 0], torch.full((2, 1), 31.0))


def test_mask_path_is_nearest_and_leaves_the_op_unchanged():
    aug = TA.RandomRotation(20.0, p=1.0)
    m = torch.from_numpy(ARRAYS["mask"])
    prm = aug.generate_parameters(torch.Generator().manual_seed(1), m.shape)
    out = aug.apply_to_mask(m, prm, (32, 32))
    assert set(torch.unique(out).tolist()) <= {0.0, 1.0, 2.0, 3.0}
    assert aug.flags["resample"] == "bilinear"


def test_resized_crop_always_applies():
    aug = TA.RandomResizedCrop((16, 16), p=0.0)
    assert aug.p == 1.0
    prm = aug.generate_parameters(torch.Generator().manual_seed(0),
                                  (64, 3, 32, 32))
    assert bool(prm["apply_mask"].all())
    assert bool((prm["w"] >= 8).all() and (prm["w"] <= 32).all())
