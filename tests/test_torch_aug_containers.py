"""Parity of the port's augmentation containers, video and patch
containers and ADA (``kornia_tpu_torch/augmentation/{container,video,
presets}.py``) with the JAX package, and the slice's two training-data
pipelines through both libraries.

A container's JAX params (one dict an op) cross through
``convert.aug_params_from_numpy``; the JAX side runs in one program
(tests/torch_aug_parity), except ``PatchSequential``'s records, which
the JAX package draws on the host (numpy) and so eagerly; its five modes'
outputs on them come from one more program. Tolerances:
1e-4 for images that pass a warp or the JPEG codec and for coordinates
(pixels of a 32-64-wide image); 0 for label masks through the matrix
warps (nearest) and for class labels; 1e-5 for intensity-only
pipelines. Mirrors the container legs of tests/test_augmentation.py,
tests/test_aug_containers_extra.py and the non-reference legs of
tests/test_patch_video_sequential.py.
"""

import numpy as np
import pytest
import torch

import kornia_tpu.augmentation as JA
import kornia_tpu_torch.augmentation as TA
from kornia_tpu_torch.convert import aug_params_from_numpy
from tests.torch_aug_parity import AugCase, check_case, references
from tests.torch_op_parity import (FAST_OPTIONS, check_close, exact_jit,
                                   rand)
from tests.torch_threads import one_torch_thread  # noqa: F401

WARP = 1e-4


def _labels(shape, n, seed):
    """Integer labels 0..n-1 in 8 × 8 blocks, as float."""
    b = rand(*shape[:-2], shape[-2] // 8, shape[-1] // 8, hi=float(n),
             seed=seed)
    return np.floor(np.kron(b, np.ones((8, 8), np.float32)))


def _boxes(B, N, size, seed):
    c = rand(B, N, 2, lo=0.2 * size, hi=0.8 * size, seed=seed)
    wh = rand(B, N, 2, lo=2.0, hi=0.3 * size, seed=seed + 1)
    return np.concatenate([c - wh / 2, c + wh / 2], -1)


ARRAYS = {
    "img": rand(2, 3, 32, 32, seed=21),
    "mask": _labels((2, 1, 32, 32), 4, 22),
    "bbox": _boxes(2, 4, 32, 23),
    "kp": rand(2, 6, 2, lo=0.0, hi=31.0, seed=25),
    "cls": np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32),
    # the slice's pipelines at 2 × 3 × 64 × 64
    "img64": rand(2, 3, 64, 64, seed=26),
    "mask64": _labels((2, 1, 64, 64), 5, 27),
    "bbox64": _boxes(2, 5, 64, 28),
    "kp64": rand(2, 7, 2, lo=0.0, hi=63.0, seed=30),
    # clips (B, C, T, H, W)
    "clip": rand(2, 3, 4, 32, 32, seed=31),
}
KEYS = ["input", "mask", "bbox_xyxy", "keypoints", "class"]


def seq_call(aug, ins, p):
    """Forward of every data key, then the inverse of the outputs."""
    out = aug(*ins, data_keys=KEYS, params=p)
    back = aug.inverse(*out[:4], data_keys=KEYS[:4], params=p,
                       in_hw=tuple(ins[0].shape[-2:]))
    return tuple(out) + tuple(back)


def seq(make, inputs=("img", "mask", "bbox", "kp", "cls"),
        image=WARP, mask=0.0):
    # forward: image, mask, boxes, keypoints, labels; inverse: image,
    # mask, boxes, keypoints
    return AugCase(make, inputs, (image, mask, WARP, WARP, 0.0,
                                  WARP, mask, WARP, WARP), seq_call)


def image_seq(aug, ins, p):
    return aug(ins[0], params=p)


def video_call(aug, ins, p):
    out = aug(ins[0], params=p)
    return out, aug.inverse(out, params=p)


def simclr(A, size):
    return A.ImageSequential(
        A.RandomResizedCrop((size, size), scale=(0.08, 1.0)),
        A.RandomHorizontalFlip(),
        A.ColorJiggle(0.8, 0.8, 0.8, 0.2, p=0.8),
        A.RandomGrayscale(p=0.2),
        A.RandomGaussianBlur((23, 23), (0.1, 2.0), p=0.5),
        A.RandomSolarize(p=0.2),
        A.Normalize([0.485, 0.456, 0.406], [0.229, 0.224, 0.225]))


def detection(A, jpeg=True):
    ops = [A.RandomHorizontalFlip(),
           A.RandomAffine(15.0, (0.1, 0.1), (0.8, 1.2), 5.0),
           A.RandomPerspective(0.3),
           A.RandomElasticTransform(p=0.5),
           A.RandomBoxBlur((5, 5))]
    if jpeg:
        ops.append(A.RandomJPEG((50.0, 90.0)))
    return A.AugmentationSequential(*ops, data_keys=KEYS)


def two_views(aug, ins, p):
    return aug(ins[0], params=p)


def clip_params(aug, key, shape):
    """VideoSequential's params: one set a clip, repeated over its frames."""
    B, C, T, H, W = shape
    return aug._clip_params(key, B, T, (C, H, W))


def ada_pipeline(A):
    """ADA's pipeline at p = 0.6."""
    ada = A.AdaptiveDiscriminatorAugmentation()
    ada.p = 0.6
    return ada._pipeline()


CASES = {
    "ImageSequential": AugCase(lambda A: A.ImageSequential(
        A.RandomBrightness(p=1.0), A.RandomHorizontalFlip(),
        A.RandomGaussianBlur((5, 5), p=1.0)), call=image_seq),
    # crops re-frame the later ops; the rotation's matrix and the jitter
    # (which moves no coordinate) between them
    "AugmentationSequential[crops]": seq(lambda A: A.AugmentationSequential(
        A.RandomCrop((28, 26)), A.RandomRotation(25.0, p=1.0),
        A.ColorJiggle(p=1.0), A.RandomVerticalFlip(p=1.0),
        A.RandomResizedCrop((24, 24)), data_keys=KEYS)),
    "VideoSequential": AugCase(lambda A: A.VideoSequential(
        A.ColorJiggle(0.2, 0.3, 0.2, 0.05, p=1.0),
        A.RandomAffine(10.0, p=1.0), A.RandomBoxBlur((3, 3)),
        A.RandomHorizontalFlip(), data_format="BCTHW"), ("clip",), WARP,
        video_call, draw=clip_params),
    "ADA": AugCase(ada_pipeline, atol=WARP),
    # the slice's pipelines (chip_smoke.py step 16 (a) and (b)) at 64 px
    "simclr_view": AugCase(lambda A: simclr(A, 56), ("img64",), WARP,
                           two_views),
    "detection": seq(detection, ("img64", "mask64", "bbox64", "kp64",
                                 "cls"), mask=WARP),
}


@pytest.fixture(scope="module")
def refs():
    return references(CASES, ARRAYS)


@pytest.mark.parametrize("name", [n for n in CASES
                                  if n not in ("VideoSequential", "ADA")])
def test_replays_the_jax_params(name, refs):
    check_case(name, CASES[name], refs, ARRAYS)


def test_video_sequential_replays_the_jax_params(refs):
    p_j, want = refs["VideoSequential"]
    vs = CASES["VideoSequential"].make(TA)
    x = torch.from_numpy(ARRAYS["clip"])
    params = aug_params_from_numpy(p_j, "cpu")
    out = vs(x, params=params)
    check_close(out, want[0], WARP)
    check_close(vs.inverse(out, params=params), want[1], WARP)


def test_containers_carry_boxes_and_keypoints_types(refs):
    from kornia_tpu_torch.geometry.boxes import Boxes, Keypoints
    name = "AugmentationSequential[crops]"
    p_j, want = refs[name]
    aug = CASES[name].make(TA)
    x = torch.from_numpy(ARRAYS["img"])
    boxes = Boxes.from_tensor(torch.from_numpy(ARRAYS["bbox"]))
    kps = Keypoints.from_tensor(torch.from_numpy(ARRAYS["kp"]))
    params = aug_params_from_numpy(p_j, "cpu")
    _, ob, ok = aug(x, boxes, kps, data_keys=["input", "bbox", "keypoints"],
                    params=params)
    assert isinstance(ob, Boxes) and isinstance(ok, Keypoints)
    check_close(ob.data, want[2], WARP)
    check_close(ok.data, want[3], WARP)
    bb, bk = aug.inverse(ob, ok, data_keys=["bbox", "keypoints"])
    assert isinstance(bb, Boxes) and isinstance(bk, Keypoints)
    check_close(bb.data, want[7], WARP)
    check_close(bk.data, want[8], WARP)


def test_detection_inverse_maps_keypoints_back(refs):
    """The pipeline's only non-matrix op (elastic) leaves points where
    they are: its inverse maps the keypoints back to the input."""
    p_j, want = refs["detection"]
    kp = ARRAYS["kp64"]
    np.testing.assert_allclose(want[8], kp, atol=1e-3)
    aug = detection(TA)
    params = aug_params_from_numpy(p_j, "cpu")
    x = torch.from_numpy(ARRAYS["img64"])
    _, k = aug(x, torch.from_numpy(kp), data_keys=["input", "keypoints"],
               params=params)
    back = aug.inverse(k, data_keys=["keypoints"])
    np.testing.assert_allclose(back.numpy(), kp, atol=1e-3)


def test_two_views_differ_and_replay():
    x = torch.from_numpy(ARRAYS["img64"])
    aug = simclr(TA, 56)
    g = torch.Generator().manual_seed(0)
    v1, v2 = aug(x, g), aug(x, g)
    assert v1.shape == (2, 3, 56, 56) and not torch.equal(v1, v2)
    p = aug.generate_parameters(torch.Generator().manual_seed(1), x.shape)
    assert torch.equal(aug(x, params=p), aug(x, params=p))


def test_a_forward_makes_no_host_read(monkeypatch):
    """The SimCLR and detection forwards read nothing back to the host:
    every tensor-to-Python conversion raises while they run (after one
    warm-up call, which fills the per-device constant tables)."""
    x = torch.from_numpy(ARRAYS["img64"])
    ins = [torch.from_numpy(ARRAYS[k]) for k in ("img64", "mask64",
                                                 "bbox64", "kp64", "cls")]
    views, det = simclr(TA, 56), detection(TA)

    def run():
        g = torch.Generator().manual_seed(0)
        views(x, g)
        views(x, g)
        det(*ins, generator=g)

    run()

    def refuse(*a, **k):
        raise AssertionError("host read in a forward")

    for name in ("item", "tolist", "numpy", "__bool__", "__float__",
                 "__int__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    run()


def test_intensity_ops_leave_coordinates_and_masks():
    aug = TA.AugmentationSequential(TA.ColorJiggle(p=1.0),
                                    data_keys=["input", "mask", "keypoints"])
    x = torch.from_numpy(ARRAYS["img"])
    m = torch.from_numpy(ARRAYS["mask"])
    k = torch.from_numpy(ARRAYS["kp"])
    _, om, ok = aug(x, m, k)
    assert torch.equal(om, m) and torch.equal(ok, k)


def test_hflip_moves_boxes_and_keypoints():
    seq_ = TA.AugmentationSequential(TA.RandomHorizontalFlip(p=1.0),
                                     data_keys=["input", "bbox_xyxy",
                                                "keypoints"])
    x = torch.zeros(4, 3, 16, 16)
    _, b, k = seq_(x, torch.tensor([[[2.0, 3.0, 5.0, 6.0]]] * 4),
                   torch.tensor([[[2.0, 3.0]]] * 4))
    torch.testing.assert_close(b, torch.tensor([[[10.0, 3.0, 13.0, 6.0]]]
                                               * 4), atol=1e-4, rtol=0)
    torch.testing.assert_close(k, torch.tensor([[[13.0, 3.0]]] * 4),
                               atol=1e-4, rtol=0)


def test_dispatchers():
    x = torch.from_numpy(ARRAYS["img"])
    a = TA.AugmentationSequential(TA.RandomAffine(20.0, p=1.0),
                                  TA.ColorJiggle(p=1.0))
    b = TA.AugmentationSequential(TA.RandomAffine(20.0, p=1.0),
                                  TA.ColorJiggle(p=1.0))
    o1, o2 = TA.ManyToOneAugmentationDispather(a, b)(
        x, x, generator=torch.Generator().manual_seed(0))
    assert torch.equal(o1, o2)  # one parameter set for both
    o3, o4 = TA.ManyToManyAugmentationDispather(a, b)(
        (x,), (x,), generator=torch.Generator().manual_seed(0))
    assert not torch.equal(o3, o4)  # each its own draws


# -- VideoSequential and PatchSequential ---------------------------------------

def test_video_frames_share_their_clip_params():
    frame = rand(2, 1, 3, 16, 16, seed=40) * 0.5 + 0.2
    clip = torch.from_numpy(np.repeat(frame, 4, 1))  # (B, T, C, H, W)
    vs = TA.VideoSequential(TA.RandomBrightness((0.7, 1.3), p=1.0))
    out = vs(clip, torch.Generator().manual_seed(0))
    assert torch.allclose(out[0, 0], out[0, 3], atol=1e-6)
    assert not torch.allclose(out[0, 0] - clip[0, 0], out[1, 0] - clip[1, 0],
                              atol=1e-4)
    flips = TA.VideoSequential(TA.RandomHorizontalFlip(p=0.5))(
        clip, torch.Generator().manual_seed(3))
    moved = (flips - clip).abs().amax(dim=(2, 3, 4)) > 1e-6
    assert all(len(set(r.tolist())) == 1 for r in moved)


def test_video_inverse_takes_its_own_clip_length():
    yy, xx = np.meshgrid(np.linspace(0, 1, 16), np.linspace(0, 1, 16),
                         indexing="ij")
    img = (0.3 * yy + 0.5 * xx).astype(np.float32)
    vs = TA.VideoSequential(TA.RandomHorizontalFlip(p=1.0))
    clip2 = torch.from_numpy(np.broadcast_to(img, (1, 2, 3, 16, 16)).copy())
    vs(torch.from_numpy(np.broadcast_to(img, (1, 5, 3, 16, 16)).copy()))
    out2 = vs(clip2, torch.Generator().manual_seed(1))
    back = vs.inverse(out2)
    assert back.shape == clip2.shape
    torch.testing.assert_close(back, clip2, atol=1e-5, rtol=0)


PATCH_MODES = {
    "default": lambda A: A.PatchSequential(
        A.RandomBrightness((0.6, 1.4), p=1.0),
        A.RandomContrast((0.7, 1.3), p=1.0), grid_size=2),
    "same_on_batch": lambda A: A.PatchSequential(
        A.RandomBrightness((0.6, 1.4), p=1.0), A.RandomGamma(p=1.0),
        grid_size=(2, 2), same_on_batch=True),
    "random_apply": lambda A: A.PatchSequential(
        A.RandomBrightness(p=1.0), A.RandomContrast(p=1.0),
        A.RandomSaturation(p=1.0), grid_size=2, random_apply=2),
    "patchwise": lambda A: A.PatchSequential(
        A.RandomBrightness(p=1.0), A.RandomContrast(p=1.0),
        A.RandomSaturation(p=1.0), A.RandomGamma(p=1.0), grid_size=2,
        patchwise_apply=True),
    "valid": lambda A: A.PatchSequential(
        A.RandomBrightness(p=1.0), grid_size=3, padding="valid"),
}


@pytest.fixture(scope="module")
def patch_refs():
    """Each mode's JAX records (eager: drawn on the host) and the JAX
    outputs on them, every mode from one program."""
    import jax
    x = rand(2, 3, 16, 18, seed=41)
    seqs = {m: make(JA) for m, make in PATCH_MODES.items()}
    recs = {m: ps.forward_parameters(jax.random.PRNGKey(3), x.shape)
            for m, ps in seqs.items()}
    out = exact_jit(lambda a: {m: ps(a, params=recs[m])
                               for m, ps in seqs.items()},
                    x, exact=False, options=FAST_OPTIONS)
    return x, {m: (recs[m], np.asarray(out[m])) for m in seqs}


@pytest.mark.parametrize("mode", list(PATCH_MODES))
def test_patch_sequential_replays_the_jax_records(mode, patch_refs):
    x, refs_ = patch_refs
    recs, want = refs_[mode]
    ps = PATCH_MODES[mode](TA)
    got = ps(torch.from_numpy(x), params=aug_params_from_numpy(recs, "cpu"))
    check_close(got, want, 1e-5)
    # the port's own records: the same modes, counts and indices
    own = ps.forward_parameters(torch.Generator().manual_seed(0), x.shape)
    if mode in ("default", "same_on_batch", "patchwise"):
        assert [(r.indices, r.op_index) for r in own] == \
            [(tuple(r.indices), r.op_index) for r in recs]
    assert len(own) > 0 and all(
        sorted(r.data) == sorted(recs[0].data) for r in own
        if r.op_index == recs[0].op_index)


def test_patch_geometry():
    x = torch.arange(16.0).reshape(1, 1, 4, 4)
    ps = TA.PatchSequential(TA.RandomBrightness(p=1.0), grid_size=2)
    patches = ps.extract_patches(x)
    assert patches[0, 0, 0].tolist() == [[0, 1], [4, 5]]
    assert patches[0, 1, 0].tolist() == [[2, 3], [6, 7]]
    assert torch.equal(ps.restore_from_patches(patches), x)
    x = torch.arange(54.0).reshape(1, 1, 6, 9)
    ps = TA.PatchSequential(TA.RandomBrightness(p=1.0), grid_size=2,
                            padding="valid")
    patches = ps.extract_patches(x, pad=(-1, -1, -2, -2))
    assert patches[0, 0, 0].tolist() == [[19, 20, 21]]
    assert patches[0, 3, 0].tolist() == [[31, 32, 33]]
    assert ps.compute_padding((6, 9)) == (-2, -2, -2, -2)


def test_patch_sequential_rules_and_inverse():
    with pytest.raises(ValueError, match="equal with grid size"):
        TA.PatchSequential(TA.RandomBrightness(p=1.0), grid_size=2,
                           patchwise_apply=True)
    with pytest.raises(ValueError, match="Only boolean"):
        TA.PatchSequential(*[TA.RandomBrightness(p=1.0)] * 4, grid_size=2,
                           patchwise_apply=True, random_apply=2)
    x = torch.from_numpy(rand(1, 3, 8, 8, seed=42))
    ps = TA.PatchSequential(TA.RandomBrightness(p=1.0), grid_size=2)
    assert torch.equal(ps.inverse(x), x)
    with pytest.raises(NotImplementedError):
        TA.PatchSequential(TA.RandomHorizontalFlip(p=1.0),
                           grid_size=2).inverse(x)


def test_patch_replay_is_one_call_an_op():
    x = torch.from_numpy(rand(8, 3, 16, 16, seed=43))
    ps = TA.PatchSequential(TA.RandomBrightness(p=1.0),
                            TA.RandomContrast(p=1.0), TA.RandomGamma(p=1.0),
                            grid_size=4)
    calls = []

    class Counting:
        def __init__(self, aug):
            self._aug = aug

        def __call__(self, *a, **kw):
            calls.append(1)
            return self._aug(*a, **kw)

        def __getattr__(self, n):
            return getattr(self._aug, n)

    ps.augs = [Counting(a) for a in ps.augs]
    recs = ps.forward_parameters(torch.Generator().manual_seed(0), x.shape)
    out = ps(x, params=recs)
    assert out.shape == x.shape and len(calls) <= 3
    # against a record-by-record replay
    pad = ps.compute_padding(x.shape[-2:])
    flat = ps.extract_patches(x, pad).reshape(-1, 3, 4, 4)
    for rec in recs:
        idx = torch.tensor(rec.indices)
        flat = flat.index_copy(0, idx, ps.augs[rec.op_index](
            flat[idx], params=rec.data))
    naive = ps.restore_from_patches(flat.reshape(8, -1, 3, 4, 4), pad)
    torch.testing.assert_close(out, naive, atol=1e-6, rtol=0)


# -- ADA ----------------------------------------------------------------------

def test_ada_replays_the_jax_pipeline(refs):
    check_case("ADA", CASES["ADA"], refs, ARRAYS)


def test_ada_p_follows_the_jax_package():
    ja = JA.AdaptiveDiscriminatorAugmentation(adjustment_speed=0.1)
    ta = TA.AdaptiveDiscriminatorAugmentation(adjustment_speed=0.1)
    x = torch.from_numpy(ARRAYS["img"])
    assert torch.equal(ta(x), x)  # p = 0: the identity
    rng = np.random.default_rng(44)
    for _ in range(12):
        logits = rng.normal(0.3, 1.0, 16).astype(np.float32)
        assert ta.update(torch.from_numpy(logits)) == \
            pytest.approx(ja.update(logits))
    assert ta.p > 0
    out = ta(x, torch.Generator().manual_seed(0))
    assert out.shape == x.shape
