"""The port's image IO and dataset readers (kornia_tpu_torch/io) against
the JAX package on the CPU: ``load_image`` / ``write_image`` round trips,
the native decoder's legs of tests/test_native_io.py (against the same
``native/libkornia_io.so``; they skip where it cannot be built, as the JAX
test does) and the TUM / KITTI legs of tests/test_datasets.py; the
default device of ``load_image`` through a stub.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kornia_tpu.io import datasets as j_ds
from kornia_tpu.io import io as j_io
from kornia_tpu_torch.io import datasets as t_ds
from kornia_tpu_torch.io import io as t_io
from kornia_tpu_torch.io import native as t_native
from tests.torch_threads import one_torch_thread  # noqa: F401

needs_native = pytest.mark.skipif(not t_native.native_available(),
                                  reason="native io backend not built")


def _u8(seed, shape):
    return (np.random.default_rng(seed).random(shape) * 255).astype(np.uint8)


# --- io.py -------------------------------------------------------------------

@pytest.mark.parametrize("ext", ["png", "jpg"])
def test_load_write_against_the_reference(tmp_path, ext):
    img = np.random.default_rng(0).random((3, 12, 10)).astype(np.float32)
    p_t, p_j = str(tmp_path / f"t.{ext}"), str(tmp_path / f"j.{ext}")
    t_io.write_image(p_t, torch.from_numpy(img))
    j_io.write_image(p_j, jnp.asarray(img))
    with open(p_t, "rb") as ft, open(p_j, "rb") as fj:
        assert ft.read() == fj.read()
    for typ in t_io.ImageLoadType:
        got = t_io.load_image(p_t, typ, device="cpu")
        want = np.asarray(j_io.load_image(p_t, j_io.ImageLoadType[typ.name]))
        assert got.dtype == (torch.float32 if typ.name.endswith("32")
                             else torch.uint8), typ
        np.testing.assert_array_equal(got.numpy(), want, err_msg=typ.name)


def test_write_uint8_batch_and_gray(tmp_path):
    batch = _u8(1, (2, 1, 9, 7))
    p = str(tmp_path / "g.png")
    t_io.write_image(p, torch.from_numpy(batch))
    back = t_io.load_image(p, t_io.ImageLoadType.UNCHANGED, device="cpu")
    np.testing.assert_array_equal(back.numpy(), batch[0])


def test_load_write_mirrored(tmp_path):
    path = str(tmp_path / "t.png")
    img = torch.from_numpy(
        np.random.default_rng(0).random((3, 8, 8)).astype(np.float32))
    t_io.write_image(path, img)
    back = t_io.load_image(path, t_io.ImageLoadType.RGB32, device="cpu")
    assert back.shape == (3, 8, 8)
    np.testing.assert_allclose(back.numpy(), img.numpy(),
                               atol=1 / 255.0 + 1e-3)


def test_load_image_defaults_to_the_card(tmp_path, monkeypatch):
    """With no device, the decoded tensor is sent to `cuda` (stubbed here:
    the stub records where the tensor was sent and keeps it on the
    CPU)."""
    path = str(tmp_path / "t.png")
    t_io.write_image(path, torch.from_numpy(_u8(2, (3, 4, 5))))
    sent = []
    real_to = torch.Tensor.to

    def to(self, *args, **kwargs):
        sent.append(args[0] if args else kwargs.get("device"))
        return real_to(self, "cpu")

    monkeypatch.setattr(torch.Tensor, "to", to)
    out = t_io.load_image(path)
    out_cpu = t_io.load_image(path, device="cpu")
    monkeypatch.undo()
    assert sent == ["cuda", "cpu"]
    np.testing.assert_array_equal(out.numpy(), out_cpu.numpy())


# --- native.py (tests/test_native_io.py) ------------------------------------

@needs_native
class TestNativeIO:
    def test_png_roundtrip(self, tmp_path):
        img = _u8(0, (32, 24, 3))
        p = str(tmp_path / "a.png")
        t_native.write_image_native(p, img)
        np.testing.assert_array_equal(t_native.read_image_native(p), img)

    def test_jpeg_roundtrip_smooth(self, tmp_path):
        ys = np.linspace(0, 255, 64)[:, None]
        xs = np.linspace(0, 255, 48)[None, :]
        img = np.stack([ys + 0 * xs, 0 * ys + xs, (ys + xs) / 2],
                       -1).astype(np.uint8)
        p = str(tmp_path / "a.jpg")
        t_native.write_image_native(p, img, quality=95)
        back = t_native.read_image_native(p)
        assert np.abs(back.astype(int) - img.astype(int)).mean() < 3

    def test_batch_resize(self, tmp_path):
        paths = []
        for i in range(8):
            p = str(tmp_path / f"{i}.png")
            t_native.write_image_native(p, _u8(i, (40 + i, 30, 3)))
            paths.append(p)
        batch = t_native.read_batch_native(paths, (32, 32))
        assert batch.shape == (8, 32, 32, 3)

    def test_batch_loader(self, tmp_path):
        paths = []
        for i in range(4):
            p = str(tmp_path / f"{i}.png")
            t_native.write_image_native(p, _u8(i, (16, 16, 3)))
            paths.append(p)
        batches = list(t_native.NativeBatchLoader([paths[:2], paths[2:]],
                                                  (16, 16)))
        assert len(batches) == 2 and batches[0].shape == (2, 16, 16, 3)
        assert list(t_native.NativeBatchLoader([], (16, 16))) == []

    def test_missing_file_and_dtype(self, tmp_path):
        with pytest.raises(IOError):
            t_native.read_image_native("/nonexistent/file.png")
        with pytest.raises(TypeError):
            t_native.write_image_native(str(tmp_path / "f.png"),
                                        np.zeros((4, 4, 3), np.float32))

    def test_load_image_uses_native(self, tmp_path):
        img = _u8(0, (16, 16, 3))
        p = str(tmp_path / "a.png")
        t_native.write_image_native(p, img)
        out = t_io.load_image(p, t_io.ImageLoadType.RGB32, device="cpu")
        assert out.shape == (3, 16, 16)
        np.testing.assert_allclose(out.numpy(), img.transpose(2, 0, 1)
                                   / 255.0, atol=1e-6)

    def test_against_the_reference_batch(self, tmp_path):
        from kornia_tpu.io import native as j_native
        paths = []
        for i in range(3):
            p = str(tmp_path / f"{i}.jpg")
            t_native.write_image_native(p, _u8(i, (20 + 3 * i, 17, 3)))
            paths.append(p)
        np.testing.assert_array_equal(
            t_native.read_batch_native(paths, (12, 9)),
            j_native.read_batch_native(paths, (12, 9)))
        for typ in ("GRAY8", "RGB32"):
            np.testing.assert_array_equal(
                t_io.load_image(paths[1], t_io.ImageLoadType[typ],
                                device="cpu").numpy(),
                np.asarray(j_io.load_image(paths[1],
                                           j_io.ImageLoadType[typ])))


# --- datasets.py (tests/test_datasets.py) -----------------------------------

def _write_png(path, arr):
    if arr.ndim == 3 and arr.shape[-1] in (1, 3):
        arr = np.moveaxis(arr, -1, 0)
    if arr.shape[0] == 1:
        arr = np.repeat(arr, 3, axis=0)
    t_io.write_image(str(path), torch.from_numpy(arr))


def _write_tum_sequence(root, n=8):
    """tests/test_datasets.py::_write_tum_sequence's layout."""
    os.makedirs(root / "rgb", exist_ok=True)
    os.makedirs(root / "depth", exist_ok=True)
    rng = np.random.default_rng(0)
    with open(root / "rgb.txt", "w") as fr, \
            open(root / "depth.txt", "w") as fd, \
            open(root / "groundtruth.txt", "w") as fg:
        fr.write("# color images\n")
        fd.write("# depth images\n")
        fg.write("# ground truth\n")
        for i in range(n):
            t = 100.0 + i * 0.1
            img = (rng.random((6, 8, 3)) * 255).astype(np.uint8)
            _write_png(root / "rgb" / f"{i}.png", img)
            _write_png(root / "depth" / f"{i}.png", img[..., :1])
            fr.write(f"{t:.4f} rgb/{i}.png\n")
            fd.write(f"{t + 0.005:.4f} depth/{i}.png\n")
            fg.write(f"{t + 0.002:.4f} {0.1 * i:.3f} 0 0 0 0 0 1\n")
    return n


def test_read_tum_trajectory(tmp_path):
    p = tmp_path / "gt.txt"
    p.write_text("# comment\n1.0 1 2 3 0 0 0 1\n2.0 4 5 6 0 0 0.7071 0.7071\n"
                 "3.0 short row\n")
    tr = t_ds.read_tum_trajectory(str(p))
    assert len(tr) == 2
    np.testing.assert_allclose(tr.positions[0], [1, 2, 3])
    np.testing.assert_allclose(tr.quaternions_wxyz[1], [0.7071, 0, 0, 0.7071])
    want = j_ds.read_tum_trajectory(str(p))
    for f in ("timestamps", "positions", "quaternions_wxyz"):
        np.testing.assert_array_equal(getattr(tr, f), getattr(want, f))


@pytest.mark.parametrize("max_dt", [0.02, 0.3])
def test_associate_timestamps(max_dt):
    ta = np.array([1.0, 2.0, 3.0])
    tb = np.array([1.01, 2.5, 3.005])
    ia, ib = t_ds.associate_timestamps(ta, tb, max_dt=0.02)
    np.testing.assert_array_equal(ia, [0, 2])
    np.testing.assert_array_equal(ib, [0, 2])
    rng = np.random.default_rng(3)
    ta = np.sort(rng.uniform(0, 5, 40))
    tb = np.sort(rng.uniform(0, 5, 30))
    for got, want in zip(t_ds.associate_timestamps(ta, tb, max_dt),
                         j_ds.associate_timestamps(ta, tb, max_dt)):
        np.testing.assert_array_equal(got, want)


def test_tum_sequence_windows(tmp_path):
    n = _write_tum_sequence(tmp_path)
    rgb, depth, gt = t_ds.read_tum_rgbd(str(tmp_path))
    assert len(rgb) == len(depth) == len(gt) == n
    seq = t_ds.TUMSequence(str(tmp_path), window=4, stride=2)
    ref = j_ds.TUMSequence(str(tmp_path), window=4, stride=2)
    assert len(seq) == len(ref) >= 2
    w0 = seq[0]
    assert w0["images"].shape[0] == 4 and w0["positions"].shape == (4, 3)
    np.testing.assert_allclose(w0["positions"][:, 0], [0.0, 0.1, 0.2, 0.3],
                               atol=1e-6)
    np.testing.assert_allclose(seq[1]["positions"][0, 0], 0.2, atol=1e-6)
    for i in range(len(seq)):
        got, want = seq[i], ref[i]
        assert got.keys() == want.keys()
        for k in got:
            assert isinstance(got[k], np.ndarray)
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    rgbseq = t_ds.TUMSequence(str(tmp_path), window=3, grayscale=False)
    np.testing.assert_array_equal(
        rgbseq[2]["images"],
        j_ds.TUMSequence(str(tmp_path), window=3, grayscale=False)[2][
            "images"])


def test_kitti_poses(tmp_path):
    rows = np.zeros((2, 12))
    rows[:, 0] = rows[:, 5] = rows[:, 10] = 1.0
    rows[1, 3] = 1.0
    np.savetxt(tmp_path / "00.txt", rows)
    R, t = t_ds.read_kitti_poses(str(tmp_path / "00.txt"))
    assert R.shape == (2, 3, 3) and t.shape == (2, 3)
    np.testing.assert_allclose(R[0], np.eye(3))
    np.testing.assert_allclose(t[1], [1, 0, 0])


def test_kitti_sequence(tmp_path):
    img_dir = tmp_path / "image_2"
    os.makedirs(img_dir)
    rng = np.random.default_rng(1)
    for i in range(5):
        _write_png(img_dir / f"{i:06d}.png",
                   (rng.random((6, 8, 3)) * 255).astype(np.uint8))
    rows = np.zeros((5, 12))
    rows[:, 0] = rows[:, 5] = rows[:, 10] = 1.0
    rows[:, 3] = np.arange(5)
    np.savetxt(tmp_path / "poses.txt", rows)
    seq = t_ds.KittiOdometrySequence(str(img_dir), str(tmp_path / "poses.txt"),
                                     window=3)
    ref = j_ds.KittiOdometrySequence(str(img_dir), str(tmp_path / "poses.txt"),
                                     window=3)
    assert len(seq) == len(ref) == 3
    w = seq[1]
    assert w["images"].shape[0] == 3
    np.testing.assert_allclose(w["t"][:, 0], [1, 2, 3])
    for k, v in ref[2].items():
        np.testing.assert_array_equal(seq[2][k], v, err_msg=k)
