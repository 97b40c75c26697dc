"""Exact ray-traced renderer for textured planar scenes (counterpart of
``kornia_tpu/utils/render.py``): the rendered sequences with exact 6-DoF
ground truth that visual odometry and loop closure are measured on.

Per pixel, the ray meets every plane in closed form; the nearest hit inside
its rectangle wins and its texture is sampled bilinearly. The renderer also
returns the exact per-pixel depth. It runs on the device of the scene's
tensors; ``make_room_scene`` builds the scene on ``cuda`` unless the caller
passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..contrib.ops import diamond_square
from ..core.dtype import float32_on as _f32
from ..core.linalg import f32_precision
from ..ops.filters import motion_blur

__all__ = ["PlaneScene", "render_scene", "make_room_scene",
           "walk_trajectory", "orbit_trajectory", "render_sequence",
           "loop_trajectory", "degrade_sequence"]

Device = Union[str, torch.device]


@dataclasses.dataclass(frozen=True)
class PlaneScene:
    """A set of P textured rectangles.

    origins:  (P, 3) rectangle corner (world)
    edge_u:   (P, 3) edge spanning texture-u (full side length)
    edge_v:   (P, 3) edge spanning texture-v
    textures: (P, Ht, Wt) grayscale albedo in [0, 1]
    """

    origins: torch.Tensor
    edge_u: torch.Tensor
    edge_v: torch.Tensor
    textures: torch.Tensor


def render_scene(scene: PlaneScene, K: torch.Tensor, T_w2c: torch.Tensor,
                 height: int, width: int,
                 background: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Render one view. Returns (image (1, 1, H, W), z-depth (H, W)).

    T_w2c is the (4, 4) world→camera transform; pixels follow the usual
    +x right / +y down / +z forward pinhole convention.
    """
    dev = scene.origins.device
    K = _f32(K, dev)
    T_w2c = _f32(T_w2c, dev)
    with f32_precision():
        R = T_w2c[:3, :3]
        t = T_w2c[:3, 3]
        cam_center = -R.T @ t  # (3,)

        # per-pixel ray directions in world coords
        ys, xs = torch.meshgrid(
            torch.arange(height, dtype=K.dtype, device=dev),
            torch.arange(width, dtype=K.dtype, device=dev), indexing="ij")
        pix = torch.stack([xs, ys, torch.ones_like(xs)], -1)  # (H, W, 3)
        Kinv = torch.linalg.inv(K)
        d_cam = pix @ Kinv.T  # (H, W, 3), z-component == 1
        d_world = d_cam @ R  # R^T @ d per pixel

        o = scene.origins  # (P, 3)
        eu = scene.edge_u
        ev = scene.edge_v
        n = torch.linalg.cross(eu, ev)  # (P, 3) plane normal (unnormalized)

        # ray ∩ plane: s = dot(o - C, n) / dot(d, n); z-depth = s because
        # d_cam.z == 1
        denom = torch.einsum("hwk,pk->hwp", d_world, n)
        num = torch.einsum("pk,pk->p", o - cam_center[None], n)
        s = num[None, None, :] / torch.where(denom.abs() < 1e-12,
                                             math.inf, denom)  # (H, W, P)
        hit = cam_center[None, None, None] + s[..., None] \
            * d_world[:, :, None]
        rel = hit - o[None, None]  # (H, W, P, 3)
        # rectangle coords (a, b) via the dual basis (non-orthogonal edges)
        g11 = torch.einsum("pk,pk->p", eu, eu)
        g12 = torch.einsum("pk,pk->p", eu, ev)
        g22 = torch.einsum("pk,pk->p", ev, ev)
        det = g11 * g22 - g12 * g12
        ru = torch.einsum("hwpk,pk->hwp", rel, eu)
        rv = torch.einsum("hwpk,pk->hwp", rel, ev)
        a = (g22 * ru - g12 * rv) / det
        b = (g11 * rv - g12 * ru) / det

        valid = (s > 1e-4) & (a >= 0.0) & (a <= 1.0) & (b >= 0.0) \
            & (b <= 1.0)
        depth_all = torch.where(valid, s, math.inf)
        nearest = torch.argmin(depth_all, dim=-1)  # (H, W)
        depth = torch.gather(depth_all, -1, nearest[..., None])[..., 0]
        any_hit = torch.isfinite(depth)

        # bilinear texture sample on the winning plane
        Ht, Wt = scene.textures.shape[-2:]
        a_w = torch.gather(a, -1, nearest[..., None])[..., 0]
        b_w = torch.gather(b, -1, nearest[..., None])[..., 0]
        u = a_w.clamp(0.0, 1.0) * (Wt - 1)
        v = b_w.clamp(0.0, 1.0) * (Ht - 1)
        u0 = torch.floor(u).to(torch.int64).clamp(0, Wt - 2)
        v0 = torch.floor(v).to(torch.int64).clamp(0, Ht - 2)
        fu = u - u0
        fv = v - v0

        def sample(dy, dx):
            return scene.textures[nearest, v0 + dy, u0 + dx]

        c00 = sample(0, 0)
        c01 = sample(0, 1)
        c10 = sample(1, 0)
        c11 = sample(1, 1)
        color = ((1 - fv) * ((1 - fu) * c00 + fu * c01)
                 + fv * ((1 - fu) * c10 + fu * c11))
        img = torch.where(any_hit, color, background)
        depth = torch.where(any_hit, depth, 0.0)
    return img[None, None], depth


def _fractal_texture(generator: Optional[torch.Generator], size: int,
                     contrast: float = 1.0, *,
                     draws: Optional[Tuple[Sequence[torch.Tensor],
                                           torch.Tensor]] = None,
                     device: Device = "cuda") -> torch.Tensor:
    """Multi-octave fractal texture in [0, 1] with rich corner content.
    `draws`: the plasma's uniform draws (``diamond_square``'s) and the
    (8, 8) uniform block values."""
    base = diamond_square((1, 1, size, size), roughness=0.6,
                          generator=generator,
                          draws=None if draws is None else draws[0],
                          device=device)[0, 0]
    # superpose a blocky layer: hard edges → strong, localizable corners
    cells = 8
    blocks = (_f32(draws[1], device) if draws is not None else
              torch.rand((cells, cells), generator=generator, device=device))
    reps = size // cells + 1
    blocky = torch.kron(blocks, torch.ones((reps, reps), device=device))[
        :size, :size]
    tex = 0.6 * base + 0.4 * blocky
    tex = 0.5 + contrast * (tex - tex.mean())
    return tex.clamp(0.02, 0.98)


def make_room_scene(generator: Optional[torch.Generator] = None,
                    tex_size: int = 256,
                    room: Tuple[float, float, float] = (6.0, 4.0, 10.0),
                    n_boxes: int = 2, *,
                    draws: Optional[Sequence] = None,
                    device: Device = "cuda") -> PlaneScene:
    """A textured room (4 walls, floor, ceiling) with free-standing textured
    boxes providing multi-depth parallax. Room spans x∈[-W/2, W/2],
    y∈[-H/2, H/2] (y down), z∈[0, D]; cameras travel along +z.

    Textures draw from `generator` (None: a generator seeded with 7, as
    the reference's default key) plane by plane, or take `draws`, one
    ``_fractal_texture`` draw pair per plane."""
    if generator is None and draws is None:
        generator = torch.Generator(device=device).manual_seed(7)
    W, H, D = room
    planes: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []

    def rect(origin, eu, ev):
        planes.append((np.asarray(origin, np.float32),
                       np.asarray(eu, np.float32),
                       np.asarray(ev, np.float32)))

    # walls: left (x=-W/2), right (x=+W/2), far (z=D), floor (y=H/2), ceil
    rect([-W / 2, -H / 2, 0], [0, 0, D], [0, H, 0])       # left
    rect([W / 2, -H / 2, 0], [0, 0, D], [0, H, 0])        # right
    rect([-W / 2, -H / 2, D], [W, 0, 0], [0, H, 0])       # far wall
    rect([-W / 2, H / 2, 0], [W, 0, 0], [0, 0, D])        # floor
    rect([-W / 2, -H / 2, 0], [W, 0, 0], [0, 0, D])       # ceiling
    # free-standing boxes (front + side faces)
    rng = np.random.default_rng(3)
    for i in range(n_boxes):
        cx = float(rng.uniform(-W / 4, W / 4))
        cz = float(rng.uniform(0.35 * D, 0.75 * D))
        w = float(rng.uniform(0.6, 1.2))
        h = float(rng.uniform(0.8, 1.6))
        rect([cx - w / 2, H / 2 - h, cz], [w, 0, 0], [0, h, 0])  # front face
        rect([cx - w / 2, H / 2 - h, cz], [0, 0, w], [0, h, 0])  # left face
        rect([cx + w / 2, H / 2 - h, cz], [0, 0, w], [0, h, 0])  # right face

    P = len(planes)
    if draws is not None and len(draws) != P:
        raise ValueError(f"draws must hold {P} texture draws, got "
                         f"{len(draws)}")
    textures = torch.stack([
        _fractal_texture(generator, tex_size,
                         draws=None if draws is None else draws[i],
                         device=device) for i in range(P)])
    return PlaneScene(
        origins=_f32(np.stack([p[0] for p in planes]), device),
        edge_u=_f32(np.stack([p[1] for p in planes]), device),
        edge_v=_f32(np.stack([p[2] for p in planes]), device),
        textures=textures)


def _look_rotation(yaw: float, pitch: float = 0.0) -> np.ndarray:
    """world→camera rotation for a camera yawed/pitched from +z."""
    cy, sy = math.cos(yaw), math.sin(yaw)
    cp, sp = math.cos(pitch), math.sin(pitch)
    R_yaw = np.array([[cy, 0, -sy], [0, 1, 0], [sy, 0, cy]])
    R_pitch = np.array([[1, 0, 0], [0, cp, sp], [0, -sp, cp]])
    return (R_pitch @ R_yaw).astype(np.float32)


def walk_trajectory(n_frames: int, depth: float = 10.0,
                    lateral: float = 0.8, yaw_amp: float = 0.12,
                    pitch_amp: float = 0.05) -> np.ndarray:
    """TUM-style handheld forward walk: advance along +z with sinusoidal
    lateral sway and gentle yaw/pitch. Returns (N, 4, 4) world→camera."""
    Ts = []
    for i in range(n_frames):
        s = i / max(n_frames - 1, 1)
        pos = np.array([lateral * math.sin(2.5 * math.pi * s),
                        0.25 * math.sin(1.5 * math.pi * s),
                        0.15 * depth + 0.55 * depth * s], np.float32)
        R = _look_rotation(yaw_amp * math.sin(3.0 * math.pi * s),
                           pitch_amp * math.sin(2.0 * math.pi * s))
        t = (-R @ pos).astype(np.float32)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R
        T[:3, 3] = t
        Ts.append(T)
    return np.stack(Ts)


def orbit_trajectory(n_frames: int, radius: float = 2.0,
                     center_z: float = 6.0, sweep: float = 0.9
                     ) -> np.ndarray:
    """ETH3D-style inward-looking arc around a fixation point."""
    Ts = []
    for i in range(n_frames):
        ang = (-sweep / 2 + sweep * i / max(n_frames - 1, 1))
        pos = np.array([radius * math.sin(ang), 0.0,
                        center_z - radius * math.cos(ang)], np.float32)
        R = _look_rotation(-ang)
        t = (-R @ pos).astype(np.float32)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R
        T[:3, 3] = t
        Ts.append(T)
    return np.stack(Ts)


def render_sequence(scene: PlaneScene, K: torch.Tensor,
                    trajectory: np.ndarray, height: int, width: int
                    ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Render every pose in (N, 4, 4) on the scene's device. Returns
    (frames, depths); frames are (1, 1, H, W) in [0, 1]."""
    frames, depths = [], []
    for T in trajectory:
        img, depth = render_scene(scene, K, T, height, width)
        frames.append(img)
        depths.append(depth)
    return frames, depths


def loop_trajectory(n_frames: int, rx: float = 1.6, rz: float = 3.2,
                    center_z: float = 5.0, sway: float = 0.08
                    ) -> np.ndarray:
    """Closed circuit inside the room: the camera walks an ellipse in the
    x-z plane, heading along the path tangent (full 360° yaw sweep), and
    returns to its start pose — the canonical loop-closure trajectory
    (frame N-1 revisits frame 0's view). Returns (N, 4, 4) world→camera."""
    Ts = []
    for i in range(n_frames):
        ang = 2.0 * math.pi * i / max(n_frames - 1, 1)
        pos = np.array([rx * math.sin(ang),
                        sway * math.sin(3.0 * ang),
                        center_z - rz * math.cos(ang)], np.float32)
        tx, tz = rx * math.cos(ang), rz * math.sin(ang)
        yaw = math.atan2(tx, tz)
        R = _look_rotation(yaw, 0.04 * math.sin(2.0 * ang))
        t = (-R @ pos).astype(np.float32)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R
        T[:3, 3] = t
        Ts.append(T)
    return np.stack(Ts)


def degrade_sequence(frames: List[torch.Tensor],
                     generator: Optional[torch.Generator],
                     exposure_amp: float = 0.25, noise_sigma: float = 0.01,
                     blur_frac: float = 0.3, blur_kernel: int = 5, *,
                     draws: Optional[dict] = None) -> List[torch.Tensor]:
    """Photometric nuisance model for rendered sequences: smooth exposure
    drift (random-walk log-gain), per-frame Gaussian sensor noise, and
    directional motion blur on a random subset of frames.

    The draws come from `generator` (on the frames' device), or are
    injected as `draws`: ``gain`` (N,) standard normals, ``blur`` (N,)
    uniforms, ``angle`` (N,) angles in degrees and ``noise`` (N, *frame
    shape) standard normals."""
    n = len(frames)
    dev = frames[0].device
    if draws is None:
        shape = (n,) + tuple(frames[0].shape)
        draws = dict(gain=torch.randn(n, generator=generator, device=dev),
                     blur=torch.rand(n, generator=generator, device=dev),
                     angle=torch.rand(n, generator=generator, device=dev)
                     * 180.0,
                     noise=torch.randn(shape, generator=generator,
                                       device=dev))
    steps = _f32(draws["gain"], dev) * (exposure_amp / max(n ** 0.5, 1))
    log_gain = torch.cumsum(steps, 0)
    log_gain = log_gain - log_gain.mean()
    gains = torch.exp(log_gain.clamp(-exposure_amp, exposure_amp))
    blur_mask = (_f32(draws["blur"], "cpu") < blur_frac).tolist()
    angles = _f32(draws["angle"], dev)
    noise = _f32(draws["noise"], dev)
    out = []
    for i, f in enumerate(frames):
        img = f * gains[i]
        if blur_mask[i]:
            img = motion_blur(img, blur_kernel, angles[i][None])
        img = (img + noise_sigma * noise[i]).clamp(0.0, 1.0)
        out.append(img)
    return out
