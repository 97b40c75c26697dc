"""Latent-diffusion dissolving, one reverse DDIM step (counterpart of
``kornia_tpu/models/diffusion.py``).

The scheduler is closed form (scaled-linear betas, ``alphas_cumprod`` a
table on the device); the dissolve encodes the image with a stride-8 VAE,
predicts the noise with an SD-shaped UNet (residual blocks with a time
embedding, self-attention at the lowest resolution), takes the x0
prediction and decodes it. The modules are ``nn.Module``s on NCHW tensors
whose weights are parameters that do not require grad; built without
parameters, each net draws them from a CPU generator seeded 0 (normal
with variance 1 / fan-in, zero biases), so they differ from the JAX
package's defaults, and ``convert.diffusion_from_numpy`` carries the JAX
parameters across (flax's HWIO kernels become OIHW). The timestep is chosen on the device: a
dissolve makes no host read.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..core.check import check
from ..core.dtype import as_float, true_div
from ..core.grid import linspace
from ..core.linalg import f32_matmul_precision
from .common import nchw_to_nhwc, nhwc_to_nchw, same_conv

__all__ = ["DDIMSchedule", "AutoencoderKL", "UNet2dCondition",
           "StableDiffusionDissolving", "DiffusionConfig"]

Device = Union[str, torch.device]

_LATENT_SCALE = 0.18215
_GROUPS = 8
_GN_EPS = 1e-6  # flax GroupNorm's epsilon


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    latent_channels: int = 4
    vae_channels: int = 32
    unet_channels: Sequence[int] = (32, 64, 64)
    num_train_timesteps: int = 1000
    num_ddim_steps: int = 50
    beta_start: float = 0.00085
    beta_end: float = 0.012

    @classmethod
    def sd15_like(cls) -> "DiffusionConfig":
        return cls(vae_channels=128, unet_channels=(320, 640, 1280))


class DDIMSchedule:
    """Scaled-linear beta schedule and the x0 prediction, as float32
    tables on `device`."""

    def __init__(self, num_train_timesteps: int = 1000,
                 num_ddim_steps: int = 50, beta_start: float = 0.00085,
                 beta_end: float = 0.012, device: Device = "cuda"):
        betas = linspace(beta_start ** 0.5, beta_end ** 0.5,
                             num_train_timesteps, device) ** 2
        self.alphas_cumprod = torch.cumprod(1.0 - betas, dim=0)
        self.num_train_timesteps = num_train_timesteps
        self.num_ddim_steps = num_ddim_steps
        step = num_train_timesteps // num_ddim_steps
        # diffusers' DDIM timesteps (descending), steps_offset = 1
        self.timesteps = (torch.arange(num_ddim_steps - 1, -1, -1,
                                       device=device,
                                       dtype=torch.int32) * step + 1)

    def predict_start_from_noise(self, noise_pred: torch.Tensor,
                                 t: torch.Tensor,
                                 latent: torch.Tensor) -> torch.Tensor:
        a = self.alphas_cumprod[torch.as_tensor(t).reshape(-1).long()
                                ].reshape(torch.as_tensor(t).shape)
        return (latent - torch.sqrt(1.0 - a) * noise_pred) / \
            torch.sqrt(a).clamp_min(1e-6)


def _time_embed(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * true_div(
        torch.arange(half, dtype=torch.float32, device=t.device), half))
    ang = t.to(torch.float32)[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1)


def _weight(shape) -> nn.Parameter:
    """A weight to be drawn by _draw_weights."""
    return nn.Parameter(torch.zeros(shape), requires_grad=False)


def _zeros(n: int) -> nn.Parameter:
    return nn.Parameter(torch.zeros(n), requires_grad=False)


class _Conv(nn.Module):
    """flax nn.Conv: 'SAME' padding (asymmetric at stride 2), bias."""

    def __init__(self, cin: int, cout: int, k: int, stride: int):
        super().__init__()
        self.stride = stride
        self.fan_in = cin * k * k
        self.weight = _weight((cout, cin, k, k))
        self.bias = _zeros(cout)

    def forward(self, x):
        return same_conv(x, self.weight, self.bias, self.stride)


class _ConvT(nn.Module):
    """flax nn.ConvTranspose (4x4, stride 2, 'SAME', kernel not
    transposed): torch's conv_transpose2d with padding 1 and the flax
    kernel flipped, held as (in, out, 4, 4)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.fan_in = cin * 16
        self.weight = _weight((cin, cout, 4, 4))
        self.bias = _zeros(cout)

    def forward(self, x):
        return F.conv_transpose2d(x, self.weight, self.bias, stride=2,
                                  padding=1)


class _Dense(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.fan_in = cin
        self.weight = _weight((cout, cin))
        self.bias = _zeros(cout)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class _GroupNorm(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c), requires_grad=False)
        self.bias = _zeros(c)

    def forward(self, x):
        return F.group_norm(x, _GROUPS, self.weight, self.bias, _GN_EPS)


class _ResBlock(nn.Module):
    def __init__(self, cin: int, cout: int, temb: int):
        super().__init__()
        self.norm0 = _GroupNorm(cin)
        self.conv0 = _Conv(cin, cout, 3, 1)
        self.dense = _Dense(temb, cout)
        self.norm1 = _GroupNorm(cout)
        self.conv1 = _Conv(cout, cout, 3, 1)
        self.skip = (_Conv(cin, cout, 1, 1) if cin != cout
                     else None)

    def forward(self, x, temb):
        h = self.conv0(F.silu(self.norm0(x)))
        h = h + self.dense(F.silu(temb))[:, :, None, None]
        h = self.conv1(F.silu(self.norm1(h)))
        return (x if self.skip is None else self.skip(x)) + h


class _SelfAttention2d(nn.Module):
    """Group norm, then flax's multi-head dot-product attention over the
    H·W positions (query, key, value and out projections with biases)."""

    def __init__(self, c: int, heads: int = 4):
        super().__init__()
        self.heads = heads
        self.norm = _GroupNorm(c)
        self.query = _Dense(c, c)
        self.key = _Dense(c, c)
        self.value = _Dense(c, c)
        self.out = _Dense(c, c)

    def forward(self, x):
        B, C, H, W = x.shape
        h = nchw_to_nhwc(self.norm(x)).reshape(B, H * W, C)

        def split(t):
            return t.reshape(B, H * W, self.heads, -1).transpose(1, 2)
        a = F.scaled_dot_product_attention(split(self.query(h)),
                                           split(self.key(h)),
                                           split(self.value(h)))
        a = self.out(a.transpose(1, 2).reshape(B, H * W, C))
        return x + nhwc_to_nchw(a.reshape(B, H, W, C))


def _draw_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Every conv and dense weight under `module`, in registration order,
    drawn normal with variance 1 / fan-in from `generator`."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (_Conv, _ConvT, _Dense)):
                m.weight.copy_(torch.randn(m.weight.shape,
                                           generator=generator)
                               / math.sqrt(m.fan_in))


class AutoencoderKL(nn.Module):
    """Compact SD-shaped VAE: a stride-8 encoder to latents and a
    decoder, on (B, 3, H, W) in [-1, 1]. `parent` and `name` are flax's
    module-tree arguments, accepted for the reference's signature and
    unused. Its weights are drawn from a CPU generator seeded 0."""

    def __init__(self, cfg: DiffusionConfig, parent=None,
                 name: Optional[str] = None):
        super().__init__()
        ch = cfg.vae_channels
        enc = [ch] + [ch * 2 ** i for i in range(3)]
        self.enc = nn.ModuleList(
            [_Conv(3, enc[0], 3, 1)]
            + [_Conv(enc[i], enc[i + 1], 3, 2) for i in range(3)])
        self.to_latent = _Conv(enc[-1], cfg.latent_channels, 1, 1)
        self.from_latent = _Conv(cfg.latent_channels, ch * 4, 3, 1)
        dec = [ch * 4] + [ch * 2 ** (2 - i) for i in range(3)]
        self.dec = nn.ModuleList([_ConvT(dec[i], dec[i + 1])
                                  for i in range(3)])
        self.to_rgb = _Conv(dec[-1], 3, 3, 1)
        _draw_weights(self, torch.Generator().manual_seed(0))

    def encode(self, x):
        h = x
        for c in self.enc:
            h = F.silu(c(h))
        return self.to_latent(h)  # (B, latent, H/8, W/8)

    def decode(self, z):
        h = F.silu(self.from_latent(z))
        for c in self.dec:
            h = F.silu(c(h))
        return self.to_rgb(h)  # (B, 3, H, W)

    def forward(self, x):
        return self.decode(self.encode(x))


class UNet2dCondition(nn.Module):
    """Compact SD-shaped noise-prediction UNet (down, middle with
    attention, up with skips). `parent` and `name` as AutoencoderKL's."""

    def __init__(self, cfg: DiffusionConfig, parent=None,
                 name: Optional[str] = None):
        super().__init__()
        chs = list(cfg.unet_channels)
        td = chs[0] * 4
        self.time_in = _Dense(td, td)
        self.time_out = _Dense(td, td)
        self.conv_in = _Conv(cfg.latent_channels, chs[0], 3, 1)
        self.down = nn.ModuleList()
        self.downsample = nn.ModuleList()
        c_prev = chs[0]
        for i, c in enumerate(chs):
            self.down.append(_ResBlock(c_prev, c, td))
            if i < len(chs) - 1:
                self.downsample.append(_Conv(c, c, 3, 2))
            c_prev = c
        self.mid0 = _ResBlock(chs[-1], chs[-1], td)
        self.attn = _SelfAttention2d(chs[-1])
        self.mid1 = _ResBlock(chs[-1], chs[-1], td)
        self.up = nn.ModuleList()
        self.upsample = nn.ModuleList()
        c_prev = chs[-1]
        for i, c in enumerate(reversed(chs)):
            self.up.append(_ResBlock(c_prev + c, c, td))
            if i < len(chs) - 1:
                self.upsample.append(_Conv(c, c, 3, 1))
            c_prev = c
        self.norm_out = _GroupNorm(chs[0])
        self.conv_out = _Conv(chs[0], cfg.latent_channels, 3, 1)
        _draw_weights(self, torch.Generator().manual_seed(0))

    def forward(self, z, t):
        temb = _time_embed(t, self.time_in.weight.shape[1])
        temb = self.time_out(F.silu(self.time_in(temb)))
        temb = temb.reshape(-1, temb.shape[-1]).expand(z.shape[0], -1)
        h = self.conv_in(z)
        skips = []
        for i, block in enumerate(self.down):
            h = block(h, temb)
            skips.append(h)
            if i < len(self.downsample):
                h = self.downsample[i](h)
        h = self.mid1(self.attn(self.mid0(h, temb)), temb)
        for i, block in enumerate(self.up):
            h = block(torch.cat([h, skips.pop()], dim=1), temb)
            if i < len(self.upsample):
                h = self.upsample[i](F.interpolate(h, scale_factor=2,
                                                   mode="nearest"))
        return self.conv_out(F.silu(self.norm_out(h)))


class _DissolveModel(nn.Module):
    def __init__(self, cfg: DiffusionConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.vae = AutoencoderKL(cfg)
        self.unet = UNet2dCondition(cfg)
        if generator is not None:  # each net drew from its own seed 0
            _draw_weights(self, generator)

    def forward(self, x, t, sqrt_a, sqrt_1ma):
        """The whole dissolve: encode, noise prediction, x0, decode."""
        z = self.vae.encode(x) * _LATENT_SCALE
        eps = self.unet(z, t)
        x0 = (z - sqrt_1ma * eps) / sqrt_a.clamp_min(1e-6)
        return self.vae.decode(x0 / _LATENT_SCALE)


class StableDiffusionDissolving:
    """One-step reverse-diffusion 'dissolve'.

    dissolve(image (B, 3, H, W) in [0, 1], step in [0, num_ddim_steps))
    -> (B, 3, H, W) in [0, 1]; H, W multiples of 8; `step` a number or a
    tensor on the image's device. The reference takes its timestep as
    ``num_ddim_steps - timesteps[step]`` (negative for all but the last
    steps, wrapped by torch's negative indexing): the modulo reproduces
    that. `params`: a module state dict (``convert.diffusion_from_numpy``
    builds one from the JAX parameters); `generator`: a CPU generator to
    draw the weights from without them (by default each net draws from
    its own, seeded 0)."""

    def __init__(self, cfg: Optional[DiffusionConfig] = None,
                 params: Optional[Mapping[str, torch.Tensor]] = None,
                 generator: Optional[torch.Generator] = None,
                 device: Device = "cuda"):
        self.cfg = cfg or DiffusionConfig()
        self.device = torch.device(device)
        self.schedule = DDIMSchedule(
            self.cfg.num_train_timesteps, self.cfg.num_ddim_steps,
            self.cfg.beta_start, self.cfg.beta_end, self.device)
        self.model = _DissolveModel(self.cfg, generator)
        if params is not None:
            self.model.load_state_dict(
                {k: torch.as_tensor(v) for k, v in params.items()})
        self.model.to(self.device)
        self.params = self.model.state_dict()

    @f32_matmul_precision
    def dissolve(self, image: torch.Tensor, step) -> torch.Tensor:
        B, C, H, W = image.shape
        check(C == 3, f"dissolve expects RGB (B, 3, H, W), got C={C}")
        check(H % 8 == 0 and W % 8 == 0,
              f"H, W must be multiples of 8, got {H}x{W}")
        x = as_float(image) * 2.0 - 1.0
        s = self.schedule
        if not torch.is_tensor(step):  # a fill, not a host copy
            step = torch.full((1,), int(step), device=s.timesteps.device)
        ts = s.timesteps.index_select(0, step.reshape(-1)[:1].long())
        t = torch.remainder(self.cfg.num_ddim_steps - ts,
                            self.cfg.num_train_timesteps)
        a = s.alphas_cumprod.index_select(0, t.long())[0]
        out = self.model(x, t[0], torch.sqrt(a), torch.sqrt(1.0 - a))
        return (out / 2.0 + 0.5).clamp(0.0, 1.0)

    __call__ = dissolve
