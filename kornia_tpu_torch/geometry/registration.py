"""Direct photometric image registration by gradient descent through the
warp (counterpart of ``kornia_tpu/geometry/registration.py``): a warp model
on normalized coordinates, fitted coarse to fine over a Gaussian pyramid
by Adam on the masked mean absolute difference.

The gradient comes from autograd through the warp (``homography_warp``'s
grid and sampling); the pyramid's ``pyrdown`` blurs run the fused blur
kernel on the card. An Adam step makes no host read. On the CPU a level
runs its steps as a Python loop; on the card one step is captured once as
a CUDA graph and replayed for every iteration, since a step is some 500
small kernels whose launches, not their device time, set its length. The
optimiser is optax's ``adam`` written out in float32 (``adam_update``):
the reference re-initialises it at each level.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..core.dtype import as_float
from ..ops.pyramid import build_pyramid
from ..core.linalg import inverse_3x3
from ..ops.warp import denormalize_homography, grid_sample, warp_grid

__all__ = ["Homography", "Similarity", "ImageRegistrator", "BaseModel",
           "AdamState", "adam_init", "adam_update"]


class BaseModel:
    """Base of the parametric warp models: `n_params`, `init_params()` and
    `matrix(params)`."""

    n_params = 0

    @staticmethod
    def init_params(device="cuda") -> torch.Tensor:
        raise NotImplementedError

    @staticmethod
    def matrix(params: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


class Homography(BaseModel):
    """8 degrees of freedom: I + dH, dH's last entry 0."""

    n_params = 8

    @staticmethod
    def init_params(device="cuda") -> torch.Tensor:
        return torch.zeros(8, device=device)

    @staticmethod
    def matrix(params: torch.Tensor) -> torch.Tensor:
        dH = torch.cat([params, params.new_zeros(1)]).reshape(3, 3)
        return torch.eye(3, dtype=params.dtype, device=params.device) + dH


class Similarity(BaseModel):
    """4 degrees of freedom: (angle, log scale, tx, ty)."""

    n_params = 4

    @staticmethod
    def init_params(device="cuda") -> torch.Tensor:
        return torch.zeros(4, device=device)

    @staticmethod
    def matrix(params: torch.Tensor) -> torch.Tensor:
        angle, log_scale, tx, ty = params.unbind()
        s = torch.exp(log_scale)
        c, sn = torch.cos(angle) * s, torch.sin(angle) * s
        zero, one = torch.zeros_like(c), torch.ones_like(c)
        return torch.stack([c, -sn, tx, sn, c, ty, zero, zero,
                            one]).reshape(3, 3)


class AdamState(NamedTuple):
    """optax's ``ScaleByAdamState``: the step count (int32) and the first
    and second moments."""

    count: torch.Tensor
    mu: torch.Tensor
    nu: torch.Tensor


def adam_init(params: torch.Tensor) -> AdamState:
    return AdamState(torch.zeros((), dtype=torch.int32, device=params.device),
                     torch.zeros_like(params), torch.zeros_like(params))


def adam_update(grad: torch.Tensor, state: AdamState, learning_rate: float,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8
                ) -> Tuple[torch.Tensor, AdamState]:
    """One step of ``optax.adam`` (eps_root 0), in its order of operations:
    (the update to add to the parameters, the new state). The bias
    corrections 1 - b**count are computed on the device in float32, as the
    reference computes them, so no host read is made."""
    mu = (1 - b1) * grad + b1 * state.mu
    nu = (1 - b2) * (grad * grad) + b2 * state.nu
    count = state.count + 1
    k = count.to(grad.dtype)
    mu_hat = mu / (1 - torch.pow(torch.full_like(k, b1), k))
    nu_hat = nu / (1 - torch.pow(torch.full_like(k, b2), k))
    update = mu_hat / (torch.sqrt(nu_hat) + eps)
    return -learning_rate * update, AdamState(count, mu, nu)


class ImageRegistrator:
    """Coarse-to-fine photometric alignment of `src` to `dst`."""

    def __init__(self, model_type: str = "homography",
                 num_iterations: int = 100, learning_rate: float = 1e-3,
                 pyramid_levels: int = 3, tolerance: float = 1e-4):
        self.model = Homography if model_type == "homography" else Similarity
        self.num_iterations = num_iterations
        self.learning_rate = learning_rate
        self.pyramid_levels = pyramid_levels

    def loss(self, params: torch.Tensor, src: torch.Tensor,
             dst: torch.Tensor) -> torch.Tensor:
        """Mean absolute difference of the warped `src` and `dst` over the
        pixels that the warp fills (a warped ones-image above 0.999). The
        ones-image is sampled as one more channel of `src` in the same
        ``grid_sample`` call (channels are sampled independently, so it is
        the reference's second ``homography_warp`` bit for bit)."""
        M = self.model.matrix(params)[None]
        grid = warp_grid(inverse_3x3(M.to(torch.float32)),
                         tuple(dst.shape[-2:]))
        C = src.shape[1]
        both = grid_sample(torch.cat([src, torch.ones_like(src)], dim=1),
                           grid.expand(src.shape[0], *grid.shape[1:]))
        keep = both[:, C:].detach() > 0.999
        diff = (both[:, :C] - dst) * keep
        return diff.abs().sum() / keep.sum().clamp_min(1).to(diff.dtype)

    def _step(self, params: torch.Tensor, state: AdamState,
              src: torch.Tensor, dst: torch.Tensor
              ) -> Tuple[torch.Tensor, AdamState]:
        """One Adam step: the loss's gradient by autograd, then the
        update."""
        p = params.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(self.loss(p, src, dst), p)
        update, state = adam_update(g, state, self.learning_rate)
        return p.detach() + update, state

    def run_level(self, params: torch.Tensor, src: torch.Tensor,
                  dst: torch.Tensor, state: Optional[AdamState] = None,
                  num_iterations: Optional[int] = None,
                  cuda_graph: bool = True
                  ) -> Tuple[torch.Tensor, AdamState]:
        """`num_iterations` (default the registrator's) Adam steps on one
        pyramid level, from `state` (default a fresh one, as each level of
        `register` starts): (params, state). On CUDA tensors the steps
        replay one captured CUDA graph unless `cuda_graph` is False."""
        params = params.detach()
        state = adam_init(params) if state is None else state
        n = self.num_iterations if num_iterations is None else num_iterations
        if params.is_cuda and cuda_graph and n > 0:
            return self._run_level_graph(params, src, dst, state, n)
        for _ in range(n):
            params, state = self._step(params, state, src, dst)
        return params, state

    def _run_level_graph(self, params, src, dst, state, n):
        """The steps as replays of one CUDA graph over static copies of
        the parameters and the state: two steps on a side stream warm up
        the allocator (their result is then overwritten by the starting
        values), one is captured, and the graph replays `n` times."""
        static = [params.clone(), state.count.clone(), state.mu.clone(),
                  state.nu.clone()]
        start = [t.clone() for t in static]

        def step():
            p, st = self._step(static[0], AdamState(*static[1:]), src, dst)
            for t, v in zip(static, (p, st.count, st.mu, st.nu)):
                t.copy_(v)

        side = torch.cuda.Stream(params.device)
        side.wait_stream(torch.cuda.current_stream(params.device))
        with torch.cuda.stream(side):
            for _ in range(2):
                step()
        torch.cuda.current_stream(params.device).wait_stream(side)
        for t, v in zip(static, start):
            t.copy_(v)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            step()
        for _ in range(n):
            graph.replay()
        return static[0].clone(), AdamState(*(t.clone() for t in static[1:]))

    def register(self, src: torch.Tensor, dst: torch.Tensor,
                 verbose: bool = False) -> torch.Tensor:
        """M (1, 3, 3) in pixel coordinates such that
        warp_perspective(src, M) ≈ dst. The parameters live on normalized
        coordinates, where one learning rate suits translation and
        perspective alike, and carry from level to level."""
        src = as_float(src)
        dst = as_float(dst)
        params = self.model.init_params(src.device)
        pyr_src = build_pyramid(src, self.pyramid_levels)
        pyr_dst = build_pyramid(dst, self.pyramid_levels)
        for lvl in range(self.pyramid_levels - 1, -1, -1):
            params, _ = self.run_level(params, pyr_src[lvl], pyr_dst[lvl])
        M_ndc = self.model.matrix(params)[None]
        return denormalize_homography(M_ndc, tuple(src.shape[-2:]),
                                      tuple(dst.shape[-2:]))
