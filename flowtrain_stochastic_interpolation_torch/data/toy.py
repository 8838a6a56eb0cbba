"""Toy distributions of the 2-D experiments.

Port of ``flowtrain_stochastic_interpolation_tpu/data/toy.py``: a 2-D Gaussian
through an explicit Cholesky factor (:class:`Gaussian2d`), the 60/40
two-component mixture (:class:`GaussianMixed`), the procedural image
distribution (:func:`synthetic_images`) and, with torchvision, FashionMNIST
and CIFAR-10 scaled to ±1 (:func:`get_fashion_mnist`, :func:`get_cifar10`;
``None`` without it).

Each random draw is split from its deterministic part, as in
:mod:`ops.masks`: the draws come from an explicit ``torch.Generator`` on the
distribution's device (:meth:`Gaussian2d.draw`, :meth:`GaussianMixed.draw`,
:func:`image_draws`), and :meth:`Gaussian2d.transform`,
:meth:`GaussianMixed.combine` and :func:`images_from_draws` take them (or the
JAX package's own draws) as arguments. Devices follow the port's rule: ``cuda``
unless the caller names another.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from flowtrain_stochastic_interpolation_torch.device import resolve_device


class Gaussian2d:
    """``mean + z @ chol.T`` with ``z ~ N(0, I)``."""

    def __init__(self, mean=(0.0, 0.0), chol=((1.0, 0.0), (0.3, 0.8)), device=None):
        dev = resolve_device(device)
        self.mean = torch.tensor(mean, dtype=torch.float32, device=dev)
        self.chol = torch.tensor(chol, dtype=torch.float32, device=dev)

    def draw(self, generator: torch.Generator, n: int) -> torch.Tensor:
        return torch.randn((n, 2), generator=generator, device=self.mean.device)

    def transform(self, z: torch.Tensor) -> torch.Tensor:
        return self.mean + z @ self.chol.T

    def sample(self, generator: torch.Generator, n: int) -> torch.Tensor:
        return self.transform(self.draw(generator, n))

    @property
    def covariance(self) -> torch.Tensor:
        return self.chol @ self.chol.T


class GaussianMixed:
    """A mixture of :class:`Gaussian2d` components picked with ``weights``
    (60/40 by default, means (-2, -2) and (2, 2)); its mean is (-0.4, -0.4)."""

    def __init__(self, means=((-2.0, -2.0), (2.0, 2.0)),
                 chols=(((1.0, 0.0), (0.0, 0.6)), ((0.7, 0.0), (0.2, 1.0))),
                 weights=(0.6, 0.4), device=None):
        self.components = [Gaussian2d(m, c, device) for m, c in zip(means, chols)]
        self.weights = torch.tensor(weights, dtype=torch.float32,
                                    device=self.components[0].mean.device)

    def draw(self, generator: torch.Generator, n: int):
        """``(picks [n] int64, z [n_components, n, 2])``."""
        picks = torch.multinomial(self.weights, n, replacement=True, generator=generator)
        z = torch.stack([c.draw(generator, n) for c in self.components])
        return picks, z

    def combine(self, picks: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        """Each sample from the component it picked: every component transforms
        its own draws, then ``picks`` chooses among them."""
        samples = torch.stack([c.transform(zc) for c, zc in zip(self.components, z)])
        return samples[picks, torch.arange(picks.shape[0], device=picks.device)]

    def sample(self, generator: torch.Generator, n: int) -> torch.Tensor:
        return self.combine(*self.draw(generator, n))


def get_fashion_mnist(root: str = "./data", train: bool = True) -> Optional[np.ndarray]:
    """FashionMNIST padded to 32×32, scaled to ±1, channels-last ``[N, 32, 32, 1]``;
    ``None`` without torchvision."""
    try:
        from torchvision import datasets  # type: ignore
    except ImportError:
        return None
    ds = datasets.FashionMNIST(root=root, train=train, download=True)
    imgs = ds.data.numpy().astype(np.float32) / 255.0
    imgs = np.pad(imgs, ((0, 0), (2, 2), (2, 2)))
    return (imgs * 2.0 - 1.0)[..., None]


def get_cifar10(root: str = "./data", train: bool = True) -> Optional[np.ndarray]:
    """CIFAR-10 scaled to ±1, channels-last ``[N, 32, 32, 3]``; ``None`` without
    torchvision."""
    try:
        from torchvision import datasets  # type: ignore
    except ImportError:
        return None
    ds = datasets.CIFAR10(root=root, train=train, download=True)
    imgs = np.asarray(ds.data, dtype=np.float32) / 255.0
    return imgs * 2.0 - 1.0


# the draws of synthetic_images: name -> (shape after n, low, high)
IMAGE_DRAWS = {
    "theta": ((1, 1), 0.0, 2.0 * math.pi),
    "circle_center": ((2, 1, 1), 0.25, 0.75),
    "circle_radius": ((1, 1), 0.10, 0.25),
    "circle_intensity": ((1, 1), -1.0, 1.0),
    "square_center": ((2, 1, 1), 0.25, 0.75),
    "square_half_width": ((1, 1), 0.08, 0.20),
    "square_intensity": ((1, 1), -1.0, 1.0),
}


def image_draws(generator: torch.Generator, n: int) -> Dict[str, torch.Tensor]:
    """The uniform draws of ``n`` procedural images (:data:`IMAGE_DRAWS`)."""
    out = {}
    for name, (shape, low, high) in IMAGE_DRAWS.items():
        u = torch.rand((n, *shape), generator=generator, device=generator.device)
        out[name] = low + u * (high - low)
    return out


def images_from_draws(draws: Dict[str, torch.Tensor], size: int) -> torch.Tensor:
    """``[n, size, size, 1]`` images in [-1, 1] from :func:`image_draws`: a linear
    intensity gradient at the angle ``theta``, a filled circle over it and an
    axis-aligned filled square over both."""
    theta = draws["theta"]
    coord = (torch.arange(size, dtype=torch.float32, device=theta.device) + 0.5) / size
    yy, xx = coord[:, None], coord[None, :]
    bg = 0.5 * ((xx - 0.5)[None] * torch.cos(theta) + (yy - 0.5)[None] * torch.sin(theta)) * 2.0
    ccy, ccx = draws["circle_center"].unbind(1)
    circle = (xx[None] - ccx) ** 2 + (yy[None] - ccy) ** 2 <= draws["circle_radius"] ** 2
    img = torch.where(circle, draws["circle_intensity"], bg)
    scy, scx = draws["square_center"].unbind(1)
    sh = draws["square_half_width"]
    square = ((xx[None] - scx).abs() <= sh) & ((yy[None] - scy).abs() <= sh)
    img = torch.where(square, draws["square_intensity"], img)
    return img.clamp(-1.0, 1.0)[..., None]


def synthetic_images(generator: torch.Generator, n: int, size: int = 32) -> torch.Tensor:
    """``n`` procedural ``[size, size, 1]`` images on the generator's device: the
    image toy's distribution where no image dataset can be read."""
    return images_from_draws(image_draws(generator, n), size)
