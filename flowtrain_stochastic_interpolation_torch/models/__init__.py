"""The 3-D attention UNet and its building blocks."""

from flowtrain_stochastic_interpolation_torch.models.unet import UNet, UNet3D

__all__ = ["UNet", "UNet3D"]
