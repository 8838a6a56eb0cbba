"""The 3-D attention UNets and their building blocks."""

from flowtrain_stochastic_interpolation_torch.models.unet import UNet, UNet3D
from flowtrain_stochastic_interpolation_torch.models.unet_cond import UNet3DCond

__all__ = ["UNet", "UNet3D", "UNet3DCond"]
