"""The attention UNets (3-D, conditional 3-D and 2-D), the toys' velocity MLP
and their building blocks."""

from flowtrain_stochastic_interpolation_torch.models.mlp import VelocityMLP
from flowtrain_stochastic_interpolation_torch.models.unet import UNet, UNet2D, UNet3D
from flowtrain_stochastic_interpolation_torch.models.unet_cond import UNet3DCond

# the reference's name, as the JAX package exports it
Unet2D = UNet2D

__all__ = ["UNet", "UNet2D", "UNet3D", "UNet3DCond", "Unet2D", "VelocityMLP"]
