"""PyTorch port of ``flowtrain_stochastic_interpolation_tpu`` for NVIDIA Hopper.

The JAX package beside this one is the reference: every module here keeps the
name of its counterpart there and is tested against it. This package imports
``torch`` and never JAX, Flax or anything of the JAX package.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with no
card and no explicit CPU request they raise (:func:`device.resolve_device`).
Public tensors are channels-last ``[B, X, Y, Z, C]``, as in the JAX package.
"""

__version__ = "0.1.0"
