"""Tensor ops: simplex embedding and the folded linear-attention kernels."""
