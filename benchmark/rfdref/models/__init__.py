"""Torch models of ISCNet, in train and eval mode (torch's module mode)."""

from .iscnet import ISCNet

__all__ = ["ISCNet"]
