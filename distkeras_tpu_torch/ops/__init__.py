"""Kernels of the port: each module holds a hand-written CUDA kernel's
wrapper (launch on a CUDA tensor, or raise) beside its plain PyTorch
version (run on a CPU tensor); and the losses and metrics the trainers
name (``get_loss``, ``accuracy``)."""

from distkeras_tpu_torch.ops import losses, metrics
from distkeras_tpu_torch.ops.losses import get_loss
from distkeras_tpu_torch.ops.metrics import accuracy

__all__ = ["losses", "metrics", "get_loss", "accuracy"]
