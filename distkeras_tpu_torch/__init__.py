"""PyTorch + CUDA port of ``distkeras_tpu``.

The JAX package stays the reference; this package grows beside it slice by
slice, with the same module paths, so each counterpart is found by name. It
imports ``torch`` and never JAX or anything of the JAX package. Every
kernel the JAX package wrote in Pallas becomes a hand-written CUDA kernel
here (``csrc/``, built with ``nvcc`` on first use); every entry point runs
on the card unless the caller passes ``device="cpu"``.

Ported so far: the serving path — :mod:`~distkeras_tpu_torch.models.lm`,
:mod:`~distkeras_tpu_torch.serving`, the int8 ``q_matmul`` and the
flash-attention forward kernels (``ops``), the framing
(:mod:`~distkeras_tpu_torch.networking`) and the weight bridge
(:mod:`~distkeras_tpu_torch.convert`).
"""
