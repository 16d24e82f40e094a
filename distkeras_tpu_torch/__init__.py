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
(:mod:`~distkeras_tpu_torch.networking`) — and the training path on the
collective backend — :mod:`~distkeras_tpu_torch.model`, the BASELINE zoo
(``models``), losses, metrics, :mod:`~distkeras_tpu_torch.optim`, the
merge rules and window engine (:mod:`~distkeras_tpu_torch.parallel`),
:mod:`~distkeras_tpu_torch.data`, :mod:`~distkeras_tpu_torch.datasets`,
the six trainers (:mod:`~distkeras_tpu_torch.trainers`), and the fused
Adam and LSTM-scan kernels — with the weight bridge
(:mod:`~distkeras_tpu_torch.convert`); the asynchronous parameter-server
backend (:mod:`~distkeras_tpu_torch.parameter_servers`,
:mod:`~distkeras_tpu_torch.workers`, ``parallel.compression``,
``observability.trace``); and the paper's user surface
(:mod:`~distkeras_tpu_torch.transformers`,
:mod:`~distkeras_tpu_torch.evaluators`,
:mod:`~distkeras_tpu_torch.predictors`, the MNIST example in
``examples``).
"""
