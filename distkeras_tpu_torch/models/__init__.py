"""The port's model zoo: the decoder-only LM the serving tier runs and its
training spec (:func:`transformer_lm_spec`), the encoder classifier
(:func:`transformer_classifier`, config 6), and the BASELINE training
models — :func:`mlp` (configs 1 and 4), :func:`lenet` (config 2),
:func:`vgg_small` (config 3) and :func:`lstm_classifier` (config 5)."""

from distkeras_tpu_torch.models.cnn import LeNet, VGGSmall, lenet, vgg_small
from distkeras_tpu_torch.models.lm import (
    TransformerLM,
    quantize_lm,
    transformer_lm,
    transformer_lm_spec,
)
from distkeras_tpu_torch.models.lstm import LSTMClassifier, lstm_classifier
from distkeras_tpu_torch.models.mlp import MLP, mlp
from distkeras_tpu_torch.models.transformer import (
    TransformerClassifier,
    transformer_classifier,
)

__all__ = ["TransformerLM", "transformer_lm", "transformer_lm_spec",
           "quantize_lm", "TransformerClassifier", "transformer_classifier",
           "MLP", "mlp", "LeNet", "lenet", "VGGSmall", "vgg_small",
           "LSTMClassifier", "lstm_classifier"]
