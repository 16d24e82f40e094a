"""The port's model zoo: the decoder-only LM the serving tier runs, its
dense-cache decoding (:func:`generate`, :func:`speculative_generate`,
:func:`beam_search`) and its training spec (:func:`transformer_lm_spec`,
with :func:`next_token_dataset` for its columns),
the encoder classifier
(:func:`transformer_classifier`, config 6), the BASELINE training
models — :func:`mlp` (configs 1 and 4), :func:`lenet` (config 2),
:func:`vgg_small` (config 3) and :func:`lstm_classifier` (config 5) — and
the model families beyond them: :func:`resnet_small` (BatchNorm state,
optionally synchronized over the stacked workers), :func:`sru_classifier`
and :func:`moe_transformer_classifier` (with :func:`moe_aux_loss`); the
classifier's forwards over a mesh (:func:`pipelined_transformer_forward`,
:func:`sequence_parallel_transformer_forward`); and the AFMoE LM
(:class:`AfmoeLM`, :func:`afmoe_lm_spec`: windowed and full gated GQA,
dropless sigmoid-routed experts)."""

from distkeras_tpu_torch.models.afmoe import AfmoeLM, afmoe_lm_spec
from distkeras_tpu_torch.models.cnn import LeNet, VGGSmall, lenet, vgg_small
from distkeras_tpu_torch.models.lm import (
    TransformerLM,
    beam_search,
    generate,
    next_token_dataset,
    quantize_lm,
    quantize_state_dict,
    speculative_generate,
    transformer_lm,
    transformer_lm_spec,
)
from distkeras_tpu_torch.models.lstm import LSTMClassifier, lstm_classifier
from distkeras_tpu_torch.models.mlp import MLP, mlp
from distkeras_tpu_torch.models.moe import (
    MoETransformerClassifier,
    moe_aux_loss,
    moe_transformer_classifier,
)
from distkeras_tpu_torch.models.resnet import ResNetSmall, resnet_small
from distkeras_tpu_torch.models.sru import SRUClassifier, sru_classifier
from distkeras_tpu_torch.models.transformer import (
    TransformerClassifier,
    pipelined_transformer_forward,
    sequence_parallel_transformer_forward,
    transformer_classifier,
)

__all__ = ["TransformerLM", "transformer_lm", "transformer_lm_spec",
           "quantize_lm", "quantize_state_dict", "generate",
           "speculative_generate", "beam_search", "next_token_dataset",
           "TransformerClassifier", "transformer_classifier",
           "pipelined_transformer_forward",
           "sequence_parallel_transformer_forward",
           "MLP", "mlp", "LeNet", "lenet", "VGGSmall", "vgg_small",
           "LSTMClassifier", "lstm_classifier", "ResNetSmall",
           "resnet_small", "SRUClassifier", "sru_classifier",
           "MoETransformerClassifier", "moe_transformer_classifier",
           "moe_aux_loss", "AfmoeLM", "afmoe_lm_spec"]
