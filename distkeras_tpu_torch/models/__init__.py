"""The port's model zoo: so far the decoder-only LM the serving tier runs."""

from distkeras_tpu_torch.models.lm import (
    TransformerLM,
    quantize_lm,
    transformer_lm,
)

__all__ = ["TransformerLM", "transformer_lm", "quantize_lm"]
