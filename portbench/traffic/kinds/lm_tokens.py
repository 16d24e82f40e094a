"""``lm_tokens``: token rows of ``length + 1`` drawn uniformly from the
configuration's vocabulary → ``(features, label)``, each ``[lead, rows,
length]``, the label the next token."""

import torch


def columns(traffic: dict, config: dict, lead: int, rows: int, gen,
            device) -> tuple:
    vocab = int(config["kwargs"]["vocab"])
    L = int(traffic["length"])
    toks = torch.randint(0, vocab, (lead, rows, L + 1), generator=gen,
                         device=device).to(torch.int32)
    return toks[..., :-1].contiguous(), toks[..., 1:].contiguous()
