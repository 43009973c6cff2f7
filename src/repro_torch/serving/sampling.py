"""Token samplers for the serving engine (f32 logits in, int32 tokens out;
the port of ``repro/serving/sampling.py``). Randomness comes from a
``torch.Generator``, so it does not match the reference's draws."""
from __future__ import annotations

import torch


def greedy(logits: torch.Tensor, generator=None) -> torch.Tensor:
    """argmax over the last dim; the lowest index wins a tie."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def sample_top_p(logits: torch.Tensor, generator: torch.Generator | None,
                 *, top_p: float = 0.9,
                 temperature: float = 1.0) -> torch.Tensor:
    """Nucleus sampling. logits: [B, V] -> [B] int32."""
    logits = logits / max(temperature, 1e-6)
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    # smallest prefix with cumulative mass >= top_p stays
    cutoff_idx = torch.sum(cum < top_p, dim=-1, keepdim=True)
    cutoff_idx = torch.clamp(cutoff_idx, max=logits.shape[-1] - 1)
    cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
    masked = torch.where(logits < cutoff, float("-inf"), logits)
    probs = torch.softmax(masked, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)
