"""The MD-trajectory envelope (§4.5), a device copy of
``make_md_trajectory``: a Markov jump process over ``n_states`` metastable
reference structures of 3 * ``n_atoms`` coordinates (N(0, 1)); at each
frame the state jumps with probability 1 / ``dwell`` to a uniform state,
and a frame is its state's structure plus N(0, ``noise``) on every
coordinate. The structures and a chain of ``n_frames`` frames come from
``seed``; a chain of ``n_test`` held-out frames of the same process from
``test_seed``. A chain is drawn vectorised: jump times and jump targets at
once, the state at each frame the target of the last jump at or before it
(state 0 before the first, as the numpy copy starts)."""
from __future__ import annotations

import torch

from . import CHUNK, Data, generator


def chain(g: torch.Generator, refs: torch.Tensor, n: int, p: dict, device):
    k, d = refs.shape
    jump = torch.rand((n,), generator=g, device=device) < 1.0 / p["dwell"]
    target = torch.randint(0, k, (n,), generator=g, device=device)
    t = torch.arange(n, device=device)
    last = torch.cummax(torch.where(jump, t, -1), dim=0).values
    y = torch.where(last >= 0, target[last.clamp(min=0)],
                    torch.zeros_like(target))
    x = torch.empty((n, d), dtype=torch.float32, device=device)
    for s in range(0, n, CHUNK):
        e = min(s + CHUNK, n)
        x[s:e] = refs[y[s:e]] + p["noise"] * torch.randn(
            (e - s, d), generator=g, device=device)
    return x, y


def make(p: dict, seed: int, device, test_seed: int) -> Data:
    g = generator(seed, device)
    refs = torch.randn((p["n_states"], 3 * p["n_atoms"]), generator=g,
                       device=device)
    x, y = chain(g, refs, p["n_frames"], p, device)
    x_test, y_test = chain(generator(test_seed, device), refs, p["n_test"],
                           p, device)
    return Data(x=x, y=y, x_test=x_test, y_test=y_test)
