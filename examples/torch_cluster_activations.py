"""LM-integration example of the PyTorch port: cluster a model's hidden
states with the paper's kernel k-means, the analogue of the paper's
MD-frame clustering (conformational frames -> activation vectors; both
need no explicit feature-space geometry, only a kernel).

    PYTHONPATH=src python examples/torch_cluster_activations.py  # the card
    PYTHONPATH=src python examples/torch_cluster_activations.py \\
        --arch rwkv6-7b --device cpu

The port of ``examples/cluster_activations.py``. A model of the zoo (its
smoke config, parameters from seed 0) embeds token sequences drawn from C
synthetic "topics" (``topic_stream``, the reference's numpy draws); the
mean-pooled final hidden state of each sequence (``models.{rwkv, zamba,
transformer}.forward``) is a sample, and ``fit_dataset`` / ``predict``
recover the topics without labels. ``main`` returns the printed numbers.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.core import (KernelSpec, MiniBatchConfig,
                              clustering_accuracy, gamma_from_dmax, nmi)
from repro_torch.core.minibatch import fit_dataset, predict
from repro_torch.models import get_model


def topic_stream(vocab: int, n_topics: int, n_seqs: int, seq_len: int,
                 seed: int = 0):
    """Each topic draws tokens from its own narrow vocabulary band."""
    rng = np.random.default_rng(seed)
    width = max(vocab // (2 * n_topics), 4)
    tokens = np.empty((n_seqs, seq_len), np.int32)
    topics = rng.integers(0, n_topics, n_seqs)
    for i, t in enumerate(topics):
        lo = 1 + t * width
        tokens[i] = rng.integers(lo, lo + width, seq_len)
    return tokens, topics.astype(np.int32)


def features(params, tokens: np.ndarray, cfg, device, *,
             chunk: int = 64) -> np.ndarray:
    """The mean-pooled final hidden state [n, D] f32 of each sequence, in
    chunks of ``chunk`` sequences."""
    if cfg.family == "ssm":
        from repro_torch.models.rwkv import forward
    elif cfg.family == "hybrid":
        from repro_torch.models.zamba import forward
    elif cfg.family in ("dense", "moe"):
        from repro_torch.models.transformer import forward
    else:
        raise ValueError(f"{cfg.name}: the {cfg.family} family has no "
                         f"token-only forward")
    out = []
    with torch.no_grad():
        for i in range(0, len(tokens), chunk):
            tok = torch.as_tensor(tokens[i:i + chunk], dtype=torch.long,
                                  device=device)
            hidden = forward(params, tok, cfg, remat=False)[0]
            out.append(hidden.to(torch.float32).mean(dim=1).cpu().numpy())
    return np.concatenate(out)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv6-7b")
    ap.add_argument("--topics", type=int, default=5)
    ap.add_argument("--seqs", type=int, default=512)
    ap.add_argument("--seq-len", type=int, default=32)
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, raising without one)")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch, smoke=True)
    api = get_model(cfg, device=args.device)
    params = api.init(0)
    tokens, topics = topic_stream(cfg.vocab_size, args.topics, args.seqs,
                                  args.seq_len)
    print(f"[activations] embedding {args.seqs} sequences with "
          f"{args.arch} (smoke config) on {api.device}")
    x = features(params, tokens, cfg, api.device)
    print(f"[activations] features: {x.shape}")

    gamma = gamma_from_dmax(torch.as_tensor(x, device=api.device))
    cc = MiniBatchConfig(n_clusters=args.topics, n_batches=args.batches,
                         s=1.0, kernel=KernelSpec("rbf", gamma=gamma),
                         seed=0)
    res = fit_dataset(x, cc, device=api.device)
    labels = predict(x, res.state.medoids, res.state.medoid_diag,
                     spec=cc.kernel, device=api.device).cpu().numpy()
    out = {"acc": clustering_accuracy(topics, labels),
           "nmi": nmi(topics, labels)}
    print(f"[activations] kernel k-means over activations: "
          f"acc={out['acc']:.3f} nmi={out['nmi']:.3f} "
          f"(B={args.batches} mini-batches)")
    return out


if __name__ == "__main__":
    main()
