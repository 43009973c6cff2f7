"""LM serving launcher: ``python -m repro_torch.launch.serve --arch <id>``.

Runs the continuous-batching engine (``repro_torch.serving``) on the
reference launcher's synthetic request stream (``repro/launch/serve.py``:
prompt lengths and tokens from ``np.random.default_rng(0)``, parameters
from seed 0) and prints the same summary line. ``--device`` defaults to the
GPU; ``--device cpu`` runs the plain PyTorch path. ``--assign`` (frozen
clustering artifacts), ``--mesh`` and ``--obs`` wait for ROADMAP Queue 1
items 7, 8 and 10.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.models import get_model
from repro_torch.serving import (ServeConfig, ServingEngine, greedy,
                                 sample_top_p)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, help="LM-zoo arch id")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's small smoke config")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, raising without one)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--top-p", type=float, default=0.0,
                    help="0 -> greedy; else nucleus sampling")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch, smoke=args.smoke)
    api = get_model(cfg, device=args.device)
    params = api.init(0)

    sampler = greedy if args.top_p <= 0 else \
        (lambda logits, gen: sample_top_p(logits, gen, top_p=args.top_p))
    eng = ServingEngine(api, params, ServeConfig(
        max_batch=args.max_batch, max_len=args.max_len,
        max_new_tokens=args.max_new_tokens, eos_token=-1), sampler=sampler,
        device=api.device)

    rng = np.random.default_rng(0)
    lens = rng.integers(2, args.prompt_len + 1, size=args.requests)
    for n in lens:
        eng.submit(rng.integers(1, cfg.vocab_size, size=int(n)))

    t0 = time.time()
    results = eng.run()
    if api.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.time() - t0
    n_tokens = sum(len(v) for v in results.values())
    print(f"[serve] {args.arch}: {len(results)} requests, "
          f"{n_tokens} tokens in {dt:.2f}s "
          f"({n_tokens/dt:.1f} tok/s, {eng.ticks} batched ticks)")
    return results


if __name__ == "__main__":
    main()
