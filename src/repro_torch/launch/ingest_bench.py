"""Time how a fit takes its batches onto the card: the plain per-batch copy
against ``BatchSource``'s pinned stage, on one card.

    python src/repro_torch/launch/ingest_bench.py --reps 3 --out FILE

For each setting (Tab.1 MNIST exact fused, B = 4, s = 0.2; Fig.5's RFF at
m = 320, B = 1; Tab.2's count sketch on the dense 256-d view, m = 128, B =
4) it runs, in turns (plain, staged, staged, plain, ...):

* ``plain``: ``fit`` over the list of host batches, each copied to the
  card by a blocking ``.to("cuda")`` from pageable memory (what
  ``fit_dataset`` does);
* ``prefetch1``: a ``BatchSource`` staging one batch ahead on a producer
  thread (pinned copy, copy stream; its default stage there);
* ``prefetch0``: a ``BatchSource`` running that pinned stage in the
  consumer;

and prints each fit's host seconds (ending in a synchronize), and the
seconds of one stage call (pin and copy) a batch, with the card's name and
power limit. The fits are checked to end in the same state.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch  # noqa: E402

from repro_torch.core import (KernelSpec, MiniBatchConfig, fit,  # noqa: E402
                              gamma_from_dmax)
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.data.loader import BatchSource, DeviceStage, arrive  # noqa: E402
from repro_torch.data.sampling import split_batches  # noqa: E402


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def settings():
    x, _ = synthetic.make_mnist_like(60000, seed=0)
    gamma = gamma_from_dmax(torch.as_tensor(x[:4096], device="cuda"))
    rbf = KernelSpec("rbf", gamma=gamma)
    xr, _ = synthetic.make_rcv1_like(188000, n_classes=50, seed=0)
    return {
        "tab1-exact-B4": (x, MiniBatchConfig(n_clusters=10, n_batches=4,
                                             s=0.2, kernel=rbf, seed=0,
                                             engine="fused")),
        "fig5-rff-B1": (x, MiniBatchConfig(n_clusters=10, n_batches=1,
                                           kernel=rbf, seed=0, method="rff",
                                           embed_dim=320)),
        "tab2-sketch-B4": (xr, MiniBatchConfig(
            n_clusters=50, n_batches=4, seed=0, method="sketch",
            embed_dim=128, kernel=KernelSpec("linear"))),
    }


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, res


def run(reps: int) -> dict:
    out = {"card": card_line(), "settings": {}}
    for name, (x, cfg) in settings().items():
        ways = {
            "plain": lambda: fit(split_batches(x, cfg.n_batches,
                                               cfg.sampling), cfg),
            "prefetch1": lambda: fit(BatchSource.from_dataset(
                x, cfg.n_batches, cfg.sampling, prefetch=1), cfg),
            "prefetch0": lambda: fit(BatchSource.from_dataset(
                x, cfg.n_batches, cfg.sampling,
                stage=DeviceStage("cuda")), cfg),
        }
        order = ["plain", "prefetch1", "prefetch0"]
        secs = {k: [] for k in order}
        states = {}
        for r in range(reps):
            for k in (order if r % 2 == 0 else order[::-1]):
                s, res = timed(ways[k])
                secs[k].append(s)
                states[k] = res.state
        same = all(torch.equal(a, b) for k in order[1:]
                   for a, b in zip(states[k][:-1], states["plain"][:-1]))
        stage = DeviceStage("cuda")
        stage_s = []
        for b in split_batches(x, cfg.n_batches, cfg.sampling):
            s, _ = timed(lambda: arrive(stage(b)))
            stage_s.append(s)
        pageable_s = [timed(lambda: torch.as_tensor(b).to("cuda"))[0]
                      for b in split_batches(x, cfg.n_batches, cfg.sampling)]
        out["settings"][name] = {
            "fit_s": secs, "same_state": same, "stage_s": stage_s,
            "pageable_copy_s": pageable_s,
            "batch_bytes": int(x.nbytes // cfg.n_batches)}
        print(name, json.dumps(out["settings"][name]), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ingest_bench: no CUDA device is visible", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    out = run(args.reps)
    print(f"card: {out['card']}")
    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
