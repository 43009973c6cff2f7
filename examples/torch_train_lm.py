"""Train a model of the zoo end to end with the PyTorch port (a front end of
``repro_torch.launch.train``).

CPU-runnable (the reduced olmo config, 100 steps):

    PYTHONPATH=src python examples/torch_train_lm.py --device cpu

A ~100M-parameter run on the card (12 layers x 768, vocab 50304), with
checkpoints every 50 steps and resume on restart:

    PYTHONPATH=src python examples/torch_train_lm.py --full-100m --steps 300

The port of ``examples/train_lm.py``. The 100M config is handed to
``launch.train.run(..., cfg=)``; no registry is patched. Every run passes
``--resume``: a second run over the same ``--ckpt-dir`` continues from the
last checkpoint. ``--mesh DxM`` trains over the world of a ``torchrun``.
The paper's kind is clustering, so the port's primary end-to-end example
is ``examples/torch_cluster_md_trajectory.py``; this script covers the
LM-training half. ``main`` returns the run (``launch.train.TrainRun``).
"""
import argparse
import dataclasses
import os
import tempfile

from repro_torch.configs import get_arch
from repro_torch.launch import train as train_mod

# ~100M-parameter dense config (olmo-style): 12L x 768d, vocab 50304
LM_100M = dataclasses.replace(
    get_arch("olmo-1b"),
    name="olmo-100m", n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_head=64, d_ff=3072)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full-100m", action="store_true",
                    help="the ~100M config instead of the smoke config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--mesh", default="1x1")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, raising without one)")
    args = ap.parse_args(argv)

    if args.full_100m:
        arch_args, cfg = ["--arch", "olmo-100m"], LM_100M
    else:
        arch_args, cfg = ["--arch", "olmo-1b", "--smoke"], None
    dev_args = ["--device", args.device] if args.device else []
    run = train_mod.run(arch_args + dev_args + [
        "--mesh", args.mesh, "--steps", str(args.steps),
        "--batch", str(args.batch), "--seq", str(args.seq),
        "--ckpt-dir", args.ckpt_dir, "--ckpt-every", "50",
        "--log-every", "10", "--resume",
    ], cfg=cfg)
    final = run.losses[-1] if run.losses else float("nan")
    print(f"[train_lm] final loss {final:.4f} after {len(run.losses)} steps "
          f"(checkpoints in {args.ckpt_dir})")
    return run


if __name__ == "__main__":
    main()
