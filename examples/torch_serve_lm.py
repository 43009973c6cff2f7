"""Serve a small model with batched requests through the PyTorch port's
continuous-batching engine (a front end of ``repro_torch.launch.serve``).

    PYTHONPATH=src python examples/torch_serve_lm.py           # the card
    PYTHONPATH=src python examples/torch_serve_lm.py --device cpu

The port of ``examples/serve_lm.py``: request submission, mixed prompt
lengths decoding in one batched step a tick (per-slot cursors) and the
throughput line, on the arch's smoke config. On the card the prefill
runs the hand-written flash-attention kernel. ``main`` returns
{request id: tokens}.
"""
import argparse

from repro_torch.launch import serve as serve_mod


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--mesh", default="1x1")
    ap.add_argument("--top-p", type=float, default=0.9)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, raising without one)")
    args = ap.parse_args(argv)

    dev_args = ["--device", args.device] if args.device else []
    return serve_mod.main([
        "--arch", args.arch, "--smoke", "--mesh", args.mesh,
        "--requests", str(args.requests), "--max-batch", "4",
        "--max-len", "96", "--max-new-tokens", "12",
        "--top-p", str(args.top_p)] + dev_args)


if __name__ == "__main__":
    main()
