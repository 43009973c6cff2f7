"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``
(the port of ``repro/launch/train.py``).

    python -m repro_torch.launch.train --arch olmo-1b --smoke --device cpu
    torchrun --nproc-per-node 2 -m repro_torch.launch.train --arch olmo-1b \\
        --smoke --mesh 2x1

The production loop on one card or a data-parallel world:

  * parameters from a ``torch.Generator`` of seed 0 (bf16), AdamW state in
    ``TrainConfig.opt_state_dtype``;
  * the reference's synthetic token batches (``synthetic_batches``, numpy's
    ``default_rng``; labels are the tokens shifted by one);
  * microbatch gradient accumulation (``--microbatches``);
  * step-granular checkpoints through ``ft.checkpoint.CheckpointManager``
    in the reference's layout (``{"params", "opt"}``, layers stacked as
    ``convert.stack_lm`` stacks each family's), so either package resumes
    the other's;
  * the reference's step log.

Every decoder family trains: dense, moe, hybrid (zamba2) and ssm (rwkv6).
The encoder-decoder family is refused (``ENCDEC_NOT_TRAINED``): its batch
needs frames, which the reference's ``synthetic_batches`` does not make.

As in the reference, ``--resume`` restarts ``synthetic_batches`` at
``seed=start_step``, so a resumed run sees other batches than the
uninterrupted run's later steps. ``--mesh Dx1`` trains data-parallel over
the ``torch.distributed`` world (joined from torchrun's environment, or
one a caller started): every rank holds the parameters, takes its 1/D of
each global batch, and the f32 grads are all_reduced and averaged before
the clip; rank 0 writes the checkpoints. A model axis (``DxM``, M > 1) is
not ported. ``--device`` names the device (default: the card,
``cuda:LOCAL_RANK`` under torchrun); it is the reference's ``--platform``.
``run(argv)`` returns the run's record (parameters, optimizer state, the
per-step losses, grad norms and seconds); ``main(argv)`` the last loss.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from repro_torch.configs import TrainConfig, get_arch
from repro_torch.convert import lm_skeleton, stack_lm, unstack_lm
from repro_torch.ft.checkpoint import CheckpointManager
from repro_torch.models import get_model
from repro_torch.training.optim import AdamWState, adamw_init, tree_leaves
from repro_torch.training.step import make_train_step

from . import env

#: why the launcher refuses the encoder-decoder family
ENCDEC_NOT_TRAINED = ("the launcher feeds token batches (synthetic_batches, "
                      "the reference's) and the encoder-decoder family "
                      "needs frames too; train it through "
                      "make_train_step with frames in the batch")
#: where the ROADMAP queues the model axis of the launcher
MODEL_AXIS_QUEUED = ("launch.train --mesh DxM with M > 1 (ROADMAP Queue 1 "
                     "item 13b: the model axis of launch.train and of "
                     "moe_block_ep)")


def synthetic_batches(vocab: int, batch: int, seq: int, steps: int,
                      seed: int = 0):
    """Self-labelled LM batches: labels are next-token shifted tokens."""
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        tok = rng.integers(1, vocab, size=(batch, seq), dtype=np.int64)
        yield {"tokens": tok.astype(np.int32),
               "labels": np.roll(tok, -1, axis=1).astype(np.int32)}


@dataclasses.dataclass
class TrainRun:
    params: dict
    opt: AdamWState
    losses: list
    grad_norms: list
    seconds: list        # each step's wall seconds, ending in a sync


def _data_mesh(spec: str, dev: torch.device):
    """None for one process; else the (data, model) mesh of the world."""
    dims = tuple(int(v) for v in spec.lower().split("x"))
    if len(dims) != 2:
        raise ValueError(f"--mesh takes DxM, got {spec!r}")
    if dims[1] > 1:
        raise NotImplementedError(f"{MODEL_AXIS_QUEUED} is not ported")
    if dims[0] == 1:
        return None
    import torch.distributed as dist
    from repro_torch.distributed.mesh import make_test_mesh
    if not dist.is_initialized():
        raise RuntimeError(f"--mesh {spec} needs a torch.distributed world "
                           f"of {dims[0]} ranks (run under torchrun)")
    if dist.get_world_size() != dims[0]:
        raise ValueError(f"--mesh {spec} has {dims[0]} ranks, the world has "
                         f"{dist.get_world_size()}")
    return make_test_mesh({"data": dims[0], "model": 1}, device=dev.type)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--mesh", default="1x1",
                    help="(data)x(model) ranks; data-parallel only (Dx1)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, raising without one)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    return ap.parse_args(argv)


def _join_torchrun(dev: torch.device) -> bool:
    """Join the world torchrun describes, unless one is up or none is
    described; True when this call joined it."""
    import torch.distributed as dist
    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        return False
    kw = {"device_id": dev} if dev.type == "cuda" else {}
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method="env://", **kw)
    return True


def run(argv=None, *, cfg=None) -> TrainRun:
    """The launcher's loop. ``cfg`` replaces the arch's config (a caller's
    cut of depth)."""
    env.configure()
    args = parse_args(argv)
    dev = env.set_device(args.device)
    joined = _join_torchrun(dev)
    try:
        return _run(args, dev, _data_mesh(args.mesh, dev), cfg)
    finally:
        if joined:
            import torch.distributed as dist
            dist.destroy_process_group()


def _run(args, dev, mesh, cfg) -> TrainRun:
    dp = 1 if mesh is None else int(mesh.size(0))
    rank = 0 if mesh is None else int(mesh.get_local_rank("data"))
    if args.batch % dp:
        raise ValueError(f"--batch {args.batch} does not split over {dp} "
                         f"data ranks")

    cfg = cfg or get_arch(args.arch, smoke=args.smoke)
    if cfg.family == "encdec":
        raise ValueError(f"{args.arch}: {ENCDEC_NOT_TRAINED}")
    api = get_model(cfg, device=dev)
    tcfg = TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                       warmup_steps=max(args.steps // 10, 1),
                       microbatches=args.microbatches, remat=not args.smoke)

    params = api.init(0)
    opt = adamw_init(params, tcfg)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"[train] {args.arch} ({'smoke' if args.smoke else 'full'}): "
          f"{n_params/1e6:.1f}M params, mesh={{'data': {dp}, 'model': 1}}")

    start_step = 0
    cm = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    if cm and args.resume and cm.latest_step() is not None:
        s = cm.latest_step()
        skel = lm_skeleton(params, cfg)
        like = {"params": skel,
                "opt": AdamWState(torch.empty(0), skel, skel)}
        got = cm.restore(s, like, device="cpu")
        params = unstack_lm(got["params"], cfg, dev)
        o = got["opt"]
        opt = AdamWState(o.step.to(device=dev, dtype=torch.int32),
                         unstack_lm(o.m, cfg, dev), unstack_lm(o.v, cfg, dev))
        start_step = s
        print(f"[train] resumed from step {s}")

    step_fn = make_train_step(api, tcfg, mesh=mesh)
    share = slice(rank * args.batch // dp, (rank + 1) * args.batch // dp)
    losses, gnorms, times = [], [], []
    gen = synthetic_batches(cfg.vocab_size, args.batch, args.seq,
                            args.steps - start_step, seed=start_step)
    metrics = None
    for i, batch in enumerate(gen, start=start_step):
        batch = {k: torch.as_tensor(v[share], dtype=torch.long, device=dev)
                 for k, v in batch.items()}
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        params, opt, metrics = step_fn(params, opt, batch)
        losses.append(float(metrics["loss"]))    # waits for the step
        times.append(time.perf_counter() - t0)
        gnorms.append(float(metrics["grad_norm"]))
        if (i + 1) % args.log_every == 0 or i == start_step:
            print(f"  step {i+1:5d}  loss={losses[-1]:.4f} "
                  f"gnorm={gnorms[-1]:.3f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"dt={times[-1]*1e3:.0f}ms")
        if cm and (i + 1) % args.ckpt_every == 0 and rank == 0:
            cm.save(i + 1, {"params": stack_lm(params, cfg),
                            "opt": AdamWState(opt.step.cpu(),
                                              stack_lm(opt.m, cfg),
                                              stack_lm(opt.v, cfg))},
                    extra={"arch": args.arch})
    med = float(np.median(times[1:])) if len(times) > 1 else float("nan")
    first = times[0] * 1e3 if times else float("nan")
    print(f"[train] done. median step {med*1e3:.0f}ms "
          f"(first/compile {first:.0f}ms)")
    return TrainRun(params=params, opt=opt, losses=losses, grad_norms=gnorms,
                    seconds=times)


def main(argv=None) -> float:
    out = run(argv)
    return out.losses[-1] if out.losses else float("nan")


if __name__ == "__main__":
    main()
