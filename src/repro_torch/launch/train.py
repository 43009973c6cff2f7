"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``
(the port of ``repro/launch/train.py``).

    python -m repro_torch.launch.train --arch olmo-1b --smoke --device cpu
    torchrun --nproc-per-node 2 -m repro_torch.launch.train --arch olmo-1b \\
        --smoke --mesh 2x1
    torchrun --nproc-per-node 2 -m repro_torch.launch.train --arch olmo-1b \\
        --smoke --device cpu --mesh 1x2

The production loop on one card or a (data, model) world:

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
uninterrupted run's later steps. ``--mesh DxM`` trains over the
``torch.distributed`` world (joined from torchrun's environment, or one a
caller started) as a (data D, model M) mesh: the model is split over M
ranks (``get_model(tp_size=M, dp_size=D)``, Megatron-style), each data
index takes its 1/D of each global batch, and the f32 grads are
all_reduced over ``data`` and averaged before the clip. Checkpoints hold
whole leaves in the reference's layout: every rank joins the gather over
``model`` (``convert.gather_lm``) and world rank 0 writes; a restore cuts
the whole leaves for each rank (``convert.shard_lm``), so a run resumes
at another M, and either package resumes the other's. ``--mesh 1x1``
with no world up is one process; in a world of one it runs the mesh code
with every model-axis collective the identity. ``--device`` names the
device (default: the card, ``cuda:LOCAL_RANK`` under torchrun); it is the
reference's ``--platform``.
``run(argv)`` returns the run's record (parameters, optimizer state, the
per-step losses, grad norms and seconds); ``main(argv)`` the last loss.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import TrainConfig, get_arch
from repro_torch.convert import (lm_skeleton, shard_lm, stack_lm,
                                 unstack_lm, whole_lm)
from repro_torch.ft.checkpoint import CheckpointManager
from repro_torch.models import get_model
from repro_torch.training.optim import AdamWState, adamw_init, tree_leaves
from repro_torch.training.step import make_train_step

from . import env
from .mesh import join_torchrun, launcher_mesh

#: why the launcher refuses the encoder-decoder family
ENCDEC_NOT_TRAINED = ("the launcher feeds token batches (synthetic_batches, "
                      "the reference's) and the encoder-decoder family "
                      "needs frames too; train it through "
                      "make_train_step with frames in the batch")


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


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--mesh", default="1x1",
                    help="(data)x(model) ranks of the world")
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


def run(argv=None, *, cfg=None, dtype=torch.bfloat16) -> TrainRun:
    """The launcher's loop. ``cfg`` replaces the arch's config (a caller's
    cut of depth), ``dtype`` the parameters' bf16."""
    env.configure()
    args = parse_args(argv)
    dev = env.set_device(args.device)
    joined = join_torchrun(dev)
    try:
        return _run(args, dev, launcher_mesh(args.mesh, dev), cfg, dtype)
    finally:
        if joined:
            import torch.distributed as dist
            dist.destroy_process_group()


def _run(args, dev, mesh, cfg, dtype) -> TrainRun:
    dp = 1 if mesh is None else int(mesh.size(0))
    tp_size = 1 if mesh is None else int(mesh.size(1))
    rank = 0 if mesh is None else int(mesh.get_local_rank("data"))
    writer = mesh is None or mesh.get_rank() == 0
    if args.batch % dp:
        raise ValueError(f"--batch {args.batch} does not split over {dp} "
                         f"data ranks")

    cfg = cfg or get_arch(args.arch, smoke=args.smoke)
    if cfg.family == "encdec":
        raise ValueError(f"{args.arch}: {ENCDEC_NOT_TRAINED}")
    api = get_model(cfg, tp_size=tp_size, dp_size=dp, mesh=mesh,
                    device=dev)
    tcfg = TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                       warmup_steps=max(args.steps // 10, 1),
                       microbatches=args.microbatches, remat=not args.smoke)

    params = api.init(0, dtype)
    opt = adamw_init(params, tcfg)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"[train] {args.arch} ({'smoke' if args.smoke else 'full'}): "
          f"{n_params/1e6:.1f}M params (this rank's), "
          f"mesh={{'data': {dp}, 'model': {tp_size}}}")

    start_step = 0
    cm = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    if cm and args.resume and cm.latest_step() is not None:
        s = cm.latest_step()
        skel = lm_skeleton(params, cfg)
        like = {"params": skel,
                "opt": AdamWState(torch.empty(0), skel, skel)}
        got = cm.restore(s, like, device="cpu")
        tp = api.tp

        def load(tree):
            return shard_lm(unstack_lm(tree, cfg, dev), cfg, tp.rank,
                            tp.size)
        params = load(got["params"])
        o = got["opt"]
        opt = AdamWState(o.step.to(device=dev, dtype=torch.int32),
                         load(o.m), load(o.v))
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
        if cm and (i + 1) % args.ckpt_every == 0:
            whole = [whole_lm(t, cfg, api.tp) for t in (params, opt.m, opt.v)]
            if writer:
                cm.save(i + 1, {"params": stack_lm(whole[0], cfg),
                                "opt": AdamWState(opt.step.cpu(),
                                                  stack_lm(whole[1], cfg),
                                                  stack_lm(whole[2], cfg))},
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
