"""Serving launcher: ``python -m repro_torch.launch.serve [...]``.

Two services share this entry point, as in ``repro/launch/serve.py``:

* ``--arch <id>``: the LM continuous-batching engine
  (``repro_torch.serving.engine``) on the reference launcher's synthetic
  request stream (prompt lengths and tokens from
  ``np.random.default_rng(0)``, parameters from seed 0); every decoder
  family (dense, moe, hybrid, ssm); the encoder-decoder family is refused,
  as the engine refuses it;
* ``--assign <artifact.npz | synth>``: the assignment service
  (``repro_torch.serving.assign``): load a frozen artifact (or fit and
  freeze a small synthetic RFF model), build one program per bucket (a
  captured CUDA graph on the card), and drive a ragged request stream
  through the queue, reporting p50/p99 latency and rows/s.

Both report into the same ``--obs PATH`` flight-recorder JSONL
(``repro_torch.obs``): a run header, the service's records and a
``serve/summary`` event. ``--device`` defaults to the GPU, where LM
prefill runs the flash kernel (``attn_impl="flash"``; a layer with a
window runs chunked attention, as the model code rules); ``--device cpu``
runs the plain PyTorch path at the config's attention. ``main`` first
stages the process variables (``launch.env.configure``).

``--mesh DxM`` serves the LM over the (data, model) mesh of the world
(joined from torchrun's environment, or one a caller started; gloo with
``--device cpu``): the model splits over the M model ranks
(``get_model(tp_size=M)``), and every rank runs the engine on the same
requests, its logits gathered whole, so every rank emits the same tokens
and world rank 0 reports them. On the card the world is one rank:

    torchrun --nproc-per-node 2 -m repro_torch.launch.serve \\
        --arch olmo-1b --smoke --device cpu --mesh 1x2
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.models import get_model
from repro_torch.serving import (AssignServeConfig, AssignService,
                                 ServeConfig, ServingEngine, artifact_nbytes,
                                 freeze, greedy, load_artifact, sample_top_p)
from repro_torch.serving.engine import ENCDEC_NOT_SERVED

from . import env
from .mesh import join_torchrun, launcher_mesh


def synth_artifact(device, *, precision: str = "f32", full: bool = False):
    """Fit a small rbf RFF model on blobs and freeze it, the reference's
    smoke and benchmark model: 2048 x 16 with C = 8 (``full``: 20000 x 32
    with C = 16), B = 4, m = 8 C, seed 0."""
    from repro_torch.core import MiniBatchConfig, fit_dataset
    from repro_torch.data.synthetic import make_blobs
    n, d, c = (20000, 32, 16) if full else (2048, 16, 8)
    x, _ = make_blobs(n, d, c, seed=0)
    cfg = MiniBatchConfig(n_clusters=c, n_batches=4, method="rff",
                          embed_dim=8 * c, seed=0)
    return freeze(fit_dataset(x, cfg, device=device), precision=precision)


def _make_recorder(args, device, **extra):
    if not args.obs:
        return None
    from repro_torch.obs import JsonlRecorder, export
    return JsonlRecorder(args.obs, header=export.run_header(
        device=device, entry="launch.serve", **extra))


def assign_main(args):
    art = (synth_artifact(args.device, precision=args.precision)
           if args.assign == "synth"
           else load_artifact(args.assign, device=args.device))
    buckets = tuple(int(b) for b in args.buckets.split(","))
    # the artifact's kind under its own key: ``kind`` is the header's
    rec = _make_recorder(args, art.device, mode="assign",
                         artifact_kind=art.kind, precision=art.precision,
                         buckets=list(buckets))
    svc = AssignService(art, AssignServeConfig(buckets=buckets),
                        recorder=rec)
    rng = np.random.default_rng(0)
    sizes = rng.integers(1, args.rows_max + 1, size=args.requests)
    lat, rows = [], 0
    t0 = time.perf_counter()
    for n in sizes:
        ts = time.perf_counter()
        svc.predict(rng.normal(size=(int(n), art.in_dim)).astype(np.float32))
        lat.append(time.perf_counter() - ts)
        rows += int(n)
    dt = time.perf_counter() - t0
    p50, p99 = np.percentile(lat, [50, 99])
    if rec is not None:
        rec.event("serve/summary", requests=len(sizes), rows=rows,
                  seconds=dt, p50_seconds=float(p50),
                  p99_seconds=float(p99), warm_seconds=svc.warm_seconds,
                  programs=svc.compiled_programs,
                  artifact_bytes=artifact_nbytes(art))
        rec.close()
    print(f"[serve.assign] kind={art.kind} precision={art.precision} "
          f"device={art.device} programs={svc.compiled_programs} (warm "
          f"{svc.warm_seconds:.2f}s) artifact {artifact_nbytes(art)} bytes | "
          f"{len(sizes)} requests / {rows} rows in {dt:.2f}s "
          f"({rows/dt:.0f} rows/s, p50 {p50*1e3:.2f}ms, p99 {p99*1e3:.2f}ms)")
    return svc


def main(argv=None):
    env.configure()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None,
                    help="LM-zoo arch id (LM serving)")
    ap.add_argument("--assign", default=None, metavar="ARTIFACT",
                    help="assignment serving: a frozen artifact .npz "
                    "(serving.save_artifact, of either package) or 'synth' "
                    "for a small fitted smoke model")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's small smoke config")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, raising without one)")
    ap.add_argument("--mesh", default="1x1",
                    help="(data)x(model) ranks of the world (LM serving)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--top-p", type=float, default=0.0,
                    help="0 -> greedy; else nucleus sampling")
    ap.add_argument("--buckets", default="1,8,64,512",
                    help="assignment shape-bucket ladder (row counts)")
    ap.add_argument("--rows-max", type=int, default=64,
                    help="assignment request sizes draw from [1, rows-max]")
    ap.add_argument("--precision", choices=("f32", "bf16"), default="f32",
                    help="tile dtype of the --assign synth artifact")
    ap.add_argument("--obs", default=None, metavar="PATH",
                    help="write a repro_torch.obs flight-recorder JSONL here")
    args = ap.parse_args(argv)
    if args.assign is not None:
        return assign_main(args)
    if args.arch is None:
        ap.error("one of --arch (LM serving) or --assign is required")

    cfg = get_arch(args.arch, smoke=args.smoke)
    if cfg.family == "encdec":          # refused before drawing parameters
        raise ValueError(f"{args.arch}: {ENCDEC_NOT_SERVED}")
    dev = env.set_device(args.device)
    if dev.type == "cuda":   # the flash kernel (windowed layers: chunked)
        cfg = dataclasses.replace(cfg, attn_impl="flash")
    joined = join_torchrun(dev)
    try:
        return lm_main(args, cfg, launcher_mesh(args.mesh, dev), dev)
    finally:
        if joined:
            import torch.distributed as dist
            dist.destroy_process_group()


def lm_main(args, cfg, mesh, dev):
    """The LM service on ``mesh`` (None: one process)."""
    dp, tp_size = (1, 1) if mesh is None else (int(mesh.size(0)),
                                               int(mesh.size(1)))
    api = get_model(cfg, tp_size=tp_size, dp_size=dp, mesh=mesh, device=dev)
    params = api.init(0)
    report = mesh is None or mesh.get_rank() == 0

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

    rec = _make_recorder(args, api.device, arch=args.arch,
                         mesh={"data": dp, "model": tp_size}) \
        if report else None
    results = {}
    t0 = time.time()
    try:
        results = eng.run()
        if api.device.type == "cuda":
            torch.cuda.synchronize()
    finally:
        dt = time.time() - t0
        if rec is not None:
            rec.event("serve/summary", requests=len(lens),
                      tokens=sum(len(v) for v in results.values()),
                      seconds=dt, ticks=eng.ticks)
            rec.close()
    n_tokens = sum(len(v) for v in results.values())
    if report:
        print(f"[serve] {args.arch}: {len(results)} requests, "
              f"{n_tokens} tokens in {dt:.2f}s "
              f"({n_tokens/dt:.1f} tok/s, {eng.ticks} batched ticks, "
              f"mesh={{'data': {dp}, 'model': {tp_size}}})")
    return results


if __name__ == "__main__":
    main()
