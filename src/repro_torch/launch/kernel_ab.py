"""A/B timing of the port's CUDA kernels across source trees, on one card.

    python src/repro_torch/launch/kernel_ab.py --trees OLD/src src \\
        --order 0 1 1 0 --out build/kernel_ab.json

Times every kernel wrapper the main path calls (``ops.assign_fused``,
``ops.gram_matvec``, ``ops.kernel_matrix``, ``ops.embed_assign``,
``ops.sketch_assign``, ``ops.flash_attention``) at the shapes of
``chip_smoke.py``'s timed checks: the Tab.1 MNIST batch (15,000 x {15,000,
3,000} x 784, C = 10, and the g stats' 3,000 x 3,000), the skinny
``kernel_matrix`` calls of k-means++ and Eq.8 (``SKINNY``), the tile body
at the Gram build's 15,000 x 3,000 and D-nystrom's K_LL 320 x 320, the Fig.5
embedding (60,000 x 784 -> m, C = 10; RFF at m = 20, 80, 160 and 320,
Nystrom rbf at 320), the Tab.2 count sketch (188,000 x 256 -> 128, C = 50,
on rows already in the tile dtype; also at C = 10 and 200 and at D = 128)
and the attention of OLMo-1B, gemma2-2b and qwen3-32b at S 2048, at f32 and
bf16. Beside each attention shape it times ``scaled_dot_product_attention``
(or, with a softcap, matmul + tanh + masked softmax + matmul), beside each
skinny ``kernel_matrix`` shape ``x @ y.T`` with the epilogue and the norms
as the wrapper takes them, beside the tile body's shapes cdist and exp,
and beside each embedding shape and the sketch the composite of PyTorch
calls that computes the same labels; the port never calls any of them.
Every kernel key but the attention's also gets the card's own time a call
(``.../device``: the device activities of a ``torch.profiler`` trace),
since a back-to-back loop of small calls reads the host's launch path
rather than the card.
The bf16 embedding at m = 320 is also timed on rows already in bf16
(``.../bf16/precast``: without the wrapper's cast of the f32 rows). A tree whose
``kernel_matrix`` has two bodies also gets the sweep that chose
``NCOL_MAX``: each body forced at [15,000, N] x 784, N = 1, 4, 5, 10, 16
and 32 (keys ``kernel_matrix/sweep/...``).

Each entry of ``--order`` is one process that imports ``repro_torch`` from
that tree's ``src`` (so two trees never share a module or a built library),
builds its kernels and times them, in the order given: ``0 1 1 0`` runs the
first tree, the second twice, the first again, so a drift of the card over
the call shows as a gap between the two runs of one tree. The data are made
once (``repro_torch.data.synthetic`` of this tree, seed 0) and handed to
every process as ``.npy`` files. Times are CUDA-event means over ``--reps``
launches after one warm-up launch, in ms; the card's name and power limit
are printed and stored beside them. Needs a CUDA card; imports no JAX.
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# (name, B, H, KH, S, dh, softcap): chip_smoke.FLASH_MAIN
FLASH = [("olmo-1b", 1, 16, 16, 2048, 128, None),
         ("gemma2-2b", 1, 8, 4, 2048, 256, 50.0),
         ("qwen3-32b", 1, 64, 8, 2048, 128, None)]
EMBED_M = (20, 80, 160, 320)
# the skinny kernel_matrix calls of the runs (rows, columns, D, kind, data,
# tile dtypes): k-means++ (two a step) and Eq.8 / predict of runs A-C on
# the MNIST batch and on 10,000 rows in place of the test rows, k-means++
# of the D runs on the RFF embedding (m = 320) and of the E runs on a
# count-sketch batch (m = 128)
SKINNY = [(15000, 1, 784, "rbf", "batch", ("f32",)),
          (15000, 4, 784, "rbf", "batch", ("f32",)),
          (15000, 10, 784, "rbf", "batch", ("f32",)),
          (10000, 10, 784, "rbf", "test", ("f32",)),
          (60000, 1, 320, "linear", "rff", ("f32", "bf16")),
          (60000, 4, 320, "linear", "rff", ("f32", "bf16")),
          (47000, 1, 128, "linear", "sketch", ("f32", "bf16")),
          (47000, 5, 128, "linear", "sketch", ("f32", "bf16"))]
SWEEP_N = (1, 4, 5, 10, 16, 32)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def make_data(src: Path, out: Path) -> None:
    """The MNIST-like and RCV1-like sets of chip_smoke.py, as .npy files."""
    sys.path.insert(0, str(src))
    import numpy as np
    from repro_torch.data import synthetic
    x, y = synthetic.make_mnist_like(70000, seed=0)
    np.save(out / "x_mnist.npy", x[:60000])
    np.save(out / "y_mnist.npy", y[:60000])
    x, y = synthetic.make_rcv1_like(188000 + 5844, n_classes=50, seed=0)
    np.save(out / "x_rcv1.npy", x[:188000])
    np.save(out / "y_rcv1.npy", y[:188000])


def worker(src: Path, data: Path, reps: int) -> dict:
    """Import repro_torch from ``src`` and time its kernels: {key: ms}."""
    sys.path.insert(0, str(src))
    import numpy as np
    import torch
    from repro_torch import approx, core
    from repro_torch.kernels import build, ops
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    F = torch.nn.functional
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    build.load()
    times = {"build_s": time.perf_counter() - t0}

    def timed(key, fn, device=False):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times[key] = start.elapsed_time(end) / reps
        if device:   # the card's own time a call, without the host's
            times[key + "/device"] = device_ms(fn)

    def device_ms(fn):
        """The summed time of the device activities (kernels, copies) of
        one call, from a torch.profiler trace of ``reps`` calls."""
        act = torch.profiler.ProfilerActivity.CUDA
        with torch.profiler.profile(activities=[act]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(getattr(e, "device_time_total", 0)
                    for e in prof.key_averages())
        return total / reps / 1e3

    x_tr = torch.as_tensor(np.load(data / "x_mnist.npy"), device=dev)
    y_tr = torch.as_tensor(np.load(data / "y_mnist.npy"), device=dev)
    gamma = core.gamma_from_dmax(x_tr[:4096])
    spec = core.KernelSpec("rbf", gamma=gamma)

    # the skinny kernel_matrix calls, Y the first rows of X as k-means++'s;
    # each X contiguous, as the fits hand their batches over
    xr = torch.as_tensor(np.load(data / "x_rcv1.npy"), device=dev)
    rows = {"batch": x_tr[0::4].contiguous(), "test": x_tr[-10000:],
            "rff": approx.make_rff(torch.Generator().manual_seed(3),
                                   x_tr.shape[1], 320, spec, device=dev)(x_tr),
            "sketch": approx.make_count_sketch(
                torch.Generator().manual_seed(5), xr.shape[1], 128,
                core.KernelSpec("linear"), device=dev)(xr[0::4].contiguous())}
    del xr
    for m, n, d, kind, src, precs in SKINNY:
        x = rows[src][:m]
        for prec in precs:
            xp = x.to(torch.bfloat16) if prec == "bf16" else x
            yp = xp[:n]
            timed(f"kernel_matrix/{m}x{n}x{d}/{kind}/{prec}",
                  lambda: ops.kernel_matrix(xp, yp, kind=kind, gamma=gamma,
                                            precision=prec), device=True)
            xf, yf = xp.float(), yp.float()

            def library():
                dot = xf @ yf.T
                if kind == "linear":
                    return dot
                d2 = ((xf * xf).sum(1)[:, None] + (yf * yf).sum(1)[None]
                      - 2.0 * dot)
                return torch.exp(-gamma * d2.clamp_(min=0.0))
            timed(f"kernel_matrix/{m}x{n}x{d}/{kind}/{prec}/library", library,
                  device=True)
    from repro_torch.kernels import kernel_matrix as km
    if hasattr(km, "route"):   # the column body: the sweep behind NCOL_MAX
        # trees before the tile body computed its own norms take them as an
        # argument, computed here as the wrapper did
        takes_norms = "norms" in inspect.signature(
            km.kernel_matrix_cuda).parameters
        for prec, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            x = rows["batch"].to(dtype)
            for n in SWEEP_N:
                y = x[:n]
                for body in ("column", "tile"):
                    norms = (() if not takes_norms else (None,)
                             if body == "column" else
                             ((ops._sqnorms(x), ops._sqnorms(y)),))
                    timed(f"kernel_matrix/sweep/{n}/{prec}/{body}",
                          lambda: km.kernel_matrix_cuda(
                              x, y, *norms, kind="rbf", gamma=gamma,
                              coef0=1.0, degree=3, body=body), device=True)
    del rows

    # Tab.1: one 15,000-row batch, |L| = 15,000 and 3,000
    x_b, y_b = x_tr[0::4], y_tr[0::4]
    gen = torch.Generator().manual_seed(0)
    l3 = torch.sort(torch.randperm(len(x_b), generator=gen)[:3000]).values
    for prec in ("f32", "bf16"):
        for tag, idx in (("15000", torch.arange(len(x_b))), ("3000", l3)):
            lm, lab = x_b[idx.to(dev)], y_b[idx.to(dev)]
            counts = torch.bincount(lab.long(), minlength=10).float()
            g = torch.rand(10, generator=gen).to(dev)
            timed(f"assign_fused/{tag}/{prec}", lambda: ops.assign_fused(
                x_b, lm, lab, counts, g, n_clusters=10, kind="rbf",
                gamma=gamma, precision=prec), device=True)
        # the tile body: materialize's Gram build and D-nystrom's K_LL,
        # beside cdist and exp on the same (rounded) operands
        for tag, xk, yk in (("3000", x_b, x_b[l3.to(dev)]),
                            ("320x320", x_b[l3[:320].to(dev)],
                             x_b[l3[:320].to(dev)])):
            if prec == "bf16":
                xk, yk = xk.to(torch.bfloat16), yk.to(torch.bfloat16)
            timed(f"kernel_matrix/{tag}/{prec}", lambda: ops.kernel_matrix(
                xk, yk, kind="rbf", gamma=gamma, precision=prec),
                device=True)
            xf, yf = xk.float(), yk.float()
            timed(f"kernel_matrix/{tag}/{prec}/library", lambda: torch.exp(
                torch.cdist(xf, yf).square_().mul_(-gamma)), device=True)
        # the g stats of runs B and C: K(L, L) @ H at |L| = 3,000
        lm = x_b[l3.to(dev)]
        h = F.one_hot(y_b[l3.to(dev)].long(), 10).float()
        timed(f"gram_matvec/3000/{prec}", lambda: ops.gram_matvec(
            lm, lm, h, kind="rbf", gamma=gamma, precision=prec),
            device=True)
    del x_b, y_b

    # Fig.5: the embedding of all 60,000 training rows
    onehot = F.one_hot(y_tr.long(), 10).float()
    counts = onehot.sum(dim=0)
    for kind, ms in (("rff", EMBED_M), ("nystrom", (320,))):
        for m in ms:
            if kind == "rff":
                fmap = approx.make_rff(torch.Generator().manual_seed(3),
                                       x_tr.shape[1], m, spec, device=dev)
            else:
                fmap = approx.make_nystrom(torch.Generator().manual_seed(4),
                                           x_tr, m, spec)
            cents = (onehot.T @ fmap(x_tr)) / counts[:, None]
            for prec in (("f32", "bf16") if m == 320 else ("f32",)):
                timed(f"embed_assign/{kind}/{m}/{prec}",
                      lambda: ops.embed_assign(x_tr, fmap, cents, counts,
                                               precision=prec), device=True)
            if m == 320:   # on rows already in the tile dtype: no cast
                xb = x_tr.to(torch.bfloat16)
                timed(f"embed_assign/{kind}/{m}/bf16/precast",
                      lambda: ops.embed_assign(xb, fmap, cents, counts,
                                               precision="bf16"), device=True)
                del xb
            w, aux, v, csq, st = ops.embed_panels(fmap, cents, counts)
            wf = w.float()
            wsq = (wf * wf).sum(dim=1)
            xsq = (x_tr * x_tr).sum(dim=1)

            def composite():
                a = x_tr @ wf.T
                if kind == "rff":
                    e = st["scale"] * torch.cos(a + aux)
                else:
                    d2 = xsq[:, None] + wsq[None] - 2.0 * a
                    e = torch.exp(-st["gamma"] * d2.clamp_(min=0.0))
                sc = csq[None] - 2.0 * (e @ v)
                return torch.argmin(sc, dim=1), torch.amin(sc, dim=1)
            timed(f"embed_assign/{kind}/{m}/library", composite, device=True)
    del x_tr, y_tr, onehot

    # Tab.2: the count sketch of 188,000 rows
    xr = torch.as_tensor(np.load(data / "x_rcv1.npy"), device=dev)
    yr = torch.as_tensor(np.load(data / "y_rcv1.npy"), device=dev)
    fmap = approx.make_count_sketch(torch.Generator().manual_seed(5),
                                    xr.shape[1], 128, core.KernelSpec("linear"),
                                    device=dev)
    oh = F.one_hot(yr.long(), 50).float()
    cnt = oh.sum(dim=0)
    cents = (oh.T @ fmap(xr)) / cnt.clamp(min=1.0)[:, None]
    for prec in ("f32", "bf16"):
        # rows already in the tile dtype: the kernel's time, not the
        # wrapper's cast of f32 rows
        xp = xr.to(torch.bfloat16) if prec == "bf16" else xr
        timed(f"sketch_assign/{prec}", lambda: ops.embed_assign(
            xp, fmap, cents, cnt, precision=prec), device=True)
        # index_add_ + matmul + argmin on the same (rounded) rows
        xs = xp.float()
        csq = (cents * cents).sum(dim=1)

        def library():
            z = torch.zeros(len(xs), 128, device=dev).index_add_(
                1, fmap.h.long(), xs * fmap.sign[None])
            sc = csq[None] - 2.0 * (z @ cents.T)
            return torch.argmin(sc, dim=1), torch.amin(sc, dim=1)
        timed(f"sketch_assign/{prec}/library", library, device=True)
    # what the sketch's time follows: C = 10 and 200 clusters (random
    # centroids), and half the columns
    for d, c in ((256, 10), (256, 200), (128, 50)):
        xd = xr[:, :d].contiguous()
        fd = approx.make_count_sketch(torch.Generator().manual_seed(5), d,
                                      128, core.KernelSpec("linear"),
                                      device=dev)
        gen = torch.Generator(device=dev).manual_seed(c)
        cd = torch.randn(c, 128, device=dev, generator=gen)
        ones = torch.ones(c, device=dev)
        for prec in ("f32", "bf16"):
            xp = xd.to(torch.bfloat16) if prec == "bf16" else xd
            timed(f"sketch_assign/D{d}/C{c}/{prec}", lambda: ops.embed_assign(
                xp, fd, cd, ones, precision=prec), device=True)
    del xr, yr, oh

    # attention at S 2048
    for i, (name, b, h, kh, s, dh, cap) in enumerate(FLASH):
        gen = torch.Generator(device="cuda").manual_seed(i)
        q0, k0, v0 = (torch.randn(shape, generator=gen, device=dev)
                      for shape in ((b, h, s, dh), (b, kh, s, dh),
                                    (b, kh, s, dh)))
        q0 = q0 * 3.0
        for prec, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            q, k, v = q0.to(dtype), k0.to(dtype), v0.to(dtype)
            timed(f"flash_attention/{name}/{prec}", lambda: ops.flash_attention(
                q, k, v, causal=True, softcap=cap, precision=prec))
            if cap is None:
                timed(f"flash_attention/{name}/{prec}/library",
                      lambda: F.scaled_dot_product_attention(
                          q, k, v, is_causal=True, enable_gqa=h != kh))
            else:
                mask = torch.tril(torch.ones(s, s, dtype=torch.bool,
                                             device=dev))

                def composite():
                    kx = k.repeat_interleave(h // kh, dim=1)
                    vx = v.repeat_interleave(h // kh, dim=1)
                    sc = (q @ kx.transpose(-1, -2)).float() * dh ** -0.5
                    sc = (cap * torch.tanh(sc / cap)).masked_fill(~mask, -1e30)
                    return torch.softmax(sc, dim=-1).to(q.dtype) @ vx
                timed(f"flash_attention/{name}/{prec}/library", composite)
        del q0, k0, v0
    return times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", type=Path,
                    help="the src directories to compare")
    ap.add_argument("--order", nargs="+", type=int,
                    help="indices into --trees, one process each")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--worker", type=Path, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--data", type=Path, default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker is not None:
        print("RESULT " + json.dumps(worker(args.worker, args.data,
                                            args.reps)))
        return 0

    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device is visible", file=sys.stderr)
        return 2
    trees = [t.resolve() for t in args.trees]
    order = args.order or list(range(len(trees)))
    card = card_line()
    print(f"card: {card}")
    here = Path(__file__).resolve()
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        make_data(here.parents[2], Path(tmp))
        print(f"data: {time.perf_counter() - t0:.1f} s")
        for i in order:
            t0 = time.perf_counter()
            out = subprocess.run(
                [sys.executable, str(here), "--worker", str(trees[i]),
                 "--data", tmp, "--reps", str(args.reps)],
                capture_output=True, text=True, env=dict(os.environ),
                cwd=str(trees[i].parent))
            lines = [ln for ln in out.stdout.splitlines()
                     if ln.startswith("RESULT ")]
            if out.returncode or not lines:
                print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
                return 1
            runs.append({"tree": str(trees[i]), "index": i,
                         "times": json.loads(lines[-1][len("RESULT "):])})
            print(f"run {len(runs)}: tree {i} ({trees[i]}) "
                  f"{time.perf_counter() - t0:.1f} s")
    # every tree's keys, in the order they were first timed
    keys = list(dict.fromkeys(k for r in runs for k in r["times"]))
    width = max(map(len, keys))
    print(f"{'key':<{width}}  " + "  ".join(
        f"tree{r['index']}" for r in runs))
    for key in keys:
        print(f"{key:<{width}}  " + "  ".join(
            f"{r['times'].get(key, float('nan')):.4f}" for r in runs))
    print(f"card: {card_line()}")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card, "order": order,
                                        "trees": list(map(str, trees)),
                                        "runs": runs}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
