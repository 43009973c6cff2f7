"""Dry run of every (arch, shape) LM cell on the production mesh, the port of
``repro/launch/dryrun.py``:

    python -m repro_torch.launch.dryrun --all --out build/dryrun
    python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k \\
        --both-meshes
    python -m repro_torch.launch.dryrun --arch qwen3-moe-235b-a22b \\
        --shape train_4k --variant ep

Each cell runs as rank 0 of a fake world of 256 ranks (the (16, 16)
single-pod mesh) or 512 (the (2, 16, 16) multi-pod one), as
``launch/dryrun_cluster.py`` does: ``init_process_group("fake",
store=FakeStore())``, whose collectives return at once, the mesh from
``launch.mesh.make_production_mesh``, and ``get_model(cfg, tp_size=16,
dp_size=16 or 32, mesh=)``. The whole cell runs under ``FakeTensorMode``,
so no tensor holds storage: ``api.init`` draws the whole tree from the
seed as shapes and keeps the rank's cut (grok-1-314b's 628 GB of bf16
parameters included), and nothing is allocated. A ``train`` cell runs one
``training.step`` train step (AdamW state in bf16 above 1e11 parameters,
as the reference's); a ``prefill`` cell ``api.prefill``; a ``decode``
cell one ``api.decode`` against a cache of ``api.cache_specs``. The
per-rank batch follows the reference's ``_dp_for_batch``: the global
batch over the data axes, unless it does not split (long_500k's batch of
1 stays whole on every rank).

The run is priced by ``launch.hlocost.cost_of`` (flops, bytes and the
collectives' payload, ``loop_aware``) and by the tally's calls
(``distributed.mesh.tally()``), to which ``collectives`` applies the
reference's ring formulas (``ring_bytes``), so that block means what the
reference's means. The cell's JSON holds the reference's schema:
``n_params``, ``n_active_params`` (the ``e_`` leaves scaled by top_k /
n_experts), ``tokens_per_step``, ``model_flops_total``,
``flops_per_device``, ``bytes_per_device``, ``loop_aware``,
``collectives``, ``memory_analysis`` (``argument_bytes``: the rank's
parameters, optimizer state, batch and cache; ``peak_bytes``: the peak of
live fake storages over the run, arguments included) and
``trace_seconds`` in place of ``compile_seconds`` (nothing is compiled).
The reference counts one layer's HLO once per loop trip through its
trip counts; the port runs its loops eagerly, so every layer's ops and
collectives are counted as they run.

A model axis of 16 wider than a config's heads splits each head over
16 / H ranks (``models.registry.check_heads``): gemma2-2b's 8 query heads
two ranks a head, the ``--smoke`` configs' 2-4 heads 4-8 ranks a head,
so every cell of ``--all`` and of ``--smoke --all`` runs. Refusals, each
a cell with ``ok: false`` and its named reason:

* ``--variant flash`` on a ``train`` cell (``kernels.ops.FLASH_NO_GRAD``:
  the kernel has no gradient, as the reference's has none);
* a config whose heads neither rule covers
  (``models.registry.HEADS_DO_NOT_SPLIT``; none of the repo's).

The fake process group comes from ``torch.testing._internal.distributed.
fake_pg`` (internal; imported at run time only). The run needs a process
with no ``torch.distributed`` world up. A cell whose JSON exists is
skipped (``[skip] ... (cached)``); the exit code is 1 if any cell failed.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import SHAPES, TrainConfig, cells, get_arch
from repro_torch.distributed import mesh as dmesh
from repro_torch.launch.dryrun_cluster import _fake_store
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import get_model
from repro_torch.training.optim import tree_leaves

#: config deltas on top of an arch config (results under "<arch>+<variant>")
VARIANTS = {
    "ep": lambda cfg, dp: dataclasses.replace(cfg, moe_ep_groups=dp),
    "qc1024": lambda cfg, dp: dataclasses.replace(cfg, q_chunk=1024),
    "qc2048": lambda cfg, dp: dataclasses.replace(cfg, q_chunk=2048),
    "flash": lambda cfg, dp: dataclasses.replace(cfg, attn_impl="flash"),
}
MODEL_AXIS = 16


def ring_bytes(calls) -> dict:
    """The reference's per-device link-bytes estimate (``collective_bytes``,
    ring costs) of a tally's calls [(kind, output bytes, group size)]:
    all-gather out (g-1)/g, all-reduce 2 out (g-1)/g, reduce-scatter
    out (g-1), all-to-all out (g-1)/g; a call over a group of one moves
    nothing."""
    kinds = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
             "collective-permute")
    totals = dict.fromkeys(kinds, 0.0)
    counts = dict.fromkeys(kinds, 0)
    for kind, out, g in calls:
        if g <= 1:
            continue
        moved = {"all-gather": out * (g - 1) / g,
                 "all-reduce": 2.0 * out * (g - 1) / g,
                 "reduce-scatter": float(out * (g - 1)),
                 "all-to-all": out * (g - 1) / g}[kind]
        totals[kind] += moved
        counts[kind] += 1
    return {"bytes_by_kind": totals, "counts": counts,
            "total_bytes": sum(totals.values())}


def _leaves(tree) -> list:
    """The tensor leaves of a nest of dicts, lists and tuples."""
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


class _FakePeak(TorchDispatchMode):
    """The high-water mark of the live fake storages a run's ops make over
    ``base`` bytes of arguments: a storage lives while any tensor an op
    returned on it (itself or a view) lives."""

    def __init__(self, base: int):
        super().__init__()
        self.cur = self.peak = base
        self.live: dict = {}          # storage -> [bytes, live tensors]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = {t.untyped_storage()._cdata for t in _leaves((args, kwargs))}
        for t in _leaves(out):
            st = t.untyped_storage()
            entry = self.live.get(st._cdata)
            if entry is None:
                if st._cdata in ins:  # a view or in-place result of an
                    continue          # argument's or an earlier storage
                entry = self.live[st._cdata] = [st.nbytes(), 0]
                self.cur += st.nbytes()
                self.peak = max(self.peak, self.cur)
            entry[1] += 1
            weakref.finalize(t, self._release, st._cdata)
        return out

    def _release(self, key):
        entry = self.live[key]
        entry[1] -= 1
        if not entry[1]:
            del self.live[key]
            self.cur -= entry[0]


def _batch(specs: dict, b_local: int) -> dict:
    """Fake tensors of the batch specs with the rank's batch rows."""
    out = {}
    for name, (shape, dtype) in specs.items():
        shape = (b_local, *shape[1:]) if shape else shape
        dtype = torch.long if dtype == torch.int32 else dtype
        out[name] = torch.zeros(shape, dtype=dtype)
    return out


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
               smoke: bool = False, opt_dtype: str | None = None,
               variant: str | None = None) -> dict:
    """Run one (arch x shape x mesh) cell as rank 0 of the production
    mesh's fake world (module docstring) -> the cell's JSON dict."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.convert import shard_lm
    from repro_torch.launch.hlocost import cost_of
    from repro_torch.training import adamw_init, make_train_step

    if dist.is_initialized():
        raise RuntimeError("dryrun starts its own fake world; run it in a "
                           "process with no torch.distributed world")
    world = 512 if multi_pod else 256
    t0 = time.time()
    dist.init_process_group("fake", store=_fake_store(), rank=0,
                            world_size=world)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        cfg = get_arch(arch, smoke=smoke)
        shape = SHAPES[shape_name]
        axes, dp_size = dmesh.data_axes(mesh)
        if variant:
            cfg = VARIANTS[variant](cfg, dp_size)
            arch = f"{arch}+{variant}"
        api = get_model(cfg, tp_size=MODEL_AXIS, dp_size=dp_size, mesh=mesh,
                        device="cpu")
        dmesh.axis_group(mesh, axes)    # built before the fake mode
        b = shape.global_batch
        b_local = b // dp_size if b % dp_size == 0 else b
        with FakeTensorMode():
            whole = get_model(cfg, device="cpu").init(0)
            counts = model_counts(whole, cfg, shape)
            n_params = counts["n_params"]
            params = shard_lm(whole, cfg, api.tp.rank, api.tp.size)
            del whole
            specs = api.input_specs(shape)
            with dmesh.tally() as bill:
                if shape.kind == "train":
                    if opt_dtype is None:
                        opt_dtype = ("bfloat16" if n_params > 1e11
                                     else "float32")
                    tcfg = TrainConfig(opt_state_dtype=opt_dtype)
                    opt = adamw_init(params, tcfg)
                    batch = _batch(specs, b_local)
                    args = (params, opt, batch)
                    step = make_train_step(api, tcfg, mesh=mesh)
                    fn = lambda: step(params, opt, batch)   # noqa: E731
                elif shape.kind == "prefill":
                    batch = _batch(specs, b_local)
                    args = (params, batch)

                    def fn():
                        with torch.no_grad():
                            return api.prefill(params, batch,
                                               max_len=shape.seq_len)
                else:
                    local = dataclasses.replace(shape, global_batch=b_local)
                    cache = {name: torch.zeros(s, dtype=dt) for name, (s, dt)
                             in api.cache_specs(local).items()}
                    token = torch.zeros(b_local, dtype=torch.long)
                    args = (params, cache, token)

                    def fn():
                        with torch.no_grad():
                            return api.decode(params, cache, token,
                                              shape.seq_len - 1)
                argument_bytes = _nbytes(args)
                peak = _FakePeak(argument_bytes)
                with peak:
                    cost = cost_of(fn)
        calls = list(bill.calls)
    finally:
        dist.destroy_process_group()

    return {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        **counts,
        "flops_per_device": cost.flops,
        "bytes_per_device": cost.bytes,
        "loop_aware": {
            "flops_per_device": cost.flops,
            "flops_by_precision": cost.flops_by_precision,
            "bytes_per_device": cost.bytes,
            "collective_bytes_by_kind": cost.coll,
            "collective_counts": cost.coll_counts,
            "collective_bytes": cost.coll_bytes,
        },
        "problem": {"world": world, "model_axis": MODEL_AXIS,
                    "data_axes": dp_size, "batch_per_rank": b_local,
                    "opt_state_dtype": opt_dtype},
        "memory_analysis": {"argument_bytes": argument_bytes,
                            "peak_bytes": peak.peak,
                            "allocated_bytes": cost.allocated},
        "collectives": ring_bytes(calls),
        "trace_seconds": round(time.time() - t0, 2),
        "ok": True,
    }


def model_counts(whole, cfg, shape) -> dict:
    """The reference's model terms of a cell from the whole parameter tree
    (fake tensors will do): ``n_params``, ``n_active_params`` (the ``e_``
    leaves scaled by top_k / n_experts), ``tokens_per_step`` (B S to train
    and prefill, B to decode one token) and ``model_flops_total`` (6 N_act
    tokens to train, 2 N_act tokens otherwise)."""
    n_params = sum(t.numel() for t in _leaves(whole))
    expert = sum(t.numel() for name, t in _named(whole)
                 if name.startswith("e_"))
    n_active = n_params
    if cfg.n_experts:
        n_active = n_params - expert \
            + expert * cfg.moe_top_k // cfg.n_experts
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    mult = 6.0 if shape.kind == "train" else 2.0
    return {"n_params": int(n_params), "n_active_params": int(n_active),
            "tokens_per_step": int(tokens),
            "model_flops_total": mult * n_active * tokens}


def _named(tree, name=""):
    """(leaf name, tensor) pairs of a nest of dicts and lists."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _named(v, k)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _named(v, name)]
    return [(name, tree)]


def main(argv=None):
    ap = argparse.ArgumentParser(description="multi-pod dry run of the LM "
                                             "cells")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--variant", default=None, choices=sorted(VARIANTS))
    ap.add_argument("--out", default="build/dryrun")
    args = ap.parse_args(argv)
    if not args.all and (args.arch is None or args.shape is None):
        ap.error("--arch and --shape, or --all, are required")

    todo = cells() if args.all else [(args.arch, args.shape)]
    meshes = [False, True] if (args.both_meshes or args.all) \
        else [args.multi_pod]
    os.makedirs(args.out, exist_ok=True)
    n_fail = 0
    for arch, shape in todo:
        for mp in meshes:
            vtag = f"+{args.variant}" if args.variant else ""
            tag = f"{arch}{vtag}__{shape}__{'mp' if mp else 'sp'}"
            path = os.path.join(args.out, tag + ".json")
            if os.path.exists(path):
                print(f"[skip] {tag} (cached)")
                continue
            try:
                res = lower_cell(arch, shape, multi_pod=mp, smoke=args.smoke,
                                 variant=args.variant)
                print(f"[ok]   {tag}  trace={res['trace_seconds']}s "
                      f"flops/dev={res['flops_per_device']:.3e} "
                      f"coll={res['collectives']['total_bytes']:.3e}B")
            except Exception as e:
                n_fail += 1
                res = {"arch": arch + vtag, "shape": shape,
                       "mesh": "2x16x16" if mp else "16x16", "ok": False,
                       "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()}
                print(f"[FAIL] {tag}: {type(e).__name__}: {e}")
            with open(path, "w") as f:
                json.dump(res, f, indent=1)
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
