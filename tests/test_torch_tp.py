"""The port's model axis (Megatron-style tensor parallelism of every family:
``get_model(tp_size=, mesh=)``, ``convert.shard_lm``,
``launch.train --mesh DxM``, ``launch.serve --mesh``) against the port's
world-1 run and the JAX package's single-device run, on the CPU.

The oracle: the JAX package's f32 ``init_lm`` / ``init_zamba`` parameters
of each smoke config (converted by ``convert.lm_params_from_numpy``), its
prefill logits, 8 greedy decode tokens, loss and grads on a seeded batch,
made once per module in this process. The port runs the same parameters,
cut for each rank by ``convert.shard_lm``, in spawned gloo worlds: one
spawn per world size (2: the (1, 2) mesh; 4: (1, 4) and (2, 2)), which
returns every case, each case then its own parametrised test. Each rank
also runs the port's world-1 model on the whole parameters. The configs:
olmo-1b (KH 4: the ``heads`` K/V policy), qwen3-32b (KH 2: ``heads`` at 2,
``seq`` at 4), gemma2-2b (softcaps, the sliding window's ring, ``seq`` at
4), qwen3-moe-235b-a22b (dense dispatch; at (2, 2) also the expert-parallel
dispatch with a model axis, ``qwen3-moe-ep``), zamba2-2.7b (the Mamba2
head split and the shared block), seamless-m4t-medium (KH 4: ``heads`` on
the self and cross caches; at (1, 4) also ``seamless-kh2``, KH 2, the
``seq`` policy on both caches) and rwkv6-7b (2 heads: worlds (1, 2) and
(2, 2), and at (1, 4) split mid-head, two ranks a head). At (1, 4) five
more variants split each head over two ranks (``MID``): olmo-1b with H =
KH = 2, gemma2-2b with H 2, KH 1 (softcaps, the window of 8) and with a
window of 6 (the ``seq`` cache padded to 8 slots, its ring wrapping in
prefill and decode), seamless with H = KH = 2 (self- and
cross-attention), and zamba2 with ``ssm_expand`` 1 (2 Mamba2 heads of 64
channels) and an H = KH = 2 shared block.

Tolerances, and why (f32 throughout):
- prefill and decode logits: 1e-5 normwise. The split products are summed
  by all_reduce in another order than one product sums them.
- greedy tokens: equal, every rank, token for token.
- loss: 1e-5 relative; grads gathered whole: 1e-4 normwise per leaf (the
  backward's sums reorder too, through two layers); a leaf every rank
  holds whole has bitwise equal grads on every model rank.
- one AdamW step's parameters: 1e-5 normwise per leaf against the world-1
  step (whose AdamW the train tests hold to the reference's); RWKV6's
  zero-initialized ``w0``, whose value after the step is the bare
  normalized update, 1e-4 (``_step_limit``).
- the expert-parallel MoE at (2, 2) against the world-1 grouped path with
  G = 4 groups (the reference's grouping: a data rank holds one row, a
  model rank half of its positions), with drops (capacity factor 0.5).
- ``launch.train --mesh`` runs f32 parameters (``run(dtype=)``) and is held
  to 1e-5: a 1x2 run to the 1x1 run, a 2x2 run to a 1x1 run of 2
  microbatches (each data rank's half batch is one microbatch), and a
  checkpoint of either mesh resumed at the other to the resume at its own
  mesh (the launcher's resume restarts the batch stream, so resumed runs
  are compared with resumed runs).
"""
import dataclasses
import datetime
import os
import pickle
import shutil
import time
import traceback

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.distributed.compat import make_mesh
from repro.models import Axes
from repro.models import get_model as jax_get_model
from repro_torch import convert
from repro_torch.configs import get_arch

AXES = Axes(dp=("data",), tp="model")
SEAMLESS, RWKV = "seamless-m4t-medium", "rwkv6-7b"
ARCHS = ["olmo-1b", "qwen3-32b", "gemma2-2b", "qwen3-moe-235b-a22b",
         "zamba2-2.7b", SEAMLESS, RWKV]
EP = "qwen3-moe-ep"            # qwen3-moe with the expert-parallel dispatch
KH2 = "seamless-kh2"           # seamless with KH 2: ``seq`` at a model of 4
#: variants whose heads split mid-head at a model axis of 4: key -> (arch,
#: config changes)
MID = {"olmo-h2": ("olmo-1b", dict(n_heads=2, n_kv_heads=2)),
       "gemma2-h2": ("gemma2-2b", dict(n_heads=2, n_kv_heads=1)),
       "gemma2-h2-w6": ("gemma2-2b", dict(n_heads=2, n_kv_heads=1,
                                          window=6)),
       "seamless-h2": (SEAMLESS, dict(n_heads=2, n_kv_heads=2)),
       "zamba2-h2": ("zamba2-2.7b", dict(n_heads=2, n_kv_heads=2,
                                         ssm_expand=1))}
#: mesh name -> (world, axes)
MESHES = {"1x2": (2, {"data": 1, "model": 2}),
          "1x4": (4, {"data": 1, "model": 4}),
          "2x2": (4, {"data": 2, "model": 2})}
B, S, MAX_LEN, N_DECODE = 2, 8, 16, 8
S_ENC = 8                      # seamless's encoder frames
DEADLINE = 300.0
TRAIN = ["--arch", "olmo-1b", "--smoke", "--device", "cpu", "--batch", "2",
         "--seq", "16", "--lr", "1e-3", "--log-every", "1"]
SERVE = ["--arch", "olmo-1b", "--smoke", "--device", "cpu", "--requests",
         "3", "--max-new-tokens", "4"]


def _cfg(key, jax_side=False):
    arch = {EP: "qwen3-moe-235b-a22b", KH2: SEAMLESS,
            **{k: a for k, (a, _) in MID.items()}}.get(key, key)
    cfg = (jax_get_arch if jax_side else get_arch)(arch, smoke=True)
    if key == KH2:
        return dataclasses.replace(cfg, n_kv_heads=2)
    if key in MID:
        return dataclasses.replace(cfg, **MID[key][1])
    return dataclasses.replace(cfg, moe_ep_groups=4) if key == EP else cfg


def _tokens():
    rng = np.random.default_rng(5)
    return rng.integers(1, 256, size=(B, S)).astype(np.int32)


def _frames(key):
    """seamless's encoder input [B, S_ENC, D] f32, or None."""
    cfg = _cfg(key)
    if cfg.family != "encdec":
        return None
    return np.random.default_rng(6).normal(
        size=(B, S_ENC, cfg.d_model)).astype(np.float32)


def _with_frames(batch, key, rows=slice(None), as_torch=True):
    """``batch`` plus the encoder frames of ``rows`` for seamless."""
    f = _frames(key)
    if f is not None:
        batch = dict(batch, frames=torch.from_numpy(f[rows]) if as_torch
                     else jnp.asarray(f[rows]))
    return batch


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    den = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / den) if den else \
        float(np.linalg.norm(got))


def _flat_t(tree, prefix=""):
    """{path: leaf} of a nest of dicts and lists."""
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in
                _flat_t(tree[key], f"{prefix}{key}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, x in enumerate(tree) for k, v in
                _flat_t(x, f"{prefix}{i}/").items()}
    return {prefix[:-1]: tree}


def _flat(tree):
    """{path: f32 numpy array} of a nest of dicts and lists."""
    return {k: (v.detach().to(torch.float32).numpy()
                if isinstance(v, torch.Tensor) else np.asarray(v, np.float32))
            for k, v in _flat_t(tree).items()}


# ---------------------------------------------------------------------------
# the oracle: the JAX package on one device
# ---------------------------------------------------------------------------


def _reference(key) -> dict:
    jcfg = _cfg(key, jax_side=True)
    japi = jax_get_model(jcfg, tp_size=1)
    dec_api = jax_get_model(dataclasses.replace(jcfg, moe_ep_groups=0),
                            tp_size=1)
    jparams, specs = japi.init(jax.random.PRNGKey(0), jnp.float32)
    tok = jnp.asarray(_tokens())
    batch = {"tokens": tok, "labels": jnp.roll(tok, -1, axis=1)}
    batch = _with_frames(batch, key, as_torch=False)
    with make_mesh((1, 1), ("data", "model")):
        cache, logits = japi.prefill(
            jparams, _with_frames({"tokens": tok}, key, as_torch=False),
            AXES, max_len=MAX_LEN)
        out = {"logits": np.asarray(logits)}
        t = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        toks = [np.asarray(t)]
        for i in range(N_DECODE - 1):
            logits, cache = dec_api.decode(jparams, cache, t,
                                           jnp.asarray(S + i, jnp.int32),
                                           AXES)
            t = jnp.argmax(logits, axis=-1).astype(jnp.int32)
            toks.append(np.asarray(t))
        loss, grads = jax.value_and_grad(
            lambda p: japi.loss(p, batch, AXES, remat=False))(jparams)
    np_params = jax.tree.map(np.asarray, jparams)
    return {"params": np_params, "specs": specs, "tokens": np.stack(toks),
            "loss": float(loss), **out,
            "grads": _flat(convert.lm_params_from_numpy(
                jax.tree.map(np.asarray, grads), _cfg(key), "cpu",
                torch.float32))}


@pytest.fixture(scope="module")
def reference():
    return {key: _reference(key) for key in ARCHS + [EP, KH2, *MID]}


# ---------------------------------------------------------------------------
# the spawned worlds
# ---------------------------------------------------------------------------


def _cases_of(mesh_name):
    """KH2 is ``seq`` only at a model axis of 4, and the MID variants split
    mid-head only there (as RWKV6's 2 heads do)."""
    model = MESHES[mesh_name][1]["model"]
    return (ARCHS + ([EP] if mesh_name == "2x2" else [])
            + ([KH2, *MID] if model == 4 else []))


def _model_case(key, mesh, ref):
    """One config on one mesh: this rank's results and its world-1 run's."""
    from repro_torch.configs import TrainConfig
    from repro_torch.distributed import mesh as dmesh
    from repro_torch.models import get_model
    from repro_torch.models.common import TP
    from repro_torch.training import adamw_init, make_train_step
    from repro_torch.training.optim import tree_leaves, tree_unflatten

    cfg = _cfg(key)
    tp = TP.of(mesh)
    d, dp = mesh.get_local_rank("data"), mesh.size(0)
    full = convert.lm_params_from_numpy(ref["params"], cfg, "cpu",
                                        torch.float32)
    w1 = get_model(cfg, device="cpu")
    w1_dec = get_model(dataclasses.replace(cfg, moe_ep_groups=0),
                       device="cpu")
    api = get_model(cfg, tp_size=tp.size, dp_size=dp, mesh=mesh,
                    device="cpu")
    params = convert.shard_lm(full, cfg, tp.rank, tp.size)
    tok = torch.as_tensor(_tokens(), dtype=torch.long)
    # the expert-parallel dispatch takes each data rank's share; the other
    # configs serve the same requests on every rank
    rows = slice(d, d + 1) if key == EP else slice(0, B)

    def greedy(a, dec, p, rows):
        cache, logits = a.prefill(p, _with_frames({"tokens": tok[rows]}, key,
                                                  rows), max_len=MAX_LEN)
        first = logits
        t = torch.argmax(logits, dim=-1)
        toks = [t]
        for i in range(N_DECODE - 1):
            logits, cache = dec.decode(p, cache, t, S + i)
            t = torch.argmax(logits, dim=-1)
            toks.append(t)
        return first.numpy(), torch.stack(toks).numpy(), logits.numpy()

    out = {}
    with torch.no_grad():
        out["logits"], out["tokens"], out["last"] = greedy(api, api, params,
                                                           rows)
        w1_run = greedy(w1, w1_dec, full, slice(0, B))
    out["w1_logits"] = w1_run[0][rows]
    out["w1_tokens"] = w1_run[1][:, rows]
    out["w1_last"] = w1_run[2][rows]

    share = slice(d * B // dp, (d + 1) * B // dp)
    batch = _with_frames({"tokens": tok[share],
                          "labels": torch.roll(tok, -1, 1)[share]}, key,
                         share)
    whole = _with_frames({"tokens": tok, "labels": torch.roll(tok, -1, 1)},
                         key)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = api.loss(params, batch, remat=True)
    grads = torch.autograd.grad(loss, leaves)
    if dp > 1:
        grads = [dmesh.all_reduce(g, mesh, "data") / dp for g in grads]
        loss = dmesh.all_reduce(loss.detach(), mesh, "data") / dp
    out["loss"] = float(loss)
    gtree = tree_unflatten(params, [g.detach() for g in grads])
    out["grads"] = _flat(convert.whole_lm(gtree, cfg, tp))
    out["rep_diff"] = _replicated_spread(gtree, cfg, tp)
    wl = tree_leaves(full)
    for p in wl:
        p.requires_grad_(True)
    w1_loss = w1.loss(full, whole, remat=False)
    out["w1_loss"] = float(w1_loss)
    out["w1_grads"] = _flat(tree_unflatten(
        full, list(torch.autograd.grad(w1_loss, wl))))

    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    p_tp = convert.shard_lm(full, cfg, tp.rank, tp.size)
    p_tp = make_train_step(api, tcfg, mesh=mesh)(
        p_tp, adamw_init(p_tp, tcfg), batch)[0]
    p_w1 = convert.shard_lm(full, cfg, 0, 1)
    p_w1 = make_train_step(w1, tcfg)(p_w1, adamw_init(p_w1, tcfg), whole)[0]
    got, want = _flat(convert.whole_lm(p_tp, cfg, tp)), _flat(p_w1)
    out["step_rel"] = {k: _rel(got[k], want[k]) for k in want}
    return out


def _replicated_spread(gtree, cfg, tp) -> float:
    """The largest difference between the model ranks' grads of the parts
    every rank holds whole (leaves the layout keeps whole, and the B and C
    columns of the Mamba2 leaves)."""
    from repro_torch.distributed import mesh as dmesh
    layout = convert.tp_layout(cfg, tp.size)
    worst = 0.0
    for path, g in _flat_t(gtree).items():
        name = path.rsplit("/", 1)[-1]
        how = layout.get(name)
        if how is not None and how != "mamba":
            continue
        if how == "mamba":
            parts = convert._mamba_parts(cfg, name, tp.size)
            pieces = torch.split(g, [w for w, _ in parts], dim=-1)
            g = torch.cat([x.reshape(-1) for x, (_, c) in zip(pieces, parts)
                           if not c])
        every = dmesh.all_gather(g[None].contiguous(), tp.mesh, "model")
        worst = max(worst, float((every - every[:1]).abs().max()))
    return worst


def _bill_case(mesh):
    """The collective bill of one dense layer's forward (olmo-1b), of one
    RWKV6 channel mix, and at (2, 2) of the expert-parallel MoE layer."""
    from repro_torch.distributed.mesh import tally
    from repro_torch.models import rwkv, transformer
    from repro_torch.models.common import TP, TP1
    from repro_torch.models.mlp import moe_block
    tp = TP.of(mesh)
    cfg = get_arch("olmo-1b", smoke=True)
    full = transformer.init_lm(cfg, torch.Generator().manual_seed(0),
                               torch.float32, "cpu")
    layer = convert.shard_lm(full, cfg, tp.rank, tp.size)["layers"][0]
    x = torch.randn((B, S, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1))
    out = {}
    for name, ctx, lay in (("tp", tp, layer), ("tp1", TP1,
                                               full["layers"][0])):
        with torch.no_grad(), tally() as t:
            transformer._block_fwd(lay, x, cfg, "global", tp=ctx)
        out[name] = _bill(t)
    rcfg = get_arch(RWKV, smoke=True)
    lay = convert.shard_lm(rwkv.init_rwkv_lm(
        rcfg, torch.Generator().manual_seed(0), torch.float32, "cpu"), rcfg,
        tp.rank, tp.size)["layers"][0]
    xr = torch.randn((B, S, rcfg.d_model), generator=torch.Generator()
                     .manual_seed(1))
    with torch.no_grad(), tally() as t:
        rwkv.channel_mix(lay, xr, rcfg, tp=tp)
    out["rwkv_cm"] = _bill(t)
    if tp.size == 4:          # mid-head: two ranks a head
        with torch.no_grad(), tally() as t:
            rwkv.time_mix(lay, xr, rcfg, tp=tp)
        out["rwkv_tm"] = _bill(t)
        hcfg = _cfg("olmo-h2")
        hl = convert.shard_lm(transformer.init_lm(
            hcfg, torch.Generator().manual_seed(0), torch.float32, "cpu"),
            hcfg, tp.rank, tp.size)["layers"][0]
        xh = x.clone().requires_grad_(True)
        hl["wq"].requires_grad_(True)
        with tally() as t:
            y, _ = transformer._block_fwd(hl, xh, hcfg, "global", tp=tp)
            torch.autograd.grad(y.sum(), [hl["wq"], xh])
        out["mid"] = _bill(t)
    if mesh.size(0) == 2:
        mcfg = dataclasses.replace(_cfg(EP), capacity_factor=0.5)
        pm = convert.shard_lm(transformer.init_lm(
            mcfg, torch.Generator().manual_seed(0), torch.float32, "cpu"),
            mcfg, tp.rank, tp.size)["layers"][0]
        d = mesh.get_local_rank("data")
        with torch.no_grad(), tally() as t:
            moe_block(pm, x[d:d + 1], mcfg, tp=tp)
        out["ep"] = _bill(t)
    return out


def _bill(t) -> dict:
    """A tally's counters, and its calls as (kind, bytes, group size)."""
    out = t.summary()
    out["calls"] = list(t.calls)
    return out


def _ep_layer_case(mesh):
    """The expert-parallel MoE layer at (2, 2) with drops (capacity factor
    0.5): outputs, the data-summed grads (experts gathered over model)
    and the input's grads, with the world-1 grouped path's (G = 4)."""
    from repro_torch.distributed import mesh as dmesh
    from repro_torch.models import transformer
    from repro_torch.models.common import TP
    from repro_torch.models.mlp import moe_block, route, slot_positions
    tp = TP.of(mesh)
    d = mesh.get_local_rank("data")
    cfg = dataclasses.replace(_cfg(EP), capacity_factor=0.5)
    full = transformer.init_lm(cfg, torch.Generator().manual_seed(0),
                               torch.float32, "cpu")["layers"][0]
    names = ["router", "e_gate", "e_up", "e_down"]
    full = {k: full[k] for k in names}
    gen = torch.Generator().manual_seed(2)
    x = torch.randn((B, 32, cfg.d_model), generator=gen)
    cot = torch.randn((B, 32, cfg.d_model), generator=gen)
    p = convert.shard_lm(full, cfg, tp.rank, tp.size)
    for v in p.values():
        v.requires_grad_(True)
    xl = x[d:d + 1].clone().requires_grad_(True)
    y = moe_block(p, xl, cfg, tp=tp)
    grads = torch.autograd.grad((y * cot[d:d + 1]).sum(), [*p.values(), xl])
    gp = {k: dmesh.all_reduce(g, mesh, "data") for k, g in zip(p, grads)}
    whole = convert.gather_lm([{k: dmesh.all_gather(
        v[None], mesh, "model")[r] for k, v in gp.items()}
        for r in range(tp.size)], cfg)
    for v in full.values():
        v.requires_grad_(True)
    xw = x.clone().requires_grad_(True)
    yw = moe_block(full, xw, cfg)
    gw = torch.autograd.grad((yw * cot).sum(), [*full.values(), xw])
    # the grouped path's drops: slots at or past a group's capacity
    groups, k = 4, cfg.moe_top_k
    tg = B * x.shape[1] // groups
    cap = max(8, -(-int(tg * k / cfg.n_experts * cfg.capacity_factor)
                  // 8) * 8)
    _, top_e = route(x.reshape(groups, tg, -1), full["router"].detach(), k)
    dropped = int((slot_positions(top_e.reshape(groups, -1),
                                  cfg.n_experts) >= cap).sum())
    return {"out_rel": _rel(y.detach(), yw[d:d + 1].detach()),
            "x_grad_rel": _rel(grads[-1], gw[-1][d:d + 1]),
            "grad_rel": {k: _rel(whole[k], g) for k, g in zip(full, gw)},
            "dropped_slots": dropped}


def _launch_cases(world, out_dir, mesh_names):
    """The launchers over the whole world (every rank calls)."""
    from repro_torch.launch import serve, train
    out = {}
    if world == 2:
        out["train"] = train.run(TRAIN + ["--mesh", "1x2", "--steps", "2"],
                                 dtype=torch.float32).losses
        ck = os.path.join(out_dir, "ck-1x2")
        train.run(TRAIN + ["--mesh", "1x2", "--steps", "2", "--ckpt-dir", ck,
                           "--ckpt-every", "2"], dtype=torch.float32)
        own = os.path.join(out_dir, "ck-1x2-own")
        if torch.distributed.get_rank() == 0:
            shutil.copytree(ck, own)
        torch.distributed.barrier()
        out["resume_own"] = train.run(
            TRAIN + ["--mesh", "1x2", "--steps", "4", "--ckpt-dir", own,
                     "--ckpt-every", "100", "--resume"],
            dtype=torch.float32).losses
        out["resume_1x1"] = train.run(
            TRAIN + ["--mesh", "1x2", "--steps", "4", "--ckpt-dir",
                     os.path.join(out_dir, "ck-1x1"), "--ckpt-every", "100",
                     "--resume"], dtype=torch.float32).losses
        out["serve"] = serve.main(SERVE + ["--mesh", "1x2"])
    if "2x2" in mesh_names:
        out["train_2x2"] = train.run(
            TRAIN + ["--mesh", "2x2", "--steps", "2"],
            dtype=torch.float32).losses
    return out


def _child(rank, world, store_path, out_dir, mesh_names, refs):
    import warnings
    warnings.simplefilter("ignore")
    torch.set_num_threads(1)
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    from repro_torch.distributed.mesh import make_test_mesh
    got = {}
    try:
        for name in mesh_names:
            mesh = make_test_mesh(MESHES[name][1], device="cpu")
            got[name] = {}
            for key in _cases_of(name):
                try:
                    got[name][key] = _model_case(key, mesh, refs[key])
                except Exception:
                    got[name][key] = {"error": traceback.format_exc()}
            for case, fn in (("bill", _bill_case), ("ep_layer",
                                                    _ep_layer_case)):
                if case == "ep_layer" and name != "2x2":
                    continue
                try:
                    got[name][case] = fn(mesh)
                except Exception:
                    got[name][case] = {"error": traceback.format_exc()}
        try:
            got["launch"] = _launch_cases(world, out_dir, mesh_names)
        except Exception:
            got["launch"] = {"error": traceback.format_exc()}
    except Exception:
        got = {"error": traceback.format_exc()}
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(got, f)
    dist.destroy_process_group()


def _spawn(world, out_dir, mesh_names, refs):
    import torch.multiprocessing as mp
    store = os.path.join(out_dir, "store")
    ctx = mp.start_processes(_child, args=(world, store, out_dir, mesh_names,
                                           refs),
                             nprocs=world, join=False, start_method="spawn")
    t0 = time.monotonic()
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() - t0 > DEADLINE:
                pytest.fail(f"a world of {world} ranks passed its "
                            f"{DEADLINE} s deadline")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    ranks = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
        assert "error" not in ranks[-1], ranks[-1].get("error")
    return ranks


@pytest.fixture(scope="module")
def worlds(reference, tmp_path_factory):
    """{world size: every rank's results}; the 1x1 checkpoint the world of
    2 resumes is written here first."""
    from repro_torch.launch import train
    refs = {k: {"params": v["params"]} for k, v in reference.items()}
    out = {}
    for world in (2, 4):
        d = str(tmp_path_factory.mktemp(f"tp-world{world}"))
        if world == 2:
            train.run(TRAIN + ["--steps", "2", "--ckpt-dir",
                               os.path.join(d, "ck-1x1"), "--ckpt-every",
                               "2"], dtype=torch.float32)
        names = [n for n, (w, _) in MESHES.items() if w == world]
        out[world] = (d, _spawn(world, d, names, refs))
    return out


def _result(worlds, mesh_name, case):
    world = MESHES[mesh_name][0]
    ranks = worlds[world][1]
    got = [r[mesh_name][case] for r in ranks]
    for g in got:
        assert "error" not in g, g["error"]
    return got


# ---------------------------------------------------------------------------
# the model cases
# ---------------------------------------------------------------------------

CASES = [(m, k) for m in MESHES for k in _cases_of(m)]


@pytest.mark.parametrize("mesh_name,key", CASES,
                         ids=[f"{m}-{k}" for m, k in CASES])
def test_prefill_and_greedy_decode_match(worlds, reference, mesh_name, key):
    ranks = _result(worlds, mesh_name, key)
    ref = reference[key]
    d_of = (lambda r: r // 2) if mesh_name == "2x2" else (lambda r: 0)
    for r, got in enumerate(ranks):
        rows = slice(d_of(r), d_of(r) + 1) if key == EP else slice(0, B)
        assert _rel(got["logits"], got["w1_logits"]) <= 1e-5
        assert _rel(got["logits"], ref["logits"][rows]) <= 1e-5
        assert _rel(got["last"], got["w1_last"]) <= 1e-5
        np.testing.assert_array_equal(got["tokens"], got["w1_tokens"])
        np.testing.assert_array_equal(got["tokens"], ref["tokens"][:, rows])


@pytest.mark.parametrize("mesh_name,key", CASES,
                         ids=[f"{m}-{k}" for m, k in CASES])
def test_loss_grads_and_step_match(worlds, reference, mesh_name, key):
    ranks = _result(worlds, mesh_name, key)
    ref = reference[key]
    for got in ranks:
        assert abs(got["loss"] - got["w1_loss"]) <= 1e-5 * got["w1_loss"]
        assert abs(got["loss"] - ref["loss"]) <= 1e-5 * ref["loss"]
        assert sorted(got["grads"]) == sorted(ref["grads"])
        for path, want in ref["grads"].items():
            assert _rel(got["grads"][path], got["w1_grads"][path]) <= 1e-4, \
                path
            assert _rel(got["grads"][path], want) <= 1e-4, path
        assert got["rep_diff"] == 0.0
        for path, rel in got["step_rel"].items():
            assert rel <= _step_limit(key, path), (path, rel)


def _step_limit(key, path) -> float:
    """1e-5, but 1e-4 for RWKV6's ``w0``: it starts at zero, so after one
    step it IS AdamW's normalized update g / (|g| + eps), and its clipped
    grads reach 8e-8 beside eps = 1e-8, where the update moves with the
    grad's own f32 noise (0.3% on such an element, the same as between
    the world-1 run and the reference; 2.3e-5 measured at (1, 2))."""
    return 1e-4 if key == RWKV and path.endswith("/w0") else 1e-5


def test_the_model_axis_bill(worlds):
    """One dense layer's forward: two all_reduces of [B, S, D] f32 at tp >
    1, none at one rank; one RWKV6 channel mix: one reduce_scatter and one
    all_gather of [B, S, D] f32 (each rank sends in, and gets back, the
    whole row block); the expert-parallel MoE layer at (2, 2): its two
    data exchanges of the [E, G/D, cap, D] f32 slot buffer, the model
    all_gather of the slots, the reduce_scatter back and the all_gather
    of the positions' outputs."""
    nbytes = B * S * get_arch("olmo-1b", smoke=True).d_model * 4
    rbytes = B * S * get_arch(RWKV, smoke=True).d_model * 4
    for mesh_name in MESHES:
        m = MESHES[mesh_name][1]["model"]
        for got in _result(worlds, mesh_name, "bill"):
            assert got["tp"]["psum"] == 2
            assert got["tp"]["psum_bytes"] == 2 * nbytes
            assert got["tp"]["allgather"] == got["tp"]["reducescatter"] == 0
            assert all(v == 0 for k, v in got["tp1"].items() if k != "calls")
            assert got["tp1"]["calls"] == []
            cm = got["rwkv_cm"]
            assert (cm["psum"], cm["allgather"], cm["reducescatter"],
                    cm["alltoall"]) == (0, 1, 1, 0)
            assert cm["reducescatter_bytes"] == cm["allgather_bytes"] \
                == rbytes
            assert sorted(cm["calls"]) == [("all-gather", rbytes, m),
                                           ("reduce-scatter", rbytes // m,
                                            m)]
            if mesh_name == "2x2":
                ep = got["ep"]
                assert (ep["alltoall"], ep["allgather"], ep["reducescatter"],
                        ep["psum"]) == (2, 2, 1, 0)
                # a data rank's row, its model rank's S/2 positions
                mcfg = _cfg(EP)
                cap = max(8, -(-int(S // 2 * mcfg.moe_top_k / mcfg.n_experts
                                    * 0.5) // 8) * 8)
                slots = mcfg.n_experts * cap * mcfg.d_model * 4
                assert ep["alltoall_bytes"] == 2 * slots
                assert [c for c in ep["calls"] if c[0] == "all-to-all"] \
                    == [("all-to-all", slots, 2)] * 2


def test_the_mid_head_bill(worlds):
    """At (1, 4), two ranks a head. One olmo-h2 layer forward and its
    backward to wq and the input: the forward's two all_reduces of [B, S,
    D] f32 and one all_gather of q over the whole model axis ([B, S, H dh]
    f32, r = 2 times the group's head); the backward's reduce_scatter of
    that gather's gradient, and the two all_reduces of tp.copy's input
    gradients (attention's and the MLP's). One RWKV6 time mix: one
    all_gather of r | k | decay ([B, S, 3 D] f32), one of u ([D] f32) and
    one of the partial sums of squares ([B, S, M] f32), and the output's
    all_reduce of [B, S, D]."""
    hcfg, rcfg = _cfg("olmo-h2"), get_arch(RWKV, smoke=True)
    d = hcfg.d_model
    q = B * S * hcfg.n_heads * hcfg.d_head * 4
    for got in _result(worlds, "1x4", "bill"):
        mid = got["mid"]
        assert sorted(mid["calls"]) == sorted(
            [("all-reduce", B * S * d * 4, 4)] * 4
            + [("all-gather", q, 4), ("reduce-scatter", q // 4, 4)])
        tm = got["rwkv_tm"]
        rd = rcfg.d_model
        assert sorted(tm["calls"]) == sorted(
            [("all-gather", B * S * 3 * rd * 4, 4), ("all-gather", rd * 4, 4),
             ("all-gather", B * S * 4 * 4, 4),
             ("all-reduce", B * S * rd * 4, 4)])


def test_expert_parallel_layer_with_drops_matches_grouped_path(worlds):
    for got in _result(worlds, "2x2", "ep_layer"):
        assert got["dropped_slots"] > 0
        assert got["out_rel"] <= 1e-5
        assert got["x_grad_rel"] <= 1e-5
        for name, rel in got["grad_rel"].items():
            assert rel <= 1e-5, (name, rel)


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------


def _launch(worlds, world):
    ranks = worlds[world][1]
    for r in ranks:
        assert "error" not in r["launch"], r["launch"]["error"]
    return [r["launch"] for r in ranks]


def test_launch_train_mesh_1x2_matches_one_process(worlds):
    from repro_torch.launch import train
    want = train.run(TRAIN + ["--steps", "2"], dtype=torch.float32).losses
    for got in _launch(worlds, 2):
        np.testing.assert_allclose(got["train"], want, rtol=1e-5)


def test_launch_train_mesh_2x2_matches_microbatches(worlds):
    from repro_torch.launch import train
    want = train.run(TRAIN + ["--steps", "2", "--microbatches", "2"],
                     dtype=torch.float32).losses
    for got in _launch(worlds, 4):
        np.testing.assert_allclose(got["train_2x2"], want, rtol=1e-5)


def test_checkpoints_resume_across_meshes(worlds):
    """A 1x2 checkpoint resumed at 1x1 equals its resume at 1x2, a 1x1
    checkpoint resumed at 1x2 equals its resume at 1x1, and both hold the
    reference's leaves."""
    from repro_torch.ft.checkpoint import CheckpointManager
    from repro_torch.launch import train
    out_dir = worlds[2][0]
    got = _launch(worlds, 2)
    ck12 = os.path.join(out_dir, "ck-1x2")
    at_1x1 = train.run(TRAIN + ["--steps", "4", "--ckpt-dir", ck12,
                                "--ckpt-every", "100", "--resume"],
                       dtype=torch.float32).losses
    own_1x1 = train.run(TRAIN + ["--steps", "4", "--ckpt-dir",
                                 os.path.join(out_dir, "ck-1x1"),
                                 "--ckpt-every", "100", "--resume"],
                        dtype=torch.float32).losses
    for g in got:
        np.testing.assert_allclose(at_1x1, g["resume_own"], rtol=1e-5)
        np.testing.assert_allclose(g["resume_1x1"], own_1x1, rtol=1e-5)
    m12 = CheckpointManager(ck12)._manifest(2)["leaves"]
    m11 = CheckpointManager(os.path.join(out_dir, "ck-1x1"))._manifest(2)[
        "leaves"]
    assert {k: v["shape"] for k, v in m12.items()} == \
        {k: v["shape"] for k, v in m11.items()}


def test_launch_serve_mesh_1x2_emits_the_one_process_tokens(worlds):
    from repro_torch.launch import serve
    want = serve.main(SERVE)
    for got in _launch(worlds, 2):
        assert got["serve"] == want


# ---------------------------------------------------------------------------
# shard_lm / gather_lm, and the refusals (this process)
# ---------------------------------------------------------------------------


def _spec_dim(spec):
    dims = [i for i, a in enumerate(tuple(spec)) if a == "model"]
    return dims[0] if dims else None


#: RWKV6 leaves the port cuts to the rank's heads where the reference's
#: specs keep them whole: the time mix's per-channel leaves, so that the
#: decay and the group norm are computed for the rank's channels only
_RWKV_CUT = {"u": 0, "w0": 0, "ln_x": 0, "w2": 1}


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("key", ARCHS)
def test_shard_lm_follows_the_reference_specs(reference, key, size):
    _check_shards(reference, key, size)


@pytest.mark.parametrize("key", list(MID))
def test_shard_lm_mid_head_follows_the_reference_specs(reference, key):
    """At 4 ranks, two a head: the same cut (the reference's 1/M column
    blocks, which now part a head)."""
    _check_shards(reference, key, 4)


def _check_shards(reference, key, size):
    from repro_torch.models.attention import kv_policy
    cfg = _cfg(key)
    ref = reference[key]
    full = convert.lm_params_from_numpy(ref["params"], cfg, "cpu",
                                        torch.float32)
    shards = [convert.shard_lm(full, cfg, r, size) for r in range(size)]
    back = convert.gather_lm(shards, cfg)
    for path, want in _flat(full).items():
        np.testing.assert_array_equal(_flat(back)[path], want)
    specs = _flat_specs(ref["specs"], cfg)
    # attention's K/V under the seq policy (RWKV6's wk / wv are not)
    seq = kv_policy(cfg, size) == "seq" and cfg.family != "ssm"
    mamba = ("in_proj", "conv_w", "conv_b")
    for path, want in _flat(full).items():
        name = path.rsplit("/", 1)[-1]
        got = [_flat(s)[path] for s in shards]
        dim = _spec_dim(specs[path])
        if name in mamba:
            assert dim is not None
            continue                       # the stated head layout, below
        if cfg.family == "ssm" and name in _RWKV_CUT:
            assert dim is None
            dim = _RWKV_CUT[name]
        if dim is None or (seq and name in ("wk", "wv", "x_wk", "x_wv")):
            for g in got:
                np.testing.assert_array_equal(g, want)
        else:
            for r, g in enumerate(got):
                np.testing.assert_array_equal(
                    g, np.split(want, size, axis=dim)[r])


def _flat_specs(specs, cfg):
    """The reference's spec tree in the port's layout: a stacked layer's
    spec carries the stack's leading dims (None), which the port's
    per-layer leaves do not."""
    lead = {k: len(v) for k, v in convert._stacks(cfg).items()}
    out = {}
    for key, node in specs.items():
        if key in lead:
            n = int(np.prod(convert._stacks(cfg)[key]))
            for i in range(n):
                for name, s in node.items():
                    out[f"{key}/{i}/{name}"] = tuple(s)[lead[key]:]
        elif isinstance(node, dict):
            for name, s in node.items():
                out[f"{key}/{name}"] = tuple(s)
        else:
            out[key] = tuple(node)
    return out


@pytest.mark.parametrize("size", [2, 4])
def test_shard_lm_mamba_layout(size):
    """in_proj [z | x | B | C | dt] -> [z_r | x_r | B | C | dt_r]; conv_w
    and conv_b [x | B | C] -> [x_r | B | C]."""
    from repro_torch.models import zamba
    from repro_torch.models.ssm import ssm_dims
    cfg = get_arch("zamba2-2.7b", smoke=True)
    full = zamba.init_zamba(cfg, torch.Generator().manual_seed(0),
                            torch.float32, "cpu")
    d_inner, n_heads, _ = ssm_dims(cfg)
    n = cfg.ssm_state
    w = full["layers"][0]["in_proj"]
    z, x, bm, cm, dt = torch.split(w, [d_inner, d_inner, n, n, n_heads], -1)
    c = full["layers"][0]["conv_w"]
    cx, cbc = c[:, :d_inner], c[:, d_inner:]
    for r in range(size):
        lay = convert.shard_lm(full, cfg, r, size)["layers"][0]
        want = torch.cat([z.chunk(size, -1)[r], x.chunk(size, -1)[r], bm, cm,
                          dt.chunk(size, -1)[r]], -1)
        assert torch.equal(lay["in_proj"], want)
        assert torch.equal(lay["conv_w"],
                           torch.cat([cx.chunk(size, -1)[r], cbc], -1))
        assert torch.equal(lay["ssm_norm"],
                           full["layers"][0]["ssm_norm"].chunk(size)[r])
        for name in ("dt_bias", "A_log", "D"):
            assert torch.equal(lay[name], full["layers"][0][name])


def test_shard_lm_mamba_mid_head_layout():
    """zamba2 smoke with ssm_expand 1 (2 heads) at 4 ranks: x, z, the conv's
    x channels and ssm_norm cut in quarters (half a head a rank), the dt
    columns whole with B and C."""
    from repro_torch.models import zamba
    from repro_torch.models.ssm import ssm_dims
    cfg = _cfg("zamba2-h2")
    full = zamba.init_zamba(cfg, torch.Generator().manual_seed(0),
                            torch.float32, "cpu")
    d_inner, n_heads, _ = ssm_dims(cfg)
    assert n_heads == 2
    n = cfg.ssm_state
    w = full["layers"][0]["in_proj"]
    z, x, rest = torch.split(w, [d_inner, d_inner, 2 * n + n_heads], -1)
    shards = [convert.shard_lm(full, cfg, r, 4) for r in range(4)]
    for r, sh in enumerate(shards):
        assert torch.equal(sh["layers"][0]["in_proj"], torch.cat(
            [z.chunk(4, -1)[r], x.chunk(4, -1)[r], rest], -1))
    back = convert.gather_lm(shards, cfg)
    assert torch.equal(back["layers"][0]["in_proj"], w)
    assert [w for w, c in convert._mamba_parts(cfg, "in_proj", 4)
            if not c] == [n, n, n_heads]


def test_rwkv_heads_that_do_not_split_are_refused():
    """RWKV6's smoke config has 2 heads of 64 channels: a model axis of 3
    neither divides them nor is divided by them, and at 6 the 3 ranks a
    head would split 64 channels unevenly; both are refused by the named
    ``ValueError`` (the check ``get_model`` runs on its mesh's model
    axis). At 4 and 16 each head splits over 2 and 8 ranks."""
    from repro_torch.models.registry import HEADS_DO_NOT_SPLIT, check_heads
    cfg = get_arch(RWKV, smoke=True)
    for m in (3, 6):
        want = HEADS_DO_NOT_SPLIT.format(n=2, what="RWKV6 heads", width=64,
                                         m=m)
        with pytest.raises(ValueError) as e:
            check_heads(cfg, m)
        assert str(e.value) == want
    for m in (1, 2, 4, 16, 128):
        check_heads(cfg, m)


#: (arch, smoke?, config changes, model axis, the head count refused,
#: what, its channels): pairs neither rule covers
REFUSED = [("internlm2-20b", False, {}, 32, 48, "query heads", 128),
           ("gemma2-2b", False, {}, 12, 8, "query heads", 256),
           ("zamba2-2.7b", False, {}, 96, 32, "query heads", 80),
           ("zamba2-2.7b", True, {"ssm_expand": 3}, 4, 6, "Mamba2 heads",
            64)]


@pytest.mark.parametrize("arch,smoke,changes,m,n,what,width", REFUSED,
                         ids=[f"{a}-{m}" for a, _, _, m, *_ in REFUSED])
def test_heads_no_rule_covers_are_refused(arch, smoke, changes, m, n, what,
                                          width):
    """internlm2-20b's 48 heads at 32 and gemma2-2b's 8 at 12 (neither
    count divides the other); zamba2-2.7b's 32 heads of 80 channels at 96
    (3 ranks a head, 80 % 3 != 0); zamba2 smoke with ssm_expand 3, whose
    attention splits at 4 but whose 6 Mamba2 heads do not."""
    from repro_torch.models.registry import HEADS_DO_NOT_SPLIT, check_heads
    cfg = dataclasses.replace(get_arch(arch, smoke=smoke), **changes)
    with pytest.raises(ValueError) as e:
        check_heads(cfg, m)
    assert str(e.value) == HEADS_DO_NOT_SPLIT.format(n=n, what=what,
                                                     width=width, m=m)


#: (arch, model axis): pairs a rule covers, whole heads or mid-head
ACCEPTED = [("gemma2-2b", False, 16), ("gemma2-2b", False, 8),
            ("zamba2-2.7b", True, 16), ("seamless-m4t-medium", True, 16),
            ("olmo-1b", True, 64)]


@pytest.mark.parametrize("arch,smoke,m", ACCEPTED,
                         ids=[f"{a}-{m}" for a, _, m in ACCEPTED])
def test_heads_a_rule_covers_are_accepted(arch, smoke, m):
    """gemma2-2b at 16 (2 ranks a head) and 8 (whole heads); zamba2 smoke
    at 16 (4 ranks to each attention and Mamba2 head); seamless smoke at
    16; olmo smoke at 64 (16 ranks to a head of 16 channels: one each)."""
    from repro_torch.models.registry import check_heads
    check_heads(get_arch(arch, smoke=smoke), m)


def test_a_model_axis_needs_a_mesh():
    from repro_torch.models import get_model
    with pytest.raises(ValueError, match="needs a mesh"):
        get_model(get_arch("olmo-1b", smoke=True), tp_size=2, device="cpu")
