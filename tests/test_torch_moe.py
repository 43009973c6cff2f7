"""The port's mixture of experts against the JAX package, on the CPU.

The same numpy inputs (the layer's router and expert weights, the tokens)
go through ``repro.models.mlp`` and ``repro_torch.models.mlp``.

Tolerances, and why:
- routing (each slot's expert, its position in the expert's buffer, kept
  or dropped): equal, exactly. The router logits are f32 products of the
  same operands, top-k keeps the lower expert first on equal logits in
  both, and the positions are integer counts.
- outputs: 1e-5 (rtol and atol) at f32: the same expert products, summed
  in another order.
- the all_to_all path (a gloo world of 2) against the reference's grouped
  path with ``moe_ep_groups=2``: outputs 1e-5; the ranks' summed weight
  grads against the port's grouped path's on the whole batch: normwise
  1e-5.
"""
import dataclasses
import os
import pickle
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.distributed.compat import make_mesh
from repro.models import Axes
from repro.models import mlp as jax_mlp
from repro_torch.configs import get_arch
from repro_torch.models import mlp

AXES = Axes(dp=("data",), tp="model")
ARCH = "qwen3-moe-235b-a22b"


def _cfgs(**kw):
    """The smoke qwen3-moe config of both packages with ``kw`` replaced."""
    return (dataclasses.replace(get_arch(ARCH, smoke=True), **kw),
            dataclasses.replace(jax_get_arch(ARCH, smoke=True), **kw))


def _layer(cfg, seed=0, tie=False):
    """A MoE layer's weights as numpy f32 (router [D, E], experts)."""
    rng = np.random.default_rng(seed)
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    p = {"router": rng.normal(size=(d, e)) * d ** -0.5,
         "e_gate": rng.normal(size=(e, d, f)) * d ** -0.5,
         "e_up": rng.normal(size=(e, d, f)) * d ** -0.5,
         "e_down": rng.normal(size=(e, f, d)) * f ** -0.5}
    if tie:   # experts 1 and 3 (and 0 and 2) score every token equally
        p["router"][:, 3] = p["router"][:, 1]
        p["router"][:, 2] = p["router"][:, 0]
    return {k: v.astype(np.float32) for k, v in p.items()}


def _x(cfg, b=2, s=24, seed=1):
    return np.random.default_rng(seed).normal(
        size=(b, s, cfg.d_model)).astype(np.float32)


def _t(p):
    return {k: torch.from_numpy(v) for k, v in p.items()}


def _j(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def _jax_moe(fn, p, x, jcfg):
    with make_mesh((1, 1), ("data", "model")):
        return np.asarray(fn(_j(p), jnp.asarray(x), jcfg, AXES))


def _jax_routing(x, router, k, e, cap):
    """The reference's routing lines (``moe_block``) on the same inputs."""
    logits = (x @ router).astype(jnp.float32)
    top_w, top_e = jax.lax.top_k(logits, k)
    e_ids = top_e.reshape(-1)
    onehot = jax.nn.one_hot(e_ids, e, dtype=jnp.int32)
    pos = jnp.sum((jnp.cumsum(onehot, axis=0) - onehot) * onehot, axis=1)
    return (np.asarray(jax.nn.softmax(top_w, axis=-1).astype(x.dtype),
                       np.float32),
            np.asarray(top_e), np.asarray(pos), np.asarray(pos < cap))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tie", [False, True])
@pytest.mark.parametrize("cf", [0.3, 1.25])
def test_routing_equals_the_references_exactly(cf, tie, dtype):
    cfg, _ = _cfgs(capacity_factor=cf, n_experts=8, moe_top_k=3)
    p = _layer(cfg, tie=tie)
    x = _x(cfg).reshape(-1, cfg.d_model)
    t, k, e = x.shape[0], cfg.moe_top_k, cfg.n_experts
    cap = max(1, int(t * k / e * cf))     # a small capacity forces drops
    jx = jnp.asarray(x).astype(dtype)
    want_w, want_e, want_pos, want_kept = _jax_routing(
        jx, jnp.asarray(p["router"]), k, e, cap)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    top_w, top_e = mlp.route(tx, torch.from_numpy(p["router"]), k)
    pos = mlp.slot_positions(top_e.reshape(-1), e)
    np.testing.assert_array_equal(top_e.numpy(), want_e)
    np.testing.assert_array_equal(pos.numpy(), want_pos)
    np.testing.assert_array_equal((pos < cap).numpy(), want_kept)
    assert top_w.dtype == tx.dtype
    np.testing.assert_allclose(top_w.float().numpy(), want_w, rtol=1e-6,
                               atol=1e-6)
    if tie:   # an exact tie keeps the lower expert first
        both = [(r.tolist().index(1), r.tolist().index(3))
                for r in top_e.numpy() if 1 in r and 3 in r]
        assert both and all(a < b for a, b in both)
    if cf < 1:
        assert not want_kept.all()


@pytest.mark.parametrize("cf", [0.3, 1.25, 100.0])
@pytest.mark.parametrize("experts,k", [(4, 2), (16, 4)])
def test_moe_block_matches_jax(experts, k, cf):
    cfg, jcfg = _cfgs(capacity_factor=cf, n_experts=experts, moe_top_k=k)
    p, x = _layer(cfg), _x(cfg)
    got = mlp.moe_block(_t(p), torch.from_numpy(x), cfg)
    want = _jax_moe(jax_mlp.moe_block, p, x, jcfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_moe_block_drops_contribute_zero():
    """At a capacity below one slot an expert, every slot past the first
    128 is dropped: tokens routed only past capacity get a zero output."""
    cfg, _ = _cfgs(capacity_factor=1e-9, n_experts=4, moe_top_k=2)
    p = _layer(cfg)
    x = torch.from_numpy(_x(cfg, b=4, s=64))        # 256 tokens x 2 slots
    out = mlp.moe_block(_t(p), x, cfg).reshape(-1, cfg.d_model)
    _, top_e = mlp.route(x.reshape(-1, cfg.d_model), _t(p)["router"], 2)
    pos = mlp.slot_positions(top_e.reshape(-1), 4).reshape(-1, 2)
    dropped = (pos >= 128).all(-1)
    assert dropped.any() and not dropped.all()
    assert torch.all(out[dropped] == 0)
    assert torch.all(out[~dropped].abs().sum(-1) > 0)


@pytest.mark.parametrize("cf", [0.5, 2.0])
@pytest.mark.parametrize("groups", [2, 4])
def test_grouped_ep_matches_jax(groups, cf):
    cfg, jcfg = _cfgs(capacity_factor=cf, moe_ep_groups=groups)
    p, x = _layer(cfg), _x(cfg)
    got = mlp.moe_block(_t(p), torch.from_numpy(x), cfg)    # no mesh: grouped
    want = _jax_moe(jax_mlp._moe_block_ep_gspmd, p, x, jcfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_grouped_ep_equals_dense_without_drops():
    """tests/test_moe_ep.py's property: with nothing dropped, the grouped
    and the dense dispatch give the same outputs."""
    cfg, _ = _cfgs(capacity_factor=100.0)
    p, x = _t(_layer(cfg)), torch.from_numpy(_x(cfg))
    dense = mlp.moe_block(p, x, cfg)
    grouped = mlp.moe_block(p, x, dataclasses.replace(cfg, moe_ep_groups=4))
    torch.testing.assert_close(grouped, dense, rtol=1e-6, atol=1e-6)


def test_grouped_ep_refuses_uneven_groups():
    cfg, _ = _cfgs(moe_ep_groups=5)
    with pytest.raises(ValueError, match="groups"):
        mlp.moe_block(_t(_layer(cfg)), torch.from_numpy(_x(cfg)), cfg)


def _a2a_child(rank, world, store_path, out_dir, p, x, cot, cfg):
    import datetime
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    got = {}
    try:
        from repro_torch.distributed.mesh import make_test_mesh, tally
        from repro_torch.models.common import TP
        tp = TP.of(make_test_mesh({"data": world, "model": 1}, device="cpu"))
        params = {k: torch.from_numpy(v).requires_grad_(True)
                  for k, v in p.items()}
        xl = torch.from_numpy(x[rank:rank + 1]).requires_grad_(True)
        with tally() as t:
            out = mlp.moe_block(params, xl, cfg, tp=tp)
            grads = torch.autograd.grad(
                (out * torch.from_numpy(cot[rank:rank + 1])).sum(),
                [*params.values(), xl])
        got = {"out": out.detach().numpy(), "alltoall": t.alltoall,
               "grads": {k: g.numpy() for k, g in zip(params, grads)},
               "x_grad": grads[-1].numpy()}
        # a model axis the weights are not split over (a TP of size 1 on
        # a (1, 2) mesh): each rank routes its own row alone, with every
        # expert
        one_rank = TP(make_test_mesh({"data": 1, "model": world},
                                     device="cpu"))
        with torch.no_grad():
            got["model_axis"] = mlp.moe_block(params, xl, cfg,
                                              tp=one_rank).numpy()
    except Exception:
        import traceback
        got = {"error": traceback.format_exc()}
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(got, f)
    dist.destroy_process_group()


def test_all_to_all_ep_at_world_2_matches_the_grouped_path(tmp_path):
    import torch.multiprocessing as mp
    cfg, jcfg = _cfgs(capacity_factor=0.75, moe_ep_groups=2)
    p, x = _layer(cfg), _x(cfg, b=2, s=24)
    cot = np.random.default_rng(9).normal(size=x.shape).astype(np.float32)
    ctx = mp.start_processes(
        _a2a_child, args=(2, str(tmp_path / "store"), str(tmp_path), p, x,
                          cot, cfg),
        nprocs=2, join=False, start_method="spawn")
    t0 = time.monotonic()
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() - t0 > 120:
                pytest.fail("the world of 2 passed its 120 s deadline")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
                proc.join()
    ranks = []
    for r in range(2):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
        assert "error" not in ranks[-1], ranks[-1].get("error")
    # forward: the reference's grouped path, groups = the two ranks' halves
    want = _jax_moe(jax_mlp._moe_block_ep_gspmd, p, x, jcfg)
    got = np.concatenate([r["out"] for r in ranks])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # one exchange each way in the forward pass (the backward's two run
    # inside autograd, uncounted)
    assert all(r["alltoall"] == 2 for r in ranks)
    one = dataclasses.replace(cfg, moe_ep_groups=1)
    with torch.no_grad():
        for r, got_r in enumerate(ranks):
            want_r = mlp.moe_block({k: torch.from_numpy(v)
                                    for k, v in p.items()},
                                   torch.from_numpy(x[r:r + 1]), one)
            np.testing.assert_allclose(got_r["model_axis"], want_r.numpy(),
                                       rtol=1e-6, atol=1e-6)
    # backward through the exchange: the ranks' grads sum to the grouped
    # path's on the whole batch (each rank's expert grads hold every
    # rank's tokens routed to its experts)
    params = {k: torch.from_numpy(v).requires_grad_(True)
              for k, v in p.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    out = mlp.moe_block(params, xt, cfg)
    grads = torch.autograd.grad((out * torch.from_numpy(cot)).sum(),
                                [*params.values(), xt])
    for name, g in zip(params, grads):
        summed = ranks[0]["grads"][name] + ranks[1]["grads"][name]
        rel = np.linalg.norm(summed - g.numpy()) / np.linalg.norm(g.numpy())
        assert rel <= 1e-5, (name, rel)
    x_grad = np.concatenate([r["x_grad"] for r in ranks])
    np.testing.assert_allclose(x_grad, grads[-1].numpy(), rtol=1e-5,
                               atol=1e-5)


def test_init_moe_shapes_and_dtypes():
    from repro_torch.models.common import ParamBuilder
    cfg, _ = _cfgs()
    b = ParamBuilder(torch.Generator().manual_seed(0), torch.bfloat16,
                     torch.device("cpu"))
    mlp.init_moe(b, cfg)
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    assert b.params["router"].dtype == torch.float32
    assert b.params["router"].shape == (d, e)
    assert b.params["e_gate"].shape == b.params["e_up"].shape == (e, d, f)
    assert b.params["e_down"].shape == (e, f, d)
    assert b.params["e_down"].dtype == torch.bfloat16
