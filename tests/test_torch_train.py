"""The port's LM training against the JAX package, on the CPU.

The same numpy inputs go through both packages: the smoke configs with the
JAX package's f32 ``init_lm`` parameters, converted by
``repro_torch.convert.lm_params_from_numpy``, and token batches from numpy
seeds.

Tolerances, and why:
- ``chunked_cross_entropy``: relative 1e-6. Both make f32 logits of the
  same operands; only the order of the vocabulary's sums differs.
- ``lm_loss``: relative 1e-5; every grad leaf normwise (||got - want|| /
  ||want||) 1e-4. Two layers of f32 math in another summation order.
- remat on against off: bitwise on the CPU (the recompute repeats the same
  operations).
- ``adamw_update`` and ``lr_schedule``: 1e-6, f32 arithmetic in the
  reference's order.
- two ``make_train_step`` steps: the parameters normwise 1e-5 per leaf.
- a resume of the reference launcher's checkpoint: the two resumed steps'
  losses within 1e-4 (relative) of the reference's resumed run. The
  launcher's parameters are bf16; the comparison stops at two steps since
  after that a bf16 rounding of an updated parameter that lands on the
  other side in one package moves the later losses by ~2e-4 (measured: the
  third resumed step, 6.0081 against 6.0095).
- ``--mesh 2x1`` over gloo against one process with ``--microbatches 2``:
  losses and grad norms within 1e-5. Each rank's half batch is one of the
  two microbatches, and both sum the halves' f32 grads and halve them; the
  launcher's parameters are bf16, so against ``--microbatches 1`` (one
  bf16 grad of the whole batch) the grads would differ by bf16 rounding.
"""
import dataclasses
import os
import pickle
import re
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import TrainConfig as JaxTrainConfig
from repro.configs import get_arch as jax_get_arch
from repro.distributed.compat import make_mesh
from repro.models import Axes
from repro.models import common as jax_common
from repro.models import get_model as jax_get_model
from repro.training import optim as jax_optim
from repro.training.step import make_train_step as jax_make_train_step
from repro_torch import convert
from repro_torch.configs import TrainConfig, get_arch
from repro_torch.kernels import ops
from repro_torch.models import common, get_model
from repro_torch.training import (adamw_init, adamw_update, lr_schedule,
                                  make_train_step)
from repro_torch.training.optim import tree_leaves, tree_unflatten

AXES = Axes(dp=("data",), tp="model")
ARCHS = ["olmo-1b", "gemma2-2b", "qwen3-moe-235b-a22b", "grok-1-314b"]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _leaf_rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    den = np.linalg.norm(want)
    num = np.linalg.norm(got - want)
    return num / den if den else num


def _batch(cfg, b=2, s=16, seed=0, pad_last=True):
    rng = np.random.default_rng(seed)
    tok = rng.integers(1, cfg.vocab_size, (b, s)).astype(np.int32)
    lab = np.roll(tok, -1, 1)
    if pad_last:
        lab[:, -1] = -1
    return tok, lab


def _jax_params(arch):
    cfg = jax_get_arch(arch, smoke=True)
    api = jax_get_model(cfg, tp_size=1)
    params, _ = api.init(jax.random.PRNGKey(0), jnp.float32)
    return api, params


def _torch_batch(tok, lab):
    return {"tokens": torch.from_numpy(tok).long(),
            "labels": torch.from_numpy(lab).long()}


@pytest.fixture(scope="module")
def jax_loss_grads():
    """arch -> (numpy params, tokens, labels, loss, numpy grads) of the
    reference at remat off."""
    cache = {}

    def get(arch):
        if arch not in cache:
            api, params = _jax_params(arch)
            tok, lab = _batch(get_arch(arch, smoke=True))
            batch = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)}
            with make_mesh((1, 1), ("data", "model")):
                loss, grads = jax.value_and_grad(
                    lambda p: api.loss(p, batch, AXES, remat=False))(params)
            cache[arch] = (jax.tree.map(np.asarray, params), tok, lab,
                           float(loss), jax.tree.map(np.asarray, grads))
        return cache[arch]
    return get


def _port_loss_grads(arch, params_np, tok, lab, remat):
    cfg = get_arch(arch, smoke=True)
    params = convert.lm_params_from_numpy(params_np, cfg, "cpu")
    for p in tree_leaves(params):
        p.requires_grad_(True)
    loss = get_model(cfg, device="cpu").loss(params, _torch_batch(tok, lab),
                                             remat=remat)
    grads = torch.autograd.grad(loss, tree_leaves(params))
    return loss.detach(), tree_unflatten(params, list(grads))


# ---------------------------------------------------------------------------
# the chunked cross-entropy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cap", [None, 30.0])
@pytest.mark.parametrize("t,chunk", [(300, 128), (64, 2048)])
def test_chunked_cross_entropy_matches_jax(t, chunk, cap):
    rng = np.random.default_rng(1)
    v_valid, d = 200, 32
    vp = common.padded_vocab_size(v_valid)
    assert vp == jax_common.padded_vocab_size(v_valid) == 256
    hidden = rng.normal(size=(t, d)).astype(np.float32)
    emb = (rng.normal(size=(vp, d)) * 0.5).astype(np.float32)
    labels = rng.integers(0, v_valid, t).astype(np.int32)
    labels[rng.random(t) < 0.2] = -1
    kw = dict(chunk=chunk, logit_softcap=cap, n_valid_vocab=v_valid)
    got = common.chunked_cross_entropy(torch.from_numpy(hidden),
                                       torch.from_numpy(emb),
                                       torch.from_numpy(labels).long(), **kw)
    want = jax_common.chunked_cross_entropy(
        jnp.asarray(hidden), jnp.asarray(emb), jnp.asarray(labels), **kw)
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(float(want), rel=1e-6)


def test_cross_entropy_ignores_padding_and_masks_the_vocab_tail():
    logits = torch.zeros(2, 6)
    masked = common.mask_vocab_pad(logits, 4)
    want = jax_common.mask_vocab_pad(jnp.zeros((2, 6)), 4)
    np.testing.assert_array_equal(masked.numpy(), np.asarray(want))
    assert common.mask_vocab_pad(logits, 6) is logits
    # every label -1: the loss is 0 (the count is clamped to 1)
    loss = common.chunked_cross_entropy(torch.ones(5, 3), torch.ones(4, 3),
                                        torch.full((5,), -1))
    assert float(loss) == 0.0


def test_cross_entropy_recomputes_each_chunk():
    """The chunk's logits are not saved for the backward pass: a saved
    [chunk, V] f32 block would show among the graph's saved tensors."""
    t, v, d = 64, 512, 8
    h = torch.randn(t, d, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    emb = torch.randn(v, d, generator=torch.Generator().manual_seed(1))
    sizes = []

    def pack(x):
        sizes.append(x.numel())
        return x
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        loss = common.chunked_cross_entropy(h, emb, torch.arange(t) % v,
                                            chunk=32)
    assert max(sizes) < 32 * v
    loss.backward()
    assert torch.isfinite(h.grad).all()


# ---------------------------------------------------------------------------
# lm_loss and its grads
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_matches_jax(arch, jax_loss_grads):
    params_np, tok, lab, want, _ = jax_loss_grads(arch)
    got, _ = _port_loss_grads(arch, params_np, tok, lab, remat=False)
    assert float(got) == pytest.approx(want, rel=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_grads_match_jax(arch, jax_loss_grads):
    params_np, tok, lab, _, want = jax_loss_grads(arch)
    _, grads = _port_loss_grads(arch, params_np, tok, lab, remat=False)
    cfg = get_arch(arch, smoke=True)
    got = convert.stack_lm(grads, cfg)
    names = []
    for name, g in got.items():
        if name == "layers":
            for lname, gl in g.items():
                w = want["layers"][lname]
                names.append((f"layers/{lname}", _leaf_rel(
                    _np(gl), w.reshape(gl.shape))))
        else:
            names.append((name, _leaf_rel(_np(g), want[name])))
    assert len(names) == len(jax.tree.leaves(want))
    worst = max(names, key=lambda x: x[1])
    assert worst[1] <= 1e-4, worst


@pytest.mark.parametrize("arch", ["olmo-1b", "gemma2-2b",
                                  "qwen3-moe-235b-a22b"])
def test_remat_equals_no_remat_bitwise(arch, jax_loss_grads):
    params_np, tok, lab, _, _ = jax_loss_grads(arch)
    l0, g0 = _port_loss_grads(arch, params_np, tok, lab, remat=False)
    l1, g1 = _port_loss_grads(arch, params_np, tok, lab, remat=True)
    assert float(l0) == float(l1)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        assert torch.equal(a, b)


def test_remat_saves_only_group_inputs():
    """With remat, the graph keeps the residual stream at group boundaries
    (and the chunked CE's inputs), not the layers' activations."""
    cfg = get_arch("olmo-1b", smoke=True)
    api = get_model(cfg, device="cpu")
    params = api.init(0, torch.float32)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    tok, lab = _batch(cfg, b=2, s=32)
    counts = {}
    for remat in (False, True):
        n = [0]

        def pack(x):
            n[0] += 1
            return x
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
            api.loss(params, _torch_batch(tok, lab), remat=remat)
        counts[remat] = n[0]
    # two layer groups: their checkpoints save x; the CE chunk saves its
    # inputs; without remat every matmul, norm and softmax saves its own
    assert counts[True] <= 12 < counts[False]


def test_flash_refuses_a_gradient():
    cfg = dataclasses.replace(get_arch("olmo-1b", smoke=True),
                              attn_impl="flash")
    api = get_model(cfg, device="cpu")
    params = api.init(0, torch.float32)
    tok, lab = _batch(cfg)
    with pytest.raises(RuntimeError, match='attn_impl="chunked"'):
        api.loss(params, _torch_batch(tok, lab))
    q = torch.zeros(1, 2, 8, 16, requires_grad=True)
    k = torch.zeros(1, 2, 8, 16)
    with pytest.raises(RuntimeError, match="no gradient"):
        ops.flash_attention(q, k, k)
    # forward only: without grad mode, or with no input requiring grad,
    # the kernel runs (prefill is unchanged)
    with torch.no_grad():
        assert ops.flash_attention(q, k, k).shape == (1, 2, 8, 16)
    assert ops.flash_attention(q.detach(), k, k).shape == (1, 2, 8, 16)
    cache, logits = api.prefill(params, {"tokens": torch.from_numpy(tok)})
    assert torch.isfinite(logits).all()


def test_input_specs():
    api = get_model(get_arch("olmo-1b", smoke=True), device="cpu")
    from repro_torch.configs.base import ShapeConfig
    assert api.input_specs(ShapeConfig("t", "train", 64, 4)) == {
        "tokens": ((4, 64), torch.int32), "labels": ((4, 64), torch.int32)}
    assert api.input_specs(ShapeConfig("p", "prefill", 64, 4)) == {
        "tokens": ((4, 64), torch.int32)}
    assert api.input_specs(ShapeConfig("d", "decode", 64, 4)) == {
        "token": ((4,), torch.int32), "pos": ((), torch.int32)}


# ---------------------------------------------------------------------------
# AdamW and the train step
# ---------------------------------------------------------------------------


def test_train_config_matches_reference():
    assert dataclasses.asdict(TrainConfig()) == \
        dataclasses.asdict(JaxTrainConfig())


def test_lr_schedule_matches_jax():
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=10, total_steps=100)
    jcfg = JaxTrainConfig(learning_rate=1e-3, warmup_steps=10,
                          total_steps=100)
    steps = np.arange(0, 110)
    got = lr_schedule(torch.from_numpy(steps), tcfg)
    want = jax_optim.lr_schedule(jnp.asarray(steps), jcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)


@pytest.mark.parametrize("opt_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(opt_dtype):
    rng = np.random.default_rng(2)
    shapes = {"a": (16, 8), "b": (5,), "c": (3, 4, 6)}
    dtypes = {"a": np.float32, "b": np.float32, "c": np.float32}
    p0 = {k: rng.normal(size=s).astype(dtypes[k]) for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * 3).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    tcfg = TrainConfig(opt_state_dtype=opt_dtype, warmup_steps=2,
                       total_steps=10)
    jcfg = JaxTrainConfig(opt_state_dtype=opt_dtype, warmup_steps=2,
                          total_steps=10)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jst = jax_optim.adamw_init(jp, jcfg)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    tst = adamw_init(tp, tcfg)
    for g in grads:
        jp, jst, jm = jax_optim.adamw_update(
            jp, {k: jnp.asarray(v) for k, v in g.items()}, jst, jcfg)
        tp, tst, tm = adamw_update(
            tp, {k: torch.from_numpy(v) for k, v in g.items()}, tst, tcfg)
        assert float(jm["grad_norm"]) > tcfg.grad_clip      # clip active
        for key in ("grad_norm", "lr"):
            assert float(tm[key]) == pytest.approx(float(jm[key]), rel=1e-6)
    assert int(tst.step) == int(jst.step) == 3
    for k in shapes:
        np.testing.assert_allclose(_np(tp[k]), np.asarray(jp[k]), rtol=1e-6,
                                   atol=1e-6)
        for mine, theirs in ((tst.m, jst.m), (tst.v, jst.v)):
            assert str(mine[k].dtype).endswith(opt_dtype)
            np.testing.assert_allclose(
                _np(mine[k]), np.asarray(theirs[k], np.float32), rtol=1e-6,
                atol=1e-9)


def test_adamw_keeps_a_bf16_parameter_in_bf16_and_works_in_f32():
    tcfg = TrainConfig(warmup_steps=1, total_steps=2, weight_decay=0.0)
    p = {"w": torch.full((4,), 1.0, dtype=torch.bfloat16)}
    st = adamw_init(p, tcfg)
    g = {"w": torch.full((4,), 1e-3, dtype=torch.bfloat16)}
    p, st, _ = adamw_update(p, g, st, tcfg)
    assert p["w"].dtype == torch.bfloat16 and st.m["w"].dtype == torch.float32
    # the f32 step is lr = 3e-4 below 1.0: rounded to bf16 that is 1.0
    # (bf16 steps of 2^-7 there); the f32 moment holds the exact 1e-4
    assert float(p["w"][0]) == 1.0
    assert float(st.m["w"][0]) == pytest.approx(0.1 * 1e-3, rel=1e-2)


@pytest.mark.parametrize("n_micro", [1, 4])
def test_train_step_matches_jax(n_micro):
    arch = "olmo-1b"
    cfg = get_arch(arch, smoke=True)
    api_j, params_j = _jax_params(arch)
    params_np = jax.tree.map(np.asarray, params_j)
    kw = dict(remat=False, microbatches=n_micro, warmup_steps=1,
              total_steps=10)
    jcfg, tcfg = JaxTrainConfig(**kw), TrainConfig(**kw)
    batches = [_batch(cfg, b=4, s=16, seed=s, pad_last=False)
               for s in (0, 1)]
    step_j = jax.jit(jax_make_train_step(api_j, jcfg, AXES))
    opt_j = jax_optim.adamw_init(params_j, jcfg)
    with make_mesh((1, 1), ("data", "model")):
        for tok, lab in batches:
            params_j, opt_j, mj = step_j(
                params_j, opt_j, {"tokens": jnp.asarray(tok),
                                  "labels": jnp.asarray(lab)})
    api = get_model(cfg, device="cpu")
    params = convert.lm_params_from_numpy(params_np, cfg, "cpu")
    opt = adamw_init(params, tcfg)
    step = make_train_step(api, tcfg)
    for tok, lab in batches:
        params, opt, mt = step(params, opt, _torch_batch(tok, lab))
    assert float(mt["loss"]) == pytest.approx(float(mj["loss"]), rel=1e-5)
    got = convert.stack_lm(params, cfg)
    want = jax.tree.map(np.asarray, params_j)
    rels = [_leaf_rel(_np(got[k]), want[k]) for k in got if k != "layers"]
    rels += [_leaf_rel(_np(v), want["layers"][k].reshape(v.shape))
             for k, v in got["layers"].items()]
    assert max(rels) <= 1e-5


def test_microbatches_accumulate_f32_grads():
    """microbatches=4 sums f32 grads of four slices and scales by 1/4: the
    first loss equals the full batch's to f32 rounding."""
    cfg = get_arch("olmo-1b", smoke=True)
    api = get_model(cfg, device="cpu")
    tok, lab = _batch(cfg, b=8, s=16, pad_last=False)
    losses = []
    for n in (1, 4):
        tcfg = TrainConfig(remat=False, microbatches=n)
        params = api.init(0, torch.float32)
        _, _, m = make_train_step(api, tcfg)(params, adamw_init(params, tcfg),
                                             _torch_batch(tok, lab))
        losses.append(float(m["loss"]))
    assert losses[1] == pytest.approx(losses[0], rel=1e-6)


# ---------------------------------------------------------------------------
# convert
# ---------------------------------------------------------------------------


def test_adamw_state_crosses_the_port():
    arch = "qwen3-moe-235b-a22b"
    cfg = get_arch(arch, smoke=True)
    _, params_j = _jax_params(arch)
    jcfg = JaxTrainConfig(opt_state_dtype="bfloat16")
    st = jax_optim.adamw_init(params_j, jcfg)
    st = st._replace(step=jnp.int32(7), m=jax.tree.map(
        lambda a: (a * 0.5).astype(jnp.bfloat16), params_j))
    m_np = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), st.m)
    v_np = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), st.v)
    got = convert.adamw_state_from_numpy(st.step, m_np, v_np, cfg, "cpu",
                                         dtype=torch.bfloat16)
    assert int(got.step) == 7 and got.step.dtype == torch.int32
    assert got.m["layers"][1]["e_gate"].dtype == torch.bfloat16
    back = convert.adamw_state_to_numpy(got, cfg)
    assert back["step"] == 7
    for name, a in m_np["layers"].items():
        np.testing.assert_array_equal(back["m"]["layers"][name], a)
    np.testing.assert_array_equal(back["v"]["embed"], v_np["embed"])


def test_moe_params_convert_with_an_f32_router():
    arch = "qwen3-moe-235b-a22b"
    cfg = get_arch(arch, smoke=True)
    _, params_j = _jax_params(arch)
    got = convert.lm_params_from_numpy(jax.tree.map(np.asarray, params_j),
                                       cfg, "cpu", dtype=torch.bfloat16)
    layer = got["layers"][0]
    assert layer["router"].dtype == torch.float32
    for name in ("e_gate", "e_up", "e_down", "wq"):
        assert layer[name].dtype == torch.bfloat16
    assert layer["e_gate"].shape == (cfg.n_experts, cfg.d_model, cfg.d_ff)
    # the port's own init draws the router in f32 too
    mine = get_model(cfg, device="cpu").init(0)
    assert mine["layers"][0]["router"].dtype == torch.float32
    assert mine["layers"][0]["e_down"].dtype == torch.bfloat16
    back = convert.unstack_lm(convert.stack_lm(mine, cfg), cfg, "cpu")
    for a, b in zip(tree_leaves(mine), tree_leaves(back)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

_STEP = re.compile(r"step\s+(\d+)\s+loss=([0-9.]+)")


def _losses(text: str) -> dict:
    return {int(s): float(v) for s, v in _STEP.findall(text)}


def _ref_train(*runs) -> str:
    """The reference launcher's runs, one after another in one subprocess
    (its environment staging wants a fresh process); their stdout."""
    common = ["--arch", "olmo-1b", "--smoke", "--batch", "4", "--seq", "32",
              "--log-every", "1"]
    code = "from repro.launch.train import main\n" + "".join(
        f"main({common + list(r)!r})\n" for r in runs)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


def test_launch_train_resumes_a_reference_checkpoint(tmp_path, capsys):
    from repro_torch.launch.train import main
    # the reference trains 4 steps (checkpoints at 2 and 4), then resumes
    # to step 6 writing none (--ckpt-every stays 25); the port resumes the
    # same step-4 checkpoint
    ckpt = str(tmp_path)
    ref = _ref_train(("--steps", "4", "--ckpt-dir", ckpt, "--ckpt-every",
                      "2"), ("--steps", "6", "--ckpt-dir", ckpt, "--resume"))
    want = _losses(ref.split("[train] resumed from step 4")[1])
    main(["--arch", "olmo-1b", "--smoke", "--device", "cpu", "--batch", "4",
          "--seq", "32", "--log-every", "1", "--steps", "6", "--ckpt-dir",
          ckpt, "--resume"])
    out = capsys.readouterr().out
    assert "[train] resumed from step 4" in out
    got = _losses(out)
    assert sorted(got) == sorted(want) == [5, 6]
    for s in (5, 6):
        assert got[s] == pytest.approx(want[s], rel=1e-4)


def test_launch_train_checkpoint_layout_is_the_references(tmp_path, capsys):
    """The port writes the reference's leaf paths, shapes and dtypes."""
    from repro_torch.ft.checkpoint import CheckpointManager
    from repro_torch.launch.train import main
    main(["--arch", "gemma2-2b", "--smoke", "--device", "cpu", "--batch",
          "2", "--seq", "16", "--steps", "2", "--ckpt-every", "2",
          "--ckpt-dir", str(tmp_path)])
    assert "step     1  loss=" in capsys.readouterr().out
    cm = CheckpointManager(str(tmp_path))
    leaves = cm._manifest(2)["leaves"]
    cfg = jax_get_arch("gemma2-2b", smoke=True)
    params, _ = jax_get_model(cfg, tp_size=1).init(jax.random.PRNGKey(0))
    opt = jax_optim.adamw_init(params, JaxTrainConfig())
    from repro.ft.checkpoint import _leaf_paths
    want = {name: (list(leaf.shape), str(leaf.dtype)) for name, leaf in
            _leaf_paths({"params": params, "opt": opt})}
    assert {k: (v["shape"], v["dtype"]) for k, v in leaves.items()} == want


def test_launch_train_refuses_a_model_axis():
    """A model axis needs a world of its ranks: ``--mesh 1x2`` in one
    process is refused before any step (the model axis itself trains in
    tests/test_torch_tp.py)."""
    from repro_torch.launch.train import main
    with pytest.raises(RuntimeError, match="needs a torch.distributed world "
                       "of 2 ranks"):
        main(["--arch", "olmo-1b", "--smoke", "--device", "cpu", "--mesh",
              "1x2", "--steps", "1"])


def _dp_child(rank, world, store_path, out_dir):
    import datetime
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        from repro_torch.launch.train import run
        out = run(["--arch", "qwen3-moe-235b-a22b", "--smoke", "--device",
                   "cpu", "--batch", "4", "--seq", "16", "--steps", "3",
                   "--log-every", "1", "--mesh", f"{world}x1"])
        got = {"losses": out.losses, "grad_norms": out.grad_norms,
               "embed": out.params["embed"].detach().float().numpy()}
    except Exception:
        import traceback
        got = {"error": traceback.format_exc()}
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(got, f)
    dist.destroy_process_group()


def test_launch_train_data_parallel_equals_one_process(tmp_path):
    import torch.multiprocessing as mp
    from repro_torch.launch.train import run
    one = run(["--arch", "qwen3-moe-235b-a22b", "--smoke", "--device",
               "cpu", "--batch", "4", "--seq", "16", "--steps", "3",
               "--microbatches", "2"])
    ctx = mp.start_processes(_dp_child, args=(2, str(tmp_path / "store"),
                                              str(tmp_path)),
                             nprocs=2, join=False, start_method="spawn")
    t0 = time.monotonic()
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() - t0 > 120:
                pytest.fail("the world of 2 passed its 120 s deadline")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    ranks = []
    for r in range(2):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
        assert "error" not in ranks[-1], ranks[-1].get("error")
    for r in ranks:
        np.testing.assert_allclose(r["losses"], one.losses, rtol=1e-5)
        np.testing.assert_allclose(r["grad_norms"], one.grad_norms,
                                   rtol=1e-5)
    np.testing.assert_array_equal(ranks[0]["embed"], ranks[1]["embed"])
