"""The port's hybrid family (zamba2: Mamba2 layers and one shared attention
block) against the JAX package, on the CPU.

The same numpy inputs go through both packages: the smoke config with the
JAX package's f32 ``init_zamba`` parameters (``PRNGKey(0)``), converted by
``repro_torch.convert.lm_params_from_numpy``, and inputs from numpy seeds.

Tolerances, and why (``tests/test_torch_lm.py``'s and
``tests/test_torch_train.py``'s):
- the Mamba2 modules, hidden states, the prefill cache and logits: 1e-4
  (rtol and atol). Both sides do f32 math on the same inputs; only the
  order of the sums differs (the chunked scan's einsums among them).
- decode logits: 1e-3. The K/V are bf16 leaves on both sides (the
  cache the engine allocates, the port's ``cache_specs`` at the
  parameters' dtype, f32 here for the states), and a value whose f32
  results differ in the last bit may round to neighbouring bf16 values.
  The reference's decode returns new leaves; the test writes them back
  in their leaves' dtypes, as the port's in-place writes do.
- ``lm_loss``: relative 1e-5; every grad leaf normwise 1e-4.
- generated tokens: equal token for token.
- a resumed checkpoint: the resumed state bitwise; the first resumed
  step's loss within RESUME_REL = 2e-3 relative of the reference
  launcher's. Its parameters are bf16, and its jitted bf16 forward keeps
  intermediates in f32 across fused operations where the port rounds each
  to bf16 (so does the reference run op by op: on this config the two
  agree within 0.09% after two groups; the jitted forward's hidden states
  stray 2.4% normwise from both). Measured: 4.6e-4 (zamba2), 1.4e-4
  (rwkv6). Later steps update with bf16 grads and drift further.
"""
import dataclasses
import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ShapeConfig as JaxShapeConfig
from repro.configs import get_arch as jax_get_arch
from repro.distributed.compat import make_mesh
from repro.models import Axes
from repro.models import get_model as jax_get_model
from repro.serving import ServeConfig as JaxServeConfig
from repro.serving import ServingEngine as JaxServingEngine
from repro_torch import convert
from repro_torch.configs import ShapeConfig, get_arch
from repro_torch.models import get_model
from repro_torch.serving import ServeConfig, ServingEngine
from repro_torch.training.optim import tree_leaves, tree_unflatten

AXES = Axes(dp=("data",), tp="model")
ARCH = "zamba2-2.7b"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
# 21 tokens > the smoke window of 16: the shared block's cache wraps
PROMPT_LENS = (11, 21)
MAX_LEN = 24
RESUME_REL = 2e-3


def _mesh():
    return make_mesh((1, 1), ("data", "model"))


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _np(t):
    return t.detach().to(torch.float32).numpy()


def close(got, want, tol):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def leaf_rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    den = np.linalg.norm(want)
    num = np.linalg.norm(got - want)
    return num / den if den else num


def models(arch, impl="chunked"):
    """(JAX api, JAX f32 params, port api, the same params converted)."""
    cfg = dataclasses.replace(get_arch(arch, smoke=True), attn_impl=impl)
    jcfg = dataclasses.replace(jax_get_arch(arch, smoke=True),
                               attn_impl=impl)
    japi = jax_get_model(jcfg, tp_size=1)
    jparams, _ = japi.init(jax.random.PRNGKey(0), jnp.float32)
    params = convert.lm_params_from_numpy(
        jax.tree.map(np.asarray, jparams), cfg, "cpu", torch.float32)
    return japi, jparams, get_model(cfg, device="cpu"), params


def assert_trees_close(got, want, tol, path=""):
    """Walk the reference-layout ``got`` (tensors) against ``want`` (numpy)
    leaf by leaf, normwise."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            assert_trees_close(got[k], want[k], tol, f"{path}/{k}")
        return
    rel = leaf_rel(_np(got), want)
    assert rel <= tol, f"{path}: {rel}"


def prefill_decode_parity(japi, jparams, api, params, batches, tokens_after,
                          max_len=MAX_LEN):
    """Prefill each single-request batch on both sides (logits and cache
    within 1e-4), write the caches slot by slot into caches of the leaf
    dtypes the engine allocates (the port's ``cache_specs`` at f32
    weights), then four decode steps with a per-slot position vector
    (logits within 1e-3). ``batches``: [(JAX batch, port batch, prompt
    length)]."""
    n = len(batches)
    dts = {name: dt for name, (_, dt) in api.cache_specs(
        ShapeConfig("t", "decode", max_len, n), torch.float32).items()}

    def jdt(name):
        return jnp.float32 if dts[name] == torch.float32 else jnp.bfloat16

    big_j = big_t = None
    with _mesh():
        for slot, (bj, bt, _) in enumerate(batches):
            cache_j, logits_j = japi.prefill(jparams, bj, AXES,
                                             max_len=max_len)
            cache_t, logits_t = api.prefill(params, bt, max_len=max_len)
            close(logits_t, logits_j, 1e-4)
            want = convert.lm_cache_from_numpy(
                jax.tree.map(np.asarray, cache_j), "cpu")
            assert sorted(cache_t) == sorted(want) == sorted(dts)
            if big_t is None:
                # the reference's tree (tuples for the hybrid's states) in
                # the port's leaf dtypes
                big_j = {name: (tuple(jnp.zeros((c.shape[0], n,
                                                 *c.shape[2:]),
                                                jdt(f"{name}{j}"))
                                      for j, c in enumerate(node))
                                if isinstance(node, tuple) else
                                jnp.zeros((node.shape[0], n,
                                           *node.shape[2:]), jdt(name)))
                         for name, node in cache_j.items()}
                big_t = {name: torch.zeros((c.shape[0], n, *c.shape[2:]),
                                           dtype=dts[name])
                         for name, c in cache_t.items()}
            for name in want:
                close(cache_t[name], want[name], 1e-4)
                big_t[name][:, slot] = cache_t[name][:, 0].to(
                    big_t[name].dtype)
            big_j = jax.tree.map(
                lambda big, small: big.at[:, slot].set(
                    small[:, 0].astype(big.dtype)), big_j, cache_j)
        jdtypes = jax.tree.map(lambda a: a.dtype, big_j)

        tok = np.asarray(tokens_after, np.int32)
        for step in range(4):
            pos = np.array([b[2] for b in batches], np.int32) + step
            logits_j, new_j = japi.decode(jparams, big_j, jnp.asarray(tok),
                                          jnp.asarray(pos), AXES)
            big_j = jax.tree.map(lambda a, dt: a.astype(dt), new_j,
                                 jdtypes)
            logits_t, big_t = api.decode(params, big_t,
                                         torch.from_numpy(tok).long(),
                                         torch.from_numpy(pos).long())
            close(logits_t, logits_j, 1e-3)
            tok = np.asarray(jnp.argmax(logits_j, axis=-1), np.int32)
    want = convert.lm_cache_from_numpy(jax.tree.map(np.asarray, big_j), "cpu")
    for name, dt in dts.items():
        assert big_t[name].dtype == dt, name
        close(big_t[name], want[name], 1e-2)


def loss_grads_parity(japi, jparams, api, params, jbatch, batch):
    """The loss (relative 1e-5) and every grad leaf (normwise 1e-4) against
    ``jax.value_and_grad`` at remat off."""
    with _mesh():
        loss_j, grads_j = jax.value_and_grad(
            lambda p: japi.loss(p, jbatch, AXES, remat=False))(jparams)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = api.loss(params, batch, remat=False)
    grads = tree_unflatten(params, list(torch.autograd.grad(loss, leaves)))
    assert float(loss) == pytest.approx(float(loss_j), rel=1e-5)
    assert_trees_close(convert.stack_lm(grads, api.cfg),
                       jax.tree.map(np.asarray, grads_j), 1e-4)
    # remat recomputes the same operations: bitwise equal on the CPU
    loss_r = api.loss(params, batch, remat=True)
    grads_r = torch.autograd.grad(loss_r, leaves)
    assert torch.equal(loss_r, loss)
    for a, b in zip(grads_r, tree_leaves(grads)):
        assert torch.equal(a, b)


def engine_parity(japi, jparams, api, params):
    """tests/test_serving_engine.py's settings: six requests through four
    slots, eight greedy tokens each; equal token for token."""
    kw = dict(max_batch=4, max_len=64, max_new_tokens=8, eos_token=-1)
    jeng = JaxServingEngine(japi, jparams, JaxServeConfig(**kw))
    eng = ServingEngine(api, params, ServeConfig(**kw), device="cpu")
    rng = np.random.default_rng(0)
    for n in (5, 9, 3, 7, 6, 4):
        prompt = rng.integers(1, api.cfg.vocab_size, size=n)
        assert jeng.submit(prompt) == eng.submit(prompt)
    with _mesh():
        want = jeng.run(AXES)
    got = eng.run()
    assert got == want
    assert eng.ticks == jeng.ticks


_STEP = re.compile(r"step\s+(\d+)\s+loss=([0-9.]+)")


def step_losses(text: str) -> dict:
    return {int(s): float(v) for s, v in _STEP.findall(text)}


def ref_train(arch, *runs) -> str:
    """The reference launcher's runs on ``arch``'s smoke config, one after
    another in one subprocess (its environment staging wants a fresh
    process); their stdout."""
    common = ["--arch", arch, "--smoke", "--batch", "2", "--seq", "16",
              "--log-every", "1"]
    code = "from repro.launch.train import main\n" + "".join(
        f"main({common + list(r)!r})\n" for r in runs)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


def resume_parity(arch, tmp_path, capsys):
    """The reference launcher trains 2 steps (a checkpoint at 2), then
    resumes to step 4. The port's launcher resumes the same checkpoint:
    its state (parameters, moments, step) equals the checkpoint's leaves
    bit for bit, and its first resumed step's loss is within RESUME_REL of
    the reference's; then the port's own checkpoint holds the reference's
    leaf paths, shapes and dtypes."""
    from repro_torch.ft.checkpoint import CheckpointManager, _leaves, \
        _to_numpy
    from repro_torch.launch.train import main, run
    from repro_torch.training.optim import AdamWState
    cfg = get_arch(arch, smoke=True)
    ckpt = str(tmp_path / "ref")
    ref = ref_train(arch, ("--steps", "2", "--ckpt-dir", ckpt,
                           "--ckpt-every", "2"),
                    ("--steps", "4", "--ckpt-dir", ckpt, "--resume"))
    want = step_losses(ref.split("[train] resumed from step 2")[1])
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
            "--seq", "16", "--log-every", "1", "--ckpt-dir", ckpt,
            "--resume"]

    state = run(argv + ["--steps", "2"])           # resumes, takes no step
    mine = dict(_leaves({
        "params": convert.stack_lm(state.params, cfg),
        "opt": AdamWState(state.opt.step.cpu(),
                          convert.stack_lm(state.opt.m, cfg),
                          convert.stack_lm(state.opt.v, cfg))}))
    step_dir = os.path.join(ckpt, "step_000000002")
    with open(os.path.join(step_dir, "manifest.json")) as f:
        leaves = json.load(f)["leaves"]
    assert sorted(mine) == sorted(leaves)
    for name, meta in leaves.items():
        got = _to_numpy(mine[name])
        theirs = np.load(os.path.join(step_dir, meta["file"]))
        assert list(got.shape) == meta["shape"], name
        assert got.tobytes() == theirs.tobytes(), name

    main(argv + ["--steps", "3"])
    out = capsys.readouterr().out
    assert "[train] resumed from step 2" in out
    got = step_losses(out)
    assert sorted(got) == [3]
    assert got[3] == pytest.approx(want[3], rel=RESUME_REL)

    port = str(tmp_path / "port")
    main(argv[:-3] + ["--steps", "2", "--ckpt-every", "2", "--ckpt-dir",
                      port])
    mine = CheckpointManager(port)._manifest(2)["leaves"]
    assert {k: (v["shape"], v["dtype"]) for k, v in mine.items()} == \
        {k: (v["shape"], v["dtype"]) for k, v in leaves.items()}


# ---------------------------------------------------------------------------
# the Mamba2 modules
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def zamba():
    return models(ARCH)


def _layer(jparams, params, i=0):
    """Layer i's parameters in both packages."""
    period = get_arch(ARCH, smoke=True).attn_period
    jl = jax.tree.map(lambda a: a[i // period, i % period], jparams["layers"])
    return jl, params["layers"][i]


def test_causal_conv_matches_jax(zamba):
    from repro.models import ssm as jax_ssm
    from repro_torch.models import ssm
    _, jparams, api, params = zamba
    jl, pl = _layer(jparams, params)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 9, jl["conv_w"].shape[1])).astype(np.float32)
    k = api.cfg.conv_kernel
    want = jax_ssm._causal_conv(jnp.asarray(x), jl["conv_w"], jl["conv_b"], k)
    got = ssm._causal_conv(_t(x), pl["conv_w"], pl["conv_b"], k)
    close(got, want, 1e-5)


@pytest.mark.parametrize("s", [1, 100, 300])
@pytest.mark.parametrize("with_state", [False, True])
def test_mamba2_block_matches_jax(zamba, s, with_state):
    """Chunks of 128: one short chunk, one ragged, three with a ragged
    tail; from zeros and from a carried state."""
    from repro.models import ssm as jax_ssm
    from repro_torch.models import ssm
    _, jparams, api, params = zamba
    cfg = api.cfg
    jl, pl = _layer(jparams, params, 1)
    rng = np.random.default_rng(s)
    x = rng.normal(size=(2, s, cfg.d_model)).astype(np.float32)
    _, h, _ = ssm.ssm_dims(cfg)
    st = rng.normal(size=(2, h, cfg.ssm_state, 64)).astype(np.float32) \
        if with_state else None
    with _mesh():
        out_j, (ssm_j, conv_j) = jax_ssm.mamba2_block(
            jl, jnp.asarray(x), jax_get_arch(ARCH, smoke=True), AXES,
            initial_state=None if st is None else jnp.asarray(st),
            return_state=True)
    out_t, (ssm_t, conv_t) = ssm.mamba2_block(
        pl, _t(x), cfg, initial_state=None if st is None else _t(st),
        return_state=True)
    close(out_t, out_j, 1e-4)
    close(ssm_t, ssm_j, 1e-4)
    assert ssm_t.dtype == torch.float32
    if s >= cfg.conv_kernel - 1:
        close(conv_t, conv_j, 1e-6)
    else:
        # the reference's slice is short here; the port pads with the
        # zero rows the conv saw
        k = cfg.conv_kernel - 1
        assert conv_t.shape[1] == k
        close(conv_t[:, k - s:], conv_j, 1e-6)
        assert not bool(conv_t[:, :k - s].any())


def test_mamba2_decode_matches_jax_and_continues_the_block(zamba):
    """Prefill 20 tokens, then 3 decode steps: each step's output and
    states equal the reference's, and the outputs equal the block's own on
    the 23 tokens (the exact handoff)."""
    from repro.models import ssm as jax_ssm
    from repro_torch.models import ssm
    _, jparams, api, params = zamba
    cfg = api.cfg
    jcfg = jax_get_arch(ARCH, smoke=True)
    jl, pl = _layer(jparams, params, 2)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 23, cfg.d_model)).astype(np.float32)
    full = ssm.mamba2_block(pl, _t(x), cfg)
    with _mesh():
        _, st_j = jax_ssm.mamba2_block(jl, jnp.asarray(x[:, :20]), jcfg,
                                       AXES, return_state=True)
    _, st_t = ssm.mamba2_block(pl, _t(x[:, :20]), cfg, return_state=True)
    for t in range(20, 23):
        with _mesh():
            out_j, st_j = jax_ssm.mamba2_decode(jl, jnp.asarray(x[:, t:t + 1]),
                                                st_j, jcfg, AXES)
        out_t, st_t = ssm.mamba2_decode(pl, _t(x[:, t:t + 1]), st_t, cfg)
        close(out_t, out_j, 1e-4)
        close(st_t[0], st_j[0], 1e-4)
        close(st_t[1], st_j[1], 1e-6)
        close(out_t[:, 0], full[:, t], 1e-4)


# ---------------------------------------------------------------------------
# the family
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["chunked", "flash"])
def test_forward_prefill_decode_match_jax(impl):
    """forward's hidden states, the prefill cache (the shared K/V ring of a
    21-token prompt, padded rows of an 11-token one, every Mamba2 state)
    and logits, and four decode steps with a per-slot position vector."""
    from repro.models import zamba as jax_zamba
    from repro_torch.models import zamba
    japi, jparams, api, params = models(ARCH, impl)
    rng = np.random.default_rng(6)
    tokens = rng.integers(1, api.cfg.vocab_size, size=(2, 40)).astype(
        np.int32)
    with _mesh():
        hid_j, _ = jax_zamba.forward(jparams, jnp.asarray(tokens), japi.cfg,
                                     AXES, remat=False)
    hid_t, _ = zamba.forward(params, torch.from_numpy(tokens).long(),
                             api.cfg, remat=False)
    close(hid_t, hid_j, 1e-4)
    prompts = [rng.integers(1, api.cfg.vocab_size, size=n).astype(np.int32)
               for n in PROMPT_LENS]
    batches = [({"tokens": jnp.asarray(p[None])},
                {"tokens": torch.from_numpy(p[None]).long()}, len(p))
               for p in prompts]
    prefill_decode_parity(japi, jparams, api, params, batches,
                          [rng.integers(1, api.cfg.vocab_size)
                           for _ in prompts])


def test_lm_loss_and_grads_match_jax(zamba):
    japi, jparams, api, params = zamba
    rng = np.random.default_rng(0)
    tok = rng.integers(1, api.cfg.vocab_size, (2, 20)).astype(np.int32)
    lab = np.roll(tok, -1, 1)
    lab[:, -1] = -1
    loss_grads_parity(
        japi, jparams, api, params,
        {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)},
        {"tokens": torch.from_numpy(tok).long(),
         "labels": torch.from_numpy(lab).long()})


def test_params_convert_and_init_dtypes(zamba):
    """The conversion keeps A_log, D, dt_bias, conv_b and the norms f32 at
    bf16; the port's own init draws the same names, shapes and dtypes, and
    stack_lm / unstack_lm round-trip it."""
    _, jparams, api, _ = zamba
    cfg = api.cfg
    got = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       cfg, "cpu", torch.bfloat16)
    mine = api.init(0, torch.bfloat16)
    for tree in (got, mine):
        assert len(tree["layers"]) == cfg.n_layers
        for name in ("A_log", "D", "dt_bias", "conv_b", "ln", "ssm_norm"):
            assert tree["layers"][0][name].dtype == torch.float32, name
        for name in ("in_proj", "conv_w", "out_proj"):
            assert tree["layers"][0][name].dtype == torch.bfloat16, name
        assert tree["shared"]["wq"].dtype == torch.bfloat16
    assert {k: (tuple(v.shape), v.dtype) for k, v in
            mine["layers"][0].items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in got["layers"][0].items()}
    assert sorted(mine["shared"]) == sorted(got["shared"])
    back = convert.unstack_lm(convert.stack_lm(mine, cfg), cfg, "cpu")
    for a, b in zip(tree_leaves(mine), tree_leaves(back)):
        assert torch.equal(a, b)
    stacked = convert.stack_lm(mine, cfg)
    assert stacked["layers"]["in_proj"].shape[:2] == (
        cfg.n_layers // cfg.attn_period, cfg.attn_period)
    assert convert.lm_skeleton(mine, cfg).keys() == stacked.keys()


def test_cache_specs_keep_the_states_f32():
    """The reference's spec at bf16 weights: K/V and conv rows bf16, the
    SSM states f32; f32 weights keep the conv rows f32 (as the
    reference's engine holds them after its first tick) and K/V bf16."""
    api = get_model(get_arch(ARCH), device="cpu")
    shape = ShapeConfig("d", "decode", 8192, 4)
    specs = api.cache_specs(shape)
    assert specs["k"] == ((9, 4, 4096, 32, 80), torch.bfloat16)
    assert specs["ssm0"] == ((9, 4, 80, 64, 64), torch.float32)
    assert specs["conv5"] == ((9, 4, 3, 5248), torch.bfloat16)
    assert len(specs) == 2 + 2 * 6
    f32 = api.cache_specs(shape, torch.float32)
    assert f32["conv5"][1] == torch.float32 and f32["v"][1] == torch.bfloat16
    jshapes, _ = jax_get_model(jax_get_arch(ARCH)).cache_specs(
        JaxShapeConfig("d", "decode", 8192, 4), AXES)
    got = convert.lm_cache_from_numpy(
        jax.tree.map(lambda s: np.zeros((0,)), jshapes), "cpu")
    assert sorted(got) == sorted(specs)


def test_serving_engine_greedy_matches_jax(zamba):
    engine_parity(*zamba)


def test_launch_train_resumes_a_reference_checkpoint(tmp_path, capsys):
    resume_parity(ARCH, tmp_path, capsys)


def test_launch_serve_smoke_on_cpu(capsys):
    from repro_torch.launch.serve import main
    out = main(["--arch", ARCH, "--smoke", "--device", "cpu", "--requests",
                "5", "--max-len", "48", "--prompt-len", "30"])
    assert sorted(out) == [1, 2, 3, 4, 5]
    assert all(len(v) == 16 for v in out.values())
    assert f"[serve] {ARCH}: 5 requests, 80 tokens" in \
        capsys.readouterr().out
