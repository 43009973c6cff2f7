"""The port's SSM family (rwkv6: the chunked wkv scan, time-mix and
channel-mix) against the JAX package, on the CPU.

The smoke config with the JAX package's f32 ``init_rwkv_lm`` parameters
(``PRNGKey(0)``), converted by ``repro_torch.convert.lm_params_from_numpy``;
inputs from numpy seeds. The tolerances are ``tests/test_torch_hybrid.py``'s
(whose helpers this file shares): 1e-4 on the modules, hidden states, the
prefill cache and logits; 1e-3 on decode logits (the token-shift rows are
bf16 leaves at bf16 weights; f32 here, the wkv state f32 always); loss
relative 1e-5 and grads normwise 1e-4; engine tokens equal; a resumed
checkpoint bitwise, its first step's loss within ``RESUME_REL``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro_torch import convert
from repro_torch.configs import ShapeConfig, get_arch
from repro_torch.models import get_model
from test_torch_hybrid import (AXES, _mesh, _t, close, engine_parity,
                               loss_grads_parity, models,
                               prefill_decode_parity, resume_parity)

ARCH = "rwkv6-7b"


@pytest.fixture(scope="module")
def rwkv():
    return models(ARCH)


def _wkv_inputs(s, seed, d=128):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(2, s, d)).astype(np.float32) for _ in range(3))
    # log decays in (-inf, 0): -exp(N(0, 1)), some steep, some flat
    logw = -np.exp(rng.normal(size=(2, s, d))).astype(np.float32)
    u = rng.normal(size=(d,)).astype(np.float32)
    st = rng.normal(size=(2, d // 64, 64, 64)).astype(np.float32)
    return r, k, v, logw, u, st


@pytest.mark.parametrize("s", [1, 63, 64, 65, 130])
@pytest.mark.parametrize("with_state", [False, True])
def test_wkv_chunked_matches_jax(s, with_state):
    """Chunks of 64: one token, one short chunk, exactly one, a ragged
    second, three with a ragged tail; from zeros and from a state."""
    from repro.models import rwkv as jax_rwkv
    from repro_torch.models import rwkv
    r, k, v, logw, u, st = _wkv_inputs(s, s)
    init = st if with_state else None
    out_j, st_j = jax_rwkv._wkv_chunked(
        *(jnp.asarray(a) for a in (r, k, v, logw, u)), 2,
        initial_state=None if init is None else jnp.asarray(init))
    out_t, st_t = rwkv._wkv_chunked(
        *(_t(a) for a in (r, k, v, logw, u)), 2,
        initial_state=None if init is None else _t(init))
    close(out_t, out_j, 1e-4)
    close(st_t, st_j, 1e-4)
    assert st_t.dtype == torch.float32


def test_wkv_decay_clip_keeps_long_chunks_finite():
    """Steep decays over a full chunk: the cumulative log decay reaches far
    below -30, and the clip keeps exp(-cum) finite (as the reference's)."""
    from repro_torch.models import rwkv
    r, k, v, _, u, _ = _wkv_inputs(64, 5)
    logw = np.full_like(r, -4.0)             # cum reaches -256
    out, st = rwkv._wkv_chunked(*(_t(a) for a in (r, k, v, logw, u)), 2)
    assert bool(torch.isfinite(out).all()) and bool(torch.isfinite(st).all())


@pytest.mark.parametrize("with_state", [False, True])
def test_time_mix_and_channel_mix_match_jax(rwkv, with_state):
    from repro.models import rwkv as jax_rwkv
    from repro_torch.models import rwkv as trwkv
    _, jparams, api, params = rwkv
    cfg, jcfg = api.cfg, jax_get_arch(ARCH, smoke=True)
    jl = jax.tree.map(lambda a: a[1], jparams["layers"])
    pl = params["layers"][1]
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 70, cfg.d_model)).astype(np.float32)
    x_last = rng.normal(size=(2, cfg.d_model)).astype(np.float32)
    wkv = rng.normal(size=(2, 2, 64, 64)).astype(np.float32)
    state_j = (jnp.asarray(x_last), jnp.asarray(wkv)) if with_state else None
    state_t = (_t(x_last), _t(wkv)) if with_state else None
    with _mesh():
        out_j, (xl_j, wkv_j) = jax_rwkv.time_mix(jl, jnp.asarray(x), jcfg,
                                                 AXES, state=state_j)
        cm_j, cml_j = jax_rwkv.channel_mix(
            jl, jnp.asarray(x), jcfg,
            x_last=jnp.asarray(x_last) if with_state else None)
    out_t, (xl_t, wkv_t) = trwkv.time_mix(pl, _t(x), cfg, state=state_t)
    cm_t, cml_t = trwkv.channel_mix(pl, _t(x), cfg,
                                    x_last=_t(x_last) if with_state else None)
    close(out_t, out_j, 1e-4)
    close(xl_t, xl_j, 0)
    close(wkv_t, wkv_j, 1e-4)
    close(cm_t, cm_j, 1e-4)
    close(cml_t, cml_j, 0)


def test_forward_prefill_decode_match_jax(rwkv):
    """forward's hidden states, the prefill cache (every layer's token
    shift and wkv state, prompts of 11 and 70 tokens: one chunk, two) and
    logits, and four decode steps with a per-slot position vector."""
    from repro.models import rwkv as jax_rwkv
    from repro_torch.models import rwkv as trwkv
    japi, jparams, api, params = rwkv
    rng = np.random.default_rng(6)
    tokens = rng.integers(1, api.cfg.vocab_size, size=(2, 40)).astype(
        np.int32)
    with _mesh():
        hid_j, _ = jax_rwkv.forward(jparams, jnp.asarray(tokens), japi.cfg,
                                    AXES, remat=False)
    hid_t, _ = trwkv.forward(params, torch.from_numpy(tokens).long(),
                             api.cfg, remat=False)
    close(hid_t, hid_j, 1e-4)
    prompts = [rng.integers(1, api.cfg.vocab_size, size=n).astype(np.int32)
               for n in (11, 70)]
    batches = [({"tokens": jnp.asarray(p[None])},
                {"tokens": torch.from_numpy(p[None]).long()}, len(p))
               for p in prompts]
    prefill_decode_parity(japi, jparams, api, params, batches,
                          [rng.integers(1, api.cfg.vocab_size)
                           for _ in prompts], max_len=96)


@pytest.mark.parametrize("impl", ["chunked", "flash"])
def test_lm_loss_and_grads_match_jax(impl):
    """RWKV attends nothing: it trains at either attn_impl."""
    japi, jparams, api, params = models(ARCH, impl)
    rng = np.random.default_rng(0)
    tok = rng.integers(1, api.cfg.vocab_size, (2, 70)).astype(np.int32)
    lab = np.roll(tok, -1, 1)
    lab[:, -1] = -1
    loss_grads_parity(
        japi, jparams, api, params,
        {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)},
        {"tokens": torch.from_numpy(tok).long(),
         "labels": torch.from_numpy(lab).long()})


def test_params_convert_and_init_dtypes(rwkv):
    """The mu_*/cmu_* leaves, w0, u and the norms stay f32 at bf16; the
    port's own init has the reference's names, shapes and dtypes."""
    _, jparams, api, _ = rwkv
    cfg = api.cfg
    got = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       cfg, "cpu", torch.bfloat16)
    mine = api.init(0, torch.bfloat16)
    for tree in (got, mine):
        layer = tree["layers"][0]
        for name in ("mu_r", "mu_w", "cmu_k", "cmu_r", "w0", "u", "ln_x"):
            assert layer[name].dtype == torch.float32, name
        for name in ("wr", "w1", "w2", "ck", "cv", "cr"):
            assert layer[name].dtype == torch.bfloat16, name
    assert {k: (tuple(v.shape), v.dtype) for k, v in
            mine["layers"][0].items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in got["layers"][0].items()}
    assert float(mine["layers"][0]["mu_k"][0]) == 0.5
    assert convert.stack_lm(mine, cfg)["layers"]["wr"].shape == (
        cfg.n_layers, cfg.d_model, cfg.d_model)


def test_cache_specs():
    api = get_model(get_arch(ARCH), device="cpu")
    specs = api.cache_specs(ShapeConfig("d", "decode", 4096, 8))
    assert specs == {"tm_x": ((32, 8, 4096), torch.bfloat16),
                     "cm_x": ((32, 8, 4096), torch.bfloat16),
                     "wkv": ((32, 8, 64, 64, 64), torch.float32)}


def test_serving_engine_greedy_matches_jax(rwkv):
    engine_parity(*rwkv)


def test_launch_train_resumes_a_reference_checkpoint(tmp_path, capsys):
    resume_parity(ARCH, tmp_path, capsys)


def test_launch_serve_smoke_on_cpu(capsys):
    from repro_torch.launch.serve import main
    cfg = get_arch(ARCH, smoke=True)
    out = main(["--arch", ARCH, "--smoke", "--device", "cpu", "--requests",
                "5", "--prompt-len", "80", "--max-len", "128"])
    assert sorted(out) == [1, 2, 3, 4, 5]
    assert all(len(v) == 16 and all(0 <= t < cfg.vocab_size for t in v)
               for v in out.values())
    assert f"[serve] {ARCH}: 5 requests, 80 tokens" in \
        capsys.readouterr().out
