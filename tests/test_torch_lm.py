"""The port's LM serving path against the JAX package, on the CPU.

The same numpy inputs go through both packages. The models use the JAX
package's f32 ``init_lm`` parameters, converted by
``repro_torch.convert.lm_params_from_numpy``; the JAX flash kernel runs in
Pallas interpret mode, as ``tests/test_pallas_kernels.py`` runs it.

Tolerances, and why:
- f32 attention and model outputs: 1e-4 (rtol and atol; 2e-5 for the flash
  kernel, the JAX test's own limit). Both sides do f32 math on the same
  inputs; only the order of the sums differs, and two layers carry it.
- bf16 flash tiles: 1e-2. Both sides round q, k and v to bf16 once and do
  f32 math; the outputs, rounded to bf16, may differ by one bf16 step
  (2^-8 relative) where the f32 results straddle a rounding boundary.
- decode logits: 1e-3. The KV cache is bf16 on both sides, and a K or V
  value whose f32 results differ in the last bit may round to neighbouring
  bf16 values (one step, 2^-8 relative) on the two sides.
- generated tokens: equal, token for token (greedy, f32 parameters).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.distributed.compat import make_mesh
from repro.kernels import ops as jax_ops
from repro.models import Axes
from repro.models import common as jax_common
from repro.models import get_model as jax_get_model
from repro.serving import ServeConfig as JaxServeConfig
from repro.serving import ServingEngine as JaxServingEngine
from repro_torch import convert
from repro_torch.configs import ARCHS, get_arch
from repro_torch.kernels import ops
from repro_torch.models import common, get_model
from repro_torch.serving import (ServeConfig, ServingEngine, greedy,
                                 sample_top_p)

AXES = Axes(dp=("data",), tp="model")
FLASH_CASES = [
    # (B, H, KH, Sq, Sk, dh, causal, softcap), tests/test_pallas_kernels.py
    (2, 4, 4, 128, 128, 64, True, None),      # MHA, aligned
    (1, 8, 2, 100, 100, 64, True, None),      # GQA + ragged (padding path)
    (2, 4, 2, 256, 256, 128, True, 50.0),     # gemma-style softcap
    (1, 2, 2, 64, 256, 64, False, None),      # cross attention (non-causal)
    (1, 4, 1, 200, 200, 64, True, None),      # MQA
]
# (arch, attn_impl): olmo both ways; gemma2's window 8 under prompts longer
# than it (ring buffer, softcaps, sandwich norms); qwen3's qk_norm and
# untied head
MODEL_CASES = [("olmo-1b", "flash"), ("olmo-1b", "chunked"),
               ("gemma2-2b", "chunked"), ("qwen3-32b", "chunked")]
PROMPT_LENS = (11, 13)
MAX_LEN = 24


def _mesh():
    return make_mesh((1, 1), ("data", "model"))


def _t(a, dtype=None):
    t = torch.from_numpy(np.asarray(a))
    return t if dtype is None else t.to(dtype)


def _np(t):
    return t.detach().to(torch.float32).numpy()


@pytest.mark.parametrize("prec", ["f32", "bf16"])
@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=[f"B{c[0]}H{c[1]}KH{c[2]}S{c[3]}x{c[4]}"
                              for c in FLASH_CASES])
def test_flash_plain_matches_jax_kernel(case, prec):
    b, h, kh, sq, sk, dh, causal, cap = case
    rng = np.random.default_rng(7)
    q = rng.normal(size=(b, h, sq, dh)).astype(np.float32)
    k = rng.normal(size=(b, kh, sk, dh)).astype(np.float32)
    v = rng.normal(size=(b, kh, sk, dh)).astype(np.float32)
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                              softcap=cap, precision=prec)
    want = jax_ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal, softcap=cap,
                                   interpret=True, precision=prec)
    assert got.dtype == (torch.bfloat16 if prec == "bf16" else torch.float32)
    tol = 1e-2 if prec == "bf16" else 2e-5
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def test_flash_rejects_ragged_non_causal():
    q = torch.zeros(1, 2, 64, 16)
    k = torch.zeros(1, 2, 100, 16)
    with pytest.raises(ValueError, match="Sk % 128"):
        ops.flash_attention(q, k, k, causal=False)


@pytest.mark.parametrize("cap", [None, 50.0])
@pytest.mark.parametrize("window,q_offset,q_chunk",
                         [(None, 0, 512), (16, 8, 16), (5, 0, 7)])
def test_chunked_attention_matches_jax(window, q_offset, q_chunk, cap):
    rng = np.random.default_rng(3)
    q = rng.normal(size=(2, 40, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 40 + q_offset, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 40 + q_offset, 2, 16)).astype(np.float32)
    kw = dict(causal=True, window=window, attn_softcap=cap, q_chunk=q_chunk,
              q_offset=q_offset)
    got = common.chunked_attention(_t(q), _t(k), _t(v), **kw)
    want = jax_common.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), **kw)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope_matches_jax(theta):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 10, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 100, size=(2, 10)).astype(np.int32)
    got = common.apply_rope(_t(x), _t(pos), theta=theta)
    want = jax_common.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                 theta=theta)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("weight,plus_one",
                         [(None, False), ("w", False), ("w", True)])
def test_rms_norm_matches_jax(weight, plus_one):
    rng = np.random.default_rng(5)
    x = (3.0 * rng.normal(size=(3, 5, 64))).astype(np.float32)
    w = rng.normal(size=(64,)).astype(np.float32) if weight else None
    got = common.rms_norm(_t(x), None if w is None else _t(w),
                          plus_one=plus_one)
    want = jax_common.rms_norm(jnp.asarray(x),
                               None if w is None else jnp.asarray(w),
                               plus_one=plus_one)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("cap", [None, 30.0])
def test_softcap_and_swiglu_match_jax(cap):
    rng = np.random.default_rng(8)
    x = (40.0 * rng.normal(size=(4, 64))).astype(np.float32)
    y = rng.normal(size=(4, 64)).astype(np.float32)
    np.testing.assert_allclose(_np(common.softcap(_t(x), cap)),
                               np.asarray(jax_common.softcap(jnp.asarray(x),
                                                             cap)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(common.swiglu(_t(x), _t(y))),
                               np.asarray(jax_common.swiglu(jnp.asarray(x),
                                                            jnp.asarray(y))),
                               rtol=1e-5, atol=1e-5)


def _models(arch, impl):
    """(JAX api, JAX f32 params, port api, the same params converted)."""
    cfg = dataclasses.replace(get_arch(arch, smoke=True), attn_impl=impl)
    jcfg = dataclasses.replace(jax_get_arch(arch, smoke=True), attn_impl=impl)
    japi = jax_get_model(jcfg, tp_size=1)
    jparams, _ = japi.init(jax.random.PRNGKey(0), jnp.float32)
    params = convert.lm_params_from_numpy(
        jax.tree.map(np.asarray, jparams), cfg, "cpu", torch.float32)
    return japi, jparams, get_model(cfg, device="cpu"), params


@pytest.mark.parametrize("arch,impl", MODEL_CASES)
def test_forward_prefill_decode_match_jax(arch, impl):
    """forward's hidden states, prefill's cache and logits, and four
    decode steps with a per-slot position vector over a bf16 cache written
    slot by slot, as the engine writes it."""
    from repro.models import transformer as jax_transformer
    from repro_torch.models import transformer
    japi, jparams, api, params = _models(arch, impl)
    cfg = api.cfg
    rng = np.random.default_rng(6)
    tokens = rng.integers(1, cfg.vocab_size, size=(2, 12)).astype(np.int32)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
               for n in PROMPT_LENS]
    with _mesh():
        hid_j, _ = jax_transformer.forward(jparams, jnp.asarray(tokens),
                                           japi.cfg, AXES, remat=False)
        hid_t, _ = transformer.forward(params, _t(tokens).long(), cfg)
        np.testing.assert_allclose(_np(hid_t), np.asarray(hid_j), rtol=1e-4,
                                   atol=1e-4)

        big_j, big_t = None, None
        for slot, prompt in enumerate(prompts):
            cache_j, logits_j = japi.prefill(
                jparams, {"tokens": jnp.asarray(prompt[None])}, AXES,
                max_len=MAX_LEN)
            cache_t, logits_t = api.prefill(
                params, {"tokens": _t(prompt[None]).long()}, max_len=MAX_LEN)
            np.testing.assert_allclose(_np(logits_t), np.asarray(logits_j),
                                       rtol=1e-4, atol=1e-4)
            assert sorted(cache_t) == sorted(cache_j)
            if big_j is None:
                big_j = {n: jnp.zeros((c.shape[0], 2, *c.shape[2:]),
                                      jnp.bfloat16)
                         for n, c in cache_j.items()}
                big_t = {n: torch.zeros((c.shape[0], 2, *c.shape[2:]),
                                        dtype=torch.bfloat16)
                         for n, c in cache_t.items()}
            for n in cache_j:
                np.testing.assert_allclose(_np(cache_t[n]),
                                           np.asarray(cache_j[n]), rtol=1e-4,
                                           atol=1e-4)
                big_j[n] = big_j[n].at[:, slot].set(
                    cache_j[n][:, 0].astype(jnp.bfloat16))
                big_t[n][:, slot] = cache_t[n][:, 0].to(torch.bfloat16)

        tok = np.array([rng.integers(1, cfg.vocab_size) for _ in prompts],
                       np.int32)
        for step in range(4):
            pos = np.array(PROMPT_LENS, np.int32) + step
            logits_j, big_j = japi.decode(jparams, big_j, jnp.asarray(tok),
                                          jnp.asarray(pos), AXES)
            logits_t, big_t = api.decode(params, big_t, _t(tok).long(),
                                         _t(pos).long())
            np.testing.assert_allclose(_np(logits_t), np.asarray(logits_j),
                                       rtol=1e-3, atol=1e-3)
            tok = np.asarray(jnp.argmax(logits_j, axis=-1), np.int32)
        for n in big_j:
            np.testing.assert_allclose(_np(big_t[n]),
                                       np.asarray(big_j[n], np.float32),
                                       rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("arch,impl", [("olmo-1b", "chunked"),
                                       ("olmo-1b", "flash"),
                                       ("gemma2-2b", "chunked")])
def test_serving_engine_greedy_matches_jax(arch, impl):
    """tests/test_serving_engine.py's settings: six requests through four
    slots, eight greedy tokens each; equal token for token."""
    japi, jparams, api, params = _models(arch, impl)
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


def test_eos_frees_slot_early():
    _, _, api, params = _models("olmo-1b", "chunked")
    kw = dict(max_batch=1, max_len=32, max_new_tokens=4)
    probe = ServingEngine(api, params, ServeConfig(eos_token=-1, **kw),
                          device="cpu")
    up = probe.submit([5, 6, 7])
    first = probe.run()[up][0]
    eng = ServingEngine(api, params, ServeConfig(eos_token=first, **kw),
                        device="cpu")
    u = eng.submit([5, 6, 7])
    assert eng.run()[u] == [first]


def test_init_scales_and_dtypes():
    cfg = get_arch("qwen3-32b", smoke=True)
    params = get_model(cfg, device="cpu").init(0, torch.bfloat16)
    layer = params["layers"][0]
    assert len(params["layers"]) == cfg.n_layers
    assert layer["wq"].dtype == torch.bfloat16
    assert layer["qn"].dtype == torch.float32 and layer["ln1"].dtype == \
        torch.float32
    assert "lm_head" in params                      # untied
    std_wq = float(layer["wq"].float().std())
    std_emb = float(params["embed"].float().std())
    assert abs(std_wq - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5
    assert abs(std_emb - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5


def test_samplers():
    logits = torch.tensor([[0.5, 2.0, 2.0, -1.0], [3.0, 0.0, 1.0, 3.0]])
    assert greedy(logits).tolist() == [1, 0]          # lowest index on a tie
    gen = torch.Generator().manual_seed(0)
    # a nucleus smaller than the top token's mass keeps the top tokens only
    out = sample_top_p(torch.tensor([[0.0, 9.0, 1.0], [8.0, 0.0, 0.0]]),
                       gen, top_p=0.1)
    assert out.tolist() == [1, 0] and out.dtype == torch.int32


def test_launch_serve_smoke_on_cpu(capsys):
    from repro_torch.launch.serve import main
    out = main(["--arch", "olmo-1b", "--smoke", "--device", "cpu",
                "--requests", "5"])
    assert sorted(out) == [1, 2, 3, 4, 5]
    assert all(len(v) == 16 for v in out.values())
    assert "[serve] olmo-1b: 5 requests, 80 tokens" in capsys.readouterr().out


def test_entry_points_without_device_raise_here():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs there")
    cfg = get_arch("olmo-1b", smoke=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_model(cfg)
    api = get_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(api, None, ServeConfig())


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "grok-1-314b"])
def test_moe_family_builds_prefills_and_decodes(arch):
    """The MoE family is ported: its forward, prefill (cache and logits)
    and four decode steps against the JAX package's, as the dense cases."""
    api = get_model(get_arch(arch, smoke=True), device="cpu")
    assert api.cfg.family == "moe" and api.cfg.n_experts > 0
    test_forward_prefill_decode_match_jax(arch, "chunked")


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_every_config_builds_prefills_and_decodes(arch):
    """Each config's smoke model on the CPU: init, a prefill (seamless from
    frames and decoder tokens) and two decode steps give finite logits
    over the vocabulary, greedy tokens inside it."""
    cfg = get_arch(arch, smoke=True)
    api = get_model(cfg, device="cpu")
    params = api.init(0)
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.as_tensor(
        rng.integers(1, cfg.vocab_size, size=(1, 20)))}
    if cfg.family == "encdec":
        batch = {"tokens": batch["tokens"][:, :3],
                 "frames": torch.as_tensor(rng.normal(
                     size=(1, 32, cfg.d_model)).astype(np.float32)).to(
                         torch.bfloat16)}
    cache, logits = api.prefill(params, batch, max_len=32)
    pos = batch["tokens"].shape[1]
    for step in range(2):
        assert logits.shape[-1] >= cfg.vocab_size
        assert bool(torch.isfinite(logits[:, :cfg.vocab_size]).all())
        tok = torch.argmax(logits, dim=-1)
        assert int(tok) < cfg.vocab_size
        logits, cache = api.decode(params, cache, tok, pos + step)
