"""The port's encoder-decoder family (seamless-m4t-medium: cross-attention,
the encoder over stub frame embeddings, the decoder) against the JAX
package, on the CPU.

The smoke config with its vocabulary cut to 250 in both packages, so the
tied embedding pads to 256 rows and the logits mask 6 of them; the JAX
package's f32 ``init_encdec`` parameters (``PRNGKey(0)``), converted by
``repro_torch.convert.lm_params_from_numpy``; frames and tokens from numpy
seeds. The tolerances are ``tests/test_torch_hybrid.py``'s (whose helpers
this file shares): 1e-4 on cross-attention, hidden states, the prefill
cache and logits (the JAX flash kernel in interpret mode, the port's plain
version); 1e-3 on decode logits over bf16 K/V leaves; loss relative 1e-5,
grads normwise 1e-4. The engine and both launchers refuse the family.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import get_model as jax_get_model
from repro_torch import convert
from repro_torch.configs import ShapeConfig, get_arch
from repro_torch.models import get_model
from repro_torch.models.common import NEG_INF, padded_vocab_size
from repro_torch.serving import ServeConfig, ServingEngine
from test_torch_hybrid import (AXES, _mesh, _t, close, loss_grads_parity,
                               prefill_decode_parity)

ARCH = "seamless-m4t-medium"
VOCAB = 250          # pads to 256: the last 6 logits are masked
DECODER_PROMPTS = (3, 6)
MAX_LEN = 16


def _models(impl="chunked"):
    """(JAX api, JAX f32 params, port api, the same params converted) of
    the smoke config at VOCAB."""
    cfg = dataclasses.replace(get_arch(ARCH, smoke=True), attn_impl=impl,
                              vocab_size=VOCAB)
    jcfg = dataclasses.replace(jax_get_arch(ARCH, smoke=True),
                               attn_impl=impl, vocab_size=VOCAB)
    japi = jax_get_model(jcfg, tp_size=1)
    jparams, _ = japi.init(jax.random.PRNGKey(0), jnp.float32)
    params = convert.lm_params_from_numpy(
        jax.tree.map(np.asarray, jparams), cfg, "cpu", torch.float32)
    return japi, jparams, get_model(cfg, device="cpu"), params


@pytest.fixture(scope="module")
def seamless():
    return _models()


def _frames(s, seed, d):
    return np.random.default_rng(seed).normal(size=(1, s, d)).astype(
        np.float32)


def test_cross_attention_matches_jax(seamless):
    from repro.models import attention as jax_attention
    from repro_torch.models import attention
    _, jparams, api, params = seamless
    cfg, jcfg = api.cfg, jax_get_arch(ARCH, smoke=True)
    jl = jax.tree.map(lambda a: a[0], jparams["decoder"])
    pl = params["decoder"][0]
    rng = np.random.default_rng(3)
    h, kh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    x = rng.normal(size=(2, 7, cfg.d_model)).astype(np.float32)
    k = rng.normal(size=(2, 40, kh, dh)).astype(np.float32)
    v = rng.normal(size=(2, 40, kh, dh)).astype(np.float32)
    with _mesh():
        want = jax_attention.cross_attention_block(
            jl, jnp.asarray(x), (jnp.asarray(k), jnp.asarray(v)), jcfg, AXES)
        want1 = jax_attention.decode_cross_attention(
            jl, jnp.asarray(x[:, :1]), (jnp.asarray(k), jnp.asarray(v)),
            jcfg, AXES)
    got = attention.cross_attention_block(pl, _t(x), (_t(k), _t(v)), cfg)
    got1 = attention.decode_cross_attention(pl, _t(x[:, :1]), (_t(k), _t(v)),
                                            cfg)
    close(got, want, 1e-4)
    close(got1, want1, 1e-4)
    # one token against the memory: the block and the decode path agree
    close(got1, got[:, :1], 1e-5)
    assert h % kh == 0


@pytest.mark.parametrize("impl,s_enc", [("chunked", 40), ("flash", 128)])
def test_encode_prefill_decode_match_jax(impl, s_enc):
    """The encoder's and the decoder's hidden states, the prefill cache
    (self K/V padded to MAX_LEN, the cross K/V of the frames) and the
    masked logits of two requests (decoder prompts of 3 and 6 tokens), then
    four decode steps with a per-slot position vector. Flash runs the
    encoder non-causal (S_enc % 128 == 0) and the decoder causal."""
    from repro.models import encdec as jax_encdec
    from repro_torch.models import encdec
    japi, jparams, api, params = _models(impl)
    cfg = api.cfg
    rng = np.random.default_rng(8)
    frames = _frames(s_enc, 1, cfg.d_model)
    tok = rng.integers(1, VOCAB, size=(1, 9)).astype(np.int32)
    with _mesh():
        mem_j = jax_encdec.encode(jparams, jnp.asarray(frames), japi.cfg,
                                  AXES, remat=False)
        hid_j, _ = jax_encdec.decode_train(jparams, jnp.asarray(tok), mem_j,
                                           japi.cfg, AXES, remat=False)
    mem_t = encdec.encode(params, _t(frames), cfg, remat=False)
    hid_t, _ = encdec.decode_train(params, torch.from_numpy(tok).long(),
                                   mem_t, cfg, remat=False)
    close(mem_t, mem_j, 1e-4)
    close(hid_t, hid_j, 1e-4)

    batches = []
    for i, n in enumerate(DECODER_PROMPTS):
        f = _frames(s_enc, 10 + i, cfg.d_model)
        p = rng.integers(1, VOCAB, size=(1, n)).astype(np.int32)
        batches.append(({"frames": jnp.asarray(f), "tokens": jnp.asarray(p)},
                        {"frames": _t(f),
                         "tokens": torch.from_numpy(p).long()}, n))
    prefill_decode_parity(japi, jparams, api, params, batches,
                          [rng.integers(1, VOCAB) for _ in batches],
                          max_len=MAX_LEN)


def test_logits_mask_the_padded_vocabulary(seamless):
    _, _, api, params = seamless
    assert params["embed"].shape[0] == padded_vocab_size(VOCAB) == 256
    f = _frames(40, 2, api.cfg.d_model)
    cache, logits = api.prefill(params, {"frames": _t(f),
                                         "tokens": torch.tensor([[5, 6]])},
                                max_len=8)
    assert bool((logits[:, VOCAB:] == NEG_INF).all())
    assert bool(torch.isfinite(logits[:, :VOCAB]).all())
    logits, _ = api.decode(params, cache, torch.tensor([7]), 2)
    assert bool((logits[:, VOCAB:] == NEG_INF).all())
    assert int(torch.argmax(logits)) < VOCAB
    assert padded_vocab_size(get_arch(ARCH).vocab_size) == 256256


def test_seq2seq_loss_and_grads_match_jax(seamless):
    japi, jparams, api, params = seamless
    rng = np.random.default_rng(0)
    frames = rng.normal(size=(2, 24, api.cfg.d_model)).astype(np.float32)
    tok = rng.integers(1, VOCAB, (2, 10)).astype(np.int32)
    lab = np.roll(tok, -1, 1)
    lab[:, -1] = -1
    loss_grads_parity(
        japi, jparams, api, params,
        {"frames": jnp.asarray(frames), "tokens": jnp.asarray(tok),
         "labels": jnp.asarray(lab)},
        {"frames": _t(frames), "tokens": torch.from_numpy(tok).long(),
         "labels": torch.from_numpy(lab).long()})


def test_params_convert_and_init(seamless):
    """Encoder and decoder lists of the reference's layer trees; norms f32
    at bf16; stack_lm / unstack_lm round-trip the port's own init."""
    _, jparams, api, _ = seamless
    cfg = api.cfg
    got = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       cfg, "cpu", torch.bfloat16)
    mine = api.init(0, torch.bfloat16)
    for tree in (got, mine):
        assert len(tree["encoder"]) == cfg.n_enc_layers
        assert len(tree["decoder"]) == cfg.n_dec_layers
        assert tree["decoder"][0]["x_wq"].dtype == torch.bfloat16
        assert tree["decoder"][0]["lnx"].dtype == torch.float32
        assert tree["enc_final"].dtype == torch.float32
    for part in ("encoder", "decoder"):
        assert {k: (tuple(v.shape), v.dtype) for k, v in
                mine[part][0].items()} == \
            {k: (tuple(v.shape), v.dtype) for k, v in got[part][0].items()}
    back = convert.unstack_lm(convert.stack_lm(mine, cfg), cfg, "cpu")
    assert sorted(back) == sorted(mine)
    assert torch.equal(back["decoder"][1]["x_wo"], mine["decoder"][1]["x_wo"])


def test_specs():
    api = get_model(get_arch(ARCH), device="cpu")
    assert api.input_specs(ShapeConfig("p", "prefill", 2048, 4)) == {
        "frames": ((4, 2048, 1024), torch.bfloat16),
        "tokens": ((4, 1), torch.int32)}
    assert api.input_specs(ShapeConfig("t", "train", 256, 2))["frames"] == \
        ((2, 256, 1024), torch.bfloat16)
    kv = ((12, 4, 64, 16, 64), torch.bfloat16)
    assert api.cache_specs(ShapeConfig("d", "decode", 64, 4)) == {
        "k": kv, "v": kv, "xk": kv, "xv": kv}


def test_engine_and_launchers_refuse_the_family(seamless):
    from repro_torch.launch import serve, train
    _, _, api, params = seamless
    with pytest.raises(ValueError, match="per-request encoder memory"):
        ServingEngine(api, params, ServeConfig(), device="cpu")
    with pytest.raises(ValueError, match="per-request encoder memory"):
        serve.main(["--arch", ARCH, "--smoke", "--device", "cpu"])
    with pytest.raises(ValueError, match="needs frames"):
        train.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps",
                    "1"])


def test_flash_refuses_a_gradient(seamless):
    _, _, _, params = seamless
    api = get_model(dataclasses.replace(get_arch(ARCH, smoke=True),
                                        attn_impl="flash"), device="cpu")
    with pytest.raises(RuntimeError, match='attn_impl="chunked"'):
        api.loss(params, {})
