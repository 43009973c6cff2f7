"""Parity of the port's kernel layer (``repro_torch.kernels``) with the JAX
package's, plus the port's hygiene.

On the CPU the port's wrappers run their plain PyTorch versions; these are
held against ``repro.kernels.ref`` over the sweep of
tests/test_pallas_kernels.py and against the Pallas kernels themselves in
interpret mode on two small shapes, with that file's tolerances: 1e-5 for
f32 ``kernel_matrix``, 1e-4 for f and mind, 2e-2 at bf16. Inputs are made
with numpy and handed to both packages.

The CUDA kernels themselves are held against the plain versions on the card
by tests/test_torch_cuda.py and ``chip_smoke.py``.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.precision import BF16, F32, Precision, resolve_precision

ROOT = Path(__file__).resolve().parents[1]

KINDS = ["rbf", "linear", "polynomial", "cosine"]
SHAPES = [(8, 8, 4), (100, 77, 30), (256, 256, 128), (300, 520, 129)]
SMALL = [(8, 8, 4), (100, 77, 30)]
ASSIGN_SHAPES = [(64, 32, 16), (300, 130, 40)]
PRECS = ["f32", "bf16"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one machine, some of them
    simulating 8-device JAX meshes whose collectives time out when
    starved: keep torch's CPU ops (small here) on one thread."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _tol(prec, f32_tol):
    return dict(rtol=2e-2, atol=2e-2) if prec == "bf16" \
        else dict(rtol=f32_tol, atol=f32_tol)


def _data(m, n, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(m, d)).astype(np.float32),
            rng.normal(size=(n, d)).astype(np.float32))


def _assign_inputs(m, lm, d, c, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, d)).astype(np.float32)
    landmarks = rng.normal(size=(lm, d)).astype(np.float32)
    labels_l = rng.integers(0, c, lm).astype(np.int32)
    counts = np.bincount(labels_l, minlength=c).astype(np.float32)
    g = rng.random(c).astype(np.float32)
    return x, landmarks, labels_l, counts, g


def _jax_h(labels_l, counts, g, c):
    h = jax.nn.one_hot(jnp.asarray(labels_l), c) / jnp.maximum(
        jnp.asarray(counts), 1.0)[None]
    return h, jnp.where(jnp.asarray(counts) > 0, jnp.asarray(g), 1e30)


def _port_assign(x, landmarks, labels_l, counts, g, c, kind, prec):
    lab, mind, f = ops.assign_fused(
        torch.from_numpy(x), torch.from_numpy(landmarks),
        torch.from_numpy(labels_l), torch.from_numpy(counts),
        torch.from_numpy(g), n_clusters=c, kind=kind, gamma=0.05,
        precision=prec)
    return lab.numpy(), mind.numpy(), f.numpy()


# ---------------------------------------------------------------------------
# kernel_matrix
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_matrix_matches_jax_ref(kind, shape, prec):
    x, y = _data(*shape)
    got = ops.kernel_matrix(torch.from_numpy(x), torch.from_numpy(y),
                            kind=kind, gamma=0.05, precision=prec)
    want = jref.kernel_matrix_ref(jnp.asarray(x), jnp.asarray(y), kind=kind,
                                  gamma=0.05, precision=prec)
    assert got.shape == shape[:2] and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **_tol(prec, 1e-5))


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("shape", SMALL, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_matrix_matches_jax_pallas_interpret(kind, shape, prec):
    x, y = _data(*shape)
    got = ops.kernel_matrix(torch.from_numpy(x), torch.from_numpy(y),
                            kind=kind, gamma=0.05, precision=prec)
    want = jops.kernel_matrix(jnp.asarray(x), jnp.asarray(y), kind=kind,
                              gamma=0.05, interpret=True, precision=prec)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **_tol(prec, 1e-5))


def test_kernel_matrix_rbf_diag_is_one():
    x = np.random.default_rng(3).normal(size=(40, 6)).astype(np.float32)
    k = ops.kernel_matrix(torch.from_numpy(x), torch.from_numpy(x),
                          kind="rbf", gamma=0.7).numpy()
    np.testing.assert_allclose(np.diagonal(k), 1.0, atol=1e-5)
    np.testing.assert_allclose(k, k.T, atol=1e-5)


# ---------------------------------------------------------------------------
# assign_fused / gram_matvec
# ---------------------------------------------------------------------------


# rbf and linear over the whole C sweep (as tests/test_pallas_kernels.py);
# the other two epilogues at C = 7
ASSIGN_CASES = [(k, c) for k in ("rbf", "linear") for c in (3, 7, 130)] + [
    ("polynomial", 7), ("cosine", 7)]


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("shape", ASSIGN_SHAPES, ids=["small", "ragged"])
@pytest.mark.parametrize("kind,n_clusters", ASSIGN_CASES,
                         ids=[f"{k}-C{c}" for k, c in ASSIGN_CASES])
def test_assign_fused_matches_jax_ref(kind, n_clusters, shape, prec):
    x, lm, labels_l, counts, g = _assign_inputs(*shape, n_clusters)
    got_lab, got_min, got_f = _port_assign(x, lm, labels_l, counts, g,
                                           n_clusters, kind, prec)
    h, g_masked = _jax_h(labels_l, counts, g, n_clusters)
    want_lab, want_min, want_f = jref.assign_fused_ref(
        jnp.asarray(x), jnp.asarray(lm), h, g_masked, kind=kind, gamma=0.05,
        precision=prec)
    assert got_lab.dtype == np.int32 and got_f.shape == (shape[0], n_clusters)
    np.testing.assert_array_equal(got_lab, np.asarray(want_lab))
    np.testing.assert_allclose(got_min, np.asarray(want_min),
                               **_tol(prec, 1e-4))
    np.testing.assert_allclose(got_f, np.asarray(want_f), **_tol(prec, 1e-4))


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("shape", ASSIGN_SHAPES, ids=["small", "ragged"])
@pytest.mark.parametrize("kind", ["rbf", "linear"])
def test_assign_fused_matches_jax_pallas_interpret(kind, shape, prec):
    x, lm, labels_l, counts, g = _assign_inputs(*shape, 7)
    got_lab, got_min, got_f = _port_assign(x, lm, labels_l, counts, g, 7,
                                           kind, prec)
    want_lab, want_min, want_f = jops.assign_fused(
        jnp.asarray(x), jnp.asarray(lm), jnp.asarray(labels_l),
        jnp.asarray(counts), jnp.asarray(g), n_clusters=7, kind=kind,
        gamma=0.05, interpret=True, precision=prec)
    np.testing.assert_array_equal(got_lab, np.asarray(want_lab))
    np.testing.assert_allclose(got_min, np.asarray(want_min),
                               **_tol(prec, 1e-4))
    np.testing.assert_allclose(got_f, np.asarray(want_f), **_tol(prec, 1e-4))


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("shape", ASSIGN_SHAPES, ids=["small", "ragged"])
@pytest.mark.parametrize("kind", KINDS)
def test_gram_matvec_matches_jax(kind, shape, prec):
    m, lm, d = shape
    rng = np.random.default_rng(4)
    x = rng.normal(size=(m, d)).astype(np.float32)
    landmarks = rng.normal(size=(lm, d)).astype(np.float32)
    h = rng.random((lm, 5)).astype(np.float32)
    got = ops.gram_matvec(torch.from_numpy(x), torch.from_numpy(landmarks),
                          torch.from_numpy(h), kind=kind, gamma=0.05,
                          precision=prec)
    want = jref.kernel_matrix_ref(jnp.asarray(x), jnp.asarray(landmarks),
                                  kind=kind, gamma=0.05,
                                  precision=prec) @ jnp.asarray(h)
    assert got.shape == (m, 5) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **_tol(prec, 1e-4))
    if shape in SMALL or kind not in ("rbf", "linear"):
        return
    pallas = jops.gram_matvec(jnp.asarray(x), jnp.asarray(landmarks),
                              jnp.asarray(h), kind=kind, gamma=0.05,
                              interpret=True, precision=prec)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas),
                               **_tol(prec, 1e-4))


@pytest.mark.parametrize("prec", PRECS)
def test_assign_fused_empty_cluster_never_selected(prec):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(50, 8)).astype(np.float32)
    labels_l = (np.arange(20) % 3).astype(np.int32)       # clusters 3, 4 empty
    counts = np.bincount(labels_l, minlength=5).astype(np.float32)
    lab, mind, _ = _port_assign(x, x[:20], labels_l, counts,
                                np.zeros(5, np.float32), 5, "rbf", prec)
    assert lab.max() <= 2 and np.all(mind < 1e29)


@pytest.mark.parametrize("prec", PRECS)
def test_assign_fused_bitwise_tie_takes_lowest_index(prec):
    """Two clusters over one duplicated landmark with equal g tie exactly
    for every row: both packages must answer cluster 0."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(40, 6)).astype(np.float32)
    a = rng.normal(size=(1, 6)).astype(np.float32)
    lm = np.concatenate([a, a, rng.normal(size=(1, 6)).astype(np.float32)])
    labels_l = np.array([0, 1, 2], np.int32)
    counts = np.ones(3, np.float32)
    g = np.array([0.5, 0.5, 5.0], np.float32)
    lab, _, f = _port_assign(x, lm, labels_l, counts, g, 3, "rbf", prec)
    np.testing.assert_array_equal(f[:, 0], f[:, 1])
    assert np.all(lab == 0)
    h, gm = _jax_h(labels_l, counts, g, 3)
    want, _, _ = jref.assign_fused_ref(jnp.asarray(x), jnp.asarray(lm), h, gm,
                                       kind="rbf", gamma=0.05, precision=prec)
    np.testing.assert_array_equal(lab, np.asarray(want))


def test_plain_versions_count_their_calls():
    before, launches = dict(ref.CALLS), dict(ops.LAUNCHES)
    x = torch.randn(5, 3)
    ops.kernel_matrix(x, x)
    ops.assign_fused(x, x, torch.zeros(5, dtype=torch.int32),
                     torch.tensor([5.0, 0.0]), torch.zeros(2), n_clusters=2)
    assert ref.CALLS["kernel_matrix_ref"] == before["kernel_matrix_ref"] + 2
    assert ref.CALLS["assign_fused_ref"] == before["assign_fused_ref"] + 1
    assert ops.LAUNCHES == launches      # CPU tensors never launch a kernel


# ---------------------------------------------------------------------------
# precision policy
# ---------------------------------------------------------------------------


def test_precision_policy():
    assert resolve_precision("bf16") is BF16 and resolve_precision(F32) is F32
    assert BF16.tile_dtype == torch.bfloat16 and BF16.tile_itemsize == 2
    with pytest.raises(ValueError, match="always f32"):
        Precision(tile="bf16", accum="bf16")
    with pytest.raises(ValueError):
        resolve_precision("fp8")


def test_bf16_rounding_matches_jax():
    """cast_tiles rounds to nearest even, bit for bit like jnp, including
    values halfway between two bf16 numbers."""
    rng = np.random.default_rng(6)
    v = rng.normal(size=4096).astype(np.float32)
    halfway = (np.arange(1, 257, dtype=np.uint32) << 16 | 0x8000).view(
        np.float32)
    v = np.concatenate([v, halfway, -halfway])
    got = BF16.cast_tiles(torch.from_numpy(v)).float().numpy()
    want = np.asarray(jnp.asarray(v).astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


# ---------------------------------------------------------------------------
# the build seam and operand checks (no nvcc, no card needed)
# ---------------------------------------------------------------------------


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setattr(build.os.path, "exists", lambda _: False)
    monkeypatch.setattr(build, "BUILD_ROOT", ROOT / "build" / "absent")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()


def test_cached_build_brings_back_its_compiler_output(monkeypatch, tmp_path):
    """A library built earlier loads with the ptxas lines of its build, so
    a run that finds it cached can still print registers and spills."""
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path)
    out = tmp_path / build._digest()
    out.mkdir()
    (out / "libkernels.so").write_bytes(b"")
    (out / "build.log").write_text("ptxas info    : Used 128 registers")
    assert build.build() == out / "libkernels.so"
    assert build.LAST_BUILD["log"] == "ptxas info    : Used 128 registers"


def test_build_flags_target_hopper():
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert {"assign.cu", "kernel_matrix.cu"} <= {
        p.name for p in build.SRC_DIR.glob("*.cu")}
    assert len(build._digest()) == 16


@pytest.mark.parametrize("bad", ["device", "dtype", "shape", "contiguity",
                                 "alignment"])
def test_check_operand_rejects(bad):
    t = torch.zeros(8, 8)
    kw = dict(dtype=torch.float32, shape=(8, 8), device=torch.device("cpu"))
    if bad == "device":
        kw["device"] = torch.device("meta")
    elif bad == "dtype":
        t = t.to(torch.bfloat16)
    elif bad == "shape":
        kw["shape"] = (8, 4)
    elif bad == "contiguity":
        t = torch.zeros(8, 16)[:, ::2]
    else:
        t = torch.zeros(65)[1:].view(8, 8)
    with pytest.raises((ValueError, TypeError)):
        build.check_operand(t, "t", **kw)
    build.check_operand(torch.zeros(8, 8), "t", dtype=torch.float32,
                        shape=(8, 8), device=torch.device("cpu"))


def test_too_many_clusters_for_the_kernel_raise():
    """One launch takes at most 256 clusters (the wrapper chunks more);
    the launcher refuses a wider H before it builds or launches anything."""
    from repro_torch.kernels.assign import assign_fused_cuda
    x = torch.zeros(16, 8)
    for cp in (272, 8):
        with pytest.raises(ValueError, match="256 clusters"):
            assign_fused_cuda(x, x, torch.zeros(16, cp), torch.zeros(cp),
                              kind="rbf", gamma=1.0, coef0=1.0, degree=3)


def _kernel_stand_in(calls):
    """The launcher's contract on CPU tensors: check the chunk it is given,
    then answer with the plain version (what the kernel computes)."""
    from repro_torch.kernels.assign import CP_MULTIPLE, MAX_CP

    def launch(x, landmarks, h, g, *, kind, gamma, coef0, degree):
        cp = h.shape[1]
        assert cp % CP_MULTIPLE == 0 and 0 < cp <= MAX_CP
        assert g.shape == (cp,) and h.is_contiguous() and g.is_contiguous()
        calls.append(cp)
        prec = "bf16" if x.dtype == torch.bfloat16 else "f32"
        return ref.assign_fused_ref(x, landmarks, h, g, kind=kind,
                                    gamma=gamma, coef0=coef0, degree=degree,
                                    precision=prec)
    return launch


@pytest.mark.parametrize("n_clusters,chunks", [(10, [16]), (256, [256]),
                                               (600, [256, 256, 96])])
def test_cluster_chunks_merge_to_the_unchunked_result(monkeypatch, n_clusters,
                                                      chunks):
    """Past 256 clusters the wrapper launches once per chunk; labels, mind
    and f equal the one-pass plain version's."""
    calls = []
    monkeypatch.setattr(ops, "assign_fused_cuda", _kernel_stand_in(calls))
    x, landmarks, labels_l, counts, g = map(
        torch.from_numpy, _assign_inputs(200, 700, 12, n_clusters, seed=9))
    h, gm = ops.assign_panels(labels_l, counts, g, n_clusters)
    before = ops.LAUNCHES["assign_fused"]
    lab, mind, f = ops._launch_assign(x, landmarks, h, gm, kind="rbf",
                                      gamma=0.1, coef0=1.0, degree=3)
    assert calls == chunks
    assert ops.LAUNCHES["assign_fused"] == before + len(chunks)
    want_lab, want_min, want_f = ref.assign_fused_ref(x, landmarks, h, gm,
                                                      gamma=0.1)
    assert f.shape == (200, n_clusters)
    assert torch.equal(lab, want_lab)
    torch.testing.assert_close(mind, want_min, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(f, want_f, rtol=1e-6, atol=1e-6)


def test_cluster_chunk_ties_keep_the_lowest_index(monkeypatch):
    """Every chunk reaches the same minimum: the first chunk's label
    stands; a strictly smaller minimum in a later chunk takes over, with
    the chunk's offset added."""
    n, c = 6, 520
    answers = iter([
        (torch.full((n,), 3, dtype=torch.int32), torch.ones(n)),
        (torch.zeros(n, dtype=torch.int32), torch.ones(n)),
        (torch.full((n,), 1, dtype=torch.int32),
         torch.tensor([1.0, 0.5, 1.0, 0.5, 1.0, 1.0])),
    ])

    def launch(x, landmarks, h, g, **_):
        lab, mind = next(answers)
        return lab, mind, torch.zeros(n, h.shape[1])

    monkeypatch.setattr(ops, "assign_fused_cuda", launch)
    lab, mind, f = ops._launch_assign(
        torch.zeros(n, 4), torch.zeros(3, 4), torch.zeros(3, c),
        torch.zeros(c), kind="rbf", gamma=1.0, coef0=1.0, degree=3)
    assert lab.tolist() == [3, 513, 3, 513, 3, 3]
    assert mind.tolist() == [1.0, 0.5, 1.0, 0.5, 1.0, 1.0]
    assert f.shape == (n, c)


# ---------------------------------------------------------------------------
# launch geometry of the redesigned bodies (computed here, used on the card)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,tile", [(20, 20), (40, 40), (80, 80),
                                    (160, 160), (320, 160)])
def test_embed_f32_tile_keeps_padding_under_an_eighth(m, tile):
    """At every m of the Fig.5 sweep (benchmarks/fig5_approx_sweep.py)
    the f32 body's column tile wastes under 1/8 of the Gram work, and the
    widest such tile is taken."""
    from repro_torch.kernels.embed_assign import f32_geometry, padded_share
    bn, _ = f32_geometry(m)
    assert bn == tile and padded_share(m, bn) < 1 / 8


def test_embed_f32_row_block_fills_whole_waves():
    """At Fig.5's n = 60,000 the wide tiles' 80-row blocks make 750 CTAs,
    95% of three whole waves of 2 x 132; 128-row blocks would fill 89% of
    two. A tile wider than m falls back to the least padded one."""
    from repro_torch.kernels.embed_assign import f32_geometry
    slots = 2 * 132
    for m in (80, 160, 320):
        bm = f32_geometry(m)[1]
        ctas = -(-60000 // bm)
        assert ctas / (-(-ctas // slots) * slots) > 0.94
    assert f32_geometry(13) == (20, 128)


def test_embed_bf16_split_at_fig5():
    """The bf16 body splits the w axis as assign bf16 splits its
    landmarks: at Fig.5's 60,000 x 784 -> 320 (3 tiles of 128, two a split
    at least) one split, 469 CTAs; a wide map splits where the row blocks
    alone would not fill the card."""
    from repro_torch.kernels.assign import BF16, landmark_splits
    assert landmark_splits(60000, 320, 132, 2, BF16) == 1
    assert -(-60000 // BF16.bm) == 469
    assert landmark_splits(1000, 3000, 132, 2, BF16) > 1


@pytest.mark.parametrize("map_kind", ["rff", "rbf", "cosine"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_embed_assign_launch_passes_no_norms(monkeypatch, map_kind, dtype):
    """The launcher hands the kernel no row norms: rff its phases and no
    scratch, a Mercer kind no phases and a scratch of n + M that the launch
    sums |x|^2 and |w|^2 into. The bf16 body also gets the split count
    landmark_splits chooses for it and a scratch of [splits, n, Cp] (none
    for one split, whose argmin the kernel takes)."""
    from repro_torch.kernels import embed_assign as ea
    from repro_torch.kernels.assign import BF16, landmark_splits
    seen = []
    monkeypatch.setattr(build, "launch", lambda entry, *a: seen.append(
        (entry, a)))
    monkeypatch.setattr(ea, "_sm_count", lambda index: 132)
    monkeypatch.setattr(ea, "ctas_per_sm", lambda cp, kind, index: 2)
    n, d, cp = 1000, 8, 16
    for m, splits in ((700, 3), (320, 1)):
        assert landmark_splits(n, m, 132, 2, BF16) == splits
        b = torch.zeros(m) if map_kind == "rff" else None
        ea.embed_assign_cuda(torch.zeros(n, d, dtype=dtype),
                             torch.zeros(m, d, dtype=dtype), b,
                             torch.zeros(m, cp), torch.zeros(cp),
                             map_kind=map_kind, gamma=1.0, coef0=1.0,
                             degree=3, scale=1.0)
        entry, args = seen.pop()
        assert entry == ea._ENTRY[dtype]
        assert (args[2] == 0) == (map_kind != "rff")     # the phases
        assert (args[3] == 0) == (map_kind == "rff")     # the norm scratch
        if dtype == torch.float32:
            assert args[8:12] == (n, m, d, cp)
            assert args[-2:] == ea.f32_geometry(m)
        else:
            assert (args[8] == 0) == (splits == 1)       # the partial F
            assert args[9:14] == (n, m, d, cp, splits)
            assert args[14] == ea.MAP_KINDS[map_kind]


def test_embed_assign_launch_checks_its_phases():
    """rff needs its phases and a Mercer kind takes none."""
    from repro_torch.kernels import embed_assign as ea
    x, w, v = torch.zeros(4, 8), torch.zeros(3, 8), torch.zeros(3, 16)
    for map_kind, b in (("rff", None), ("rbf", torch.zeros(3))):
        with pytest.raises(ValueError, match="phases"):
            ea.embed_assign_cuda(x, w, b, v, torch.zeros(16),
                                 map_kind=map_kind, gamma=1.0, coef0=1.0,
                                 degree=3, scale=1.0)


def _bf16(*shape):
    return torch.zeros(*shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("case,want", [
    ("contiguous", (8 * 100 * 64, 100 * 64, 64)),
    ("heads-view", (100 * 8 * 64, 64, 8 * 64)),
    ("dh-slice", (100 * 8 * 72, 72, 8 * 72)),
    ("unit-batch", (100 * 8 * 64, 64, 8 * 64)),
    ("dh-strided", None), ("odd-stride", None), ("unaligned", None)])
def test_flash_tma_strides(case, want):
    """The (batch, head, row) element strides the bf16 body's tensor maps
    read a [B, H, S, dh] operand through, or None where TMA cannot."""
    from repro_torch.kernels.flash_attention import tma_strides
    t = {"contiguous": lambda: _bf16(2, 8, 100, 64),
         "heads-view": lambda: _bf16(2, 100, 8, 64).transpose(1, 2),
         "dh-slice": lambda: _bf16(2, 100, 8, 72)[..., :64].transpose(1, 2),
         "unit-batch": lambda: _bf16(1, 100, 8, 64).transpose(1, 2),
         "dh-strided": lambda: _bf16(2, 8, 100, 128)[..., ::2],
         "odd-stride": lambda: _bf16(2, 100, 8, 68)[..., :64].transpose(1, 2),
         "unaligned": lambda: _bf16(2 * 8 * 100 * 64 + 1)[1:].view(
             2, 8, 100, 64)}[case]()
    got = tma_strides(t)
    if case == "unit-batch":
        # a size-1 batch takes the tensor's span, valid whatever its stride
        assert got[1:] == want[1:] and got[0] == 100 * 8 * 64
    else:
        assert got == want


@pytest.mark.parametrize("case", ["heads-view", "odd-stride", "unaligned"])
def test_flash_bf16_launch_reads_views_in_place(monkeypatch, case):
    """The bf16 launcher hands the kernel the views of [B, S, H, dh]
    activations as they are, with their strides; a view TMA cannot read
    (a stride or base off 16 bytes) is copied once, contiguous. o is a
    [B, H, S, dh] view of [B, S, H, dh] memory. (The kernel itself runs on
    the card only.)"""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    seen = []
    monkeypatch.setattr(build, "launch", lambda entry, *a: seen.append(a))
    if case == "unaligned":
        q = _bf16(2 * 8 * 100 * 64 + 1)[1:].view(2, 8, 100, 64)
    else:
        width = 64 if case == "heads-view" else 68
        q = _bf16(2, 100, 8, width)[..., :64].transpose(1, 2)
    out = flash_attention_cuda(q, q, q, causal=True, softcap=None)
    args = seen[0]
    in_place = case == "heads-view"
    assert (args[0] == q.data_ptr()) == in_place
    want = (100 * 8 * 64, 64, 8 * 64)
    assert args[13:16] == (want if in_place else (8 * 100 * 64, 100 * 64, 64))
    assert args[-3:] == want and args[3] == out.data_ptr()
    assert out.shape == (2, 8, 100, 64) and out.transpose(1, 2).is_contiguous()


@pytest.mark.parametrize("case", ["heads-view", "dh-slice", "odd-stride",
                                  "unaligned"])
def test_flash_f32_launch_reads_views_in_place(monkeypatch, case):
    """The f32 launcher, like the bf16 one, hands the kernel the views of
    [B, S, H, dh] activations with their strides (16-byte rows: a multiple
    of 4 floats); a stride or base off 16 bytes is copied once, contiguous.
    o is a [B, H, S, dh] view of [B, S, H, dh] memory."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    seen = []
    monkeypatch.setattr(build, "launch", lambda entry, *a: seen.append(
        (entry, a)))
    if case == "unaligned":
        q = torch.zeros(2 * 8 * 100 * 64 + 1)[1:].view(2, 8, 100, 64)
    else:
        width = {"heads-view": 64, "dh-slice": 68, "odd-stride": 66}[case]
        q = torch.zeros(2, 100, 8, width)[..., :64].transpose(1, 2)
    out = flash_attention_cuda(q, q, q, causal=True, softcap=None)
    entry, args = seen[0]
    assert entry == "rt_flash_attention_f32"
    in_place = case in ("heads-view", "dh-slice")
    assert (args[0] == q.data_ptr()) == in_place
    width = {"heads-view": 64, "dh-slice": 68}.get(case)
    want = (100 * 8 * width, width, 8 * width) if in_place else \
        (8 * 100 * 64, 100 * 64, 64)
    assert args[13:16] == want
    assert args[-3:] == (100 * 8 * 64, 64, 8 * 64)
    assert args[3] == out.data_ptr()
    assert out.shape == (2, 8, 100, 64) and out.transpose(1, 2).is_contiguous()


# (rows, landmarks): the main path's three shapes (runs A, B and C, and the
# g stats at s = 0.2), one row, small and ragged landmark counts
SPLIT_SHAPES = [(15000, 15000), (15000, 3000), (3000, 3000), (1, 3000),
                (300, 130), (64, 32), (100, 64), (5000, 65), (15000, 1000),
                (200, 777)]
# each shape for the f32 body (ids as before) and for the bf16 body
SPLIT_CASES = ([(m, n, "f32") for m, n in SPLIT_SHAPES]
               + [(m, n, "bf16") for m, n in SPLIT_SHAPES])


@pytest.mark.parametrize("ctas_per_sm", [1, 2])
@pytest.mark.parametrize("sms", [132, 114, 8])
@pytest.mark.parametrize("m,n_landmarks,body", SPLIT_CASES,
                         ids=[("" if b == "f32" else "bf16-") + f"{m}x{n}"
                              for m, n, b in SPLIT_CASES])
def test_assign_f32_splits_cover_the_landmarks(m, n_landmarks, body, sms,
                                               ctas_per_sm):
    """The landmark ranges of a body's splits (the f32 body's tiles of 64,
    the bf16 body's of 128) cover [0, L) once, in whole tiles (the last
    one ragged), each at least the body's min_split_tiles tiles where there
    are several; L within one tile takes one split."""
    from repro_torch.kernels.assign import (BF16, F32, landmark_splits,
                                            split_ranges)
    geo = F32 if body == "f32" else BF16
    splits = landmark_splits(m, n_landmarks, sms, ctas_per_sm, geo)
    tiles = -(-n_landmarks // geo.bn)
    assert 1 <= splits <= max(1, tiles // geo.min_split_tiles)
    if n_landmarks <= geo.bn:
        assert splits == 1
    ranges = split_ranges(n_landmarks, splits, geo)
    assert len(ranges) == splits
    assert ranges[0][0] == 0 and ranges[-1][1] == n_landmarks
    for (_, hi), (lo, _) in zip(ranges, ranges[1:]):
        assert hi == lo                       # no gap, no overlap
    for lo, hi in ranges:
        assert lo % geo.bn == 0 and hi > lo
        assert hi % geo.bn == 0 or hi == n_landmarks
        if splits > 1:
            assert -(-(hi - lo) // geo.bn) >= geo.min_split_tiles


@pytest.mark.parametrize("m,n_landmarks,sms,ctas_per_sm,splits", [
    (15000, 15000, 132, 2, 11), (15000, 3000, 132, 2, 2),
    (3000, 3000, 132, 2, 10), (3000, 3000, 132, 1, 5), (1, 3000, 132, 2, 2),
    (15000, 1000, 132, 2, 2), (200, 777, 114, 1, 1),
    (15000, 15000, 114, 1, 14)])
def test_assign_f32_split_counts_stay_as_they_were(m, n_landmarks, sms,
                                                   ctas_per_sm, splits):
    """Generalising landmark_splits to a body's geometry leaves the f32
    body's answers as they were (the counts of the PR that split it)."""
    from repro_torch.kernels.assign import F32, landmark_splits
    assert landmark_splits(m, n_landmarks, sms, ctas_per_sm) == splits
    assert landmark_splits(m, n_landmarks, sms, ctas_per_sm, F32) == splits


def test_assign_f32_splits_fill_the_card_at_the_main_shapes():
    """On 132 SMs at two CTAs each (the card's occupancy at C = 10, which
    the card test test_assign_f32_occupancy checks), the g stats' 3000 x
    3000 call runs ten or more splits (24 row blocks alone would fill 9% of
    the slots), and every main shape's grid fills at least 80% of its
    waves."""
    from repro_torch.kernels.assign import F32, landmark_splits
    assert landmark_splits(3000, 3000, 132, 2) >= 10
    for m, n in [(15000, 15000), (15000, 3000), (3000, 3000)]:
        s = landmark_splits(m, n, 132, 2)
        rows, tiles = -(-m // F32.bm), -(-n // F32.bn)
        waves = -(-rows * s // 264)
        assert rows * tiles / (waves * 264 * -(-tiles // s)) >= 0.8


def test_assign_bf16_splits_fill_the_card_at_the_main_shapes():
    """On 132 SMs at two CTAs each (the bf16 body's occupancy at C = 10,
    test_assign_bf16_occupancy on the card), the g stats' 3000 x 3000 and
    run C's 15000 x 3000 launch at least 132 CTAs (24 and 118 row blocks
    alone would not), and run A's 15000 x 15000 fills 90% of its waves."""
    from repro_torch.kernels.assign import BF16, landmark_splits
    for m, n in [(3000, 3000), (15000, 3000), (15000, 15000)]:
        s = landmark_splits(m, n, 132, 2, BF16)
        rows, tiles = -(-m // BF16.bm), -(-n // BF16.bn)
        assert rows * s >= 132
        waves = -(-rows * s // 264)
        share = rows * tiles / (waves * 264 * -(-tiles // s))
        assert share >= (0.9 if n == 15000 else 0.7)


@pytest.mark.parametrize("n_landmarks", [64, 3000])
def test_assign_f32_launch_passes_splits_and_scratch(monkeypatch,
                                                     n_landmarks):
    """Both launchers pass the split count they chose for their body, a
    scratch of [splits, M, Cp] (f itself for one split) and no row norms
    (the launch computes them)."""
    from repro_torch.kernels import assign
    seen = []
    monkeypatch.setattr(build, "launch", lambda entry, *a: seen.append(
        (entry, a)))
    monkeypatch.setattr(assign, "_sm_count", lambda index: 132)
    monkeypatch.setattr(assign, "ctas_per_sm",
                        lambda dtype, cp, kind, index: 2)
    m, d, cp = 3000, 8, 16
    x, lm = torch.zeros(m, d), torch.zeros(n_landmarks, d)
    h, g = torch.zeros(n_landmarks, cp), torch.zeros(cp)
    for i, (dtype, geo) in enumerate([(torch.float32, assign.F32),
                                      (torch.bfloat16, assign.BF16)]):
        _, _, f = assign.assign_fused_cuda(x.to(dtype), lm.to(dtype), h, g,
                                           kind="rbf", gamma=1.0, coef0=1.0,
                                           degree=3)
        entry, args = seen[i]
        splits = assign.landmark_splits(m, n_landmarks, 132, 2, geo)
        assert entry == assign._ENTRY[dtype] and args[13] == splits
        assert args[7] == f.data_ptr()
        assert (args[8] == f.data_ptr()) == (splits == 1)
        assert (splits == 1) == (n_landmarks == 64)
        assert args[9:13] == (m, n_landmarks, d, cp)


# ---------------------------------------------------------------------------
# kernel_matrix: the route between the tile body and the column body
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,d,body", [
    (1, 784, "column"), (4, 784, "column"), (5, 128, "column"),
    (10, 784, "column"), (16, 320, "column"), (17, 784, "column"),
    (32, 784, "column"), (33, 784, "tile"), (320, 784, "tile"),
    (3000, 784, "tile"), (0, 784, "tile"), (16, 3631, "column"),
    (16, 3632, "tile"), (32, 1815, "column"), (32, 1816, "tile"),
    (1, 58111, "column"), (1, 58112, "tile")])
def test_kernel_matrix_route(n, d, body):
    """Y of at most NCOL_MAX rows takes the column body, wider Y the tile
    body, and so does a Y whose f32 copy (in the column body's width)
    would not fit in a block's shared memory."""
    from repro_torch.kernels import kernel_matrix as km
    assert km.NCOL_MAX == km.COL_WIDTHS[-1] == 32
    assert km.route(n, d) == body


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("n", [1, 4, 5, 10, 16, 32, 33, 40])
def test_kernel_matrix_launch_passes_norms_by_route(monkeypatch, n, prec):
    """ops.kernel_matrix computes no norms on either route: the column body
    sums |x|^2 and |y|^2 from its own loads (x read once), the tile body's
    launch sums them into a scratch of M + N it is handed, on a persistent
    grid of tile_ctas; the launches count the route."""
    from repro_torch.kernels import kernel_matrix as km
    seen = []
    monkeypatch.setattr(build, "launch", lambda entry, *a: seen.append(
        (entry, a)))
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    monkeypatch.setattr(km, "_sm_count", lambda index: 132)
    monkeypatch.setattr(km, "ctas_per_sm", lambda dtype, kind, index: 2)
    before = dict(ops.LAUNCHES)
    x, y = torch.randn(50, 16), torch.randn(n, 16)
    out = ops.kernel_matrix(x, y, kind="rbf", precision=prec)
    (entry, args), = seen
    dt = "bf16" if prec == "bf16" else "f32"
    column = n <= km.NCOL_MAX
    assert out.shape == (50, n)
    if column:
        assert entry == f"rt_kernel_matrix_col_{dt}"
        assert args[2:6] == (out.data_ptr(), 50, n, 16)
    else:
        assert entry == f"rt_kernel_matrix_{dt}"
        assert args[3:7] == (out.data_ptr(), 50, n, 16)
        dtype = torch.bfloat16 if prec == "bf16" else torch.float32
        assert args[7] == km.tile_ctas(50, n, dtype, 132, 2) == 1
    assert ops.LAUNCHES["kernel_matrix"] == before["kernel_matrix"] + 1
    assert (ops.LAUNCHES["kernel_matrix_column"]
            == before["kernel_matrix_column"] + column)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("m,n", [(15000, 3000), (320, 320), (1001, 130),
                                 (50, 33), (15000, 15000), (1, 40)])
def test_kernel_matrix_tile_grid_covers_the_tiles(m, n, dtype):
    """The tile body's persistent grid: at most one CTA a slot of the card
    and one a tile; the ranges [i T / G, (i + 1) T / G) cover the T tiles
    once, each CTA within one tile of every other's share."""
    from repro_torch.kernels.kernel_matrix import TILE, tile_ctas
    bm, bn = TILE[dtype]
    tiles = -(-m // bm) * -(-n // bn)
    ctas = tile_ctas(m, n, dtype, 132, 2)
    assert 1 <= ctas == min(tiles, 264)
    edges = [i * tiles // ctas for i in range(ctas + 1)]
    assert edges[0] == 0 and edges[-1] == tiles
    sizes = [hi - lo for lo, hi in zip(edges, edges[1:])]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1


def test_kernel_matrix_tile_grid_at_the_main_shapes():
    """The Gram build [15000 x 3000] fills all 264 slots of 132 SMs at two
    CTAs each, 21 tiles a CTA at f32 (128 x 64) and 10-11 at bf16 (128 x
    128); D-nystrom's K_LL [320 x 320] takes 15 and 9 CTAs, one tile each."""
    from repro_torch.kernels.kernel_matrix import TILE, tile_ctas
    assert TILE == {torch.float32: (128, 64), torch.bfloat16: (128, 128)}
    assert tile_ctas(15000, 3000, torch.float32, 132, 2) == 264
    assert 118 * 47 // 264 == 21
    assert tile_ctas(15000, 3000, torch.bfloat16, 132, 2) == 264
    assert tile_ctas(320, 320, torch.float32, 132, 2) == 15
    assert tile_ctas(320, 320, torch.bfloat16, 132, 2) == 9


# ---------------------------------------------------------------------------
# sketch_assign: the bucket chunk, the shared memory and the grid
# ---------------------------------------------------------------------------


def test_sketch_geometry_at_the_main_shape():
    """Tab.2's sketch (D = 256, m = 128, C = 50 padded to 64): every bucket
    in one chunk, so X is read once, and two CTAs an SM at either dtype."""
    from repro_torch.kernels import sketch_assign as sk
    for itemsize in (4, 2):
        mb, per_sm, staged = sk.geometry(256, 128, 64, itemsize)
        assert (mb, per_sm, staged) == (128, 2, True)
        nch = -(-256 // sk.chunk_features(itemsize))
        assert 2 * (sk.smem_bytes(256, nch, 128, 64, mb) + 1024) <= sk.SMEM_SM
    assert sk.chunk_features(4) == 128 and sk.chunk_features(2) == 256
    assert sk.grid(188000, 132, 2) == 264


@pytest.mark.parametrize("itemsize", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("d,m,cp", [(256, 128, 64), (16, 32, 16),
                                    (30, 77, 16), (520, 260, 144),
                                    (520, 77, 256), (24, 40, 16),
                                    (4000, 1000, 256), (3000, 77, 48)])
def test_sketch_geometry_fits_the_block(d, m, cp, itemsize):
    """The bucket chunk is a multiple of 8 and at most m rounded up to 8,
    its shared memory fits a block (two CTAs an SM where it says so), and a
    chunk below all m buckets takes the widest that fits one CTA. A staged
    program leaves the chunk and the CTAs an SM as the in-place one has."""
    from repro_torch.kernels import sketch_assign as sk
    mb, per_sm, staged = sk.geometry(d, m, cp, itemsize)
    nch = -(-d // sk.chunk_features(itemsize))
    assert mb % 8 == 0 and 8 <= mb <= -(-m // 8) * 8
    bytes_ = sk.smem_bytes(d, nch, m, cp, mb, staged=staged)
    assert bytes_ <= sk.SMEM_BLOCK
    assert per_sm in (1, 2)
    assert (2 * (bytes_ + 1024) <= sk.SMEM_SM) == (per_sm == 2)
    if mb < m:
        assert sk.smem_bytes(d, nch, m, cp, mb + 8,
                             staged=staged) > sk.SMEM_BLOCK
    if staged:
        in_place = sk.smem_bytes(d, nch, m, cp, mb, staged=False)
        assert (2 * (in_place + 1024) <= sk.SMEM_SM) == (per_sm == 2)


def test_sketch_geometry_smem_counts_each_buffer():
    """smem_bytes mirrors sk::smem_bytes of csrc/sketch_assign.cu: the
    3-stage ring of 32 rows of 528 bytes, zT [mb][40], V [mb][Cp rounded to
    32, + 8], the program (8 bytes an entry), its positions [nch][m rounded
    to 8, + 8] where it is staged, and the argmin's slots."""
    from repro_torch.kernels import sketch_assign as sk
    ring = 3 * 32 * 528
    assert sk.smem_bytes(47236, 370, 256, 64, 256, staged=False) == (
        ring + 4 * (256 * 40 + 256 * 72) + 8 * 32 * 4)
    assert sk.mpos(128) == 136 and sk.mpos(77) == 88
    assert sk.smem_bytes(256, 2, 128, 64, 128) == (
        ring + 4 * (128 * 40 + 128 * 72) + 8 * 256 + 4 * 272 + 8 * 32 * 4)
    assert sk.smem_bytes(29, 1, 77, 16, 80) == (
        ring + 4 * (80 * 40 + 80 * 40) + 8 * 30 + 4 * 88 + 8 * 32 * 4)


def test_sketch_geometry_raises_when_the_program_fills_the_block():
    """A program that would fill the block is read in place, not staged:
    the launch keeps every bucket in one chunk and two CTAs an SM, and
    nothing raises."""
    from repro_torch.kernels import sketch_assign as sk
    nch = -(-30000 // sk.chunk_features(4))
    assert sk.smem_bytes(30000, nch, 128, 64, 8) > sk.SMEM_BLOCK
    assert sk.geometry(30000, 128, 64, 4) == (128, 2, False)


@pytest.mark.parametrize("n,sms,per_sm,want", [
    (188000, 132, 2, 264), (300, 132, 2, 10), (64, 132, 1, 2), (1, 132, 2, 1),
    (188000, 114, 1, 114)])
def test_sketch_grid_is_the_card_or_the_row_blocks(n, sms, per_sm, want):
    from repro_torch.kernels import sketch_assign as sk
    assert sk.grid(n, sms, per_sm) == want


def _emulate_gather(x, program, positions, m, kd, mb):
    """The kernel's gather (csrc/sketch_assign.cu ``gather``) in numpy f32,
    all rows at once: z [n, m] after every column chunk of every bucket
    chunk, warp by warp."""
    from repro_torch.kernels import sketch_assign as sk
    prog, pos = program.numpy(), positions.numpy()
    n = x.shape[0]
    mr = sk.mpos(m) - sk.WARPS
    z = np.zeros((n, m), np.float32)
    for jb in range(0, m, mb):
        for c in range(pos.shape[0]):
            if c == 0:
                z[:, jb:jb + mb] = 0.0
            for w in range(sk.WARPS):
                acc = None
                for k in range(pos[c, jb + w], pos[c, min(jb + mb, mr) + w]):
                    ex, ey = int(prog[k, 0]), int(prog[k, 1])
                    j = ey & (sk.LAST - 1)
                    assert j % sk.WARPS == w and jb <= j < jb + mb
                    if ey & sk.FIRST:
                        acc = z[:, j].copy()
                    col = (ex & 0x7fffffff) + c * kd
                    acc = (acc + np.float32(-1.0 if ex < 0 else 1.0)
                           * x[:, col]).astype(np.float32)
                    if ey & sk.LAST:
                        z[:, j] = acc
    return z


@pytest.mark.parametrize("d,m,kd,mb", [(256, 128, 128, 128), (256, 128, 256, 128),
                                       (130, 77, 32, 40), (520, 260, 128, 208),
                                       (20, 77, 128, 80)])
def test_sketch_gather_program_sums_each_bucket_in_column_order(d, m, kd, mb):
    """The gather program, walked as the kernel walks it (per bucket chunk,
    column chunk and warp), gives z bitwise equal to the fixed-order chain
    sum over each bucket's columns in increasing index (the parent
    kernel's), columns with h = -1 dropped; every column with h >= 0 is
    read once."""
    from repro_torch.kernels import sketch_assign as sk
    rng = np.random.default_rng(11)
    h = rng.integers(0, m, d).astype(np.int32)
    h[rng.random(d) < 0.1] = -1
    sign = rng.choice([-1.0, 1.0], d).astype(np.float32)
    x = (rng.normal(size=(17, d)) * 10).astype(np.float32)
    order, offsets, ssign = sk.bucket_tables(torch.from_numpy(h),
                                             torch.from_numpy(sign), m)
    program, positions = sk.gather_program(order, offsets, ssign, m, kd)
    assert program.dtype == positions.dtype == torch.int32
    assert program.shape == (int((h >= 0).sum()), 2)
    assert positions.shape == (-(-d // kd), sk.mpos(m))
    got = _emulate_gather(x, program, positions, m, kd, mb)
    want = np.zeros((17, m), np.float32)
    for j in range(m):
        for col in np.flatnonzero(h == j):       # increasing column order
            want[:, j] = (want[:, j] + sign[col] * x[:, col]).astype(
                np.float32)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("d", [256, 30])
def test_sketch_launch_passes_padded_rows_and_geometry(monkeypatch, prec, d):
    """ops.sketch_assign pads D to the 16-byte vector (zero columns no
    program entry names) and hands the kernel the gather program of its
    chunk width, the row stride, the bucket chunk and the grid of
    ``geometry`` and ``grid``; the program is built once per map."""
    from repro_torch.approx import make_count_sketch
    from repro_torch.core import KernelSpec
    from repro_torch.kernels import kernel_matrix as km
    from repro_torch.kernels import sketch_assign as sk
    seen = []
    monkeypatch.setattr(build, "launch", lambda entry, *a: seen.append(
        (entry, a)))
    monkeypatch.setattr(km, "_sm_count", lambda index: 132)
    monkeypatch.setattr(sk, "_sm_count", lambda index: 132)
    fmap = make_count_sketch(torch.Generator().manual_seed(0), d, 77,
                             KernelSpec("linear"), device="cpu")
    x, cents = torch.randn(300, d), torch.randn(13, 77)
    built = []
    real = sk.gather_program
    monkeypatch.setattr(sk, "gather_program", lambda *a: built.append(a[-1])
                        or real(*a))
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    for _ in range(2):
        ops.sketch_assign(x, fmap, cents, precision=prec)
    (entry, args), _ = seen
    dt = "bf16" if prec == "bf16" else "f32"
    item = 2 if prec == "bf16" else 4
    dp = -(-d // (16 // item)) * (16 // item)
    mb, per_sm, staged = sk.geometry(d, 77, 16, item)
    assert entry == f"rt_sketch_assign_{dt}"
    assert built == [sk.chunk_features(item)]
    assert args[7:15] == (300, d, dp, 77, 16, mb, sk.grid(300, 132, per_sm),
                          int(staged))


# ---------------------------------------------------------------------------
# hygiene: the port stands alone and never falls back to the CPU quietly
# ---------------------------------------------------------------------------


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, name)


def test_import_leaves_jax_and_triton_out(tmp_path):
    """A fresh interpreter imports every module of the port with no nvcc on
    PATH and triton blocked, and jax never enters sys.modules."""
    mods = sorted(
        "repro_torch." + ".".join(p.relative_to(ROOT / "src" / "repro_torch")
                                  .with_suffix("").parts)
        for p in (ROOT / "src" / "repro_torch").rglob("*.py")
        if p.name != "__init__.py")
    code = ("import sys, importlib\n"
            "sys.modules['triton'] = None\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "import repro_torch\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "assert not any(m == 'repro' or m.startswith('repro.') "
            "for m in sys.modules), 'repro imported'\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), PATH=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_entry_point_without_device_raises_here():
    from repro_torch.core import KernelSpec, MiniBatchConfig, fit_dataset
    from repro_torch.core.minibatch import predict
    from repro_torch.device import resolve_device
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs there")
    x = np.zeros((20, 2), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fit_dataset(x, MiniBatchConfig(n_clusters=2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        predict(x, torch.zeros(2, 2), torch.ones(2), spec=KernelSpec())
    assert resolve_device("cpu") == torch.device("cpu")
