"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs a CUDA device and nvcc, is marked ``gpu`` and skips
without them. This file imports no JAX (the GPU machine has none); run it
there with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Tolerances: 1e-5 for ``kernel_matrix``, 1e-4 for f and mind, at f32 and
bf16 alike: kernel and plain version get the same bf16-rounded operands and
both sum in f32, so only the order of the sums differs. rbf runs at
gamma = 1/D, where its values spread over (0, 1).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import KernelSpec, MiniBatchConfig, fit_dataset
from repro_torch.data.synthetic import toy2d
from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.gpu

KINDS = ["rbf", "linear", "polynomial", "cosine"]
SHAPES = [(8, 8, 4), (100, 77, 30), (256, 256, 128), (300, 520, 129)]
ASSIGN_SHAPES = [(64, 32, 16), (300, 130, 40)]
PRECS = ["f32", "bf16"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run with -m gpu on the GPU)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tol(tol):
    return dict(rtol=tol, atol=tol)


def _gamma(kind, d):
    return 1.0 / d if kind == "rbf" else 0.05


def _rand(shape, seed, dev):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_matrix_matches_plain(cuda, kind, shape, prec):
    m, n, d = shape
    x, y = _rand((m, d), 0, cuda), _rand((n, d), 1, cuda)
    gamma = _gamma(kind, d)
    before = ops.LAUNCHES["kernel_matrix"]
    got = ops.kernel_matrix(x, y, kind=kind, gamma=gamma, precision=prec)
    assert ops.LAUNCHES["kernel_matrix"] == before + 1
    want = ref.kernel_matrix_ref(x, y, kind=kind, gamma=gamma, precision=prec)
    assert got.shape == (m, n) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, **_tol(1e-5))


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("n_clusters", [3, 7, 130, 300])
@pytest.mark.parametrize("shape", ASSIGN_SHAPES, ids=["small", "ragged"])
@pytest.mark.parametrize("kind", KINDS)
def test_assign_fused_matches_plain(cuda, kind, shape, n_clusters, prec):
    m, lm, d = shape
    rng = np.random.default_rng(2)
    x, landmarks = _rand((m, d), 3, cuda), _rand((lm, d), 4, cuda)
    labels_l = torch.from_numpy(
        rng.integers(0, n_clusters, lm).astype(np.int32)).to(cuda)
    counts = torch.bincount(labels_l.long(), minlength=n_clusters).float()
    g = torch.from_numpy(rng.random(n_clusters).astype(np.float32)).to(cuda)
    gamma = _gamma(kind, d)
    before = ops.LAUNCHES["assign_fused"]
    lab, mind, f = ops.assign_fused(x, landmarks, labels_l, counts, g,
                                    n_clusters=n_clusters, kind=kind,
                                    gamma=gamma, precision=prec)
    # one launch per 256 clusters
    assert ops.LAUNCHES["assign_fused"] == before + -(-n_clusters // 256)
    h, gm = ops.assign_panels(labels_l, counts, g, n_clusters)
    want_lab, want_min, want_f = ref.assign_fused_ref(
        x, landmarks, h, gm, kind=kind, gamma=gamma, precision=prec)
    assert f.shape == (m, n_clusters)
    torch.testing.assert_close(f, want_f, **_tol(1e-4))
    torch.testing.assert_close(mind, want_min, **_tol(1e-4))
    assert torch.equal(lab, want_lab)


def test_gram_matvec_matches_plain(cuda):
    x, landmarks = _rand((300, 40), 5, cuda), _rand((130, 40), 6, cuda)
    h = torch.rand(130, 5, device=cuda)
    got = ops.gram_matvec(x, landmarks, h, kind="rbf", gamma=1 / 40)
    want = ref.kernel_matrix_ref(x, landmarks, kind="rbf", gamma=1 / 40) @ h
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_wrappers_take_strided_and_unaligned_operands(cuda):
    """A column slice (not contiguous) and a row slice starting off a
    16-byte boundary are copied by the wrapper, never passed raw."""
    base = _rand((64, 33), 7, cuda)
    x = base[:, :32]
    y = base.flatten()[1:1 + 20 * 32].view(20, 32)
    got = ops.kernel_matrix(x, y, kind="linear")
    torch.testing.assert_close(got, x @ y.T, rtol=1e-5, atol=1e-5)


def test_cluster_chunks_keep_the_lowest_index_on_the_card(cuda):
    """600 clusters in three launches; a tie across two chunks (clusters 5
    and 261 hold the same landmarks) goes to cluster 5."""
    x, a = _rand((300, 40), 8, cuda), _rand((64, 40), 9, cuda)
    c = 600
    labels_l = torch.cat([torch.full((64,), 5), torch.full((64,), 261),
                          torch.arange(64) % 40 + 300]).int().to(cuda)
    landmarks = torch.cat([a, a, _rand((64, 40), 10, cuda)])
    counts = torch.bincount(labels_l.long(), minlength=c).float()
    g = torch.full((c,), -5.0, device=cuda)
    g[300:] = 5.0
    before = ops.LAUNCHES["assign_fused"]
    lab, mind, f = ops.assign_fused(x, landmarks, labels_l, counts, g,
                                    n_clusters=c, gamma=1 / 40)
    assert ops.LAUNCHES["assign_fused"] == before + 3
    assert torch.equal(f[:, 5], f[:, 261])
    assert int(lab.min()) == 5 and int(lab.max()) == 5
    h, gm = ops.assign_panels(labels_l, counts, g, c)
    want_lab, want_min, want_f = ref.assign_fused_ref(x, landmarks, h, gm,
                                                      gamma=1 / 40)
    torch.testing.assert_close(mind, want_min, **_tol(1e-4))
    torch.testing.assert_close(f, want_f, **_tol(1e-4))


@pytest.mark.parametrize("engine", ["fused", "materialize", "tiled"])
def test_small_fit_on_the_card_matches_the_cpu(cuda, engine):
    """Same seed, same landmark draws (a CPU generator): the fit on the
    card lands where the plain fit on the CPU lands."""
    x, _ = toy2d(300)
    cfg = MiniBatchConfig(n_clusters=4, n_batches=3, s=0.5, engine=engine,
                          kernel=KernelSpec("rbf", gamma=4.0))
    gpu = fit_dataset(x, cfg)
    cpu = fit_dataset(x, cfg, device="cpu")
    assert gpu.state.medoids.is_cuda
    agree = (gpu.predict(x).cpu() == cpu.predict(x)).float().mean()
    assert float(agree) >= 0.99
