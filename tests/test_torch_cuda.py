"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs a CUDA device and nvcc, is marked ``gpu`` and skips
without them. This file imports no JAX (the GPU machine has none); run it
there with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Tolerances: 1e-5 for ``kernel_matrix``, 1e-4 for f, mind and the
embedded scores, at f32 and bf16 alike: kernel and plain version get the
same bf16-rounded operands and both sum in f32, so only the order of the
sums differs. rbf runs at gamma = 1/D, where its values spread over (0, 1).
Embedded labels must equal the plain version's outside its near-ties.
``flash_attention``: 2e-5 at f32 (the JAX test's own limit) and 1e-2 at
bf16, where the kernel rounds P to bf16 for the P.V product and both
versions round the output to bf16. Assignment serving: a CUDA-graph replay
must equal an eager launch of the same bucket bitwise. Sparse rows: the
O(nnz) sketch (a stable sort and a segment sum, no atomics) must repeat
bitwise on the card, also under ``torch.use_deterministic_algorithms``, and
agree with the CPU's within 1e-6 normwise; batches staged through pinned
memory and the copy stream must equal their host rows after kernels ran on
them.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.approx import make_count_sketch, make_nystrom, make_rff
from repro_torch.configs import get_arch
from repro_torch.core import KernelSpec, MiniBatchConfig, fit_dataset
from repro_torch.data import sparse as tsp
from repro_torch.data.loader import BatchSource
from repro_torch.data.synthetic import make_rcv1_sparse, toy2d
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.embed_assign import f32_geometry
from repro_torch.kernels.precision import resolve_precision
from repro_torch.models import get_model
from repro_torch.approx import selectors
from repro_torch.approx.sketch import make_tensor_sketch
from repro_torch.serving import (AssignServeConfig, AssignService, ServeConfig,
                                 ServingEngine, freeze, freeze_map)
from repro_torch.serving.assign import run_bucket

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


def _assign_case(m, lm, d, n_clusters, seed, dev):
    rng = np.random.default_rng(seed)
    x, landmarks = _rand((m, d), seed + 1, dev), _rand((lm, d), seed + 2, dev)
    labels_l = torch.from_numpy(
        rng.integers(0, n_clusters, lm).astype(np.int32)).to(dev)
    counts = torch.bincount(labels_l.long(), minlength=n_clusters).float()
    g = torch.from_numpy(rng.random(n_clusters).astype(np.float32)).to(dev)
    return x, landmarks, labels_l, counts, g


def _labels_outside_near_ties(lab, want_lab, dist):
    """Labels equal wherever the plain version's top-2 gap is at least 1e-4
    of max(1, |min|) (chip_smoke.py's near-tie rule)."""
    top2 = torch.topk(dist, 2, dim=1, largest=False).values
    near = top2[:, 1] - top2[:, 0] <= 1e-4 * top2[:, 0].abs().clamp(min=1.0)
    return bool(((lab == want_lab) | near).all())


# (rows, landmarks, D) of the f32 body's split grid: one row, the main
# path's 3,000 and 15,000 rows over 3,000 landmarks (47 tiles: no multiple
# of the split count), L past no tile boundary, L within one tile
SPLIT_SHAPES = [(1, 3000, 784), (3000, 3000, 784), (15000, 3000, 784),
                (500, 777, 40), (200, 40, 40)]


@pytest.mark.parametrize("n_clusters", [3, 10, 130])
@pytest.mark.parametrize("shape", SPLIT_SHAPES,
                         ids=["x".join(map(str, s)) for s in SPLIT_SHAPES])
@pytest.mark.parametrize("kind", KINDS)
def test_assign_fused_f32_split_matches_plain(cuda, kind, shape, n_clusters):
    m, lm, d = shape
    x, landmarks, labels_l, counts, g = _assign_case(m, lm, d, n_clusters, 40,
                                                     cuda)
    gamma = _gamma(kind, d)
    lab, mind, f = ops.assign_fused(x, landmarks, labels_l, counts, g,
                                    n_clusters=n_clusters, kind=kind,
                                    gamma=gamma)
    h, gm = ops.assign_panels(labels_l, counts, g, n_clusters)
    want_lab, want_min, want_f = ref.assign_fused_ref(
        x, landmarks, h, gm, kind=kind, gamma=gamma)
    assert f.shape == (m, n_clusters)
    torch.testing.assert_close(f, want_f, **_tol(1e-4))
    torch.testing.assert_close(mind, want_min, **_tol(1e-4))
    assert _labels_outside_near_ties(lab, want_lab, gm[None] - 2.0 * want_f)


def test_assign_fused_f32_split_at_run_a(cuda):
    """Run A's shape: 15,000 rows against 15,000 landmarks, C = 10, and 300
    clusters (two launches) on a slice of it."""
    x, landmarks, labels_l, counts, g = _assign_case(15000, 15000, 784, 10,
                                                     41, cuda)
    lab, mind, f = ops.assign_fused(x, landmarks, labels_l, counts, g,
                                    n_clusters=10, gamma=1 / 784)
    h, gm = ops.assign_panels(labels_l, counts, g, 10)
    want_lab, want_min, want_f = ref.assign_fused_ref(x, landmarks, h, gm,
                                                      gamma=1 / 784)
    torch.testing.assert_close(f, want_f, **_tol(1e-4))
    torch.testing.assert_close(mind, want_min, **_tol(1e-4))
    assert _labels_outside_near_ties(lab, want_lab, gm[None] - 2.0 * want_f)
    x, landmarks, labels_l, counts, g = _assign_case(2000, 3000, 784, 300, 42,
                                                     cuda)
    before = ops.LAUNCHES["assign_fused"]
    lab, mind, f = ops.assign_fused(x, landmarks, labels_l, counts, g,
                                    n_clusters=300, gamma=1 / 784)
    assert ops.LAUNCHES["assign_fused"] == before + 2
    h, gm = ops.assign_panels(labels_l, counts, g, 300)
    want_lab, want_min, want_f = ref.assign_fused_ref(x, landmarks, h, gm,
                                                      gamma=1 / 784)
    torch.testing.assert_close(f, want_f, **_tol(1e-4))
    torch.testing.assert_close(mind, want_min, **_tol(1e-4))
    assert _labels_outside_near_ties(lab, want_lab, gm[None] - 2.0 * want_f)


@pytest.mark.parametrize("prec", PRECS)
def test_gram_matvec_at_the_g_stats_shape(cuda, prec):
    """K(L, L) @ H at |L| = 3,000 x 784, C = 10: the g stats of runs B and
    C, normwise (H is a plain one-hot: sums of up to |L| values)."""
    lm = _rand((3000, 784), 43, cuda)
    labels = torch.from_numpy(
        np.random.default_rng(43).integers(0, 10, 3000)).to(cuda)
    h = torch.nn.functional.one_hot(labels, 10).float()
    got = ops.gram_matvec(lm, lm, h, kind="rbf", gamma=1 / 784,
                          precision=prec)
    want = ref.kernel_matrix_ref(lm, lm, kind="rbf", gamma=1 / 784,
                                 precision=prec) @ h
    err = float((got - want).abs().max()) / max(1.0, float(want.abs().max()))
    assert err <= 1e-4


@pytest.mark.parametrize("kind", KINDS)
def test_assign_f32_occupancy(cuda, kind):
    """The library reports what the split choice assumes: two CTAs of the
    f32 body share an SM at C = 10 (Cp 16), one at 256 clusters."""
    from repro_torch.kernels.assign import ctas_per_sm
    index = torch.cuda.current_device()
    assert ctas_per_sm(torch.float32, 16, kind, index) == 2
    assert ctas_per_sm(torch.float32, 256, kind, index) == 1


@pytest.mark.parametrize("kind", KINDS)
def test_assign_bf16_occupancy(cuda, kind):
    """Two CTAs of the bf16 body (two warpgroups each, at most 128
    registers a thread) share an SM at C = 10, one at 256 clusters (its f
    accumulator takes 128 KB of shared memory)."""
    from repro_torch.kernels.assign import ctas_per_sm
    index = torch.cuda.current_device()
    assert ctas_per_sm(torch.bfloat16, 16, kind, index) == 2
    assert ctas_per_sm(torch.bfloat16, 256, kind, index) == 1


# (rows, landmarks, D) of the bf16 body's split grid: one row, the g stats'
# 3,000 x 3,000 and run C's 15,000 x 3,000 (24 tiles of 128), L past no
# tile boundary, L within one tile, D past no 64-feature chunk, D within one
BF16_SPLIT_SHAPES = [(1, 3000, 784), (3000, 3000, 784), (15000, 3000, 784),
                     (500, 777, 40), (200, 40, 40), (300, 1000, 136)]


@pytest.mark.parametrize("n_clusters", [3, 10, 130])
@pytest.mark.parametrize("shape", BF16_SPLIT_SHAPES,
                         ids=["x".join(map(str, s)) for s in BF16_SPLIT_SHAPES])
@pytest.mark.parametrize("kind", KINDS)
def test_assign_fused_bf16_split_matches_plain(cuda, kind, shape, n_clusters):
    m, lm, d = shape
    x, landmarks, labels_l, counts, g = _assign_case(m, lm, d, n_clusters, 45,
                                                     cuda)
    gamma = _gamma(kind, d)
    lab, mind, f = ops.assign_fused(x, landmarks, labels_l, counts, g,
                                    n_clusters=n_clusters, kind=kind,
                                    gamma=gamma, precision="bf16")
    h, gm = ops.assign_panels(labels_l, counts, g, n_clusters)
    want_lab, want_min, want_f = ref.assign_fused_ref(
        x, landmarks, h, gm, kind=kind, gamma=gamma, precision="bf16")
    assert f.shape == (m, n_clusters)
    torch.testing.assert_close(f, want_f, **_tol(1e-4))
    torch.testing.assert_close(mind, want_min, **_tol(1e-4))
    assert _labels_outside_near_ties(lab, want_lab, gm[None] - 2.0 * want_f)


@pytest.mark.parametrize("shape", [(3000, 3000, 784), (15000, 3000, 784),
                                   (500, 777, 40)],
                         ids=["3000x3000", "15000x3000", "500x777"])
def test_assign_fused_bf16_is_bitwise_repeatable(cuda, shape):
    """The bf16 body's splits are summed in the same fixed order: two
    launches give the same bits, as ops.gram_matvec (the g stats) too."""
    m, lm, d = shape
    x, landmarks, labels_l, counts, g = _assign_case(m, lm, d, 10, 46, cuda)
    a, b = (ops.assign_fused(x, landmarks, labels_l, counts, g, n_clusters=10,
                             gamma=1 / d, precision="bf16") for _ in range(2))
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    h = torch.nn.functional.one_hot(labels_l.long(), 10).float()
    a, b = (ops.gram_matvec(landmarks, landmarks, h, gamma=1 / d,
                            precision="bf16") for _ in range(2))
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# kernel_matrix's column body (skinny Y: k-means++ columns, Eq.8 blocks)
# ---------------------------------------------------------------------------

def _column_widths():
    from repro_torch.kernels.kernel_matrix import NCOL_MAX
    return [1, 4, 5, 10, NCOL_MAX, NCOL_MAX + 1]


def _assert_normwise(got, want, tol=1e-5):
    """max |got - want| <= tol * max(1, max |want|) (chip_smoke.py's rule:
    at D = 784 a dot product near 0 carries the rounding of terms near 1)."""
    err = float((got - want).abs().max())
    assert err <= tol * max(1.0, float(want.abs().max())), err


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("d", [784, 130, 5])
@pytest.mark.parametrize("col", range(6), ids=["1", "4", "5", "10", "ncol_max",
                                               "ncol_max+1"])
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_matrix_column_body_matches_plain(cuda, kind, col, d, prec):
    """N = 1, 4, 5, 10 and NCOL_MAX take the column body, NCOL_MAX + 1 the
    tile body; 1,001 rows leave a ragged row group, D = 130 and 5 a ragged
    vector (padded by the wrapper)."""
    from repro_torch.kernels.kernel_matrix import NCOL_MAX
    n = _column_widths()[col]
    x, y = _rand((1001, d), 50, cuda), _rand((n, d), 51, cuda)
    gamma = _gamma(kind, d)
    before = dict(ops.LAUNCHES)
    got = ops.kernel_matrix(x, y, kind=kind, gamma=gamma, precision=prec)
    assert ops.LAUNCHES["kernel_matrix"] == before["kernel_matrix"] + 1
    assert (ops.LAUNCHES["kernel_matrix_column"]
            == before["kernel_matrix_column"] + (n <= NCOL_MAX))
    want = ref.kernel_matrix_ref(x, y, kind=kind, gamma=gamma, precision=prec)
    assert got.shape == (1001, n) and got.dtype == torch.float32
    _assert_normwise(got, want)


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("n", [2, 8, 17, 32])
def test_kernel_matrix_column_body_forced_to_its_widest(cuda, n, prec):
    """The column body, called with body="column" as the sweep that chose
    NCOL_MAX calls it, at widths between its instantiations and at its
    widest."""
    from repro_torch.kernels.kernel_matrix import kernel_matrix_cuda
    p = resolve_precision(prec)
    x = p.cast_tiles(_rand((3000, 320), 52, cuda))
    y = p.cast_tiles(_rand((n, 320), 53, cuda))
    got = kernel_matrix_cuda(x, y, kind="rbf", gamma=1 / 320, coef0=1.0,
                             degree=3, body="column")
    want = ref.kernel_matrix_ref(x, y, kind="rbf", gamma=1 / 320,
                                 precision=prec)
    _assert_normwise(got, want)


@pytest.mark.parametrize("prec", PRECS)
def test_kernel_matrix_column_body_at_the_run_shapes(cuda, prec):
    """The k-means++ columns and Eq.8 blocks at the runs' sizes: [15000, 1
    | 4 | 10] x 784, [60000, 4] x 320, [47000, 5] x 128; rbf K(x, x) is 1
    on the diagonal of the first rows."""
    for m, n, d in [(15000, 1, 784), (15000, 4, 784), (15000, 10, 784),
                    (60000, 4, 320), (47000, 5, 128)]:
        x = _rand((m, d), 54, cuda)
        for kind in ("rbf", "linear"):
            gamma = _gamma(kind, d)
            got = ops.kernel_matrix(x, x[:n], kind=kind, gamma=gamma,
                                    precision=prec)
            want = ref.kernel_matrix_ref(x, x[:n], kind=kind, gamma=gamma,
                                         precision=prec)
            _assert_normwise(got, want)
            if kind == "rbf":
                diag = torch.diagonal(got[:n])
                assert float((diag - 1).abs().max()) <= 1e-5


def test_column_route_takes_strided_and_unaligned_operands(cuda):
    """On the column route as on the tile route, a column slice and a row
    slice off a 16-byte boundary are copied by the wrapper."""
    base = _rand((64, 33), 55, cuda)
    x = base[:, :32]
    y = base.flatten()[1:1 + 4 * 32].view(4, 32)
    before = ops.LAUNCHES["kernel_matrix_column"]
    got = ops.kernel_matrix(x, y, kind="linear")
    assert ops.LAUNCHES["kernel_matrix_column"] == before + 1
    torch.testing.assert_close(got, x @ y.T, rtol=1e-5, atol=1e-5)
    got = ops.kernel_matrix(y, x[:3], kind="rbf", gamma=1 / 32)
    want = ref.kernel_matrix_ref(y, x[:3], kind="rbf", gamma=1 / 32)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# kernel_matrix's tile bodies (wide Y: the Gram builds)
# ---------------------------------------------------------------------------

# (M, N, D): M and N off the 128-row tile and the 64-column (f32) and
# 128-column (bf16) tiles, N = NCOL_MAX + 1 (the narrowest Y the tile route
# takes), N a multiple of 4 (16-byte stores) and not (4-byte stores), D off
# the rings' chunks (32 features at f32, 64 at bf16) and off the bf16
# vector (padded by the wrapper), more tiles than the card has CTAs, and
# D-nystrom's K_LL
TILE_SHAPES = [(1001, 130, 100), (1001, 33, 784), (257, 65, 36),
               (1001, 200, 40), (130, 1001, 5), (2000, 3000, 72),
               (320, 320, 784)]


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("shape", TILE_SHAPES,
                         ids=["x".join(map(str, s)) for s in TILE_SHAPES])
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_matrix_tile_body_at_ragged_edges(cuda, kind, shape, prec):
    m, n, d = shape
    x, y = _rand((m, d), 60, cuda), _rand((n, d), 61, cuda)
    gamma = _gamma(kind, d)
    before = dict(ops.LAUNCHES)
    got = ops.kernel_matrix(x, y, kind=kind, gamma=gamma, precision=prec)
    assert ops.LAUNCHES["kernel_matrix"] == before["kernel_matrix"] + 1
    assert (ops.LAUNCHES["kernel_matrix_column"]
            == before["kernel_matrix_column"])
    want = ref.kernel_matrix_ref(x, y, kind=kind, gamma=gamma, precision=prec)
    assert got.shape == (m, n) and got.dtype == torch.float32
    _assert_normwise(got, want)


def _offset_rows(m, d, ratio, seed, dev):
    """Rows c + noise whose squared norm is `ratio` times the median
    squared distance between them, and gamma = 1 / that median."""
    rng = np.random.default_rng(seed)
    noise = rng.normal(size=(m, d))
    spread = 2.0 * d                     # E |n_i - n_j|^2 of unit noise
    c = rng.normal(size=d)
    c *= np.sqrt(ratio * spread) / np.linalg.norm(c)
    x = torch.from_numpy((c + noise).astype(np.float32)).to(dev)
    return x, 1.0 / spread


@pytest.mark.parametrize("prec,ratio", [("f32", 0.0), ("f32", 10.0),
                                        ("f32", 30.0), ("bf16", 0.0),
                                        ("bf16", 1.0)])
def test_kernel_matrix_tile_rbf_diagonal_at_large_norms(cuda, prec, ratio):
    """K(x, x)'s diagonal on the tile body, for rows whose squared norms
    are `ratio` times their spread 1 / gamma, where |x|^2 + |x|^2 - 2 x.x
    cancels terms of 2 ratio / gamma. The f32 body sums |x|^2 on the tensor
    cores exactly as its product sums x.x, so its diagonal is 1 at any
    ratio; the bf16 body's norms are f32 sums beside a wgmma product, as
    the plain version's are beside its matmul, so its ratio stays where an
    f32 sum of 784 terms keeps 1e-5."""
    x, gamma = _offset_rows(1000, 784, ratio, 62, cuda)
    x = resolve_precision(prec).cast_tiles(x)
    got = ops.kernel_matrix(x, x, kind="rbf", gamma=gamma, precision=prec)
    diag = torch.diagonal(got)
    assert float((diag - 1).abs().max()) <= 1e-5
    if prec == "f32":
        assert bool((diag == 1.0).all())
    if ratio <= 1.0:   # past that the plain version's own sums miss 1e-5
        want = ref.kernel_matrix_ref(x, x, kind="rbf", gamma=gamma,
                                     precision=prec)
        _assert_normwise(got, want)


@pytest.mark.parametrize("prec", PRECS)
def test_kernel_matrix_tile_body_is_bitwise_repeatable(cuda, prec):
    """No atomics: two launches on the Gram build's widths give the same
    bits."""
    x, y = _rand((3000, 784), 63, cuda), _rand((3000, 784), 64, cuda)
    a, b = (ops.kernel_matrix(x, y, kind="rbf", gamma=1 / 784,
                              precision=prec) for _ in range(2))
    assert torch.equal(a, b)


@pytest.mark.parametrize("kind", KINDS)
def test_kernel_matrix_tile_occupancy(cuda, kind):
    """Two CTAs of either tile body share an SM, as tile_ctas assumes."""
    from repro_torch.kernels.kernel_matrix import ctas_per_sm
    index = torch.cuda.current_device()
    assert ctas_per_sm(torch.float32, kind, index) == 2
    assert ctas_per_sm(torch.bfloat16, kind, index) == 2


@pytest.mark.parametrize("shape", [(3000, 3000, 784), (500, 777, 40)],
                         ids=["3000x3000", "500x777"])
def test_assign_fused_f32_is_bitwise_repeatable(cuda, shape):
    """The splits are summed in a fixed order, without atomics: two
    launches on the same inputs give the same bits."""
    m, lm, d = shape
    x, landmarks, labels_l, counts, g = _assign_case(m, lm, d, 10, 44, cuda)
    a = ops.assign_fused(x, landmarks, labels_l, counts, g, n_clusters=10,
                         gamma=1 / d)
    b = ops.assign_fused(x, landmarks, labels_l, counts, g, n_clusters=10,
                         gamma=1 / d)
    assert all(torch.equal(u, v) for u, v in zip(a, b))


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


# ---------------------------------------------------------------------------
# the explicit feature maps: embed_assign and sketch_assign
# ---------------------------------------------------------------------------

# (n, d, m, C): the reference's test shapes (tests/test_approx.py,
# tests/test_sketch.py), m = 77 leaves a ragged embed tile, C = 300 takes
# two launches
EMBED_SHAPES = [(64, 16, 32, 5), (100, 30, 77, 13), (300, 40, 260, 130),
                (300, 40, 77, 300)]
SKETCH_SHAPES = [(64, 16, 32, 5), (100, 30, 77, 13), (300, 520, 260, 130),
                 (300, 520, 77, 300)]
NYSTROM_SPECS = {"rbf": dict(gamma=0.5), "linear": {},
                 "polynomial": dict(gamma=0.05, coef0=1.0, degree=3),
                 "cosine": {}}


def _embed_map(kind, x, m, spec_kind="rbf"):
    gen = torch.Generator().manual_seed(0)
    if kind == "rff":
        return make_rff(gen, x.shape[1], m, KernelSpec("rbf", gamma=0.5),
                        device=x.device)
    if kind == "sketch":
        return make_count_sketch(gen, x.shape[1], m, KernelSpec("linear"),
                                 device=x.device)
    return make_nystrom(gen, x, m, KernelSpec(spec_kind,
                                              **NYSTROM_SPECS[spec_kind]))


def _plain_scores(x, fmap, centroids, counts, prec):
    """The plain version's whole score matrix [n, C] (for near-ties) and its
    (labels, score)."""
    p = resolve_precision(prec)
    xc = p.cast_tiles(x)
    if fmap.kind == "sketch":
        c32, csq = ops._masked_csq(centroids, counts)
        args = (xc, fmap.h, fmap.sign.to(p.sign_dtype), c32.T, csq)
        return (ref.sketch_score_ref(*args, precision=prec),
                ref.sketch_assign_ref(*args, precision=prec))
    w, aux, v, csq, statics = ops.embed_panels(fmap, centroids, counts)
    args = (xc, p.cast_tiles(w), v, csq)
    kw = dict(b=aux, precision=prec, **statics)
    return ref.embed_score_ref(*args, **kw), ref.embed_assign_ref(*args, **kw)


def _check_assignment(x, fmap, centroids, counts, prec, name,
                      normwise=False):
    """The kernel against its plain version: scores within 1e-4 (normwise:
    max |error| <= 1e-4 max(1, max |score|), for scores whose size grows
    with the row width), labels equal outside near-ties."""
    before = ops.LAUNCHES[name]
    lab, score = ops.embed_assign(x, fmap, centroids, counts, precision=prec)
    assert ops.LAUNCHES[name] == before + -(-centroids.shape[0] // 256)
    full, (want_lab, want_score) = _plain_scores(x, fmap, centroids, counts,
                                                 prec)
    if normwise:
        err = float((score - want_score).abs().max())
        assert err <= 1e-4 * max(1.0, float(want_score.abs().max()))
    else:
        torch.testing.assert_close(score, want_score, **_tol(1e-4))
    # labels equal outside near-ties of the plain version
    top2 = torch.topk(full, 2, dim=1, largest=False).values
    near = top2[:, 1] - top2[:, 0] <= 1e-4 * torch.clamp(top2[:, 0].abs(),
                                                         min=1.0)
    assert not bool(((lab != want_lab) & ~near).any())
    return lab, score


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("shape", EMBED_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("kind", ["rff", "nystrom"])
def test_embed_assign_matches_plain(cuda, kind, shape, prec):
    n, d, m, c = shape
    x, centroids = _rand((n, d), 11, cuda), _rand((c, m), 12, cuda)
    counts = torch.ones(c, device=cuda)
    _check_assignment(x, _embed_map(kind, x, m), centroids, counts, prec,
                      "embed_assign")


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("spec_kind", list(NYSTROM_SPECS))
def test_embed_assign_every_mercer_kind(cuda, spec_kind, prec):
    x, centroids = _rand((300, 40), 13, cuda), _rand((13, 77), 14, cuda)
    fmap = _embed_map("nystrom", x, 77, spec_kind)
    _check_assignment(x, fmap, centroids, torch.ones(13, device=cuda), prec,
                      "embed_assign")


# (n, d, m, C) and the geometry (column tile, row block) the f32 body takes
# for them (kernels/embed_assign.py f32_geometry): every tile, n off the
# row block, D off the chunk, C = 130 and 300 (two launches)
EMBED_F32_SHAPES = [((300, 36, 20, 5), (20, 128)),
                    ((500, 36, 40, 300), (40, 128)),
                    ((1000, 100, 80, 10), (80, 80)),
                    ((300, 40, 160, 130), (160, 80)),
                    ((777, 784, 320, 10), (160, 80)),
                    ((60000, 64, 320, 10), (160, 80))]


@pytest.mark.parametrize("shape,geometry", EMBED_F32_SHAPES,
                         ids=["x".join(map(str, s)) for s, _ in EMBED_F32_SHAPES])
@pytest.mark.parametrize("kind", ["rff", "nystrom"])
def test_embed_assign_f32_geometries(cuda, kind, shape, geometry):
    n, d, m, c = shape
    assert f32_geometry(m) == geometry
    x, centroids = _rand((n, d), 33, cuda), _rand((c, m), 34, cuda)
    _check_assignment(x, _embed_map(kind, x, m), centroids,
                      torch.ones(c, device=cuda), "f32", "embed_assign")


@pytest.mark.parametrize("m", [20, 40, 80, 160])
@pytest.mark.parametrize("spec_kind", list(NYSTROM_SPECS))
def test_embed_assign_f32_every_mercer_kind_per_tile(cuda, spec_kind, m):
    x, centroids = _rand((500, 40), 35, cuda), _rand((13, m), 36, cuda)
    fmap = _embed_map("nystrom", x, m, spec_kind)
    _check_assignment(x, fmap, centroids, torch.ones(13, device=cuda), "f32",
                      "embed_assign")


# (n, d, m, C) of the bf16 body (the assign bf16 body with the map as its
# epilogue): Fig.5's width at n off the 128-row block, ragged m (77 in one
# tile, 320 in three), D off the 64-feature chunk, C = 300 (two cluster
# chunks), and m = 700 (three splits of the w axis)
EMBED_BF16_SHAPES = [(1001, 784, 320, 10), (1001, 100, 77, 13),
                     (400, 40, 320, 300), (2000, 784, 700, 10)]
EMBED_BF16_KINDS = ["rff", *NYSTROM_SPECS]


def _bf16_embed_map(kind, x, m):
    """An RFF map of the rbf kernel or a Nystrom map of ``kind``, with
    gamma 1/D, where rbf values spread over (0, 1) at any D."""
    gen, d = torch.Generator().manual_seed(0), x.shape[1]
    spec = {"rff": dict(gamma=1 / d), "rbf": dict(gamma=1 / d),
            "linear": {}, "polynomial": dict(gamma=1 / d, coef0=1.0,
                                             degree=3),
            "cosine": {}}[kind]
    if kind == "rff":
        return make_rff(gen, d, m, KernelSpec("rbf", **spec), device=x.device)
    return make_nystrom(gen, x, m, KernelSpec(kind, **spec))


@pytest.mark.parametrize("shape", EMBED_BF16_SHAPES,
                         ids=["x".join(map(str, s)) for s in EMBED_BF16_SHAPES])
@pytest.mark.parametrize("kind", EMBED_BF16_KINDS)
def test_embed_bf16_body_matches_plain(cuda, kind, shape):
    n, d, m, c = shape
    x = _rand((n, d), 37, cuda)
    centroids = _rand((c, m), 38, cuda) * m ** -0.5   # |c|^2 near 1
    _check_assignment(x, _bf16_embed_map(kind, x, m), centroids,
                      torch.ones(c, device=cuda), "bf16", "embed_assign")


@pytest.mark.parametrize("kind", ["rff", "rbf"])
def test_embed_bf16_ties_and_empty_clusters_at_fig5_width(cuda, kind):
    """At m = 320 over rows off the row block: two identical centroids tie
    bitwise (the lower index wins), an empty cluster (+1e30) is never
    chosen, even with a zero centroid."""
    x = _rand((1001, 784), 39, cuda)
    fmap = _bf16_embed_map(kind, x, 320)
    a, b = _rand((2, 320), 40, cuda) * 320 ** -0.5
    lab, _ = ops.embed_assign(x, fmap, torch.stack([a, b, a]),
                              torch.ones(3, device=cuda), precision="bf16")
    assert int(lab.max()) <= 1 and bool((lab == 0).any())
    lab, score = ops.embed_assign(
        x, fmap, torch.stack([a, torch.zeros_like(a), b]),
        torch.tensor([5.0, 0.0, 3.0], device=cuda), precision="bf16")
    assert not bool((lab == 1).any()) and float(score.max()) < 1e29


def test_embed_bf16_rff_at_large_phases(cuda):
    """At gamma 4 and D = 784, |x.w + b| reaches tens of pi: the
    full-range cosine keeps the bf16 body within 1e-4 of the plain version
    on the same bf16 tiles."""
    x = _rand((1001, 784), 41, cuda)
    fmap = make_rff(torch.Generator().manual_seed(0), 784, 320,
                    KernelSpec("rbf", gamma=4.0), device=cuda)
    arg = (x.to(torch.bfloat16).float() @ fmap.w.to(torch.bfloat16).float().T
           + fmap.b[None])
    assert float(arg.abs().max()) > 20 * np.pi
    centroids = _rand((10, 320), 42, cuda) * 320 ** -0.5
    _check_assignment(x, fmap, centroids, torch.ones(10, device=cuda), "bf16",
                      "embed_assign")


@pytest.mark.parametrize("step", [256, 1024], ids=["reduced", "past"])
def test_embed_bf16_rff_cosine_at_exact_arguments(cuda, step):
    """One-hot rows make x.w a single bf16 product, exact in any order, so
    kernel and plain version take the cosine of the same f32 arguments
    x.w + b: up to 65,280 (within the reduced cosine's range, where the
    body's tiles take it without a branch) and up to 261,120 (most past
    it, where a tile falls back to the library's cosf)."""
    from repro_torch import convert
    n, d, m, c = 1000, 16, 200, 10
    rng = np.random.default_rng(45)
    x = np.zeros((n, d), np.float32)
    x[np.arange(n), np.arange(n) % d] = 1.0
    w = (rng.integers(-255, 256, (m, d)) * step).astype(np.float32)
    b = rng.uniform(0.0, 2 * np.pi, m).astype(np.float32)
    fmap = convert.feature_map_from_numpy(
        "rff", {"w": w, "b": b}, {"scale": (2.0 / m) ** 0.5}, cuda)
    centroids = _rand((c, m), 46, cuda) * m ** -0.5
    _check_assignment(torch.from_numpy(x).to(cuda), fmap, centroids,
                      torch.ones(c, device=cuda), "bf16", "embed_assign")


@pytest.mark.parametrize("kind", ["rff", "rbf"])
def test_embed_bf16_is_bitwise_repeatable(cuda, kind):
    """The splits of the w axis are summed in a fixed order: two launches
    give the same bits (m = 700: three splits)."""
    x = _rand((2000, 784), 43, cuda)
    fmap = _bf16_embed_map(kind, x, 700)
    centroids = _rand((10, 700), 44, cuda)
    one, two = (ops.embed_assign(x, fmap, centroids, precision="bf16")
                for _ in range(2))
    assert torch.equal(one[0], two[0]) and torch.equal(one[1], two[1])


@pytest.mark.parametrize("kind", EMBED_BF16_KINDS)
def test_embed_bf16_occupancy(cuda, kind):
    """Two CTAs of the bf16 body share an SM at C = 10 for every epilogue,
    RFF's cosine included (at most 128 registers a thread), one at 256
    clusters."""
    from repro_torch.kernels.embed_assign import ctas_per_sm
    index = torch.cuda.current_device()
    assert ctas_per_sm(16, kind, index) == 2
    assert ctas_per_sm(256, kind, index) == 1


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("shape", SKETCH_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_sketch_assign_matches_plain(cuda, shape, prec):
    n, d, m, c = shape
    x, centroids = _rand((n, d), 15, cuda), _rand((c, m), 16, cuda)
    _check_assignment(x, _embed_map("sketch", x, m), centroids,
                      torch.ones(c, device=cuda), prec, "sketch_assign")


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("kind", ["rff", "nystrom", "sketch"])
def test_embedded_ties_and_empty_clusters(cuda, kind, prec):
    """Two identical centroids tie bitwise (the lower index wins); an empty
    cluster is never chosen, even with a zero centroid."""
    x = _rand((300, 24), 17, cuda)
    fmap = _embed_map(kind, x, 40)
    a, b = _rand((2, 40), 18, cuda)
    lab, _ = ops.embed_assign(x, fmap, torch.stack([a, b, a]),
                              torch.ones(3, device=cuda), precision=prec)
    assert int(lab.max()) <= 1
    centroids = torch.stack([a, torch.zeros_like(a), b])
    lab, _ = ops.embed_assign(x, fmap, centroids,
                              torch.tensor([5.0, 0.0, 3.0], device=cuda),
                              precision=prec)
    assert not bool((lab == 1).any())


@pytest.mark.parametrize("prec", PRECS)
def test_sketch_assign_is_deterministic(cuda, prec):
    x, centroids = _rand((3000, 256), 19, cuda), _rand((50, 128), 20, cuda)
    fmap = _embed_map("sketch", x, 128)
    one = ops.sketch_assign(x, fmap, centroids, precision=prec)
    two = ops.sketch_assign(x, fmap, centroids, precision=prec)
    assert torch.equal(one[0], two[0]) and torch.equal(one[1], two[1])


def _sketch_map_dropping_columns(d, m, seed, dev):
    """A count sketch whose hash sends about one column in ten nowhere
    (h = -1), which make_count_sketch never draws."""
    from repro_torch.approx.sketch import CountSketchMap
    rng = np.random.default_rng(seed)
    h = rng.integers(0, m, d)
    h[rng.random(d) < 0.1] = -1
    sign = rng.choice([-1.0, 1.0], d)
    return CountSketchMap(h=torch.from_numpy(h.astype(np.int32)).to(dev),
                          sign=torch.from_numpy(sign.astype(np.float32)).to(
                              dev), m=m)


# (n, D, m, C): n off the 32-row block; m = 77 (off the 8-bucket k step);
# D off the bf16 vector (padded) and over several 512-byte column chunks;
# C = 300 (two launches); m = 260 with C = 130, whose V does not fit beside
# the ring, so the buckets go in two chunks; Tab.2's widths
SKETCH_EDGE_SHAPES = [(1001, 130, 77, 300), (1001, 520, 77, 13),
                      (333, 520, 260, 130), (1001, 256, 128, 50),
                      (40, 20, 77, 5)]


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("shape", SKETCH_EDGE_SHAPES,
                         ids=["x".join(map(str, s)) for s in SKETCH_EDGE_SHAPES])
def test_sketch_assign_at_ragged_edges(cuda, shape, prec):
    n, d, m, c = shape
    x, centroids = _rand((n, d), 65, cuda), _rand((c, m), 66, cuda)
    fmap = _sketch_map_dropping_columns(d, m, 67, cuda)
    _check_assignment(x, fmap, centroids, torch.ones(c, device=cuda), prec,
                      "sketch_assign")


# (n, D, m): rows wider than a staged gather program fits beside the ring
# (10,881 columns at m = 256) and Tab.2's 47,236-term vocabulary, at both
# of its sketch widths; C = 50
SKETCH_WIDE_SHAPES = [(1001, 10881, 128), (1001, 10881, 256),
                      (1001, 47236, 128), (1001, 47236, 256)]


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("shape", SKETCH_WIDE_SHAPES,
                         ids=["x".join(map(str, s)) for s in SKETCH_WIDE_SHAPES])
def test_sketch_assign_takes_wide_rows(cuda, shape, prec):
    """The gather program is read in place past what shared memory holds,
    so any width launches and agrees with the plain version. A bucket sums
    about D / m of the normal rows' columns (the two versions in another
    order), so the score grows with D and is held normwise."""
    from repro_torch.kernels import sketch_assign as sk
    n, d, m = shape
    item = 2 if prec == "bf16" else 4
    assert not sk.geometry(d, m, 64, item)[2]
    x, centroids = _rand((n, d), 71, cuda), _rand((50, m), 72, cuda)
    fmap = _sketch_map_dropping_columns(d, m, 73, cuda)
    _check_assignment(x, fmap, centroids, torch.ones(50, device=cuda), prec,
                      "sketch_assign", normwise=True)


@pytest.mark.parametrize("prec", PRECS)
def test_sketch_program_in_place_equals_staged(cuda, prec, monkeypatch):
    """At Tab.2's dense width the program is staged; read in place instead
    (the wide rows' route), the kernel gives the same bits."""
    from repro_torch.kernels import sketch_assign as sk
    x, centroids = _rand((5000, 256), 74, cuda), _rand((50, 128), 75, cuda)
    fmap = _sketch_map_dropping_columns(256, 128, 76, cuda)
    item = 2 if prec == "bf16" else 4
    assert sk.geometry(256, 128, 64, item)[2]
    staged = ops.sketch_assign(x, fmap, centroids, precision=prec)
    real = sk.geometry
    monkeypatch.setattr(sk, "geometry",
                        lambda *a: (*real(*a)[:2], False))
    in_place = ops.sketch_assign(x, fmap, centroids, precision=prec)
    assert torch.equal(staged[0], in_place[0])
    assert torch.equal(staged[1], in_place[1])


@pytest.mark.parametrize("prec", PRECS)
def test_sketch_assign_is_bitwise_repeatable_over_launches(cuda, prec):
    """Two calls over 20,000 rows and 300 clusters (two launches each, with
    dropped columns) give the same bits."""
    x, centroids = _rand((20000, 256), 68, cuda), _rand((300, 128), 69, cuda)
    fmap = _sketch_map_dropping_columns(256, 128, 70, cuda)
    one = ops.sketch_assign(x, fmap, centroids, precision=prec)
    two = ops.sketch_assign(x, fmap, centroids, precision=prec)
    assert torch.equal(one[0], two[0]) and torch.equal(one[1], two[1])


def test_count_sketch_features_are_deterministic(cuda):
    """The fit's dense sketch sums in a fixed order on the card too, and
    matches the CPU's within rounding."""
    x = _rand((3000, 256), 21, cuda)
    fmap = _embed_map("sketch", x, 128)
    z = fmap(x)
    assert torch.equal(z, fmap(x))
    torch.testing.assert_close(z.cpu(), x.cpu() @ fmap.matrix.cpu(),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("method", ["rff", "nystrom", "sketch",
                                    "tensorsketch"])
def test_small_embedded_fit_on_the_card_matches_the_cpu(cuda, method):
    x, _ = toy2d(300)
    spec = {"sketch": KernelSpec("linear"),
            "tensorsketch": KernelSpec("polynomial", gamma=1.0, coef0=0.5,
                                       degree=2)}.get(
        method, KernelSpec("rbf", gamma=4.0))
    cfg = MiniBatchConfig(n_clusters=4, n_batches=3, kernel=spec,
                          method=method, embed_dim=32)
    launches = dict(ops.LAUNCHES)
    gpu = fit_dataset(x, cfg)
    gpu_labels = gpu.predict(x)
    cpu = fit_dataset(x, cfg, device="cpu")
    assert gpu.state.centroids.is_cuda
    kernel = {"sketch": "sketch_assign", "tensorsketch": None}.get(
        method, "embed_assign")
    if kernel is not None:
        assert ops.LAUNCHES[kernel] > launches[kernel]
    agree = (gpu_labels.cpu() == cpu.predict(x)).float().mean()
    assert float(agree) >= 0.99


# (B, H, KH, Sq, Sk, dh, causal, softcap): the JAX kernel test's cases, then
# dh 16 to 256 with ragged S from 1 to 2047, Sq > Sk, and non-causal
FLASH_CASES = [
    (2, 4, 4, 128, 128, 64, True, None),
    (1, 8, 2, 100, 100, 64, True, None),
    (2, 4, 2, 256, 256, 128, True, 50.0),
    (1, 2, 2, 64, 256, 64, False, None),
    (1, 4, 1, 200, 200, 64, True, None),
    (1, 4, 2, 1, 1, 16, True, None),
    (2, 4, 4, 100, 100, 16, True, None),
    (1, 2, 1, 70, 70, 32, True, None),
    (1, 2, 2, 130, 128, 48, True, None),
    (1, 4, 2, 1000, 1000, 64, True, None),
    (1, 2, 1, 1000, 1000, 256, True, 50.0),
    (1, 2, 2, 2047, 2047, 128, True, None),
    (1, 4, 2, 77, 384, 256, False, 30.0),
    # every tiling class of the bf16 body (dh padded to 64, 128, 256) with
    # GQA 8:1, softcap, B > 1, S = 1 and S past a multiple of 128, Sq < Sk
    # causal and Sq > Sk not
    (1, 8, 1, 300, 300, 128, True, None),
    (3, 8, 1, 129, 129, 48, True, 20.0),
    (2, 8, 1, 257, 257, 16, True, None),
    (1, 4, 2, 100, 384, 128, True, None),
    (1, 2, 2, 300, 128, 128, False, None),
    (1, 2, 1, 1, 1, 256, True, None),
    (2, 16, 2, 640, 640, 256, True, 50.0),
    # zamba2-2.7b's shared block (dh 80: the 128 tiling, 48 columns
    # padded) and seamless-m4t-medium's encoder (non-causal, dh 64)
    (1, 32, 32, 600, 600, 80, True, None),
    (1, 16, 16, 512, 512, 64, False, None),
]


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=[f"B{c[0]}H{c[1]}KH{c[2]}S{c[3]}x{c[4]}d{c[5]}"
                              for c in FLASH_CASES])
def test_flash_attention_matches_plain(cuda, case, prec):
    b, h, kh, sq, sk, dh, causal, cap = case
    q, k, v = (_rand((b, n, s, dh), seed, cuda)
               for n, s, seed in ((h, sq, 22), (kh, sk, 23), (kh, sk, 24)))
    before = ops.LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=causal, softcap=cap,
                              precision=prec)
    assert ops.LAUNCHES["flash_attention"] == before + 1
    p = resolve_precision(prec)
    want = ref.flash_attention_ref(p.cast_tiles(q), p.cast_tiles(k),
                                   p.cast_tiles(v), causal=causal,
                                   softcap=cap)
    assert got.shape == (b, h, sq, dh) and got.dtype == p.tile_dtype
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), want.float(),
                               **_tol(1e-2 if prec == "bf16" else 2e-5))


@pytest.mark.parametrize("dh,width", [(128, 128), (16, 24)],
                         ids=["heads", "dh-slice"])
def test_flash_attention_reads_strided_views(cuda, monkeypatch, dh, width):
    """bf16 q, k and v as attention_block hands them over: [B, H, S, dh]
    views of [B, S, H, dh] activations (here also a dh slice of wider
    rows). The kernel reads them in place, writes o as a view of
    [B, S, H, dh] memory, and agrees with contiguous inputs bit for bit."""
    b, s, h, kh = 2, 300, 8, 2
    q, k, v = (_rand((b, s, n, width), seed, cuda).to(torch.bfloat16)
               [..., :dh].transpose(1, 2)
               for n, seed in ((h, 30), (kh, 31), (kh, 32)))
    assert not q.is_contiguous()
    seen, launch = [], build.launch
    monkeypatch.setattr(build, "launch",
                        lambda entry, *a: (seen.append(a), launch(entry, *a)))
    got = ops.flash_attention(q, k, v, precision="bf16")
    monkeypatch.undo()
    assert seen[0][:3] == (q.data_ptr(), k.data_ptr(), v.data_ptr())
    assert got.shape == (b, h, s, dh)
    assert got.transpose(1, 2).is_contiguous()
    dense = ops.flash_attention(q.contiguous(), k.contiguous(),
                                v.contiguous(), precision="bf16")
    assert torch.equal(got, dense)
    want = ref.flash_attention_ref(q, k, v)
    torch.testing.assert_close(got.float(), want.float(), **_tol(1e-2))


# (B, H, KH, S, dh, softcap): every tiling of the f32 body, ragged S, GQA
F32_VIEW_CASES = [(2, 8, 2, 300, 16, None), (1, 4, 4, 129, 64, 30.0),
                  (2, 8, 1, 257, 128, None), (1, 4, 2, 100, 256, 50.0)]


@pytest.mark.parametrize("case", F32_VIEW_CASES,
                         ids=[f"B{c[0]}H{c[1]}KH{c[2]}S{c[3]}d{c[4]}"
                              for c in F32_VIEW_CASES])
def test_flash_attention_f32_reads_strided_views(cuda, monkeypatch, case):
    """f32 q, k and v as attention_block hands them over: [B, H, S, dh]
    views of [B, S, H, dh] activations. The wrapper makes no contiguous
    copy (the kernel gets the views' own pointers), o is a view of
    [B, S, H, dh] memory, and the result equals that of contiguous inputs
    bit for bit and the plain version within 2e-5."""
    b, h, kh, s, dh, cap = case
    q, k, v = (_rand((b, s, n, dh), seed, cuda).transpose(1, 2)
               for n, seed in ((h, 33), (kh, 34), (kh, 35)))
    assert not q.is_contiguous()
    seen, launch = [], build.launch
    monkeypatch.setattr(build, "launch",
                        lambda entry, *a: (seen.append(a), launch(entry, *a)))
    got = ops.flash_attention(q, k, v, softcap=cap)
    monkeypatch.undo()
    assert seen[0][:3] == (q.data_ptr(), k.data_ptr(), v.data_ptr())
    assert got.shape == (b, h, s, dh) and got.dtype == torch.float32
    assert got.transpose(1, 2).is_contiguous()
    dense = ops.flash_attention(q.contiguous(), k.contiguous(),
                                v.contiguous(), softcap=cap)
    assert torch.equal(got, dense)
    want = ref.flash_attention_ref(q, k, v, softcap=cap)
    torch.testing.assert_close(got, want, **_tol(2e-5))


def test_flash_attention_wrapper_raises(cuda):
    q = _rand((1, 2, 64, 24), 25, cuda)
    with pytest.raises(ValueError, match="multiple of 16"):
        ops.flash_attention(q, q, q)
    q = _rand((1, 2, 64, 272), 25, cuda)
    with pytest.raises(ValueError, match="multiple of 16"):
        ops.flash_attention(q, q, q)
    q, k = _rand((1, 2, 64, 64), 26, cuda), _rand((1, 2, 200, 64), 27, cuda)
    with pytest.raises(ValueError, match="Sk % 128"):
        ops.flash_attention(q, k, k, causal=False)
    q, k = _rand((1, 3, 64, 64), 28, cuda), _rand((1, 2, 64, 64), 29, cuda)
    with pytest.raises(ValueError, match="kv heads"):
        ops.flash_attention(q, k, k)
    with pytest.raises(TypeError, match="f32 or bf16"):
        ops.flash_attention(q.half(), k.half(), k.half())


def _params_to(params, dev):
    return {n: ([{k: t.to(dev) for k, t in layer.items()} for layer in v]
                if n == "layers" else v.to(dev)) for n, v in params.items()}


@pytest.mark.parametrize("arch", ["olmo-1b", "gemma2-2b"])
def test_serving_engine_on_the_card_matches_the_cpu(cuda, arch):
    """The smoke config with attn_impl="flash" at f32: every prefill layer
    without a window launches the kernel, and the greedy outputs equal the
    same engine's on the CPU."""
    cfg = dataclasses.replace(get_arch(arch, smoke=True), attn_impl="flash")
    cpu_api = get_model(cfg, device="cpu")
    params = cpu_api.init(0, torch.float32)
    gpu_api = get_model(cfg)
    kw = dict(max_batch=4, max_len=64, max_new_tokens=8, eos_token=-1)
    engines = [ServingEngine(cpu_api, params, ServeConfig(**kw),
                             device="cpu"),
               ServingEngine(gpu_api, _params_to(params, cuda),
                             ServeConfig(**kw))]
    rng = np.random.default_rng(0)
    for n in (5, 9, 3, 7, 6, 4):
        prompt = rng.integers(1, cfg.vocab_size, size=n)
        for eng in engines:
            eng.submit(prompt)
    want = engines[0].run()
    before = ops.LAUNCHES["flash_attention"]
    got = engines[1].run()
    flash_layers = cfg.n_layers // (2 if cfg.local_global_period else 1)
    assert ops.LAUNCHES["flash_attention"] == before + 6 * flash_layers
    assert got == want


def test_gemma2_served_with_flash_matches_chunked_on_the_card(cuda):
    """gemma2 smoke at f32 (4 layers: 2 global with softcap 50, 2 with the
    8-row window) served through the engine on the card with
    attn_impl="flash" and with "chunked" on the same parameters, prompts
    of 3-21 tokens (past the window: the local layers' ring wraps in
    prefill and in decode): one flash launch per global layer per request
    and none in the chunked run, the first-token logits within 1e-4
    normwise (the f32 kernel against the plain chunked softmax) and the
    greedy tokens equal."""
    base = dataclasses.replace(get_arch("gemma2-2b", smoke=True),
                               n_layers=4)
    params = _params_to(get_model(base, device="cpu").init(0, torch.float32),
                        cuda)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, base.vocab_size, size=n)
               for n in (3, 9, 14, 21, 6)]
    runs = {}
    for impl in ("flash", "chunked"):
        api = get_model(dataclasses.replace(base, attn_impl=impl))
        firsts = []

        def prefill(p, batch, api=api, firsts=firsts, **kw):
            cache, logits = api.prefill(p, batch, **kw)
            firsts.append(logits[0])
            return cache, logits

        eng = ServingEngine(dataclasses.replace(api, prefill=prefill),
                            params, ServeConfig(max_batch=2, max_len=40,
                                                max_new_tokens=12,
                                                eos_token=-1))
        for prompt in prompts:
            eng.submit(prompt)
        before = ops.LAUNCHES["flash_attention"]
        runs[impl] = (eng.run(), firsts,
                      ops.LAUNCHES["flash_attention"] - before)
    global_layers = base.n_layers // base.local_global_period
    assert runs["flash"][2] == len(prompts) * global_layers
    assert runs["chunked"][2] == 0
    for f, c in zip(runs["flash"][1], runs["chunked"][1]):
        assert _rel(f, c) <= 1e-4
    assert runs["flash"][0] == runs["chunked"][0]


# ---------------------------------------------------------------------------
# assignment serving: bucket shapes, CUDA graphs, keyed draws, RLS
# ---------------------------------------------------------------------------

SERVE_KINDS = ["rff", "nystrom", "sketch", "tensorsketch", "exact"]


def _serving_artifact(kind, prec, dev, *, d=40, m=48, c=5):
    """A frozen artifact on ``dev``: blob-like rows, a map drawn from a
    seeded generator and class-mean centroids (exact: a small fit)."""
    rng = np.random.default_rng(3)
    centers = rng.normal(size=(c, d)).astype(np.float32) * 3
    y = rng.integers(0, c, size=600)
    x = centers[y] + rng.normal(size=(600, d)).astype(np.float32)
    xt = torch.from_numpy(x).to(dev)
    if kind == "exact":
        res = fit_dataset(x, MiniBatchConfig(
            n_clusters=c, n_batches=2, kernel=KernelSpec("rbf", gamma=1 / d)),
            device=dev)
        return freeze(res, precision=prec), x
    gen = torch.Generator().manual_seed(5)
    fmap = {"rff": lambda: make_rff(gen, d, m, KernelSpec("rbf", gamma=1 / d),
                                    device=dev),
            "nystrom": lambda: make_nystrom(gen, xt, m, KernelSpec(
                "rbf", gamma=1 / d)),
            "sketch": lambda: make_count_sketch(gen, d, m, KernelSpec(
                "linear"), device=dev),
            "tensorsketch": lambda: make_tensor_sketch(gen, d, m, KernelSpec(
                "polynomial", gamma=0.05, coef0=1.0, degree=2),
                device=dev)}[kind]()
    z = fmap(xt)
    yt = torch.from_numpy(y).to(dev)
    h = torch.nn.functional.one_hot(yt, c).float()
    cents = (h.T @ z) / h.sum(0).clamp(min=1)[:, None]
    return freeze_map(fmap, cents, h.sum(0), precision=prec), x


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("kind", SERVE_KINDS)
def test_graph_replay_equals_eager_at_every_bucket(cuda, kind, prec):
    """One captured graph per bucket; each replay's labels equal an eager
    launch of the same bucket bitwise, and each replay counts the launches
    its capture recorded."""
    art, x = _serving_artifact(kind, prec, cuda)
    svc = AssignService(art)
    assert svc.compiled_programs == 4
    rng = np.random.default_rng(1)
    for b in svc.cfg.buckets:
        xp = x[rng.integers(0, len(x), size=b)]
        before = dict(ops.LAUNCHES)
        got = svc._programs[b](xp)
        replayed = {k: ops.LAUNCHES[k] - before[k] for k in before}
        assert replayed == svc._programs[b].launches
        want = run_bucket(art, torch.from_numpy(xp).to(cuda)).cpu().numpy()
        assert np.array_equal(got, want)


def test_graph_replay_over_cluster_chunks(cuda):
    """Past 256 clusters the wrapper launches once per chunk and merges
    on the card: the captured merge equals the eager one."""
    art, x = _serving_artifact("rff", "f32", cuda, c=300)
    svc = AssignService(art, AssignServeConfig(buckets=(8, 64)))
    assert svc._programs[64].launches["embed_assign"] == 2
    for b in (8, 64):
        want = run_bucket(art, torch.from_numpy(x[:b]).to(cuda))
        assert np.array_equal(svc._programs[b](x[:b]), want.cpu().numpy())


@pytest.mark.parametrize("kind", SERVE_KINDS)
def test_service_on_the_card_labels_as_offline_predict(cuda, kind):
    """A ragged request mix through the graphs labels every row as the
    offline bucketed predict does."""
    art, x = _serving_artifact(kind, "f32", cuda)
    svc = AssignService(art, AssignServeConfig(max_queue_rows=len(x)))
    rng = np.random.default_rng(2)
    uids, start = [], 0
    while start < len(x):
        n = int(rng.integers(1, 150))
        uids.append((svc.submit(x[start:start + n]), start, n))
        start += n
    done = svc.drain()
    want = predict_frozen_np(art, x)
    for uid, a, n in uids:
        assert np.array_equal(done[uid], want[a:a + n])


def predict_frozen_np(art, x):
    from repro_torch.serving import predict_frozen
    return predict_frozen(art, x).cpu().numpy()


@pytest.mark.parametrize("prec", PRECS)
def test_sketch_artifact_reuses_the_maps_tables(cuda, prec):
    """A count-sketch artifact frozen from its map takes the map's bucket
    tables and gather programs; one loaded from its arrays builds its own,
    and both label alike."""
    from repro_torch.serving import predict_frozen
    art, x = _serving_artifact("sketch", prec, cuda)
    gen = torch.Generator().manual_seed(5)
    fmap = make_count_sketch(gen, x.shape[1], 48, KernelSpec("linear"),
                             device=cuda)
    cents, counts = art.arrays["centroids"], art.arrays["counts"]
    mine = freeze_map(fmap, cents, counts, precision=prec)
    order, offsets, sign, programs = mine.runtime["tables"]
    assert programs is fmap.programs and order is fmap.buckets[0]
    theirs = dataclasses.replace(mine)
    assert theirs.runtime["tables"][3] is not fmap.programs
    assert np.array_equal(predict_frozen(mine, x).cpu().numpy(),
                          predict_frozen(theirs, x).cpu().numpy())


@pytest.mark.parametrize("bucket", [1, 8])
@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("kind", ["rff", "nystrom", "sketch"])
def test_predict_assign_at_bucket_shapes(cuda, kind, prec, bucket):
    """ops.predict_assign at M = 1 and 8 rows of 784 features against its
    plain version, with a garbage tail (rows of 1e6) that changes no real
    label."""
    d = 256 if kind == "sketch" else 784
    art, _ = _serving_artifact(kind, prec, cuda, d=d, m=128 if kind ==
                               "sketch" else 320, c=10)
    a, st = art.arrays, art.statics
    x = _rand((8, d), 31, cuda)
    real = max(1, bucket - 2)
    xp = x[:bucket].clone()
    xp[real:] = 1e6
    if kind == "sketch":
        args = (a["h"], a["sign"], a["v"], a["csq"])
        kw = dict(map_kind="sketch", precision=prec)
        lab, score = ops.predict_assign(xp, *args, tables=art.runtime.get(
            "tables"), **kw)
    else:
        args = (a["w"], art.runtime.get("b", a["aux"]), a["v"], a["csq"])
        kw = dict(map_kind=st["map_kind"], gamma=st["gamma"],
                  coef0=st["coef0"], degree=st["degree"], scale=st["scale"],
                  precision=prec)
        lab, score = ops.predict_assign(xp, *args, **kw)
    p = resolve_precision(prec)
    lab_p, score_p = ref.predict_assign_ref(p.cast_tiles(xp), *args, **kw)
    torch.testing.assert_close(score[:real], score_p[:real], **_tol(1e-4))
    assert torch.equal(lab[:real], lab_p[:real])
    clean = x[:bucket].clone()
    clean[real:] = 0.0
    if kind == "sketch":
        lab_c = ops.predict_assign(clean, *args, tables=art.runtime.get(
            "tables"), **kw)[0]
    else:
        lab_c = ops.predict_assign(clean, *args, **kw)[0]
    assert torch.equal(lab_c[:real], lab[:real])


@pytest.mark.parametrize("bucket", [1, 8])
def test_kernel_matrix_column_body_at_bucket_shapes(cuda, bucket):
    x, y = _rand((bucket, 784), 32, cuda), _rand((10, 784), 33, cuda)
    got = ops.kernel_matrix(x, y, kind="rbf", gamma=1 / 784)
    want = ref.kernel_matrix_ref(x, y, kind="rbf", gamma=1 / 784)
    torch.testing.assert_close(got, want, **_tol(1e-5))


def test_keyed_draw_is_bitwise_equal_on_the_cpu_and_the_card(cuda):
    gids = torch.arange(0, 200000, 7)
    for key, tag in ((0, 0), (12345, 1), ((1 << 62) - 3, 2)):
        cpu = selectors.keyed_uniform(key, tag, gids)
        card = selectors.keyed_uniform(key, tag, gids.to(cuda)).cpu()
        assert torch.equal(cpu, card)
        assert torch.equal(selectors.keyed_gumbel(key, tag, gids),
                           selectors.keyed_gumbel(key, tag,
                                                  gids.to(cuda)).cpu())


@pytest.mark.parametrize("n,m", [(3000, 64), (6000, 320)])
def test_rls_selection_on_the_card_matches_plain(cuda, n, m):
    """RLS from the hand kernel's K against the same selection from the
    plain K (on the CPU), the draws keyed alike. Tie rule: the two index
    sets may differ only in rows whose plain logit lies within 1e-3 *
    max(1, |t|) of the plain m-th largest logit t."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(n, 64)).astype(np.float32)
    spec = KernelSpec("rbf", gamma=1 / 64)
    sel = selectors.RLSSelector()
    gids = torch.arange(n)
    pidx = sel.pilot_indices(selectors.keyed_uniform(7, 1, gids), m)
    noise = selectors.keyed_gumbel(7, 2, gids)
    xc = torch.from_numpy(x)
    before = ops.LAUNCHES["kernel_matrix"]
    s_card = sel.scores(xc.to(cuda), pidx.to(cuda), spec).cpu()
    assert ops.LAUNCHES["kernel_matrix"] == before + 2
    s_plain = sel.scores(xc, pidx, spec)
    logit = torch.log(torch.clamp(s_plain, min=1e-30)) + noise
    t = torch.sort(logit, descending=True).values[m - 1]
    near = torch.abs(logit - t) <= 1e-3 * max(1.0, abs(float(t)))
    got = set(sel.gumbel_top_m(s_card, noise, m).tolist())
    want = set(sel.gumbel_top_m(s_plain, noise, m).tolist())
    assert all(bool(near[i]) for i in got ^ want)
    assert len(got ^ want) <= 2 * int(near.sum())


@pytest.mark.parametrize("kind", ["sketch", "tensorsketch"])
def test_csr_sketch_is_bitwise_repeatable_on_the_card(cuda, kind):
    """Tab.2's vocabulary: two runs bitwise equal, a third under
    torch.use_deterministic_algorithms(True) (which refuses nondeterministic
    ops) equal too; within 1e-6 normwise of the CPU's."""
    xs, _ = make_rcv1_sparse(6000, vocab=47236, n_classes=50, seed=0)
    gen = torch.Generator().manual_seed(3)
    if kind == "sketch":
        fmap = make_count_sketch(gen, 47236, 256, KernelSpec("linear"),
                                 device=cuda)
    else:
        fmap = make_tensor_sketch(gen, 47236, 64, KernelSpec(
            "polynomial", gamma=1.0, coef0=0.5, degree=2), device=cuda)
    b = xs.to(cuda)
    one, two = fmap(b), fmap(b)
    assert torch.equal(one, two)
    torch.use_deterministic_algorithms(True)
    try:
        three = fmap(b)
    finally:
        torch.use_deterministic_algorithms(False)
    assert torch.equal(one, three)
    cpu_map = dataclasses.replace(
        fmap, **{f.name: getattr(fmap, f.name).cpu()
                 for f in dataclasses.fields(fmap)
                 if torch.is_tensor(getattr(fmap, f.name))})
    want = cpu_map(xs)
    err = float((one.cpu() - want).abs().max()) / max(
        1.0, float(want.abs().max()))
    assert err <= 1e-6


@pytest.mark.parametrize("kind", ["dense", "csr"])
def test_pinned_streamed_batches_equal_the_host_rows(cuda, kind):
    """A streamed BatchSource on the card (pinned copies on the copy
    stream, prefetch 2): each batch, cloned on the consumer's stream the
    moment it arrives and again after kernels ran on it, equals its host
    rows bitwise."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(48000, 784)).astype(np.float32)
    x[rng.random(x.shape) < 0.9] = 0.0
    cuts = [0, 1000, 13000, 13001, 30000, 48000]
    chunks = [x[a:b] if kind == "dense" else tsp.csr_from_dense(x[a:b])
              for a, b in zip(cuts[:-1], cuts[1:])]
    src = BatchSource.from_stream(chunks, 12000, prefetch=2)
    seen = []
    with src:
        for batch in src:
            dense = batch if kind == "dense" else tsp.to_dense(batch)
            first = dense.clone()               # reads right after arrival
            ops.kernel_matrix(dense, dense[:4], kind="rbf", gamma=1 / 784)
            seen.append((first, dense.clone()))
    torch.cuda.synchronize()
    assert len(seen) == 4
    for i, (first, after) in enumerate(seen):
        want = torch.from_numpy(x[i * 12000:(i + 1) * 12000])
        assert first.is_cuda and first.dtype == torch.float32
        assert torch.equal(first.cpu(), want) and torch.equal(after.cpu(),
                                                              want)


# ---------------------------------------------------------------------------
# the flight recorder on the card (repro_torch.obs)
# ---------------------------------------------------------------------------


def _obs_fit(method, dev, recorder=None):
    from repro_torch.data.synthetic import make_blobs
    x, _ = make_blobs(2000, 32, 5, seed=0)
    cfg = MiniBatchConfig(n_clusters=5, n_batches=2, s=0.5, seed=0,
                          kernel=KernelSpec("rbf", gamma=1 / 32),
                          engine="fused" if method == "exact" else
                          "materialize", method=method,
                          embed_dim=0 if method == "exact" else 40)
    return fit_dataset(x, cfg, device=dev, recorder=recorder)


@pytest.mark.parametrize("method", ["exact", "rff"])
def test_recorder_on_equals_off_on_the_card(cuda, tmp_path, method):
    """The recorder changes no bit and no launch; its watermarks read the
    card's allocator."""
    from repro_torch.obs import JsonlRecorder, export
    counts = []
    states = []
    for rec in (None, JsonlRecorder(str(tmp_path / "on.jsonl"))):
        for k in ops.LAUNCHES:
            ops.LAUNCHES[k] = 0
        for k in ref.CALLS:
            ref.CALLS[k] = 0
        states.append(_obs_fit(method, cuda, rec))
        torch.cuda.synchronize()
        counts.append((dict(ops.LAUNCHES), dict(ref.CALLS)))
        if rec is not None:
            rec.close()
    assert all(torch.equal(a, b) for a, b in zip(states[0].state[:-1],
                                                 states[1].state[:-1]))
    assert counts[0] == counts[1]
    assert all(v == 0 for v in counts[1][1].values())
    kernel = "assign_fused" if method == "exact" else "kernel_matrix"
    assert counts[1][0][kernel] > 0
    ev = export.read_events(str(tmp_path / "on.jsonl"))
    marks = [e for e in ev if e.get("name") == "hbm_watermark"]
    assert len(marks) == 2
    for m in marks:
        assert m["source"] == "device"
        assert m["peak_bytes"] >= m["measured_bytes"] > 0
        assert m["devices"][0]["device"] == f"cuda:{torch.cuda.current_device()}"
    costs = [e["value"] for e in ev if e.get("name") == "inner/cost"]
    assert costs == pytest.approx([h.cost for h in states[1].history])


def test_watermark_reads_the_allocator(cuda):
    from repro_torch.obs.memory import device_memory_stats
    keep = torch.empty(1 << 22, device=cuda)          # 16 MiB
    (st,) = device_memory_stats(cuda)
    assert st["bytes_in_use"] >= keep.numel() * 4
    assert st["peak_bytes_in_use"] >= st["bytes_in_use"]
    assert device_memory_stats("cpu") == []


def test_graphs_and_replays_unchanged_with_the_recorder(cuda, tmp_path):
    """The hooks sit around replay(): the same graphs, the same launches
    a replay, the same labels, with the recorder on."""
    from repro_torch.obs import JsonlRecorder, export
    art, x = _serving_artifact("rff", "f32", cuda)
    path = str(tmp_path / "svc.jsonl")
    rec = JsonlRecorder(path)
    got = []
    for svc in (AssignService(art), AssignService(art, recorder=rec)):
        assert svc.compiled_programs == 4
        before = dict(ops.LAUNCHES)
        uids = [svc.submit(x[a:a + n]) for a, n in ((0, 1), (1, 7),
                                                     (8, 300))]
        done = svc.drain()
        got.append(([done[u] for u in uids],
                    {k: ops.LAUNCHES[k] - before[k] for k in before},
                    {b: p.launches for b, p in svc._programs.items()}))
    rec.close()
    (lab0, l0, p0), (lab1, l1, p1) = got
    assert all(np.array_equal(a, b) for a, b in zip(lab0, lab1))
    assert l0 == l1 and p0 == p1 and l1["embed_assign"] > 0
    reqs = [e for e in export.read_events(path)
            if e.get("name") == "serve/request"]
    assert len(reqs) == 3 and all(e["compute_seconds"] > 0 for e in reqs)


def test_profiler_trace_names_spans_and_kernels(cuda, tmp_path):
    """torch.profiler over the card: the trace holds the obs spans, the
    hand kernels launched inside them, and every copy from the card to the
    host that the fits' thread launched lies in an ``obs:host_read``
    span, one copy a span."""
    import json
    from repro_torch.obs import start_profile, stop_profile
    start_profile(str(tmp_path))
    try:
        _obs_fit("exact", cuda)
        _obs_fit("rff", cuda).predict(np.zeros((100, 32), np.float32))
        from repro_torch.data.synthetic import make_blobs
        x, _ = make_blobs(1000, 32, 5, seed=1)
        fit_dataset(x, MiniBatchConfig(
            n_clusters=5, n_batches=2, s=0.5, seed=0, engine="materialize",
            kernel=KernelSpec("rbf", gamma=1 / 32)), device=cuda).predict(x)
        torch.cuda.synchronize()
    finally:
        stop_profile()
    with open(tmp_path / "trace.json") as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    names = {e.get("name", "") for e in events}
    assert "obs:gram_panel_build" in names
    assert "obs:engine_stats[materialize]" in names
    assert {"obs:fit", "obs:batch", "obs:stage", "obs:landmarks",
            "obs:kmeanspp", "obs:eq8", "obs:sweep", "obs:merge",
            "obs:embed_phi", "obs:predict", "obs:host_read[changed]",
            "obs:host_read[batch_stats]",
            "obs:host_read[kmeanspp]"} <= names
    assert "obs:gram_tiled_panel" not in names
    assert any("assign_f32_kernel" in n for n in names)
    assert any("kernel_matrix_col_kernel" in n for n in names)
    tid = next(e["tid"] for e in events if e["name"] == "obs:fit")
    reads = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in events if e["tid"] == tid
                   and e["name"].startswith("obs:host_read["))
    launch = {e["args"]["correlation"]: float(e["ts"]) for e in events
              if e.get("cat") == "cuda_runtime" and e["tid"] == tid
              and "correlation" in (e.get("args") or {})}
    dtoh = [launch[e["args"]["correlation"]] for e in events
            if e.get("cat") == "gpu_memcpy" and "DtoH" in e["name"]
            and e["args"].get("correlation") in launch]
    assert dtoh
    held = [next((k for k, (a, b) in enumerate(reads) if a <= t <= b), None)
            for t in dtoh]
    assert None not in held and len(set(held)) == len(held)


# ---------------------------------------------------------------------------
# the program audit on the card (launch.audit, analysis.dispatch)


@pytest.fixture
def card_world(cuda, tmp_path):
    """A NCCL world of one on a FileStore (none other is up here)."""
    import torch.distributed as dist
    started = not dist.is_initialized()
    if started:
        dist.init_process_group(
            "nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
            world_size=1, device_id=torch.device("cuda", 0))
    try:
        yield cuda
    finally:
        if started:
            dist.destroy_process_group()


def test_the_26_audits_are_clean_on_the_card(card_world):
    from repro_torch.launch import audit as launch_audit
    results = launch_audit.run_audits(n=512, d=16, n_landmarks=256, c=8,
                                      m=32, tile_rows=64, device="cuda")
    assert len(results) == 26
    for report, violations in results:
        assert violations == [], (report.name, violations)
        assert report.device == "cuda"
        assert report.allocator_peak_bytes is not None
    by_name = {r.name: r for r, _ in results}
    fused = by_name["kkmeans_fit[fused,f32]"]
    assert fused.kernel_launches_per_iteration["assign_fused"] >= 1
    assert "assign_fused" not in by_name["kkmeans_fit[tiled,f32]"]. \
        kernel_launches
    assert by_name["serve_bucket[64]"].kernel_launches["embed_assign"] >= 1


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("kernel", ["kernel_matrix", "assign_fused",
                                    "embed_assign", "sketch_assign",
                                    "flash_attention"])
def test_f32_accumulation_probe_on_the_card(cuda, kernel, prec):
    from repro_torch.launch import audit as launch_audit
    before = ops.LAUNCHES[kernel]
    probe = launch_audit.accumulation_probe(kernel, prec, cuda)
    assert probe["ok"], probe
    assert ops.LAUNCHES[kernel] > before      # the kernel, not the plain one


def test_tab1_audit_stays_below_the_gram_block(cuda):
    """Fused and tiled at Tab.1's batch width (15,000 x 784, |L| = 3,000,
    C = 10): allocator peak and largest intermediate below the [rows, |L|]
    f32 block, one host read an iteration; materialize holds the block."""
    from repro_torch.launch import audit as launch_audit
    n, d, n_l = 15000, 784, 3000
    x = _rand((n, d), 0, cuda)
    gram = 4 * n * n_l
    for report, violations in launch_audit.audit_engine_modes(
            n=n, d=d, n_landmarks=n_l, c=10, tile_rows=256, device="cuda",
            x=x, gamma=1.0 / d, max_iters=3):
        assert violations == [], (report.name, violations)
        assert report.host_reads_per_iteration <= 1
        if "materialize" in report.name:
            assert report.largest_intermediate_bytes >= gram
        else:
            assert report.allocator_peak_bytes < gram, report.name
            assert report.largest_intermediate_bytes < gram, report.name


def test_fit_labels_and_launches_unchanged_under_an_audit(cuda):
    """The audited fit (in card mode: sync debug mode on, the allocator's
    peak read) gives the labels and launches of the same fit run bare,
    and leaves the sync debug mode as it found it."""
    from repro_torch.analysis import audit
    x = _rand((3000, 24), 5, cuda).cpu().numpy()
    cfg = MiniBatchConfig(n_clusters=5, n_batches=2, s=0.3, seed=0,
                          engine="fused")

    def fit():
        before = dict(ops.LAUNCHES)
        labels = fit_dataset(x, cfg, device=cuda).predict(x)
        return labels.cpu(), {k: ops.LAUNCHES[k] - before[k] for k in before}

    plain_labels, plain_launches = fit()
    report = audit(fit, on_device=cuda)
    audited_labels, audited_launches = report.output
    assert report.device == "cuda"
    assert report.allocator_peak_bytes is not None
    assert torch.equal(plain_labels, audited_labels)
    assert plain_launches == audited_launches
    assert plain_launches["assign_fused"] > 0
    assert {k: v for k, v in report.kernel_launches.items() if v} == \
        {k: v for k, v in plain_launches.items() if v}
    assert report.sync_warnings > 0        # the mode was on while it ran
    assert torch.cuda.get_sync_debug_mode() == 0


def test_smoke_mp_runs_its_ranks_on_the_card(cuda, tmp_path):
    """``dryrun_cluster --smoke-mp P`` with no ``--device``: one NCCL rank
    a visible card, the s-step mesh fit through the kernels."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = torch.cuda.device_count()
    log = tmp_path / "smoke.jsonl"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun_cluster",
         "--smoke-mp", str(p), "--obs", str(log)],
        env=dict(os.environ, PYTHONPATH=os.path.join(root, "src")),
        cwd=root, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert f"[ok] multi-process smoke: {p} processes clean on cuda" \
        in proc.stdout
    import json
    header = json.loads(log.read_text().splitlines()[0])
    assert header["backend"] == "cuda" and header["n_processes"] == p


# ---------------------------------------------------------------------------
# LM training and the MoE family
# ---------------------------------------------------------------------------


def test_train_step_on_the_card_matches_the_cpu(cuda):
    """Two smoke train steps (f32, microbatches 2) on the card against the
    same steps on the CPU: losses within 1e-5, parameters normwise 1e-4
    (f32 math in another summation order, through two AdamW updates)."""
    from repro_torch.configs import TrainConfig
    from repro_torch.training import adamw_init, make_train_step
    from repro_torch.training.optim import tree_leaves, tree_map
    cfg = get_arch("qwen3-moe-235b-a22b", smoke=True)
    base = get_model(cfg, device="cpu").init(0, torch.float32)
    rng = np.random.default_rng(0)
    tok = rng.integers(1, cfg.vocab_size, size=(4, 32))
    tcfg = TrainConfig(microbatches=2, warmup_steps=1, total_steps=4)
    out = {}
    for dev in ("cpu", "cuda"):
        api = get_model(cfg, device=dev)
        params = tree_map(lambda t: t.to(dev, copy=True), base)
        opt = adamw_init(params, tcfg)
        step = make_train_step(api, tcfg)
        losses = []
        for _ in range(2):
            batch = {"tokens": torch.as_tensor(tok, device=dev),
                     "labels": torch.as_tensor(np.roll(tok, -1, 1),
                                               device=dev)}
            params, opt, m = step(params, opt, batch)
            losses.append(float(m["loss"]))
        out[dev] = (losses, [p.detach().cpu() for p in tree_leaves(params)])
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        assert float(torch.linalg.vector_norm(a - b)
                     / torch.linalg.vector_norm(b)) <= 1e-4


def test_flash_refuses_a_gradient_on_the_card(cuda):
    q = torch.randn(1, 4, 64, 64, device=cuda, requires_grad=True,
                    generator=torch.Generator(device=cuda).manual_seed(0))
    k = torch.zeros(1, 4, 64, 64, device=cuda)
    n = ops.LAUNCHES["flash_attention"]
    with pytest.raises(RuntimeError, match='attn_impl="chunked"'):
        ops.flash_attention(q, k, k)
    assert ops.LAUNCHES["flash_attention"] == n
    with torch.no_grad():
        out = ops.flash_attention(q, k, k)
    assert out.shape == q.shape and ops.LAUNCHES["flash_attention"] == n + 1
    cfg = dataclasses.replace(get_arch("olmo-1b", smoke=True),
                              attn_impl="flash")
    api = get_model(cfg, device=cuda)
    tok = torch.ones(1, 16, dtype=torch.long, device=cuda)
    with pytest.raises(RuntimeError, match="no gradient"):
        api.loss(api.init(0), {"tokens": tok, "labels": tok})


@pytest.mark.parametrize("groups,cf", [(0, 0.3), (0, 1.25), (4, 0.5)])
def test_moe_block_on_the_card_matches_the_cpu(cuda, groups, cf):
    """moe_block at f32 (dense dispatch with and without drops, the grouped
    expert-parallel path): routing equal, outputs within 1e-5."""
    from repro_torch.models import mlp
    from repro_torch.models.common import ParamBuilder
    cfg = dataclasses.replace(get_arch("qwen3-moe-235b-a22b", smoke=True),
                              n_experts=16, moe_top_k=4, capacity_factor=cf,
                              moe_ep_groups=groups)
    b = ParamBuilder(torch.Generator().manual_seed(0), torch.float32,
                     torch.device("cpu"))
    mlp.init_moe(b, cfg)
    x = _rand((4, 32, cfg.d_model), 3, "cpu")
    want = mlp.moe_block(b.params, x, cfg)
    p = {k: v.to(cuda) for k, v in b.params.items()}
    got = mlp.moe_block(p, x.to(cuda), cfg)
    _, e_cpu = mlp.route(x.reshape(-1, cfg.d_model), b.params["router"], 4)
    _, e_gpu = mlp.route(x.to(cuda).reshape(-1, cfg.d_model), p["router"], 4)
    assert torch.equal(e_gpu.cpu(), e_cpu)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the encoder-decoder, hybrid and RWKV6 families
# ---------------------------------------------------------------------------


def _rel(a, b) -> float:
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    den = float(torch.linalg.vector_norm(b))
    num = float(torch.linalg.vector_norm(a - b))
    return num / den if den else num


@pytest.mark.parametrize("arch,launches", [("seamless-m4t-medium", 4),
                                           ("zamba2-2.7b", 2),
                                           ("rwkv6-7b", 0)])
def test_new_families_on_the_card_match_the_cpu(cuda, monkeypatch, arch,
                                                 launches):
    """The smoke config at f32 on the card against the CPU: prefill with
    attn_impl="flash" (the encoder non-causal and the decoder causal,
    zamba2's shared block on a 40-token prompt past its window of 16; each
    attending layer one launch, RWKV none), its logits and cache, four
    decode steps fed the CPU's tokens (logits 1e-4 normwise), then the loss
    (relative 1e-5) and every grad (normwise 1e-4) at attn_impl="chunked"
    (f32 math in another summation order). zamba2's grads are ill
    conditioned (a few f32 leaves sit ~1e-4 from their f64 values), so
    they are held to an f64 oracle instead: the same call on the CPU in
    f64 arithmetic, every leaf of the card's and of the CPU's f32 grads
    within 4 x the CPU f32 run's own distance from f64 (its largest
    leaf's)."""
    from repro_torch.training.optim import (tree_leaves, tree_map,
                                            tree_unflatten)
    cfg = get_arch(arch, smoke=True)
    flash = dataclasses.replace(cfg, attn_impl="flash")
    params = get_model(cfg, device="cpu").init(0, torch.float32)
    on_card = tree_map(lambda t: t.to(cuda), params)
    rng = np.random.default_rng(0)
    tok = rng.integers(1, cfg.vocab_size, size=(2, 40))
    batch = {"tokens": torch.as_tensor(tok)}
    max_len = 48
    if cfg.family == "encdec":
        batch = {"tokens": batch["tokens"][:, :5], "frames": torch.as_tensor(
            rng.normal(size=(2, 128, cfg.d_model)).astype(np.float32))}
        max_len = 16
    out = {}
    for dev, p in (("cpu", params), ("cuda", on_card)):
        api = get_model(flash, device=dev)
        b = {k: v.to(dev) for k, v in batch.items()}
        before = ops.LAUNCHES["flash_attention"]
        cache, logits = api.prefill(p, b, max_len=max_len)
        if dev == "cuda":
            assert ops.LAUNCHES["flash_attention"] == before + launches
        steps = [logits]
        pos = b["tokens"].shape[1]
        for i in range(4):
            nxt = torch.argmax(out["cpu"][1][i] if dev == "cuda" else
                               steps[-1], dim=-1)
            logits, cache = api.decode(p, cache, nxt.to(dev), pos + i)
            steps.append(logits)
        out[dev] = (cache, steps)
    for name, leaf in out["cpu"][0].items():
        assert out["cuda"][0][name].dtype == leaf.dtype
        assert _rel(out["cuda"][0][name], leaf) <= 1e-4, name
    for got, want in zip(out["cuda"][1], out["cpu"][1]):
        assert _rel(got, want) <= 1e-4

    batch["labels"] = torch.roll(batch["tokens"], -1, dims=1)

    def loss_grads(dev, p):
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in tree_leaves(p)]
        b = {k: v.to(dev) for k, v in batch.items()}
        loss = get_model(cfg, device=dev).loss(tree_unflatten(p, leaves), b,
                                               remat=True)
        return float(loss.detach()), torch.autograd.grad(loss, leaves)

    loss_c, grads_c = loss_grads("cpu", params)
    loss_g, grads_g = loss_grads("cuda", on_card)
    assert loss_g == pytest.approx(loss_c, rel=1e-5)
    if cfg.family != "hybrid":
        for a, b in zip(grads_g, grads_c):
            assert _rel(a, b) <= 1e-4
        return
    # the f64 oracle: every cast the model makes to float32 goes to
    # float64 while the f64 call runs
    monkeypatch.setattr(torch, "float32", torch.float64)
    _, grads_64 = loss_grads("cpu", tree_map(lambda t: t.double(), params))
    monkeypatch.undo()
    assert all(w.dtype == torch.float64 for w in grads_64)
    # one limit for every leaf, from the CPU run's largest distance: at the
    # smoke config's widths a 4-element D leaf read 5.9x its own CPU
    # distance on the card (a handful of f32 sums, each rounding apart),
    # while the card's largest leaf distance stayed within 1.7x the CPU's
    # largest. chip_smoke.py's full-width cut, where the card read at most
    # 1.07x the CPU leaf by leaf, holds each leaf to its own
    limit = 4 * max(_rel(c, w) for c, w in zip(grads_c, grads_64))
    for g, w in zip(grads_g, grads_64):
        assert _rel(g, w) <= limit


def test_lloyd_and_sculley_on_the_card_match_the_cpu(cuda):
    """The linear baselines on the card against the port on the CPU, on
    blobs with clear margins: Lloyd's (k-means++ draws from the same CPU
    generator) labels and iterations equal, cost within 1e-5 relative;
    Sculley's (the same numpy batches) centers within 1e-5 normwise and
    labels equal."""
    from conftest import four_blobs
    from repro_torch.baselines import lloyd_kmeans, sgd_minibatch_kmeans
    x, _ = four_blobs(n_per=500, seed=3)
    res = {dev: lloyd_kmeans(x, 4, n_init=3, seed=0, device=dev)
           for dev in ("cpu", "cuda")}
    assert torch.equal(res["cuda"].labels.cpu(), res["cpu"].labels)
    assert res["cuda"].n_iter == res["cpu"].n_iter
    assert float(res["cuda"].cost) == pytest.approx(float(res["cpu"].cost),
                                                    rel=1e-5)
    for seed in (0, 1):
        sg = {dev: sgd_minibatch_kmeans(x, 4, batch_size=200, n_iters=20,
                                        seed=seed, device=dev)
              for dev in ("cpu", "cuda")}
        assert _rel(sg["cuda"].centers, sg["cpu"].centers) <= 1e-5
        assert torch.equal(sg["cuda"].labels.cpu(), sg["cpu"].labels)


def test_a_model_axis_of_one_is_the_plain_path_on_the_card(card_world):
    """get_model on a (1, 1) mesh of a NCCL world of one against the same
    model without a mesh, on the card: prefill logits, four greedy decode
    steps and the loss bitwise equal, and no collective launched."""
    from repro_torch.distributed.mesh import make_test_mesh, tally
    cfg = get_arch("olmo-1b", smoke=True)
    mesh = make_test_mesh({"data": 1, "model": 1})
    plain = get_model(cfg, device="cuda")
    meshed = get_model(cfg, tp_size=1, mesh=mesh, device="cuda")
    params = plain.init(0, torch.float32)
    tok = torch.as_tensor(np.random.default_rng(0).integers(
        1, cfg.vocab_size, size=(2, 12)), device="cuda")
    batch = {"tokens": tok, "labels": torch.roll(tok, -1, 1)}
    out = {}
    with tally() as bill:
        for name, api in (("plain", plain), ("meshed", meshed)):
            with torch.no_grad():
                cache, logits = api.prefill(params, {"tokens": tok},
                                            max_len=16)
                steps = [logits]
                for i in range(4):
                    logits, cache = api.decode(
                        params, cache, torch.argmax(steps[-1], -1), 12 + i)
                    steps.append(logits)
                out[name] = (steps, api.loss(params, batch, remat=False))
    for a, b in zip(out["plain"][0], out["meshed"][0]):
        assert torch.equal(a, b)
    assert torch.equal(out["plain"][1], out["meshed"][1])
    assert bill.calls == []


@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "rwkv6-7b"])
def test_encdec_and_ssm_on_a_model_axis_of_one_are_the_plain_path(
        card_world, arch):
    """The encoder-decoder and RWKV6 families on a (1, 1) mesh of a NCCL
    world of one against the same model without a mesh, on the card:
    prefill logits, four greedy decode steps, the loss and its grads
    bitwise equal, and no collective launched."""
    from repro_torch.distributed.mesh import make_test_mesh, tally
    from repro_torch.training.optim import tree_leaves
    cfg = get_arch(arch, smoke=True)
    mesh = make_test_mesh({"data": 1, "model": 1})
    plain = get_model(cfg, device="cuda")
    meshed = get_model(cfg, tp_size=1, mesh=mesh, device="cuda")
    rng = np.random.default_rng(0)
    tok = torch.as_tensor(rng.integers(1, cfg.vocab_size, size=(2, 12)),
                          device="cuda")
    inputs = {"tokens": tok}
    if cfg.family == "encdec":
        inputs["frames"] = torch.as_tensor(rng.standard_normal(
            (2, 16, cfg.d_model), dtype=np.float32), device="cuda")
    batch = dict(inputs, labels=torch.roll(tok, -1, 1))
    out = {}
    with tally() as bill:
        for name, api in (("plain", plain), ("meshed", meshed)):
            params = api.init(0, torch.float32)
            with torch.no_grad():
                cache, logits = api.prefill(params, inputs, max_len=16)
                steps = [logits]
                for i in range(4):
                    logits, cache = api.decode(
                        params, cache, torch.argmax(steps[-1], -1), 12 + i)
                    steps.append(logits)
            leaves = tree_leaves(params)
            for t in leaves:
                t.requires_grad_(True)
            loss = api.loss(params, batch, remat=False)
            out[name] = (steps, loss, torch.autograd.grad(loss, leaves))
    for a, b in zip(out["plain"][0], out["meshed"][0]):
        assert torch.equal(a, b)
    assert torch.equal(out["plain"][1], out["meshed"][1])
    for a, b in zip(out["plain"][2], out["meshed"][2]):
        assert torch.equal(a, b)
    assert bill.calls == []


def test_quickstart_example_on_the_card(cuda):
    """examples/torch_quickstart.py on the card: the fits launch
    kernel_matrix and no plain version runs; the kernel beats linear
    k-means on the XOR set."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "torch_quickstart.py")
    spec = importlib.util.spec_from_file_location("torch_quickstart", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    launches0, calls0 = dict(ops.LAUNCHES), dict(ref.CALLS)
    out = mod.main([])
    assert ops.LAUNCHES["kernel_matrix"] > launches0["kernel_matrix"]
    assert dict(ref.CALLS) == calls0
    assert out["xor_kernel_acc"] > out["xor_linear_acc"]
    assert out["toy_acc"] >= 0.75
