"""The port's memory planner (``repro_torch.core.memory``) against the JAX
package's (``repro.core.memory``): every footprint, Eq.19's two B_min
forms and ``plan`` (each field of ``Plan`` and its ``frontier``) must be
identical, as Python floats, over a grid of inputs under one explicit
``MachineSpec``. Only the default machine differs (an H100 here, a TPU
v5e there)."""
import dataclasses
import itertools

import pytest

from repro.core import memory as jm
from repro_torch.core import memory as tm

MACHINE = dict(memory_bytes=16e9, n_processors=64, bytes_per_scalar=4,
               hbm_gbps=819.0, peak_tflops_bf16=197.0, ici_gbps_per_link=50.0)
WORKLOADS = [(60000, 10, 784), (2_000_000, 50, 256), (188000, 50, 256),
             (1_000_000, 100, 32)]


def _machines():
    return jm.MachineSpec(**MACHINE), tm.MachineSpec(**MACHINE)


def test_default_machine_is_one_h100():
    m = tm.MachineSpec()
    assert (m.memory_bytes, m.n_processors, m.hbm_gbps,
            m.peak_tflops_bf16) == (80e9, 1, 3350.0, 989.0)
    assert [f.name for f in dataclasses.fields(m)] == \
        [f.name for f in dataclasses.fields(jm.MachineSpec)]


@pytest.mark.parametrize("n,c,d", WORKLOADS)
@pytest.mark.parametrize("b", [1, 4, 16])
@pytest.mark.parametrize("s", [1.0, 0.2])
def test_fit_footprints_equal(n, c, d, b, s):
    for fused, p, q in itertools.product((False, True), (1, 8), (2, 4)):
        kw = dict(s=s, d=d, fused=fused)
        assert tm.footprint_bytes(n, b, c, p, q, **kw) == \
            jm.footprint_bytes(n, b, c, p, q, **kw)
    for mode, q_tile, rows in itertools.product(
            tm.ENGINE_MODES, (None, 2), (64, 256)):
        kw = dict(s=s, d=d, mode=mode, tile_rows=rows, q_tile=q_tile)
        assert tm.engine_footprint_bytes(n, b, c, 8, 4, **kw) == \
            jm.engine_footprint_bytes(n, b, c, 8, 4, **kw)
    for s_step in (1, 4):
        assert tm.s_step_state_bytes(n, b, c, 8, s_step=s_step) == \
            jm.s_step_state_bytes(n, b, c, 8, s_step=s_step)


@pytest.mark.parametrize("n,c,d", WORKLOADS)
@pytest.mark.parametrize("m", [20, 320, 4096])
def test_embed_sketch_selector_footprints_equal(n, c, d, m):
    for b, p in itertools.product((1, 4), (1, 8)):
        assert tm.embed_footprint_bytes(n, b, c, p, m=m, d=d) == \
            jm.embed_footprint_bytes(n, b, c, p, m=m, d=d)
        for dens in (1.0, 0.01):
            assert tm.sketch_footprint_bytes(n, b, c, p, m=m, d=d,
                                             density=dens) == \
                jm.sketch_footprint_bytes(n, b, c, p, m=m, d=d, density=dens)
        for sel in ("uniform", "rls", "kpp"):
            assert tm.selector_footprint_bytes(n, b, p, m=m, selector=sel) \
                == jm.selector_footprint_bytes(n, b, p, m=m, selector=sel)
    for method, sel in itertools.product(("nystrom", "sketch", "exact-tiled"),
                                         ("uniform", "rls", "kpp", None)):
        assert tm.predicted_accuracy(method, sel, m, c) == \
            jm.predicted_accuracy(method, sel, m, c)
    with pytest.raises(ValueError):
        tm.selector_footprint_bytes(n, 1, 1, m=m, selector="bogus")


@pytest.mark.parametrize("method", ["rff", "nystrom", "sketch",
                                    "tensorsketch", "exact"])
@pytest.mark.parametrize("bucket", [0, 1, 64, 512])
def test_serve_footprint_equal(method, bucket):
    for (c, m, d), q_tile in itertools.product(
            [(10, 320, 784), (50, 128, 256), (8, 64, 16)], (None, 2)):
        kw = dict(method=method, q_tile=q_tile, degree=3, bucket=bucket)
        assert tm.serve_footprint_bytes(c, m, d, **kw) == \
            jm.serve_footprint_bytes(c, m, d, **kw)


@pytest.mark.parametrize("n,c,d", WORKLOADS)
def test_b_min_and_host_staging_equal(n, c, d):
    mj, mt = _machines()
    for mem in (16e9, 80e9):
        mj2, mt2 = (dataclasses.replace(mj, memory_bytes=mem),
                    dataclasses.replace(mt, memory_bytes=mem))
        for s in (1.0, 0.3):
            assert tm.b_min(n, c, mt2, s=s) == jm.b_min(n, c, mj2, s=s)
        assert tm.b_min_paper(n, c, mt2) == jm.b_min_paper(n, c, mj2)
    for sparse, depth in itertools.product((False, True), (0, 2)):
        kw = dict(d=d, density=0.01, sparse=sparse, prefetch_depth=depth)
        assert tm.host_staging_bytes(n, 4, **kw) == \
            jm.host_staging_bytes(n, 4, **kw)


_PLANS = [dict(), dict(b=64), dict(b=2, precision="bf16"),
          dict(selector="rls", sketchable=True, density=0.01),
          dict(selector="kpp", embed_dim=256, s_step=4),
          dict(target_batch_seconds=1.0, measured_batch_seconds=3.0),
          dict(target_batch_seconds=1.0, measured_batch_seconds=9.0),
          dict(b=1, tile_rows=64)]


@pytest.mark.parametrize("n,c,d", WORKLOADS)
@pytest.mark.parametrize("kw", _PLANS, ids=lambda k: "-".join(
    f"{a}={b}" for a, b in k.items()) or "default")
def test_plan_and_frontier_equal(n, c, d, kw):
    mj, mt = _machines()
    pj = jm.plan(n, c, mj, d=d, **kw)
    pt = tm.plan(n, c, mt, d=d, **kw)
    for f in dataclasses.fields(jm.Plan):
        assert getattr(pt, f.name) == getattr(pj, f.name), f.name
    assert pt.frontier() == pj.frontier()
    budget = pj.frontier()[0]["bytes"] / 3 if pj.frontier() else 1e6
    assert pt.frontier(budget) == pj.frontier(budget)
    eng = pt.gram_engine()
    assert (eng.mode, eng.tile_rows, eng.precision) == \
        (pt.engine, pt.tile_rows, pt.precision)


def test_plan_rejects_what_the_reference_rejects():
    _, mt = _machines()
    with pytest.raises(ValueError, match="unknown selector"):
        tm.plan(2_000_000, 50, mt, d=256, selector="bogus")
    with pytest.raises(ValueError, match="precision"):
        tm.plan(2_000_000, 50, mt, d=256, precision="fp8")
    with pytest.raises(ValueError, match="frontier"):
        tm.Plan(b=1, s=1.0, footprint=0, fused_footprint=0,
                note="").frontier()
    with pytest.raises(ValueError, match="bookkeeping"):
        tm.b_min(10, 10, dataclasses.replace(mt, memory_bytes=1.0))
