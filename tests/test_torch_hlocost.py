"""repro_torch.launch.hlocost: the cost terms of one run, and KERNEL_WORK,
the one count of each kernel's work that chip_smoke.py's bounds come from.

The counterpart of ``tests/test_hlocost.py``: a loop of matmuls counts
exactly its passes times 2mnk (the reference's scan), one matmul its flops
and bytes, nested loops multiply, and the collective bytes of a world of
one are the payload. ``KERNEL_WORK`` must give, to the last digit, the
flops and bytes that ``chip_smoke.py`` passed to ``bound_ms`` inline
before they moved (copied below as ``_old_*``), at its phase-3 shapes.
"""
import os
import sys
import tempfile

import pytest
import torch
import torch.distributed as dist

from repro_torch.distributed import mesh as dmesh
from repro_torch.kernels import ops
from repro_torch.launch import hlocost
from repro_torch.launch.hlocost import KERNEL_WORK, compiled_cost_terms

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_loop_of_matmuls_flops_exact():
    """A 7-pass loop of [32, 64] x [64, 48] matmuls: exactly 7 * 2mnk (the
    eager loop counts as it runs; the reference multiplies a scan's trip
    count through)."""
    def f(x, w):
        for _ in range(7):
            x = torch.tanh(x @ w)
        return x.sum()

    x, w = torch.randn(32, 64), torch.randn(64, 64)
    cost = compiled_cost_terms(f, x, w)
    assert cost["flops"] == 7 * 2 * 32 * 64 * 64
    assert cost["flops_by_precision"] == {"f32": 7 * 2 * 32 * 64 * 64}


def test_single_matmul_flops_and_bytes():
    a, b = torch.randn(64, 512), torch.randn(512, 128)
    cost = compiled_cost_terms(lambda a, b: a @ b, a, b)
    assert cost["flops"] == 2 * 64 * 512 * 128
    # operands + result, exactly: one eager op
    assert cost["hbm_bytes"] == (64 * 512 + 512 * 128 + 64 * 128) * 4
    assert cost["coll_counts"] == {} and cost["kernel_work"] == []


def test_nested_loop_multiplication():
    """outer 4 x inner 8 -> 32x the body."""
    def f(x, w):
        for _ in range(4):
            for wi in w:
                x = x @ wi
        return x.sum()

    x, w = torch.randn(32, 64), torch.randn(8, 64, 64)
    cost = compiled_cost_terms(f, x, w)
    assert cost["flops"] == 4 * 8 * 2 * 32 * 64 * 64


def test_bf16_flops_are_kept_apart():
    a, b = torch.randn(16, 32), torch.randn(32, 8)
    cost = compiled_cost_terms(lambda a, b: (a.bfloat16() @ b.bfloat16()),
                               a, b)
    assert cost["flops_by_precision"] == {"bf16": 2 * 16 * 32 * 8}


def test_collective_bytes_of_a_world_of_one():
    started = not dist.is_initialized()
    with tempfile.TemporaryDirectory() as tmp:
        if started:
            dist.init_process_group(
                "gloo", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                rank=0, world_size=1)
        try:
            mesh = dmesh.make_test_mesh({"data": 1}, device="cpu")

            def f(x):
                x = dmesh.all_reduce(x, mesh, ("data",))
                return dmesh.all_gather(x[:3], mesh, ("data",))

            cost = compiled_cost_terms(f, torch.ones(10))
        finally:
            if started:
                dist.destroy_process_group()
    assert cost["coll_counts"] == {"all-reduce": 1, "all-gather": 1}
    assert cost["coll_bytes"] == 10 * 4 + 3 * 4


def test_cost_terms_read_from_an_audited_run():
    """An audit report prices the run it audited: the same terms as
    compiled_cost_terms, with no second run."""
    from repro_torch.analysis import audit
    x, y = torch.randn(100, 16), torch.randn(40, 16)

    def f(x, y):
        return torch.tanh(ops.kernel_matrix(x, y)).sum()

    report = audit(f, x, y)
    assert hlocost.cost_terms(report) == compiled_cost_terms(f, x, y)
    assert hlocost.cost_terms(report)["kernel_work"][0]["kernel"] == \
        "kernel_matrix"


def test_kernel_work_of_a_plain_stand_in():
    """On the CPU a wrapper's plain version stands in for the launch: its
    own ops are kernel scope (not counted), KERNEL_WORK prices it."""
    x, y = torch.randn(100, 16), torch.randn(40, 16)
    cost = compiled_cost_terms(lambda: ops.kernel_matrix(x, y))
    work = KERNEL_WORK["kernel_matrix"](m=100, n=40, d=16, prec="f32")
    assert cost["flops"] == work.flops[0][1]
    assert cost["hbm_bytes"] == work.bytes
    [item] = cost["kernel_work"]
    assert (item["work"], item["m"], item["n"], item["d"]) == \
        ("kernel_matrix", 100, 40, 16)
    h = torch.ones(40, 3)
    cost = compiled_cost_terms(lambda: ops.gram_matvec(y, y, h))
    assert [(i["work"], i["kernel"], i["shared"])
            for i in cost["kernel_work"]] == [
        ("gram_matvec", "assign_fused", True)]


# ---------------------------------------------------------------------------
# KERNEL_WORK against the counts chip_smoke.py used before the move


def _old_kernel_matrix(m, n, d, prec):
    it = 2 if prec == "bf16" else 4
    return ([(prec, 2.0 * m * n * d)], (m + n) * d * it + m * n * 4)


def _old_assign(m, nl, d, c, prec):
    it = 2 if prec == "bf16" else 4
    return ([(prec, 2.0 * m * nl * d), ("f32", 2.0 * m * nl * c)],
            (m + nl) * d * it + (m + nl) * 4 + nl * c * 4
            + c * 4 + m * (8 + 4 * c))


def _old_gram_matvec(nl, d, c, prec):
    it = 2 if prec == "bf16" else 4
    return ([(prec, 2.0 * nl * nl * d), ("f32", 2.0 * nl * nl * c)],
            nl * d * it + nl * 4 + 2 * nl * c * 4)


def _old_embed(n, d, m, c, prec):
    it = 2 if prec == "bf16" else 4
    return ([(prec, 2.0 * n * m * d), ("f32", 2.0 * n * m * c)],
            (n + m) * d * it + (n + m) * 4 + (m + 1) * c * 4 + n * 8)


def _old_sketch(n, d, m, c, prec):
    it = 2 if prec == "bf16" else 4
    sign_itemsize = 1 if prec == "bf16" else 4
    return ([("f32", 2.0 * n * m * c + n * d)],
            n * d * it + d * (4 + sign_itemsize) + (m + 1) * 4
            + (m + 1) * c * 4 + n * 8)


def _old_attention_pairs(sq, sk, causal):
    if not causal:
        return sq * sk
    m = min(sq, sk)
    return m * (m + 1) // 2 + (sq - m) * sk


def _old_flash(b, h, kh, sq, sk, dh, causal, prec):
    it = 2 if prec == "bf16" else 4
    pairs = _old_attention_pairs(sq, sk, causal)
    return ([(prec, 4.0 * b * h * dh * pairs)],
            (2 * b * h * sq * dh + 2 * b * kh * sk * dh) * it)


def _phase3_cases():
    """(kind, old formula, its arguments, KERNEL_WORK keywords) at the
    shapes chip_smoke.py's phase 3 times."""
    sys.path.insert(0, os.path.join(_ROOT, "src"))
    from repro_torch.launch.kernel_ab import SKINNY
    out = []
    for prec in ("f32", "bf16"):
        km = [(15000, 3000, 784), (15000, 10, 784), (15000, 33, 784),
              (320, 320, 784), (300, 520, 129), (40, 40, 6), (16, 16, 6),
              (60000, 320, 784)]
        km += [(m, n, d) for m, n, d, *_ in SKINNY]
        for m, n, d in km:
            out.append(("kernel_matrix", _old_kernel_matrix, (m, n, d, prec),
                        dict(m=m, n=n, d=d, prec=prec)))
        for m, nl, d, c in [(15000, 15000, 784, 10), (15000, 3000, 784, 10),
                            (300, 130, 40, 3), (300, 130, 40, 7),
                            (300, 130, 40, 130), (300, 130, 40, 300)]:
            out.append(("assign_fused", _old_assign, (m, nl, d, c, prec),
                        dict(m=m, l=nl, d=d, c=c, prec=prec)))
        for nl in (15000, 3000):
            out.append(("gram_matvec", _old_gram_matvec, (nl, 784, 10, prec),
                        dict(m=nl, l=nl, d=784, c=10, prec=prec,
                             shared=True)))
        for n, d, m, c in [(60000, 784, 320, 10), (60000, 784, 20, 10),
                           (60000, 784, 80, 10), (60000, 784, 160, 10),
                           (1, 784, 320, 10), (8, 784, 320, 10),
                           (64, 784, 320, 10), (512, 784, 320, 10)]:
            out.append(("embed_assign", _old_embed, (n, d, m, c, prec),
                        dict(n=n, d=d, m=m, c=c, prec=prec)))
        for n, d, m, c in [(188000, 256, 128, 50), (1, 256, 128, 50),
                           (512, 256, 128, 50), (1024, 47236, 256, 50),
                           (4096, 47236, 256, 50)]:
            out.append(("sketch_assign", _old_sketch, (n, d, m, c, prec),
                        dict(n=n, d=d, m=m, c=c, prec=prec)))
        for b, h, kh, s, dh in [(1, 16, 16, 2048, 128), (1, 8, 4, 2048, 256),
                                (1, 64, 8, 2048, 128)]:
            for causal in (True, False):
                out.append(("flash_attention", _old_flash,
                            (b, h, kh, s, s, dh, causal, prec),
                            dict(b=b, h=h, kh=kh, sq=s, sk=s, dh=dh,
                                 causal=causal, prec=prec)))
    return out


@pytest.mark.parametrize("kind", sorted(KERNEL_WORK))
def test_kernel_work_equals_chip_smokes_counts(kind):
    """The same flops list and bytes, and so the same bound_ms to the last
    digit (chip_smoke.bound_ms on both)."""
    sys.path.insert(0, _ROOT)
    import chip_smoke
    cases = [c for c in _phase3_cases() if c[0] == kind]
    assert cases
    for _, old, args, kw in cases:
        flops, nbytes = old(*args)
        work = KERNEL_WORK[kind](**kw)
        assert work.flops == flops and work.bytes == nbytes, (kind, args)
        assert chip_smoke.bound_ms(*work) == chip_smoke.bound_ms(
            flops, nbytes)


def test_attention_pairs_moved_unchanged():
    for sq, sk in [(1, 1), (100, 256), (2048, 2048), (1000, 10)]:
        for causal in (True, False):
            assert hlocost.attention_pairs(sq, sk, causal) == \
                _old_attention_pairs(sq, sk, causal)
