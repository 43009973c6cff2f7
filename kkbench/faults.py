"""Faults planted in the program, to show that the comparison fails them:
each ``plant(monkeypatch, which)`` breaks the timed path of a cell's
entry (``which``: ``"exact"`` for ``fit_dataset``'s exact fit, ``"mesh"``
for the mesh entry, ``"rff"`` for the embedded fit) through pytest's
``monkeypatch``. The CPU tests plant each in a whole tiny run; the
calibration (``python3 -m kkbench.calibrate --fault NAME``) reads one at
a cell's own size. A benchmark run never imports this."""
from __future__ import annotations

import contextlib

import pytest
import torch

import repro_torch.approx.embed_kmeans as ek
import repro_torch.core.engine as engine
import repro_torch.core.minibatch as mb
import repro_torch.distributed.inner as dinner
import repro_torch.distributed.outer as douter
import repro_torch.serving.assign as sassign
from repro_torch.distributed.mesh import axis_size


def unchanged(monkeypatch, which):
    """A step that returns its state unchanged."""
    if which == "exact":
        orig = mb._next_batch_step

        def step(x, l_idx, state, *, cfg):
            _, res, disp = orig(x, l_idx, state, cfg=cfg)
            return state, res, disp
        monkeypatch.setattr(mb, "_next_batch_step", step)
    elif which == "mesh":
        orig = douter.DistributedMiniBatchKMeans._medoid_merge

        def merge(self, xb, x, diag, res, k_tilde, state, first, wgt):
            new, disp = orig(self, xb, x, diag, res, k_tilde, state, first,
                             wgt)
            return (new if first else state), disp
        monkeypatch.setattr(douter.DistributedMiniBatchKMeans,
                            "_medoid_merge", merge)
    else:           # one batch: Lloyd hands back its starting partition
        orig = ek.lloyd_fit
        monkeypatch.setattr(ek, "lloyd_fit", lambda z, labels0, **kw:
                            orig(z, labels0, **dict(kw, max_iters=0)))


def half(monkeypatch, which):
    """Half of the batch left out, the mean taken over the rest."""
    if which == "rff":
        orig = ek._means
        monkeypatch.setattr(ek, "_means", lambda z, labels, c:
                            orig(z[::2], labels[::2], c))
        return

    def stats(eng, spec, op_xl, op_ll, cols, rows, c):
        keep = torch.arange(cols.shape[0], device=cols.device) % 2 == 0
        # labels past the last cluster drop out of the one-hot sums
        cols = torch.where(keep, cols, torch.full_like(cols, c))
        h = torch.nn.functional.one_hot(cols.long(), c + 1)[:, :c].to(
            torch.float32)
        counts = h.sum(0)
        f_raw = eng.matvec(spec, op_xl, h)
        t = eng.matvec(spec, op_ll, h)
        hr = torch.nn.functional.one_hot(rows.long(), c).to(torch.float32)
        return counts, f_raw, torch.sum(hr * t, dim=0)
    monkeypatch.setattr(engine, "engine_stats_raw", stats)
    monkeypatch.setattr(dinner, "engine_stats_raw", stats)


def _swap_weights(state, counts):
    """``state`` with cardinalities W' = n^2 / W, so that Eq.12's weight
    n / (n + W') is the right one's complement W / (n + W)."""
    w = state.cardinalities
    swapped = torch.where(w > 0, counts * counts / w.clamp(min=1e-30),
                          torch.full_like(w, float("inf")))
    return state._replace(cardinalities=swapped)


def swapped(monkeypatch, which):
    """Eq.12's merge with alpha and 1 - alpha swapped: the batch medoid
    weighted as the accumulated one, and the other way round."""
    if which == "exact":
        orig = mb._next_batch_step

        def step(x, l_idx, state, *, cfg):
            _, res, _ = orig(x, l_idx, state, cfg=cfg)
            new, res, disp = orig(x, l_idx, _swap_weights(state, res.counts),
                                  cfg=cfg)
            return new._replace(cardinalities=state.cardinalities
                                + res.counts), res, disp
        monkeypatch.setattr(mb, "_next_batch_step", step)
    elif which == "mesh":
        orig = douter.DistributedMiniBatchKMeans._medoid_merge

        def merge(self, xb, x, diag, res, k_tilde, state, first, wgt):
            if first:
                return orig(self, xb, x, diag, res, k_tilde, state, first,
                            wgt)
            new, disp = orig(self, xb, x, diag, res, k_tilde,
                             _swap_weights(state, res.counts), first, wgt)
            return new._replace(cardinalities=state.cardinalities
                                + res.counts), disp
        monkeypatch.setattr(douter.DistributedMiniBatchKMeans,
                            "_medoid_merge", merge)
    else:
        raise ValueError("an embedded fit has no merge")


def argmax(monkeypatch, which):
    """Eq.7's medoid taken by argmax in place of argmin (on the mesh,
    Eq.12's merge too: both go through one distributed argmin)."""
    if which == "exact":
        orig = mb.medoid_indices

        def medoids(diag_k, f, labels, counts, **kw):
            # argmin(-(K_ll - 2 f)) = argmax(K_ll - 2 f)
            return orig(-diag_k, -f, labels, counts, **kw)
        monkeypatch.setattr(mb, "medoid_indices", medoids)
    elif which == "mesh":
        orig = douter._dist_argmin_rows
        monkeypatch.setattr(douter, "_dist_argmin_rows",
                            lambda mesh, axes, score: orig(mesh, axes, -score))
    else:
        raise ValueError("an embedded fit has no medoids")


def altered(monkeypatch, which):
    """An answer altered where it is produced: one held-out label."""
    orig = sassign.predict

    def predict(art, x, **kw):
        out = orig(art, x, **kw).clone()
        out[0] = (out[0] + 1) % _clusters(art)
        return out
    monkeypatch.setattr(sassign, "predict", predict)


def _clusters(art) -> int:
    for name in ("medoids", "centroids", "v"):
        t = getattr(art, name, None)
        if isinstance(t, torch.Tensor):
            return t.shape[-1] if name == "v" else t.shape[0]
    return 10


def exchange(monkeypatch, which):
    """The exchange between chips left out of the mesh's inner loop: each
    rank takes its own labels for every rank's (the all_gather) and its
    own partial g, cost and changed count for the sums (the all_reduce)."""
    monkeypatch.setattr(dinner, "all_gather", lambda t, mesh, axes: t.repeat(
        (axis_size(mesh, axes),) + (1,) * (t.dim() - 1)))
    monkeypatch.setattr(dinner, "all_reduce", lambda t, mesh, axes: t)


def which(cell: dict) -> str:
    """The entry a cell's timed path runs, as the faults name it."""
    if cell["method"] == "rff":
        return "rff"
    return "mesh" if cell["entry"] == "mesh" else "exact"


FAULTS = {"unchanged": unchanged, "half": half, "argmax": argmax,
          "swapped": swapped, "altered": altered, "exchange": exchange}
# the faults each entry can have and the comparison fails (an embedded
# fit has no medoids; a swapped merge mostly picks the same row, or one
# tied with it, so no number can fail it without failing sound runs:
# PERF.md gives its readings); a mesh of one rank has no exchange
APPLIES = {"exact": ["altered", "argmax", "half", "unchanged"],
           "mesh": ["altered", "argmax", "half", "unchanged"],
           "rff": ["altered", "half", "unchanged"]}


def applies(cell: dict) -> list:
    """The faults a cell's timed path can have (``APPLIES``, and the
    exchange on a world above one)."""
    return APPLIES[which(cell)] + (["exchange"] if cell.get("world", 1) > 1
                                   else [])


@contextlib.contextmanager
def planted(name: str, cell: dict):
    """``FAULTS[name]`` planted in ``cell``'s timed path while the block
    runs."""
    with pytest.MonkeyPatch.context() as mp:
        FAULTS[name](mp, which(cell))
        yield
