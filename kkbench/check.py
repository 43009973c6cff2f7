"""The comparison that decides ``correct``: after the window, the plain
reference (``reference/``) works out again from the same rows what the
program derived, and each compared number is held to its limit (the
cell's ``limits``).

A fit is judged by a sample drawn from the run's seed: one step of the
window and, in it, the first batch, the last and one between. Each batch
is followed from the program's own state entering it (the reference
cannot replay the program's near-tie rounding through many batches), the
first batch from the draws alone. ``predict``'s labels are judged in every
step of the window against that step's final state. The numbers are
maxima over what was judged.

With ``control=True`` the reference computed in TF32 (``tf32=True``: the
nearest precision below the configuration's float32) takes the program's
place on the judged batches, from the same entering states, and labels
the held-out rows by the same final medoids; the readings of the
control, never part of a run."""
from __future__ import annotations

import math
import types

import numpy as np
import torch

from .reference import kkmeans, rff


def sample(seed: int, n_steps: int, n_batches: int):
    """(step, batches) to judge, drawn from the run's seed."""
    rng = np.random.default_rng([int(seed), 17])
    step = int(rng.integers(n_steps))
    batches = {0, n_batches - 1}
    if n_batches > 2:
        batches.add(int(rng.integers(1, n_batches - 1)))
    return step, sorted(batches)


def units(outs: list, seed: int, *, every: bool = False) -> list:
    """What a run judges, one unit at a time: ``("batch", k, i)``, batch i
    of step k (the seed's sample; ``every``: every batch of every step),
    then ``("predict", k)`` for each step k."""
    b = len(outs[0].history)
    if every:
        fits = [("batch", k, i) for k in range(len(outs)) for i in range(b)]
    else:
        k, batches = sample(seed, len(outs), b)
        fits = [("batch", k, i) for i in batches]
    return fits + [("predict", k) for k in range(len(outs))]


def judge(cell: dict, data, gamma: float, outs: list, seed: int, *,
          control: bool = False, every: bool = False, world=None,
          judged: list | None = None) -> dict:
    """The compared numbers of a run's steps ``outs``. An exact cell's
    ``units`` are shared out over ``world``'s ranks (``kkbench/world.py``;
    rank r of P judges every P-th from the r-th on its own device) and
    merged on every rank; ``judged``, where given, receives every (unit,
    its numbers)."""
    if cell["method"] == "exact":
        rank, size = (world.rank, world.size) if world else (0, 1)
        mine = [[list(u), judge_unit(cell, data, gamma, outs, u,
                                     control=control)]
                for u in units(outs, seed, every=every)[rank::size]]
        shares = world.exchange("control" if control else "judged",
                                mine) if world else [mine]
        got = [(tuple(u), d) for share in shares for u, d in share]
        if judged is not None:
            judged.extend(got)
        return merge(d for _, d in got)
    if control:
        raise ValueError("the reference control is for the exact cells")
    if cell["method"] == "rff":
        return _rff(cell, data, gamma, outs, seed)
    raise ValueError(f"no reference for method {cell['method']!r}")


#: the exact cells' numbers, compared or not
EXACT = ("cost", "count", "medoid", "medoid_gap", "moved", "predict")


def merge(gots) -> dict:
    """The key-wise maximum of readings (each number is a maximum over
    what was judged; every exact number is 0 where nothing was read of it,
    and one that is not a number stays so)."""
    out = dict.fromkeys(EXACT, 0.0)
    for got in gots:
        for k, v in got.items():
            out[k] = math.nan if math.isnan(v) or math.isnan(out[k]) \
                else max(out[k], v)
    return out


def _tf32_batch(xb, gamma, c, iters, seed, i, prev, mult):
    """The control's outputs for one batch: (cost, counts, state)."""
    st = kkmeans.batch_step(
        xb, gamma, c, iters, seed=seed, i=i, tf32=True, multiple_of=mult,
        medoids_in=None if prev is None else prev.medoids.to(xb.device),
        card_in=None if prev is None else prev.cardinalities.to(xb.device))
    return (st.inner.cost, st.inner.st.counts.cpu(),
            types.SimpleNamespace(medoids=st.medoids.float(),
                                  cardinalities=st.cardinalities.float()))


def landmark_multiple(cell: dict) -> int:
    """What the program rounds a batch's landmark count to: the mesh's row
    count on the mesh entry (a 1-D ``data`` mesh over the world), else 1."""
    return cell.get("world", 1) if cell["entry"] == "mesh" else 1


def judge_unit(cell, data, gamma, outs, unit, *, control=False) -> dict:
    """The numbers of one unit (``units``): a batch's from the program's
    state entering it (the first batch's from the draws alone), or one
    step's ``predict``."""
    c, iters = cell["n_clusters"], cell["max_inner_iters"]
    out = outs[unit[1]]
    if unit[0] == "predict":
        medoids = out.states[-1].medoids
        labels = kkmeans.predict(data.x_test, medoids.to(data.x.device),
                                 gamma, tf32=True) if control else out.labels
        return {"predict": kkmeans.predict_gap(data.x_test, medoids, labels,
                                               gamma)}
    i, b, mult = unit[2], len(out.history), landmark_multiple(cell)
    xb = data.x[i::b].contiguous()
    prev = out.states[i - 1] if i else None
    h = out.history[i]
    cost, counts, state = h.cost, h.counts, out.states[i]
    if control:
        cost, counts, state = _tf32_batch(xb, gamma, c, iters, out.seed, i,
                                          prev, mult)
    r = kkmeans.judge_batch(
        xb, gamma, c, iters, seed=out.seed, i=i, cost=cost, counts=counts,
        state_out=state, state_in=prev, s=cell["s"], multiple_of=mult)
    del xb
    if data.x.is_cuda:
        torch.cuda.empty_cache()
    return r


def _rff(cell, data, gamma, outs, seed) -> dict:
    if len(outs[0].history) != 1:
        raise ValueError("the RFF comparison judges one-batch fits")
    k, _ = sample(seed, len(outs), 1)
    out = outs[k]
    w, b = rff.draw_map(out.seed, data.x.shape[1], cell["embed_dim"], gamma)
    fm = out.fmap
    got = {"map": max(float((fm.w.cpu() - w).abs().max()),
                      float((fm.b.cpu() - b).abs().max()))}
    z = rff.embed(data.x, w, b)
    st, h = out.states[-1], out.history[-1]
    got.update(rff.judge_final(z, st.centroids, st.cardinalities, h.cost))
    del z
    gaps = []
    for o in outs:      # each step's own map, drawn again from its seed
        wo, bo = rff.draw_map(o.seed, data.x.shape[1], cell["embed_dim"],
                              gamma)
        gaps.append(rff.predict_gap(rff.embed(data.x_test, wo, bo),
                                    o.states[-1].centroids,
                                    o.states[-1].cardinalities, o.labels))
    got["predict"] = max(gaps)
    return got


def verdict(got: dict, limits: dict) -> bool:
    """Every compared number within its limit (a number that is not
    finite fails)."""
    return all(np.isfinite(got[k]) and got[k] <= limits[k] for k in limits)
