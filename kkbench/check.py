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


def judge(cell: dict, data, gamma: float, outs: list, seed: int, *,
          control: bool = False, batch: int | None = None) -> dict:
    """The compared numbers of a run's steps ``outs``; ``batch`` judges
    that batch of the first step in place of the seed's sample (the
    calibration's sweep over a cell's own cycle)."""
    if cell["method"] == "exact":
        return _exact(cell, data, gamma, outs, seed, control, batch)
    if control:
        raise ValueError("the reference control is for the exact cells")
    if cell["method"] == "rff":
        return _rff(cell, data, gamma, outs, seed)
    raise ValueError(f"no reference for method {cell['method']!r}")


def _tf32_batch(xb, gamma, c, iters, seed, i, prev):
    """The control's outputs for one batch: (cost, counts, state)."""
    st = kkmeans.batch_step(
        xb, gamma, c, iters, seed=seed, i=i, tf32=True,
        medoids_in=None if prev is None else prev.medoids.to(xb.device),
        card_in=None if prev is None else prev.cardinalities.to(xb.device))
    return (st.inner.cost, st.inner.st.counts.cpu(),
            types.SimpleNamespace(medoids=st.medoids.float(),
                                  cardinalities=st.cardinalities.float()))


def _exact(cell, data, gamma, outs, seed, control=False, batch=None):
    c, iters = cell["n_clusters"], cell["max_inner_iters"]
    b = len(outs[0].history)
    k, batches = sample(seed, len(outs), b) if batch is None else (0, [batch])
    out = outs[k]
    got = {"cost": 0.0, "count": 0.0, "medoid": 0.0, "medoid_gap": 0.0,
           "moved": 0.0}
    for i in batches:
        xb = data.x[i::b].contiguous()
        prev = out.states[i - 1] if i else None
        h = out.history[i]
        cost, counts, state = h.cost, h.counts, out.states[i]
        if control:
            cost, counts, state = _tf32_batch(xb, gamma, c, iters, out.seed,
                                              i, prev)
        r = kkmeans.judge_batch(
            xb, gamma, c, iters, seed=out.seed, i=i, cost=cost,
            counts=counts, state_out=state, state_in=prev)
        del xb
        if data.x.is_cuda:
            torch.cuda.empty_cache()
        got = {key: max(got[key], r[key]) for key in got}
    got["predict"] = max(kkmeans.predict_gap(
        data.x_test, o.states[-1].medoids,
        kkmeans.predict(data.x_test, o.states[-1].medoids.to(data.x.device),
                        gamma, tf32=True) if control else o.labels,
        gamma) for o in outs)
    return got


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
